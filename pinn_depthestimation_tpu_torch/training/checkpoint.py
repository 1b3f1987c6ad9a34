"""Weights files the port reads.

Port of the JAX package's ``training/checkpoint.py::restore_params_any``
for the serving path. Two formats:

* a reference torch ``.pth``/``.pt`` — a whole pickled ``dnn.DNN`` module
  or a ``state_dict`` (``utils.torch_interop``);
* an ``.npz`` holding the parameter exchange dict (the six arrays of
  ``models.mlp.PARAM_KEYS``): ``np.savez(path, **params_to_numpy(p))``
  here, ``np.savez(path, **jax.tree.map(np.asarray, params))`` from the
  JAX package.

The JAX package's own ``.msgpack``/``.orbax`` checkpoints need ``flax`` /
``orbax``, which the port does not use; export them once with the JAX
package's ``utils.torch_interop.torch_state_dict_from_params`` and
``torch.save``. Reading msgpack directly is queued in ``ROADMAP.md``.
"""

from __future__ import annotations

import numpy as np
import torch

from pinn_depthestimation_tpu_torch.models.mlp import (
    PARAM_KEYS,
    params_from_numpy,
)
from pinn_depthestimation_tpu_torch.utils.torch_interop import (
    check_architecture,
    params_from_torch_file,
)


def restore_params_any(
    path: str, spec=None, *, device: str | torch.device
) -> dict[str, torch.Tensor]:
    """Load model parameters from a ``.pth``/``.pt`` or ``.npz`` file onto
    ``device``. ``spec`` (``models.MLPSpec``) checks the architecture."""
    if path.endswith((".pth", ".pt")):
        arrays = params_from_torch_file(path, spec=spec)
    elif path.endswith(".npz"):
        with np.load(path) as f:
            arrays = {k: f[k] for k in PARAM_KEYS if k in f.files}
        missing = [k for k in PARAM_KEYS if k not in arrays]
        if missing:
            raise KeyError(f"{path!r} lacks parameter arrays {missing}")
        if spec is not None:
            check_architecture(arrays, spec, path)
    elif path.endswith((".msgpack", ".orbax")):
        raise ValueError(
            f"{path!r}: the port reads no flax/orbax checkpoint. Export it "
            "with the JAX package's "
            "utils.torch_interop.torch_state_dict_from_params and torch.save "
            "to a .pth (direct msgpack reading is queued in ROADMAP.md)"
        )
    else:
        raise ValueError(
            f"{path!r}: unknown weights format (expected .pth, .pt or .npz)"
        )
    return params_from_numpy(arrays, device)
