"""Checkpoints the port writes, and the weights files it reads.

Port of the JAX package's ``training/checkpoint.py``. A training
checkpoint is one ``.npz`` (the card's machine has no flax, msgpack or
orbax), written to a temporary file and moved into place with
``os.replace``, so a crash never leaves a torn file. Its keys:

* the six parameter arrays at the top level (``w_in`` ... ``b_out``), so
  :func:`restore_params_any` and ``Predictor`` read a trained model as it is;
* ``iteration`` (completed loss evaluations);
* ``opt/...`` (the Adam state: ``step``, ``lr``, ``exp_avg/<key>``,
  ``exp_avg_sq/<key>``);
* ``lbfgs/<field>`` in checkpoints cut during the L-BFGS phase (the
  runner's exported state: iterate, s/y history, counters).

The reference keeps the ``model_<iter>`` naming and cadence
(:func:`checkpoint_due`, :func:`checkpoint_points`). Weights files read by
:func:`restore_params_any`, three formats:

* a reference torch ``.pth``/``.pt`` — a whole pickled ``dnn.DNN`` module
  or a ``state_dict`` (``utils.torch_interop``);
* an ``.npz`` holding the parameter exchange dict (the six arrays of
  ``models.mlp.PARAM_KEYS``): ``np.savez(path, **params_to_numpy(p))``
  here, ``np.savez(path, **jax.tree.map(np.asarray, params))`` from the
  JAX package.

* the JAX package's ``.msgpack`` checkpoint (``flax.serialization.to_bytes``
  of a full training state ``{'params', 'opt_state', 'iteration'}`` or of
  a bare parameter tree), read by the port's own decoder
  (``utils.msgpack_lite``: the card's machine has no ``msgpack`` or
  ``flax``), as the JAX ``restore_params`` reads it.

The JAX package's ``.orbax`` checkpoints need ``orbax``, which the port does
not use; export them once with the JAX package's
``utils.torch_interop.torch_state_dict_from_params`` and ``torch.save``.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from pinn_depthestimation_tpu_torch.models.mlp import (
    PARAM_KEYS,
    params_from_numpy,
)
from pinn_depthestimation_tpu_torch.utils import msgpack_lite
from pinn_depthestimation_tpu_torch.utils.torch_interop import (
    check_architecture,
    params_from_torch_file,
)


def restore_params_any(
    path: str, spec=None, *, device: str | torch.device
) -> dict[str, torch.Tensor]:
    """Load model parameters from a ``.pth``/``.pt``, ``.npz`` or JAX
    ``.msgpack`` file onto ``device``. ``spec`` (``models.MLPSpec``) checks
    the architecture."""
    if path.endswith((".pth", ".pt")):
        arrays = params_from_torch_file(path, spec=spec)
    elif path.endswith((".npz", ".msgpack")):
        if path.endswith(".npz"):
            with np.load(path) as f:
                arrays = {k: f[k] for k in PARAM_KEYS if k in f.files}
        else:
            arrays = _msgpack_params(path)
        missing = [k for k in PARAM_KEYS if k not in arrays]
        if missing:
            raise KeyError(f"{path!r} lacks parameter arrays {missing}")
        if spec is not None:
            check_architecture(arrays, spec, path)
    elif path.endswith(".orbax"):
        raise ValueError(
            f"{path!r}: the port reads no orbax checkpoint. Export it "
            "with the JAX package's "
            "utils.torch_interop.torch_state_dict_from_params and torch.save "
            "to a .pth, or save it with the msgpack backend"
        )
    else:
        raise ValueError(
            f"{path!r}: unknown weights format (expected .pth, .pt, .npz or .msgpack)"
        )
    return params_from_numpy(arrays, device)


def _msgpack_params(path: str) -> dict[str, np.ndarray]:
    """The parameter arrays of a JAX ``.msgpack`` checkpoint: the
    ``params`` of a full training state, or the bare tree (JAX
    ``training/checkpoint.py::restore_params``)."""
    raw = msgpack_lite.read(path)
    tree = raw["params"] if isinstance(raw, dict) and "params" in raw else raw
    if not isinstance(tree, dict):
        raise ValueError(f"{path!r} holds no parameter tree")
    return {k: np.array(tree[k]) for k in PARAM_KEYS if k in tree}  # writable copies


def save_checkpoint(path: str, state: dict) -> str:
    """Write ``state`` (nested dicts of arrays, flattened to ``a/b`` keys)
    as ``<path>.npz``, atomically. Returns the file name."""
    flat: dict[str, np.ndarray] = {}

    def put(prefix: str, tree) -> None:
        for k, v in tree.items():
            key = f"{prefix}{k}"
            if isinstance(v, dict):
                put(key + "/", v)
            elif isinstance(v, torch.Tensor):
                flat[key] = v.detach().cpu().numpy()
            else:
                flat[key] = np.asarray(v)

    put("", state)
    full = path + ".npz"
    tmp = full + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, full)
    return full


def load_raw(path: str) -> dict:
    """A checkpoint back as nested dicts of numpy arrays."""
    out: dict = {}
    with np.load(path) as f:
        for key in f.files:
            node = out
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = f[key]
    return out


def latest_checkpoint(run_dir: str, prefix: str = "model_") -> str | None:
    """The highest-iteration ``model_<iter>.npz`` in a run directory."""
    best, best_it = None, -1
    pat = re.compile(re.escape(prefix) + r"(\d+)\.npz$")
    if not os.path.isdir(run_dir):
        return None
    for name in os.listdir(run_dir):
        m = pat.match(name)
        if m and int(m.group(1)) > best_it:
            best_it = int(m.group(1))
            best = os.path.join(run_dir, name)
    return best


def checkpoint_due(iteration: int, kind: str) -> bool:
    """Reference checkpoint cadence. CMB: every 1000 iterations (reference
    ``train.py:175``). newmethod: every 10000 until 45000, then every 1000
    (reference ``train_newmethod.py:181-188``)."""
    if iteration <= 0:
        return False
    if kind == "newmethod":
        if iteration <= 45_000:
            return iteration % 10_000 == 0
        return iteration % 1000 == 0
    return iteration % 1000 == 0


def checkpoint_points(start: int, end: int, kind: str) -> list[int]:
    """All cadence points in ``(start, end]``, in order: one record block
    can cross several, and each gets its own ``model_<point>`` file holding
    the block-end state."""
    return [i for i in range(start + 1, end + 1) if checkpoint_due(i, kind)]
