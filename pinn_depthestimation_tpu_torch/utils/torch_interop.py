"""Load reference PyTorch ``.pth`` checkpoints, and export the reference layout.

Port of the JAX package's ``utils/torch_interop.py``. The reference saves
WHOLE pickled modules — ``torch.save(self.dnn, ...)`` (reference
``train.py:178-179``) — and reloads them with ``torch.load`` (reference
``test.py:35-42``), so a migrating user owns ``model_<iter>.pth`` files whose
pickle stream names the class ``dnn.DNN``. This module turns such files (and
plain ``state_dict`` saves) into the parameter exchange dict (six float32
numpy arrays, ``models.mlp.PARAM_KEYS``), the same dict the JAX package's
loader returns.

Unpickling a whole module does not need the reference's source: pickle
restores an ``nn.Module`` via ``__class__`` + ``__dict__`` (``__init__``
never runs), so a stub class registered under the names the stream mentions
is enough.
"""

from __future__ import annotations

import re
import sys
import types
from typing import Mapping

import numpy as np
import torch

# Module/class names the reference's pickle streams reference
# (reference train.py:178 pickles instances of dnn.DNN).
_STUB_TARGETS = (("dnn", "DNN"),)


def _ensure_stub_modules() -> tuple[list, list]:
    """Register minimal stand-in classes so whole-module pickles resolve.

    Installs a stub only where the named module (or its class attribute) is
    absent. Returns ``(module_names, (module, attr) pairs)`` that were
    installed, so the caller can undo both after the load: a lingering stub
    module would shadow a later real ``import dnn``.
    """
    installed_modules, installed_attrs = [], []
    for mod_name, cls_name in _STUB_TARGETS:
        mod = sys.modules.get(mod_name)
        if mod is not None and hasattr(mod, cls_name):
            continue
        if mod is None:
            mod = types.ModuleType(mod_name)
            mod.__doc__ = "pinn_depthestimation_tpu_torch stub for torch unpickling"
            sys.modules[mod_name] = mod
            installed_modules.append(mod_name)
        else:
            installed_attrs.append((mod, cls_name))
        stub = type(cls_name, (torch.nn.Module,), {"__module__": mod_name})
        setattr(mod, cls_name, stub)
    return installed_modules, installed_attrs


def _linears_from_state_dict(state_dict: Mapping) -> list:
    """Pair ``<prefix>.weight`` / ``<prefix>.bias`` entries in LAYER order.

    When every prefix carries a layer index (the reference's
    ``layers.layer_<i>``), sort by it, since a re-serialized state_dict can
    arrive permuted and uniform hidden widths would hide scrambled layers;
    otherwise keep insertion order.
    """
    entries = []
    for key, value in state_dict.items():
        if key.endswith(".weight"):
            prefix = key[: -len(".weight")]
            bias_key = prefix + ".bias"
            if bias_key not in state_dict:
                raise ValueError(f"no bias found for {key!r}")
            nums = re.findall(r"\d+", prefix)
            entries.append((prefix, nums, value, state_dict[bias_key]))
    if not entries:
        raise ValueError("no '<prefix>.weight' entries found in state_dict")
    if all(nums for _, nums, _, _ in entries):
        entries.sort(key=lambda e: [int(n) for n in e[1]])
    return [(w, b) for _, _, w, b in entries]


def _as_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().to("cpu", torch.float32).numpy()
    return np.asarray(t, dtype=np.float32)


def params_from_torch_linears(weights_and_biases) -> dict[str, np.ndarray]:
    """(weight (out,in), bias (out,)) sequence -> parameter exchange dict.

    Torch stores Linear weights as (out_features, in_features); the
    functional layout is (in, out), transposed here once.
    """
    wb = [(_as_numpy(w).T, _as_numpy(b)) for w, b in weights_and_biases]
    if len(wb) < 2:
        raise ValueError(f"need at least input+output layers, got {len(wb)}")
    (w_in, b_in), hidden, (w_out, b_out) = wb[0], wb[1:-1], wb[-1]
    width = w_in.shape[1]
    for i, (w, _) in enumerate(hidden):
        if w.shape != (width, width):
            raise ValueError(
                f"hidden layer {i} has shape {w.shape}, expected ({width}, {width})"
            )
    if w_out.shape[0] != width:
        raise ValueError(
            f"output layer expects {w_out.shape[0]} inputs but the last "
            f"hidden width is {width} — inconsistent state_dict layer order"
        )
    if hidden:
        w_hidden = np.stack([w for w, _ in hidden])
        b_hidden = np.stack([b for _, b in hidden])
    else:
        w_hidden = np.zeros((0, width, width), np.float32)
        b_hidden = np.zeros((0, width), np.float32)
    return {
        "w_in": np.ascontiguousarray(w_in), "b_in": b_in,
        "w_hidden": w_hidden, "b_hidden": b_hidden,
        "w_out": np.ascontiguousarray(w_out), "b_out": b_out,
    }


def check_architecture(params: Mapping[str, np.ndarray], spec, where: str) -> None:
    """Raise when the parameter shapes disagree with ``spec``
    (``models.MLPSpec``): (d_in, width, n_hidden, d_out)."""
    expect = (spec.d_in, spec.width, spec.n_hidden, spec.d_out)
    got = (
        params["w_in"].shape[0], params["w_in"].shape[1],
        params["w_hidden"].shape[0] + 1, params["w_out"].shape[1],
    )
    if expect != got:
        raise ValueError(
            f"{where!r} architecture (d_in, width, n_hidden, d_out)={got} "
            f"does not match the config's {expect}"
        )


def params_from_torch_file(path: str, spec=None) -> dict[str, np.ndarray]:
    """Load a reference ``.pth`` checkpoint -> parameter exchange dict.

    Accepts a whole pickled ``dnn.DNN`` module (what the reference training
    loop saves) and a bare ``state_dict``. ``spec`` (``models.MLPSpec``)
    enables architecture validation against the config.

    Tries ``weights_only=True`` first (safe for ``state_dict`` saves); only
    whole-module pickles fall back to full unpickling, which executes code
    from the file by design — a warning names the file, and such files must
    be trusted (as the reference's own ``test.py:35`` requires).
    """
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except (OSError, EOFError):
        # Missing/unreadable/truncated file: not an unpickling-trust issue.
        raise
    except Exception:
        print(
            f"warning: {path!r} is not a plain state_dict; falling back to "
            "full unpickling (executes code from the file — trusted "
            "checkpoints only)",
            file=sys.stderr,
        )
        installed_modules, installed_attrs = _ensure_stub_modules()
        try:
            obj = torch.load(path, map_location="cpu", weights_only=False)
        finally:
            for name in installed_modules:  # don't shadow a later `import dnn`
                sys.modules.pop(name, None)
            for mod, attr in installed_attrs:  # undo foreign-module mutation
                try:
                    delattr(mod, attr)
                except AttributeError:
                    pass
    if isinstance(obj, torch.nn.Module):
        # The reference net is a Sequential of Linear/activation/Dropout
        # (reference dnn.py:25-40); traversal order == layer order.
        wb = [
            (m.weight, m.bias) for m in obj.modules() if isinstance(m, torch.nn.Linear)
        ]
    elif isinstance(obj, dict):
        wb = _linears_from_state_dict(obj)
    else:
        raise ValueError(
            f"{path!r}: expected a pickled nn.Module or a state_dict, "
            f"got {type(obj).__name__}"
        )
    params = params_from_torch_linears(wb)
    if spec is not None:
        check_architecture(params, spec, path)
    return params


def torch_state_dict_from_params(params: Mapping) -> dict[str, torch.Tensor]:
    """Parameter dict (tensors or the numpy exchange dict) -> CPU
    ``state_dict`` in the reference's key layout (``layers.layer_<i>.weight``
    / ``.bias``, reference ``dnn.py:35``), loadable into a reference ``DNN``
    with ``load_state_dict(strict=True)``. Weights go back to torch's
    (out_features, in_features) storage."""
    w_in = _as_numpy(params["w_in"])
    if w_in.shape[1] == 0:
        raise ValueError(
            "cannot export a zero-hidden-layer parameter set: the reference "
            "DNN layout has no representation for it"
        )
    wb = [(w_in, _as_numpy(params["b_in"]))]
    wb += list(zip(_as_numpy(params["w_hidden"]), _as_numpy(params["b_hidden"])))
    wb.append((_as_numpy(params["w_out"]), _as_numpy(params["b_out"])))
    out = {}
    for i, (w, b) in enumerate(wb):
        out[f"layers.layer_{i}.weight"] = torch.from_numpy(np.ascontiguousarray(w.T))
        out[f"layers.layer_{i}.bias"] = torch.from_numpy(np.ascontiguousarray(b))
    return out
