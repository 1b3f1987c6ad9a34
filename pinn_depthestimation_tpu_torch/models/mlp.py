"""The PINN MLP as plain functions on a dict of tensors.

Port of the JAX package's ``models/mlp.py``; same parameter layout, so both
packages compute from identical weights:

* ``w_in (d_in, W)``, ``b_in (W,)``;
* stacked hidden ``w_hidden (L-1, W, W)``, ``b_hidden (L-1, W)``;
* ``w_out (W, d_out)``, ``b_out (d_out,)``.

Weights are stored ``(in, out)`` and applied as ``x @ w`` (the reference's
torch ``Linear`` stores ``(out, in)``; ``utils.torch_interop`` transposes).

Capability parity with the reference ``DNN`` (reference ``dnn.py:5-55``):
tanh + Xavier-uniform or LeakyReLU(0.01) + Kaiming-uniform by ``init_type``;
zero biases except the final layer's; inverted dropout after every hidden
activation in training mode.

Numerics: the JAX package pins ``Precision.HIGHEST``; the port computes in
true float32 (TF32 is switched off when the package is imported), so the
two agree to f32 roundoff. ``MLPSpec`` therefore has no precision field.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np
import torch

PARAM_KEYS = ("w_in", "b_in", "w_hidden", "b_hidden", "w_out", "b_out")


@dataclass(frozen=True)
class MLPSpec:
    """Static architecture description."""

    sizes: tuple[int, ...]          # [d_in, W, W, ..., W, d_out]
    init_type: str = "xavier"       # 'xavier' (tanh) | 'kaiming' (leaky_relu)
    dropout_rate: float = 0.0

    def __post_init__(self):
        if len(self.sizes) < 2:
            raise ValueError("MLP needs at least input and output sizes")
        hidden = self.sizes[1:-1]
        if hidden and any(w != hidden[0] for w in hidden):
            raise ValueError(
                "hidden layers must share one width (reference builds "
                f"[in]+[width]*n+[out], train.py:56); got {self.sizes}"
            )
        if self.init_type not in ("xavier", "kaiming"):
            raise ValueError(f"init_type must be 'xavier' or 'kaiming', got {self.init_type!r}")

    @property
    def d_in(self) -> int:
        return self.sizes[0]

    @property
    def d_out(self) -> int:
        return self.sizes[-1]

    @property
    def width(self) -> int:
        return self.sizes[1] if len(self.sizes) > 2 else self.sizes[-1]

    @property
    def n_hidden(self) -> int:
        """Number of hidden layers (== reference config ``hidden_layers``)."""
        return len(self.sizes) - 2

    @classmethod
    def from_layers(cls, layers_cfg) -> "MLPSpec":
        return cls(
            sizes=tuple(layers_cfg.sizes),
            init_type=layers_cfg.init_type,
            dropout_rate=layers_cfg.dropout_rate,
        )


def _activation(init_type: str, z: torch.Tensor) -> torch.Tensor:
    if init_type == "xavier":
        return torch.tanh(z)
    return torch.where(z >= 0, z, 0.01 * z)  # LeakyReLU(0.01), dnn.py:21


def _activation_deriv(init_type: str, z: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Derivative of the activation given pre-activation z and activation a."""
    if init_type == "xavier":
        return 1.0 - a * a
    return torch.where(z >= 0, 1.0, 0.01).to(z.dtype)


def _weight_bound(init_type: str, fan_in: int, fan_out: int) -> float:
    # Xavier-uniform sqrt(6/(fan_in+fan_out)) == nn.init.xavier_uniform_
    # (reference dnn.py:47); Kaiming-uniform with the leaky_relu gain
    # sqrt(2) -> sqrt(6/fan_in) == nn.init.kaiming_uniform_ (dnn.py:45).
    if init_type == "xavier":
        return math.sqrt(6.0 / (fan_in + fan_out))
    return math.sqrt(6.0 / fan_in)


def _uniform(shape, bound: float, generator: torch.Generator, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype).uniform_(-bound, bound, generator=generator)


def init_mlp_params(
    generator: torch.Generator,
    spec: MLPSpec,
    *,
    device: str | torch.device,
    dtype=torch.float32,
) -> dict[str, torch.Tensor]:
    """Initialize the parameter dict.

    ``generator`` is a CPU ``torch.Generator``: the draws happen on the CPU
    and move to ``device``, so one seed gives one set of weights on every
    device. The numbers differ from the JAX package's ``jax.random`` draws
    for the same seed (same distributions, other bits); tests that compare
    the two packages hand both the same weights instead.

    Fans are taken per stacked hidden layer (``W`` in, ``W`` out), not over
    the stack.
    """
    d_in, d_out = spec.d_in, spec.d_out
    if spec.n_hidden < 1:
        # Degenerate single-Linear network: in -> out directly.
        w = _uniform((d_in, d_out), _weight_bound(spec.init_type, d_in, d_out), generator, dtype)
        b = _uniform((d_out,), 1.0 / math.sqrt(d_in), generator, dtype)
        params = {
            "w_in": torch.zeros((d_in, 0), dtype=dtype),
            "b_in": torch.zeros((0,), dtype=dtype),
            "w_hidden": torch.zeros((0, 0, 0), dtype=dtype),
            "b_hidden": torch.zeros((0, 0), dtype=dtype),
            "w_out": w,
            "b_out": b,
        }
        return {k: v.to(device) for k, v in params.items()}

    W = spec.width
    n_stack = spec.n_hidden - 1
    bound_hidden = _weight_bound(spec.init_type, W, W)
    params = {
        "w_in": _uniform((d_in, W), _weight_bound(spec.init_type, d_in, W), generator, dtype),
        "b_in": torch.zeros((W,), dtype=dtype),
        "w_hidden": _uniform((n_stack, W, W), bound_hidden, generator, dtype),
        "b_hidden": torch.zeros((n_stack, W), dtype=dtype),
        "w_out": _uniform((W, d_out), _weight_bound(spec.init_type, W, d_out), generator, dtype),
        # Final-layer bias keeps the framework-default uniform init: the
        # reference only zeroes biases on non-final layers (dnn.py:33,51-52).
        "b_out": _uniform((d_out,), 1.0 / math.sqrt(W), generator, dtype),
    }
    return {k: v.to(device) for k, v in params.items()}


def num_params(params: Mapping[str, torch.Tensor]) -> int:
    return sum(int(p.numel()) for p in params.values())


def params_from_numpy(
    d: Mapping[str, np.ndarray], device: str | torch.device
) -> dict[str, torch.Tensor]:
    """The exchange dict (six numpy arrays under :data:`PARAM_KEYS`, the JAX
    package's parameter pytree as numpy) -> float32 tensors on ``device``."""
    missing = [k for k in PARAM_KEYS if k not in d]
    if missing:
        raise KeyError(f"parameter exchange dict lacks {missing}")
    return {
        k: torch.as_tensor(np.asarray(d[k], dtype=np.float32)).to(device).contiguous()
        for k in PARAM_KEYS
    }


def params_to_numpy(p: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Inverse of :func:`params_from_numpy`: float32 numpy arrays on the host."""
    return {k: p[k].detach().to("cpu", torch.float32).numpy() for k in PARAM_KEYS}


def _dropout(a: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    keep = 1.0 - rate
    mask = torch.rand(a.shape, generator=generator, device=a.device, dtype=a.dtype) < keep
    return torch.where(mask, a / keep, torch.zeros_like(a))


def mlp_apply(
    params: Mapping[str, torch.Tensor],
    x: torch.Tensor,
    spec: MLPSpec,
    *,
    dropout_generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Forward pass. ``x``: ``(..., d_in)`` -> ``(..., d_out)``.

    Dropout (inverted, as ``torch.nn.Dropout``) follows every hidden
    activation when ``dropout_generator`` is given and
    ``spec.dropout_rate > 0`` (training mode); the generator lives on
    ``x``'s device. Inference passes none, matching ``model.eval()``
    (reference ``test.py:38``).
    """
    rate = spec.dropout_rate
    use_dropout = dropout_generator is not None and rate > 0.0

    if spec.n_hidden < 1:
        return x @ params["w_out"] + params["b_out"]

    a = _activation(spec.init_type, x @ params["w_in"] + params["b_in"])
    if use_dropout:
        a = _dropout(a, rate, dropout_generator)
    for w, b in zip(params["w_hidden"], params["b_hidden"]):
        a = _activation(spec.init_type, a @ w + b)
        if use_dropout:
            a = _dropout(a, rate, dropout_generator)
    return a @ params["w_out"] + params["b_out"]


def mlp_apply_with_tangents(
    params: Mapping[str, torch.Tensor],
    x: torch.Tensor,
    tangents: Sequence[torch.Tensor] | torch.Tensor,
    spec: MLPSpec,
):
    """Forward pass fused with K directional (JVP) derivatives.

    ``tangents``: ``(K, ..., d_in)`` (or a sequence of ``(..., d_in)``)
    direction vectors; typically the coordinate basis ``e_x``, ``e_y``.

    Returns ``(y, dy)`` with ``y: (..., d_out)`` and ``dy: (K, ..., d_out)``.
    The primal activations are shared across all tangents: one pass in all.
    Deterministic only (no dropout), as in the JAX package.
    """
    if not isinstance(tangents, torch.Tensor):
        tangents = torch.stack(list(tangents), dim=0)
    init_type = spec.init_type

    if spec.n_hidden < 1:
        w = params["w_out"]
        return x @ w + params["b_out"], tangents @ w

    z = x @ params["w_in"] + params["b_in"]
    a = _activation(init_type, z)
    t = (tangents @ params["w_in"]) * _activation_deriv(init_type, z, a)[None]
    for w, b in zip(params["w_hidden"], params["b_hidden"]):
        z = a @ w + b
        a = _activation(init_type, z)
        t = (t @ w) * _activation_deriv(init_type, z, a)[None]

    y = a @ params["w_out"] + params["b_out"]
    dy = t @ params["w_out"]
    return y, dy
