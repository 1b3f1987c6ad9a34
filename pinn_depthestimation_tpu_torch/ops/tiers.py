"""The precision tiers of the kernels, and the plain bf16 forward and backward.

What the ``bf16`` tier computes (the function K1, K2, K3 and K4 hold to at
``precision='bf16'``; taken from the JAX package's kernels, not from the
TPU's layout):

1. **Weights.** ``w_in``, ``w_hidden`` and ``w_out`` are rounded to bf16,
   round to nearest even (``astype(bfloat16)``; ``__float2bfloat16_rn`` in
   the kernels). Biases stay f32. The tangent seeds are the rows of the
   *rounded* ``w_in``, in f32 (JAX ``ops/kernels.py:158-172``,
   ``ops/kernels_vjp.py:146-154``).
2. **Forward products.** Every runtime operand is rounded to bf16 before it
   meets a bf16 weight, and the products accumulate in f32: the input
   coordinates before ``w_in``; the activation and each scaled tangent
   stream ``u * act'`` before each hidden weight; the last state before
   ``w_out`` (JAX ``mm`` at ``ops/kernels_vjp.py:250``, ``matmul`` at
   ``ops/kernels.py:262``). A product of two bf16 values is exact in f32,
   so an f32 product of the rounded values is exactly the tier's product.
3. **Backward products.** The stacked cotangent ``[zbar; ubar^k]`` is
   rounded to bf16 against the bf16 weight (``mm_t``, ``:253``). The
   weight-gradient products (``mm_tn``, ``:257``) take two f32 runtime
   operands and run in f32, as the JAX function computes them on the CPU;
   the input layer's gradient takes the unrounded coordinates. Sums over
   points, act, act' and the loss epilogue stay f32.

The plain backward is written out (:func:`tier_backward`) and is not
autograd through a cast: the backward of ``.to(torch.bfloat16)`` would
round the *gradient*, which the JAX custom VJP (``_bwd_math``) does not do.
At ``f32`` the same functions compute the f32 function (rounding is the
identity); the port's f32 plain versions stay autograd of
``models.mlp.mlp_apply_with_tangents``.

The ``f32x3`` tier is not ported (``ROADMAP.md`` Queue 2).
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import torch

from pinn_depthestimation_tpu_torch.models.mlp import MLPSpec

TIERS = ("f32", "bf16")
# packed_mlp_bwd(impl='auto') per tier: the JAX package's BWD_IMPL_DEFAULT
# (ops/kernels_vjp.py:95) for the tiers the port has
BWD_IMPL_DEFAULT = {"f32": "stream", "bf16": "rebuild"}


def check_precision(precision: str, kernel: str = "K2") -> None:
    """``f32`` and ``bf16`` are ported; ``f32x3`` raises
    ``NotImplementedError`` naming ``ROADMAP.md`` Queue 2; anything else is
    a ``ValueError``."""
    if precision in TIERS:
        return
    if precision == "f32x3":
        raise NotImplementedError(
            f"{kernel} precision tier 'f32x3' is not ported yet (ROADMAP.md Queue 2, "
            "'the f32x3 tier of K1-K4'); use kernel_precision 'f32', 'bf16' or 'auto'"
        )
    raise ValueError(f"precision must be 'f32', 'f32x3' or 'bf16', got {precision!r}")


def rnd(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` rounded to the tier's operand type, back in ``x``'s type
    (identity at f32). The tier's functions run in float64 too, for a
    reference with exact sums (``chip_smoke.py::compare_tier``)."""
    if precision == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    return x


def _act(init_type: str, z: torch.Tensor) -> torch.Tensor:
    return torch.tanh(z) if init_type == "xavier" else torch.where(z >= 0, z, 0.01 * z)


def _dact(init_type: str, a: torch.Tensor) -> torch.Tensor:
    """act' from the activation (for LeakyReLU sign(a) == sign(z))."""
    if init_type == "xavier":
        return 1.0 - a * a
    return torch.where(a >= 0, 1.0, 0.01).to(a.dtype)


def _ddact(init_type: str, a: torch.Tensor, dbar: torch.Tensor) -> torch.Tensor:
    """d(act')/da times dbar: -2*a*dbar for tanh, 0 for LeakyReLU."""
    if init_type == "xavier":
        return -2.0 * a * dbar
    return torch.zeros_like(a)


class TierWeights(NamedTuple):
    w_in: torch.Tensor      # (d_in, W), rounded
    w_hidden: torch.Tensor  # (n_stack, W, W), rounded
    w_out: torch.Tensor     # (W, d_out), rounded


def tier_weights(params: Mapping[str, torch.Tensor], precision: str) -> TierWeights:
    return TierWeights(*(rnd(params[k], precision) for k in ("w_in", "w_hidden", "w_out")))


class Forward(NamedTuple):
    y: torch.Tensor             # (N, d_out)
    dy: torch.Tensor            # (K, N, d_out)
    a: list[torch.Tensor]       # the activation of every state kept, (N, W) each
    u: list[torch.Tensor]       # the tangent streams before the act' scale, (K, N, W) each
    w: TierWeights


def tier_forward(params: Mapping[str, torch.Tensor], coords: torch.Tensor, spec: MLPSpec,
                 n_tangents: int, precision: str, keep_states: bool = True) -> Forward:
    """The forward with the first ``n_tangents`` coordinate tangents at the
    tier, keeping every layer state ``(a, u)`` (state 0 after the input
    layer, state ``l + 1`` after hidden layer ``l``) for
    :func:`tier_backward`, or only the last with ``keep_states=False``.
    Not differentiable."""
    if spec.n_hidden < 1:
        raise ValueError("the kernels' tiers need at least one hidden layer")
    it, K = spec.init_type, n_tangents
    w = tier_weights(params, precision)
    with torch.no_grad():
        z = rnd(coords, precision) @ w.w_in + params["b_in"]
        a = _act(it, z)
        # the seeds: rows 0..K-1 of the rounded w_in, one per point
        u = w.w_in[:K, None, :].expand(K, coords.shape[0], spec.width)
        states_a, states_u = [a], [u]
        for l in range(spec.n_hidden - 1):
            wl = w.w_hidden[l]
            t = u * _dact(it, a)[None]
            z = rnd(a, precision) @ wl + params["b_hidden"][l]
            u = rnd(t, precision) @ wl
            a = _act(it, z)
            if not keep_states:
                states_a.clear()
                states_u.clear()
            states_a.append(a)
            states_u.append(u)
        t = u * _dact(it, a)[None]
        y = rnd(a, precision) @ w.w_out + params["b_out"]
        dy = rnd(t, precision) @ w.w_out
    return Forward(y, dy, states_a, states_u, w)


def tier_backward(params: Mapping[str, torch.Tensor], coords: torch.Tensor, fwd: Forward,
                  ybar: torch.Tensor, dybar: torch.Tensor, spec: MLPSpec,
                  precision: str) -> dict[str, torch.Tensor]:
    """Every parameter gradient, summed over points, of the tier's
    ``(y, dy)`` for the cotangents ``ybar (N, d_out)`` and ``dybar (K, N,
    d_out)``: the JAX ``_bwd_math`` walk written out in PyTorch (``mm_t``
    rounds the cotangent stack, ``mm_tn`` stays f32, the tangent seeds add
    their column sums to ``w_in``'s rows)."""
    it = spec.init_type
    w = fwd.w
    K = dybar.shape[0] if dybar.dim() == 3 else 0
    n_stack = spec.n_hidden - 1
    with torch.no_grad():
        a_L, u_L = fwd.a[-1], fwd.u[-1]
        t_L = u_L * _dact(it, a_L)[None]
        g_w_out = a_L.T @ ybar
        for k in range(K):
            g_w_out = g_w_out + t_L[k].T @ dybar[k]
        g_b_out = ybar.sum(0)
        abar = rnd(ybar, precision) @ w.w_out.T
        tbar = rnd(dybar[:K], precision) @ w.w_out.T
        g_w_h = torch.zeros_like(params["w_hidden"])
        g_b_h = torch.zeros_like(params["b_hidden"])
        for j in range(n_stack - 1, -1, -1):
            a_cur, u_cur = fwd.a[j + 1], fwd.u[j + 1]
            d_cur = _dact(it, a_cur)
            dbar = (tbar * u_cur).sum(0)
            zbar = (abar + _ddact(it, a_cur, dbar)) * d_cur
            ubar = tbar * d_cur[None]
            a_prev = fwd.a[j]
            s_prev = fwd.u[j] * _dact(it, a_prev)[None]
            gw = a_prev.T @ zbar
            for k in range(K):
                gw = gw + s_prev[k].T @ ubar[k]
            g_w_h[j] = gw
            g_b_h[j] = zbar.sum(0)
            abar = rnd(zbar, precision) @ w.w_hidden[j].T
            tbar = rnd(ubar, precision) @ w.w_hidden[j].T
        a0, u0 = fwd.a[0], fwd.u[0]
        d0 = _dact(it, a0)
        dbar = (tbar * u0).sum(0)
        zbar0 = (abar + _ddact(it, a0, dbar)) * d0
        g_w_in = coords.T @ zbar0  # mm_tn: the unrounded coordinates
        for k in range(K):
            g_w_in[k] = g_w_in[k] + (tbar[k] * d0).sum(0)
        g_b_in = zbar0.sum(0)
    return {"w_in": g_w_in, "b_in": g_b_in, "w_hidden": g_w_h, "b_hidden": g_b_h,
            "w_out": g_w_out, "b_out": g_b_out}
