"""The precision tiers of the kernels, and their plain forward and backward.

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

What the ``f32x3`` (split-f32) tier computes (JAX ``ops/kernels.py:36-43``,
``_split_f32`` at ``:120-126``):

1. **The split.** An f32 value ``a`` becomes ``hi = bf16(a)`` and ``lo =
   bf16(a - hi)`` (:func:`split`), ~16 bits of ``a`` between them. The
   weights are split once (``_split_passes``); the tangent seeds are the
   rows of ``hi + lo`` of ``w_in``, in f32.
2. **Products.** Every product against a weight splits its runtime operand
   and runs as three bf16 products with f32 sums, added as
   ``(a_lo @ w_hi + a_hi @ w_lo) + a_hi @ w_hi`` (:func:`mm`; JAX
   ``kernels.py:257-262``, ``mm``/``mm_t`` at ``kernels_vjp.py:229-242``),
   at the same places as the bf16 tier rounds. The weight-gradient product
   splits *both* runtime operands (:func:`mm_tn`, ``kernels_vjp.py:243-248``),
   the input layer's coordinates included; the tangent-seed term of
   ``dw_in`` stays an f32 sum of ``ubar``. Biases, sums over points, act,
   act' and the loss epilogue stay f32.

The plain backward is written out (:func:`tier_backward`) and is not
autograd through a cast or a split: the backward of ``.to(torch.bfloat16)``
would round the *gradient*, which the JAX custom VJP (``_bwd_math``) does
not do. At ``f32`` the same functions compute the f32 function (rounding is
the identity); the port's f32 plain versions stay autograd of
``models.mlp.mlp_apply_with_tangents``. Every function here also runs in
float64, for a reference with exact sums (``chip_smoke.py::compare_tier``).
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import torch

from pinn_depthestimation_tpu_torch.models.mlp import MLPSpec

TIERS = ("f32", "f32x3", "bf16")
# packed_mlp_bwd(impl='auto') per tier: the JAX package's BWD_IMPL_DEFAULT
# (ops/kernels_vjp.py:95)
BWD_IMPL_DEFAULT = {"f32": "stream", "f32x3": "stream", "bf16": "rebuild"}


def check_precision(precision: str, kernel: str = "K2") -> None:
    """Every tier of :data:`TIERS` is ported; anything else is a
    ``ValueError`` naming ``kernel``."""
    if precision not in TIERS:
        raise ValueError(
            f"{kernel}: precision must be 'f32', 'f32x3' or 'bf16', got {precision!r}")


def rnd(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` rounded to the bf16 tier's operand type, back in ``x``'s type
    (the identity at the other tiers)."""
    if precision == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    return x


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The f32x3 split: ``hi = bf16(x)``, ``lo = bf16(x - hi)``, each
    bf16-valued in ``x``'s type."""
    hi = x.to(torch.bfloat16).to(x.dtype)
    return hi, (x - hi).to(torch.bfloat16).to(x.dtype)


def mm3(a: torch.Tensor, w_hi: torch.Tensor, w_lo: torch.Tensor) -> torch.Tensor:
    """The f32x3 product of a runtime operand ``a`` (split here) and a split
    weight: ``(a_lo @ w_hi + a_hi @ w_lo) + a_hi @ w_hi``. A product of two
    bf16 values is exact in f32, so matmuls of the split values are the
    tier's products."""
    a_hi, a_lo = split(a)
    return (a_lo @ w_hi + a_hi @ w_lo) + a_hi @ w_hi


def mm_tn(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a.T @ b``, the weight-gradient product of two runtime operands: f32
    at ``f32`` and ``bf16``, both operands split at ``f32x3``."""
    if precision != "f32x3":
        return a.T @ b
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    return (a_lo.T @ b_hi + a_hi.T @ b_lo) + a_hi.T @ b_hi


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


class TierWeight(NamedTuple):
    """One weight at the tier: ``w`` is the rounded weight (bf16), the
    weight (f32) or its ``hi`` part (f32x3); ``lo`` the ``lo`` part at
    f32x3, else None."""

    w: torch.Tensor
    lo: torch.Tensor | None

    def value(self) -> torch.Tensor:
        """The weight the tier's products see, as one f32 tensor (``hi +
        lo`` at f32x3): the source of the tangent seeds."""
        return self.w if self.lo is None else self.w + self.lo

    def __getitem__(self, i):  # noqa: D105 - layer i of a stacked weight
        return TierWeight(self.w[i], None if self.lo is None else self.lo[i])

    @property
    def T(self) -> "TierWeight":
        return TierWeight(self.w.T, None if self.lo is None else self.lo.T)


class TierWeights(NamedTuple):
    w_in: TierWeight      # (d_in, W)
    w_hidden: TierWeight  # (n_stack, W, W)
    w_out: TierWeight     # (W, d_out)


def tier_weight(w: torch.Tensor, precision: str) -> TierWeight:
    if precision == "f32x3":
        return TierWeight(*split(w))
    return TierWeight(rnd(w, precision), None)


def tier_weights(params: Mapping[str, torch.Tensor], precision: str) -> TierWeights:
    return TierWeights(*(tier_weight(params[k], precision) for k in ("w_in", "w_hidden", "w_out")))


def mm(a: torch.Tensor, w: TierWeight, precision: str) -> torch.Tensor:
    """``a @ w`` at the tier: ``a`` rounded (bf16), split (f32x3, :func:`mm3`)
    or as it is (f32)."""
    if w.lo is not None:
        return mm3(a, w.w, w.lo)
    return rnd(a, precision) @ w.w


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
        z = mm(coords, w.w_in, precision) + params["b_in"]
        a = _act(it, z)
        # the seeds: rows 0..K-1 of the tier's w_in, one per point
        u = w.w_in.value()[:K, None, :].expand(K, coords.shape[0], spec.width)
        states_a, states_u = [a], [u]
        for l in range(spec.n_hidden - 1):
            wl = w.w_hidden[l]
            t = u * _dact(it, a)[None]
            z = mm(a, wl, precision) + params["b_hidden"][l]
            u = mm(t, wl, precision)
            a = _act(it, z)
            if not keep_states:
                states_a.clear()
                states_u.clear()
            states_a.append(a)
            states_u.append(u)
        t = u * _dact(it, a)[None]
        y = mm(a, w.w_out, precision) + params["b_out"]
        dy = mm(t, w.w_out, precision)
    return Forward(y, dy, states_a, states_u, w)


def _weight_grad(a: torch.Tensor, t: torch.Tensor, zbar: torch.Tensor, ubar: torch.Tensor,
                 K: int, precision: str) -> torch.Tensor:
    """``a.T @ zbar + sum_k t[k].T @ ubar[k]``: at f32x3 one split product
    over the stacked streams ``[a; t^0; ...]`` and ``[zbar; ubar^0; ...]``
    (JAX's one ``mm_tn`` over the stack), else f32 products."""
    if precision == "f32x3":
        return mm_tn(torch.cat([a] + [t[k] for k in range(K)]),
                     torch.cat([zbar] + [ubar[k] for k in range(K)]), precision)
    g = a.T @ zbar
    for k in range(K):
        g = g + t[k].T @ ubar[k]
    return g


def tier_backward(params: Mapping[str, torch.Tensor], coords: torch.Tensor, fwd: Forward,
                  ybar: torch.Tensor, dybar: torch.Tensor, spec: MLPSpec,
                  precision: str) -> dict[str, torch.Tensor]:
    """Every parameter gradient, summed over points, of the tier's
    ``(y, dy)`` for the cotangents ``ybar (N, d_out)`` and ``dybar (K, N,
    d_out)``: the JAX ``_bwd_math`` walk written out in PyTorch (``mm_t``
    takes the cotangent stack at the tier, ``mm_tn`` is f32 or split at
    f32x3, the tangent seeds add their f32 column sums to ``w_in``'s rows)."""
    it = spec.init_type
    w = fwd.w
    K = dybar.shape[0] if dybar.dim() == 3 else 0
    n_stack = spec.n_hidden - 1
    with torch.no_grad():
        a_L, u_L = fwd.a[-1], fwd.u[-1]
        t_L = u_L * _dact(it, a_L)[None]
        g_w_out = _weight_grad(a_L, t_L, ybar, dybar, K, precision)
        g_b_out = ybar.sum(0)
        abar = mm(ybar, w.w_out.T, precision)
        tbar = mm(dybar[:K], w.w_out.T, precision)
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
            g_w_h[j] = _weight_grad(a_prev, s_prev, zbar, ubar, K, precision)
            g_b_h[j] = zbar.sum(0)
            abar = mm(zbar, w.w_hidden[j].T, precision)
            tbar = mm(ubar, w.w_hidden[j].T, precision)
        a0, u0 = fwd.a[0], fwd.u[0]
        d0 = _dact(it, a0)
        dbar = (tbar * u0).sum(0)
        zbar0 = (abar + _ddact(it, a0, dbar)) * d0
        g_w_in = mm_tn(coords, zbar0, precision)  # the unrounded coordinates (bf16)
        for k in range(K):
            g_w_in[k] = g_w_in[k] + (tbar[k] * d0).sum(0)
        g_b_in = zbar0.sum(0)
    return {"w_in": g_w_in, "b_in": g_b_in, "w_hidden": g_w_h, "b_hidden": g_b_h,
            "w_out": g_w_out, "b_out": g_b_out}
