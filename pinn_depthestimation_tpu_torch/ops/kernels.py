"""K2: the fused MLP forward + coordinate-tangents kernel, for Hopper.

Replaces the JAX package's TPU kernel ``ops/kernels.py::_mlp_kernel``
(launched by ``packed_mlp_fwd_tangents_raw``; wrapped by
``packed_mlp_fwd_tangents`` and ``fused_residual_continuity``). The kernel
is CUDA C++ in ``csrc/mlp_fwd_tangents.cu``, built by ``ops.cuda_build``.
It computes what ``models.mlp.mlp_apply_with_tangents`` computes for the
coordinate-basis tangents, and none of the TPU's lane packing carries over.

f32: a point takes one or two lanes, each keeping its share of the primal's
and the K tangent streams' neurons in registers and taking a layer's inputs
from its partner by shuffles, on a persistent grid that stages the hidden
stack once per block (the plan: :func:`ops.k2_plan.f32_plan`); every output
keeps the bits of one thread a point. What bounds it on the H100: FLOPs,
not bytes. Per point it does ``2*(d_in*W + (L-1)*W^2
+ W*d_out)*(1+K)`` FLOPs (about 238,000 for the 2->[20]x100->3 flagship at
K=2, plus 100*W tanh) against about 12 B of device memory, so it is bound by
the CUDA cores' FMA rate (``SMs x 128 lanes x 2 x SM clock``); f32 stays
true f32 there (TF32 is not).

bf16 and f32x3 (defined in ``ops.tiers``: bf16 operands, f32 sums; f32x3
three products of (hi, lo) splits, ``(a_lo w_hi + a_hi w_lo) + a_hi w_hi``)
run on the tensor cores (``csrc/mlp_fwd_tangents_mma.cuh``): a warp owns 16
points, each of the 1+K streams is the m16 operand of ``mma.sync``
m16n8k16 products against the layer's B fragments, and a layer's
accumulators are the next layer's operands, rounded or split in registers.
Its launch plan (a persistent grid, the stack's chunks) is
:mod:`ops.k2_plan`'s. The tensor cores' bound is a few percent of the time:
what binds is the CUDA cores' issue of everything around the products
(accurate tanhf, act', the conversions; ``PERF.md``).

Shapes: every net the Pallas kernel takes (``ops/widths.py``): the narrow
body above for width <= 32 and ``d_in, d_out <= 8`` (at the next compiled
width, padded exactly, where the width was not compiled), the wide body
(``csrc/mlp_fwd_tangents_wide.cu`` on ``csrc/mlp_wide.cuh``, the width at
run time, plan :mod:`ops.wide_plan`) for width 33-128 or ``d_in``/``d_out``
above 8.

Beside the kernel, per the port's rules:

* the plain PyTorch version (:func:`mlp_fwd_tangents_plain`,
  :func:`residual_continuity_plain`), which the CPU runs and the card
  checks the kernel against;
* the wrappers :func:`mlp_fwd_tangents` and
  :func:`fused_residual_continuity`: for a CPU tensor they take the plain
  version, for a CUDA tensor they launch the kernel or raise — no fallback;
* a launch count on each wrapper (``mlp_fwd_tangents.launches``,
  ``fused_residual_continuity.launches``), raised by one per launch, and
  the same count per tier (``.launches_by_tier``) and per body
  (``.launches_by_body``: ``narrow`` or ``wide``), by
  :func:`tracing.count_launch`;
* the span ``residual#k2`` over each :func:`fused_residual_continuity`
  call (:mod:`tracing`).
"""

from __future__ import annotations

from typing import Mapping

import torch

from pinn_depthestimation_tpu_torch import tracing
from pinn_depthestimation_tpu_torch.models.mlp import MLPSpec, mlp_apply_with_tangents
from pinn_depthestimation_tpu_torch.ops.cuda_build import k2_library, wide_library
from pinn_depthestimation_tpu_torch.ops import k2_plan, tiers, wide_plan, widths
from pinn_depthestimation_tpu_torch.ops.tiers import check_precision
from pinn_depthestimation_tpu_torch.physics import continuity_only_residuals
from pinn_depthestimation_tpu_torch.tracing import count_launch, reset_launches

MAX_TANGENTS = widths.MAX_TANGENTS
_MAX_POINTS = 2**31 - 256  # the kernel indexes blocks and points with int
_ACT = {"xavier": 0, "kaiming": 1}  # tanh, LeakyReLU(0.01)


def kernel_supports(spec: MLPSpec) -> bool:
    """Whether K2 takes this architecture: the Pallas kernel's shapes, at
    least one hidden layer and ``max(width, d_in, d_out) <= 128``
    (:func:`ops.widths.structurally_ok`)."""
    return widths.structurally_ok(spec)


def _coordinate_tangents(coords: torch.Tensor, n_tangents: int) -> torch.Tensor:
    t = torch.zeros((n_tangents,) + tuple(coords.shape), dtype=coords.dtype, device=coords.device)
    for k in range(n_tangents):
        t[k, :, k] = 1.0
    return t


# ----------------------------------------------------------- plain versions

def mlp_fwd_tangents_plain(params, coords, spec: MLPSpec, n_tangents: int,
                           precision: str = "f32"):
    """Plain PyTorch K2: ``(y (N, d_out), dy (K, N, d_out))`` for the first
    ``n_tangents`` coordinate directions. ``f32``: ``mlp_apply_with_tangents``
    (differentiable); ``bf16`` and ``f32x3``: ``ops.tiers.tier_forward``."""
    check_precision(precision)
    if precision == "f32":
        return mlp_apply_with_tangents(
            params, coords, _coordinate_tangents(coords, n_tangents), spec
        )
    fwd = tiers.tier_forward(params, coords, spec, n_tangents, precision, keep_states=False)
    return fwd.y, fwd.dy


def residual_continuity_plain(params, coords, spec: MLPSpec,
                              precision: str = "f32") -> torch.Tensor:
    """Plain PyTorch K2 with the continuity epilogue: per-point
    ``d(hU)/dx + d(hV)/dy`` with heads ``(U, V, h)`` and inputs ``(x, y)``."""
    y, dy = mlp_fwd_tangents_plain(params, coords, spec, 2, precision)
    fields = {"U": y[:, 0], "V": y[:, 1], "h": y[:, 2]}
    grads = {c: {"U": dy[k][:, 0], "V": dy[k][:, 1], "h": dy[k][:, 2]}
             for k, c in enumerate(("x", "y"))}
    return continuity_only_residuals(fields, grads)


# ------------------------------------------------------------ CUDA launch

def _check_launch(params: Mapping[str, torch.Tensor], coords: torch.Tensor,
                  spec: MLPSpec, n_tangents: int) -> None:
    if not kernel_supports(spec):
        raise ValueError(
            "K2 takes the Pallas kernel's shapes, >= 1 hidden layer and "
            f"max(width, d_in, d_out) <= {widths.MAX_DIM}; got sizes {spec.sizes}"
        )
    if not 0 <= n_tangents <= min(MAX_TANGENTS, spec.d_in):
        raise ValueError(f"K2 takes 0 <= n_tangents <= min(3, d_in), got {n_tangents}")
    if coords.dim() != 2 or coords.shape[1] != spec.d_in or coords.shape[0] > _MAX_POINTS:
        raise ValueError(f"coords must be (N, {spec.d_in}) with N < 2^31, got {tuple(coords.shape)}")
    W, n_stack = spec.width, spec.n_hidden - 1
    shapes = {
        "w_in": (spec.d_in, W), "b_in": (W,), "w_hidden": (n_stack, W, W),
        "b_hidden": (n_stack, W), "w_out": (W, spec.d_out), "b_out": (spec.d_out,),
    }
    for name, t in [("coords", coords)] + [(k, params[k]) for k in shapes]:
        if t.device != coords.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"K2 takes contiguous float32 tensors on {coords.device}; {name} is "
                f"{t.dtype} on {t.device}, contiguous={t.is_contiguous()}"
            )
        if name != "coords" and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shapes[name]}")


def entry(lib, name: str, precision: str):
    """The C entry ``name`` of a kernel library at ``precision``: the f32
    entry is ``name``, the others ``name + '_bf16'`` and ``name +
    '_f32x3'``."""
    return getattr(lib, name if precision == "f32" else f"{name}_{precision}")


def _launch_k2(params, coords, spec: MLPSpec, n_tangents: int, precision: str, *,
               epilogue: bool, y=None, dy=None, fc=None, lib=None) -> None:
    """One K2 launch into ``y``/``dy`` or ``fc`` on the body
    :func:`ops.widths.route` picks: the narrow one (:func:`_launch_k2_narrow`)
    or the wide one (:func:`_launch_k2_wide`). ``lib``: another build of the
    narrow K2 for this width (a check of a rebuilt source)."""
    out = dict(epilogue=epilogue, y=y, dy=dy, fc=fc)
    if lib is not None:
        _launch_k2_narrow(params, coords, spec, n_tangents, precision, lib=lib, **out)
        return
    widths.route(
        spec, params,
        lambda p, s: _launch_k2_narrow(p, coords, s, n_tangents, precision, **out),
        lambda p, s: _launch_k2_wide(p, coords, s, n_tangents, precision, **out))


def _launch_k2_narrow(params, coords, spec: MLPSpec, n_tangents: int, precision: str, *,
                      epilogue: bool, y=None, dy=None, fc=None, lib=None,
                      lanes: int | None = None) -> None:
    """One launch of K2's narrow body at ``spec``'s (compiled) width, on the
    plan of :func:`ops.k2_plan.card_f32_plan` at f32 (grid, threads, lanes
    a point, chunk; ``lanes`` forces the lanes) or of
    :func:`ops.k2_plan.card_plan` at bf16 and f32x3 (grid, chunk)."""
    lib = lib or k2_library().libs[spec.width]
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    n, n_stack = coords.shape[0], spec.n_hidden - 1
    if precision == "f32":
        plan = k2_plan.card_f32_plan(lib, n, spec.width, n_stack, n_tangents, coords.device,
                                     lanes)
        extra = (plan.grid, plan.threads, plan.lanes, plan.chunk)
    else:
        plan = k2_plan.card_plan(lib, n, spec.width, n_stack, precision, coords.device)
        extra = (plan.grid, plan.chunk)
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream(coords.device).cuda_stream
        err = entry(lib, "k2_mlp_fwd_tangents", precision)(
            ptr(coords), ptr(params["w_in"]), ptr(params["b_in"]),
            ptr(params["w_hidden"]), ptr(params["b_hidden"]),
            ptr(params["w_out"]), ptr(params["b_out"]),
            ptr(y), ptr(dy), ptr(fc),
            n, spec.d_in, spec.d_out, n_stack,
            n_tangents, _ACT[spec.init_type], int(epilogue),
            *extra, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"K2 launch failed: CUDA error {err} "
            f"({lib.k2_error_string(err).decode()}) at sizes {spec.sizes}, "
            f"N={coords.shape[0]}, K={n_tangents}, epilogue={epilogue}, precision={precision}, "
            f"plan {plan}"
        )


def _launch_k2_wide(params, coords, spec: MLPSpec, n_tangents: int, precision: str, *,
                    epilogue: bool, y=None, dy=None, fc=None, lib=None) -> None:
    """One launch of K2's wide body on the plan of :func:`ops.wide_plan.
    card_plan`, its weight images in a scratch of the plan's bytes. ``lib``:
    another build of the wide K2 (a check of a rebuilt source)."""
    lib = lib or wide_library("k2")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    n = coords.shape[0]
    plan = wide_plan.card_plan("k2", n, spec, n_tangents, precision, coords.device)
    image = plan.scratch(0, coords.device)
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream(coords.device).cuda_stream
        err = entry(lib, "k2w_mlp_fwd_tangents", precision)(
            ptr(coords), ptr(params["w_in"]), ptr(params["b_in"]),
            ptr(params["w_hidden"]), ptr(params["b_hidden"]),
            ptr(params["w_out"]), ptr(params["b_out"]), ptr(image),
            ptr(y), ptr(dy), ptr(fc),
            n, spec.d_in, spec.d_out, spec.n_hidden - 1,
            n_tangents, _ACT[spec.init_type], int(epilogue),
            spec.width, plan.grid, plan.tile, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"K2 (wide) launch failed: CUDA error {err} ({lib.k2w_error_string(err).decode()}) "
            f"at sizes {spec.sizes}, N={n}, K={n_tangents}, epilogue={epilogue}, "
            f"precision={precision}, tile={plan.tile}, grid={plan.grid}, smem={plan.smem}"
        )


def _on_cuda(coords: torch.Tensor, kernel: str = "K2") -> bool:
    if coords.device.type == "cpu":
        return False
    if coords.device.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA tensors (CPU: plain version), got {coords.device}")
    return True


# --------------------------------------------------------------- wrappers

def mlp_fwd_tangents(params, coords: torch.Tensor, spec: MLPSpec, n_tangents: int,
                     *, precision: str = "f32"):
    """Fused forward + the first ``n_tangents`` coordinate tangents.
    Returns ``(y (N, d_out), dy (n_tangents, N, d_out))``.

    Counterpart of the JAX ``ops.kernels.packed_mlp_fwd_tangents``. A CPU
    ``coords`` runs :func:`mlp_fwd_tangents_plain`; a CUDA one launches K2
    at ``precision`` (``'f32'``, ``'bf16'`` or ``'f32x3'``).
    """
    check_precision(precision)
    if not _on_cuda(coords):
        return mlp_fwd_tangents_plain(params, coords, spec, n_tangents, precision)
    _check_launch(params, coords, spec, n_tangents)
    n = coords.shape[0]
    y = torch.empty((n, spec.d_out), dtype=torch.float32, device=coords.device)
    dy = torch.empty((n_tangents, n, spec.d_out), dtype=torch.float32, device=coords.device)
    if n:
        _launch_k2(params, coords, spec, n_tangents, precision, epilogue=False,
                   y=y, dy=dy if n_tangents else None)
        count_launch(mlp_fwd_tangents, precision, spec)
    return y, dy


reset_launches(mlp_fwd_tangents)


def fused_residual_continuity(params, coords: torch.Tensor, spec: MLPSpec,
                              *, precision: str = "f32") -> torch.Tensor:
    """Per-point continuity residual ``d(hU)/dx + d(hV)/dy`` (the residual
    bench's hot path), computed inside K2: one ``(N,)`` output.

    Needs heads ``(U, V, h)`` (``d_out == 3``) and inputs ``(x, y, ...)``.
    Counterpart of the JAX ``ops.kernels.fused_residual_continuity``. The
    whole call is the span ``residual#k2``.
    """
    with tracing.span("residual#k2"):
        check_precision(precision)
        if spec.d_out != 3 or spec.d_in < 2:
            raise ValueError(
                "the continuity epilogue needs d_out=3 heads (U, V, h) and "
                f"inputs (x, y, ...); got sizes {spec.sizes}"
            )
        if not _on_cuda(coords):
            return residual_continuity_plain(params, coords, spec, precision)
        _check_launch(params, coords, spec, 2)
        fc = torch.empty((coords.shape[0],), dtype=torch.float32, device=coords.device)
        if coords.shape[0]:
            _launch_k2(params, coords, spec, 2, precision, epilogue=True, fc=fc)
            count_launch(fused_residual_continuity, precision, spec)
        return fc


reset_launches(fused_residual_continuity)
