"""K3 and K4: the fused MLP backward, and the differentiable fused forward+tangents.

K3 replaces the JAX package's TPU kernel ``ops/kernels_vjp.py::
packed_mlp_bwd`` with ``impl='stream'`` (``pallas_call`` at ``:805``, body
``_make_bwd_kernel_stream(train_epilogue=0)``); K4 replaces the same call
with ``impl='rebuild'`` (body ``_make_bwd_kernel``, ``:268``, segmented
recomputation). Both compute the backward of the custom VJP
``fused_apply_with_tangents``: given output cotangents ``ybar (N, d_out)``
and ``dybar (K, N, d_out)`` of ``(y, dy) = mlp_apply_with_tangents(params,
coords, e_0..e_{K-1})``, every parameter gradient. The kernels are CUDA
C++ in ``csrc/mlp_bwd.cu`` (K3, every layer state stored) and
``csrc/mlp_bwd_rebuild.cu`` (K4, checkpoints and a segment buffer), both on
the walk of ``csrc/mlp_bwd_common.cuh``, which K1 shares (design and bound
in their headers), built by ``ops.cuda_build``. Tiers ``f32``, ``bf16``
and ``f32x3`` (``ops.tiers``).

Shapes: every net the Pallas kernels take (``ops/widths.py``): the narrow
bodies for width <= 32 and ``d_in, d_out <= 8`` (at the next compiled
width, padded exactly, where the width was not compiled; the padded
gradients are sliced away), the wide body (``csrc/mlp_bwd_wide.cu`` on
``csrc/mlp_wide.cuh``, K3 and K4 by ``-DWIDE_REBUILD``; plan
:mod:`ops.wide_plan`) for width 33-128 or ``d_in``/``d_out`` above 8.

``impl='auto'`` resolves per tier through ``ops.tiers.BWD_IMPL_DEFAULT``,
the JAX package's default: ``f32`` and ``f32x3`` -> ``'stream'`` (K3),
``bf16`` -> ``'rebuild'`` (K4).

Beside the kernels, per the port's rules:

* the plain PyTorch version :func:`packed_mlp_bwd_plain`, K3's and K4's
  function: at ``f32`` autograd of ``models.mlp.mlp_apply_with_tangents``
  with the given cotangents, at ``bf16`` and ``f32x3`` the backward written out
  (``ops.tiers.tier_backward``);
* the wrappers :func:`packed_mlp_bwd` (K3) and
  :func:`packed_mlp_bwd_rebuild` (K4): CPU tensors take the plain version,
  CUDA tensors launch the kernel or raise — no fallback;
* the launch counts ``packed_mlp_bwd.launches`` (K3) and
  ``packed_mlp_bwd_rebuild.launches`` (K4), one per launch (the kernel and
  its fixed-order reduction), and per tier (``.launches_by_tier``).

:class:`FusedApplyWithTangents` is the ``torch.autograd.Function`` of the
JAX custom VJP: its forward is K2 (``ops.kernels.mlp_fwd_tangents``), its
backward :func:`packed_mlp_bwd` with the Function's ``bwd_impl``.
"""

from __future__ import annotations

import torch

from pinn_depthestimation_tpu_torch.models.mlp import PARAM_KEYS, MLPSpec
from pinn_depthestimation_tpu_torch.ops import kernels, tiers, wide_plan, widths
from pinn_depthestimation_tpu_torch.ops.cuda_build import k3_library, k4_library, wide_library
from pinn_depthestimation_tpu_torch.ops.kernels import (
    _ACT,
    _MAX_POINTS,
    MAX_TANGENTS,
    _on_cuda,
    check_precision,
    entry,
)
from pinn_depthestimation_tpu_torch.ops.kernels_step import n_flat, unflatten, unpad_flat
from pinn_depthestimation_tpu_torch.ops.tiers import BWD_IMPL_DEFAULT
from pinn_depthestimation_tpu_torch.ops.walk_plan import card_plan
from pinn_depthestimation_tpu_torch.tracing import count_launch, reset_launches


def kernel_supports(spec: MLPSpec) -> bool:
    """Whether K3 and K4 take this architecture: the Pallas kernels'
    shapes, at least one hidden layer and ``max(width, d_in, d_out) <= 128``
    (:func:`ops.widths.structurally_ok`)."""
    return widths.structurally_ok(spec)


def resolve_impl(impl: str, precision: str) -> str:
    """``'auto'`` -> the tier's default (``BWD_IMPL_DEFAULT``); ``'stream'``
    (K3) and ``'rebuild'`` (K4) as they are."""
    check_precision(precision, "K3/K4")
    if impl == "auto":
        return BWD_IMPL_DEFAULT[precision]
    if impl not in ("stream", "rebuild"):
        raise ValueError(f"impl must be 'auto', 'stream' or 'rebuild', got {impl!r}")
    return impl


# ------------------------------------------------------------ plain version

def packed_mlp_bwd_plain(params, coords, ybar, dybar, spec: MLPSpec, n_tangents: int,
                         precision: str = "f32"):
    """Plain PyTorch K3/K4: the parameter gradients of ``(y, dy) =
    mlp_fwd_tangents_plain(params, coords, spec, n_tangents, precision)``
    for the cotangents ``(ybar, dybar)``. ``f32``: ``torch.autograd.grad``;
    ``bf16``, ``f32x3``: the tier's backward written out (``ops.tiers``)."""
    check_precision(precision, "K3/K4")
    if precision != "f32":
        fwd = tiers.tier_forward(params, coords.detach(), spec, n_tangents, precision)
        return tiers.tier_backward(params, coords.detach(), fwd, ybar, dybar[:n_tangents],
                                   spec, precision)
    leaves = {k: params[k].detach().requires_grad_() for k in PARAM_KEYS}
    with torch.enable_grad():
        y, dy = kernels.mlp_fwd_tangents_plain(leaves, coords.detach(), spec, n_tangents)
        outputs, cotangents = [y], [ybar]
        if n_tangents:
            outputs.append(dy)
            cotangents.append(dybar)
        grads = torch.autograd.grad(outputs, [leaves[k] for k in PARAM_KEYS],
                                    grad_outputs=cotangents, allow_unused=True,
                                    materialize_grads=True)
    return dict(zip(PARAM_KEYS, grads))


# -------------------------------------------------------------- CUDA launch

def _check_launch(params, coords, ybar, dybar, spec: MLPSpec, n_tangents: int,
                  kernel: str = "K3") -> None:
    if spec.dropout_rate:
        raise ValueError(f"{kernel} does not support dropout")
    if not kernel_supports(spec):
        raise ValueError(
            f"{kernel} takes the Pallas kernels' shapes, >= 1 hidden layer and "
            f"max(width, d_in, d_out) <= {widths.MAX_DIM}; got sizes {spec.sizes}"
        )
    if not 0 <= n_tangents <= min(MAX_TANGENTS, spec.d_in):
        raise ValueError(f"{kernel} takes 0 <= n_tangents <= min(3, d_in), got {n_tangents}")
    n = coords.shape[0]
    if coords.dim() != 2 or coords.shape[1] != spec.d_in or n > _MAX_POINTS:
        raise ValueError(f"coords must be (N, {spec.d_in}) with N < 2^31, got {tuple(coords.shape)}")
    W, n_stack = spec.width, spec.n_hidden - 1
    shapes = {
        "ybar": (n, spec.d_out), "dybar": (n_tangents, n, spec.d_out),
        "w_in": (spec.d_in, W), "b_in": (W,), "w_hidden": (n_stack, W, W),
        "b_hidden": (n_stack, W), "w_out": (W, spec.d_out), "b_out": (spec.d_out,),
    }
    tensors = {"coords": coords, "ybar": ybar, "dybar": dybar,
               **{k: params[k] for k in PARAM_KEYS}}
    for name, t in tensors.items():
        if t.device != coords.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"{kernel} takes contiguous float32 tensors on {coords.device}; {name} is "
                f"{t.dtype} on {t.device}, contiguous={t.is_contiguous()}"
            )
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shapes[name]}")


_WEIGHT_ORDER = ("w_in", "b_in", "w_hidden", "b_hidden", "w_out", "b_out")


def _launch_k3(params, coords, ybar, dybar, spec: MLPSpec, n_tangents: int,
               precision: str = "f32", lib=None) -> torch.Tensor:
    """K3 + its reduction; returns the flat ``(n_flat,)`` gradients in
    ``kernels_step.FLAT_KEYS`` order, on the body :func:`ops.widths.route`
    picks: the narrow one (:func:`_launch_k3_narrow`) or the wide one
    (:func:`_launch_wide`). ``lib``: another build of the narrow K3 for this
    width (a check of a rebuilt source)."""
    if lib is not None:
        return _launch_k3_narrow(params, coords, ybar, dybar, spec, n_tangents, precision, lib)
    return widths.route(
        spec, params,
        lambda p, s: _launch_k3_narrow(p, coords, ybar, dybar, s, n_tangents, precision),
        lambda p, s: _launch_wide("k3", p, coords, ybar, dybar, s, n_tangents, precision),
        unpad_flat)


def _launch_k3_narrow(params, coords, ybar, dybar, spec: MLPSpec, n_tangents: int,
                      precision: str = "f32", lib=None) -> torch.Tensor:
    """K3's narrow body + its reduction at ``spec``'s (compiled) width."""
    lib = lib or k3_library().libs[spec.width]
    dev = coords.device
    n, W, n_stack = coords.shape[0], spec.width, spec.n_hidden - 1
    plan = card_plan(lib, "k3", precision, n, dev)
    partial, states, out = plan.scratch(n_flat(spec), n_stack + 1, 1 + n_tangents, W, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = entry(lib, "k3_mlp_bwd", precision)(
            coords.data_ptr(), ybar.data_ptr(), dybar.data_ptr() if n_tangents else None,
            *(params[k].data_ptr() for k in _WEIGHT_ORDER),
            partial.data_ptr(), states.data_ptr(), out.data_ptr(),
            n, spec.d_in, spec.d_out, n_stack, n_tangents, _ACT[spec.init_type], plan.grid,
            plan.tile, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"K3 launch failed: CUDA error {err} ({lib.k3_error_string(err).decode()}) "
            f"at sizes {spec.sizes}, N={n}, K={n_tangents}, precision={precision}, "
            f"tile={plan.tile}, grid={plan.grid}"
        )
    return out


def rebuild_ckpt_every(spec: MLPSpec, n_tangents: int, precision: str,
                       ckpt_every: int = 0, lib=None, *, n_points: int) -> int:
    """K4's segment length C on the current card for a launch on
    ``n_points`` points (the tile of :func:`ops.walk_plan.walk_plan` sets
    the segment buffer's size): ``ckpt_every`` cut to the stack depth, or
    with 0 the largest C <= 8 that leaves the whole stack in one
    shared-memory chunk, else half of it (``mlp_bwd::rebuild_plan``). Raises
    when the segment buffer does not fit. ``lib``: another build of K4."""
    if lib is None:
        width = widths.narrow_width(spec)
        if width is None:
            return wide_plan.ckpt_every(spec.n_hidden - 1, ckpt_every)
        spec = widths.padded_spec(spec, width)
        lib = k4_library().libs[width]
    plan = card_plan(lib, "k4", precision, n_points, torch.cuda.current_device())
    return _ckpt_every(lib, spec, n_tangents, precision, ckpt_every, plan.tile)


def _ckpt_every(lib, spec: MLPSpec, n_tangents: int, precision: str, ckpt_every: int,
                tile: int) -> int:
    """:func:`rebuild_ckpt_every` for a launch whose plan has ``tile``."""
    c = entry(lib, "k4_ckpt_every", precision)(spec.n_hidden - 1, n_tangents, ckpt_every, tile)
    if c < 1:
        raise ValueError(
            f"K4: a segment buffer of {ckpt_every} states does not fit in shared memory "
            f"at sizes {spec.sizes}, K={n_tangents}, precision={precision}, tile={tile}"
        )
    return c


def _launch_k4(params, coords, ybar, dybar, spec: MLPSpec, n_tangents: int,
               precision: str, ckpt_every: int = 0, lib=None) -> torch.Tensor:
    """K4 + its reduction; returns the flat ``(n_flat,)`` gradients in
    ``kernels_step.FLAT_KEYS`` order, routed as :func:`_launch_k3`.
    ``lib``: another build of the narrow K4 for this width (a check of a
    rebuilt source)."""
    if lib is not None:
        return _launch_k4_narrow(params, coords, ybar, dybar, spec, n_tangents, precision,
                                 ckpt_every, lib)
    return widths.route(
        spec, params,
        lambda p, s: _launch_k4_narrow(p, coords, ybar, dybar, s, n_tangents, precision,
                                       ckpt_every),
        lambda p, s: _launch_wide("k4", p, coords, ybar, dybar, s, n_tangents, precision,
                                  ckpt_every),
        unpad_flat)


def _launch_k4_narrow(params, coords, ybar, dybar, spec: MLPSpec, n_tangents: int,
                      precision: str, ckpt_every: int = 0, lib=None) -> torch.Tensor:
    """K4's narrow body + its reduction at ``spec``'s (compiled) width."""
    lib = lib or k4_library().libs[spec.width]
    dev = coords.device
    n, W, n_stack = coords.shape[0], spec.width, spec.n_hidden - 1
    plan = card_plan(lib, "k4", precision, n, dev)
    c = _ckpt_every(lib, spec, n_tangents, precision, ckpt_every, plan.tile)
    partial, states, out = plan.scratch(n_flat(spec), max(1, -(-n_stack // c)),
                                        1 + n_tangents, W, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = entry(lib, "k4_mlp_bwd", precision)(
            coords.data_ptr(), ybar.data_ptr(), dybar.data_ptr() if n_tangents else None,
            *(params[k].data_ptr() for k in _WEIGHT_ORDER),
            partial.data_ptr(), states.data_ptr(), out.data_ptr(),
            n, spec.d_in, spec.d_out, n_stack, n_tangents, _ACT[spec.init_type], c, plan.grid,
            plan.tile, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"K4 launch failed: CUDA error {err} ({lib.k4_error_string(err).decode()}) "
            f"at sizes {spec.sizes}, N={n}, K={n_tangents}, C={c}, precision={precision}, "
            f"tile={plan.tile}, grid={plan.grid}"
        )
    return out


def _launch_wide(kernel: str, params, coords, ybar, dybar, spec: MLPSpec, n_tangents: int,
                 precision: str, ckpt_every: int = 0, lib=None) -> torch.Tensor:
    """K3's or K4's wide body (``kernel`` ``'k3'`` or ``'k4'``) + its
    reduction on the plan of :func:`ops.wide_plan.card_plan`; the flat
    ``(n_flat,)`` gradients in ``kernels_step.FLAT_KEYS`` order. ``lib``:
    another build of that wide body (a check of a rebuilt source)."""
    lib = lib or wide_library(kernel)
    dev = coords.device
    n = coords.shape[0]
    plan = wide_plan.card_plan(kernel, n, spec, n_tangents, precision, dev, ckpt_every)
    image, partial, states, out = plan.scratch(n_flat(spec), dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = entry(lib, f"{kernel}w_mlp_bwd", precision)(
            coords.data_ptr(), ybar.data_ptr(), dybar.data_ptr() if n_tangents else None,
            *(params[k].data_ptr() for k in _WEIGHT_ORDER),
            image.data_ptr(), partial.data_ptr(), states.data_ptr(), out.data_ptr(),
            n, spec.d_in, spec.d_out, spec.n_hidden - 1, n_tangents, _ACT[spec.init_type],
            plan.ckpt_every, spec.width, plan.grid, plan.tile, stream,
        )
    if err != 0:
        msg = getattr(lib, f"{kernel}w_error_string")(err).decode()
        raise RuntimeError(
            f"{kernel.upper()} (wide) launch failed: CUDA error {err} ({msg}) at sizes "
            f"{spec.sizes}, N={n}, K={n_tangents}, precision={precision}, tile={plan.tile}, "
            f"grid={plan.grid}, smem={plan.smem}, C={plan.ckpt_every}"
        )
    return out


# ----------------------------------------------------------------- wrappers

def packed_mlp_bwd(params, coords, ybar, dybar, spec: MLPSpec, n_tangents: int,
                   *, precision: str = "f32", impl: str = "auto") -> dict[str, torch.Tensor]:
    """Parameter gradients of ``(y, dy) = mlp_apply_with_tangents(params,
    coords, e_0..e_{K-1})`` at the tier ``precision``, given output
    cotangents ``ybar (N, d_out)`` and ``dybar (K, N, d_out)``. Counterpart
    of the JAX ``ops.kernels_vjp.packed_mlp_bwd``. ``impl``: ``'stream'``
    is K3, ``'rebuild'`` is K4 (:func:`packed_mlp_bwd_rebuild`), ``'auto'``
    the tier's default. A CPU ``coords`` runs :func:`packed_mlp_bwd_plain`;
    a CUDA one launches the kernel."""
    if resolve_impl(impl, precision) == "rebuild":
        return packed_mlp_bwd_rebuild(params, coords, ybar, dybar, spec, n_tangents,
                                      precision=precision)
    if not _on_cuda(coords, "K3"):
        return packed_mlp_bwd_plain(params, coords, ybar, dybar, spec, n_tangents, precision)
    _check_launch(params, coords, ybar, dybar, spec, n_tangents, "K3")
    if coords.shape[0] == 0:
        return {k: torch.zeros_like(params[k]) for k in PARAM_KEYS}
    out = _launch_k3(params, coords, ybar, dybar, spec, n_tangents, precision)
    count_launch(packed_mlp_bwd, precision, spec)
    return unflatten(out, spec)


reset_launches(packed_mlp_bwd)


def packed_mlp_bwd_rebuild(params, coords, ybar, dybar, spec: MLPSpec, n_tangents: int,
                           *, precision: str = "f32",
                           ckpt_every: int = 0) -> dict[str, torch.Tensor]:
    """K4: :func:`packed_mlp_bwd`'s gradients by segmented recomputation
    (the JAX ``impl='rebuild'``), segments of ``ckpt_every`` layers (0: the
    planned C, :func:`rebuild_ckpt_every` at this call's point count). A
    CPU ``coords`` runs :func:`packed_mlp_bwd_plain`; a CUDA one launches
    K4."""
    check_precision(precision, "K4")
    if not _on_cuda(coords, "K4"):
        return packed_mlp_bwd_plain(params, coords, ybar, dybar, spec, n_tangents, precision)
    _check_launch(params, coords, ybar, dybar, spec, n_tangents, "K4")
    if coords.shape[0] == 0:
        return {k: torch.zeros_like(params[k]) for k in PARAM_KEYS}
    out = _launch_k4(params, coords, ybar, dybar, spec, n_tangents, precision, ckpt_every)
    count_launch(packed_mlp_bwd_rebuild, precision, spec)
    return unflatten(out, spec)


reset_launches(packed_mlp_bwd_rebuild)


class FusedApplyWithTangents(torch.autograd.Function):
    """``(y, dy)`` of the MLP with the first ``n_tangents`` coordinate
    tangents at the tier ``precision``: forward ``ops.kernels.
    mlp_fwd_tangents`` (K2 on the card), backward :func:`packed_mlp_bwd`
    with ``bwd_impl`` (K3 or K4 on the card). ``coords`` gets no gradient
    (``None``)."""

    @staticmethod
    def forward(ctx, spec, n_tangents, precision, bwd_impl, coords, *flat_params):
        params = dict(zip(PARAM_KEYS, flat_params))
        y, dy = kernels.mlp_fwd_tangents(params, coords, spec, n_tangents, precision=precision)
        ctx.save_for_backward(coords, *flat_params)
        ctx.spec, ctx.n_tangents = spec, n_tangents
        ctx.precision, ctx.bwd_impl = precision, bwd_impl
        return y, dy

    @staticmethod
    def backward(ctx, ybar, dybar):
        coords, *flat_params = ctx.saved_tensors
        params = dict(zip(PARAM_KEYS, flat_params))
        grads = packed_mlp_bwd(params, coords, ybar.contiguous(), dybar.contiguous(),
                               ctx.spec, ctx.n_tangents, precision=ctx.precision,
                               impl=ctx.bwd_impl)
        return (None, None, None, None, None, *(grads[k] for k in PARAM_KEYS))


def fused_apply_with_tangents(params, coords: torch.Tensor, spec: MLPSpec, n_tangents: int,
                              precision: str = "f32", bwd_impl: str = "auto"):
    """Differentiable fused forward + the first ``n_tangents`` coordinate
    tangents, ``(y (N, d_out), dy (K, N, d_out))``, at the tier
    ``precision``; the backward is ``bwd_impl`` (:func:`packed_mlp_bwd`).
    Counterpart of the JAX ``ops.kernels_vjp.fused_apply_with_tangents``.

    ``coords`` is detached first, as the JAX function passes it through
    ``lax.stop_gradient``: the backward computes no coordinate gradient, so
    a loss that differentiates w.r.t. the coordinates must not be built on
    this path (use ``models.mlp.mlp_apply_with_tangents``, which
    differentiates fully)."""
    if spec.dropout_rate:
        raise ValueError("the fused forward+tangents does not support dropout")
    resolve_impl(bwd_impl, precision)
    return FusedApplyWithTangents.apply(spec, n_tangents, precision, bwd_impl, coords.detach(),
                                        *(params[k] for k in PARAM_KEYS))
