"""K1: the one-kernel training step of the continuity losses, for Hopper.

Replaces the JAX package's TPU kernel ``ops/kernels_step.py::_stats_and_grads``
(``pallas_call`` at ``:272``, the body ``ops/kernels_vjp.py::
_make_bwd_kernel_stream`` with ``train_epilogue``). For the flagship
configuration — newmethod, fidelity and residual on one point set,
``continuity_only``/``continuity_ftemp`` physics, heads ``(U, V, h)``, no
dropout — the loss and every parameter gradient come from one evaluation:

* residual = mean_masked(fc^2) [+ sum(sel*(h-depth)^2)/sum(sel) for
  ``continuity_only``], fc = d(hU)/dx + d(hV)/dy;
* fidelity = sum_j w_j * mean_masked((y_j - true_j)^2) over the true heads;
* total = w_fid*fidelity + w_res*residual.

The kernel is CUDA C++ in ``csrc/continuity_train_step.cu`` (design and
bound in its header), built by ``ops.cuda_build``. K1 *is* the value and
the gradient, so it is no ``torch.autograd.Function``: callers assign its
gradients to ``.grad`` themselves.

Beside the kernel, per the port's rules:

* the plain PyTorch version :func:`fused_loss_and_grad_plain` — at ``f32``
  ``torch.autograd.grad`` of :func:`shared_forward_loss_plain`, the same
  loss built on ``models.mlp.mlp_apply_with_tangents``, for any width; at
  ``bf16`` and ``f32x3`` the tier's forward (``ops.tiers.tier_forward``), the loss
  epilogue differentiated on its outputs, and the tier's backward written
  out (``ops.tiers.tier_backward``);
* the wrapper :func:`fused_loss_and_grad`: a CPU batch takes the plain
  version, a CUDA batch launches K1 or raises — no fallback;
* the launch count ``fused_loss_and_grad.launches``, one per evaluation (K1
  and its fixed-order reduction), and per tier
  (``fused_loss_and_grad.launches_by_tier``);
* the span ``step#k1`` over each :func:`fused_loss_and_grad` call
  (:mod:`tracing`).

Shapes: every net the Pallas kernel takes with heads ``(U, V, h)`` and
``d_in >= 2`` (``ops/widths.py``): the narrow body for width <= 32 and
``d_in <= 8`` (at the next compiled width, padded exactly, where the width
was not compiled; the padded gradients are sliced away), the wide body
(``csrc/continuity_train_step_wide.cu`` on ``csrc/mlp_wide.cuh``; plan
:mod:`ops.wide_plan`) for width 33-128 or ``d_in`` above 8.

The per-batch constants (``sel``, ``mask``, the trues, the denominators
and the cotangent scales) are built once by :func:`make_step_batch`; an
evaluation is then the kernel, the reduction and the combination of three
statistics, with no host synchronisation. Tiers ``f32``, ``bf16`` and
``f32x3`` (``ops.tiers``).

The plain form follows the batch's float type: a float64 batch (the f64
polish, ``training.driver.Trainer.train_f64_polish``) evaluates in float64
throughout. K1 itself takes float32 only.

Data parallelism (counterpart of the JAX ``fused_loss_and_grad_sharded``):
a batch is a list of shards. :func:`make_step_batches` builds one
:class:`StepBatch` per shard with the GLOBAL masked counts and scales, and
:func:`fused_loss_and_grad` runs K1 (or its plain statistics and gradients)
on each shard's rows, sums the flat ``(n_flat + 8,)`` outputs in shard order
on the first shard's device and combines the statistics once. With global
scales each shard's gradient is a partial sum of the full-batch gradient,
so the shards add exactly. An unsharded batch is the one-shard case.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from pinn_depthestimation_tpu_torch import tracing
from pinn_depthestimation_tpu_torch.models.mlp import PARAM_KEYS, MLPSpec, mlp_apply_with_tangents
from pinn_depthestimation_tpu_torch.ops import tiers, wide_plan, widths
from pinn_depthestimation_tpu_torch.ops.cuda_build import k1_library, wide_library
from pinn_depthestimation_tpu_torch.ops.walk_plan import card_plan
from pinn_depthestimation_tpu_torch.ops.kernels import (
    _ACT,
    _MAX_POINTS,
    _coordinate_tangents,
    _on_cuda,
    check_precision,
    entry,
)
from pinn_depthestimation_tpu_torch.tracing import count_launch, reset_launches

KT = 2  # the continuity losses differentiate w.r.t. (x, y) only
N_STATS = 8  # [sum fc^2, sum anch^2, sum err_j^2 (j < 3), unused]
# the order of JAX's ravel_pytree over the parameter dict (sorted keys), in
# which the kernel writes its gradients
FLAT_KEYS = tuple(sorted(PARAM_KEYS))


def _check_step_spec(spec: MLPSpec, n_true: int, has_anchor: bool) -> None:
    if spec.dropout_rate:
        raise ValueError("fused training step does not support dropout")
    if spec.d_out < 3 or not (0 < n_true <= 3):
        raise ValueError("fused training step needs (U, V, h) heads")
    if has_anchor and n_true > 2:
        raise ValueError(
            "the anchor selector rides the h column of the packed obs rows; "
            "3 observed fidelity heads collide with it (use the generic "
            "loss path for anchored 3-head configurations)"
        )


def kernel_supports(spec: MLPSpec) -> bool:
    """Whether K1 takes this architecture: the Pallas kernels' shapes (at
    least one hidden layer, ``max(width, d_in, d_out) <= 128``,
    :func:`ops.widths.structurally_ok`) with heads ``(U, V, h)`` only and
    ``d_in >= 2``."""
    return widths.structurally_ok(spec) and spec.d_in >= 2 and spec.d_out == 3


def _scales_from_counts(n_res, n_sel, fid_weights, n_true, w_fid, w_res, anchor_depth,
                        has_anchor):
    """The cotangent-scale vector ``[res_scale, anchor_scale, anchor_depth,
    fid_scale_0..]`` (8 floats, in the counts' dtype) from the global
    masked counts, batch statistics with zero parameter gradient."""
    res_scale = 2.0 * w_res / n_res
    anchor_scale = (2.0 * w_res / n_sel) if has_anchor else torch.zeros_like(n_res)
    fid_scales = 2.0 * w_fid * fid_weights.to(n_res.dtype) / n_res
    scal = torch.zeros((8,), dtype=n_res.dtype, device=n_res.device)
    scal[0] = res_scale
    scal[1] = anchor_scale
    scal[2] = anchor_depth
    scal[3 : 3 + n_true] = fid_scales
    return scal


def _combine_stats(stats, fid_weights, n_res, n_sel, n_true, w_fid, w_res, has_anchor):
    """Loss terms ``(total, fidelity, residual)`` from the statistics."""
    residual = stats[0] / n_res
    if has_anchor:
        residual = residual + stats[1] / n_sel
    fidelity = torch.sum(fid_weights.to(stats.dtype) * stats[2 : 2 + n_true]) / n_res
    total = w_fid * fidelity + w_res * residual
    return total, fidelity, residual


@dataclass(frozen=True)
class StepBatch:
    """The per-batch constants of a training step, on one device."""

    coords: torch.Tensor        # (N, d_in) residual == fidelity points
    trues: torch.Tensor         # (N, n_true) observed true heads
    sel: torch.Tensor           # (N,) anchor selector, already mask-multiplied
    mask: torch.Tensor          # (N,) validity (1.0 = real point)
    fid_weights: torch.Tensor   # (n_true,) per-output fidelity weights
    n_res: torch.Tensor         # sum(mask)
    n_sel: torch.Tensor         # sum(sel)
    scal: torch.Tensor          # (8,) cotangent scales (_scales_from_counts)
    n_true: int
    w_fid: float
    w_res: float
    anchor_depth: float
    has_anchor: bool


def make_step_batches(coords, trues, sel, mask, fid_weights, n_true: int, w_fid: float,
                      w_res: float, anchor_depth: float = 0.75,
                      has_anchor: bool = True) -> list[StepBatch]:
    """Build the constants once; every later evaluation reuses them. One
    :class:`StepBatch` per shard: ``coords``, ``trues``, ``sel`` and ``mask``
    are lists of the shards' rows, each on its device; the other arguments
    are those of the JAX ``fused_loss_and_grad``. Everything is cast to the
    float type of ``coords`` (float32 unless it is float64). The masked
    counts are summed over the shards in order on the first shard's device
    and every shard's scales are built from those GLOBAL counts, once per
    batch, before any launch (K1 reads its scales from device memory, so a
    shard's local counts would give a wrong gradient)."""
    shards = []
    for c, t, s, m in zip(coords, trues, sel, mask):
        dt = _batch_dtype(c)
        c = c.to(dt).contiguous()
        dev = c.device
        shards.append((c, t.to(dev, dt)[:, :n_true].contiguous(), s.to(dev, dt).contiguous(),
                       m.to(dev, dt).contiguous()))
    first = shards[0][0]
    fid_weights = torch.as_tensor(fid_weights, dtype=first.dtype).to(first.device)
    n_res = _sum_in_order([torch.sum(m).to(first.device) for _, _, _, m in shards])
    n_sel = _sum_in_order([torch.sum(s).to(first.device) for _, _, s, _ in shards])
    scal = _scales_from_counts(n_res, n_sel, fid_weights, n_true, float(w_fid), float(w_res),
                               float(anchor_depth), has_anchor)
    return [StepBatch(
        coords=c, trues=t, sel=s, mask=m, fid_weights=fid_weights.to(c.device),
        n_res=n_res.to(c.device), n_sel=n_sel.to(c.device), scal=scal.to(c.device),
        n_true=n_true, w_fid=float(w_fid), w_res=float(w_res),
        anchor_depth=float(anchor_depth), has_anchor=has_anchor,
    ) for c, t, s, m in shards]


def make_step_batch(coords, trues, sel, mask, *args, **kwargs) -> StepBatch:
    """:func:`make_step_batches` of one shard."""
    return make_step_batches([coords], [trues], [sel], [mask], *args, **kwargs)[0]


def _batch_dtype(coords: torch.Tensor) -> torch.dtype:
    return torch.float64 if coords.dtype == torch.float64 else torch.float32


def _shards(b) -> list[StepBatch]:
    """A batch as its list of shards (an unsharded batch is one shard)."""
    return [b] if isinstance(b, StepBatch) else list(b)


def _shard_params(params, shard: StepBatch, first: StepBatch):
    """``params`` as the shard sees them: the master copy itself on the
    first shard (which must hold it), a differentiable copy elsewhere."""
    if shard is first:
        return params
    return {k: params[k].to(shard.coords.device) for k in PARAM_KEYS}


def _sum_in_order(values: list[torch.Tensor]) -> torch.Tensor:
    out = values[0]
    for v in values[1:]:
        out = out + v
    return out


# ------------------------------------------------------------ plain version

def _step_stats_plain(params, b: StepBatch, spec: MLPSpec) -> torch.Tensor:
    """The (8,) statistics of K1, in plain PyTorch (differentiable)."""
    y, dy = mlp_apply_with_tangents(params, b.coords, _coordinate_tangents(b.coords, KT), spec)
    return _stats_from_outputs(y, dy, b)


def _stats_from_outputs(y, dy, b: StepBatch) -> torch.Tensor:
    """The (8,) statistics from the network's ``y`` and ``dy`` (K=2): the
    loss epilogue of K1, differentiable in ``y`` and ``dy``."""
    U, V, h = y[:, 0], y[:, 1], y[:, 2]
    fc = (dy[0][:, 2] * U + h * dy[0][:, 0] + (dy[1][:, 2] * V + h * dy[1][:, 1])) * b.mask
    stats = [torch.sum(fc * fc)]
    if b.has_anchor:
        anch = b.sel * (h - b.anchor_depth)
        stats.append(torch.sum(anch * anch))
    else:
        stats.append(torch.zeros((), dtype=y.dtype, device=y.device))
    err = b.mask[:, None] * (y[:, : b.n_true] - b.trues)
    stats += list(torch.sum(err * err, dim=0))
    stats += [torch.zeros((), dtype=y.dtype, device=y.device)] * (N_STATS - len(stats))
    return torch.stack(stats)


def _shard_stats_plain(params, b: StepBatch, spec: MLPSpec, precision: str):
    """The (8,) statistics of :func:`shared_forward_loss_plain` on one
    shard's rows (differentiable at ``f32``)."""
    _check_step_spec(spec, b.n_true, b.has_anchor)
    check_precision(precision, "K1")
    if precision == "f32":
        return _step_stats_plain(params, b, spec)
    fwd = tiers.tier_forward(params, b.coords, spec, KT, precision, keep_states=False)
    return _stats_from_outputs(fwd.y, fwd.dy, b)


def shared_forward_loss_plain(params, b, spec: MLPSpec, precision: str = "f32"):
    """``(total, fidelity, residual)`` of the shared-forward continuity loss
    in plain PyTorch. The one plain form of this loss: K1's plain version
    differentiates it, and so does ``training.loss.build_loss_fn`` for a
    configuration inside the one-kernel gate. ``b`` is a :class:`StepBatch`
    or a list of shards (:func:`make_step_batches`): each shard's statistics
    on its device from a copy of ``params``, summed in shard order on the
    first device, combined once. At ``f32`` it is differentiable (back to
    ``params``); at ``bf16`` and ``f32x3`` it is the value at the tier
    (``ops.tiers.tier_forward``), which no autograd differentiates: the
    tier's gradient is :func:`fused_loss_and_grad_plain`'s."""
    shards = _shards(b)
    first = shards[0]
    stats = _sum_in_order([
        _shard_stats_plain(_shard_params(params, s, first), s, spec,
                           precision).to(first.coords.device)
        for s in shards])
    return _combine_stats(stats, first.fid_weights, first.n_res, first.n_sel, first.n_true,
                          first.w_fid, first.w_res, first.has_anchor)


def _plain_stats_and_grads(params, b: StepBatch, spec: MLPSpec, precision: str):
    """``(total, fidelity, residual, stats, grads)`` of plain K1 on ``b``'s
    rows, every gradient taken at ``b``'s scales (on a shard with the global
    counts: that shard's partial sum of the full-batch gradient)."""
    _check_step_spec(spec, b.n_true, b.has_anchor)
    if precision != "f32":
        fwd = tiers.tier_forward(params, b.coords, spec, KT, precision)
        y, dy = fwd.y.requires_grad_(), fwd.dy.requires_grad_()
        with torch.enable_grad():
            stats = _stats_from_outputs(y, dy, b)
            total, fid, res = _combine_stats(stats, b.fid_weights, b.n_res, b.n_sel,
                                             b.n_true, b.w_fid, b.w_res, b.has_anchor)
            ybar, dybar = torch.autograd.grad(total, [y, dy])
        grads = tiers.tier_backward(params, b.coords, fwd, ybar, dybar, spec, precision)
        return total.detach(), fid.detach(), res.detach(), stats.detach(), grads
    leaves = {k: params[k].detach().requires_grad_() for k in PARAM_KEYS}
    with torch.enable_grad():
        stats = _step_stats_plain(leaves, b, spec)
        total, fid, res = _combine_stats(stats, b.fid_weights, b.n_res, b.n_sel, b.n_true,
                                         b.w_fid, b.w_res, b.has_anchor)
        grads = torch.autograd.grad(total, [leaves[k] for k in PARAM_KEYS],
                                    allow_unused=True, materialize_grads=True)
    return (total.detach(), fid.detach(), res.detach(), stats.detach(),
            dict(zip(PARAM_KEYS, grads)))


def fused_loss_and_grad_plain(params, b: StepBatch, spec: MLPSpec, precision: str = "f32"):
    """Plain PyTorch K1: ``((total, (fidelity, residual)), grads)``. Any
    width. ``f32``: ``torch.autograd.grad`` of :func:`shared_forward_loss_plain`.
    ``bf16``, ``f32x3``: the tier's forward, the epilogue's cotangents by autograd on
    ``(y, dy)`` (f32, as in the kernel), then the tier's backward."""
    check_precision(precision, "K1")
    total, fid, res, _, grads = _plain_stats_and_grads(params, b, spec, precision)
    return (total, (fid, res)), grads


# -------------------------------------------------------------- CUDA launch

def _check_launch(params, b: StepBatch, spec: MLPSpec) -> None:
    if not kernel_supports(spec):
        raise ValueError(
            "K1 takes the Pallas kernels' shapes (>= 1 hidden layer, max(width, d_in, "
            f"d_out) <= {widths.MAX_DIM}), d_in >= 2 and heads (U, V, h) (d_out = 3); "
            f"got sizes {spec.sizes}"
        )
    n = b.coords.shape[0]
    if b.coords.dim() != 2 or b.coords.shape[1] != spec.d_in or n > _MAX_POINTS:
        raise ValueError(f"coords must be (N, {spec.d_in}) with N < 2^31, got {tuple(b.coords.shape)}")
    W, n_stack = spec.width, spec.n_hidden - 1
    shapes = {
        "w_in": (spec.d_in, W), "b_in": (W,), "w_hidden": (n_stack, W, W),
        "b_hidden": (n_stack, W), "w_out": (W, 3), "b_out": (3,),
        "trues": (n, b.n_true), "sel": (n,), "mask": (n,), "scal": (8,),
    }
    tensors = {"coords": b.coords, "trues": b.trues, "sel": b.sel, "mask": b.mask,
               "scal": b.scal, **{k: params[k] for k in PARAM_KEYS}}
    for name, t in tensors.items():
        if t.device != b.coords.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"K1 takes contiguous float32 tensors on {b.coords.device}; {name} is "
                f"{t.dtype} on {t.device}, contiguous={t.is_contiguous()}"
            )
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shapes[name]}")


def n_flat(spec: MLPSpec) -> int:
    """Flat parameter count (the JAX ``ravel_pytree`` length)."""
    W, n_stack = spec.width, spec.n_hidden - 1
    return n_stack * W * (W + 1) + W + spec.d_out + spec.d_in * W + W * spec.d_out


def unflatten(flat: torch.Tensor, spec: MLPSpec) -> dict[str, torch.Tensor]:
    """Views of a flat vector in :data:`FLAT_KEYS` order as the parameter dict."""
    W, n_stack = spec.width, spec.n_hidden - 1
    shapes = {
        "b_hidden": (n_stack, W), "b_in": (W,), "b_out": (spec.d_out,),
        "w_hidden": (n_stack, W, W), "w_in": (spec.d_in, W), "w_out": (W, spec.d_out),
    }
    out, off = {}, 0
    for k in FLAT_KEYS:
        size = 1
        for s in shapes[k]:
            size *= s
        out[k] = flat[off : off + size].view(shapes[k])
        off += size
    return out


def unpad_flat(flat: torch.Tensor, padded: MLPSpec, spec: MLPSpec) -> torch.Tensor:
    """A flat result of the padded net ``padded`` (gradients in
    :data:`FLAT_KEYS` order, then any statistics) as ``spec``'s: the added
    neurons' gradient entries dropped (:func:`ops.widths.slice_grads`)."""
    n = n_flat(padded)
    grads = widths.slice_grads(unflatten(flat[:n], padded), spec)
    return torch.cat([grads[k].reshape(-1) for k in FLAT_KEYS] + [flat[n:]])


def _launch_k1(params, b: StepBatch, spec: MLPSpec, lib=None,
               precision: str = "f32") -> torch.Tensor:
    """K1 + its reduction; returns the flat ``(n_flat + 8,)`` result, on the
    body :func:`ops.widths.route` picks: the narrow one
    (:func:`_launch_k1_narrow`) or the wide one (:func:`_launch_k1_wide`).
    ``lib``: another build of the narrow K1 for this width (a check of a
    rebuilt source)."""
    if lib is not None:
        return _launch_k1_narrow(params, b, spec, lib, precision)
    return widths.route(spec, params,
                        lambda p, s: _launch_k1_narrow(p, b, s, precision=precision),
                        lambda p, s: _launch_k1_wide(p, b, s, precision), unpad_flat)


def _launch_k1_narrow(params, b: StepBatch, spec: MLPSpec, lib=None,
                      precision: str = "f32") -> torch.Tensor:
    """K1's narrow body + its reduction at ``spec``'s (compiled) width."""
    lib = lib or k1_library().libs[spec.width]
    dev = b.coords.device
    n, W, n_stack = b.coords.shape[0], spec.width, spec.n_hidden - 1
    plan = card_plan(lib, "k1", precision, n, dev)
    partial, states, out = plan.scratch(n_flat(spec) + N_STATS, n_stack + 1, 1 + KT, W, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = entry(lib, "k1_train_step", precision)(
            b.coords.data_ptr(), b.trues.data_ptr(), b.sel.data_ptr(), b.mask.data_ptr(),
            b.scal.data_ptr(),
            *(params[k].data_ptr() for k in ("w_in", "b_in", "w_hidden", "b_hidden", "w_out", "b_out")),
            partial.data_ptr(), states.data_ptr(), out.data_ptr(),
            n, spec.d_in, n_stack, b.n_true, int(b.has_anchor), _ACT[spec.init_type], plan.grid,
            plan.tile, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"K1 launch failed: CUDA error {err} ({lib.k1_error_string(err).decode()}) "
            f"at sizes {spec.sizes}, N={n}, n_true={b.n_true}, anchor={b.has_anchor}, "
            f"precision={precision}, tile={plan.tile}, grid={plan.grid}"
        )
    return out


def _launch_k1_wide(params, b: StepBatch, spec: MLPSpec, precision: str, lib=None) -> torch.Tensor:
    """K1's wide body + its reduction on the plan of :func:`ops.wide_plan.
    card_plan`; the flat ``(n_flat + 8,)`` result. ``lib``: another build of
    the wide K1 (a check of a rebuilt source)."""
    lib = lib or wide_library("k1")
    dev = b.coords.device
    n = b.coords.shape[0]
    plan = wide_plan.card_plan("k1", n, spec, KT, precision, dev)
    image, partial, states, out = plan.scratch(n_flat(spec) + N_STATS, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = entry(lib, "k1w_train_step", precision)(
            b.coords.data_ptr(), b.trues.data_ptr(), b.sel.data_ptr(), b.mask.data_ptr(),
            b.scal.data_ptr(),
            *(params[k].data_ptr() for k in ("w_in", "b_in", "w_hidden", "b_hidden", "w_out", "b_out")),
            image.data_ptr(), partial.data_ptr(), states.data_ptr(), out.data_ptr(),
            n, spec.d_in, spec.n_hidden - 1, b.n_true, int(b.has_anchor), _ACT[spec.init_type],
            spec.width, plan.grid, plan.tile, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"K1 (wide) launch failed: CUDA error {err} ({lib.k1w_error_string(err).decode()}) "
            f"at sizes {spec.sizes}, N={n}, n_true={b.n_true}, anchor={b.has_anchor}, "
            f"precision={precision}, tile={plan.tile}, grid={plan.grid}, smem={plan.smem}"
        )
    return out


# ------------------------------------------------------------------ wrapper

def fused_loss_and_grad(params, b, spec: MLPSpec, *, precision: str = "f32"):
    """Returns ``((total, (fidelity, residual)), grads)``: the value and the
    parameter gradients of the shared-forward continuity loss. Counterpart
    of the JAX ``ops.kernels_step.fused_loss_and_grad`` and, for a list of
    shards, of its ``fused_loss_and_grad_sharded``, in one process.

    ``b`` is a :class:`StepBatch` or a list of shards
    (:func:`make_step_batches`). ``params`` (on the first shard's device)
    are copied to each shard's device; a CUDA shard launches K1 at
    ``precision`` (``'f32'``, ``'bf16'`` or ``'f32x3'``), a CPU shard runs
    its plain statistics and gradients (:func:`fused_loss_and_grad_plain`'s);
    the flat ``(n_flat + 8,)`` outputs are summed in shard order on the
    first device and the statistics combined once. Every K1 launch counts
    one in ``fused_loss_and_grad.launches``. An empty anchor selection gives
    NaN, as the reference's ``torch.mean`` of an empty tensor does. The
    whole call is the span ``step#k1``."""
    with tracing.span("step#k1"):
        check_precision(precision, "K1")
        shards = _shards(b)
        first = shards[0]
        _check_step_spec(spec, first.n_true, first.has_anchor)
        n = n_flat(spec)
        outs = []
        for s in shards:
            p = _shard_params(params, s, first)
            if _on_cuda(s.coords, "K1"):
                _check_launch(p, s, spec)
                if s.coords.shape[0] == 0:
                    raise ValueError("K1 needs at least one point")
                out = _launch_k1(p, s, spec, precision=precision)
                count_launch(fused_loss_and_grad, precision, spec)
            else:
                _, _, _, stats, grads = _plain_stats_and_grads(p, s, spec, precision)
                out = torch.cat([grads[k].reshape(-1) for k in FLAT_KEYS] + [stats])
            outs.append(out.to(first.coords.device))
        flat = _sum_in_order(outs)
        total, fid, res = _combine_stats(flat[n:], first.fid_weights, first.n_res, first.n_sel,
                                         first.n_true, first.w_fid, first.w_res, first.has_anchor)
        return (total, (fid, res)), unflatten(flat[:n], spec)


reset_launches(fused_loss_and_grad)
