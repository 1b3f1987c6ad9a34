"""K3: the fused MLP backward, and the differentiable fused forward+tangents.

Replaces the JAX package's TPU kernel ``ops/kernels_vjp.py::packed_mlp_bwd``
with ``impl='stream'`` (``pallas_call`` at ``:805``, body
``_make_bwd_kernel_stream(train_epilogue=0)``), the backward of the custom
VJP ``fused_apply_with_tangents``. Given output cotangents ``ybar (N,
d_out)`` and ``dybar (K, N, d_out)`` of ``(y, dy) =
mlp_apply_with_tangents(params, coords, e_0..e_{K-1})``, K3 returns every
parameter gradient. The kernel is CUDA C++ in ``csrc/mlp_bwd.cu`` on the
walk of ``csrc/mlp_bwd_common.cuh``, which K1 shares (design and bound in
their headers), built by ``ops.cuda_build``.

Beside the kernel, per the port's rules:

* the plain PyTorch version :func:`packed_mlp_bwd_plain` — autograd of
  ``models.mlp.mlp_apply_with_tangents`` with the given cotangents;
* the wrapper :func:`packed_mlp_bwd`: CPU tensors take the plain version,
  CUDA tensors launch K3 or raise — no fallback;
* the launch count ``packed_mlp_bwd.launches``, one per launch (K3 and its
  fixed-order reduction).

:class:`FusedApplyWithTangents` is the ``torch.autograd.Function`` of the
JAX custom VJP: its forward is K2 (``ops.kernels.mlp_fwd_tangents``), its
backward K3. Only the ``f32`` tier exists; ``f32x3``/``bf16`` raise
``NotImplementedError``.
"""

from __future__ import annotations

import torch

from pinn_depthestimation_tpu_torch.models.mlp import PARAM_KEYS, MLPSpec
from pinn_depthestimation_tpu_torch.ops import kernels
from pinn_depthestimation_tpu_torch.ops.cuda_build import K3_WIDTHS, k3_library
from pinn_depthestimation_tpu_torch.ops.kernels import (
    _ACT,
    _MAX_POINTS,
    MAX_D_IN,
    MAX_D_OUT,
    MAX_TANGENTS,
    _on_cuda,
    check_precision,
)
from pinn_depthestimation_tpu_torch.ops.kernels_step import n_flat, unflatten


def kernel_supports(spec: MLPSpec) -> bool:
    """Whether K3 takes this architecture: at least one hidden layer, a
    compiled width, ``d_in <= 8`` and ``d_out <= 8``."""
    return (
        spec.n_hidden >= 1
        and spec.width in K3_WIDTHS
        and spec.d_in <= MAX_D_IN
        and spec.d_out <= MAX_D_OUT
    )


# ------------------------------------------------------------ plain version

def packed_mlp_bwd_plain(params, coords, ybar, dybar, spec: MLPSpec, n_tangents: int):
    """Plain PyTorch K3: the parameter gradients of
    ``(y, dy) = mlp_fwd_tangents_plain(params, coords, spec, n_tangents)``
    for the cotangents ``(ybar, dybar)``, by ``torch.autograd.grad``."""
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

def _check_launch(params, coords, ybar, dybar, spec: MLPSpec, n_tangents: int) -> None:
    if spec.dropout_rate:
        raise ValueError("K3 does not support dropout")
    if not kernel_supports(spec):
        raise ValueError(
            f"K3 takes >= 1 hidden layer, width in {K3_WIDTHS}, d_in <= {MAX_D_IN} "
            f"and d_out <= {MAX_D_OUT}; got sizes {spec.sizes}"
        )
    if not 0 <= n_tangents <= min(MAX_TANGENTS, spec.d_in):
        raise ValueError(f"K3 takes 0 <= n_tangents <= min(3, d_in), got {n_tangents}")
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
                f"K3 takes contiguous float32 tensors on {coords.device}; {name} is "
                f"{t.dtype} on {t.device}, contiguous={t.is_contiguous()}"
            )
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shapes[name]}")


def _launch_k3(params, coords, ybar, dybar, spec: MLPSpec, n_tangents: int) -> torch.Tensor:
    """K3 + its reduction; returns the flat ``(n_flat,)`` gradients in
    ``kernels_step.FLAT_KEYS`` order."""
    lib = k3_library().libs[spec.width]
    dev = coords.device
    n, W, n_stack = coords.shape[0], spec.width, spec.n_hidden - 1
    threads = lib.k3_threads()
    grid = min(-(-n // threads), torch.cuda.get_device_properties(dev).multi_processor_count)
    n_ent = n_flat(spec)
    partial = torch.empty((grid, n_ent), dtype=torch.float32, device=dev)
    states = torch.empty((grid * (n_stack + 1) * (1 + n_tangents) * W * threads,),
                         dtype=torch.float32, device=dev)
    out = torch.empty((n_ent,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.k3_mlp_bwd(
            coords.data_ptr(), ybar.data_ptr(), dybar.data_ptr() if n_tangents else None,
            *(params[k].data_ptr() for k in ("w_in", "b_in", "w_hidden", "b_hidden", "w_out", "b_out")),
            partial.data_ptr(), states.data_ptr(), out.data_ptr(),
            n, spec.d_in, spec.d_out, n_stack, n_tangents, _ACT[spec.init_type], grid, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"K3 launch failed: CUDA error {err} ({lib.k3_error_string(err).decode()}) "
            f"at sizes {spec.sizes}, N={n}, K={n_tangents}"
        )
    return out


# ------------------------------------------------------------------ wrapper

def packed_mlp_bwd(params, coords, ybar, dybar, spec: MLPSpec, n_tangents: int,
                   *, precision: str = "f32") -> dict[str, torch.Tensor]:
    """Parameter gradients of ``(y, dy) = mlp_apply_with_tangents(params,
    coords, e_0..e_{K-1})`` given output cotangents ``ybar (N, d_out)`` and
    ``dybar (K, N, d_out)``. Counterpart of the JAX
    ``ops.kernels_vjp.packed_mlp_bwd``. A CPU ``coords`` runs
    :func:`packed_mlp_bwd_plain`; a CUDA one launches K3."""
    check_precision(precision, "K3")
    if not _on_cuda(coords, "K3"):
        return packed_mlp_bwd_plain(params, coords, ybar, dybar, spec, n_tangents)
    _check_launch(params, coords, ybar, dybar, spec, n_tangents)
    if coords.shape[0] == 0:
        return {k: torch.zeros_like(params[k]) for k in PARAM_KEYS}
    out = _launch_k3(params, coords, ybar, dybar, spec, n_tangents)
    packed_mlp_bwd.launches += 1
    return unflatten(out, spec)


packed_mlp_bwd.launches = 0


class FusedApplyWithTangents(torch.autograd.Function):
    """``(y, dy)`` of the MLP with the first ``n_tangents`` coordinate
    tangents: forward ``ops.kernels.mlp_fwd_tangents`` (K2 on the card),
    backward :func:`packed_mlp_bwd` (K3 on the card). ``coords`` gets no
    gradient (``None``)."""

    @staticmethod
    def forward(ctx, spec, n_tangents, precision, coords, *flat_params):
        params = dict(zip(PARAM_KEYS, flat_params))
        y, dy = kernels.mlp_fwd_tangents(params, coords, spec, n_tangents, precision=precision)
        ctx.save_for_backward(coords, *flat_params)
        ctx.spec, ctx.n_tangents, ctx.precision = spec, n_tangents, precision
        return y, dy

    @staticmethod
    def backward(ctx, ybar, dybar):
        coords, *flat_params = ctx.saved_tensors
        params = dict(zip(PARAM_KEYS, flat_params))
        grads = packed_mlp_bwd(params, coords, ybar.contiguous(), dybar.contiguous(),
                               ctx.spec, ctx.n_tangents, precision=ctx.precision)
        return (None, None, None, None, *(grads[k] for k in PARAM_KEYS))


def fused_apply_with_tangents(params, coords: torch.Tensor, spec: MLPSpec, n_tangents: int,
                              precision: str = "f32"):
    """Differentiable fused forward + the first ``n_tangents`` coordinate
    tangents, ``(y (N, d_out), dy (K, N, d_out))``. Counterpart of the JAX
    ``ops.kernels_vjp.fused_apply_with_tangents``.

    ``coords`` is detached first, as the JAX function passes it through
    ``lax.stop_gradient``: K3 computes no coordinate gradient, so a loss
    that differentiates w.r.t. the coordinates must not be built on this
    path (use ``models.mlp.mlp_apply_with_tangents``, which differentiates
    fully)."""
    if spec.dropout_rate:
        raise ValueError("the fused forward+tangents does not support dropout")
    return FusedApplyWithTangents.apply(spec, n_tangents, precision, coords.detach(),
                                        *(params[k] for k in PARAM_KEYS))
