"""Which body of a kernel takes a net, and the narrow body's exact padding.

The Pallas kernels of the JAX package take every net with at least one
hidden layer and ``max(width, d_in, d_out) <= 128`` (JAX
``ops/kernels.py:92-97``, gates at ``training/driver.py:228-232`` and
``inference.py:81-86``); :func:`structurally_ok` is that gate. The port's
kernels take the same nets through one of two bodies:

* the narrow body (``csrc/mlp_fwd_tangents.cu``, ``csrc/mlp_bwd_common.cuh``),
  compiled for the widths of :data:`NARROW_WIDTHS`, for ``width <= 32`` and
  ``d_in, d_out <= 8``. A width it was not compiled for (17, 24, any odd
  width: the lane pair needs an even one) runs at the next compiled width
  with the net padded exactly (:func:`pad_params`): the extra hidden neurons
  get zero weight rows and columns and zero biases, so their activation
  (``tanh(0) = LeakyReLU(0) = 0``) and tangents are zero, they add ``+0`` to
  every real sum, and their gradients, zero too, are sliced away
  (:func:`slice_grads`) before they reach a caller;
* the wide body (``csrc/mlp_wide.cuh``, the width at run time,
  ``ops/wide_plan.py``) for every other net the gate takes: width 33-128, or
  ``d_in`` or ``d_out`` above 8.

"""

from __future__ import annotations

from typing import Callable, Mapping

import torch

from pinn_depthestimation_tpu_torch.models.mlp import PARAM_KEYS, MLPSpec
from pinn_depthestimation_tpu_torch.ops.cuda_build import K2_WIDTHS

NARROW_WIDTHS = K2_WIDTHS  # K1-K4's narrow bodies share the compiled widths
NARROW_MAX_IO = 8          # d_in, d_out at most in the narrow bodies
MAX_DIM = 128              # the Pallas kernels' 128 lanes
MAX_TANGENTS = 3


def structurally_ok(spec: MLPSpec) -> bool:
    """The Pallas kernels' shapes: at least one hidden layer and
    ``max(width, d_in, d_out) <= 128``."""
    return spec.n_hidden >= 1 and max(spec.width, spec.d_in, spec.d_out) <= MAX_DIM


def narrow_width(spec: MLPSpec) -> int | None:
    """The compiled width the narrow body runs ``spec`` at (its own width, or
    the next compiled one, padded), or None for the wide body."""
    if not structurally_ok(spec) or max(spec.d_in, spec.d_out) > NARROW_MAX_IO:
        return None
    return next((w for w in NARROW_WIDTHS if w >= spec.width), None)


BODIES = ("narrow", "wide")


def body(spec: MLPSpec) -> str:
    """``'narrow'`` or ``'wide'``: the body that runs ``spec``."""
    return "wide" if narrow_width(spec) is None else "narrow"


def route(spec: MLPSpec, params: Mapping[str, torch.Tensor], narrow: Callable,
          wide: Callable, unpad: Callable | None = None):
    """One launch on the body that takes ``spec``, the route every kernel's
    launcher goes through: ``wide(params, spec)`` for the wide body, else
    ``narrow(params, spec)`` at the compiled width, with the net padded
    exactly (:func:`pad_params`) where its own width was not compiled and
    the result passed through ``unpad(out, padded, spec)`` then (a
    gradient's added-neuron entries dropped; K2's outputs need none)."""
    width = narrow_width(spec)
    if width is None:
        return wide(params, spec)
    if width == spec.width:
        return narrow(params, spec)
    padded = padded_spec(spec, width)
    out = narrow(pad_params(params, spec, width), padded)
    return out if unpad is None else unpad(out, padded, spec)


def padded_spec(spec: MLPSpec, width: int) -> MLPSpec:
    """``spec`` with every hidden layer ``width`` wide."""
    return MLPSpec(sizes=(spec.d_in,) + (width,) * spec.n_hidden + (spec.d_out,),
                   init_type=spec.init_type, dropout_rate=spec.dropout_rate)


def pad_params(params: Mapping[str, torch.Tensor], spec: MLPSpec,
               width: int) -> dict[str, torch.Tensor]:
    """The parameters of :func:`padded_spec`: the real entries where they
    were, zeros (``+0``) for the added neurons' weights and biases."""
    W = spec.width
    pad = width - W
    if pad < 0:
        raise ValueError(f"cannot pad width {W} down to {width}")
    f = torch.nn.functional.pad
    return {
        "w_in": f(params["w_in"], (0, pad)).contiguous(),
        "b_in": f(params["b_in"], (0, pad)).contiguous(),
        "w_hidden": f(params["w_hidden"], (0, pad, 0, pad)).contiguous(),
        "b_hidden": f(params["b_hidden"], (0, pad)).contiguous(),
        "w_out": f(params["w_out"], (0, 0, 0, pad)).contiguous(),
        "b_out": params["b_out"],
    }


def slice_grads(grads: Mapping[str, torch.Tensor], spec: MLPSpec) -> dict[str, torch.Tensor]:
    """The gradients of the padded net cut back to ``spec``'s parameters
    (the added neurons' entries dropped, never summed into real ones)."""
    W = spec.width
    out = {
        "w_in": grads["w_in"][:, :W],
        "b_in": grads["b_in"][:W],
        "w_hidden": grads["w_hidden"][:, :W, :W],
        "b_hidden": grads["b_hidden"][:, :W],
        "w_out": grads["w_out"][:W],
        "b_out": grads["b_out"],
    }
    return {k: out[k].contiguous() for k in PARAM_KEYS}
