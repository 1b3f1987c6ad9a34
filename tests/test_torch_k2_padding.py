"""The zero padding of K2's tensor-core body is inert (``ops/k2_plan.py``,
``csrc/mlp_fwd_tangents_mma.cuh``): the body pads every hidden width W to
whole 16-column k-tiles, K_p = :func:`k_pad` (>= N_p, its 8-column output
tiles), with zero weights and biases. Held on the CPU from seeded
numpy inputs:

* the plain tier forward (``ops.tiers.tier_forward``) of the net
  zero-padded to width K_p agrees with that of the unpadded net within
  1e-6 x max|unpadded|, at bf16 and f32x3, at every compiled width, for
  tanh and LeakyReLU, K = 0..3 and the continuity epilogue. tanh(0) = 0
  and LeakyReLU(0) = 0 keep the padded neurons at 0, their tangents at
  0 * act'(0) = 0, and zero products leave the sums as they are;
* the padded net's forward agrees with the JAX package's
  ``packed_mlp_fwd_tangents`` / ``fused_residual_continuity`` on the
  unpadded net in interpret mode, to the tolerances that
  ``tests/test_torch_bf16.py`` and ``tests/test_torch_f32x3.py`` state for
  the unpadded port on the same cases (their gap functions, their numbers).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn_depthestimation_tpu.ops import kernels as jk
from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy
from pinn_depthestimation_tpu_torch.ops import k2_plan, kernels, tiers
from pinn_depthestimation_tpu_torch.ops.cuda_build import K2_WIDTHS
from test_torch_bf16 import gap as max_gap
from test_torch_bf16 import inputs, numpy_params
from test_torch_f32x3 import gap as l2_gap

MODES = ("K=0", "K=1", "K=2", "K=3", "epilogue")
INIT = {"tanh": "xavier", "leaky_relu": "kaiming"}


def k_pad(width: int) -> int:
    """The padded input width of a layer in whole m16n8k16 k-tiles: a
    multiple of 16. Where it exceeds ``k2_plan.n_pad`` (W = 8, 20) the
    kernel runs the last half k-tile as m16n8k8 and never stores its zero
    upper half; padding to K_p here covers that case too."""
    return 16 * -(-width // 16)


def padded(arrays: dict, width: int) -> dict:
    """The net's arrays zero-padded from hidden width W to ``width``."""
    p = width - arrays["b_in"].shape[0]
    return {"w_in": np.pad(arrays["w_in"], ((0, 0), (0, p))),
            "b_in": np.pad(arrays["b_in"], (0, p)),
            "w_hidden": np.pad(arrays["w_hidden"], ((0, 0), (0, p), (0, p))),
            "b_hidden": np.pad(arrays["b_hidden"], ((0, 0), (0, p))),
            "w_out": np.pad(arrays["w_out"], ((0, p), (0, 0))),
            "b_out": arrays["b_out"]}


def forward(arrays, sizes, init, x, kt, precision, epilogue=False):
    """``(y, dy)``, or ``fc`` with the epilogue, of the plain tier forward."""
    spec = MLPSpec(sizes=sizes, init_type=init)
    params = params_from_numpy(arrays, "cpu")
    coords = torch.from_numpy(x)
    if epilogue:
        return (kernels.residual_continuity_plain(params, coords, spec, precision),)
    fwd = tiers.tier_forward(params, coords, spec, kt, precision, keep_states=False)
    return fwd.y, fwd.dy


def padded_sizes(sizes, width):
    return (sizes[0],) + (width,) * (len(sizes) - 2) + (sizes[-1],)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("act", INIT)
@pytest.mark.parametrize("precision", ["bf16", "f32x3"])
@pytest.mark.parametrize("width", K2_WIDTHS)
def test_padding_is_inert(width, precision, act, mode):
    epilogue = mode == "epilogue"
    kt = 2 if epilogue else int(mode[-1])
    sizes = (max(2, kt),) + (width,) * 5 + (3 if epilogue else 4,)
    arrays = numpy_params(sizes, seed=11)
    x = np.random.RandomState(12).uniform(-1, 1, (203, sizes[0])).astype(np.float32)
    wide = k_pad(width)
    assert wide % 16 == 0 and wide >= k2_plan.n_pad(width) >= width
    ref = forward(arrays, sizes, INIT[act], x, kt, precision, epilogue)
    got = forward(padded(arrays, wide), padded_sizes(sizes, wide), INIT[act], x, kt, precision,
                  epilogue)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        if r.numel():
            assert float((g - r).abs().max()) <= 1e-6 * float(r.abs().max())


# The cases and tolerances of test_torch_bf16.py::test_plain_k2_bf16_matches_jax
# and ::test_plain_continuity_epilogue_bf16_matches_jax (max gap), and of
# test_torch_f32x3.py::test_plain_k2_f32x3_matches_jax and
# ::test_plain_continuity_epilogue_f32x3_matches_jax (L2 gap).
BF16_SHALLOW, BF16_DEEP = (2,) + (20,) * 5 + (3,), (2,) + (20,) * 23 + (3,)
X3_SHALLOW, X3_DEEP, X3_DEEP3 = (2,) + (8,) * 3 + (3,), (2,) + (10,) * 12 + (6,), (2,) + (10,) * 12 + (3,)
JAX_CASES = [
    ("bf16", BF16_SHALLOW, "xavier", 0, 3e-7),
    ("bf16", BF16_SHALLOW, "xavier", 2, 4e-7),
    ("bf16", BF16_DEEP, "xavier", 2, 4e-7),
    ("bf16", (2,) + (10,) * 4 + (6,), "xavier", 2, 2e-7),
    ("bf16", (3,) + (20,) * 6 + (4,), "kaiming", 3, 2.8e-3),
    ("bf16", BF16_SHALLOW, "xavier", "epilogue", 5e-7),
    ("bf16", BF16_DEEP, "xavier", "epilogue", 5e-7),
    ("f32x3", X3_SHALLOW, "xavier", 0, 4.8e-6),
    ("f32x3", X3_SHALLOW, "xavier", 2, 4.8e-6),
    ("f32x3", X3_DEEP, "xavier", 2, 1.08e-5),
    ("f32x3", (3,) + (8,) * 3 + (4,), "kaiming", 3, 4.4e-7),
    ("f32x3", X3_SHALLOW, "xavier", "epilogue", 7.8e-6),
    ("f32x3", X3_DEEP3, "xavier", "epilogue", 1.8e-5),
]


@pytest.mark.parametrize("precision,sizes,init,kt,tol", JAX_CASES)
def test_padded_net_matches_jax(precision, sizes, init, kt, tol):
    epilogue = kt == "epilogue"
    kt = 2 if epilogue else kt
    arrays, jp, _, js, _, x, _, _ = inputs(sizes, init, kt)
    gap = max_gap if precision == "bf16" else l2_gap
    wide = k_pad(sizes[1])
    got = forward(padded(arrays, wide), padded_sizes(sizes, wide), init, x, kt, precision,
                  epilogue)
    if epilogue:
        want = (jk.fused_residual_continuity(jp, jnp.asarray(x), js, precision=precision,
                                             interpret=True),)
    else:
        want = jk.packed_mlp_fwd_tangents(jp, jnp.asarray(x), js, kt, precision=precision,
                                          interpret=True)
    for g, w in zip(got, want):
        if not np.asarray(w).size:
            continue
        assert g.shape == w.shape
        assert gap(g, w) <= tol
