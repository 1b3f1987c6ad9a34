"""K2 of the port (``pinn_depthestimation_tpu_torch.ops.kernels``).

On the CPU the wrappers run K2's plain version, held here against the JAX
package's Pallas kernel in interpret mode (as ``tests/test_kernels.py`` runs
it) at identical numpy weights. Tolerance 1e-5 relative: f32 against f32
with ``Precision.HIGHEST``, summed in other orders.

The CUDA kernel itself runs only on a card: ``test_torch_cuda.py`` holds it
against its plain version there, and ``chip_smoke.py`` does the same at
full size.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn_depthestimation_tpu.models import MLPSpec as JSpec
from pinn_depthestimation_tpu.ops import kernels as jkernels
from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy
from pinn_depthestimation_tpu_torch.ops import kernels


def numpy_params(sizes, init_type="xavier", seed=0):
    rng = np.random.RandomState(seed)
    d_in, W, d_out, n_stack = sizes[0], sizes[1], sizes[-1], len(sizes) - 3
    scale = np.sqrt(3.0 / W)
    return {
        "w_in": rng.uniform(-1, 1, (d_in, W)).astype(np.float32),
        "b_in": rng.uniform(-0.1, 0.1, W).astype(np.float32),
        "w_hidden": (rng.uniform(-1, 1, (n_stack, W, W)) * scale).astype(np.float32),
        "b_hidden": rng.uniform(-0.1, 0.1, (n_stack, W)).astype(np.float32),
        "w_out": (rng.uniform(-1, 1, (W, d_out)) * scale).astype(np.float32),
        "b_out": rng.uniform(-0.2, 0.2, d_out).astype(np.float32),
    }


def jax_params(arrays):
    return {k: jnp.asarray(v) for k, v in arrays.items()}


@pytest.mark.parametrize("sizes,init_type,n_tangents,n", [
    ((2, 20, 20, 20, 20, 3), "xavier", 2, 131),   # flagship width, ragged N
    ((2, 20, 20, 20, 3), "xavier", 0, 70),        # the Predictor's K=0 mode
    ((2, 10, 10, 10, 6), "xavier", 2, 64),        # CMB width
    ((3, 16, 16, 16, 4), "kaiming", 3, 45),       # leaky-relu, 3 tangents
    ((2, 8, 8, 3), "kaiming", 1, 33),
])
def test_plain_k2_matches_pallas_interpret(sizes, init_type, n_tangents, n):
    arrays = numpy_params(sizes, init_type, seed=n)
    x = np.random.RandomState(n).uniform(-1, 1, (n, sizes[0])).astype(np.float32)
    y_j, dy_j = jkernels.packed_mlp_fwd_tangents(
        jax_params(arrays), jnp.asarray(x), JSpec(sizes=sizes, init_type=init_type),
        n_tangents, rows_per_tile=8, interpret=True,
    )
    y, dy = kernels.mlp_fwd_tangents(
        params_from_numpy(arrays, "cpu"), torch.from_numpy(x),
        MLPSpec(sizes=sizes, init_type=init_type), n_tangents,
    )
    assert y.shape == (n, sizes[-1]) and dy.shape == (n_tangents, n, sizes[-1])
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dy.numpy(), np.asarray(dy_j), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sizes,n", [((2, 20, 20, 3), 96), ((2, 20, 20, 20, 20, 20, 3), 61)])
def test_plain_residual_matches_pallas_interpret(sizes, n):
    arrays = numpy_params(sizes, seed=3)
    x = np.random.RandomState(2).uniform(-1, 1, (n, 2)).astype(np.float32)
    fc_j = jkernels.fused_residual_continuity(
        jax_params(arrays), jnp.asarray(x), JSpec(sizes=sizes), interpret=True
    )
    fc = kernels.fused_residual_continuity(
        params_from_numpy(arrays, "cpu"), torch.from_numpy(x), MLPSpec(sizes=sizes)
    )
    assert fc.shape == (n,)
    np.testing.assert_allclose(fc.numpy(), np.asarray(fc_j), rtol=1e-5, atol=1e-6)


def test_cpu_wrappers_take_the_plain_version_and_count_nothing():
    spec = MLPSpec(sizes=(2, 20, 20, 3))
    params = params_from_numpy(numpy_params(spec.sizes), "cpu")
    x = torch.rand(40, 2, generator=torch.Generator().manual_seed(0)) * 2 - 1
    before = (kernels.mlp_fwd_tangents.launches, kernels.fused_residual_continuity.launches)
    y, dy = kernels.mlp_fwd_tangents(params, x, spec, 2)
    y_p, dy_p = kernels.mlp_fwd_tangents_plain(params, x, spec, 2)
    assert torch.equal(y, y_p) and torch.equal(dy, dy_p)
    assert torch.equal(kernels.fused_residual_continuity(params, x, spec),
                       kernels.residual_continuity_plain(params, x, spec))
    after = (kernels.mlp_fwd_tangents.launches, kernels.fused_residual_continuity.launches)
    assert after == before


def test_precision_tiers():
    spec = MLPSpec(sizes=(2, 20, 20, 3))
    params = params_from_numpy(numpy_params(spec.sizes), "cpu")
    x = torch.zeros(8, 2)
    # bf16 and f32x3 are ported (tests/test_torch_bf16.py,
    # tests/test_torch_f32x3.py): on the CPU the wrappers take the tier's
    # plain version
    y, _ = kernels.mlp_fwd_tangents(params, x, spec, 0, precision="f32x3")
    assert torch.equal(y, kernels.mlp_fwd_tangents_plain(params, x, spec, 0, "f32x3")[0])
    fc = kernels.fused_residual_continuity(params, x, spec, precision="f32x3")
    assert torch.equal(fc, kernels.residual_continuity_plain(params, x, spec, "f32x3"))
    with pytest.raises(ValueError, match="precision"):
        kernels.mlp_fwd_tangents(params, x, spec, 0, precision="fp8")


def test_kernel_limits():
    assert kernels.kernel_supports(MLPSpec(sizes=(2,) + (20,) * 100 + (3,)))
    assert kernels.kernel_supports(MLPSpec(sizes=(2,) + (10,) * 10 + (6,)))
    assert kernels.kernel_supports(MLPSpec(sizes=(2, 20, 3)))          # no stacked layer
    assert not kernels.kernel_supports(MLPSpec(sizes=(2, 3)))           # no hidden layer
    assert kernels.kernel_supports(MLPSpec(sizes=(2, 64, 64, 3)))       # the wide body
    assert kernels.kernel_supports(MLPSpec(sizes=(9, 20, 20, 3)))       # d_in > 8: wide
    assert kernels.kernel_supports(MLPSpec(sizes=(2, 20, 20, 9)))       # d_out > 8: wide
    assert kernels.kernel_supports(MLPSpec(sizes=(2, 17, 17, 3)))       # padded to 20
    assert not kernels.kernel_supports(MLPSpec(sizes=(2, 129, 129, 3))) # beyond 128 lanes
    assert not kernels.kernel_supports(MLPSpec(sizes=(129, 20, 20, 3)))
    assert not kernels.kernel_supports(MLPSpec(sizes=(2, 20, 20, 129)))
    with pytest.raises(ValueError, match="d_out=3"):
        kernels.fused_residual_continuity({}, torch.zeros(4, 2), MLPSpec(sizes=(2, 20, 4)))


def test_launch_checks_reject_what_the_kernel_does_not_take():
    """The checks a CUDA launch runs first, exercised on CPU tensors."""
    spec = MLPSpec(sizes=(2, 20, 20, 3))
    params = params_from_numpy(numpy_params(spec.sizes), "cpu")
    x = torch.zeros(16, 2)
    kernels._check_launch(params, x, spec, 2)  # accepted
    with pytest.raises(ValueError, match="n_tangents"):
        kernels._check_launch(params, x, spec, 3)  # more tangents than inputs
    with pytest.raises(ValueError, match="coords"):
        kernels._check_launch(params, torch.zeros(16, 3), spec, 0)
    with pytest.raises(ValueError, match="float32"):
        kernels._check_launch(params, x.double(), spec, 0)
    with pytest.raises(ValueError, match="contiguous"):
        kernels._check_launch(params, torch.zeros(2, 16).t(), spec, 0)
    bad = dict(params, w_out=torch.zeros(20, 4))
    with pytest.raises(ValueError, match="w_out"):
        kernels._check_launch(bad, x, spec, 0)
    with pytest.raises(ValueError, match="width"):
        kernels._check_launch(params, x, MLPSpec(sizes=(2, 130, 3)), 0)
