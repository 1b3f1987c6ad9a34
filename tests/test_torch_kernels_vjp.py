"""K3's plain version and the port's fused custom VJP
(``pinn_depthestimation_tpu_torch.ops.kernels_vjp``), held against the JAX
package's ``packed_mlp_bwd`` in interpret mode (``impl='stream'``, the body
K3 replaces), as ``tests/test_kernels_vjp.py`` runs it on the CPU.

Tolerances: each gradient within 2e-5 of its largest entry — f32 autograd
against the JAX kernel's f32 ``Precision.HIGHEST`` products, summed over
the points in other orders (tile by tile there); the measured gap is below
1e-6 of the scale. The autograd-Function checks compare two plain PyTorch
routes to the same gradients and hold them to 1e-6 of the scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn_depthestimation_tpu.models import MLPSpec as JSpec
from pinn_depthestimation_tpu.ops import kernels_vjp as jvjp
from pinn_depthestimation_tpu_torch.models import MLPSpec, mlp_apply_with_tangents, params_from_numpy
from pinn_depthestimation_tpu_torch.models.mlp import PARAM_KEYS
from pinn_depthestimation_tpu_torch.ops import kernels_vjp
from pinn_depthestimation_tpu_torch.ops.cuda_build import K3_WIDTHS


def numpy_params(sizes, seed=0):
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


def assert_grads_close(got, want, tol):
    for k in PARAM_KEYS:
        a, b = np.asarray(want[k]), got[k].detach().numpy()
        assert a.shape == b.shape, k
        if a.size == 0:
            continue
        scale = np.abs(a).max() + 1e-12
        np.testing.assert_allclose(b / scale, a / scale, atol=tol, rtol=0, err_msg=k)


@pytest.mark.parametrize("width,d_in,d_out,hidden,kt,init", [
    (8, 2, 3, 2, 2, "xavier"),     # continuity heads, two tangents
    (10, 2, 6, 3, 2, "xavier"),    # the CMB net's width and heads (residual)
    (10, 2, 6, 3, 0, "xavier"),    # the CMB fidelity forward: no tangents
    (8, 1, 1, 1, 1, "kaiming"),    # one hidden layer, one head, LeakyReLU
    (8, 3, 3, 2, 3, "kaiming"),    # three tangents (the legacy pipeline's t, x, y)
    (10, 3, 1, 1, 0, "kaiming"),
    (8, 2, 6, 3, 1, "xavier"),
])
def test_plain_k3_matches_jax_kernel(width, d_in, d_out, hidden, kt, init):
    sizes = (d_in,) + (width,) * hidden + (d_out,)
    arrays = numpy_params(sizes, seed=width + hidden + kt)
    rng = np.random.RandomState(kt)
    n = 203  # ragged against the JAX kernel's tiles
    coords = rng.uniform(-1, 1, (n, d_in)).astype(np.float32)
    ybar = rng.randn(n, d_out).astype(np.float32)
    dybar = rng.randn(kt, n, d_out).astype(np.float32)
    want = jvjp.packed_mlp_bwd(
        {k: jnp.asarray(v) for k, v in arrays.items()}, jnp.asarray(coords),
        jnp.asarray(ybar), jnp.asarray(dybar), JSpec(sizes=sizes, init_type=init), kt,
        precision="f32", interpret=True, impl="stream")
    spec = MLPSpec(sizes=sizes, init_type=init)
    got = kernels_vjp.packed_mlp_bwd(params_from_numpy(arrays, "cpu"), torch.from_numpy(coords),
                                     torch.from_numpy(ybar), torch.from_numpy(dybar), spec, kt)
    assert_grads_close(got, want, 2e-5)


@pytest.mark.parametrize("kt", [0, 2, 3])
def test_fused_apply_gradients_match_autograd(kt):
    """The autograd Function (K2 forward, K3 backward; their plain versions
    on the CPU) gives the gradients autograd gives through
    mlp_apply_with_tangents, and no gradient to coords."""
    sizes = (3, 10, 10, 10, 6)
    spec = MLPSpec(sizes=sizes, init_type="xavier")
    arrays = numpy_params(sizes, seed=kt)
    rng = np.random.RandomState(11)
    coords = torch.from_numpy(rng.uniform(-1, 1, (97, 3)).astype(np.float32)).requires_grad_()
    tangents = torch.zeros((kt, 97, 3))
    for k in range(kt):
        tangents[k, :, k] = 1.0

    def loss(y, dy):
        return torch.mean(torch.sin(y)) + torch.mean((dy - 0.3) ** 2)

    leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in arrays.items()}
    y, dy = kernels_vjp.fused_apply_with_tangents(leaves, coords, spec, kt)
    total = loss(y, dy)
    assert torch.autograd.grad(total, coords, retain_graph=True, allow_unused=True) == (None,)
    got = dict(zip(PARAM_KEYS, torch.autograd.grad(total, [leaves[k] for k in PARAM_KEYS])))

    ref = {k: torch.from_numpy(v).requires_grad_() for k, v in arrays.items()}
    y2, dy2 = mlp_apply_with_tangents(ref, coords.detach(), tangents, spec)
    want = dict(zip(PARAM_KEYS, torch.autograd.grad(loss(y2, dy2), [ref[k] for k in PARAM_KEYS])))
    torch.testing.assert_close(y, y2, rtol=0, atol=0)
    assert_grads_close(got, {k: v.numpy() for k, v in want.items()}, 1e-6)


def test_fused_apply_gives_coords_no_gradient():
    """coords is detached first (the JAX stop_gradient): a loss built on the
    fused path has no gradient w.r.t. the coordinates."""
    spec = MLPSpec(sizes=(2, 8, 8, 3))
    params = params_from_numpy(numpy_params(spec.sizes), "cpu")
    coords = torch.zeros((5, 2), requires_grad=True)
    y, dy = kernels_vjp.fused_apply_with_tangents(params, coords, spec, 2)
    assert not y.requires_grad and not dy.requires_grad


def test_wrappers_refuse_what_k3_does_not_take():
    spec = MLPSpec(sizes=(2, 8, 8, 3))
    params = params_from_numpy(numpy_params(spec.sizes), "cpu")
    x, ybar, dybar = torch.zeros((4, 2)), torch.zeros((4, 3)), torch.zeros((2, 4, 3))
    want = kernels_vjp.packed_mlp_bwd_plain(params, x, ybar, dybar, spec, 2, "f32x3")
    for impl in ("auto", "stream", "rebuild"):  # f32x3 is ported: the CPU takes the plain version
        got = kernels_vjp.packed_mlp_bwd(params, x, ybar, dybar, spec, 2, precision="f32x3",
                                         impl=impl)
        assert all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="impl"):
        kernels_vjp.packed_mlp_bwd(params, x, ybar, dybar, spec, 2, impl="ring")
    with pytest.raises(ValueError, match="CUDA"):
        kernels_vjp.packed_mlp_bwd(params, x.to("meta"), ybar, dybar, spec, 2)
    with pytest.raises(ValueError, match="dropout"):
        kernels_vjp.fused_apply_with_tangents(
            params, x, MLPSpec(sizes=(2, 8, 8, 3), dropout_rate=0.1), 2)
    # the launch checks, reached on the CPU directly: beyond the Pallas gate
    beyond = MLPSpec(sizes=(2, 130, 130, 3))
    with pytest.raises(ValueError, match=r"max\(width, d_in, d_out\) <= 128"):
        kernels_vjp._check_launch(params_from_numpy(numpy_params(beyond.sizes), "cpu"),
                                  x, ybar, dybar, beyond, 2)
    padded = MLPSpec(sizes=(2, 24, 24, 3))  # an uncompiled width: taken (padded)
    kernels_vjp._check_launch(params_from_numpy(numpy_params(padded.sizes), "cpu"),
                              x, ybar, dybar, padded, 2)
    with pytest.raises(ValueError, match="n_tangents"):
        kernels_vjp._check_launch(params, x, ybar, torch.zeros((3, 4, 3)), spec, 3)
    with pytest.raises(ValueError, match="dybar has shape"):
        kernels_vjp._check_launch(params, x, ybar, torch.zeros((1, 4, 3)), spec, 2)
    kernels_vjp._check_launch(params, x, ybar, dybar, spec, 2)  # a launchable call


def test_kernel_supports():
    assert kernels_vjp.kernel_supports(MLPSpec(sizes=(2,) + (10,) * 10 + (6,)))
    assert kernels_vjp.kernel_supports(MLPSpec(sizes=(2,) + (20,) * 100 + (3,)))
    assert kernels_vjp.kernel_supports(MLPSpec(sizes=(2, 24, 3)))      # padded to 32
    assert kernels_vjp.kernel_supports(MLPSpec(sizes=(2, 10, 9)))      # the wide body
    assert kernels_vjp.kernel_supports(MLPSpec(sizes=(2, 128, 128, 128)))
    assert not kernels_vjp.kernel_supports(MLPSpec(sizes=(2, 129, 3)))  # beyond 128 lanes
    assert not kernels_vjp.kernel_supports(MLPSpec(sizes=(2, 10, 129)))
    assert not kernels_vjp.kernel_supports(MLPSpec(sizes=(2, 3)))
    assert 10 in K3_WIDTHS and 20 in K3_WIDTHS
