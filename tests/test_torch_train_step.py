"""K1 of the port (``pinn_depthestimation_tpu_torch.ops.kernels_step``).

On the CPU the wrapper runs K1's plain version (autograd of the
shared-forward loss), held here against the JAX package's one-kernel step
in interpret mode (as ``tests/test_kernels_step.py`` runs it) on identical
numpy inputs. Tolerances as there: loss terms rel 1e-4, each gradient
3e-5 of its largest entry — f32 against f32 ``Precision.HIGHEST``, summed
in other orders.

The CUDA kernel runs only on a card: ``test_torch_cuda.py`` and
``chip_smoke.py`` hold it against this plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from pinn_depthestimation_tpu.models import MLPSpec as JSpec
from pinn_depthestimation_tpu.ops.kernels_step import fused_loss_and_grad as jax_step
from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy
from pinn_depthestimation_tpu_torch.ops import kernels_step


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


def step_inputs(n, n_true, seed=7, masked=True):
    rs = np.random.RandomState(seed)
    coords = rs.uniform(-1, 1, (n, 2)).astype(np.float32)
    trues = (rs.randn(n, n_true) * 0.1).astype(np.float32)
    mask = (rs.rand(n) > (0.1 if masked else -1)).astype(np.float32)
    sel = ((coords[:, 0] < 0.3) * mask).astype(np.float32)
    fidw = rs.uniform(0.5, 2.0, n_true).astype(np.float32)
    return coords, trues, sel, mask, fidw


def port_batch(coords, trues, sel, mask, fidw, n_true, has_anchor, depth=0.6):
    return kernels_step.make_step_batch(
        torch.from_numpy(coords), torch.from_numpy(trues), torch.from_numpy(sel),
        torch.from_numpy(mask), fidw, n_true, 0.7, 1.3, anchor_depth=depth,
        has_anchor=has_anchor,
    )


def grads_close(want, got, tol):
    for k in want:
        x, y = np.asarray(want[k]), got[k].numpy()
        assert y.shape == x.shape, k
        if x.size == 0:
            continue
        scale = np.abs(x).max() + 1e-12
        np.testing.assert_allclose(y / scale, x / scale, atol=tol, err_msg=k)


@pytest.mark.parametrize("width,depth,n_true,has_anchor,init_type", [
    (17, 4, 2, True, "xavier"),    # odd (non-8-multiple) width
    (24, 9, 1, False, "xavier"),   # one fidelity head, no anchor term
    (20, 12, 3, False, "xavier"),  # all three heads observed, deep
    (16, 5, 2, True, "kaiming"),   # leaky-relu
])
def test_plain_k1_matches_jax_step(width, depth, n_true, has_anchor, init_type):
    sizes = (2,) + (width,) * (depth + 1) + (3,)
    arrays = numpy_params(sizes, init_type, seed=width)
    coords, trues, sel, mask, fidw = step_inputs(163, n_true)
    (t1, (f1, r1)), g1 = jax_step(
        {k: jnp.asarray(v) for k, v in arrays.items()}, jnp.asarray(coords),
        jnp.asarray(trues), jnp.asarray(sel), jnp.asarray(mask), jnp.asarray(fidw),
        JSpec(sizes=sizes, init_type=init_type), n_true, 0.7, 1.3, anchor_depth=0.6,
        has_anchor=has_anchor, interpret=True,
    )
    before = kernels_step.fused_loss_and_grad.launches
    (t2, (f2, r2)), g2 = kernels_step.fused_loss_and_grad(
        params_from_numpy(arrays, "cpu"),
        port_batch(coords, trues, sel, mask, fidw, n_true, has_anchor),
        MLPSpec(sizes=sizes, init_type=init_type),
    )
    assert kernels_step.fused_loss_and_grad.launches == before  # the CPU launches nothing
    for a, b in ((t1, t2), (f1, f2), (r1, r2)):
        assert float(b) == pytest.approx(float(a), rel=1e-4)
    grads_close(g1, g2, 3e-5)


def test_anchored_three_heads_refused():
    spec = MLPSpec(sizes=(2, 20, 20, 3))
    coords, trues, sel, mask, fidw = step_inputs(16, 3)
    b = port_batch(coords, trues, sel, mask, fidw, 3, True)
    with pytest.raises(ValueError, match="anchor selector"):
        kernels_step.fused_loss_and_grad(params_from_numpy(numpy_params(spec.sizes), "cpu"), b, spec)


def test_empty_anchor_selection_gives_nan():
    """As the reference's torch.mean of an empty tensor (physics.py:28), and
    as the JAX step."""
    sizes = (2, 16, 16, 3)
    arrays = numpy_params(sizes)
    coords, trues, _, mask, fidw = step_inputs(40, 2)
    sel = np.zeros(40, np.float32)
    (t1, (f1, r1)), g1 = jax_step(
        {k: jnp.asarray(v) for k, v in arrays.items()}, jnp.asarray(coords),
        jnp.asarray(trues), jnp.asarray(sel), jnp.asarray(mask), jnp.asarray(fidw),
        JSpec(sizes=sizes), 2, 0.7, 1.3, interpret=True,
    )
    (t2, (f2, r2)), g2 = kernels_step.fused_loss_and_grad(
        params_from_numpy(arrays, "cpu"),
        port_batch(coords, trues, sel, mask, fidw, 2, True, depth=0.75), MLPSpec(sizes=sizes),
    )
    assert np.isnan(float(t1)) and np.isnan(float(r1))
    assert np.isnan(float(t2)) and np.isnan(float(r2))
    assert float(f2) == pytest.approx(float(f1), rel=1e-4)  # fidelity stays finite
    # The NaN reaches every gradient the h head feeds, as exact autograd
    # gives; the U and V columns of w_out and b_out stay finite. The JAX
    # kernel's lane-packed products spread it to those columns too, so its
    # NaN set is a superset (ROADMAP.md Queue 3).
    nan = {k: torch.isnan(g).numpy() for k, g in g2.items()}
    for k in ("w_in", "b_in", "w_hidden", "b_hidden"):
        assert nan[k].all(), k
    assert nan["w_out"][:, 2].all() and not nan["w_out"][:, :2].any()
    np.testing.assert_array_equal(nan["b_out"], [False, False, True])
    for k in nan:
        assert (np.isnan(np.asarray(g1[k])) | ~nan[k]).all(), k


def test_flat_order_is_ravel_pytree_order():
    """K1 writes its gradients flat in the order of JAX's ravel_pytree over
    the parameter dict (sorted keys); unflatten reads them back."""
    spec = MLPSpec(sizes=(2, 8, 8, 8, 3))
    arrays = numpy_params(spec.sizes)
    flat_jax, _ = ravel_pytree({k: jnp.asarray(v) for k, v in arrays.items()})
    assert kernels_step.n_flat(spec) == flat_jax.shape[0]
    views = kernels_step.unflatten(torch.from_numpy(np.array(flat_jax)), spec)
    for k, v in arrays.items():
        np.testing.assert_array_equal(views[k].numpy(), v)


def test_kernel_limits_and_launch_checks():
    assert kernels_step.kernel_supports(MLPSpec(sizes=(2,) + (20,) * 100 + (3,)))
    assert kernels_step.kernel_supports(MLPSpec(sizes=(2, 10, 3), init_type="kaiming"))
    assert kernels_step.kernel_supports(MLPSpec(sizes=(2, 24, 24, 3)))       # padded to 32
    assert kernels_step.kernel_supports(MLPSpec(sizes=(2, 128, 128, 3)))     # the wide body
    assert kernels_step.kernel_supports(MLPSpec(sizes=(12, 20, 20, 3)))      # d_in > 8: wide
    assert not kernels_step.kernel_supports(MLPSpec(sizes=(2, 129, 129, 3))) # beyond 128 lanes
    assert not kernels_step.kernel_supports(MLPSpec(sizes=(2, 20, 20, 4)))   # heads != (U, V, h)
    assert not kernels_step.kernel_supports(MLPSpec(sizes=(1, 20, 20, 3)))   # no y input
    assert not kernels_step.kernel_supports(MLPSpec(sizes=(2, 3)))           # no hidden layer
    spec = MLPSpec(sizes=(2, 20, 20, 3))
    params = params_from_numpy(numpy_params(spec.sizes), "cpu")
    coords, trues, sel, mask, fidw = step_inputs(16, 2)
    b = port_batch(coords, trues, sel, mask, fidw, 2, True)
    kernels_step._check_launch(params, b, spec)  # accepted
    with pytest.raises(ValueError, match="width"):
        kernels_step._check_launch(params, b, MLPSpec(sizes=(2, 130, 3)))
    with pytest.raises(ValueError, match="w_out"):
        kernels_step._check_launch(dict(params, w_out=torch.zeros(20, 4)), b, spec)
    with pytest.raises(ValueError, match="float32"):
        kernels_step._check_launch(dict(params, b_in=params["b_in"].double()), b, spec)


def test_precision_tiers_and_devices():
    spec = MLPSpec(sizes=(2, 16, 16, 3))
    params = params_from_numpy(numpy_params(spec.sizes), "cpu")
    b = port_batch(*step_inputs(8, 2), 2, True)
    (total, _), grads = kernels_step.fused_loss_and_grad(params, b, spec, precision="f32x3")
    (want, _), want_grads = kernels_step.fused_loss_and_grad_plain(params, b, spec, "f32x3")
    assert torch.equal(total, want) and all(torch.equal(grads[k], want_grads[k]) for k in grads)
    with pytest.raises(ValueError, match="precision"):
        kernels_step.fused_loss_and_grad(params, b, spec, precision="fp8")
    meta = kernels_step.make_step_batch(
        torch.zeros(4, 2, device="meta"), torch.zeros(4, 2, device="meta"),
        torch.zeros(4, device="meta"), torch.zeros(4, device="meta"), [1.0, 1.0], 2, 1.0, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        kernels_step.fused_loss_and_grad(params, meta, spec)
