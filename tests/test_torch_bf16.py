"""The bf16 tier of the port's kernels (``ops.tiers``), held against the JAX
package in interpret mode on the CPU from identical numpy inputs: K2's plain
bf16 forward (K = 0, 2, 3 and the continuity epilogue), K1's plain bf16 step,
the plain K4 (``impl='rebuild'``) at f32 and bf16, and the CMB loss at bf16
through ``build_loss_fn(fused_kernel=True, fused_precision='bf16')``.

Tolerances. Each case's tolerance is at most 4x the gap measured between
the port and the JAX function on these inputs (the largest output, each
array relative to its largest entry), and never looser than the JAX
package's own bf16 tolerances (3e-2 for gradients in
``tests/test_kernels_vjp.py:64``, 4e-2 for gradients and 1e-2 for loss
terms in ``tests/test_kernels_step.py:160``/``:204``). Most gaps are f32
roundoff (1e-7 of the scale): both sides round the same operands to bf16,
round to nearest even, and sum the exact products in f32 in other orders.
Where one of those f32 differences flips a bf16 rounding deep in a chain,
the gap grows to that flip's size (the 23-layer K1 case, the LeakyReLU
tangents at K=3). Every bf16 case also checks that the tier is real: the
JAX bf16 result differs from the JAX f32 result by more than the
tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn_depthestimation_tpu.config import parse_config as jparse
from pinn_depthestimation_tpu.models import MLPSpec as JSpec
from pinn_depthestimation_tpu.ops import kernels as jk
from pinn_depthestimation_tpu.ops import kernels_step as jstep
from pinn_depthestimation_tpu.ops import kernels_vjp as jvjp
from pinn_depthestimation_tpu.training import loss as jloss
from pinn_depthestimation_tpu.utils import synthetic
from pinn_depthestimation_tpu_torch import data
from pinn_depthestimation_tpu_torch.config import parse_config
from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy
from pinn_depthestimation_tpu_torch.models.mlp import PARAM_KEYS
from pinn_depthestimation_tpu_torch.ops import kernels, kernels_step, kernels_vjp, tiers
from pinn_depthestimation_tpu_torch.parity import make_cmb_config
from pinn_depthestimation_tpu_torch.training import loss

SHALLOW = (2,) + (20,) * 5 + (3,)
DEEP = (2,) + (20,) * 23 + (3,)        # several K4 segments at any C <= 8
CMB = (2,) + (10,) * 4 + (6,)
THREE = (3,) + (20,) * 6 + (4,)        # three tangents need three inputs


def numpy_params(sizes, seed=1):
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


def gap(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def tree_gap(got, want) -> float:
    return max(gap(got[k], want[k]) for k in want if np.asarray(want[k]).size)


def inputs(sizes, init, n_tangents, n=203, seed=3):
    rs = np.random.RandomState(seed)
    x = rs.uniform(-1, 1, (n, sizes[0])).astype(np.float32)
    ybar = rs.randn(n, sizes[-1]).astype(np.float32)
    dybar = rs.randn(n_tangents, n, sizes[-1]).astype(np.float32)
    arrays = numpy_params(sizes)
    return (arrays, {k: jnp.asarray(v) for k, v in arrays.items()},
            params_from_numpy(arrays, "cpu"), JSpec(sizes=sizes, init_type=init),
            MLPSpec(sizes=sizes, init_type=init), x, ybar, dybar)


# ------------------------------------------------------------------------ K2

@pytest.mark.parametrize("sizes,init,kt,tol", [
    (SHALLOW, "xavier", 0, 3e-7),     # measured 8.6e-8
    (SHALLOW, "xavier", 2, 4e-7),     # measured 1.2e-7
    (DEEP, "xavier", 2, 4e-7),        # measured 1.0e-7
    (CMB, "xavier", 2, 2e-7),         # measured 5.5e-8
    (THREE, "kaiming", 3, 2.8e-3),    # measured 7.1e-4: a flipped rounding at a LeakyReLU kink
])
def test_plain_k2_bf16_matches_jax(sizes, init, kt, tol):
    _, jp, p, js, ps, x, _, _ = inputs(sizes, init, kt)
    jy, jdy = jk.packed_mlp_fwd_tangents(jp, jnp.asarray(x), js, kt, precision="bf16",
                                         interpret=True)
    jy32, jdy32 = jk.packed_mlp_fwd_tangents(jp, jnp.asarray(x), js, kt, precision="f32",
                                             interpret=True)
    before = kernels.mlp_fwd_tangents.launches_by_tier["bf16"]
    y, dy = kernels.mlp_fwd_tangents(p, torch.from_numpy(x), ps, kt, precision="bf16")
    assert kernels.mlp_fwd_tangents.launches_by_tier["bf16"] == before  # the CPU launches nothing
    pairs = [(y, jy, jy32)] + ([(dy, jdy, jdy32)] if kt else [])
    for got, want, want32 in pairs:
        assert got.shape == want.shape
        assert gap(got, want) <= tol
        assert gap(want, want32) > tol  # the tier is real


@pytest.mark.parametrize("sizes,tol", [(SHALLOW, 5e-7), (DEEP, 5e-7)])  # measured 1.3e-7, 1.4e-7
def test_plain_continuity_epilogue_bf16_matches_jax(sizes, tol):
    _, jp, p, js, ps, x, _, _ = inputs(sizes, "xavier", 2)
    jfc = jk.fused_residual_continuity(jp, jnp.asarray(x), js, precision="bf16", interpret=True)
    jfc32 = jk.fused_residual_continuity(jp, jnp.asarray(x), js, precision="f32", interpret=True)
    fc = kernels.fused_residual_continuity(p, torch.from_numpy(x), ps, precision="bf16")
    assert gap(fc, jfc) <= tol
    assert gap(jfc, jfc32) > tol


# ------------------------------------------------------------------------ K4

@pytest.mark.parametrize("sizes,init,kt,precision,tol", [
    (SHALLOW, "xavier", 2, "f32", 1.9e-6),  # measured 4.9e-7
    (SHALLOW, "xavier", 2, "bf16", 1.4e-6), # measured 3.5e-7
    (DEEP, "xavier", 2, "f32", 4.7e-6),     # measured 1.2e-6
    (DEEP, "xavier", 2, "bf16", 2.4e-6),    # measured 6.2e-7
    (CMB, "xavier", 0, "f32", 1.7e-6),      # measured 4.3e-7
    (CMB, "xavier", 0, "bf16", 1.7e-6),     # measured 4.3e-7
    (THREE, "kaiming", 3, "f32", 1.5e-6),   # measured 4.0e-7
    (THREE, "kaiming", 3, "bf16", 1e-5),    # measured 2.6e-6
])
def test_plain_k4_matches_jax_rebuild(sizes, init, kt, precision, tol):
    _, jp, p, js, ps, x, ybar, dybar = inputs(sizes, init, kt)
    jargs = (jp, jnp.asarray(x), jnp.asarray(ybar), jnp.asarray(dybar), js, kt)
    want = jvjp.packed_mlp_bwd(*jargs, precision=precision, interpret=True, impl="rebuild")
    before = kernels_vjp.packed_mlp_bwd_rebuild.launches
    got = kernels_vjp.packed_mlp_bwd(p, torch.from_numpy(x), torch.from_numpy(ybar),
                                     torch.from_numpy(dybar), ps, kt, precision=precision,
                                     impl="rebuild")
    assert kernels_vjp.packed_mlp_bwd_rebuild.launches == before
    assert all(got[k].shape == tuple(want[k].shape) for k in PARAM_KEYS)
    assert tree_gap(got, want) <= tol
    if precision == "bf16":
        want32 = jvjp.packed_mlp_bwd(*jargs, precision="f32", interpret=True, impl="rebuild")
        assert tree_gap(want, want32) > tol


def test_written_out_backward_at_f32_equals_autograd():
    """The bf16 plain backward is ``tiers.tier_backward``; at f32 (no
    rounding) the same function is autograd's backward, to f32 roundoff
    (measured up to 5.9e-7 of the scale)."""
    for sizes, init, kt in ((DEEP, "xavier", 2), (THREE, "kaiming", 3), (CMB, "xavier", 0)):
        _, _, p, _, ps, x, ybar, dybar = inputs(sizes, init, kt)
        x, ybar, dybar = map(torch.from_numpy, (x, ybar, dybar))
        fwd = tiers.tier_forward(p, x, ps, kt, "f32")
        written = tiers.tier_backward(p, x, fwd, ybar, dybar, ps, "f32")
        auto = kernels_vjp.packed_mlp_bwd_plain(p, x, ybar, dybar, ps, kt, "f32")
        assert tree_gap(written, {k: v.numpy() for k, v in auto.items()}) <= 2.3e-6


def test_bf16_rounds_to_nearest_even():
    x = torch.tensor([1.0 + 2.0**-8, 1.0 + 3 * 2.0**-8, -(1.0 + 2.0**-8), 3.0])
    assert tiers.rnd(x, "bf16").tolist() == [1.0, 1.0 + 2.0**-6, -1.0, 3.0]
    assert tiers.rnd(x, "f32") is x


# ------------------------------------------------------------------------ K1

@pytest.mark.parametrize("sizes,n_true,has_anchor,tol,loss_tol", [
    (SHALLOW, 2, True, 1.1e-6, 1e-7),     # measured 2.8e-7, loss terms equal
    (SHALLOW, 3, False, 1.7e-6, 4e-7),    # measured 4.3e-7, loss 1.2e-7
    (DEEP, 2, True, 1.6e-3, 2.3e-4),      # measured 4.1e-4, loss 5.8e-5: flips deep in the chain
])
def test_plain_k1_bf16_matches_jax_step(sizes, n_true, has_anchor, tol, loss_tol):
    from test_torch_train_step import port_batch, step_inputs

    arrays = numpy_params(sizes)
    coords, trues, sel, mask, fidw = step_inputs(163, n_true)
    jargs = ({k: jnp.asarray(v) for k, v in arrays.items()}, jnp.asarray(coords),
             jnp.asarray(trues), jnp.asarray(sel), jnp.asarray(mask), jnp.asarray(fidw),
             JSpec(sizes=sizes), n_true, 0.7, 1.3)
    jkw = dict(anchor_depth=0.6, has_anchor=has_anchor, interpret=True)
    (t1, (f1, r1)), g1 = jstep.fused_loss_and_grad(*jargs, precision="bf16", **jkw)
    (_, _), g32 = jstep.fused_loss_and_grad(*jargs, precision="f32", **jkw)
    before = kernels_step.fused_loss_and_grad.launches
    (t2, (f2, r2)), g2 = kernels_step.fused_loss_and_grad(
        params_from_numpy(arrays, "cpu"),
        port_batch(coords, trues, sel, mask, fidw, n_true, has_anchor),
        MLPSpec(sizes=sizes), precision="bf16")
    assert kernels_step.fused_loss_and_grad.launches == before
    for a, b in ((t2, t1), (f2, f1), (r2, r1)):
        np.testing.assert_allclose(float(a), float(b), rtol=loss_tol)
    assert tree_gap(g2, g1) <= tol
    assert tree_gap(g1, g32) > tol


# ------------------------------------------------------------------ CMB loss

@pytest.mark.parametrize("parity", [True, False])
def test_cmb_loss_bf16_matches_jax(tmp_path, monkeypatch, parity):
    """The CMB loss and its gradients at bf16: the port's fused path (K2-bf16
    and K4-bf16's plain versions, for the residual and the fidelity term)
    against the JAX fused path in interpret mode (K2-bf16 and the rebuild
    backward). The JAX package sends a fidelity set below
    ``FUSED_FIDELITY_MIN_POINTS`` rows through XLA in f32; the port takes
    the kernels at every size (``ROADMAP.md`` Queue 3), so at bf16 the
    routes give other values (3e-4 of the loss here). The test lowers the
    JAX threshold to 0 so that both take the same route. Measured gaps:
    loss terms equal, gradients 4.1e-7 of their scale."""
    monkeypatch.setattr(jloss, "FUSED_FIDELITY_MIN_POINTS", 0)
    csv, mat = str(tmp_path / "fid.csv"), str(tmp_path / "res.mat")
    synthetic.make_cmb_dataset(csv, mat, nx=21, ny=31, n_csv=60, seed=6, nan_fraction=0.03)
    raw = make_cmb_config(csv, mat, 5, 0, hidden_layers=4, hidden_width=10, nx=21, ny=31,
                          interval=2, training_points=40)
    raw.update(parity=parity, kernel_precision="bf16")
    cfg, jcfg = parse_config(raw), jparse(raw)
    td = data.load_training_data(cfg)
    spec = MLPSpec.from_layers(cfg.layers)
    assert spec.sizes == CMB
    arrays = numpy_params(spec.sizes, seed=2)
    arrays["b_out"][3] += 1.0  # the eta head shifted, so eta + h stays away from 0
    keys = ("fidelity_input", "fidelity_true", "residual_input")
    batch = {k: torch.from_numpy(getattr(td, k)) for k in keys}
    jbatch = {k: jnp.asarray(getattr(td, k)) for k in keys}
    jparams = {k: jnp.asarray(v) for k, v in arrays.items()}
    want = {}
    for tier in ("bf16", "f32"):
        jfn = jloss.build_loss_fn(jcfg, JSpec.from_layers(jcfg.layers),
                                  input_min_max=td.input_min_max, fused_kernel=True,
                                  fused_interpret=True, fused_precision=tier)
        want[tier] = jax.value_and_grad(lambda p: jfn(p, jbatch), has_aux=True)(jparams)
    fn = loss.build_loss_fn(cfg, spec, input_min_max=td.input_min_max, fused_kernel=True,
                            fused_precision=cfg.resolved_kernel_precision())
    (total, (fid, res)), grads = loss.value_and_grad(fn)(params_from_numpy(arrays, "cpu"), batch)
    (jtotal, (jfid, jres)), jgrads = want["bf16"]
    for a, b in ((total, jtotal), (fid, jfid), (res, jres)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-7)
    assert tree_gap(grads, jgrads) <= 1.6e-6
    assert tree_gap(jgrads, want["f32"][1]) > 1.6e-6


# ------------------------------------------------------------------- routing

def test_auto_at_bf16_takes_the_rebuild_backward(monkeypatch):
    """``impl='auto'`` resolves per tier as the JAX ``BWD_IMPL_DEFAULT``:
    bf16 reaches K4's wrapper (its plain version on the CPU), f32 and
    f32x3 K3's."""
    _, _, p, _, ps, x, ybar, dybar = inputs(SHALLOW, "xavier", 2, n=17)
    x, ybar, dybar = map(torch.from_numpy, (x, ybar, dybar))
    calls = []
    real = kernels_vjp.packed_mlp_bwd_rebuild

    def spy(*args, **kwargs):
        calls.append(kwargs["precision"])
        return real(*args, **kwargs)

    monkeypatch.setattr(kernels_vjp, "packed_mlp_bwd_rebuild", spy)
    g_auto = kernels_vjp.packed_mlp_bwd(p, x, ybar, dybar, ps, 2, precision="bf16")
    assert calls == ["bf16"]
    g_plain = kernels_vjp.packed_mlp_bwd_plain(p, x, ybar, dybar, ps, 2, "bf16")
    assert all(torch.equal(g_auto[k], g_plain[k]) for k in PARAM_KEYS)
    kernels_vjp.packed_mlp_bwd(p, x, ybar, dybar, ps, 2, precision="f32")
    kernels_vjp.packed_mlp_bwd(p, x, ybar, dybar, ps, 2, precision="bf16", impl="stream")
    assert calls == ["bf16"]
    assert tiers.BWD_IMPL_DEFAULT == {"f32": "stream", "f32x3": "stream", "bf16": "rebuild"}
    assert jvjp.BWD_IMPL_DEFAULT == tiers.BWD_IMPL_DEFAULT
    g3 = kernels_vjp.packed_mlp_bwd(p, x, ybar, dybar, ps, 2, precision="f32x3")
    assert calls == ["bf16"]  # f32x3 'auto' is the stream backward (K3)
    g3_plain = kernels_vjp.packed_mlp_bwd_plain(p, x, ybar, dybar, ps, 2, "f32x3")
    assert all(torch.equal(g3[k], g3_plain[k]) for k in PARAM_KEYS)
    kernels_vjp.packed_mlp_bwd(p, x, ybar, dybar, ps, 2, precision="f32x3", impl="rebuild")
    assert calls == ["bf16", "f32x3"]
    with pytest.raises(ValueError, match="precision"):
        kernels_vjp.packed_mlp_bwd(p, x, ybar, dybar, ps, 2, precision="fp8")


def test_fused_apply_carries_the_tier_and_the_backward():
    """``fused_apply_with_tangents(precision='bf16')``: the forward is K2's
    bf16 plain version and the backward K4's (through ``bwd_impl='auto'``),
    bit for bit on the CPU."""
    _, _, p, _, ps, x, ybar, dybar = inputs(DEEP, "xavier", 2, n=65)
    x, ybar, dybar = map(torch.from_numpy, (x, ybar, dybar))
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    y, dy = kernels_vjp.fused_apply_with_tangents(leaves, x, ps, 2, "bf16")
    y_ref, dy_ref = kernels.mlp_fwd_tangents_plain(p, x, ps, 2, "bf16")
    assert torch.equal(y, y_ref) and torch.equal(dy, dy_ref)
    grads = torch.autograd.grad((y, dy), [leaves[k] for k in PARAM_KEYS], (ybar, dybar))
    want = kernels_vjp.packed_mlp_bwd_plain(p, x, ybar, dybar, ps, 2, "bf16")
    assert all(torch.equal(g, want[k]) for g, k in zip(grads, PARAM_KEYS))
    with pytest.raises(ValueError, match="impl"):
        kernels_vjp.fused_apply_with_tangents(p, x, ps, 2, "bf16", bwd_impl="ring")
