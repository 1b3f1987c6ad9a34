"""The f32x3 (split-f32) tier of the port's kernels (``ops.tiers``), held
against the JAX package's kernels in interpret mode on the CPU from identical
numpy inputs: K2's plain f32x3 forward (K = 0, 2, 3 and the continuity
epilogue), K1's plain f32x3 step (the loss statistics and the six
gradients), the plain K3 and K4 (``impl='stream'`` and ``'rebuild'``) at
K = 0 and K = 2, and the slice as a whole: the iteration-1 losses and a
5-step Adam prefix of a Trainer at ``kernel_precision: "f32x3"`` (the
flagship's K1 path and the CMB pipeline's K2 + K3 path), and a Predictor.

Tolerances. A gap is the L2 norm of the difference over the L2 norm of the
JAX output (for a gradient dict, the largest over its arrays). Each
tolerance is at most 4x the gap measured on these inputs, and at most 1.5x
where 2x would reach the tier's own error. Both sides split the same
operands into bf16 (hi, lo) pairs and sum exact products in f32, in other
orders; one f32 roundoff that flips a hi rounding moves lo by the tier's
own 2^-16, so on the 12-layer net the gap reaches half the tier's error and
the margins are thin by nature (PERF.md). The JAX package's own f32x3
tolerances are 1e-4 to 2e-5 (``tests/test_kernels_vjp.py:64``,
``tests/test_kernels_step.py:142``). Every case also checks that the tier
is real: the JAX f32x3 result differs from the JAX f32 result by more than
the tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pinn_depthestimation_tpu.config import parse_config as jparse
from pinn_depthestimation_tpu.models import MLPSpec as JSpec
from pinn_depthestimation_tpu.ops import kernels as jk
from pinn_depthestimation_tpu.ops import kernels_step as jstep
from pinn_depthestimation_tpu.ops import kernels_vjp as jvjp
from pinn_depthestimation_tpu.training import loss as jloss
from pinn_depthestimation_tpu.training.driver import make_adam_optimizer as jax_adam
from pinn_depthestimation_tpu.utils import synthetic
from pinn_depthestimation_tpu_torch import data
from pinn_depthestimation_tpu_torch.config import parse_config
from pinn_depthestimation_tpu_torch.inference import Predictor
from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy
from pinn_depthestimation_tpu_torch.models.mlp import PARAM_KEYS
from pinn_depthestimation_tpu_torch.ops import kernels, kernels_step, kernels_vjp, tiers
from pinn_depthestimation_tpu_torch.parity import make_cmb_config
from pinn_depthestimation_tpu_torch.training.driver import Trainer
from test_torch_bf16 import inputs, numpy_params
from test_torch_train_step import port_batch, step_inputs

X3 = "f32x3"
SHALLOW = (2,) + (8,) * 3 + (3,)
DEEP = (2,) + (10,) * 12 + (6,)
DEEP3 = (2,) + (10,) * 12 + (3,)       # the deep net with heads (U, V, h)
THREE = (3,) + (8,) * 3 + (4,)         # three tangents need three inputs


def gap(got, want) -> float:
    """||got - want|| / ||want||."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def tree_gap(got, want) -> float:
    return max(gap(got[k], want[k]) for k in want if np.asarray(want[k]).size)


# ------------------------------------------------------------------ the tier

def test_split_is_the_jax_split():
    """``tiers.split`` is JAX ``_split_f32``: hi = bf16(x), lo = bf16(x -
    hi), bit for bit, and hi + lo carries ~16 bits of x."""
    x = np.random.RandomState(0).randn(4096).astype(np.float32) * 3
    hi, lo = tiers.split(torch.from_numpy(x))
    jhi, jlo = jk._split_f32(jnp.asarray(x))
    assert np.array_equal(hi.numpy(), np.asarray(jhi, np.float32))
    assert np.array_equal(lo.numpy(), np.asarray(jlo, np.float32))
    assert np.abs((hi + lo).numpy() - x).max() <= 2.0**-16 * np.abs(x).max()
    # the three products of exact bf16 values, (cross) + main, as in JAX
    w = np.random.RandomState(1).randn(16, 8).astype(np.float32)
    a = np.random.RandomState(2).randn(5, 16).astype(np.float32)
    w_hi, w_lo = tiers.split(torch.from_numpy(w))
    got = tiers.mm3(torch.from_numpy(a), w_hi, w_lo)
    assert gap(got, a @ w) <= 2e-5 and gap(got, a @ w) > 1e-7


# ------------------------------------------------------------------------ K2

@pytest.mark.parametrize("sizes,init,kt,tol", [
    (SHALLOW, "xavier", 0, 4.8e-6),     # measured 1.2e-6
    (SHALLOW, "xavier", 2, 4.8e-6),     # measured 1.2e-6 (y), 8.1e-7 (dy)
    (DEEP, "xavier", 2, 1.08e-5),       # measured 5.7e-6 (y), 7.2e-6 (dy); tier 1.7e-5
    (THREE, "kaiming", 3, 4.4e-7),      # measured 1.1e-7 (y), 7.0e-8 (dy)
])
def test_plain_k2_f32x3_matches_jax(sizes, init, kt, tol):
    _, jp, p, js, ps, x, _, _ = inputs(sizes, init, kt)
    jy, jdy = jk.packed_mlp_fwd_tangents(jp, jnp.asarray(x), js, kt, precision=X3,
                                         interpret=True)
    jy32, jdy32 = jk.packed_mlp_fwd_tangents(jp, jnp.asarray(x), js, kt, precision="f32",
                                             interpret=True)
    before = kernels.mlp_fwd_tangents.launches_by_tier[X3]
    y, dy = kernels.mlp_fwd_tangents(p, torch.from_numpy(x), ps, kt, precision=X3)
    assert kernels.mlp_fwd_tangents.launches_by_tier[X3] == before  # the CPU launches nothing
    pairs = [(y, jy, jy32)] + ([(dy, jdy, jdy32)] if kt else [])
    for got, want, want32 in pairs:
        assert got.shape == want.shape
        assert gap(got, want) <= tol
        assert gap(want, want32) > tol  # the tier is real


@pytest.mark.parametrize("sizes,tol", [
    (SHALLOW, 7.8e-6),   # measured 2.0e-6
    (DEEP3, 1.8e-5),     # measured 9.0e-6; tier 2.9e-5
])
def test_plain_continuity_epilogue_f32x3_matches_jax(sizes, tol):
    _, jp, p, js, ps, x, _, _ = inputs(sizes, "xavier", 2)
    jfc = jk.fused_residual_continuity(jp, jnp.asarray(x), js, precision=X3, interpret=True)
    jfc32 = jk.fused_residual_continuity(jp, jnp.asarray(x), js, precision="f32", interpret=True)
    fc = kernels.fused_residual_continuity(p, torch.from_numpy(x), ps, precision=X3)
    assert gap(fc, jfc) <= tol
    assert gap(jfc, jfc32) > tol


# ------------------------------------------------------------------------ K1

@pytest.mark.parametrize("sizes,n_true,has_anchor,tol,loss_tol", [
    (SHALLOW, 2, True, 2.2e-6, 4.2e-7),    # measured 5.6e-7, loss terms up to 2.1e-7
    (SHALLOW, 3, False, 1.7e-6, 3e-7),     # measured 4.2e-7, loss terms up to 7.6e-8
    (DEEP3, 2, True, 1.5e-5, 8.2e-7),      # measured 3.8e-6, loss terms up to 2.1e-7
])
def test_plain_k1_f32x3_matches_jax_step(sizes, n_true, has_anchor, tol, loss_tol):
    arrays = numpy_params(sizes)
    coords, trues, sel, mask, fidw = step_inputs(163, n_true)
    jargs = ({k: jnp.asarray(v) for k, v in arrays.items()}, jnp.asarray(coords),
             jnp.asarray(trues), jnp.asarray(sel), jnp.asarray(mask), jnp.asarray(fidw),
             JSpec(sizes=sizes), n_true, 0.7, 1.3)
    jkw = dict(anchor_depth=0.6, has_anchor=has_anchor, interpret=True)
    (t1, (f1, r1)), g1 = jstep.fused_loss_and_grad(*jargs, precision=X3, **jkw)
    (t32, (f32, r32)), g32 = jstep.fused_loss_and_grad(*jargs, precision="f32", **jkw)
    before = kernels_step.fused_loss_and_grad.launches
    (t2, (f2, r2)), g2 = kernels_step.fused_loss_and_grad(
        params_from_numpy(arrays, "cpu"),
        port_batch(coords, trues, sel, mask, fidw, n_true, has_anchor),
        MLPSpec(sizes=sizes), precision=X3)
    assert kernels_step.fused_loss_and_grad.launches == before
    for a, b in ((t2, t1), (f2, f1), (r2, r1)):
        np.testing.assert_allclose(float(a), float(b), rtol=loss_tol)
    assert tree_gap(g2, g1) <= tol
    assert tree_gap(g1, g32) > tol
    # the loss terms' own tier gap: the fidelity and the residual exceed it
    assert max(abs(float(a) - float(b)) / abs(float(b))
               for a, b in ((f1, f32), (r1, r32))) > loss_tol


# ------------------------------------------------------------------- K3, K4

@pytest.mark.parametrize("impl", ["stream", "rebuild"])
@pytest.mark.parametrize("sizes,kt,tol", [
    (SHALLOW, 0, 7.1e-6),    # measured 1.8e-6
    (SHALLOW, 2, 8e-6),      # measured 2.0e-6
    (DEEP, 0, 2.7e-5),       # measured 1.4e-5; tier 4.8e-5
    (DEEP, 2, 1.8e-5),       # measured 1.2e-5; tier 2.4e-5
])
def test_plain_k3_k4_f32x3_match_jax(impl, sizes, kt, tol):
    """K3 (``impl='stream'``, the default at f32x3) and K4
    (``impl='rebuild'``) compute one function; the port's plain version is
    held to each JAX backward."""
    _, jp, p, js, ps, x, ybar, dybar = inputs(sizes, "xavier", kt)
    jargs = (jp, jnp.asarray(x), jnp.asarray(ybar), jnp.asarray(dybar), js, kt)
    want = jvjp.packed_mlp_bwd(*jargs, precision=X3, interpret=True, impl=impl)
    want32 = jvjp.packed_mlp_bwd(*jargs, precision="f32", interpret=True, impl=impl)
    wrapper = kernels_vjp.packed_mlp_bwd if impl == "stream" else kernels_vjp.packed_mlp_bwd_rebuild
    before = wrapper.launches
    got = kernels_vjp.packed_mlp_bwd(p, torch.from_numpy(x), torch.from_numpy(ybar),
                                     torch.from_numpy(dybar), ps, kt, precision=X3, impl=impl)
    assert wrapper.launches == before
    assert all(got[k].shape == tuple(want[k].shape) for k in PARAM_KEYS)
    assert tree_gap(got, want) <= tol
    assert tree_gap(want, want32) > tol


def test_written_out_backward_splits_both_weight_gradient_operands():
    """At f32x3 the weight-gradient product splits both runtime operands
    (JAX ``mm_tn``), so it differs from an f32 product by the tier's error;
    the tangent-seed term of dw_in stays an f32 sum."""
    _, _, p, _, ps, x, ybar, dybar = inputs(SHALLOW, "xavier", 2)
    x, ybar, dybar = map(torch.from_numpy, (x, ybar, dybar))
    fwd = tiers.tier_forward(p, x, ps, 2, X3)
    g = tiers.tier_backward(p, x, fwd, ybar, dybar, ps, X3)
    a, b = fwd.a[-1], ybar
    exact = a.double().T @ b.double()
    split_ab = tiers.mm_tn(a, b, X3)
    assert gap(split_ab, exact) > 1e-7 and gap(split_ab, exact) < 1e-4
    assert torch.equal(tiers.mm_tn(a, b, "bf16"), a.T @ b)
    assert g["w_in"].shape == p["w_in"].shape and torch.isfinite(g["w_in"]).all()


# ---------------------------------------------------------------- the slice

def _flagship_like_raw(mat, **extra):
    raw = {
        "layers": {"input_features": 2, "hidden_layers": 3, "hidden_width": 8,
                   "output_features": 3, "dropout_rate": 0.0, "init_type": "xavier"},
        "adam_optimizer": {"max_it": 5, "learning_rate": 1e-3, "scheduler_step_size": 30,
                           "scheduler_gamma": 0.8},
        "lbfgs_optimizer": {"max_it": 0, "learning_rate": 1, "max_evaluation": 1,
                            "history_size": 10, "tolerance_grad": 1e-9,
                            "tolerance_change": 1e-12, "line_search_fn": "strong_wolfe"},
        "loss": {"weight_fid_loss": 1, "weight_res_loss": 1},
        "data": {"file": mat, "inputs": {"x": {"requires_grad": ["true"]},
                                         "y": {"requires_grad": ["true"]}},
                 "trues": ["U", "V"], "unknowns": ["h"]},
        "kernel_precision": X3, "fused_kernel": "on",
    }
    raw.update(extra)
    return raw


def _jax_prefix(jcfg, jvg, arrays, jbatch, n=5):
    """``n`` Adam steps of the JAX value-and-grad function from ``arrays``:
    the (fid, res, total) rows, as the Trainer logs them."""
    opt = jax_adam(jcfg)
    params = {k: jnp.asarray(v) for k, v in arrays.items()}
    state = opt.init(params)
    rows = []
    for _ in range(n):
        (total, (fid, res)), grads = jvg(params, jbatch)
        rows.append((float(fid), float(res), float(total)))
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    return np.array(rows)


def _assert_prefix(got, rows, tol_1, tol):
    """Iteration 1 within ``tol_1`` and the 5-step prefix within ``tol`` of
    the JAX f32x3 rows (relative), each farther than that from the JAX f32
    rows."""
    rel = lambda a, b: float(np.max(np.abs(a - b) / np.abs(b)))  # noqa: E731
    assert rel(got[0], rows[X3][0]) <= tol_1
    assert rel(got, rows[X3]) <= tol
    assert rel(rows[X3][0], rows["f32"][0]) > tol_1
    assert rel(rows[X3], rows["f32"]) > tol


def _port_prefix(cfg, arrays, run_dir, n=5):
    tr = Trainer(cfg, run_dir=run_dir, echo_every=0, initial_params=arrays, device="cpu")
    return tr, tr._adam_steps(n).numpy()[:, [0, 1, 2]]


def test_flagship_trainer_at_f32x3_matches_jax(tmp_path):
    """The flagship path at f32x3 (K1's plain f32x3 version on the CPU, with
    ``residual_chunk_size`` set and dropped on the kernel path): iteration 1
    and a 5-step Adam prefix against the JAX one-kernel step at f32x3 in
    interpret mode. Measured: iteration 1 agrees to 7.2e-8 relative (the
    tier moves it by 1.8e-6), the prefix to 8.9e-7 (the tier: 7.6e-6)."""
    mat = str(tmp_path / "data.mat")
    synthetic.make_newmethod_mat(mat, nx=16, ny=20, nan_fraction=0.05, seed=2)
    raw = _flagship_like_raw(mat, residual_chunk_size=64)
    cfg, jcfg = parse_config(raw), jparse(raw)
    arrays = numpy_params(SHALLOW, seed=4)
    (tmp_path / "port").mkdir()
    tr, got = _port_prefix(cfg, arrays, str(tmp_path / "port"))
    assert tr.fused_step_fn is not None and tr.kernel_plan.k1
    td = data.load_training_data(cfg)
    jbatch = {k: jnp.asarray(getattr(td, k))
              for k in ("fidelity_input", "fidelity_true", "residual_input")}
    rows = {}
    for tier in (X3, "f32"):
        jvg = jloss.build_value_and_grad_fn(
            jcfg, JSpec(sizes=SHALLOW), input_min_max=td.input_min_max, fused_kernel=True,
            fused_interpret=True, fused_precision=tier, fidelity_is_residual=True)
        rows[tier] = _jax_prefix(jcfg, jvg, arrays, jbatch)
    _assert_prefix(got, rows, tol_1=2.9e-7, tol=3.5e-6)


def test_cmb_trainer_at_f32x3_matches_jax(tmp_path, monkeypatch):
    """The CMB pipeline at f32x3 (K2 and K3's plain f32x3 versions for the
    residual and the fidelity term): iteration 1 and a 5-step Adam prefix
    against the JAX fused loss at f32x3 in interpret mode, with the JAX
    fidelity threshold lowered to 0 so that both route the 40 fidelity rows
    through the kernels (tests/test_torch_bf16.py says why). Measured:
    iteration 1 agrees to 2.3e-7 relative, the prefix to 5.6e-7 (the tier
    moves both by 3.7e-5)."""
    monkeypatch.setattr(jloss, "FUSED_FIDELITY_MIN_POINTS", 0)
    csv, mat = str(tmp_path / "fid.csv"), str(tmp_path / "res.mat")
    synthetic.make_cmb_dataset(csv, mat, nx=21, ny=31, n_csv=60, seed=6, nan_fraction=0.03)
    raw = make_cmb_config(csv, mat, 5, 0, hidden_layers=4, hidden_width=10, nx=21, ny=31,
                          interval=2, training_points=40)
    raw.update(kernel_precision=X3, fused_kernel="on", residual_chunk_size=64)
    cfg, jcfg = parse_config(raw), jparse(raw)
    spec = MLPSpec.from_layers(cfg.layers)
    arrays = numpy_params(spec.sizes, seed=2)
    arrays["b_out"][3] += 1.0  # the eta head shifted, so eta + h stays away from 0
    (tmp_path / "port").mkdir()
    tr, got = _port_prefix(cfg, arrays, str(tmp_path / "port"))
    assert tr.fused_step_fn is None and tr.kernel_plan.fused
    td = data.load_training_data(cfg)
    jbatch = {k: jnp.asarray(getattr(td, k))
              for k in ("fidelity_input", "fidelity_true", "residual_input")}
    rows = {}
    for tier in (X3, "f32"):
        jfn = jloss.build_loss_fn(jcfg, JSpec.from_layers(jcfg.layers),
                                  input_min_max=td.input_min_max, fused_kernel=True,
                                  fused_interpret=True, fused_precision=tier)
        jvg = jax.value_and_grad(lambda p, b, _f=jfn: _f(p, b), has_aux=True)
        rows[tier] = _jax_prefix(jcfg, jvg, arrays, jbatch)
    _assert_prefix(got, rows, tol_1=9e-7, tol=2.2e-6)


def test_predictor_at_f32x3_matches_jax(tmp_path):
    """A Predictor at ``kernel_precision: "f32x3"`` through K2 (its plain
    f32x3 version on the CPU) against the JAX K2 at f32x3 in interpret mode
    on the test grid. Measured gap 2.4e-6 (the tier: 1.8e-5)."""
    mat = str(tmp_path / "grid.mat")
    synthetic.make_newmethod_mat(mat, nx=12, ny=10, nan_fraction=0.1, seed=3)
    raw = _flagship_like_raw(mat)
    raw["data_test"] = {"file": mat, "nx": 12, "ny": 10, "x_min": 25.0, "x_max": 33.0,
                        "y_min": -13.0, "y_max": 13.0}
    cfg = parse_config(raw)
    arrays = numpy_params(SHALLOW, seed=5)
    npz = str(tmp_path / "model.npz")
    np.savez(npz, **arrays)
    pred = Predictor(cfg, npz, device="cpu", use_kernel=True)
    assert pred.use_kernel and pred.precision == X3
    td = data.load_test_data(cfg)
    got = pred.predict(td.inputs)
    jp = {k: jnp.asarray(v) for k, v in arrays.items()}
    want, _ = jk.packed_mlp_fwd_tangents(jp, jnp.asarray(td.inputs), JSpec(sizes=SHALLOW), 0,
                                         precision=X3, interpret=True)
    want32, _ = jk.packed_mlp_fwd_tangents(jp, jnp.asarray(td.inputs), JSpec(sizes=SHALLOW), 0,
                                           precision="f32", interpret=True)
    tol = 7.3e-6
    assert gap(got, want) <= tol
    assert gap(want, want32) > tol
