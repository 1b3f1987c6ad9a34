"""The port's float64 L-BFGS polish (``Trainer.train_f64_polish``, the
``lbfgs64``/``params64`` checkpoint sections, CLI ``--f64-polish``) held
against the JAX package's on the CPU.

* The f64 loss and gradient the polish differentiates (K1's plain form
  inside the one-kernel gate, the generic loss for the CMB pipeline) against
  the JAX package's under ``jax.enable_x64()``: within 1e-11 relative (both
  are float64 sums of the same terms in different orders; measured 1.4e-16
  on the loss terms and 7.0e-16 of the gradients' scale, both configs).
* The JAX ``tests/test_train.py:440-640`` cases, ported: the identical f32
  prefix and the extra rows, the improvement, f32 parameters back; exact
  mid-polish continuation; extension from ``params64``; the polish under a
  mesh on the unsharded batch.
* The port's and the JAX package's polish from the same f32 parameters at
  ``backend='cpu'``: their rows as ``log.txt`` prints them (six significant
  digits) agree for the first evaluations, and their f64 minima within
  1e-9 relative (measured: 5.1e-13 apart, the test below).
* CLI ``--f64-polish``'s merge semantics (JAX ``tests/test_cli.py:170-215``).
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn_depthestimation_tpu.config import parse_config as jparse
from pinn_depthestimation_tpu.models import MLPSpec as JSpec
from pinn_depthestimation_tpu.training import Trainer as JTrainer
from pinn_depthestimation_tpu.training import build_loss_fn as jbuild_loss_fn
from pinn_depthestimation_tpu.training.logging_utils import read_log as jread_log
from pinn_depthestimation_tpu.utils import synthetic
from pinn_depthestimation_tpu_torch import cli, parallel
from pinn_depthestimation_tpu_torch.config import parse_config
from pinn_depthestimation_tpu_torch.data import load_training_data
from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy
from pinn_depthestimation_tpu_torch.ops import kernels_step
from pinn_depthestimation_tpu_torch.optim import lbfgs as lbfgs_mod
from pinn_depthestimation_tpu_torch.training import checkpoint as ckpt_mod
from pinn_depthestimation_tpu_torch.training import driver
from pinn_depthestimation_tpu_torch.training.driver import Trainer
from pinn_depthestimation_tpu_torch.training.logging_utils import read_log
from pinn_depthestimation_tpu_torch.training.loss import build_loss_fn, value_and_grad

BATCH_KEYS = ("fidelity_input", "fidelity_true", "residual_input")


def newmethod_raw(mat, adam_it=60, lbfgs_it=15, **extra):
    """The JAX test's config (``tests/test_train.py::_newmethod_raw``)."""
    raw = {
        "layers": {"input_features": 2, "hidden_layers": 3, "hidden_width": 16,
                   "output_features": 3, "dropout_rate": 0.0, "init_type": "xavier"},
        "adam_optimizer": {"max_it": adam_it, "learning_rate": 1e-3,
                           "scheduler_step_size": 30, "scheduler_gamma": 0.8},
        "lbfgs_optimizer": {"max_it": lbfgs_it, "learning_rate": 1,
                            "max_evaluation": round(lbfgs_it * 1.25), "history_size": 10,
                            "tolerance_grad": 1e-9, "tolerance_change": 1e-12,
                            "line_search_fn": "strong_wolfe"},
        "loss": {"weight_fid_loss": 1, "weight_res_loss": 1},
        "data": {"file": mat,
                 "inputs": {"x": {"requires_grad": ["true"]},
                            "y": {"requires_grad": ["true"]}},
                 "trues": ["U", "V"], "unknowns": ["h"]},
    }
    raw.update(extra)
    return raw


@pytest.fixture
def mat(tmp_path):
    path = str(tmp_path / "data.mat")
    synthetic.make_newmethod_mat(path, nx=16, ny=20, nan_fraction=0.05, seed=2)
    return path


def cmb_raw(tmp_path):
    csv, res = str(tmp_path / "fid.csv"), str(tmp_path / "res.mat")
    synthetic.make_cmb_dataset(csv, res, nx=15, ny=13, n_csv=77, seed=6, nan_fraction=0.03)
    outputs = ["h", "U", "V", "eta_mean", "Hrms", "k"]
    return {
        "layers": {"input_features": 2, "hidden_layers": 3, "hidden_width": 10,
                   "output_features": 6, "dropout_rate": 0.0, "init_type": "xavier"},
        "adam_optimizer": {"max_it": 5, "learning_rate": 1e-4,
                           "scheduler_step_size": 100, "scheduler_gamma": 0.8},
        "lbfgs_optimizer": {"max_it": 0, "learning_rate": 1, "max_evaluation": 0,
                            "history_size": 10, "tolerance_grad": 1e-9,
                            "tolerance_change": 1e-12, "line_search_fn": "strong_wolfe"},
        "loss": {"weight_fid_loss": 1, "weight_res_loss": 1, "weight_h_loss": 2,
                 "weight_U_loss": 1, "weight_V_loss": 1, "weight_eta_mean_loss": 1,
                 "weight_Hrms_loss": 0.5, "weight_k_loss": 0.5},
        "data_fidelity": {"file": csv, "inputs": ["x", "y"], "outputs": outputs,
                          "training_points": 60},
        "data_residual": {"file": res,
                          "inputs": {"x": {"requires_grad": ["true"]},
                                     "y": {"requires_grad": ["true"]}},
                          "outputs": outputs, "interval_x": 1, "interval_y": 1},
        "data_test": {"x_min": 25.0, "x_max": 33.0, "y_min": -13.0, "y_max": 13.0},
        "physics": "wave_averaged",
        "parity": False,
    }


def numpy_params(sizes, seed=0, eta_col=None):
    rng = np.random.RandomState(seed)
    d_in, W, d_out, n_stack = sizes[0], sizes[1], sizes[-1], len(sizes) - 3
    scale = np.sqrt(3.0 / W)
    p = {
        "w_in": rng.uniform(-1, 1, (d_in, W)).astype(np.float32),
        "b_in": rng.uniform(-0.1, 0.1, W).astype(np.float32),
        "w_hidden": (rng.uniform(-1, 1, (n_stack, W, W)) * scale).astype(np.float32),
        "b_hidden": rng.uniform(-0.1, 0.1, (n_stack, W)).astype(np.float32),
        "w_out": (rng.uniform(-1, 1, (W, d_out)) * scale).astype(np.float32),
        "b_out": rng.uniform(-0.2, 0.2, d_out).astype(np.float32),
    }
    if eta_col is not None:
        p["b_out"][eta_col] += 1.0
    return p


def run_dir(tmp_path, name):
    path = str(tmp_path / name)
    os.makedirs(path)
    return path


# ------------------------------------------------------ the f64 loss itself


@pytest.mark.parametrize("pipeline", ["newmethod", "cmb"])
def test_f64_loss_and_grad_match_jax(tmp_path, mat, pipeline):
    """The loss the polish differentiates, in float64, against the JAX
    package's under ``jax.enable_x64()``: K1's plain form (the flagship's
    one-kernel gate) and the CMB pipeline's generic loss, loss terms and
    every gradient within 1e-11 relative (of each leaf's largest entry)."""
    raw = newmethod_raw(mat) if pipeline == "newmethod" else cmb_raw(tmp_path)
    cfg = parse_config(raw)
    td = load_training_data(cfg)
    spec = MLPSpec.from_layers(cfg.layers)
    arrays = numpy_params(spec.sizes, seed=3, eta_col=None if pipeline == "newmethod" else 3)
    kw = dict(input_min_max=td.input_min_max, fidelity_is_residual=td.fidelity_is_residual)
    loss_fn = build_loss_fn(cfg, spec, residual_chunk_size=cfg.residual_chunk_size, **kw)
    params = {k: torch.as_tensor(v).double() for k, v in arrays.items()}
    batch = {k: torch.as_tensor(np.asarray(getattr(td, k), np.float64)) for k in BATCH_KEYS}
    (t, (f, r)), g = value_and_grad(loss_fn)(params, batch)
    assert t.dtype == torch.float64 and all(v.dtype == torch.float64 for v in g.values())
    jcfg = jparse(raw)
    with jax.enable_x64():
        jloss = jbuild_loss_fn(jcfg, JSpec.from_layers(jcfg.layers),
                               residual_chunk_size=jcfg.residual_chunk_size, **kw)
        jp = {k: jnp.asarray(v, jnp.float64) for k, v in arrays.items()}
        jb = {k: jnp.asarray(np.asarray(getattr(td, k), np.float64)) for k in BATCH_KEYS}
        (jt, (jf, jr)), jg = jax.value_and_grad(jloss, has_aux=True)(jp, jb)
        assert jt.dtype == jnp.float64
        want = np.asarray([jf, jr, jt])
        jg = {k: np.asarray(v) for k, v in jg.items()}
    np.testing.assert_allclose([float(f), float(r), float(t)], want, rtol=1e-11)
    for k, w in jg.items():
        np.testing.assert_allclose(g[k].numpy(), w, rtol=0, atol=1e-11 * np.abs(w).max(),
                                   err_msg=k)


def test_k1_plain_form_follows_the_batch_dtype(mat):
    """``make_step_batch`` and the scales keep a float64 batch in float64
    (no f32 cast), and K1's launch keeps refusing anything but float32."""
    cfg = parse_config(newmethod_raw(mat))
    td = load_training_data(cfg)
    coords = torch.as_tensor(td.residual_input).double()
    n = coords.shape[0]
    b = kernels_step.make_step_batch(coords, torch.as_tensor(td.fidelity_true).double(),
                                     torch.ones(n, dtype=torch.float64),
                                     torch.ones(n, dtype=torch.float64), [1.0, 1.0], 2, 1.0, 1.0)
    for t in (b.coords, b.trues, b.sel, b.mask, b.fid_weights, b.n_res, b.n_sel, b.scal):
        assert t.dtype == torch.float64
    b32 = kernels_step.make_step_batch(coords.float(), torch.as_tensor(td.fidelity_true),
                                       torch.ones(n), torch.ones(n), [1.0, 1.0], 2, 1.0, 1.0)
    assert all(t.dtype == torch.float32 for t in (b32.coords, b32.scal, b32.n_res))
    spec = MLPSpec.from_layers(cfg.layers)
    p64 = {k: v.double() for k, v in params_from_numpy(numpy_params(spec.sizes), "cpu").items()}
    total, fid, res = kernels_step.shared_forward_loss_plain(p64, b, spec)
    assert total.dtype == fid.dtype == res.dtype == torch.float64
    with pytest.raises(ValueError, match="float32"):
        kernels_step._check_launch(p64, b, spec)


# ------------------------------------------------------------ the polish


def test_f64_polish_phase(mat, tmp_path):
    """JAX ``test_f64_polish_phase``: the polish runs after the f32 L-BFGS
    phase, logs every evaluation in the same ``log.txt``, improves on the
    f32 phases' best and hands back f32 parameters."""
    raw = newmethod_raw(mat, adam_it=40, lbfgs_it=10)
    tr_a = Trainer(parse_config(raw), run_dir=run_dir(tmp_path, "a"), echo_every=0, device="cpu")
    tr_a.train()
    totals_a = read_log(tr_a.run_dir)[3]
    tr_b = Trainer(parse_config(dict(raw, f64_polish={"max_it": 25})),
                   run_dir=run_dir(tmp_path, "b"), echo_every=0, device="cpu")
    tr_b.train()
    epochs_b, _, _, totals_b = read_log(tr_b.run_dir)
    n = len(totals_a)
    assert totals_b[:n] == totals_a
    assert len(totals_b) > n
    assert epochs_b == list(range(1, len(epochs_b) + 1))
    assert min(totals_b[n:]) < min(totals_a)
    assert all(v.dtype == torch.float32 for v in tr_b.state.params.values())
    assert "f64_polish_seconds" in tr_b.stats and "f64_polish_seconds" not in tr_a.stats
    assert tr_b.stats["loss_evaluations"] == n
    assert tr_b.stats["f64_polish_evaluations"] == len(totals_b) - n
    # the f32 parameters are the rounded f64 iterate
    x64 = tr_b._live_lbfgs64_state.x
    assert x64.dtype == torch.float64
    flat32 = tr_b._lbfgs64_runner.flatten(tr_b.state.params)
    assert torch.equal(flat32, x64.float())


def test_polish_evaluations_are_float64(mat, tmp_path, monkeypatch):
    """Every polish evaluation runs in float64 (parameters, batch and loss),
    every f32-phase evaluation in float32, and the polish never reaches K1's
    wrapper."""
    seen = []
    real = kernels_step.shared_forward_loss_plain

    def spy(params, b, spec, precision="f32"):
        out = real(params, b, spec, precision)
        seen.append((params["w_in"].dtype, b[0].coords.dtype, out[0].dtype))
        return out

    monkeypatch.setattr(kernels_step, "shared_forward_loss_plain", spy)
    k1_calls = []
    monkeypatch.setattr(kernels_step, "fused_loss_and_grad",
                        lambda *a, **k: k1_calls.append(1))
    tr = Trainer(parse_config(newmethod_raw(mat, adam_it=5, lbfgs_it=3,
                                            f64_polish={"max_it": 6, "backend": "cpu"})),
                 run_dir=run_dir(tmp_path, "r"), echo_every=0, device="cpu")
    tr.train()
    n_f32 = tr.stats["loss_evaluations"]
    n_all = len(read_log(tr.run_dir)[0])
    f32, f64 = (torch.float32,) * 3, (torch.float64,) * 3
    assert seen == [f32] * n_f32 + [f64] * (n_all - n_f32)
    assert n_all > n_f32 and not k1_calls
    state = tr._live_lbfgs64_state
    assert state.x.dtype == state.g.dtype == state.s_hist.dtype == torch.float64
    assert tr.polish_device() == torch.device("cpu")


class MidPolishSaver(Trainer):
    """Saves one checkpoint inside the polish (JAX ``tests/test_train.py``)."""

    saved: dict = {}

    def _record(self, losses):
        super()._record(losses)
        if ("path" not in self.saved and self._live_lbfgs64_state is not None
                and self._live_lbfgs64_state.reason == lbfgs_mod.RUNNING):
            self.saved["path"] = self.save("model_midpolish")
            self.saved["iteration"] = self.state.iteration


@pytest.mark.parametrize("backend", ["cpu", "device_eval"])
def test_f64_polish_checkpoint_exact_continuation(mat, tmp_path, backend):
    """JAX ``test_f64_polish_checkpoint_exact_continuation``: a checkpoint
    cut inside the polish carries its whole f64 state (``lbfgs64``);
    resuming replays the uninterrupted run's remaining rows bit for bit,
    with no f32 L-BFGS row, onto identical parameters. On the CPU both
    backends run the polish on the host (``Trainer.polish_device``), so
    both resume exactly (the JAX package's ``device_eval`` does not)."""
    raw = newmethod_raw(mat, adam_it=10, lbfgs_it=5, f64_polish={"max_it": 60,
                                                                  "backend": backend})
    cfg = parse_config(raw)
    MidPolishSaver.saved = {}
    tr_a = MidPolishSaver(cfg, run_dir=run_dir(tmp_path, "full"), echo_every=0,
                          lbfgs_record_capacity=40, device="cpu")
    tr_a.train()
    saved = MidPolishSaver.saved
    assert "path" in saved, "no mid-polish chunk boundary hit; enlarge the budget"
    assert "lbfgs64" in ckpt_mod.load_raw(saved["path"])
    epochs_a, fid_a, _, tot_a = read_log(tr_a.run_dir)

    tr_b = Trainer(cfg, run_dir=run_dir(tmp_path, "resumed"), echo_every=0,
                   lbfgs_record_capacity=40, device="cpu")
    tr_b.restore(saved["path"])
    assert tr_b._pending_lbfgs64_resume is not None
    n_before = saved["iteration"]
    tr_b.train()
    epochs_b, fid_b, _, tot_b = read_log(tr_b.run_dir)
    # only the remaining polish rows: the f32 L-BFGS phase did not restart
    assert epochs_b == epochs_a[n_before:]
    assert tot_b == tot_a[n_before:]
    assert fid_b == fid_a[n_before:]
    for k in tr_a.state.params:
        assert torch.equal(tr_a.state.params[k], tr_b.state.params[k]), k
    assert torch.equal(tr_a._live_lbfgs64_state.x, tr_b._live_lbfgs64_state.x)


def test_f64_polish_with_mesh(mat, tmp_path, monkeypatch):
    """JAX ``test_f64_polish_with_mesh``: the f32 phases run sharded, the
    polish runs single-device in float64 on the unsharded batch, and still
    improves the loss."""
    seen = []
    real = kernels_step.make_step_batches

    def spy(coords, *a, **k):
        seen.append([(c.dtype, c.shape[0]) for c in coords])
        return real(coords, *a, **k)

    monkeypatch.setattr(kernels_step, "make_step_batches", spy)
    raw = newmethod_raw(mat, adam_it=30, lbfgs_it=5, f64_polish={"max_it": 15})
    tr = Trainer(parse_config(raw), run_dir=run_dir(tmp_path, "m"), echo_every=0,
                 mesh=parallel.make_mesh(2, devices=["cpu"] * 2))
    tr.train()
    totals = read_log(tr.run_dir)[3]
    n_f32 = tr.stats["loss_evaluations"]
    assert len(totals) > n_f32
    assert min(totals[n_f32:]) < min(totals[:n_f32])
    n = tr.data.residual_input.shape[0]
    padded = n + (-n) % 2
    # two f32 shards once (the mesh batch), then the f64 batch, unsharded
    assert seen == [[(torch.float32, padded // 2)] * 2, [(torch.float64, n)]]


def test_f64_polish_extension_resumes_from_f64_iterate(mat, tmp_path):
    """JAX ``test_f64_polish_extension_resumes_from_f64_iterate``: every
    checkpoint after the polish carries its f64 iterate (``params64``);
    a later run extending the polish starts from that exact iterate, its
    first evaluation the prior run's terminal f64 loss."""
    cfg = parse_config(newmethod_raw(mat, adam_it=20, lbfgs_it=0, f64_polish={"max_it": 12}))
    tr_a = Trainer(cfg, run_dir=run_dir(tmp_path, "a"), echo_every=0, device="cpu")
    tr_a.train()
    f_final = float(tr_a._live_lbfgs64_state.f)
    ckpt = os.path.join(tr_a.run_dir, "model.npz")
    raw = ckpt_mod.load_raw(ckpt)
    assert "params64" in raw and "lbfgs64" not in raw  # finished: no optimizer state
    assert raw["params64"].dtype == np.float64
    tr_b = Trainer(cfg, run_dir=run_dir(tmp_path, "b"), echo_every=0, device="cpu")
    tr_b.restore(ckpt)
    assert tr_b._pending_params64 is not None
    tr_b.train()
    totals_b = read_log(tr_b.run_dir)[3]
    assert totals_b[0] == float("%.5e" % np.float32(f_final))
    assert min(totals_b) <= totals_b[0]
    # a shadow that no longer matches (changed f32 parameters) is not used
    tr_c = Trainer(cfg, run_dir=run_dir(tmp_path, "c"), echo_every=0, device="cpu")
    tr_c.restore(ckpt)
    with torch.no_grad():
        tr_c.state.params["b_out"] += 1e-3
    tr_c.train()
    assert read_log(tr_c.run_dir)[3][0] != totals_b[0]


def test_port_and_jax_polish_agree_from_the_same_weights(mat, tmp_path):
    """The port's and the JAX package's polish from the same f32 parameters
    (no Adam, no f32 L-BFGS) at ``backend='cpu'``: both float64 runs of the
    same optimizer on the same loss. Measured (this config): 17 rows each,
    every one equal as ``log.txt`` prints it, and the f64 minima 5.1e-13
    apart relative (the two losses sum in different orders); held to the
    printed rows of the first 5 evaluations and the minima within 1e-9
    relative."""
    raw = newmethod_raw(mat, adam_it=0, lbfgs_it=0,
                        f64_polish={"max_it": 15, "backend": "cpu"})
    init = numpy_params((2, 16, 16, 16, 3), seed=7)
    tr = Trainer(parse_config(raw), run_dir=run_dir(tmp_path, "p"), echo_every=0,
                 initial_params=init, device="cpu")
    tr.train()
    jtr = JTrainer(jparse(raw), run_dir=run_dir(tmp_path, "j"), echo_every=0,
                   initial_params=init)
    jtr.train()
    ours, theirs = read_log(tr.run_dir), jread_log(jtr.run_dir)
    assert ours[0] == list(range(1, len(ours[0]) + 1))
    for col in (1, 2, 3):
        assert ours[col][:5] == theirs[col][:5]
    f_ours, f_jax = float(tr._live_lbfgs64_state.f), float(jtr._live_lbfgs64_state.f)
    assert abs(f_ours - f_jax) <= 1e-9 * abs(f_jax)


def test_polish_at_the_flagship_end_point_holds_no_pair_in_either_package(tmp_path,
                                                                          monkeypatch):
    """The flagship's depth and grid (2->[20]x100->3, the 81x261 grid's
    12,516 points) from a converged point: the f32 parameters at which
    ``examples/deep_f64.json``'s f32 phases (2,000 Adam steps and 488 L-BFGS
    evaluations through K1) end on an H100 (``tests/data/
    deep_f64_f32_end.npz``, written by ``tools/polish_witness.py``). The
    port's polish and the JAX package's, both at ``backend='cpu'``, run 9
    float64 evaluations from there, one record chunk per iteration. Neither
    stores a curvature pair: every ``s.y`` (2.4e-12 here) is under the
    absolute ``1e-10`` floor both packages keep from torch, so the polish
    is steepest descent at this point in the reference's optimizer as in
    the port's. Measured: the two runs' chunk ends (iteration, evaluations,
    pairs held) equal, their rows equal as ``log.txt`` prints them, and the
    last losses 1.3e-16 apart relative after these 9 evaluations; held to
    equal chunk ends and rows, and 1e-12 relative."""
    mat = str(tmp_path / "grid.mat")
    synthetic.make_newmethod_mat(mat, nx=81, ny=261, nan_fraction=0.408, seed=21)
    with open(os.path.join(os.path.dirname(__file__), "..", "examples", "deep_f64.json")) as f:
        raw = json.load(f)
    raw["data"]["file"] = raw["data_test"]["file"] = mat
    raw["adam_optimizer"]["max_it"] = 0
    raw["lbfgs_optimizer"].update(max_it=0, max_evaluation=0)
    raw["f64_polish"].update(max_evaluation=9, backend="cpu")
    with np.load(os.path.join(os.path.dirname(__file__), "data", "deep_f64_f32_end.npz")) as z:
        init = {k: z[k] for k in z.files}

    ys_seen, f_start = [], []
    real_step = lbfgs_mod.LBFGSRunner._step

    def step(runner, state):
        if state.n_iter > 0:
            ys_seen.append(float(torch.dot(state.g - state.prev_g, state.d * float(state.t))))
        else:
            f_start.append(float(state.f))
        real_step(runner, state)

    monkeypatch.setattr(lbfgs_mod.LBFGSRunner, "_step", step)

    def chunk_ends(cls):
        class Witness(cls):
            ends: list = []

            def _record(self, losses):
                super()._record(losses)
                st = self._live_lbfgs64_state
                Witness.ends.append((int(st.n_iter), int(st.func_evals), int(st.num)))
        return Witness

    ours_cls, theirs_cls = chunk_ends(Trainer), chunk_ends(JTrainer)
    cap = lbfgs_mod.MAX_LS + 3  # the smallest chunk: about one iteration each
    tr = ours_cls(parse_config(raw), run_dir=run_dir(tmp_path, "p"), echo_every=0,
                  initial_params=init, lbfgs_record_capacity=cap, device="cpu")
    tr.train()
    jtr = theirs_cls(jparse(raw), run_dir=run_dir(tmp_path, "j"), echo_every=0,
                     initial_params=init, lbfgs_record_capacity=cap)
    jtr.train()
    assert ours_cls.ends == theirs_cls.ends and ours_cls.ends[-1][1] == 9
    assert all(num == 0 for _, _, num in ours_cls.ends)
    assert len(ys_seen) == ours_cls.ends[-1][0] - 1 and all(0 < ys < 1e-10 for ys in ys_seen)
    ours, theirs = read_log(tr.run_dir), jread_log(jtr.run_dir)
    assert ours[1:] == theirs[1:]
    f_ours, f_jax = float(tr._live_lbfgs64_state.f), float(jtr._live_lbfgs64_state.f)
    assert abs(f_ours - f_jax) <= 1e-12 * f_jax
    # steepest descent still descends, by a few parts in 1e9 per iteration
    assert f_ours < f_start[0]


# --------------------------------------------------------------------- CLI


@pytest.fixture
def config_file(tmp_path):
    """The JAX CLI test's config (``tests/test_cli.py::config_file``)."""
    mat = str(tmp_path / "data.mat")
    synthetic.make_newmethod_mat(mat, nx=10, ny=8, nan_fraction=0.0, seed=8)
    raw = newmethod_raw(mat, adam_it=5, lbfgs_it=2)
    raw["layers"].update(hidden_layers=2, hidden_width=8)
    raw["lbfgs_optimizer"].update(max_evaluation=5, history_size=5)
    p = tmp_path / "config.json"
    p.write_text(json.dumps(raw))
    return str(p), tmp_path


def test_train_f64_polish_flag(config_file, capsys):
    """JAX ``test_train_f64_polish_flag``: ``--f64-polish N`` appends the
    polish; ``--f64-polish 0`` disables a JSON-configured one."""
    config, tmp_path = config_file
    assert cli.main(["train", "--config", config, "--log-root", str(tmp_path / "log"),
                     "--run-name", "p1", "--f64-polish", "5", "--device", "cpu"]) == 0
    assert "f64 polish" in capsys.readouterr().out
    raw = json.loads(open(config).read())
    raw["f64_polish"] = {"max_it": 5}
    cfg2 = tmp_path / "config2.json"
    cfg2.write_text(json.dumps(raw))
    assert cli.main(["train", "--config", str(cfg2), "--log-root", str(tmp_path / "log"),
                     "--run-name", "p2", "--f64-polish", "0", "--device", "cpu"]) == 0
    assert "f64 polish" not in capsys.readouterr().out
    assert cli.main(["train", "--config", str(cfg2), "--log-root", str(tmp_path / "log"),
                     "--run-name", "p3", "--device", "cpu"]) == 0
    assert "f64 polish" in capsys.readouterr().out


def test_f64_polish_flag_merges_json_fields(config_file, monkeypatch):
    """JAX ``test_f64_polish_flag_merges_json_fields``: ``--f64-polish N``
    re-budgets ``max_it``, keeps the JSON block's other fields and
    re-derives the evaluation budget."""
    config, tmp_path = config_file
    raw = json.loads(open(config).read())
    raw["f64_polish"] = {"max_it": 3, "history_size": 7, "tolerance_grad": 1e-12,
                         "max_evaluation": 4, "backend": "cpu"}
    cfg2 = tmp_path / "config_merge.json"
    cfg2.write_text(json.dumps(raw))
    captured = {}

    class StubTrainer:
        def __init__(self, cfg, **kw):
            captured["cfg"] = cfg
            self.state = types.SimpleNamespace(iteration=0)

        def train(self):
            pass

    monkeypatch.setattr(driver, "Trainer", StubTrainer)
    assert cli.main(["train", "--config", str(cfg2), "--log-root", str(tmp_path / "log"),
                     "--run-name", "merge", "--f64-polish", "40", "--device", "cpu"]) == 0
    p = captured["cfg"].f64_polish
    assert p.max_it == 40
    assert p.max_evaluation == 50      # re-derived from the new max_it
    assert p.history_size == 7         # JSON fields preserved
    assert p.tolerance_grad == 1e-12
    assert p.backend == "cpu"
