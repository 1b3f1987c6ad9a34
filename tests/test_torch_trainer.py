"""The port's training driver, CLI ``train`` and checkpoints
(``pinn_depthestimation_tpu_torch.training``), held against the JAX
package's Trainer on the CPU from identical numpy weights.

Runs on this physics fork chaotically in f32 (CLAUDE.md:73-81), so the two
packages are compared by iteration-1 equality (rel 1e-5), a short tracked
prefix (rel 1e-4 over 5 Adam steps), the log schema and the checkpoint
cadence — never by long trajectories.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pinn_depthestimation_tpu.config import parse_config as jparse
from pinn_depthestimation_tpu.training import Trainer as JTrainer
from pinn_depthestimation_tpu.training import checkpoint as jckpt
from pinn_depthestimation_tpu.training.driver import make_adam_optimizer as jax_adam
from pinn_depthestimation_tpu.utils import synthetic
from pinn_depthestimation_tpu_torch import cli
from pinn_depthestimation_tpu_torch.config import parse_config
from pinn_depthestimation_tpu_torch.inference import Predictor, resolve_use_kernel
from pinn_depthestimation_tpu_torch.models import MLPSpec
from pinn_depthestimation_tpu_torch.ops.cuda_build import K2_WIDTHS
from pinn_depthestimation_tpu_torch.parallel import make_mesh
from pinn_depthestimation_tpu_torch.training import checkpoint as ckpt
from pinn_depthestimation_tpu_torch.training.driver import Trainer, make_adam_optimizer
from pinn_depthestimation_tpu_torch.training.logging_utils import LOG_HEADER, read_log


def newmethod_raw(mat, adam_it=60, lbfgs_it=15, width=16, layers=3, **extra):
    raw = {
        "layers": {"input_features": 2, "hidden_layers": layers, "hidden_width": width,
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


def base_data(mat):
    return newmethod_raw(mat)["data"]


@pytest.fixture
def mat(tmp_path):
    path = str(tmp_path / "data.mat")
    synthetic.make_newmethod_mat(path, nx=16, ny=20, nan_fraction=0.05, seed=2)
    return path


def initial_params(sizes=(2, 16, 16, 16, 3), seed=0):
    rng = np.random.RandomState(seed)
    d_in, W, d_out, n_stack = sizes[0], sizes[1], sizes[-1], len(sizes) - 3
    b = np.sqrt(6.0 / (2 * W))
    return {
        "w_in": rng.uniform(-1, 1, (d_in, W)).astype(np.float32),
        "b_in": np.zeros(W, np.float32),
        "w_hidden": rng.uniform(-b, b, (n_stack, W, W)).astype(np.float32),
        "b_hidden": np.zeros((n_stack, W), np.float32),
        "w_out": rng.uniform(-b, b, (W, d_out)).astype(np.float32),
        "b_out": rng.uniform(-0.2, 0.2, d_out).astype(np.float32),
    }


def run_dir(tmp_path, name):
    path = str(tmp_path / name)
    os.makedirs(path)
    return path


def test_adam_and_steplr_match_optax():
    """torch Adam + StepLR stepped per iteration == optax.adam over the
    staircase exponential decay, across two StepLR boundaries."""
    class Cfg:
        class adam:
            learning_rate, scheduler_step_size, scheduler_gamma = 1e-2, 4, 0.5

    rng = np.random.RandomState(0)
    p0 = rng.randn(5).astype(np.float32)
    grads = rng.randn(11, 5).astype(np.float32)
    p = torch.tensor(p0)
    opt, sched = make_adam_optimizer(Cfg, [p])
    jopt = jax_adam(Cfg)
    jp = jnp.asarray(p0)
    jstate = jopt.init(jp)
    for g in grads:
        p.grad = torch.tensor(g)
        opt.step()
        sched.step()
        updates, jstate = jopt.update(jnp.asarray(g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        # torch divides by the bias corrections in another order than optax:
        # each step's update (~1e-2) agrees to ~1e-5 of its size
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-6, atol=2e-6)
    assert opt.param_groups[0]["lr"] == pytest.approx(1e-2 * 0.5 ** 2)


@pytest.mark.parametrize("fused", ["auto", "on"])
def test_trainer_matches_jax_trainer(mat, tmp_path, fused):
    """From the same weights: equal iteration-1 losses, a tracked 5-step
    Adam prefix and the same log schema. 'auto' on the CPU is the plain
    autograd path; 'on' runs K1's plain version."""
    raw = newmethod_raw(mat, adam_it=5, lbfgs_it=0, fused_kernel=fused)
    init = initial_params()
    port = Trainer(parse_config(raw), run_dir=run_dir(tmp_path, "port"), echo_every=0,
                   initial_params=init, device="cpu")
    assert (port.fused_step_fn is not None) == (fused == "on")
    port.train_adam()
    jraw = dict(raw, fused_kernel="off")
    ref = JTrainer(jparse(jraw), run_dir=run_dir(tmp_path, "jax"), echo_every=0,
                   initial_params={k: jnp.asarray(v) for k, v in init.items()})
    ref.train_adam()
    with open(os.path.join(port.run_dir, "log.txt")) as f, \
            open(os.path.join(ref.run_dir, "log.txt")) as g:
        lines, jlines = f.readlines(), g.readlines()
    assert lines[0] == jlines[0] == LOG_HEADER and len(lines) == len(jlines) == 6
    got = np.array(read_log(port.run_dir)[1:]).T
    want = np.array(read_log(ref.run_dir)[1:]).T
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)  # iteration 1
    np.testing.assert_allclose(got, want, rtol=1e-4)        # the 5-step prefix


def test_checkpoint_cadence_matches_jax():
    for kind in ("newmethod", "cmb"):
        for start, end in ((0, 1000), (9_990, 10_010), (44_000, 47_500), (0, 60_000)):
            assert ckpt.checkpoint_points(start, end, kind) == jckpt.checkpoint_points(start, end, kind)


def test_end_to_end_snapshot_and_model(mat, tmp_path):
    raw = newmethod_raw(mat, adam_it=20, lbfgs_it=5, snapshot_iteration=20)
    tr = Trainer(parse_config(raw), run_dir=run_dir(tmp_path, "run"), echo_every=0, device="cpu")
    tr.train()
    epochs, _, _, totals = read_log(tr.run_dir)
    assert epochs == list(range(1, len(epochs) + 1)) and len(epochs) >= 21
    assert all(np.isfinite(totals)) and totals[19] < totals[0]
    assert min(totals[20:]) <= totals[19]
    from scipy.io import loadmat

    snap = loadmat(os.path.join(tr.run_dir, "data_at20.mat"))
    for key in ("pred_U", "pred_V", "pred_h"):
        assert snap[key].shape == (tr.data.residual_input.shape[0], 1)
    # the final model serves as it is: top-level parameter arrays
    model = os.path.join(tr.run_dir, "model.npz")
    pred = Predictor(parse_config(dict(raw, data_test={"file": mat, "outputs": ["U", "V", "h"]})),
                     model, device="cpu")
    np.testing.assert_allclose(pred.predict(tr.data.residual_input), tr.predict(tr.data.residual_input),
                               rtol=1e-6, atol=1e-7)


def test_resume_is_bit_identical_and_runs_repeat(mat, tmp_path):
    init = initial_params()
    a = Trainer(parse_config(newmethod_raw(mat, adam_it=40, lbfgs_it=0)),
                run_dir=run_dir(tmp_path, "a"), echo_every=0, initial_params=init, device="cpu")
    a.train_adam()
    again = Trainer(parse_config(newmethod_raw(mat, adam_it=40, lbfgs_it=0)),
                    run_dir=run_dir(tmp_path, "again"), echo_every=0, initial_params=init,
                    device="cpu")
    again.train_adam()
    b = Trainer(parse_config(newmethod_raw(mat, adam_it=20, lbfgs_it=0)),
                run_dir=run_dir(tmp_path, "b"), echo_every=0, initial_params=init, device="cpu")
    b.train_adam()
    path = b.save("model_20")
    b2 = Trainer(parse_config(newmethod_raw(mat, adam_it=40, lbfgs_it=0)), run_dir=b.run_dir,
                 echo_every=0, device="cpu")
    b2.restore(path)
    assert b2.state.iteration == 20
    b2.train_adam()
    for k in a.state.params:
        assert torch.equal(a.state.params[k], b2.state.params[k]), k
        assert torch.equal(a.state.params[k], again.state.params[k]), k
    assert read_log(a.run_dir) == read_log(b.run_dir)


def test_lbfgs_phase_resumes_from_its_checkpoint(mat, tmp_path):
    """A checkpoint cut inside the L-BFGS phase carries the optimizer state;
    restoring it continues the phase to the same end point."""
    raw = newmethod_raw(mat, adam_it=0, lbfgs_it=12)
    init = initial_params()
    full = Trainer(parse_config(raw), run_dir=run_dir(tmp_path, "full"), echo_every=0,
                   initial_params=init, device="cpu", lbfgs_record_capacity=28)
    full.train_lbfgs()
    part = Trainer(parse_config(raw), run_dir=run_dir(tmp_path, "part"), echo_every=0,
                   initial_params=init, device="cpu", lbfgs_record_capacity=28)
    runner_state = {}
    original = part._record

    def record_then_stop(losses):
        original(losses)
        if not runner_state:
            runner_state["path"] = part.save("model_mid")
            raise KeyboardInterrupt

    part._record = record_then_stop
    with pytest.raises(KeyboardInterrupt):
        part.train_lbfgs()
    assert "lbfgs" in ckpt.load_raw(runner_state["path"])
    resumed = Trainer(parse_config(raw), run_dir=part.run_dir, echo_every=0, device="cpu",
                      lbfgs_record_capacity=28)
    resumed.restore(runner_state["path"])
    resumed.train_lbfgs()
    assert resumed.state.iteration == full.state.iteration
    for k in full.state.params:
        assert torch.equal(full.state.params[k], resumed.state.params[k]), k


def test_cli_train_on_cpu(mat, tmp_path, capsys):
    import json

    cfg = str(tmp_path / "cfg.json")
    with open(cfg, "w") as f:
        json.dump(newmethod_raw(mat, adam_it=10, lbfgs_it=3, snapshot_iteration=10), f)
    assert cli.main(["train", "--config", cfg, "--log-root", str(tmp_path), "--run-name", "r",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Training time: " in out
    run = tmp_path / "r"
    for name in ("log.txt", "model.npz", "data_at10.mat"):
        assert (run / name).exists(), name
    np.savez(tmp_path / "w.npz", **initial_params())
    assert cli.main(["train", "--config", cfg, "--log-root", str(tmp_path), "--run-name", "r2",
                     "--device", "cpu", "--init-from", str(tmp_path / "w.npz")]) == 0
    assert cli.main(["train", "--config", cfg, "--log-root", str(tmp_path), "--run-name", "r3",
                     "--device", "cpu", "--resume", str(run / "model.npz")]) == 0
    capsys.readouterr()
    # the polish and the mesh are ported: --f64-polish 2 trains, and a mesh
    # of more shards than visible CUDA devices exits 1 with the mesh error
    assert cli.main(["train", "--config", cfg, "--log-root", str(tmp_path), "--run-name", "r4",
                     "--device", "cpu", "--f64-polish", "2"]) == 0
    assert "f64 polish" in capsys.readouterr().out
    if torch.cuda.device_count() < 9:
        assert cli.main(["train", "--config", cfg, "--log-root", str(tmp_path), "--mesh",
                         "9"]) == 1
        assert (f"Error building device mesh: mesh 9x1 needs 9 devices, have "
                f"{torch.cuda.device_count()}") in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["train", "--config", cfg, "--log-root", str(tmp_path)])


def test_trainer_refuses_what_is_not_ported(mat, tmp_path):
    d = run_dir(tmp_path, "x")
    # the f64 polish (M10b) and the mesh (M11) are ported: both build a
    # Trainer (tests/test_torch_f64_polish.py, tests/test_torch_parallel.py)
    tr = Trainer(parse_config(newmethod_raw(mat, f64_polish={"max_it": 5})), run_dir=d,
                 device="cpu")
    assert tr._polish_enabled() and tr.polish_device() == torch.device("cpu")
    # parallel.data is the CLI's to read, as in the JAX package: a Trainer
    # without a mesh trains unsharded, one with a mesh over its shards
    raw = newmethod_raw(mat, parallel={"data": 2})
    assert isinstance(Trainer(parse_config(raw), run_dir=d, device="cpu").batch, dict)
    tr = Trainer(parse_config(raw), run_dir=d, mesh=make_mesh(2, devices=["cpu"] * 2))
    assert len(tr.batch) == 2 and tr.mesh.shape == {"data": 2, "model": 1}
    # the precision schedule is ported: it trains (tests/test_torch_schedule.py)
    tr = Trainer(parse_config(newmethod_raw(mat, precision_schedule=True, fused_kernel="on")),
                 run_dir=d, device="cpu")
    assert tr._prefix_iters == 35_000 and tr._prefix_value_and_grad is not tr.value_and_grad_fn
    # an f32x3 prefix is ported too: its own value-and-grad function
    tr = Trainer(parse_config(newmethod_raw(mat, fused_kernel="on", precision_schedule={
        "prefix_precision": "f32x3", "prefix_iters": 5})), run_dir=d, device="cpu")
    assert tr._prefix_iters == 5 and tr._prefix_value_and_grad is not tr.value_and_grad_fn
    # K3 is ported: 'on' outside the one-kernel gate (an anchored 3-head
    # fidelity) takes the generic fused path, K2 forward + K3 backward
    anchored_three_heads = dict(base_data(mat), trues=["U", "V", "h"], unknowns=[])
    tr = Trainer(parse_config(newmethod_raw(mat, fused_kernel="on", data=anchored_three_heads)),
                 run_dir=d, device="cpu")
    assert tr.kernel_plan == (False, True, False) and tr.fused_step_fn is None


def test_predictor_use_kernel_decision():
    """On CUDA an architecture K2 lacks raises instead of serving quietly
    through the plain path; use_kernel=False asks for the plain path."""
    flagship = MLPSpec(sizes=(2,) + (20,) * 100 + (3,))
    wide = MLPSpec(sizes=(2, 24, 24, 3))
    assert resolve_use_kernel(flagship, "cuda", None) is True
    assert resolve_use_kernel(wide, "cuda", False) is False
    with pytest.raises(ValueError, match="K2_WIDTHS") as err:
        resolve_use_kernel(wide, "cuda", None)
    assert "use_kernel=False" in str(err.value) and str(K2_WIDTHS) in str(err.value)
    with pytest.raises(ValueError, match="use_kernel=False"):
        resolve_use_kernel(wide, "cuda", True)
    assert resolve_use_kernel(wide, "cpu", None) is False
    assert resolve_use_kernel(flagship, "cpu", None) is False


@pytest.mark.parametrize("width,dropout,mode,device_type,want", [
    (20, 0.0, "auto", "cuda", (True, False, True)),
    (20, 0.0, "on", "cuda", (True, False, True)),
    (20, 0.0, "off", "cuda", (False, False, False)),
    (20, 0.0, "auto", "cpu", (False, False, False)),
    (20, 0.0, "on", "cpu", (True, False, False)),
    (20, 0.2, "auto", "cuda", (False, False, True)),   # outside the gate: autograd, K2
    (24, 0.0, "auto", "cuda", "K1_WIDTHS"),
    (24, 0.0, "on", "cuda", "K1_WIDTHS"),
    (24, 0.0, "off", "cuda", (False, False, False)),
    (24, 0.0, "auto", "cpu", (False, False, False)),
    (24, 0.0, "on", "cpu", (True, False, False)),
    (24, 0.2, "auto", "cuda", "K2_WIDTHS"),     # autograd training, but no K2
    (24, 0.2, "on", "cpu", "K3"),
])
def test_trainer_kernel_decision(mat, width, dropout, mode, device_type, want):
    """On the card a width K1 or K2 was not compiled for raises, naming the
    compiled widths and fused_kernel='off', instead of training or
    predicting quietly through the plain path."""
    from pinn_depthestimation_tpu_torch.training.driver import decide_kernels

    raw = newmethod_raw(mat, width=width, fused_kernel=mode)
    raw["layers"]["dropout_rate"] = dropout
    cfg = parse_config(raw)
    spec = MLPSpec.from_layers(cfg.layers)
    if isinstance(want, tuple):
        assert decide_kernels(cfg, spec, True, device_type) == want
        return
    with pytest.raises(ValueError, match=want) as err:
        decide_kernels(cfg, spec, True, device_type)
    if want != "K3":
        assert "fused_kernel='off'" in str(err.value)


def test_dropout_training_is_repeatable(mat, tmp_path):
    """With dropout the Trainer takes the plain path (K1's gate excludes
    it) and draws its masks from generators keyed by the absolute
    iteration, so two runs give the same log."""
    raw = newmethod_raw(mat, adam_it=8, lbfgs_it=0)
    raw["layers"]["dropout_rate"] = 0.2
    logs = []
    for name in ("d1", "d2"):
        tr = Trainer(parse_config(raw), run_dir=run_dir(tmp_path, name), echo_every=0,
                     initial_params=initial_params(), device="cpu")
        assert tr.fused_step_fn is None
        tr.train_adam()
        logs.append(read_log(tr.run_dir))
    assert logs[0] == logs[1] and all(np.isfinite(logs[0][3]))
