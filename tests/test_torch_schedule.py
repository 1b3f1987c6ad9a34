"""The staged-precision schedule of the port's Trainer (``precision_schedule``,
``train --precision-schedule``), on the CPU under ``fused_kernel='on'``,
where the kernels' plain versions run at their tiers: the chunk calls split
exactly at ``prefix_iters``, the prefix evaluates at bf16 bit for bit as a
bf16-only Trainer does, a resume from inside the prefix lands in bf16, the
schedule is inert (a warning, an identical log) where no kernel path runs,
and the CLI flag parses as the JAX package's does
(``tests/test_cli.py:322-371``). Equalities here are exact: the same plain
functions run on the same numbers.
"""

import json

import numpy as np
import pytest

from pinn_depthestimation_tpu.utils import synthetic
from pinn_depthestimation_tpu_torch import cli
from pinn_depthestimation_tpu_torch.config import parse_config
from pinn_depthestimation_tpu_torch.parity import make_cmb_config
from pinn_depthestimation_tpu_torch.training import driver
from pinn_depthestimation_tpu_torch.training.driver import Trainer
from pinn_depthestimation_tpu_torch.training.logging_utils import read_log
from test_torch_trainer import initial_params, newmethod_raw, run_dir


@pytest.fixture
def mat(tmp_path):
    path = str(tmp_path / "data.mat")
    synthetic.make_newmethod_mat(path, nx=16, ny=20, nan_fraction=0.05, seed=2)
    return path


def scheduled(mat, prefix, adam_it=24, lbfgs_it=0, tier="bf16", **extra):
    return parse_config(newmethod_raw(
        mat, adam_it=adam_it, lbfgs_it=lbfgs_it, fused_kernel=extra.pop("fused_kernel", "on"),
        precision_schedule={"prefix_precision": tier, "prefix_iters": prefix}, **extra))


def spy_chunks(monkeypatch, trainer):
    """Record (length, tier) of every Adam chunk the Trainer runs."""
    calls = []
    real = trainer._adam_steps

    def adam_steps(n, fn=None):
        prefix = fn is not None and fn is trainer._prefix_value_and_grad \
            and fn is not trainer.value_and_grad_fn
        calls.append((n, "prefix" if prefix else "main"))
        return real(n, fn)

    monkeypatch.setattr(trainer, "_adam_steps", adam_steps)
    return calls


@pytest.mark.parametrize("chunk,prefix,want", [
    (1000, 10, [(10, "prefix"), (14, "main")]),
    (4, 10, [(4, "prefix"), (4, "prefix"), (2, "prefix"), (4, "main"), (4, "main"),
             (4, "main"), (2, "main")]),
    (1000, 30, [(24, "prefix")]),   # the prefix outlasts Adam: all of it at bf16
])
def test_chunks_split_exactly_at_the_prefix(mat, tmp_path, monkeypatch, chunk, prefix, want):
    monkeypatch.setattr(driver, "_CHUNK", chunk)
    tr = Trainer(scheduled(mat, prefix), run_dir=run_dir(tmp_path, "r"), echo_every=0,
                 initial_params=initial_params(), device="cpu")
    assert tr.kernel_plan.k1 and tr._prefix_iters == prefix
    calls = spy_chunks(monkeypatch, tr)
    tr.train_adam()
    assert calls == want
    assert tr.state.iteration == 24


def test_prefix_equals_a_bf16_trainer_then_f32(mat, tmp_path):
    """The first 10 logged rows equal a bf16-only Trainer's bit for bit; the
    rest equal neither the bf16-only run nor (from the same weights) an
    f32-only run, which differs from row 1."""
    init = initial_params()
    logs = {}
    for name, cfg in (
        ("sched", scheduled(mat, 10, lbfgs_it=3)),
        ("bf16", parse_config(newmethod_raw(mat, adam_it=24, lbfgs_it=3, fused_kernel="on",
                                            kernel_precision="bf16"))),
        ("f32", parse_config(newmethod_raw(mat, adam_it=24, lbfgs_it=3, fused_kernel="on"))),
    ):
        tr = Trainer(cfg, run_dir=run_dir(tmp_path, name), echo_every=0,
                     initial_params=init, device="cpu")
        tr.train()
        logs[name] = np.asarray(read_log(tr.run_dir)[3])
    s, b, f = logs["sched"], logs["bf16"], logs["f32"]
    assert np.array_equal(s[:10], b[:10])
    assert not np.array_equal(s[10:24], b[10:24])
    assert s[0] != f[0]
    assert np.all(np.isfinite(s)) and len(s) > 24  # L-BFGS ran after Adam


def test_cmb_prefix_runs_the_bf16_fused_path(tmp_path):
    """On the generic fused path (CMB: K2 forward, K4 backward at bf16) the
    prefix rows equal a bf16-only Trainer's bit for bit."""
    csv, mat = str(tmp_path / "fid.csv"), str(tmp_path / "res.mat")
    synthetic.make_cmb_dataset(csv, mat, nx=21, ny=31, n_csv=60, seed=6, nan_fraction=0.03)
    base = make_cmb_config(csv, mat, 8, 0, hidden_layers=3, hidden_width=10, nx=21, ny=31,
                           interval=2, training_points=40)
    init = initial_params((2, 10, 10, 10, 6))
    init["b_out"][3] += 1.0
    logs = {}
    for name, extra in (("sched", {"precision_schedule": {"prefix_iters": 5}}),
                        ("bf16", {"kernel_precision": "bf16"})):
        raw = dict(base, fused_kernel="on", **extra)
        tr = Trainer(parse_config(raw), run_dir=run_dir(tmp_path, name), echo_every=0,
                     initial_params=init, device="cpu")
        assert tr.kernel_plan.fused and not tr.kernel_plan.k1
        tr.train_adam()
        logs[name] = np.asarray(read_log(tr.run_dir)[3])
    assert np.array_equal(logs["sched"][:5], logs["bf16"][:5])
    assert not np.array_equal(logs["sched"][5:], logs["bf16"][5:])


def test_resume_inside_the_prefix_lands_in_bf16(mat, tmp_path, monkeypatch):
    """A run stopped at iteration 6 of a 10-step prefix and resumed from its
    checkpoint runs 4 more bf16 steps, then f32, and logs what an
    uninterrupted run logs."""
    init = initial_params()
    whole = Trainer(scheduled(mat, 10), run_dir=run_dir(tmp_path, "whole"), echo_every=0,
                    initial_params=init, device="cpu")
    whole.train_adam()
    first = Trainer(scheduled(mat, 10, adam_it=6), run_dir=run_dir(tmp_path, "first"),
                    echo_every=0, initial_params=init, device="cpu")
    first.train()
    resumed = Trainer(scheduled(mat, 10), run_dir=run_dir(tmp_path, "resumed"), echo_every=0,
                      device="cpu")
    resumed.restore(f"{first.run_dir}/model.npz")
    assert resumed.state.iteration == 6
    calls = spy_chunks(monkeypatch, resumed)
    resumed.train_adam()
    assert calls == [(4, "prefix"), (14, "main")]
    epochs, _, _, totals = read_log(resumed.run_dir)
    assert epochs == list(range(7, 25))
    assert np.array_equal(np.asarray(totals), np.asarray(read_log(whole.run_dir)[3][6:]))


@pytest.mark.parametrize("fused_kernel", ["off", "auto"])
def test_schedule_is_inert_without_a_kernel_path(mat, tmp_path, capsys, fused_kernel):
    """'off' and 'auto' on the CPU run plain autograd: the schedule warns,
    reuses the main function, and the log equals a run without it."""
    init = initial_params()
    tr = Trainer(scheduled(mat, 10, fused_kernel=fused_kernel),
                 run_dir=run_dir(tmp_path, "s"), echo_every=0, initial_params=init,
                 device="cpu")
    assert "precision_schedule is inert" in capsys.readouterr().out
    assert tr._prefix_value_and_grad is tr.value_and_grad_fn
    tr.train_adam()
    plain = Trainer(parse_config(newmethod_raw(mat, adam_it=24, fused_kernel=fused_kernel)),
                    run_dir=run_dir(tmp_path, "p"), echo_every=0, initial_params=init,
                    device="cpu")
    plain.train_adam()
    assert np.array_equal(read_log(tr.run_dir)[3], read_log(plain.run_dir)[3])
    # a prefix at the main tier is the main function, and says nothing
    tr = Trainer(scheduled(mat, 10, tier="f32"), run_dir=run_dir(tmp_path, "same"),
                 echo_every=0, initial_params=init, device="cpu")
    assert tr._prefix_value_and_grad is tr.value_and_grad_fn
    assert "inert" not in capsys.readouterr().out


def test_cli_precision_schedule_flag(mat, tmp_path, monkeypatch):
    """--precision-schedule PREFIX_ITERS[:TIER] merges onto or overrides the
    JSON block; 0 disables; a negative value and a bad tier exit 1 — the
    JAX CLI's rules."""
    seen = {}

    class SpyTrainer:
        def __init__(self, cfg, **kw):
            seen["sched"] = cfg.precision_schedule
            self.state = type("S", (), {"iteration": 0})()

        def train(self):
            pass

    monkeypatch.setattr(driver, "Trainer", SpyTrainer)
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(newmethod_raw(mat)))

    def run(name, flag, config=cfg):
        return cli.main(["train", "--config", str(config), "--log-root", str(tmp_path),
                         "--run-name", name, "--device", "cpu", f"--precision-schedule={flag}"])

    assert run("s1", "7:f32x3") == 0
    assert (seen["sched"].prefix_iters, seen["sched"].prefix_precision) == (7, "f32x3")
    assert run("s2", "9") == 0
    assert (seen["sched"].prefix_iters, seen["sched"].prefix_precision) == (9, "bf16")
    raw = newmethod_raw(mat, precision_schedule={"prefix_precision": "bf16", "prefix_iters": 5})
    cfg2 = tmp_path / "config_sched.json"
    cfg2.write_text(json.dumps(raw))
    assert run("s3", "0", cfg2) == 0
    assert seen["sched"] is None
    assert run("s4", "11", cfg2) == 0  # the JSON tier stays when only the count changes
    assert (seen["sched"].prefix_iters, seen["sched"].prefix_precision) == (11, "bf16")
    seen.clear()
    for bad in ("many:bf16", "-3", "-3:bf16", "5:fp8"):
        assert run(f"bad{len(bad)}", bad) == 1
    assert not seen  # no Trainer was built


def test_cli_trains_under_the_schedule(mat, tmp_path, capsys):
    """CLI train with the flag on the CPU: the Trainer reports the prefix and
    logs every evaluation; an f32x3 prefix trains too."""
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(newmethod_raw(mat, adam_it=12, lbfgs_it=2, fused_kernel="on")))
    args = ["train", "--config", str(cfg), "--log-root", str(tmp_path), "--device", "cpu"]
    assert cli.main(args + ["--run-name", "ok", "--precision-schedule", "5:bf16"]) == 0
    out = capsys.readouterr().out
    assert "the first 5 Adam steps at bf16, then f32" in out
    epochs, _, _, totals = read_log(str(tmp_path / "ok"))
    assert epochs[:12] == list(range(1, 13)) and np.all(np.isfinite(totals))
    assert cli.main(args + ["--run-name", "x3", "--precision-schedule", "5:f32x3"]) == 0
    assert "the first 5 Adam steps at f32x3, then f32" in capsys.readouterr().out
    epochs, _, _, totals = read_log(str(tmp_path / "x3"))
    assert epochs[:12] == list(range(1, 13)) and np.all(np.isfinite(totals))
