"""Two things the kernel paths owe the JAX package, on the CPU:

* ``residual_chunk_size`` on the kernel paths: the JAX ``build_loss_fn``
  drops it under ``fused_kernel`` (its backward is O(1) in activations), and
  so does the port's, while the plain path evaluates the residual in chunks
  (``tests/test_torch_chunked_loss.py``). A Trainer passes one decision, K1
  or K2 with K3/K4, into both loss builders, as the JAX Trainer's
  ``use_fused_kernel``.
* the bench suite (``benchmarks.run_bench_suite``, ``bench --suite`` and
  ``--step``): the JAX suite's record, with ``plain`` in place of ``xla``.

Tolerances: loss terms rel 1e-5 and each gradient 2e-5 of its largest entry,
as ``tests/test_torch_loss.py`` holds the two packages' losses.
"""

import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn_depthestimation_tpu.config import parse_config as jparse
from pinn_depthestimation_tpu.models import MLPSpec as JSpec
from pinn_depthestimation_tpu.training import loss as jloss
from pinn_depthestimation_tpu.utils import synthetic
from pinn_depthestimation_tpu_torch import benchmarks, cli, data
from pinn_depthestimation_tpu_torch.config import parse_config
from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy
from pinn_depthestimation_tpu_torch.training import driver, loss
from pinn_depthestimation_tpu_torch.training.driver import Trainer, decide_kernels
from test_torch_loss import assert_same, numpy_params

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
CHUNK = 4096


def example_raw(name: str) -> dict:
    return json.loads((EXAMPLES / name).read_text())


@pytest.fixture
def newmethod(tmp_path):
    """``examples/newmethod.json`` on a small synthetic grid, its stack cut
    to 3 hidden layers (the width, 20, stays), ``residual_chunk_size`` set."""
    mat = str(tmp_path / "grid.mat")
    synthetic.make_newmethod_mat(mat, nx=12, ny=10, nan_fraction=0.15, seed=3)
    raw = example_raw("newmethod.json")
    raw["data"]["file"] = mat
    raw["data_test"]["file"] = mat
    raw["layers"]["hidden_layers"] = 3
    raw["residual_chunk_size"] = CHUNK
    return raw


@pytest.fixture
def cmb(tmp_path):
    """``examples/cmb.json`` on a small synthetic pair, its stack cut to 3
    hidden layers (the width, 10, stays), ``residual_chunk_size`` set."""
    csv, mat = str(tmp_path / "fid.csv"), str(tmp_path / "res.mat")
    synthetic.make_cmb_dataset(csv, mat, nx=21, ny=31, n_csv=60, seed=6, nan_fraction=0.03)
    raw = example_raw("cmb.json")
    raw["data_fidelity"]["file"] = csv
    raw["data_residual"]["file"] = mat
    raw["data_test"]["file"] = mat
    raw["layers"]["hidden_layers"] = 3
    raw["residual_chunk_size"] = CHUNK
    return raw


def _both_losses(raw, fidelity_is_residual):
    cfg, jcfg = parse_config(raw), jparse(raw)
    td = data.load_training_data(cfg)
    assert bool(td.fidelity_is_residual) == fidelity_is_residual
    spec = MLPSpec.from_layers(cfg.layers)
    keys = ("fidelity_input", "fidelity_true", "residual_input")
    batch = {k: torch.from_numpy(getattr(td, k)) for k in keys}
    jbatch = {k: jnp.asarray(getattr(td, k)) for k in keys}
    kw = dict(residual_chunk_size=cfg.residual_chunk_size, input_min_max=td.input_min_max,
              fused_kernel=True, fidelity_is_residual=fidelity_is_residual)
    port = loss.build_loss_fn(cfg, spec, **kw)
    ref = jloss.build_loss_fn(jcfg, JSpec.from_layers(jcfg.layers), fused_interpret=True, **kw)
    arrays = numpy_params(spec.sizes, seed=1)
    if not fidelity_is_residual:
        arrays["b_out"][3] += 1.0  # the CMB eta head shifted, so eta + h stays away from 0
    return (loss.value_and_grad(port)(params_from_numpy(arrays, "cpu"), batch),
            jax.value_and_grad(ref, has_aux=True)({k: jnp.asarray(v) for k, v in arrays.items()},
                                                  jbatch))


def test_newmethod_chunk_size_is_dropped_on_the_kernel_path(newmethod, monkeypatch):
    """The flagship example with residual_chunk_size: both packages build the
    loss under fused_kernel=True, and their values and gradients agree."""
    monkeypatch.setattr(jloss, "FUSED_FIDELITY_MIN_POINTS", 0)
    port, ref = _both_losses(newmethod, fidelity_is_residual=True)
    assert_same(port, ref)


def test_cmb_chunk_size_is_dropped_on_the_kernel_path(cmb, monkeypatch):
    """The CMB example with residual_chunk_size under fused_kernel=True: the
    port's K2 + K3 plain versions against the JAX fused path in interpret
    mode (its fidelity threshold lowered to 0 so that both route the
    fidelity rows through the kernels)."""
    monkeypatch.setattr(jloss, "FUSED_FIDELITY_MIN_POINTS", 0)
    port, ref = _both_losses(cmb, fidelity_is_residual=False)
    assert_same(port, ref)


def test_the_card_plan_builds_and_steps(newmethod, cmb, tmp_path, monkeypatch):
    """What the card's Trainer does, on the CPU: with the plan that
    ``decide_kernels(..., 'cuda')`` returns (K1 on the flagship, K2 + K3 on
    CMB) both loss builders accept residual_chunk_size, and a Trainer on
    that plan takes an Adam step (the kernels' plain versions here)."""
    card_plan = decide_kernels
    monkeypatch.setattr(driver, "decide_kernels",
                        lambda config, spec, fir, device_type: card_plan(config, spec, fir, "cuda"))
    for name, raw, want in (("flagship", newmethod, (True, False, True)),
                            ("cmb", cmb, (False, True, True))):
        cfg = parse_config(raw)
        spec = MLPSpec.from_layers(cfg.layers)
        fir = name == "flagship"
        plan = card_plan(cfg, spec, fir, "cuda")
        assert tuple(plan) == want
        kw = dict(input_min_max=data.load_training_data(cfg).input_min_max,
                  fused_kernel=plan.k1 or plan.fused, fidelity_is_residual=fir)
        loss.build_loss_fn(cfg, spec, residual_chunk_size=CHUNK, **kw)  # no longer raises
        assert (loss.build_value_and_grad_fn(cfg, spec, **kw) is not None) == plan.k1
        run = tmp_path / f"run_{name}"
        run.mkdir()
        tr = Trainer(cfg, run_dir=str(run), echo_every=0, device="cpu")
        assert tr.kernel_plan == plan and tr.uses_kernels
        losses = tr._adam_steps(1).numpy()
        assert losses.shape == (1, 3) and bool((losses > 0).all())


def test_the_plain_path_still_refuses_the_chunk_size(newmethod, cmb, tmp_path):
    """Off the kernels (``fused_kernel`` false, or a Trainer on the CPU with
    'auto') the chunk size is no longer refused: the chunked plain loss
    (M3) is ported. A Trainer there builds with it and its first Adam step
    equals an unchunked Trainer's within rel 1e-6, at the example's 4096
    (more than these points: the unchunked path) and at 17 (chunks)."""
    for raw in (newmethod, cmb):
        cfg = parse_config(raw)
        assert loss.build_loss_fn(cfg, MLPSpec.from_layers(cfg.layers),
                                  residual_chunk_size=CHUNK)
        rows = {}
        for chunk in (None, CHUNK, 17):
            run = tmp_path / f"plain_{cfg.kind}_{chunk}"
            run.mkdir()
            tr = Trainer(parse_config(dict(raw, residual_chunk_size=chunk) if chunk else
                                      {k: v for k, v in raw.items() if k != "residual_chunk_size"}),
                         run_dir=str(run), echo_every=0, device="cpu")
            assert not tr.uses_kernels
            assert tr.config.residual_chunk_size == chunk
            rows[chunk] = tr._adam_steps(2).numpy()
        assert np.isfinite(rows[None]).all()
        for chunk in (CHUNK, 17):
            np.testing.assert_allclose(rows[chunk][0], rows[None][0], rtol=1e-6)


# ------------------------------------------------------------ the bench suite

SUITE_EXTRAS = {"f32x3", "bf16", "plain", "adam_step_ms", "adam_step_ms_f32x3",
                "adam_step_ms_bf16", "cmb_step_ms"}


@pytest.fixture
def small_step_bench(monkeypatch):
    """The step benches at one step, one repetition, and the flagship's at a
    small grid and depth (the suite passes the tier and the device)."""
    monkeypatch.setattr(benchmarks, "run_train_step_bench", functools.partial(
        benchmarks.run_train_step_bench, n_iters=1, reps=1, nx=21, ny=31, hidden_layers=3))
    monkeypatch.setattr(benchmarks, "run_cmb_step_bench", functools.partial(
        benchmarks.run_cmb_step_bench, n_iters=1, reps=1))


def test_bench_suite_record_on_the_cpu(small_step_bench):
    """``run_bench_suite`` at a tiny size on the CPU: the headline and
    exactly the JAX suite's extras, ``plain`` in place of ``xla``."""
    rec = benchmarks.run_bench_suite(n_points=64, reps=1, device="cpu")
    assert rec["metric"] == "residual_evals_per_sec[cpu-plain]" and rec["value"] > 0
    assert set(rec["extras"]) == SUITE_EXTRAS
    assert all(v > 0 for v in rec["extras"].values())


def test_bench_suite_records_a_failed_step_bench(small_step_bench, monkeypatch):
    """A step bench that raises becomes ``<name>_error``, as in the JAX
    suite; the other extras stay."""
    def broken(**kwargs):
        raise RuntimeError("no card")

    monkeypatch.setattr(benchmarks, "run_cmb_step_bench", broken)
    rec = benchmarks.run_bench_suite(n_points=32, reps=1, device="cpu")
    assert set(rec["extras"]) == SUITE_EXTRAS - {"cmb_step_ms"} | {"cmb_step_ms_error"}
    assert rec["extras"]["cmb_step_ms_error"] == "RuntimeError: no card"


def test_cli_bench_suite_and_step(monkeypatch, capsys):
    """``bench --suite`` and ``bench --step`` print one JSON line each."""
    seen = {}

    def suite(**kwargs):
        seen["suite"] = kwargs
        return {"metric": "m", "value": 1.0, "extras": {"plain": 2.0}}

    def step(**kwargs):
        seen["step"] = kwargs
        return {"ms_per_iter": 1.5, "device": "cpu"}

    monkeypatch.setattr(benchmarks, "run_bench_suite", suite)
    monkeypatch.setattr(benchmarks, "run_train_step_bench", step)
    assert cli.main(["bench", "--suite", "--points", "128", "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out.strip())["extras"] == {"plain": 2.0}
    assert seen["suite"] == {"n_points": 128, "device": "cpu"}
    assert cli.main(["bench", "--step", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip())
    assert line["metric"] == "flagship_adam_step_ms" and line["value"] == 1.5
    with pytest.raises(SystemExit):
        cli.main(["bench", "--suite", "--step"])
