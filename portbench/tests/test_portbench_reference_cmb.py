"""The CMB reference (``portbench/reference/wave_averaged.py``) agrees with
the port's CMB pipeline on the CPU, at the CMB net on a small grid: its
inputs with the port's loader's, bit for bit; the loss terms and every
gradient leaf with the port's autograd path (K2's and K3's plain versions);
three Adam steps with a StepLR boundary inside them with the port's
``Trainer``. The test imports both; the reference itself imports nothing of
the port."""

import json
import os

import numpy as np
import pytest
import torch

from portbench import run

REF = run.load_module(run.BENCH_DIR / "reference" / "wave_averaged.py", "ref_wave_averaged")
CMB = run.load_module(run.BENCH_DIR / "drivers" / "adam_cmb.py", "driver_adam_cmb")
# 16 x 17 kept cells, 15 masked: 257 points; 20 rows
SMALL = {"residual": {"nx": 31, "ny": 33, "masked": 15, "points": 257},
         "fidelity": {"rows": 20, "training_points": 20}}


def cmb(**changes) -> dict:
    cfg = json.loads((run.BENCH_DIR / "configs" / "cmb.json").read_text())
    return run.merged(run.merged(cfg, SMALL), changes)


def port_trainer(cfg, seed, tmp_path):
    from pinn_depthestimation_tpu_torch.config import parse_config
    from pinn_depthestimation_tpu_torch.training.driver import Trainer

    rows, grid, csv_path, mat_path = CMB.write_inputs(cfg, seed, str(tmp_path))
    params0 = CMB.init_params(cfg, seed, torch.device("cpu"))
    trainer = Trainer(parse_config(CMB.port_config(cfg, csv_path, mat_path)),
                      run_dir=str(tmp_path), echo_every=0, initial_params=params0, device="cpu")
    return trainer, rows, grid, params0


def test_the_inputs_are_the_ports_loaders(tmp_path):
    cfg = cmb()
    trainer, rows, grid, _ = port_trainer(cfg, 2**40 + 3, tmp_path)
    batch = REF.cmb_batch(rows, grid, cfg, "cpu")
    data = trainer.data
    assert batch["res_coords"].shape == (257, 2) and batch["fid_trues"].shape == (20, 6)
    assert np.array_equal(batch["res_coords"].numpy(), data.residual_input)
    assert np.array_equal(batch["fid_coords"].numpy(), data.fidelity_input)
    assert np.array_equal(batch["fid_trues"].numpy(), data.fidelity_true)
    assert trainer.kernel_plan.fused and trainer.fused_step_fn is None


def test_the_loss_and_every_gradient_leaf_match_the_ports_autograd_path(tmp_path):
    cfg = cmb()
    trainer, rows, grid, params0 = port_trainer(cfg, 17, tmp_path)
    (total, (fid, res)), grads = trainer.value_and_grad_fn(trainer.state.params, trainer.batch)
    ref = REF.adam_steps(params0, REF.cmb_batch(rows, grid, cfg, "cpu"), cfg["loss"],
                         cfg["adam"], 1)
    np.testing.assert_allclose(ref["losses"][0], [float(fid), float(res), float(total)],
                               rtol=2e-6)
    for k in CMB.KEYS:
        torch.testing.assert_close(ref["grad1"][k], grads[k], rtol=1e-4,
                                   atol=1e-6 * float(grads[k].abs().max()))


def test_three_adam_steps_across_a_steplr_boundary_match_the_ports_trainer(tmp_path):
    cfg = cmb(adam={"scheduler_step_size": 2, "scheduler_gamma": 0.5})
    trainer, rows, grid, params0 = port_trainer(cfg, 29, tmp_path)
    port_losses = trainer._adam_steps(3).numpy()
    assert trainer.optimizer.param_groups[0]["lr"] == pytest.approx(0.5e-4)
    ref = REF.adam_steps(params0, REF.cmb_batch(rows, grid, cfg, "cpu"), cfg["loss"],
                         cfg["adam"], 3)
    np.testing.assert_allclose(np.asarray(ref["losses"]), port_losses, rtol=2e-6)
    for k in CMB.KEYS:
        moved = trainer.state.params[k] - params0[k]
        torch.testing.assert_close(ref["change"][k], moved, rtol=1e-4, atol=1e-9)
    # the boundary shows: a run without it moves the parameters further
    flat = REF.adam_steps(params0, REF.cmb_batch(rows, grid, cfg, "cpu"), cfg["loss"],
                          dict(cfg["adam"], scheduler_step_size=10), 3)
    assert float(flat["change"]["w_out"].norm()) > float(ref["change"]["w_out"].norm())


def test_the_weights_keep_eta_plus_h_positive_and_repeat_from_a_seed():
    cfg = cmb()
    for seed in (0, 7, 2**31 + 11, 2**40 + 3):
        a, b = (CMB.init_params(cfg, seed, torch.device("cpu")) for _ in range(2))
        for k in a:
            assert torch.equal(a[k], b[k])
        coords = torch.rand(4096, 2) * 2 - 1
        y = REF.forward(a, coords)
        assert float((y[:, 0] + y[:, 3]).min()) >= 0.5


@pytest.mark.parametrize("seed", [0, 2**40 + 5])
def test_the_inputs_repeat_from_a_seed_and_keep_their_sizes(seed):
    from portbench import gen_cmb

    cfg = json.loads((run.BENCH_DIR / "configs" / "cmb.json").read_text())
    grid, again = gen_cmb.residual_grid(cfg, seed), gen_cmb.residual_grid(cfg, seed)
    rows = gen_cmb.survey_rows(cfg, seed)
    for k in grid:
        np.testing.assert_array_equal(grid[k], again[k])
    batch = REF.cmb_batch(rows, grid, cfg, "cpu")
    assert batch["res_coords"].shape == (cfg["residual"]["points"], 2) == (20_507, 2)
    assert batch["fid_coords"].shape == (200, 2)
    assert float(batch["res_coords"].abs().max()) <= 1.0
    other = gen_cmb.residual_grid(cfg, seed + 1)
    assert not np.array_equal(np.isnan(other["x"]), np.isnan(grid["x"]))


def test_t_over_sinh_keeps_its_gradient_finite_at_zero():
    t = torch.tensor([0.0, 1e-30, 1e-13, 1e-6, 0.3, 0.7, 3.0, -0.2], dtype=torch.float64)
    r, dr = REF.t_over_sinh(t)
    quotient = torch.where(t == 0, torch.ones_like(t), t / torch.sinh(t))
    slope = torch.where(t.abs() < 1e-6, -t / 3,
                        (torch.sinh(t) - t * torch.cosh(t)) / torch.sinh(t) ** 2)
    assert float((r - quotient).abs().max()) < 1e-6
    assert float((dr - slope).abs().max()) < 2e-5
    t32 = torch.tensor([0.0, 1e-30, 1e-13, 0.5], requires_grad=True)
    r, dr = REF.t_over_sinh(t32)
    (r.sum() + dr.sum()).backward()
    assert torch.isfinite(t32.grad).all()
