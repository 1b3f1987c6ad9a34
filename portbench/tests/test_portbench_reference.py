"""The plain reference agrees with the port's plain path on the CPU, at a
small net and point count: the per-point residual against
``ops/kernels.py::residual_continuity_plain``, and three Adam steps
against the port's ``Trainer`` (K1's plain version, ``fused_kernel='on'``).
The test imports both; the reference itself imports nothing of the port."""

import json
import os

import numpy as np
import torch

from portbench import gen, run

REF = run.load_module(run.BENCH_DIR / "reference" / "continuity_only.py", "ref_continuity")
ADAM = run.load_module(run.BENCH_DIR / "drivers" / "adam.py", "driver_adam")
SMALL = {"input_features": 2, "hidden_layers": 5, "hidden_width": 8, "output_features": 3,
         "init_type": "xavier"}


def flagship(**changes) -> dict:
    cfg = json.loads((run.BENCH_DIR / "configs" / "flagship.json").read_text())
    return run.merged(cfg, changes)


def test_residual_matches_the_ports_plain_version():
    from pinn_depthestimation_tpu_torch.models import MLPSpec
    from pinn_depthestimation_tpu_torch.ops import kernels

    params = gen.init_params(SMALL, 3, torch.device("cpu"))
    cells = {"nx": 25, "ny": 20, "x_min": 25.0, "x_max": 33.0, "y_min": -13.0, "y_max": 13.0}
    coords = torch.as_tensor(gen.collocation_points(cells, 3, 1)[0])
    spec = MLPSpec(sizes=(2,) + (8,) * 5 + (3,), init_type="xavier")
    port = kernels.residual_continuity_plain(params, coords, spec)
    ref = REF.residual(params, coords, block=128)
    torch.testing.assert_close(ref, port, rtol=1e-5, atol=1e-6 * float(port.abs().max()))


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -1.0 - 2**-12, 3.0])
    y = REF.round_tf32(x)
    assert y.tolist() == [1.0 + 2**-10, 1.0, 1.0 + 2 * 2**-10, -1.0, 3.0]


def test_three_adam_steps_match_the_ports_trainer(tmp_path):
    from scipy.io import savemat

    from pinn_depthestimation_tpu_torch.config import parse_config
    from pinn_depthestimation_tpu_torch.training.driver import Trainer

    cfg = flagship(layers=SMALL, grid={"nx": 21, "ny": 31})
    columns = gen.survey_columns(cfg["grid"], 5)
    mat = os.path.join(tmp_path, "survey.mat")
    savemat(mat, {k: v.reshape(-1, 1) for k, v in columns.items()})
    params0 = gen.init_params(cfg["layers"], 5, torch.device("cpu"))
    trainer = Trainer(parse_config(ADAM.port_config(cfg, mat)), run_dir=str(tmp_path),
                      initial_params=params0, device="cpu")
    assert trainer.fused_step_fn is not None  # K1's plain version
    port_losses = trainer._adam_steps(3).numpy()
    ref = REF.adam_steps(params0, REF.survey_batch(columns, cfg["grid"], "cpu"), cfg["loss"],
                         cfg["adam"], 3)
    np.testing.assert_allclose(np.asarray(ref["losses"]), port_losses, rtol=2e-6)
    for k in ADAM.KEYS:
        moved = trainer.state.params[k] - params0[k]
        torch.testing.assert_close(ref["change"][k], moved, rtol=1e-4, atol=1e-9)
        exp_avg = trainer.optimizer.state[trainer.state.params[k]]["exp_avg"]
        assert exp_avg.shape == ref["grad1"][k].shape


def test_the_first_gradient_matches_k1s_plain_version():
    from pinn_depthestimation_tpu_torch.models import MLPSpec
    from pinn_depthestimation_tpu_torch.ops import kernels_step

    cfg = flagship(layers=SMALL, grid={"nx": 21, "ny": 31})
    columns = gen.survey_columns(cfg["grid"], 8)
    params0 = gen.init_params(cfg["layers"], 8, torch.device("cpu"))
    batch = REF.survey_batch(columns, cfg["grid"], "cpu")
    n = batch["coords"].shape[0]
    ones = torch.ones(n)
    step = kernels_step.make_step_batch(batch["coords"], batch["trues"], ones, ones, [1.0, 1.0],
                                        2, 1.0, 1.0)
    spec = MLPSpec(sizes=(2,) + (8,) * 5 + (3,), init_type="xavier")
    (total, _), grads = kernels_step.fused_loss_and_grad_plain(params0, step, spec)
    ref = REF.adam_steps(params0, batch, cfg["loss"], cfg["adam"], 1)
    assert abs(ref["losses"][0][2] - float(total)) <= 1e-6 * float(total)
    for k in ADAM.KEYS:
        torch.testing.assert_close(ref["grad1"][k], grads[k], rtol=1e-4,
                                   atol=1e-6 * float(grads[k].abs().max()))
