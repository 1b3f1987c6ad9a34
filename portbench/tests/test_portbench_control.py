"""``correct`` comes out false when the timed path is broken underneath.

Each test drives the rest of a run on the CPU (the harness's look for a
card skipped, the port's plain versions in place of its kernels), at the
cells' widths and depth on fewer points, with the cells' own limits:

* the control: the reference one precision lower (TF32 operands) put in
  the program's place, in each cell;
* the faults each cell can have: a step that leaves the state unchanged and
  half of the batch left out, the mean taken over the rest (Adam); one
  answer altered where it is produced and half of the answers left out
  (residual). One card holds each cell, so no exchange between chips can
  be left out.

A sound run at the same sizes comes out true.
"""

import pytest
import torch

from portbench import run

REF = run.load_module(run.BENCH_DIR / "reference" / "continuity_only.py", "ref_control")
KEYS = ("w_in", "b_in", "w_hidden", "b_hidden", "w_out", "b_out")
ADAM_SMALL = {"config": {"grid": {"nx": 21, "ny": 31}},
              "workload": {"block_steps": 3}}
RESIDUAL_SMALL = {"config": {"cells": {"nx": 40, "ny": 25}, "collocation_points": 1000}}


def adam_run(seed=11):
    return run.run_cell("flagship-adam", seed, 0.1, False, device="cpu", overrides=ADAM_SMALL)


def residual_run(seed=12):
    return run.run_cell("scaled-residual", seed, 0.1, False, device="cpu",
                        overrides=RESIDUAL_SMALL)


def failing(out) -> set:
    return {k for k, c in out["result"]["checks"].items() if not c["value"] <= c["limit"]}


def test_sound_runs_are_correct():
    assert adam_run()["result"]["correct"]
    assert residual_run()["result"]["correct"]


def test_adam_control_tf32_in_the_programs_place(monkeypatch):
    from pinn_depthestimation_tpu_torch.ops import kernels_step

    loss = run.load_json(run.BENCH_DIR / "configs" / "flagship.json")["loss"]

    def tf32_step(params, b, spec, *, precision="f32"):
        shard = b[0] if isinstance(b, list) else b
        leaves = {k: params[k].detach().requires_grad_() for k in KEYS}
        with torch.enable_grad():
            fid, res, total = REF.loss_terms(leaves, {"coords": shard.coords,
                                                      "trues": shard.trues}, loss, "tf32")
            grads = torch.autograd.grad(total, [leaves[k] for k in KEYS])
        return (total.detach(), (fid.detach(), res.detach())), dict(zip(KEYS, grads))

    monkeypatch.setattr(kernels_step, "fused_loss_and_grad", tf32_step)
    out = adam_run()
    assert not out["result"]["correct"] and failing(out)


def test_adam_fault_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    out = adam_run()
    assert not out["result"]["correct"]
    assert out["result"]["checks"]["change_gap"]["value"] == 1.0


def test_adam_fault_half_the_batch(monkeypatch):
    from pinn_depthestimation_tpu_torch.ops import kernels_step

    original = kernels_step.fused_loss_and_grad

    def half(params, b, spec, *, precision="f32"):
        s = b[0] if isinstance(b, list) else b
        h = s.coords.shape[0] // 2
        rest = kernels_step.make_step_batch(s.coords[:h], s.trues[:h], s.sel[:h], s.mask[:h],
                                            s.fid_weights, s.n_true, s.w_fid, s.w_res,
                                            s.anchor_depth, s.has_anchor)
        return original(params, rest, spec, precision=precision)

    monkeypatch.setattr(kernels_step, "fused_loss_and_grad", half)
    out = adam_run()
    assert not out["result"]["correct"] and failing(out)


def test_residual_control_tf32_in_the_programs_place(monkeypatch):
    from pinn_depthestimation_tpu_torch.ops import kernels

    monkeypatch.setattr(kernels, "fused_residual_continuity",
                        lambda params, coords, spec, *, precision="f32":
                        REF.residual(params, coords, "tf32"))
    out = residual_run()
    assert not out["result"]["correct"] and failing(out) == {"residual_gap"}


@pytest.mark.parametrize("fault", ["one_answer_altered", "half_left_out"])
def test_residual_faults(monkeypatch, fault):
    from pinn_depthestimation_tpu_torch.ops import kernels

    original = kernels.fused_residual_continuity

    def broken(params, coords, spec, *, precision="f32"):
        fc = original(params, coords, spec, precision=precision).clone()
        if fault == "one_answer_altered":
            fc[fc.shape[0] // 3] += 0.01 * float(fc.abs().max())
        else:
            fc[fc.shape[0] // 2:] = 0.0
        return fc

    monkeypatch.setattr(kernels, "fused_residual_continuity", broken)
    out = residual_run()
    assert not out["result"]["correct"] and failing(out) == {"residual_gap"}


@pytest.mark.cuda
def test_control_on_the_card_at_the_cells_size(card):
    """On a card: the calibration's readings at each cell's own size on
    three seeds; the program within every limit, the control outside one."""
    calibrate = run.load_module(run.BENCH_DIR / "calibrate.py", "portbench_calibrate")
    for cell in ("flagship-adam", "scaled-residual"):
        for row in calibrate.collect(cell, [21, 22, 23], 0.5):
            limits = row["limits"]
            assert all(row["program"][k] <= limits[k] for k in limits)
            assert any(row["control"][k] > limits[k] for k in limits)
