"""``correct`` comes out false in the cells ``cmb-adam`` and ``scaled-adam``
when the timed path is broken underneath, as ``test_portbench_control.py``
holds the first cells: each test drives the rest of a run on the CPU (the
port's plain versions in place of its kernels, every step op by op), at the
cells' widths and depth on fewer points, with the cells' own limits.

* the control: the reference one precision lower (TF32 operands) put in
  the program's place;
* a step that leaves the state unchanged, and half of the points and rows
  left out, the means taken over the rest.

A sound run at the same sizes comes out true.
"""

import pytest
import torch

from portbench import run

WAVE = run.load_module(run.BENCH_DIR / "reference" / "wave_averaged.py", "ref_control_cmb")
CONT = run.load_module(run.BENCH_DIR / "reference" / "continuity_only.py", "ref_control_sc")
KEYS = ("w_in", "b_in", "w_hidden", "b_hidden", "w_out", "b_out")
SMALL = {
    "cmb-adam": {"config": {"residual": {"nx": 31, "ny": 33, "masked": 15, "points": 257},
                            "fidelity": {"rows": 20, "training_points": 20}},
                 "workload": {"block_steps": 3}},
    "scaled-adam": {"config": {"cells": {"nx": 20, "ny": 10}, "collocation_points": 200},
                    "workload": {"block_steps": 3, "reference_block": 64}},
}


def cell_run(name, seed=13):
    return run.run_cell(name, seed, 0.05, False, device="cpu", overrides=SMALL[name])


def failing(out) -> set:
    return {k for k, c in out["result"]["checks"].items() if not c["value"] <= c["limit"]}


def cmb_loss(precision, half=False):
    """The CMB value-and-grad of the port's autograd path with the
    reference's loss at ``precision`` in its place (``half``: the first half
    of the points and rows)."""
    cfg = run.load_json(run.BENCH_DIR / "configs" / "cmb.json")

    def value_and_grad(loss_fn):
        def fn(params, batch, dropout_generator=None):
            b = {"fid_coords": batch["fidelity_input"], "fid_trues": batch["fidelity_true"],
                 "res_coords": batch["residual_input"]}
            if half:
                b = {k: v[: v.shape[0] // 2] for k, v in b.items()}
            leaves = {k: params[k].detach().requires_grad_() for k in KEYS}
            with torch.enable_grad():
                fid, res, total = WAVE.loss_terms(leaves, b, cfg["loss"], precision)
                grads = torch.autograd.grad(total, [leaves[k] for k in KEYS])
            return (total.detach(), (fid.detach(), res.detach())), dict(zip(KEYS, grads))
        return fn
    return value_and_grad


@pytest.mark.parametrize("name", ["cmb-adam", "scaled-adam"])
def test_sound_runs_are_correct(name):
    out = cell_run(name)
    assert out["result"]["correct"], out["result"]["checks"]


def test_cmb_control_tf32_in_the_programs_place(monkeypatch):
    from pinn_depthestimation_tpu_torch.training import driver

    monkeypatch.setattr(driver, "value_and_grad", cmb_loss("tf32"))
    out = cell_run("cmb-adam")
    assert not out["result"]["correct"] and failing(out)


def test_cmb_fault_half_the_batch(monkeypatch):
    from pinn_depthestimation_tpu_torch.training import driver

    monkeypatch.setattr(driver, "value_and_grad", cmb_loss("f32", half=True))
    out = cell_run("cmb-adam")
    assert not out["result"]["correct"] and failing(out)


@pytest.mark.parametrize("name", ["cmb-adam", "scaled-adam"])
def test_fault_state_unchanged(monkeypatch, name):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    out = cell_run(name)
    assert not out["result"]["correct"]
    assert out["result"]["checks"]["change_gap"]["value"] == 1.0


def scaled_step(precision, half=False):
    loss = run.load_json(run.BENCH_DIR / "workloads" / "scaled-adam.json")["loss"]

    def step(params, b, spec, *, precision_=None, **kw):
        shard = b[0] if isinstance(b, list) else b
        coords, trues = shard.coords, shard.trues
        if half:
            coords, trues = coords[: coords.shape[0] // 2], trues[: trues.shape[0] // 2]
        leaves = {k: params[k].detach().requires_grad_() for k in KEYS}
        with torch.enable_grad():
            fid, res, total = CONT.loss_terms(leaves, {"coords": coords, "trues": trues}, loss,
                                              precision)
            grads = torch.autograd.grad(total, [leaves[k] for k in KEYS])
        return (total.detach(), (fid.detach(), res.detach())), dict(zip(KEYS, grads))
    return step


@pytest.mark.parametrize("case", ["tf32", "half"])
def test_scaled_control_and_half_batch_in_the_programs_place(monkeypatch, case):
    from pinn_depthestimation_tpu_torch.ops import kernels_step

    fn = scaled_step("tf32") if case == "tf32" else scaled_step("f32", half=True)
    monkeypatch.setattr(kernels_step, "fused_loss_and_grad", fn)
    out = cell_run("scaled-adam")
    assert not out["result"]["correct"] and failing(out)
