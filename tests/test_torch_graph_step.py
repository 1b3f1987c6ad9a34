"""The Adam step replayed from one CUDA graph, held on the CPU where it can
be: the capturable Adam's step table, its host side and its launch, the
launch counts noted at a capture and counted at each replay, the event
counters, and the Trainer's decision to graph its step or not.

The graph itself runs only on the card (``tests/test_torch_cuda.py`` holds
the graphed CMB and legacy steps to the uncaptured ones bit for bit).
"""

import os

import numpy as np
import pytest
import torch

from pinn_depthestimation_tpu_torch import tracing
from pinn_depthestimation_tpu_torch.config import parse_config
from pinn_depthestimation_tpu_torch.models import MLPSpec
from pinn_depthestimation_tpu_torch.ops import kernels, kernels_vjp
from pinn_depthestimation_tpu_torch.optim import adam
from pinn_depthestimation_tpu_torch.parity import make_cmb_config
from pinn_depthestimation_tpu_torch.training.driver import Trainer
from pinn_depthestimation_tpu_torch.utils import synthetic


@pytest.fixture(autouse=True)
def fresh():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


# ------------------------------------------------------------- the table

def torch_adam_scalars(steps: int, lr: float, step_size: int, gamma: float):
    """What ``torch.optim.Adam`` (non-capturable) under ``StepLR`` works
    out for each of ``steps`` steps, read off a real pair: the learning rate
    in the group when ``step()`` runs and the step count it raises to, then
    its scalars in double as torch's ``_single_tensor_adam`` computes them."""
    p = torch.zeros(1, requires_grad=True)
    opt = torch.optim.Adam([p], lr=lr)
    sched = torch.optim.lr_scheduler.StepLR(opt, step_size=step_size, gamma=gamma)
    beta1, beta2 = opt.param_groups[0]["betas"]
    out = []
    p.grad = torch.ones(1)
    for _ in range(steps):
        lr_now = opt.param_groups[0]["lr"]
        opt.step()
        step = float(opt.state[p]["step"])
        bias_correction1 = 1 - beta1 ** step
        bias_correction2 = 1 - beta2 ** step
        out.append(((lr_now / bias_correction1) * -1, bias_correction2 ** 0.5))
        sched.step()
    return out, opt, sched


@pytest.mark.filterwarnings("ignore:Detected call of `lr_scheduler.step()`")
def test_the_table_is_torch_adams_and_steplrs_scalars_over_30000_steps():
    """The capturable form's rows against torch's own Adam + StepLR (every
    1,000 steps, so 29 boundaries), in double and then rounded to float as
    the kernel reads them; the scheduler and step count it leaves."""
    want, opt, sched = torch_adam_scalars(30_000, 1e-3, 1_000, 0.8)
    p = torch.zeros(1, requires_grad=True)
    ours = torch.optim.Adam([p], lr=1e-3)
    ours_sched = torch.optim.lr_scheduler.StepLR(ours, step_size=1_000, gamma=0.8)
    beta1, beta2 = ours.param_groups[0]["betas"]
    rows, step = adam.table_rows(1e-3, beta1, beta2, 0.0, 30_000, ours_sched)
    assert rows == want  # double, bit for bit
    assert np.array_equal(np.asarray(rows, np.float32), np.asarray(want, np.float32))
    assert step == float(opt.state[opt.param_groups[0]["params"][0]]["step"]) == 30_000.0
    assert ours.param_groups[0]["lr"] == opt.param_groups[0]["lr"]
    assert ours_sched.last_epoch == sched.last_epoch


def test_schedule_fills_the_table_steps_the_scheduler_and_raises_the_counts():
    """Two blocks of ``schedule`` (7 and 5 steps) across a StepLR boundary
    leave the step counts, the scheduler and the learning rate where 12
    uncaptured steps leave them; each block's rows are the table's."""
    params = [torch.zeros(3, requires_grad=True), torch.zeros(2, 2, requires_grad=True)]
    twin = [p.detach().clone().requires_grad_() for p in params]
    opt, ref = adam.FusedAdam(params, lr=1e-2), torch.optim.Adam(twin, lr=1e-2)
    sched = torch.optim.lr_scheduler.StepLR(opt, step_size=4, gamma=0.5)
    ref_sched = torch.optim.lr_scheduler.StepLR(ref, step_size=4, gamma=0.5)
    for p in params + twin:
        p.grad = torch.ones_like(p)
    opt.step()
    sched.step()
    ref.step()
    ref_sched.step()
    with pytest.raises(ValueError):
        opt.schedule(3, sched)  # no table yet
    table = opt.attach_table(8)
    assert table.scalars.shape == (8, 2) and table.counter.dtype == torch.int64
    with pytest.raises(ValueError):
        opt.schedule(9, sched)
    for n in (7, 4):
        table.counter.fill_(5)
        lr, step = opt.param_groups[0]["lr"], float(opt.state[params[0]]["step"])
        opt.schedule(n, sched)
        twin_rows, _ = adam.table_rows(lr, 0.9, 0.999, step, n)
        assert int(table.counter) == 0
        for _ in range(n):
            ref.step()
            ref_sched.step()
        assert len(twin_rows) == n
    for p, q in zip(params, twin):
        assert float(opt.state[p]["step"]) == float(ref.state[q]["step"]) == 12.0
        assert opt.state[p]["step"].dtype == torch.float32
    assert opt.param_groups[0]["lr"] == ref.param_groups[0]["lr"] == 1e-2 * 0.5**3
    assert sched.last_epoch == ref_sched.last_epoch == 12
    want = [(r[0], r[1]) for r in adam.table_rows(1e-2 * 0.5**2, 0.9, 0.999, 8.0, 4)[0]]
    assert np.array_equal(table.scalars[:4].numpy(), np.asarray(want, np.float32))


def test_schedule_refuses_leaves_at_different_step_counts():
    params = [torch.zeros(3, requires_grad=True), torch.zeros(2, requires_grad=True)]
    opt = adam.FusedAdam(params, lr=1e-2)
    params[0].grad = torch.ones(3)
    opt.step()
    params[1].grad = torch.ones(2)
    opt.step()
    opt.attach_table(4)
    with pytest.raises(ValueError, match="one step count"):
        opt.schedule(2)


class FakeLibrary:
    """``cuda_build.adam_library()``, recording both entries' launches."""

    def __init__(self):
        self.calls = []

    def adam_leaves_bytes(self):
        return adam.ctypes.sizeof(adam.AdamLeaves)

    def adam_max_leaves(self):
        return adam.MAX_LEAVES

    def adam_step(self, leaves, grads, steps, lr, beta1, beta2, eps, device, stream):
        self.calls.append(("step", lr))
        return 0

    def adam_step_table(self, leaves, grads, table, counter, beta1, beta2, eps, device, stream):
        self.calls.append(("table", table, counter))
        return 0

    def adam_error_string(self, err):
        return b"fake error"


@pytest.fixture
def fake_card(monkeypatch):
    from pinn_depthestimation_tpu_torch.ops import cuda_build

    lib = FakeLibrary()
    monkeypatch.setattr(cuda_build, "adam_library", lambda: lib)
    monkeypatch.setattr(adam, "fused_applicable", lambda groups: True)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 0, raising=False)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    adam.reset_launches(adam.fused_adam_update)
    return lib


def test_under_a_capture_the_step_launches_the_table_form(fake_card, monkeypatch):
    """Under a capture with a table: the capturable entry with the table's
    and the counter's device pointers, no host step count touched, the
    counter advanced on the device, the launch noted and counted only by
    the replays; without a table it raises."""
    p = torch.zeros(4, 6, requires_grad=True)
    p.grad = torch.ones_like(p)
    opt = adam.FusedAdam([p], lr=1e-3)
    opt.step()  # uncaptured: builds the state, one host-side launch
    assert fake_card.calls == [("step", 1e-3)]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="step table"):
        opt.step()
    table = opt.attach_table(16)
    step = opt.state[p]["step"].clone()
    with tracing.capturing_launches() as noted:
        opt.step()
    assert fake_card.calls[-1] == ("table", table.scalars.data_ptr(), table.counter.data_ptr())
    assert torch.equal(opt.state[p]["step"], step) and int(table.counter) == 1
    assert adam.fused_adam_update.launches == 1 and len(noted) == 1
    tracing.add_launches(noted, 5)
    assert adam.fused_adam_update.launches == 6
    assert adam.fused_adam_update.launches_by_tier["f32"] == 6


# ------------------------------------------------------------ the counts

def test_capturing_launches_notes_and_add_launches_counts_each_replay():
    spec = MLPSpec(sizes=(2, 8, 8, 6))
    wrappers = (kernels.mlp_fwd_tangents, kernels_vjp.packed_mlp_bwd)
    saved = [(w.launches, dict(w.launches_by_tier), dict(w.launches_by_body)) for w in wrappers]
    try:
        for w in wrappers:
            tracing.reset_launches(w)
        with tracing.capturing_launches() as noted:
            for w in wrappers * 2:
                tracing.count_launch(w, "f32", spec)
            with pytest.raises(RuntimeError):
                with tracing.capturing_launches():
                    pass
        assert [w.launches for w in wrappers] == [0, 0] and len(noted) == 4
        tracing.add_launches(noted)
        tracing.add_launches(noted, 3)
        for w in wrappers:
            assert w.launches == 8 and w.launches_by_tier["f32"] == 8
            assert w.launches_by_body["narrow"] == 8
        tracing.count_launch(kernels.mlp_fwd_tangents, "bf16", spec)
        assert kernels.mlp_fwd_tangents.launches == 9
    finally:
        for w, (n, tier, body) in zip(wrappers, saved):
            w.launches, w.launches_by_tier, w.launches_by_body = n, tier, body


def test_event_counts_count_and_reset():
    before = tracing.counts()
    tracing.count("test#event")
    tracing.count("test#event", 4)
    assert tracing.counts()["test#event"] - before.get("test#event", 0) == 5
    tracing.counts()["test#event"] = -1  # a copy
    assert tracing.counts()["test#event"] >= 5
    tracing.reset_counts()
    assert tracing.counts() == {}


# ------------------------------------------------------------ the Trainer

@pytest.fixture
def cmb_pair(tmp_path):
    csv, mat = str(tmp_path / "input_fid.csv"), str(tmp_path / "input_res.mat")
    synthetic.make_cmb_dataset(csv, mat, nx=21, ny=31, n_csv=60, seed=6, nan_fraction=0.03)
    return csv, mat


def cmb_trainer(tmp_path, cmb_pair, name, **layers):
    raw = make_cmb_config(*cmb_pair, 4, 0, hidden_layers=3, hidden_width=10, nx=21, ny=31,
                          interval=2, training_points=40)
    raw["layers"].update(layers)
    raw["fused_kernel"] = "on" if not layers else "auto"
    run = tmp_path / name
    os.makedirs(run)
    return Trainer(parse_config(raw), run_dir=str(run), echo_every=0, device="cpu")


def test_steps_that_are_not_replayed_are_counted_op_by_op(tmp_path, cmb_pair, capsys):
    """On the CPU and with dropout every Adam step runs op by op: the
    Trainer says so once, at construction, and counts each as
    ``step#eager``, none as a replay; no capture is recorded."""
    before = tracing.counts()
    tracing.enable()
    for name, layers in (("cpu", {}), ("dropout", {"dropout_rate": 0.1})):
        trainer = cmb_trainer(tmp_path, cmb_pair, name, **layers)
        assert not trainer.graph_step and trainer._graph is None
        trainer.train_adam()
    printed = capsys.readouterr().out
    assert printed.count("Adam step: op by op (no CUDA graph on cpu)") == 2
    counts = {k: v - before.get(k, 0) for k, v in tracing.counts().items()}
    assert counts["step#eager"] == 8 and counts.get("step#replay", 0) == 0
    summary = tracing.summary()
    assert summary["step#adam"]["count"] == 8 and "step#replay" not in summary
    assert "trainer#capture" not in summary


def test_the_decision_names_what_keeps_a_step_off_the_graph(tmp_path, cmb_pair, monkeypatch):
    """The reasons, in the order they are asked: the device, the one-kernel
    step, plain autograd, a tier other than f32, a leaf off the card."""
    trainer = cmb_trainer(tmp_path, cmb_pair, "decide")
    assert trainer._graph_decision() == (False, "no CUDA graph on cpu")
    monkeypatch.setattr(trainer, "device", torch.device("cuda"))
    assert trainer.kernel_plan.fused and trainer.fused_step_fn is None
    assert trainer._graph_decision() == (False, "a leaf is not a float32 card tensor")
    for tier in ("bf16", "f32x3"):
        monkeypatch.setattr(type(trainer.config), "resolved_kernel_precision",
                            lambda self, tier=tier: tier)
        assert trainer._graph_decision() == (False, "only the f32 step is graphed")
    monkeypatch.undo()
    monkeypatch.setattr(trainer, "device", torch.device("cuda"))
    monkeypatch.setattr(trainer, "kernel_plan", trainer.kernel_plan._replace(fused=False))
    assert trainer._graph_decision() == (False, "plain autograd is not graphed")
    monkeypatch.setattr(trainer, "fused_step_fn", lambda *a: None)
    assert trainer._graph_decision() == (False, "the one-kernel step (K1) is not graphed")
