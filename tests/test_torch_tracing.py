"""The port's spans and counters (``pinn_depthestimation_tpu_torch.tracing``):
off they record nothing and never reach ``record_function``; on they nest,
sum to self times and show in a ``torch.profiler`` trace; the Trainer,
the K1 and K2 wrappers and the kernel build record theirs; CLI ``train
--profile`` writes them beside its trace."""

import ast
import dataclasses
import json
import os
import re
from pathlib import Path

import pytest
import torch

import pinn_depthestimation_tpu_torch as port
from pinn_depthestimation_tpu_torch import cli, tracing
from pinn_depthestimation_tpu_torch.config import parse_config
from pinn_depthestimation_tpu_torch.models import MLPSpec
from pinn_depthestimation_tpu_torch.ops import kernels, kernels_step, kernels_vjp
from pinn_depthestimation_tpu_torch.training.driver import Trainer
from pinn_depthestimation_tpu_torch.utils import synthetic

NAME = re.compile(r"^[a-z0-9_]+#[a-z0-9_.]+$")
PROGRAM_SPANS = {
    "trainer#init", "trainer#init.data", "trainer#init.loss", "trainer#init.optimizer",
    "trainer#block", "trainer#dispatch", "trainer#sync", "trainer#record",
    "trainer#checkpoint", "step#k1", "step#adam", "residual#k2", "library#build",
    "library#load", "trainer#capture", "step#replay",
}
BLOCK = ("trainer#block", "trainer#dispatch", "trainer#sync", "trainer#record")


@pytest.fixture(autouse=True)
def fresh():
    """Each test starts with no spans and tracing off, and leaves it so."""
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def newmethod_raw(mat, adam_it):
    return {
        "layers": {"input_features": 2, "hidden_layers": 2, "hidden_width": 8,
                   "output_features": 3, "dropout_rate": 0.0, "init_type": "xavier"},
        "adam_optimizer": {"max_it": adam_it, "learning_rate": 1e-3,
                           "scheduler_step_size": 30, "scheduler_gamma": 0.8},
        "lbfgs_optimizer": {"max_it": 0},
        "loss": {"weight_fid_loss": 1, "weight_res_loss": 1},
        "data": {"file": mat, "inputs": {"x": {"requires_grad": ["true"]},
                                         "y": {"requires_grad": ["true"]}},
                 "trues": ["U", "V"], "unknowns": ["h"]},
        "physics": "continuity_only",
        "fused_kernel": "on",
    }


@pytest.fixture
def mat(tmp_path):
    path = str(tmp_path / "data.mat")
    synthetic.make_newmethod_mat(path, nx=8, ny=10, nan_fraction=0.05, seed=2)
    return path


def tiny_trainer(tmp_path, mat, adam_it=3):
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    return Trainer(parse_config(newmethod_raw(mat, adam_it)), run_dir=str(run_dir),
                   device="cpu")


def advance(trainer, to):
    """One more block: ``train_adam`` until the counter reaches ``to``."""
    trainer.config.adam = dataclasses.replace(trainer.config.adam, max_it=to)
    trainer.train_adam()


def tracing_on():
    with tracing.span("test#probe") as s:
        pass
    if s is not None:
        tracing._spans.pop()
    return s is not None


def counts():
    return {name: row["count"] for name, row in tracing.summary().items()}


def test_off_a_span_records_nothing_and_never_enters_record_function(tmp_path, mat,
                                                                     monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not tracing_on()
    with tracing.span("test#off") as s:
        assert s is None
    trainer = tiny_trainer(tmp_path, mat)
    advance(trainer, 3)
    spec = MLPSpec(sizes=(2, 8, 8, 3))
    params = {k: v for k, v in trainer.state.params.items()}
    kernels.fused_residual_continuity(params, torch.rand(16, 2), spec)
    # the set-up spans alone, which always record
    assert set(counts()) == {"trainer#init", "trainer#init.data", "trainer#init.loss",
                             "trainer#init.optimizer"}


def test_under_the_profiler_spans_nest_sum_to_self_times_and_show_as_ranges():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert tracing_on()
        with tracing.span("test#outer"):
            with tracing.span("test#inner"):
                torch.ones(64).sum()
            with tracing.span("test#inner"):
                torch.ones(64).sum()
    assert not tracing_on()
    with tracing.span("test#after"):
        pass
    raw = tracing.spans()
    assert [s.name for s in raw] == ["test#inner", "test#inner", "test#outer"]
    assert [s.parent for s in raw] == ["test#outer", "test#outer", None]
    outer = raw[2]
    for s in raw[:2]:
        assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
    summary = tracing.summary()
    inner_s = sum(s.end_ns - s.start_ns for s in raw[:2]) * 1e-9
    assert summary["test#inner"]["count"] == 2
    assert summary["test#inner"]["total_s"] == pytest.approx(inner_s)
    assert summary["test#inner"]["self_s"] == pytest.approx(inner_s)
    assert summary["test#outer"]["self_s"] == pytest.approx(
        (outer.end_ns - outer.start_ns) * 1e-9 - inner_s)
    assert summary["test#outer"]["parent"] is None
    names = [e.name for e in prof.events()]
    assert names.count("test#outer") == 1 and names.count("test#inner") == 2


def test_summary_reads_self_times_from_a_recorded_list(monkeypatch):
    S = tracing.Span
    recorded = [S("a#c", "a#p", 10, 20), S("a#c", "a#p", 30, 35), S("a#p", None, 0, 100),
                S("a#p", None, 100, 110), S("a#c", None, 200, 204)]
    monkeypatch.setattr(tracing, "_spans", recorded)
    summary = tracing.summary()
    assert summary["a#p"] == {"count": 2, "total_s": pytest.approx(110e-9),
                              "self_s": pytest.approx(95e-9), "parent": None}
    assert summary["a#c"]["count"] == 3 and summary["a#c"]["self_s"] == pytest.approx(19e-9)
    assert summary["a#c"]["parent"] == "a#p"


def test_a_span_records_when_its_body_raises():
    tracing.enable()
    with pytest.raises(ValueError):
        with tracing.span("test#raises"):
            raise ValueError("inside")
    with tracing.span("test#next"):
        pass
    assert [(s.name, s.parent) for s in tracing.spans()] == [("test#raises", None),
                                                             ("test#next", None)]


def program_span_names():
    """Every literal name the package passes to ``span`` or ``setup_span``."""
    names = set()
    for path in Path(port.__file__).parent.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("span", "setup_span")
                    and getattr(node.func.value, "id", None) == "tracing"):
                assert isinstance(node.args[0], ast.Constant), f"{path}: a name not literal"
                names.add(node.args[0].value)
    return names


def test_every_span_name_of_the_program_is_layer_hash_span():
    names = program_span_names()
    assert names == PROGRAM_SPANS
    for name in names:
        assert "#" in name and NAME.match(name), name


def test_a_tiny_trainer_records_each_block_and_step(tmp_path, mat):
    tracing.enable()
    trainer = tiny_trainer(tmp_path, mat)
    advance(trainer, 3)
    advance(trainer, 7)  # two blocks, 3 and 4 steps
    c = counts()
    for name in BLOCK:
        assert c[name] == 2, name
    assert c["step#adam"] == 7 and c["step#k1"] == 7
    summary = tracing.summary()
    assert summary["trainer#init"]["count"] == 1 and summary["trainer#init"]["parent"] is None
    for child in ("trainer#init.data", "trainer#init.loss", "trainer#init.optimizer"):
        assert summary[child] == {**summary[child], "count": 1, "parent": "trainer#init"}
    assert {summary[n]["parent"] for n in BLOCK[1:]} == {"trainer#block"}
    assert summary["step#adam"]["parent"] == summary["step#k1"]["parent"] == "trainer#dispatch"
    block = summary["trainer#block"]
    inside = sum(summary[n]["total_s"] for n in BLOCK[1:])
    assert inside <= block["total_s"] and block["self_s"] == pytest.approx(
        block["total_s"] - inside)
    assert "trainer#checkpoint" not in c  # no cadence point crossed below 1,000


def test_a_block_that_crosses_a_cadence_point_records_its_save(tmp_path, mat):
    trainer = tiny_trainer(tmp_path, mat)
    trainer.state.iteration = 9_999  # newmethod saves every 10,000 steps
    tracing.enable()
    trainer._record(torch.zeros((1, 3)).numpy())
    summary = tracing.summary()
    assert summary["trainer#checkpoint"]["count"] == 1
    assert summary["trainer#checkpoint"]["parent"] == "trainer#record"
    assert os.path.exists(os.path.join(trainer.run_dir, "model_10000.npz"))


def test_count_launch_moves_the_wrappers_attributes():
    assert kernels.count_launch is tracing.count_launch
    assert kernels.reset_launches is tracing.reset_launches
    spec = MLPSpec(sizes=(2, 8, 8, 3))
    for wrapper in (kernels.fused_residual_continuity, kernels.mlp_fwd_tangents,
                    kernels_step.fused_loss_and_grad, kernels_vjp.packed_mlp_bwd):
        before = (wrapper.launches, dict(wrapper.launches_by_tier),
                  dict(wrapper.launches_by_body))
        try:
            kernels.reset_launches(wrapper)
            assert wrapper.launches == 0
            assert set(wrapper.launches_by_tier) == {"f32", "bf16", "f32x3"}
            tracing.count_launch(wrapper, "bf16", spec)
            kernels.count_launch(wrapper, "f32", spec)
            assert wrapper.launches == 2
            assert wrapper.launches_by_tier == {"f32": 1, "bf16": 1, "f32x3": 0}
            assert wrapper.launches_by_body["narrow"] == 2
            assert sum(wrapper.launches_by_body.values()) == 2
        finally:
            wrapper.launches, wrapper.launches_by_tier, wrapper.launches_by_body = before


def test_train_profile_writes_the_spans_beside_the_trace(tmp_path, mat, capsys):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(newmethod_raw(mat, 3)))
    prof = tmp_path / "prof"
    assert cli.main(["train", "--config", str(cfg), "--log-root", str(tmp_path), "--run-name",
                     "p", "--device", "cpu", "--profile", str(prof)]) == 0
    assert not tracing_on()
    trace = json.loads((prof / "trace.json").read_text())
    ranges = {e.get("name") for e in trace["traceEvents"]}
    assert {"trainer#block", "trainer#dispatch", "step#k1", "step#adam"} <= ranges
    spans = json.loads((prof / "spans.json").read_text())
    assert spans["summary"]["trainer#block"]["count"] == 1
    assert spans["summary"]["step#adam"]["count"] == 3
    assert spans["summary"]["trainer#init"]["count"] == 1
    assert {s["name"] for s in spans["spans"]} == set(spans["summary"])
    first = spans["spans"][0]
    assert set(first) == {"name", "parent", "start_ns", "end_ns"}
    assert first["end_ns"] >= first["start_ns"]
    with pytest.raises(SystemExit):
        cli.main(["train", "--help"])
    assert "DIR/spans.json" in " ".join(capsys.readouterr().out.split())


def test_a_tiny_trainer_counts_each_step_by_how_it_ran(tmp_path, mat):
    """The counts are on whether tracing is or not: each Adam step of a CPU
    Trainer is ``step#eager``, none a replay, no capture; the K1 step says
    so at construction."""
    before = tracing.counts()
    trainer = tiny_trainer(tmp_path, mat)
    assert not trainer.graph_step and trainer._graph is None
    assert trainer._graph_decision() == (False, "no CUDA graph on cpu")
    advance(trainer, 3)
    advance(trainer, 5)
    after = tracing.counts()
    assert after["step#eager"] - before.get("step#eager", 0) == 5
    assert after.get("step#replay", 0) == before.get("step#replay", 0)
    assert counts() == {"trainer#init": 1, "trainer#init.data": 1, "trainer#init.loss": 1,
                        "trainer#init.optimizer": 1}


def test_launches_counted_inside_a_capture_are_noted_for_the_replays():
    spec = MLPSpec(sizes=(2, 8, 8, 3))
    wrapper = kernels.mlp_fwd_tangents
    before = (wrapper.launches, dict(wrapper.launches_by_tier), dict(wrapper.launches_by_body))
    try:
        with tracing.capturing_launches() as noted:
            tracing.count_launch(wrapper, "f32", spec)
        assert wrapper.launches == before[0] and noted == [(wrapper, "f32", "narrow")]
        tracing.add_launches(noted, 2)
        assert wrapper.launches == before[0] + 2
        assert wrapper.launches_by_body["narrow"] == before[2]["narrow"] + 2
    finally:
        wrapper.launches, wrapper.launches_by_tier, wrapper.launches_by_body = before
