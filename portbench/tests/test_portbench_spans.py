"""The readers of the program's spans (``source: program_span``): nothing
where the program recorded no span or has no spans at all, the right
number from a recorded list, and a value in a traced run on the CPU."""

import sys

import pytest

from portbench import run, tracing as bench_tracing

from pinn_depthestimation_tpu_torch import tracing

READERS = ("host_step_ms.train", "k1_host_us", "adam_host_us", "block_flush_ms",
           "trainer_init_s", "k2_host_us")
TRAIN = {"steps": 4, "points": 100, "sizes": [2, 8, 8, 3]}
RESIDUAL = {"calls": 5, "points": 100, "sizes": [2, 8, 8, 3]}
S = tracing.Span


def reader(name):
    return run.load_module(run.BENCH_DIR / "metrics" / f"{name}.py",
                           f"portbench_metric_{name.replace('.', '_')}").read


def view(work):
    return bench_tracing.TraceView(window_s=1.0, work=work)


@pytest.fixture
def recorded(monkeypatch):
    """Puts ``spans`` in the program's list for one test."""
    def put(spans):
        monkeypatch.setattr(tracing, "_spans", list(spans))
    put([])
    return put


@pytest.mark.parametrize("name", READERS)
def test_no_span_reads_nothing(name, recorded):
    assert reader(name)(view(TRAIN)) is None
    assert reader(name)(view(RESIDUAL)) is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_spans_reads_nothing(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "pinn_depthestimation_tpu_torch.tracing", None)
    assert reader(name)(view(TRAIN)) is None
    assert reader(name)(view(RESIDUAL)) is None


def test_each_reader_on_a_recorded_list(recorded):
    ms, us = 1_000_000, 1_000
    # two blocks of two steps: dispatch 3 ms each (K1 400 us, Adam 100 us
    # a step), sync 1 ms, record 2 ms; the Trainer built in 9 s before them
    spans = [S("trainer#init", None, 0, 9_000 * ms)]
    t = 10_000 * ms
    for _ in range(2):
        block = t
        for _ in range(2):
            spans += [S("step#k1", "trainer#dispatch", t, t + 400 * us),
                      S("step#adam", "trainer#dispatch", t + 400 * us, t + 500 * us)]
            t += 1500 * us
        spans += [S("trainer#dispatch", "trainer#block", block, block + 3 * ms),
                  S("trainer#sync", "trainer#block", block + 3 * ms, block + 4 * ms),
                  S("trainer#record", "trainer#block", block + 4 * ms, block + 6 * ms),
                  S("trainer#block", None, block, block + 6 * ms)]
        t = block + 6 * ms
    recorded(spans)
    train = view(TRAIN)
    assert reader("host_step_ms.train")(train) == pytest.approx(1.5)
    assert reader("k1_host_us")(train) == pytest.approx(400.0)
    assert reader("adam_host_us")(train) == pytest.approx(100.0)
    assert reader("block_flush_ms")(train) == pytest.approx(2.0)
    assert reader("trainer_init_s")(train) == pytest.approx(9.0)
    recorded([S("residual#k2", None, i * 10 * us, i * 10 * us + 7 * us) for i in range(5)])
    assert reader("k2_host_us")(view(RESIDUAL)) == pytest.approx(7.0)
    assert reader("k1_host_us")(view(RESIDUAL)) is None


def test_a_traced_run_on_the_cpu_reads_the_flagship_metrics():
    from portbench.tests.test_portbench_harness import SMALL

    tracing.reset()
    out = run.run_cell("flagship-adam", 2**31 + 9, 0.2, True, device="cpu", overrides=SMALL)
    res, notes = out["result"], out["notes"]
    names = [m["name"] for m in run.cell_metrics(run.load_json(run.ROOT / "BENCHMARK.json"),
                                                 "flagship-adam", "per_layer")]
    for name in READERS[:5]:
        assert name in names
        assert res["metrics"][name]["value"] > 0, name
    summary = tracing.summary()
    assert summary["step#adam"]["count"] == notes["window_steps"] == res["attempted"]
    assert summary["step#k1"]["count"] == notes["window_steps"]
    assert summary["trainer#block"]["count"] == len(notes["block_ms"])
    small = {"config": {"layers": {"hidden_layers": 4, "hidden_width": 8},
                        "cells": {"nx": 40, "ny": 25}, "collocation_points": 1000}}
    tracing.reset()
    out = run.run_cell("scaled-residual", 11, 0.2, True, device="cpu", overrides=small)
    assert out["result"]["metrics"]["k2_host_us"]["value"] > 0
    assert tracing.summary()["residual#k2"]["count"] == out["notes"]["window_calls"]
