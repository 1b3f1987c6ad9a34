"""The harness is driven by data: a new cell, configuration, driver and
per-layer metric are new files and new entries of ``BENCHMARK.json``, and
a run finds them by name. Without a card a run prints no result."""

import hashlib
import json
import shutil
import subprocess
import sys

import pytest

from portbench import run

SMALL = {"config": {"layers": {"hidden_layers": 4, "hidden_width": 8},
                    "grid": {"nx": 21, "ny": 31}},
         "workload": {"block_steps": 4}}


def digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_needs_only_new_files(tmp_path):
    shutil.copytree(run.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(tmp_path / "portbench")
    bench_dir = tmp_path / "portbench"

    config = json.loads((bench_dir / "configs" / "flagship.json").read_text())
    config.update(name="flagship-narrow", layers=dict(config["layers"], hidden_width=8,
                                                      hidden_layers=4),
                  grid=dict(config["grid"], nx=21, ny=31))
    (bench_dir / "configs" / "flagship-narrow.json").write_text(json.dumps(config))
    (bench_dir / "drivers" / "adam_again.py").write_text(
        "from portbench import run\n"
        "_adam = run.load_module(run.BENCH_DIR / 'drivers' / 'adam.py', 'adam_base')\n"
        "setup, window, release, check = _adam.setup, _adam.window, _adam.release, _adam.check\n")
    workload = json.loads((bench_dir / "workloads" / "flagship-adam.json").read_text())
    workload.update(config="flagship-narrow", traffic="adam-short", driver="adam_again",
                    block_steps=3, warmup_blocks=1)
    (bench_dir / "workloads" / "narrow-adam.json").write_text(json.dumps(workload))
    (bench_dir / "metrics" / "window_steps.py").write_text(
        "def read(view):\n    return view.work.get('steps')\n")

    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "flagship-narrow", "source": bench["configs"][0]["source"],
                             "file": "portbench/configs/flagship-narrow.json",
                             "reduced": ["layers"], "why": "a narrow test net"})
    bench["workloads"].append({"name": "narrow-adam", "config": "flagship-narrow",
                               "traffic": "adam-short", "chips": 1, "why": "a test cell"})
    bench["end_to_end"][0]["workloads"].append("narrow-adam")
    bench["per_layer"].append({"name": "window_steps", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "the step",
                               "moves": "train_step_ms", "workloads": ["narrow-adam"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    copy = run.load_module(bench_dir / "run.py", "portbench_copy_run")
    assert copy.BENCH_DIR == bench_dir
    assert [m["name"] for m in copy.cell_metrics(bench, "narrow-adam", "per_layer")] == [
        "window_steps"]
    assert "window_steps" not in {m["name"] for m in copy.cell_metrics(bench, "flagship-adam",
                                                                         "per_layer")}
    plain = copy.run_cell("narrow-adam", 3, 0.2, False, device="cpu", bench=bench)["result"]
    assert set(plain["metrics"]) == {"train_step_ms", "setup_s"} and plain["correct"]
    traced = copy.run_cell("narrow-adam", 4, 0.2, True, device="cpu", bench=bench)["result"]
    assert traced["metrics"]["window_steps"]["value"] == traced["attempted"] > 0
    assert list(traced)[-1] == "checks"
    after = digest(bench_dir)
    assert {k: after[k] for k in before} == before


def test_metrics_reach_the_cells_they_name_or_move():
    bench = {"end_to_end": [{"name": "a_ms", "workloads": ["x"]}, {"name": "setup_s"}],
             "per_layer": [{"name": "p", "moves": "a_ms"}, {"name": "q", "moves": "a_ms",
                                                            "workloads": ["y"]}]}
    assert [m["name"] for m in run.cell_metrics(bench, "x", "end_to_end")] == ["a_ms", "setup_s"]
    assert [m["name"] for m in run.cell_metrics(bench, "x", "per_layer")] == ["p"]
    assert [m["name"] for m in run.cell_metrics(bench, "y", "per_layer")] == ["q"]


def test_without_a_card_a_run_prints_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(["--workload", "flagship-adam", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copytree(run.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "scaled-residual",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout == ""


def test_a_small_run_of_each_cell_on_the_cpu():
    out = run.run_cell("flagship-adam", 2**31 + 5, 0.2, False, device="cpu", overrides=SMALL)
    res = out["result"]
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"train_step_ms", "setup_s"}
    assert [s for s, _ in out["spans"]][:2] == ["import", "data"]
    small = {"config": {"layers": {"hidden_layers": 4, "hidden_width": 8},
                        "cells": {"nx": 40, "ny": 25}, "collocation_points": 1000}}
    res = run.run_cell("scaled-residual", 9, 0.2, False, device="cpu", overrides=small)["result"]
    assert res["correct"] and set(res["metrics"]) == {"residual_points_per_s", "setup_s"}


def test_readers_on_a_trace_of_the_cards_kernel_names():
    """Kernel names as the card's profiler gives them: each
    reader finds its kernels, and the arithmetic of the view."""
    from portbench import opcount, tracing

    k1 = ("void (anonymous namespace)::k1_train_step_kernel<tier::TierF32, 20, 0>"
          "((anonymous namespace)::Args)")
    red = "mlp_bwd::(anonymous namespace)::reduce_kernel(float const*, int, int, float*)"
    adam = "void at::native::(anonymous namespace)::multi_tensor_apply_kernel<...>"
    k2 = "void k2f32::k2_f32_kernel<20, 1, 0, 2, true>(float const*, float*)"
    peaks = run.load_json(run.BENCH_DIR / "peaks.json")
    sizes = [2] + [20] * 100 + [3]
    ops, t = [], 0.0
    for _ in range(4):  # a step: K1 0.7 ms, its reduction 0.01, Adam 0.05, idle 0.04
        ops += [(k1, t, t + 7e-4), (red, t + 7e-4, t + 7.1e-4), (adam, t + 7.1e-4, t + 7.6e-4)]
        t += 8e-4
    view = tracing.TraceView(window_s=t, device=ops, work={"steps": 4, "points": 12_516,
                                                            "sizes": sizes}, peaks=peaks)
    read = {m: run.load_module(run.BENCH_DIR / "metrics" / f"{m}.py", m).read
            for m in ("k1_roofline", "mfu_pct.train", "step_other_device_ms",
                      "device_idle_pct.train", "k2_roofline", "device_idle_pct.residual")}
    bound = opcount.k1_flops(sizes, 12_516) / 67e12
    assert read["k1_roofline"](view) == pytest.approx(100 * bound / 7.1e-4)
    assert read["mfu_pct.train"](view) == pytest.approx(100 * bound / 8e-4)
    assert read["step_other_device_ms"](view) == pytest.approx(0.05)
    assert read["device_idle_pct.train"](view) == pytest.approx(5.0)
    assert read["k2_roofline"](view) is None and read["device_idle_pct.residual"](view) is None
    k2_view = tracing.TraceView(window_s=0.02, device=[(k2, 0.0, 0.008), (k2, 0.008, 0.016)],
                                work={"calls": 2, "points": 1_250_000, "sizes": sizes},
                                peaks=peaks)
    expected = opcount.k2_flops(sizes, 1_250_000, 2, True) / 67e12 / 0.008
    assert run.load_module(run.BENCH_DIR / "metrics" / "k2_roofline.py", "k2").read(
        k2_view) == pytest.approx(100 * expected)
    assert tracing.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    gaps = tracing.breakdown(view)["idle_gaps"]
    assert gaps[0][0] == "(python)" and gaps[0][1] == pytest.approx(4 * 4e-5)
