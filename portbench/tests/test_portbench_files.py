"""Every file of the benchmark parses and keeps to the contract's forms;
the inputs repeat from a seed; the copied operation counts."""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import gen, opcount, run

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FLAGSHIP = [2] + [20] * 100 + [3]


def test_benchmark_json_has_exactly_the_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((run.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_texts_use_the_allowed_characters():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    texts = ([e["why"] for e in BENCH["configs"] + BENCH["workloads"]]
             + [c["source"] for c in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]]
             + BENCH["command"])
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))


def test_every_entry_has_just_the_contract_keys_and_its_files():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((run.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert c["source"].startswith("https://") and cfg["source"] == c["source"]
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        wl = json.loads((run.BENCH_DIR / "workloads" / f"{w['name']}.json").read_text())
        assert (wl["config"], wl["traffic"]) == (w["config"], w["traffic"])
        assert (run.BENCH_DIR / "drivers" / f"{wl['driver']}.py").is_file()
        assert all(isinstance(v, float) and v > 0 for v in wl["limits"].values())
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e
        reader = run.load_module(run.BENCH_DIR / "metrics" / f"{m['name']}.py", "m")
        assert callable(reader.read)
    for w in BENCH["workloads"]:
        reported = {m["name"] for m in run.cell_metrics(BENCH, w["name"], "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        assert run.cell_metrics(BENCH, w["name"], "per_layer")
    configs = {c["name"] for c in BENCH["configs"]}
    assert configs == {w["config"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("path", sorted((run.BENCH_DIR).rglob("*.json")), ids=lambda p: p.name)
def test_every_data_file_parses(path):
    assert isinstance(json.loads(path.read_text()), dict)


def test_the_copied_operation_counts():
    assert opcount.k1_flops(FLAGSHIP, 1) == 714_200
    assert opcount.k2_flops(FLAGSHIP, 1, 2, True) == 238_207
    assert opcount.k1_flops(FLAGSHIP, 12_516) == 714_200 * 12_516


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40 + 3])
def test_inputs_repeat_from_a_seed_and_keep_their_sizes(seed):
    cfg = json.loads((run.BENCH_DIR / "configs" / "flagship.json").read_text())
    a, b = gen.survey_columns(cfg["grid"], seed), gen.survey_columns(cfg["grid"], seed)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert int((~np.isnan(a["U"])).sum()) == 12_516
    cells = {"nx": 40, "ny": 30, "x_min": 25.0, "x_max": 33.0, "y_min": -13.0, "y_max": 13.0}
    p, q = gen.collocation_points(cells, seed, 2), gen.collocation_points(cells, seed, 2)
    for s, t in zip(p, q):
        np.testing.assert_array_equal(s, t)
        assert s.shape == (1200, 2) and np.abs(s).max() <= 1.0
    w, v = (gen.init_params(cfg["layers"], seed, torch.device("cpu")) for _ in range(2))
    for k in w:
        assert torch.equal(w[k], v[k])
    assert w["w_hidden"].shape == (99, 20, 20)
    other = gen.survey_columns(cfg["grid"], seed + 1)
    assert not np.array_equal(np.isnan(other["U"]), np.isnan(a["U"]))
