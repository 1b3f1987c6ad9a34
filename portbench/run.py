"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Everything is found by name. ``BENCHMARK.json`` (the checkout's root) gives
the cell's configuration, traffic and chips and the metrics it reports;
``portbench/workloads/<cell>.json`` its traffic (the driver's name, its
parameters, the limits of its comparison); ``portbench/configs/<config>.json``
the configuration as it is run; ``portbench/drivers/<driver>.py`` the code
that drives the port; ``portbench/metrics/<metric>.py`` each per-layer
metric's reader; ``portbench/reference/<physics>.py`` the plain reference.

A run: set-up (the driver's: inputs from the seed, the system under test,
its first steps or calls, warm-up; ``setup_s`` runs from this file's first
line to the window's start), the measured window of ``--seconds`` (with
``--trace 1`` under ``torch.profiler``, for the traced length of the
workload), the device's memory peak, the program's state freed, then the
comparison with the reference that decides ``correct``. The last line of
standard output is the result; the numbers compared, each beside its limit,
are the last lines of standard error. Spans of the benchmark's own steps
go to standard error before them.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "pinn_depthestimation_tpu"})
CACHE_DIR = ROOT / ".portbench_cache"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The module at ``path`` (a file name may hold dots: a metric's)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports: those
    that list it, and those without a list that move (or are) an end-to-end
    metric the cell reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


class Context:
    """What a driver gets: the cell's configuration and traffic, the seed,
    the device, a scratch directory under ``TMPDIR``, the reference, and
    the recorder of spans (``with ctx.span(name):``) and notes."""

    def __init__(self, cell: str, seed: int, device, config: dict, workload: dict, tmp: str):
        self.cell, self.seed, self.device = cell, seed, device
        self.config, self.workload, self.tmp = config, workload, tmp
        self.spans: list[tuple[str, float]] = []
        self.notes: dict = {}
        self.reference = load_module(BENCH_DIR / "reference" / f"{config['physics']}.py",
                                     f"portbench_reference_{config['physics']}")

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, time.perf_counter() - t0))

    def sync(self):
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)


def merged(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = merged(base[k], v) if isinstance(v, dict) and isinstance(base.get(k), dict) else v
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device=None,
             overrides: dict | None = None, bench: dict | None = None) -> dict:
    """One run of cell ``name``; returns ``{"result", "spans", "notes"}``.
    ``device``: the card by default. ``overrides``: changes to
    the cell's configuration and traffic (``{"config": ..., "workload":
    ...}``, merged key by key), for tests at small sizes."""
    overrides = overrides or {}
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cell = find_cell(bench, name)
    workload = merged(load_json(BENCH_DIR / "workloads" / f"{name}.json"),
                      overrides.get("workload", {}))
    if workload["config"] != cell["config"] or workload["traffic"] != cell["traffic"]:
        raise SystemExit(f"portbench: workloads/{name}.json disagrees with BENCHMARK.json")
    config = merged(load_json(BENCH_DIR / "configs" / f"{cell['config']}.json"),
                    overrides.get("config", {}))
    peaks = load_json(BENCH_DIR / "peaks.json")
    t_import = time.perf_counter()
    import torch

    device = torch.device(device or "cuda")
    driver = load_module(BENCH_DIR / "drivers" / f"{workload['driver']}.py",
                         f"portbench_driver_{workload['driver']}")
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        ctx = Context(name, seed, device, config, workload, tmp)
        ctx.spans.append(("import", time.perf_counter() - t_import))
        state = driver.setup(ctx)
        ctx.sync()
        setup_s = time.perf_counter() - T_START
        view = None
        if trace:
            from torch.profiler import ProfilerActivity, profile, record_function

            from portbench.tracing import WINDOW, breakdown, from_profiler

            traced = min(seconds, workload["trace_seconds"])
            # on the card the device alone is traced (its operations and the
            # runtime calls that issue them): recording every host operation
            # slows the host enough to change what the window measures
            activities = ([ProfilerActivity.CUDA] if device.type == "cuda"
                          else [ProfilerActivity.CPU])
            with ctx.span("window"), profile(activities=activities) as prof:
                with record_function(WINDOW):
                    t0 = time.perf_counter()
                    work = driver.window(ctx, state, traced)
                    window_s = time.perf_counter() - t0
            with ctx.span("trace"):
                view = from_profiler(prof, work, config, peaks, window_s)
                del prof
        else:
            with ctx.span("window"):
                work = driver.window(ctx, state, seconds)
        memory = (torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)
        with ctx.span("release"):
            driver.release(ctx, state)
        with ctx.span("check"):
            checks = driver.check(ctx, state)
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    metrics = {}
    if trace:
        for m in cell_metrics(bench, name, "per_layer"):
            reader = load_module(BENCH_DIR / "metrics" / f"{m['name']}.py",
                                 f"portbench_metric_{m['name'].replace('.', '_')}")
            value = reader.read(view)
            if value is None:
                ctx.notes.setdefault("read_nothing", []).append(m["name"])
            else:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        quantities = dict(work["metrics"], setup_s=setup_s)
        for m in cell_metrics(bench, name, "end_to_end"):
            if m["name"] in quantities:
                metrics[m["name"]] = {"value": quantities[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(memory)}
    result = {"correct": bool(correct), "attempted": int(work["attempted"]),
              "failed": int(work["failed"]), "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = view.busy_s()
        dev["window_s"] = view.window_s
        result["breakdown"] = breakdown(view)
    result["checks"] = checks
    return {"result": result, "spans": ctx.spans, "notes": ctx.notes}


def card_power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = parser.parse_args(argv)

    # the program's kernel caches stay inside the checkout, at fixed paths
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE_DIR / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = find_cell(bench, args.workload)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: cell {args.workload!r} needs {cell['chips']} CUDA device(s); "
              f"torch finds {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   device="cuda:0", bench=bench)
    found = sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)
    if found:
        print(f"portbench: the process loaded {found}; the port must not", file=sys.stderr)
        return 4
    print("portbench card: " + card_power_limit(), file=sys.stderr)
    print("portbench notes: " + json.dumps(out["notes"]), file=sys.stderr)
    print("portbench spans: " + json.dumps({n: s for n, s in out["spans"]}), file=sys.stderr)
    for name, c in out["result"]["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out["result"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
