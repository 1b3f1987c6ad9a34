"""The readings the limits of ``correct`` are set from, on the card.

    python3 portbench/calibrate.py --workload NAME --seeds 1,2,3 [--seconds 1]
        [--out FILE]

For each seed, in one process: the cell's set-up and a short window, as a
run makes them (``--seconds``), then the numbers its check compares, for
three things put in the program's place, each against the reference at
the configuration's precision:

* ``program``: the port itself (the lower readings);
* ``control``: the reference one precision lower, TF32 for the
  configuration's float32 (the upper readings);
* the faults the cell can have: ``half_batch`` (Adam: the reference on half
  of the rows, the mean over those), ``altered`` (residual: one point's
  answer moved by a hundredth of the call's widest residual).

A step that returns its state unchanged reads 1 on ``change_gap`` by its
definition and needs no run. One JSON line a seed, and the whole as JSON
in ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import run  # noqa: E402


def readings(driver, ctx, state, name: str) -> dict:
    import torch

    ref = driver.reference_side(ctx, state)
    ctl = driver.reference_side(ctx, state, "tf32")
    prog = driver.program_side(state)
    out = {"program": driver.compare(prog, ref), "control": driver.compare(ctl, ref)}
    if name == "adam":
        out["half_batch"] = driver.compare(driver.reference_side(ctx, state, half=True), ref)
        # per leaf: the program's, the reference's and the control's norms
        out["leaves"] = {k: {"grad1": [prog["grad1"][k], ref["grad1"][k], ctl["grad1"][k]],
                             "change": [prog["change"][k], ref["change"][k], ctl["change"][k]]}
                         for k in prog["grad1"]}
    else:
        altered = {}
        for i, v in prog.items():
            v = v.clone()
            v[v.shape[0] // 3] += 1e-2 * float(torch.max(torch.abs(ref[i])))
            altered[i] = v
        out["altered"] = driver.compare(altered, ref)
    return out


def collect(name: str, seeds, seconds: float) -> list[dict]:
    """The readings of cell ``name`` on the card for each of ``seeds``,
    with the cell's limits."""
    import tempfile

    import torch

    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    cell = run.find_cell(bench, name)
    workload = run.load_json(run.BENCH_DIR / "workloads" / f"{name}.json")
    config = run.load_json(run.BENCH_DIR / "configs" / f"{cell['config']}.json")
    driver = run.load_module(run.BENCH_DIR / "drivers" / f"{workload['driver']}.py",
                             f"portbench_driver_{workload['driver']}")
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
            ctx = run.Context(name, seed, torch.device("cuda:0"), config, workload, tmp)
            state = driver.setup(ctx)
            driver.window(ctx, state, seconds)
            driver.release(ctx, state)
            row = {"seed": seed, **readings(driver, ctx, state, workload["driver"]),
                   "limits": workload["limits"], "seconds": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 3
    rows = collect(args.workload, [int(s) for s in args.seeds.split(",")], args.seconds)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"workload": args.workload, "rows": rows,
                                              "card": run.card_power_limit()}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
