"""The readings the limits of ``correct`` are set from, on the card, for a
cell of Adam steps whose driver is not ``drivers/adam.py`` (``adam_cmb``,
``adam_scaled``): ``portbench/calibrate.py``'s readings of an Adam cell.

    python3 portbench/calibrate_adam.py --workload NAME --seeds 1,2,3
        [--seconds 1] [--out FILE]

For each seed, in one process: the cell's set-up and a short window, as a
run makes them, then the numbers its check compares for the port
(``program``), the reference one precision lower (``control``, TF32) and
the reference on half of the points and rows (``half_batch``), each against
the reference, with the per-leaf norms. One JSON line a seed, and the whole
as JSON in ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import run  # noqa: E402


def readings(driver, ctx, state) -> dict:
    ref = driver.reference_side(ctx, state)
    ctl = driver.reference_side(ctx, state, "tf32")
    prog = driver.program_side(state)
    return {"program": driver.compare(prog, ref), "control": driver.compare(ctl, ref),
            "half_batch": driver.compare(driver.reference_side(ctx, state, half=True), ref),
            "leaves": {k: {"grad1": [prog["grad1"][k], ref["grad1"][k], ctl["grad1"][k]],
                           "change": [prog["change"][k], ref["change"][k], ctl["change"][k]]}
                       for k in prog["grad1"]}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("calibrate_adam: needs a CUDA card", file=sys.stderr)
        return 3
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    cell = run.find_cell(bench, args.workload)
    workload = run.load_json(run.BENCH_DIR / "workloads" / f"{args.workload}.json")
    config = run.load_json(run.BENCH_DIR / "configs" / f"{cell['config']}.json")
    driver = run.load_module(run.BENCH_DIR / "drivers" / f"{workload['driver']}.py",
                             f"portbench_driver_{workload['driver']}")
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
            ctx = run.Context(args.workload, seed, torch.device("cuda:0"), config, workload, tmp)
            state = driver.setup(ctx)
            driver.window(ctx, state, args.seconds)
            driver.release(ctx, state)
            row = {"seed": seed, **readings(driver, ctx, state), "limits": workload["limits"],
                   "seconds": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"workload": args.workload, "rows": rows,
                                              "card": run.card_power_limit()}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
