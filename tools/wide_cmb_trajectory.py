#!/usr/bin/env python3
"""Train phase 29's CMB run at width 128 through the kernels and through
autograd from the same weights, and put the two loss logs side by side.

    python3 tools/wide_cmb_trajectory.py [--tiers f32,bf16] [--adam 300] [--lbfgs 20]
                                         [--init seeded|prefix] [--out DIR]

Needs one CUDA card and nvcc. The configuration is the one ``chip_smoke.py``
phase 29 trains with CLI ``train``: ``examples/cmb.json`` on ``cli synth``'s
files with ``hidden_width`` 128, Adam cut to ``--adam`` steps, L-BFGS to 20
iterations (25 evaluations; ``--lbfgs``), from the example's seeded weights
(``--init seeded``) or from phase 29's prefix weights (``--init prefix``:
``chip_smoke.cmb_w128_init``, phase 12b's recipe at width 128). For each tier it
runs ``Trainer.train`` twice, with ``fused_kernel`` ``"auto"`` (K2 + K3, or
K2 + K4 at bf16: the wide body) and ``"off"`` (the plain loss under
autograd), and prints per run the totals at a few steps, the first
non-finite total, the largest finite one, and the first step where the two
runs' totals differ by more than 1e-3 and 1e-1 relative. Prints the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tiers", default="f32,bf16")
    parser.add_argument("--adam", type=int, default=300)
    parser.add_argument("--lbfgs", type=int, default=20, help="L-BFGS iterations")
    parser.add_argument("--out", default=None, help="keep the runs' directories here")
    parser.add_argument("--device", default="cuda", help="cpu: a dry run of the plain path")
    parser.add_argument("--init", default="seeded", choices=("seeded", "prefix"))
    args = parser.parse_args()

    import torch

    import chip_smoke
    from pinn_depthestimation_tpu_torch.config import load_config
    from pinn_depthestimation_tpu_torch.training.driver import Trainer
    from pinn_depthestimation_tpu_torch.training.logging_utils import read_log

    if args.device == "cuda" and not torch.cuda.is_available():
        print("wide_cmb_trajectory: needs a CUDA card", file=sys.stderr)
        return 1
    if args.device == "cuda":
        print(chip_smoke.nvidia_smi("name,power.limit"))
    lbfgs = {"max_it": args.lbfgs, "max_evaluation": args.lbfgs + 5, "tolerance_grad": 1e-9,
             "tolerance_change": 1e-12}
    with tempfile.TemporaryDirectory() as tmp:
        root = args.out or tmp
        os.makedirs(root, exist_ok=True)
        synth = os.path.join(root, "synth")
        if chip_smoke.run_cli(["synth", "--out", synth])[0] != 0:
            print("synth failed", file=sys.stderr)
            return 1
        csv, mat = (os.path.join(synth, f) for f in ("input_fid.csv", "input_res.mat"))
        for tier in args.tiers.split(","):
            totals = {}
            for mode in ("auto", "off"):
                cfg_path = chip_smoke.cmb_config(
                    root, REPO, csv, mat, layers={"hidden_width": 128},
                    adam_optimizer={"max_it": args.adam}, kernel_precision=tier,
                    data_residual={"interval_x": 1, "interval_y": 1}, lbfgs_optimizer=lbfgs,
                    fused_kernel=mode)
                run_dir = os.path.join(root, f"cmb_w128_{args.init}_{tier}_{mode}")
                os.makedirs(run_dir, exist_ok=True)
                init = chip_smoke.cmb_w128_init() if args.init == "prefix" else None
                tr = Trainer(load_config(cfg_path), run_dir=run_dir, echo_every=0,
                             initial_params=init, device=torch.device(args.device))
                print(f"{tier} fused_kernel={mode!r}: {tr.kernel_plan}")
                tr.train()
                totals[mode] = read_log(run_dir)[3]
                t = totals[mode]
                bad = next((i + 1 for i, v in enumerate(t) if not math.isfinite(v)), None)
                finite = [v for v in t if math.isfinite(v)]
                marks = {s: t[s - 1] for s in (1, 10, 50, 100, 150, 200, 250, 300, len(t))
                         if s <= len(t)}
                print(f"  {tier} {mode}: {len(t)} evaluations; totals at steps {marks}; first "
                      f"non-finite at evaluation {bad}; largest finite {max(finite):.5e}")
            a, b = totals["auto"], totals["off"]
            for tol in (1e-3, 1e-1):
                fork = next((i + 1 for i, (x, y) in enumerate(zip(a, b))
                             if not (math.isfinite(x) and math.isfinite(y))
                             or abs(x - y) > tol * abs(y)), None)
                print(f"  {tier}: kernels and autograd first differ by more than {tol:g} "
                      f"relative at evaluation {fork}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
