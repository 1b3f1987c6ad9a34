#!/usr/bin/env python3
"""The float64 polish of ``examples/deep_f64.json`` from the point its f32
phases end at, iteration by iteration: which curvature pairs it stores.

    python3 tools/polish_witness.py --out DIR [--params NPZ]
        [--devices cuda,cpu] [--evals 100]

Without ``--params`` it first trains the example's f32 phases (2,000 Adam
steps through K1, then the f32 L-BFGS phase) through CLI ``train
--f64-polish 0`` on the card, on the synthetic 81x261 grid of
``chip_smoke.py`` (12,516 points), and keeps the f32 parameters they end
at as ``DIR/f32_end.npz``. Then, on each of ``--devices``, it runs the
example's polish (its ``f64_polish`` block, ``backend`` set to the device)
from those parameters for at most ``--evals`` float64 evaluations, no Adam
and no f32 L-BFGS before it.

For every iteration after the first it prints, as the optimizer decides it,
the curvature pair ``s = t d``, ``y = g - g_prev``: ``s.y``, ``|s|``,
``|y|``, the floor ``max(1e-10, curvature_guard |s| |y|)`` and whether the
pair was stored, with the loss, the step ``t`` and ``max|g|`` after it;
then the pairs held at the end, how many iterations the absolute floor and
the angle guard each turned a pair away, and the loss at the start and the
end. The last line is one JSON object of those numbers per device.
Needs a CUDA card for the f32 phases and for ``cuda`` in ``--devices``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def grid(out: str) -> str:
    from pinn_depthestimation_tpu_torch.utils import synthetic

    mat = os.path.join(out, "grid_0408.mat")
    if not os.path.exists(mat):
        synthetic.make_newmethod_mat(mat, nx=81, ny=261, nan_fraction=0.408, seed=21)
    return mat


def example(out: str) -> dict:
    with open(os.path.join(REPO, "examples", "deep_f64.json")) as f:
        raw = json.load(f)
    raw["data"]["file"] = raw["data_test"]["file"] = grid(out)
    return raw


def train_f32_phases(out: str) -> str:
    """CLI ``train --f64-polish 0`` on the card; returns the f32 end point."""
    from pinn_depthestimation_tpu_torch import cli

    path = os.path.join(out, "deep_f64.json")
    with open(path, "w") as f:
        json.dump(example(out), f)
    run = os.path.join(out, "runs")
    shutil.rmtree(run, ignore_errors=True)
    rc = cli.main(["train", "--config", path, "--log-root", run, "--run-name", "f32",
                   "--device", "cuda", "--f64-polish", "0"])
    if rc != 0:
        raise SystemExit(f"CLI train exited {rc}")
    end = os.path.join(out, "f32_end.npz")
    shutil.copyfile(os.path.join(run, "f32", "model.npz"), end)
    return end


def polish(out: str, params_path: str, device: str, evals: int) -> dict:
    import numpy as np
    import torch

    from pinn_depthestimation_tpu_torch.config import parse_config
    from pinn_depthestimation_tpu_torch.models.mlp import PARAM_KEYS
    from pinn_depthestimation_tpu_torch.optim import lbfgs as lbfgs_mod
    from pinn_depthestimation_tpu_torch.training import checkpoint as ckpt_mod
    from pinn_depthestimation_tpu_torch.training.driver import Trainer
    from pinn_depthestimation_tpu_torch.training.logging_utils import read_log

    raw = example(out)
    raw["adam_optimizer"]["max_it"] = 0
    raw["lbfgs_optimizer"].update(max_it=0, max_evaluation=0)
    raw["f64_polish"].update(max_evaluation=evals, backend="cpu" if device == "cpu" else "default")
    saved = ckpt_mod.load_raw(params_path)
    init = {k: np.asarray(saved[k], np.float32) for k in PARAM_KEYS}
    run = os.path.join(out, "runs", f"polish_{device}")
    shutil.rmtree(run, ignore_errors=True)
    os.makedirs(run)
    tr = Trainer(parse_config(raw), run_dir=run, echo_every=0, initial_params=init,
                 device=device)

    guard = lbfgs_mod.LBFGSOptions.curvature_guard
    tally = {"stored": 0, "absolute_floor": 0, "angle_guard": 0}
    real_step = lbfgs_mod.LBFGSRunner._step

    def step(runner, state):
        line = None
        if state.n_iter > 0:
            y = state.g - state.prev_g
            s = state.d * float(state.t)
            ys, sn, yn = (float(v) for v in (torch.dot(y, s), torch.linalg.norm(s),
                                             torch.linalg.norm(y)))
            floor = max(1e-10, guard * sn * yn)
            kept = ys > floor
            why = "stored" if kept else ("absolute_floor" if 1e-10 >= guard * sn * yn
                                         else "angle_guard")
            tally[why] += 1
            line = f"s.y {ys:.3e} |s| {sn:.3e} |y| {yn:.3e} floor {floor:.3e} {why}"
        real_step(runner, state)
        if line is not None and (state.n_iter <= 30 or state.n_iter % 25 == 0):
            print(f"  [{device}] it {state.n_iter} evals {state.func_evals} {line}; "
                  f"f {state.f:.12e} t {float(state.t):.3e} max|g| "
                  f"{float(state.g.abs().max()):.3e} pairs {state.num}", flush=True)

    lbfgs_mod.LBFGSRunner._step = step
    try:
        tr.train()
    finally:
        lbfgs_mod.LBFGSRunner._step = real_step
    state = tr._live_lbfgs64_state
    _, _, _, totals = read_log(run)
    summary = {"device": device, "evaluations": int(state.func_evals),
               "iterations": int(state.n_iter), "pairs_at_end": int(state.num),
               "restarts": int(state.restarts), "stop": tr.polish_stop_reason,
               "f_first_row": float(totals[0]), "f_end": float(state.f), **tally}
    print(f"  [{device}] {summary}", flush=True)
    return summary


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", required=True, help="working directory")
    parser.add_argument("--params", default=None,
                        help=".npz of f32 parameters (default: train the f32 phases)")
    parser.add_argument("--devices", default="cuda,cpu")
    parser.add_argument("--evals", type=int, default=100)
    args = parser.parse_args()
    os.makedirs(args.out, exist_ok=True)
    params = args.params or train_f32_phases(args.out)
    rows = [polish(args.out, params, d, args.evals) for d in args.devices.split(",")]
    print(json.dumps({"polish_witness": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
