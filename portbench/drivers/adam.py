"""Driver of the Adam phase: the port's ``Trainer.train_adam`` on one
survey, as CLI ``train`` runs it.

Set-up makes the survey's columns from the seed and writes them where the
program's loader reads them (a ``.mat`` in the run's scratch directory),
makes the weights from the seed, builds one ``Trainer`` from them and drives
it through its first ``check_steps`` Adam steps by ``train_adam``, the
window's own call: the first gradient (from Adam's state after step 1),
the parameters' change after the last of them and the logged loss terms
are what the check holds against the reference. Warm-up takes the same
Trainer to the next block boundary; the window then runs whole blocks of
``block_steps`` steps (each ending in the log flush and the checkpoint
cadence, as the CLI's 1,000-step chunks do) until ``--seconds`` have
passed. ``train_step_ms`` is the window's time over all its steps.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import numpy as np
import torch
from scipy.io import savemat

from portbench import gen

KEYS = ("w_in", "b_in", "w_hidden", "b_hidden", "w_out", "b_out")


def port_config(config: dict, mat_path: str) -> dict:
    """The configuration in the port's schema (``examples/newmethod.json``),
    its data at ``mat_path``; Adam's ``max_it`` is moved by the driver."""
    loss, grid = config["loss"], config["grid"]
    return {
        "layers": dict(config["layers"], dropout_rate=0.0),
        "adam_optimizer": {"max_it": 0, "learning_rate": config["adam"]["learning_rate"],
                           "scheduler_step_size": config["adam"]["scheduler_step_size"],
                           "scheduler_gamma": config["adam"]["scheduler_gamma"]},
        "lbfgs_optimizer": {"max_it": 0},
        "loss": {k: loss[k] for k in ("weight_fid_loss", "weight_res_loss",
                                      "weight_U_loss", "weight_V_loss")},
        "data": {"file": mat_path,
                 "inputs": {"x": {"requires_grad": ["true"]}, "y": {"requires_grad": ["true"]}},
                 "trues": ["U", "V"], "unknowns": ["h"]},
        "data_test": {k: grid[k] for k in ("x_min", "x_max", "y_min", "y_max")},
        "physics": config["physics"],
        "parity": loss["parity"],
        "kernel_precision": config["precision"],
        "fused_kernel": "on",
    }


def advance(trainer, to: int) -> None:
    """``train_adam`` until the counter reaches ``to``."""
    import dataclasses

    trainer.config.adam = dataclasses.replace(trainer.config.adam, max_it=to)
    with contextlib.redirect_stdout(sys.stderr):
        trainer.train_adam()


def logged(run_dir: str, first: int, last: int) -> np.ndarray:
    """Rows ``first..last`` of ``log.txt`` as ``(fidelity, residual, total)``."""
    rows = []
    with open(os.path.join(run_dir, "log.txt")) as f:
        next(f)
        for line in f:
            epoch, *terms = line.split(", ")
            if first <= int(epoch) <= last:
                rows.append([float(t) for t in terms])
    return np.asarray(rows)


def setup(ctx):
    cfg, wl = ctx.config, ctx.workload
    with ctx.span("data"):
        columns = gen.survey_columns(cfg["grid"], ctx.seed)
        mat = os.path.join(ctx.tmp, "survey.mat")
        savemat(mat, {k: v.reshape(-1, 1) for k, v in columns.items()})
        params0 = gen.init_params(cfg["layers"], ctx.seed, ctx.device)
    with ctx.span("import_program"):
        from pinn_depthestimation_tpu_torch.config import parse_config
        from pinn_depthestimation_tpu_torch.ops import cuda_build
        from pinn_depthestimation_tpu_torch.training.driver import Trainer
    if ctx.device.type == "cuda":
        with ctx.span("library"):
            ctx.notes["build_seconds"] = cuda_build.k1_library().build_seconds
    with ctx.span("trainer"):
        run_dir = os.path.join(ctx.tmp, "run")
        os.makedirs(run_dir)
        with contextlib.redirect_stdout(sys.stderr):
            trainer = Trainer(parse_config(port_config(cfg, mat)), run_dir=run_dir,
                              initial_params=params0, device=ctx.device)
    n_check = wl["check_steps"]
    with ctx.span("first_steps"):
        advance(trainer, 1)
        beta1 = cfg["adam"]["betas"][0]
        state = trainer.optimizer.state
        grad1 = {k: (float(torch.linalg.vector_norm(state[p]["exp_avg"] / (1 - beta1)))
                     if p in state else 0.0)
                 for k, p in trainer.state.params.items()}
        advance(trainer, n_check)
        change = {k: float(torch.linalg.vector_norm(trainer.state.params[k] - params0[k]))
                  for k in KEYS}
        losses = logged(run_dir, 1, n_check)
    with ctx.span("warmup"):
        block = wl["block_steps"]
        advance(trainer, block * wl["warmup_blocks"])
        ctx.sync()
    return {"trainer": trainer, "run_dir": run_dir, "columns": columns,
            "params0": {k: v.detach().clone() for k, v in params0.items()},
            "program": {"losses": losses, "grad1": grad1, "change": change}}


def window(ctx, state, seconds: float) -> dict:
    from pinn_depthestimation_tpu_torch.ops import kernels_step

    trainer, block = state["trainer"], ctx.workload["block_steps"]
    first = trainer.state.iteration
    launches = getattr(kernels_step.fused_loss_and_grad, "launches", 0)
    t0 = time.perf_counter()
    ends = []
    while True:
        advance(trainer, trainer.state.iteration + block)
        elapsed = time.perf_counter() - t0
        ends.append(elapsed)
        if elapsed >= seconds:
            break
    ctx.notes["block_ms"] = [1e3 * (b - a) for a, b in zip([0.0] + ends, ends)]
    steps = trainer.state.iteration - first
    rows = logged(state["run_dir"], first + 1, trainer.state.iteration)
    ctx.notes["window_steps"] = steps
    ctx.notes["k1_launches_window"] = (getattr(kernels_step.fused_loss_and_grad, "launches", 0)
                                       - launches)
    points = int(trainer.data.residual_input.shape[0])
    return {"attempted": steps, "failed": int((~np.isfinite(rows)).any(axis=1).sum()),
            "metrics": {"train_step_ms": elapsed / steps * 1e3},
            "steps": steps, "points": points, "sizes": list(trainer.spec.sizes)}


def release(ctx, state) -> None:
    del state["trainer"]
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def program_side(state) -> dict:
    return state["program"]


def reference_side(ctx, state, precision: str = "f32", half: bool = False) -> dict:
    """The reference's readings from the same weights and survey; ``half``
    takes the first half of the rows only, the means over those (a fault's
    reading)."""
    ref, cfg = ctx.reference, ctx.config
    batch = ref.survey_batch(state["columns"], cfg["grid"], ctx.device)
    if half:
        batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
    out = ref.adam_steps(state["params0"], batch, cfg["loss"], cfg["adam"],
                         ctx.workload["check_steps"], precision)
    return {"losses": np.asarray(out["losses"]),
            "grad1": {k: float(torch.linalg.vector_norm(v)) for k, v in out["grad1"].items()},
            "change": {k: float(torch.linalg.vector_norm(v)) for k, v in out["change"].items()}}


def compare(prog: dict, ref: dict) -> dict:
    """``loss_gap``: the widest relative gap of a logged loss term over the
    checked steps. ``grad_gap``: the worst leaf's gap between the program's
    norm of the first gradient and the reference's, over the larger of that
    leaf's reference norm and the median leaf's. ``change_gap``: the median
    leaf's relative gap between the norms of the parameters' change after
    the checked steps; the worst leaf's swings with the round-off of single
    gradient entries near zero in the small leaves (``w_in``, ``b_in``),
    which Adam's update turns into whole steps. Leaves whose reference
    gradient is under a thousandth of the median leaf's move by round-off
    alone and are left out of ``change_gap``."""
    if prog["losses"].shape != ref["losses"].shape:
        losses = np.array([np.inf])
    else:
        losses = np.abs(prog["losses"] - ref["losses"]) / np.abs(ref["losses"])
    g_med = float(np.median(list(ref["grad1"].values())))
    grad_gap = max(abs(prog["grad1"][k] - ref["grad1"][k]) / max(ref["grad1"][k], g_med)
                   for k in KEYS)
    moved = [k for k in KEYS if ref["grad1"][k] >= 1e-3 * g_med]
    change_gap = np.median([abs(prog["change"][k] - ref["change"][k]) / ref["change"][k]
                            for k in moved])
    return {"loss_gap": float(np.max(losses)), "grad_gap": float(grad_gap),
            "change_gap": float(change_gap)}


def check(ctx, state) -> dict:
    gaps = compare(program_side(state), reference_side(ctx, state))
    limits = ctx.workload["limits"]
    return {k: {"value": v, "limit": limits[k]} for k, v in gaps.items()}
