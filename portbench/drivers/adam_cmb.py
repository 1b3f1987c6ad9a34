"""Driver of the CMB pipeline's Adam phase: the port's ``Trainer.train_adam``
on the reference's second configuration (``config_CMB.json``), as CLI
``train`` runs it, with every step after the first replayed from one CUDA
graph.

Set-up makes the survey rows and the FUNWAVE-grid fields from the seed
(``portbench/gen_cmb.py``) and writes them where the program's CMB loader
reads them (a CSV and a ``.mat`` in the run's scratch directory), makes the
weights from the seed, builds one ``Trainer`` from them and drives it
through its first ``check_steps`` Adam steps by ``train_adam``: the first
uncaptured, the graph captured after it, the rest replays. The first
gradient (from Adam's state after step 1), the parameters' change after the
last and the logged loss terms are what the check holds against
``portbench/reference/wave_averaged.py``. Warm-up takes the same Trainer to
the next block boundary; on the card it stops the run with an error naming
the graph unless every warm-up step was a replay (the program's count
``step#replay``), and before anything is built where the program has no
such count, so the cell never times the host's Python in the graph's place.
The window then runs whole blocks of ``block_steps`` steps (each ending in
the log flush and the checkpoint cadence, as the CLI's 1,000-step chunks do)
until ``--seconds`` have passed. ``train_step_ms`` is the window's time over
all its steps.
"""

from __future__ import annotations

import contextlib
import csv
import importlib.util
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch
from scipy.io import savemat

from portbench import gen, gen_cmb


def _sibling(name: str):
    """The driver ``drivers/<name>.py`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(f"portbench_driver_{name}_shared",
                                                  Path(__file__).with_name(f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_ADAM = _sibling("adam")
KEYS = _ADAM.KEYS
NO_GRAPH = ("portbench: cmb-adam times the Adam step replayed from one CUDA graph, and "
            "this program {}")


def port_config(cfg: dict, csv_path: str, mat_path: str) -> dict:
    """The configuration in the port's CMB schema (``examples/cmb.json``),
    its data at ``csv_path`` and ``mat_path``; Adam's ``max_it`` is moved by
    the driver."""
    outs, g, r = list(cfg["outputs"]), cfg["grid"], cfg["residual"]
    coords = {"x": {"requires_grad": ["true"]}, "y": {"requires_grad": ["true"]}}
    return {
        "layers": dict(cfg["layers"], dropout_rate=0.0),
        "adam_optimizer": {"max_it": 0, "learning_rate": cfg["adam"]["learning_rate"],
                           "scheduler_step_size": cfg["adam"]["scheduler_step_size"],
                           "scheduler_gamma": cfg["adam"]["scheduler_gamma"]},
        "lbfgs_optimizer": {"max_it": 0},
        "loss": {k: v for k, v in cfg["loss"].items() if k.startswith("weight_")},
        "data_fidelity": {"file": csv_path, "inputs": ["x", "y"], "outputs": outs,
                          "training_points": cfg["fidelity"]["training_points"]},
        "data_residual": {"file": mat_path, "inputs": coords, "outputs": outs,
                          "snapshots": [1], "interval_x": r["interval"],
                          "interval_y": r["interval"]},
        "data_test": {"file": mat_path, "inputs": coords, "outputs": outs,
                      "nx": (r["nx"] - 1) // r["interval"] + 1,
                      "ny": (r["ny"] - 1) // r["interval"] + 1,
                      **{k: g[k] for k in ("x_min", "x_max", "y_min", "y_max")}},
        "physics": cfg["physics"],
        "parity": cfg["loss"]["parity"],
        "kernel_precision": cfg["precision"],
        "fused_kernel": "on",
    }


def init_params(cfg: dict, seed: int, device) -> dict:
    """Xavier weights from the seed (``gen.init_params``), the ``eta_mean``
    head's bias then raised so that ``eta + h >= 0.5`` at every input: the
    last hidden layer's outputs lie in ``(-1, 1)``, so ``|(w_h + w_eta) . a|``
    is under the 1-norm of ``w_h + w_eta``."""
    params = gen.init_params(cfg["layers"], seed, device)
    h, eta = cfg["outputs"].index("h"), cfg["outputs"].index("eta_mean")
    w, b = params["w_out"], params["b_out"]
    reach = torch.sum(torch.abs(w[:, h] + w[:, eta]))
    b[eta] = torch.clamp(reach + 0.5 - b[h] - b[eta], min=0.0) + b[eta]
    return params


def write_inputs(cfg: dict, seed: int, tmp: str) -> tuple[dict, dict, str, str]:
    """The survey rows and the grid from the seed, written as the loader
    reads them: a CSV (each value in its shortest round-trip form) and a
    ``.mat`` of ``(ny, nx)`` grids."""
    rows, grid = gen_cmb.survey_rows(cfg, seed), gen_cmb.residual_grid(cfg, seed)
    csv_path, mat_path = os.path.join(tmp, "input_fid.csv"), os.path.join(tmp, "input_res.mat")
    with open(csv_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(list(rows))
        for row in zip(*rows.values()):
            writer.writerow([repr(float(v)) for v in row])
    savemat(mat_path, grid)
    return rows, grid, csv_path, mat_path


def setup(ctx):
    cfg, wl = ctx.config, ctx.workload
    from pinn_depthestimation_tpu_torch import tracing

    if ctx.device.type == "cuda" and not hasattr(tracing, "counts"):
        raise SystemExit(NO_GRAPH.format("counts no graph replays (no tracing.counts)"))
    with ctx.span("data"):
        rows, grid, csv_path, mat_path = write_inputs(cfg, ctx.seed, ctx.tmp)
        params0 = init_params(cfg, ctx.seed, ctx.device)
    with ctx.span("import_program"):
        from pinn_depthestimation_tpu_torch.config import parse_config
        from pinn_depthestimation_tpu_torch.ops import cuda_build
        from pinn_depthestimation_tpu_torch.training.driver import Trainer
    if ctx.device.type == "cuda":
        with ctx.span("library"):
            ctx.notes["build_seconds"] = cuda_build.k3_library().build_seconds
    with ctx.span("trainer"):
        run_dir = os.path.join(ctx.tmp, "run")
        os.makedirs(run_dir)
        with contextlib.redirect_stdout(sys.stderr):
            trainer = Trainer(parse_config(port_config(cfg, csv_path, mat_path)),
                              run_dir=run_dir, initial_params=params0, device=ctx.device)
    if ctx.device.type == "cuda" and not getattr(trainer, "graph_step", False):
        raise SystemExit(NO_GRAPH.format("runs it op by op (Trainer.graph_step is false)"))
    n_check = wl["check_steps"]
    with ctx.span("first_steps"):
        _ADAM.advance(trainer, 1)
        beta1 = cfg["adam"]["betas"][0]
        state = trainer.optimizer.state
        grad1 = {k: (float(torch.linalg.vector_norm(state[p]["exp_avg"] / (1 - beta1)))
                     if p in state else 0.0)
                 for k, p in trainer.state.params.items()}
        _ADAM.advance(trainer, n_check)
        change = {k: float(torch.linalg.vector_norm(trainer.state.params[k] - params0[k]))
                  for k in KEYS}
        losses = _ADAM.logged(run_dir, 1, n_check)
    with ctx.span("warmup"):
        first, before = trainer.state.iteration, tracing.counts().get("step#replay", 0)
        _ADAM.advance(trainer, wl["block_steps"] * wl["warmup_blocks"])
        ctx.sync()
        replayed = tracing.counts().get("step#replay", 0) - before
        ctx.notes["warmup_replays"] = replayed
    if ctx.device.type == "cuda" and replayed != trainer.state.iteration - first:
        raise SystemExit(NO_GRAPH.format(
            f"replayed {replayed} of the {trainer.state.iteration - first} warm-up steps"))
    return {"trainer": trainer, "run_dir": run_dir, "rows": rows, "grid": grid,
            "params0": {k: v.detach().clone() for k, v in params0.items()},
            "program": {"losses": losses, "grad1": grad1, "change": change}}


def window(ctx, state, seconds: float) -> dict:
    from pinn_depthestimation_tpu_torch import tracing
    from pinn_depthestimation_tpu_torch.ops import kernels, kernels_vjp

    trainer, block = state["trainer"], ctx.workload["block_steps"]
    first = trainer.state.iteration
    wrappers = {"k2": kernels.mlp_fwd_tangents, "k3": kernels_vjp.packed_mlp_bwd}
    launches = {k: w.launches for k, w in wrappers.items()}
    replays = tracing.counts().get("step#replay", 0)
    t0 = time.perf_counter()
    ends = []
    while True:
        _ADAM.advance(trainer, trainer.state.iteration + block)
        elapsed = time.perf_counter() - t0
        ends.append(elapsed)
        if elapsed >= seconds:
            break
    ctx.notes["block_ms"] = [1e3 * (b - a) for a, b in zip([0.0] + ends, ends)]
    steps = trainer.state.iteration - first
    rows = _ADAM.logged(state["run_dir"], first + 1, trainer.state.iteration)
    replays = tracing.counts().get("step#replay", 0) - replays
    ctx.notes["window_steps"] = steps
    ctx.notes["window_replays"] = replays
    for k, w in wrappers.items():
        ctx.notes[f"{k}_launches_window"] = w.launches - launches[k]
    return {"attempted": steps, "failed": int((~np.isfinite(rows)).any(axis=1).sum()),
            "metrics": {"train_step_ms": elapsed / steps * 1e3},
            "steps": steps, "replays": replays,
            "points": int(trainer.data.residual_input.shape[0]),
            "rows": int(trainer.data.fidelity_input.shape[0]),
            "sizes": list(trainer.spec.sizes)}


def release(ctx, state) -> None:
    _ADAM.release(ctx, state)


def program_side(state) -> dict:
    return state["program"]


def reference_side(ctx, state, precision: str = "f32", half: bool = False) -> dict:
    """The reference's readings from the same weights, rows and grid;
    ``half`` takes the first half of the residual points and of the rows
    only, the means over those (a fault's reading)."""
    ref, cfg = ctx.reference, ctx.config
    batch = ref.cmb_batch(state["rows"], state["grid"], cfg, ctx.device)
    if half:
        batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
    out = ref.adam_steps(state["params0"], batch, cfg["loss"], cfg["adam"],
                         ctx.workload["check_steps"], precision)
    return {"losses": np.asarray(out["losses"]),
            "grad1": {k: float(torch.linalg.vector_norm(v)) for k, v in out["grad1"].items()},
            "change": {k: float(torch.linalg.vector_norm(v)) for k, v in out["change"].items()}}


def compare(prog: dict, ref: dict) -> dict:
    """``loss_gap``, ``grad_gap`` and ``change_gap`` as the flagship's Adam
    cell reads them (``drivers/adam.py``)."""
    return _ADAM.compare(prog, ref)


def check(ctx, state) -> dict:
    gaps = compare(program_side(state), reference_side(ctx, state))
    limits = ctx.workload["limits"]
    return {k: {"value": v, "limit": limits[k]} for k, v in gaps.items()}
