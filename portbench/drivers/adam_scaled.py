"""Driver of the Adam phase at the scaled size: the port's
``Trainer.train_adam`` on one chip's share of the scaled bathymetry run
(all 1,250,000 points a step, full batch, ``continuity_only`` with the depth
anchor, K1), in blocks of ``block_steps`` steps each ending in the log flush.

Set-up draws one point in each cell of the configuration's grid over the
survey's domain (the points of ``gen.collocation_points``, kept raw here),
with the flagship's analytic ``U``, ``V`` at each (``gen.plane_fields``), no
row masked, and writes them where the program's newmethod loader reads
them; the rest is ``drivers/adam.py``'s: the weights from the seed, one
Trainer, its first ``check_steps`` steps by ``train_adam`` (what the check
holds), warm-up to the next block boundary, then whole blocks until
``--seconds`` have passed. The configuration holds the net and the points;
the workload the optimizer and the loss settings, the flagship's.

The reference is ``portbench/reference/continuity_only.py`` taken in blocks
of ``reference_block`` points: each loss term is a ratio of sums, so each
block's sums (the squared residual, the anchor's squared gaps and its
count, the fidelity's squared errors) and the gradients of its share of the
total are added up over the blocks, and Adam written out as the reference
writes it.
"""

from __future__ import annotations

import contextlib
import importlib.util
import math
import os
import sys
from pathlib import Path

import numpy as np
import torch
from scipy.io import savemat

from portbench import gen


def _sibling(name: str):
    """The driver ``drivers/<name>.py`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(f"portbench_driver_{name}_shared",
                                                  Path(__file__).with_name(f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_ADAM = _sibling("adam")
KEYS = _ADAM.KEYS
BOUNDS = ("x_min", "x_max", "y_min", "y_max")


def run_config(ctx) -> dict:
    """The configuration with the workload's Adam and loss settings and the
    cells' bounds as the survey's grid (``drivers/adam.py``'s keys)."""
    cfg, wl = ctx.config, ctx.workload
    return {**cfg, "adam": wl["adam"], "loss": wl["loss"],
            "grid": {k: cfg["cells"][k] for k in BOUNDS}}


def survey_columns(cells: dict, seed: int) -> dict:
    """Columns ``x, y, U, V`` (float64): one uniform point in each cell of
    the ``nx x ny`` grid, as ``gen.collocation_points`` draws its first
    set, and the analytic currents there."""
    nx, ny = cells["nx"], cells["ny"]
    ix, iy = np.meshgrid(np.arange(nx), np.arange(ny))
    ix, iy = ix.reshape(-1), iy.reshape(-1)
    jitter = gen.numpy_rng(seed, 1).random((ix.shape[0], 2))
    x = cells["x_min"] + (ix + jitter[:, 0]) * (cells["x_max"] - cells["x_min"]) / nx
    y = cells["y_min"] + (iy + jitter[:, 1]) * (cells["y_max"] - cells["y_min"]) / ny
    f = gen.plane_fields(x, y)
    return {"x": x, "y": y, "U": f["U"], "V": f["V"]}


def setup(ctx):
    cfg, wl = run_config(ctx), ctx.workload
    with ctx.span("data"):
        columns = survey_columns(cfg["cells"], ctx.seed)
        if columns["x"].shape[0] != cfg["collocation_points"]:
            raise SystemExit("portbench: the cells do not hold the configuration's points")
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
        raw = _ADAM.port_config(cfg, mat)
        raw["data"]["trues"] = ["U", "V"]
        raw["data"]["unknowns"] = ["h"]
        with contextlib.redirect_stdout(sys.stderr):
            trainer = Trainer(parse_config(raw), run_dir=run_dir, initial_params=params0,
                              device=ctx.device)
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
        _ADAM.advance(trainer, wl["block_steps"] * wl["warmup_blocks"])
        ctx.sync()
    return {"trainer": trainer, "run_dir": run_dir, "columns": columns,
            "params0": {k: v.detach().clone() for k, v in params0.items()},
            "program": {"losses": losses, "grad1": grad1, "change": change}}


def window(ctx, state, seconds: float) -> dict:
    return _ADAM.window(ctx, state, seconds)


def release(ctx, state) -> None:
    _ADAM.release(ctx, state)


def program_side(state) -> dict:
    return state["program"]


def blocked_loss_and_grad(ref, params, coords, trues, loss: dict, block: int,
                          precision: str):
    """``(fidelity, residual, total)`` and the gradient of ``total``, from
    ``ref`` (the continuity reference) in blocks of ``block`` points: each
    block's sums, and the gradient of its share of the total, added up.
    With ``parity`` every point is anchored, as ``ref.loss_terms`` reads the
    published code."""
    if not loss["parity"]:
        raise ValueError("the reference follows the published (parity) anchor only")
    n = coords.shape[0]
    leaves = {k: params[k].detach().requires_grad_() for k in KEYS}
    sums = {"fc": 0.0, "anchor": 0.0, "n_sel": 0.0, "U": 0.0, "V": 0.0}
    grads = {k: torch.zeros_like(params[k]) for k in KEYS}
    n_sel = float((coords[:, 0] < loss["anchor_threshold"]).sum())
    for i in range(0, n, block):
        c, t = coords[i:i + block], trues[i:i + block]
        with torch.enable_grad():
            y, dy = ref.forward_with_tangents(leaves, c, precision)
            fc = ref.continuity(y, dy)
            sel = c[:, 0] < loss["anchor_threshold"]
            part = {"fc": torch.sum(fc * fc),
                    "anchor": torch.sum((y[sel, 2] - loss["anchor_depth"]) ** 2),
                    "U": torch.sum((y[:, 0] - t[:, 0]) ** 2),
                    "V": torch.sum((y[:, 1] - t[:, 1]) ** 2)}
            share = (loss["weight_res_loss"] * (part["fc"] / n + part["anchor"] / n_sel)
                     + loss["weight_fid_loss"] * (loss["weight_U_loss"] * part["U"] / n
                                                  + loss["weight_V_loss"] * part["V"] / n))
            g = torch.autograd.grad(share, [leaves[k] for k in KEYS])
        for k, gk in zip(KEYS, g):
            grads[k] += gk
        for k, v in part.items():
            sums[k] += float(v.detach())
    fidelity = (loss["weight_U_loss"] * sums["U"] / n + loss["weight_V_loss"] * sums["V"] / n)
    residual = sums["fc"] / n + sums["anchor"] / n_sel
    total = loss["weight_fid_loss"] * fidelity + loss["weight_res_loss"] * residual
    return (fidelity, residual, total), grads


def reference_side(ctx, state, precision: str = "f32", half: bool = False) -> dict:
    """The reference's readings from the same weights and points, in
    blocks; ``half`` takes the first half of the points only, the means over
    those (a fault's reading)."""
    ref, cfg = ctx.reference, run_config(ctx)
    batch = ref.survey_batch(state["columns"], cfg["grid"], ctx.device)
    coords, trues = batch["coords"], batch["trues"]
    if half:
        coords, trues = coords[: coords.shape[0] // 2], trues[: trues.shape[0] // 2]
    lr, (b1, b2), eps = (cfg["adam"]["learning_rate"], cfg["adam"]["betas"],
                         cfg["adam"]["eps"])
    p = {k: state["params0"][k].detach().clone() for k in KEYS}
    m = {k: torch.zeros_like(p[k]) for k in KEYS}
    v = {k: torch.zeros_like(p[k]) for k in KEYS}
    losses, grad1 = [], None
    with ref._TrueF32():
        for step in range(1, ctx.workload["check_steps"] + 1):
            terms, g = blocked_loss_and_grad(ref, p, coords, trues, cfg["loss"],
                                             ctx.workload["reference_block"], precision)
            losses.append(terms)
            grad1 = grad1 or {k: float(torch.linalg.vector_norm(g[k])) for k in KEYS}
            with torch.no_grad():
                bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
                for k in KEYS:
                    m[k] = b1 * m[k] + (1 - b1) * g[k]
                    v[k] = b2 * v[k] + (1 - b2) * g[k] * g[k]
                    denom = v[k].sqrt() / math.sqrt(bc2) + eps
                    p[k] = p[k] - (lr / bc1) * m[k] / denom
    change = {k: float(torch.linalg.vector_norm(p[k] - state["params0"][k])) for k in KEYS}
    return {"losses": np.asarray(losses), "grad1": grad1, "change": change}


def compare(prog: dict, ref: dict) -> dict:
    """``loss_gap``, ``grad_gap`` and ``change_gap`` as the flagship's Adam
    cell reads them (``drivers/adam.py``)."""
    return _ADAM.compare(prog, ref)


def check(ctx, state) -> dict:
    gaps = compare(program_side(state), reference_side(ctx, state))
    limits = ctx.workload["limits"]
    return {k: {"value": v, "limit": limits[k]} for k, v in gaps.items()}
