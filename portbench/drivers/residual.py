"""Driver of residual evaluation: back-to-back calls of the port's
``ops.kernels.fused_residual_continuity`` (K2 with the continuity epilogue)
on one chip's collocation points.

Set-up makes ``point_sets`` sets of the configuration's points and the
weights from the seed, loads the kernels and calls each set once. The
window issues calls on the sets in turn, keeping at most
``calls_in_flight`` calls ahead of the device, until ``--seconds`` have
passed and the last call has finished; ``residual_points_per_s`` is all
the points over all that time. The outputs of ``sample_calls`` calls drawn
from the seed among the first ``sample_below`` (a window too short for one
takes its last call in its place) and of the window's last call are kept;
the check holds every point of each against the reference.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import gen


def setup(ctx):
    cfg, wl = ctx.config, ctx.workload
    cells = cfg["cells"]
    if cells["nx"] * cells["ny"] != cfg["collocation_points"]:
        raise ValueError("the configuration's cells do not give its collocation points")
    with ctx.span("data"):
        sets = gen.collocation_points(cells, ctx.seed, wl["point_sets"])
        points = [torch.as_tensor(s).to(ctx.device) for s in sets]
        params = gen.init_params(cfg["layers"], ctx.seed, ctx.device)
    with ctx.span("import_program"):
        from pinn_depthestimation_tpu_torch.models import MLPSpec
        from pinn_depthestimation_tpu_torch.ops import cuda_build, kernels
    if ctx.device.type == "cuda":
        with ctx.span("library"):
            ctx.notes["build_seconds"] = cuda_build.k2_library().build_seconds
    layers = cfg["layers"]
    spec = MLPSpec(sizes=(layers["input_features"],)
                   + (layers["hidden_width"],) * layers["hidden_layers"]
                   + (layers["output_features"],), init_type=layers["init_type"])
    with ctx.span("warmup"):
        for p in points:
            fc = kernels.fused_residual_continuity(params, p, spec, precision=cfg["precision"])
        bool(torch.isfinite(fc).all())  # the window's last look, loaded here
        ctx.sync()
    rng = gen.numpy_rng(ctx.seed, 1000)
    sample = sorted(rng.choice(wl["sample_below"], wl["sample_calls"], replace=False).tolist())
    return {"params": params, "points": points, "spec": spec, "sample": sample,
            "kept": {}}


def window(ctx, state, seconds: float) -> dict:
    from pinn_depthestimation_tpu_torch.ops import kernels

    params, points, spec = state["params"], state["points"], state["spec"]
    precision, ahead = ctx.config["precision"], ctx.workload["calls_in_flight"]
    sample, kept = set(state["sample"]), state["kept"]
    cuda = ctx.device.type == "cuda"
    launches = getattr(kernels.fused_residual_continuity, "launches", 0)
    done, calls, fc = [], 0, None
    t0 = time.perf_counter()
    while True:
        fc = kernels.fused_residual_continuity(params, points[calls % len(points)], spec,
                                               precision=precision)
        if calls in sample:
            kept[calls] = fc
        calls += 1
        if cuda:
            event = torch.cuda.Event()
            event.record()
            done.append(event)
            if len(done) > ahead:
                done.pop(0).synchronize()
        if time.perf_counter() - t0 >= seconds:
            break
    ctx.sync()
    elapsed = time.perf_counter() - t0
    kept[calls - 1] = fc
    ctx.notes["window_calls"] = calls
    ctx.notes["k2_launches_window"] = (getattr(kernels.fused_residual_continuity, "launches", 0)
                                       - launches)
    n = int(points[0].shape[0])
    failed = sum(int(not bool(torch.isfinite(v).all())) for v in kept.values())
    return {"attempted": calls, "failed": failed,
            "metrics": {"residual_points_per_s": calls * n / elapsed},
            "calls": calls, "points": n, "sizes": list(spec.sizes)}


def release(ctx, state) -> None:
    """Returns the memory the calls left cached; the kept outputs stay for
    the check."""
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def program_side(state) -> dict:
    return state["kept"]


def reference_side(ctx, state, precision: str = "f32") -> dict:
    """The reference's residual of each kept call's points."""
    n_sets = len(state["points"])
    return {i: ctx.reference.residual(state["params"], state["points"][i % n_sets], precision)
            for i in state["kept"]}


def compare(prog: dict, ref: dict) -> dict:
    """``residual_gap``: over the kept calls, the widest gap of a point's
    residual from the reference's, over the widest reference residual of
    that call."""
    gaps = []
    for i, r in ref.items():
        scale = float(torch.max(torch.abs(r)))
        p = prog.get(i)
        if p is None or p.shape != r.shape:
            gaps.append(np.inf)
            continue
        gaps.append(float(torch.max(torch.abs(p.to(r.device) - r))) / scale)
    return {"residual_gap": float(np.max(np.asarray(gaps)))}


def check(ctx, state) -> dict:
    gaps = compare(program_side(state), reference_side(ctx, state))
    limits = ctx.workload["limits"]
    return {k: {"value": v, "limit": limits[k]} for k, v in gaps.items()}
