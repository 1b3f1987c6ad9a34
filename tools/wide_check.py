"""The wide body's measurement helpers, shared by ``tools/walk_breakdown.py
--wide`` and ``tools/k1_refactor_check.py --wide``.

Builds the wide libraries of a source tree (this package's ``csrc/``, a
patched copy of it, or another commit's files from ``git show
<commit>:pinn_depthestimation_tpu_torch/csrc/<file>``), launches them at the
shapes phase 28 of ``chip_smoke.py`` times (K1 on the 2->[W]x100->3 flagship
at 12,516 points; K3 and K4 on the 2->[W]x10->6 CMB net on the 20,507-point
CMB grid at K = 2; K2 with the continuity epilogue on the flagship's points,
at K = 0 on the 81x261 serving grid and at K = 2 on the CMB grid), and times
two builds in turns (a, b, b, a) with CUDA events and with the device time
``torch.profiler`` records.

Two C interfaces are known: the first wide walk's (the weights
staged from the parameters inside the walk, tiles of a multiple of 4
points) and this tree's (``<kernel>w_image_bytes``: the weight images made
once per launch, its plan in ``ops/wide_plan.py``). A library built from
older sources is launched with the first one, its plan recomputed here from
its own ``<kernel>w_smem`` as that walk's plan did it; one from this tree
goes through the port's launchers.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

TIER_INDEX = {"f32": 0, "bf16": 1, "f32x3": 2}
SOURCES = {"k2": ("mlp_fwd_tangents_wide.cu", ()), "k1": ("continuity_train_step_wide.cu", ()),
           "k3": ("mlp_bwd_wide.cu", ("-DWIDE_REBUILD=0",)),
           "k4": ("mlp_bwd_wide.cu", ("-DWIDE_REBUILD=1",))}
KERNEL_NAME = {"k2": "fwd_kernel", "k1": "k1w_kernel", "k3": "cotangent_kernel",
               "k4": "cotangent_kernel"}


def start_builds(src_dir: str, out_dir: str, kernels, tiers, tag: str) -> dict:
    """Start one ``nvcc`` per (kernel, tier) of the wide sources in
    ``src_dir``; returns what :func:`finish_builds` waits for."""
    from pinn_depthestimation_tpu_torch.ops import cuda_build

    procs = {}
    for kind in kernels:
        source, flags = SOURCES[kind]
        for tier in tiers:
            out = os.path.join(out_dir, f"lib{kind}w_{tag}_{tier}.so")
            cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, *flags,
                   f"-DTIER_ONLY={TIER_INDEX[tier]}", "-o", out, os.path.join(src_dir, source)]
            procs[(tag, kind, tier)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                         stderr=subprocess.STDOUT, text=True), out)
    return procs


def finish_builds(procs: dict, report_registers: bool = False) -> dict:
    """``{(tag, kernel, tier): ctypes.CDLL}``, a library of this tree's
    interface bound as the port binds its own (``argtypes``: a pointer
    passed without them would be cut to 32 bits); prints ptxas's registers
    and spills of each kernel when asked."""
    from pinn_depthestimation_tpu_torch.ops import cuda_build

    binders = {"k2": cuda_build._bind_k2w, "k1": cuda_build._bind_k1w,
               "k3": cuda_build._bind_k34w("k3w"), "k4": cuda_build._bind_k34w("k4w")}
    libs = {}
    for (tag, kind, tier), (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {kind} ({tag}, {tier}):\n{log[-3000:]}")
        if report_registers:
            lines = log.splitlines()
            for i, line in enumerate(lines):
                if "Compiling entry function" in line and "reduce_kernel" not in line:
                    usage = [x.strip() for x in lines[i + 1:i + 4] if "spill" in x or "Used" in x]
                    print(f"ptxas {kind}w {tier} ({tag}): {line.split(chr(39))[1][:70]}...: "
                          f"{'; '.join(usage)}")
        lib = ctypes.CDLL(out)
        libs[(tag, kind, tier)] = binders[kind](lib) if is_current(lib, kind) else lib
    return libs


def copy_sources(src_dir: str, dst_dir: str) -> None:
    os.makedirs(dst_dir, exist_ok=True)
    for f in os.listdir(src_dir):
        if f.endswith((".cu", ".cuh")):
            shutil.copy(os.path.join(src_dir, f), dst_dir)


def is_current(lib, kind: str) -> bool:
    """Whether ``lib`` (one tier's library, whose entries carry the tier's
    suffix, or every tier's) has this tree's C interface."""
    return any(hasattr(lib, f"{kind}w_image_bytes{sfx}") for sfx in ("", "_bf16", "_f32x3"))


# ------------------------------------------------------- the first wide walk

_P, _I = ctypes.c_void_p, ctypes.c_int
_FIRST_ARGS = {"k2": [_P] * 10 + [_I] * 10 + [_P], "k1": [_P] * 14 + [_I] * 9 + [_P],
              "k3": [_P] * 12 + [_I] * 10 + [_P], "k4": [_P] * 12 + [_I] * 10 + [_P]}
_FIRST_ENTRY = {"k2": "k2w_mlp_fwd_tangents", "k1": "k1w_train_step", "k3": "k3w_mlp_bwd",
               "k4": "k4w_mlp_bwd"}


def _sfx(tier: str) -> str:
    return "" if tier == "f32" else f"_{tier}"


def first_plan(lib, kind: str, tier: str, n: int, spec, kt: int, sms: int,
              smem_limit: int = 232_448) -> dict:
    """The first wide walk's plan: the largest tile (a multiple of 4, at most
    256) whose shared memory (the library's ``<kernel>w_smem``) fits, cut to
    one call's points spread over the SMs; ``min(tiles, SMs)`` blocks."""
    smem = getattr(lib, f"{kind}w_smem{_sfx(tier)}")
    smem.restype = ctypes.c_int
    W, d_in, d_out = spec.width, spec.d_in, spec.d_out

    def nbytes(tile):
        return smem(W, d_in, tile) if kind == "k1" else smem(W, d_in, d_out, kt, tile)

    top = next(t for t in range(256, 0, -4) if nbytes(t) <= smem_limit)
    tile = max(4, min(top, (-(-n // sms) + 3) // 4 * 4))
    tiles = -(-n // tile)
    n_stack = spec.n_hidden - 1
    c = max(1, min(8, n_stack)) if kind == "k4" else 1
    slots = {"k2": 0, "k4": -(-n_stack // c) + c}.get(kind, n_stack + 1)
    return {"tile": tile, "tiles": tiles, "grid": min(tiles, sms), "smem": nbytes(tile),
            "ckpt": c, "slots": slots, "blocks_per_sm": 1}


def first_launch(lib, kind: str, tier: str, params, spec, *, x, kt=2, batch=None, ybar=None,
                dybar=None, y=None, dy=None, fc=None, plan=None):
    """One launch of a first-walk wide library (and its reduction for a walk);
    returns the flat result of a walk."""
    import torch

    from pinn_depthestimation_tpu_torch.ops import kernels_step

    fn = getattr(lib, _FIRST_ENTRY[kind] + _sfx(tier))
    fn.argtypes, fn.restype = _FIRST_ARGS[kind], ctypes.c_int
    dev, n = x.device, x.shape[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = plan or first_plan(lib, kind, tier, n, spec, kt, sms)
    w = [params[k].data_ptr() for k in ("w_in", "b_in", "w_hidden", "b_hidden", "w_out", "b_out")]
    act = 0 if spec.init_type == "xavier" else 1
    stream = torch.cuda.current_stream(dev).cuda_stream
    L = spec.n_hidden - 1
    wp = (spec.width + 3) // 4 * 4
    out = None
    if kind == "k2":
        err = fn(x.data_ptr(), *w, y.data_ptr() if y is not None else None,
                 dy.data_ptr() if dy is not None else None, fc.data_ptr() if fc is not None else None,
                 n, spec.d_in, spec.d_out, L, kt, act, int(fc is not None), spec.width,
                 plan["grid"], plan["tile"], stream)
    else:
        n_ent = kernels_step.n_flat(spec) + (kernels_step.N_STATS if kind == "k1" else 0)
        partial = torch.empty((plan["grid"], n_ent), device=dev)
        states = torch.empty((plan["grid"] * plan["slots"] * (1 + kt) * wp * plan["tile"],),
                             device=dev)
        out = torch.empty((n_ent,), device=dev)
        if kind == "k1":
            b = batch
            err = fn(b.coords.data_ptr(), b.trues.data_ptr(), b.sel.data_ptr(), b.mask.data_ptr(),
                     b.scal.data_ptr(), *w, partial.data_ptr(), states.data_ptr(),
                     out.data_ptr(), n, spec.d_in, L, b.n_true, int(b.has_anchor), act,
                     spec.width, plan["grid"], plan["tile"], stream)
        else:
            err = fn(x.data_ptr(), ybar.data_ptr(), dybar.data_ptr() if kt else None, *w,
                     partial.data_ptr(), states.data_ptr(), out.data_ptr(), n, spec.d_in,
                     spec.d_out, L, kt, act, plan["ckpt"], spec.width, plan["grid"],
                     plan["tile"], stream)
    if err:
        raise RuntimeError(f"{kind} (first wide walk) launch failed: CUDA error {err}")
    return out


# ------------------------------------------------------------ either build

def current_launch(lib, kind: str, tier: str, params, spec, *, x, kt=2, batch=None, ybar=None,
                   dybar=None, y=None, dy=None, fc=None):
    """One launch of a library with this tree's interface, through the
    port's launchers."""
    from pinn_depthestimation_tpu_torch.ops import kernels, kernels_step, kernels_vjp

    if kind == "k2":
        kernels._launch_k2_wide(params, x, spec, kt, tier, epilogue=fc is not None, y=y, dy=dy,
                                fc=fc, lib=lib)
        return None
    if kind == "k1":
        return kernels_step._launch_k1_wide(params, batch, spec, tier, lib=lib)
    return kernels_vjp._launch_wide(kind, params, x, ybar, dybar, spec, kt, tier, lib=lib)


def launch(lib, kind: str, tier: str, params, spec, **kw):
    """One launch of ``lib`` (either interface)."""
    if is_current(lib, kind):
        return current_launch(lib, kind, tier, params, spec, **kw)
    return first_launch(lib, kind, tier, params, spec, **kw)


def plan_of(lib, kind: str, tier: str, n: int, spec, kt: int, dev) -> dict:
    """Tile, tiles, blocks, blocks per SM and shared bytes of one launch."""
    import torch

    if is_current(lib, kind):
        from pinn_depthestimation_tpu_torch.ops import wide_plan

        p = wide_plan.card_plan(kind, n, spec, kt, tier, dev)
        return {"tile": p.tile, "tiles": p.tiles, "grid": p.grid, "smem": p.smem,
                "blocks_per_sm": wide_plan.BLOCKS_PER_SM}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return first_plan(lib, kind, tier, n, spec, kt, sms)


def path_cases(dev, widths=(64, 128)) -> list:
    """Phase 28's path shapes: ``[(label, kind, kt, spec, params, kwargs)]``
    for K1, K3, K4 and K2 at each width of ``widths``."""
    import tempfile

    import numpy as np
    import torch

    import chip_smoke
    from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy
    from pinn_depthestimation_tpu_torch.ops import kernels_step

    rng = np.random.RandomState(28)
    with tempfile.TemporaryDirectory() as tmp:
        _, _, res_pts, _ = chip_smoke.cmb_bench_points(dev, tmp)
    n_flag, n_grid, n_res = 12_516, 81 * 261, res_pts.shape[0]
    grid = torch.as_tensor(rng.uniform(-1, 1, (n_grid, 2)).astype(np.float32)).to(dev)
    cases = []
    for W in widths:
        flag = MLPSpec(sizes=(2,) + (W,) * 100 + (3,))
        cmb = MLPSpec(sizes=(2,) + (W,) * 10 + (6,))
        fp = params_from_numpy(chip_smoke.numpy_params(flag.sizes, "xavier", 29), dev)
        cp = params_from_numpy(chip_smoke.numpy_params(cmb.sizes, "xavier", 29), dev)
        x = torch.as_tensor(rng.uniform(-1, 1, (n_flag, 2)).astype(np.float32)).to(dev)
        tr = torch.as_tensor((rng.randn(n_flag, 2) * 0.1).astype(np.float32)).to(dev)
        b = kernels_step.make_step_batch(x, tr, (x[:, 0] < 0.3).float(),
                                         torch.ones(n_flag, device=dev), [1.0, 1.0], 2, 1.0, 1.0,
                                         anchor_depth=0.75, has_anchor=True)
        ybar = torch.as_tensor(rng.randn(n_res, 6).astype(np.float32)).to(dev)
        dybar = torch.as_tensor(rng.randn(2, n_res, 6).astype(np.float32)).to(dev)
        fc = torch.empty(n_flag, device=dev)
        y_grid = torch.empty(n_grid, 3, device=dev)
        y_cmb, dy_cmb = torch.empty(n_res, 6, device=dev), torch.empty(2, n_res, 6, device=dev)
        sizes = lambda s: f"{s.sizes[0]}->[{W}]x{s.n_hidden}->{s.d_out}"  # noqa: E731
        cases += [
            (f"K1 {sizes(flag)}, {n_flag} points", "k1", 2, flag, fp, {"x": x, "batch": b}),
            (f"K3 {sizes(cmb)}, {n_res} points, K=2", "k3", 2, cmb, cp,
             {"x": res_pts, "ybar": ybar, "dybar": dybar}),
            (f"K4 {sizes(cmb)}, {n_res} points, K=2", "k4", 2, cmb, cp,
             {"x": res_pts, "ybar": ybar, "dybar": dybar}),
            (f"K2 {sizes(flag)} epilogue, {n_flag} points", "k2", 2, flag, fp,
             {"x": x, "fc": fc}),
            (f"K2 {sizes(flag)} K=0, {n_grid} points", "k2", 0, flag, fp,
             {"x": grid, "y": y_grid}),
            (f"K2 {sizes(cmb)} K=2, {n_res} points", "k2", 2, cmb, cp,
             {"x": res_pts, "y": y_cmb, "dy": dy_cmb}),
        ]
    return cases


def time_in_turns(calls: dict, order, reps: int, inner: int, kernel: str) -> dict:
    """``{who: ([events ms], [device ms])}`` over ``order`` (for example
    a, b, b, a): CUDA events (median of ``reps`` x ``inner`` calls) and the
    profiler's device time of ``kernel`` and the walk's reduction."""
    import chip_smoke

    out = {who: ([], []) for who in calls}
    for who in order:
        fn = calls[who]
        out[who][0].append(chip_smoke.cuda_ms(fn, reps, inner))
        d = chip_smoke.device_ms(fn, inner, kernel)
        out[who][1].append(float("nan") if d is None else d)
    return out


def mean(v) -> float:
    return sum(v) / len(v)
