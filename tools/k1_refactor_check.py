#!/usr/bin/env python3
"""Hold the kernels of this tree against another build of their sources, and
time both builds.

    python3 tools/k1_refactor_check.py --other-dir OLD_CSRC [--tiers f32,bf16,f32x3]
                                       [--kernels k2,k1,k3,k4] [--exact k2:f32] [--time]
    python3 tools/k1_refactor_check.py --wide --other-dir OLD_CSRC [--tiers ...]
                                       [--kernels k1,k3,k4,k2] [--exact k1,k2:f32]
                                       [--time] [--widths 64,128]

Needs one CUDA card and nvcc. ``OLD_CSRC`` holds another version of the
kernels' sources (for example those of a parent commit:
``mlp_fwd_tangents.cu``, ``continuity_train_step.cu``, ``mlp_bwd.cu``,
``mlp_bwd_rebuild.cu`` and the headers they include, from ``git show
<commit>:pinn_depthestimation_tpu_torch/csrc/<file>``). The tool builds them
into a temporary directory with the port's own nvcc flags, one ``nvcc`` per
kernel, width and tier, started together with the port's own build, then
runs the cases of ``chip_smoke.py``'s phases 3 (K2), 7 (K1) and 11 (K3, and
K4 on the same cases) through this tree's launchers and through the other
build, at each tier of ``--tiers``, and compares K2's y, dy and continuity
residual, K1's flat result (every gradient and the loss statistics), and
K3's and K4's flat gradients. ``--exact`` names the kernels, or
``kernel:tier`` pairs, that must give the same bits (by default K2 at
f32); the others are held to ``chip_smoke.py``'s tolerances: at f32
max|ours - theirs| <= 1e-4 x max|theirs| + 1e-7, at bf16 and f32x3
``compare_tier`` with the other build in the plain tier version's place
(two valid summation orders of one function). The other build's walk must
take its tile per launch (the lane-pair walk), and its K2's bf16 and f32x3
entries their launch plan (``k2_mma_rows``: the tensor-core body). A K2
whose f32 entry takes no plan (no ``k2_f32_threads``: sources before the
f32 body took lanes a point) is launched with that entry's own arguments.
K2's cases are phase 3's (``chip_smoke.k2_cases`` and
``chip_smoke.k2_ragged_cases``: ragged point counts, the serving grid, the
legacy shape, a stack in several chunks) and the 10M-point residual; at
f32 each is also launched at every lane count the f32 body takes (one and
two lanes a point, ``ops/k2_plan.py::F32_LANES``, forced through the plan)
and held to the other build the same way. ``--kernels`` limits the check to kernels the other sources have,
and only those kernels of this tree are built.

``--time`` also times both builds in turns (other, ours, ours, other), with
CUDA events and with the device time ``torch.profiler`` records
(``chip_smoke.device_ms``): K1 on the flagship's 12,516 grid points and K3
on the 20,507-point CMB grid at K=2, at each tier of ``--tiers``; K3 and K4
at the flagship (K=2) and on the CMB grid, at each tier; K3 and K4 at the legacy
shape (``examples/legacy.json``'s 5->[20]x20->4 net at K=3 on the 26,691
points of ``cli synth --legacy --nx 41 --ny 31``, :func:`legacy_case`), at
each tier; K2 at each tier: the
continuity residual at 10M points, the 21,141-point serving grid (K=0), the
CMB grid (K=2), the CMB net's 200 fidelity rows (K=0) and the legacy shape
(K=3), with this build's plan (at f32 the lanes a point, blocks and warps). It prints each time with the card's name and power
limit, then a table of the means with the ratio. Exits 1 if a check fails
or a build fails.

``--wide`` does the same for the wide body (``csrc/mlp_wide.cuh`` and its
three sources; ``tools/wide_check.py`` builds the other sources, launches
either interface, the first wide walk's too, and makes the cases): K1, K3,
K4 and K2 at phase 28's path shapes of ``chip_smoke.py`` for each W of
``--widths`` (K1 and the K2 epilogue on the 2->[W]x100->3 flagship at
12,516 points, K2 at K = 0 on the 81x261 grid, K3, K4 and K2 at K = 2 on
the 2->[W]x10->6 CMB net and the 20,507-point CMB grid), each held to the
other build by the tolerances above (``--exact`` kernels or ``kernel:tier``
pairs bit for bit), and with ``--time`` timed in turns
(other, ours, ours, other) beside the plain version, each with its plan
(tile, tiles, rounds, blocks per SM).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import glob
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

TIER_INDEX = {"f32": 0, "bf16": 1, "f32x3": 2}


def start_build(other_dir: str, tmp: str, widths: dict[str, set[int]], tiers) -> dict:
    """Start one nvcc per (kernel, width, tier) of the other sources; returns
    what :func:`finish_build` waits for."""
    from pinn_depthestimation_tpu_torch.ops import cuda_build

    src_dir = os.path.join(tmp, "src")
    os.makedirs(src_dir)
    for f in glob.glob(os.path.join(other_dir, "*.cu")) + glob.glob(os.path.join(other_dir, "*.cuh")):
        shutil.copy(f, src_dir)
    sources = {"k2": (cuda_build.K2_SOURCE, "K2_WIDTH"), "k1": (cuda_build.K1_SOURCE, "K1_WIDTH"),
               "k3": (cuda_build.K3_SOURCE, "K3_WIDTH"), "k4": (cuda_build.K4_SOURCE, "K4_WIDTH")}
    procs = {}
    for kind, ws in widths.items():
        source, macro = sources[kind]
        for w in sorted(ws):
            for tier in tiers:
                out = os.path.join(tmp, f"lib{kind}_other_{w}_{tier}.so")
                cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, f"-D{macro}={w}",
                       f"-DTIER_ONLY={TIER_INDEX[tier]}", "-o", out, os.path.join(src_dir, source)]
                procs[(kind, w, tier)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                           stderr=subprocess.STDOUT, text=True), out)
    return procs


def finish_build(procs: dict) -> dict:
    """The other build's libraries ``{(kernel, width): library}``, one
    library per width answering every tier, as the port's are."""
    from pinn_depthestimation_tpu_torch.ops import cuda_build

    binders = {"k2": cuda_build._bind_k2, "k1": cuda_build._bind_k1,
               "k3": cuda_build._bind_k3, "k4": cuda_build._bind_k4}
    per = {}
    for (kind, w, tier), (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the other {kind} at width {w}, {tier}:\n"
                               f"{log[-3000:]}")
        lib = binders[kind](ctypes.CDLL(out))
        if kind == "k2" and tier == "f32" and not hasattr(lib, "k2_f32_threads"):
            # an f32 entry without a launch plan: pointers, shapes, mode, stream
            lib.k2_mlp_fwd_tangents.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
                ctypes.c_void_p]
        per.setdefault((kind, w), []).append(lib)
    return {key: cuda_build.WidthLibrary(libs) for key, libs in per.items()}


def launch_k2(lib, params, x, spec, kt: int, precision: str, *, epilogue: bool,
              lanes: int | None = None, **out):
    """One K2 launch from ``lib`` into ``out`` (``y``/``dy`` or ``fc``),
    through the port's launcher (``lanes``: forced into the f32 plan), or
    with the f32 entry's own arguments where it takes no plan."""
    import torch

    from pinn_depthestimation_tpu_torch.ops import kernels

    if precision == "f32" and not hasattr(lib, "k2_f32_threads"):
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        err = lib.k2_mlp_fwd_tangents(
            ptr(x), *(ptr(params[k]) for k in ("w_in", "b_in", "w_hidden", "b_hidden",
                                                "w_out", "b_out")),
            ptr(out.get("y")), ptr(out.get("dy")), ptr(out.get("fc")), x.shape[0], spec.d_in,
            spec.d_out, spec.n_hidden - 1, kt, kernels._ACT[spec.init_type], int(epilogue),
            torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"the other K2-f32 launch failed: CUDA error {err}")
        return
    kernels._launch_k2_narrow(params, x, spec, kt, precision, epilogue=epilogue, lib=lib,
                              lanes=lanes, **out)


def f32_plan_of(lib, x, spec, kt: int) -> str:
    """This build's K2-f32 plan of one launch, for the log."""
    from pinn_depthestimation_tpu_torch.ops import k2_plan

    p = k2_plan.card_f32_plan(lib, x.shape[0], spec.width, spec.n_hidden - 1, kt, x.device)
    return (f"lanes {p.lanes}, {p.grid} blocks x {p.warps} warps, {p.rounds} rounds, "
            f"chunk {p.chunk} x {p.slots} slots")


def launch_k1(lib, params, b, spec, precision: str = "f32"):
    """K1's flat result from ``lib``."""
    from pinn_depthestimation_tpu_torch.ops import kernels_step

    return kernels_step._launch_k1(params, b, spec, lib=lib, precision=precision)


def launch_k3(lib, params, x, ybar, dybar, spec, kt: int, precision: str = "f32"):
    """K3's flat gradients from ``lib``."""
    from pinn_depthestimation_tpu_torch.ops import kernels_vjp

    return kernels_vjp._launch_k3(params, x, ybar, dybar, spec, kt, precision, lib=lib)


def launch_k4(lib, params, x, ybar, dybar, spec, kt: int, precision: str = "f32"):
    """K4's flat gradients from ``lib`` at its planned segment length."""
    from pinn_depthestimation_tpu_torch.ops import kernels_vjp

    return kernels_vjp._launch_k4(params, x, ybar, dybar, spec, kt, precision, lib=lib)


def legacy_case(dev, tmp: str):
    """The legacy shape of ``chip_smoke.py`` phase 25 as a K3/K4 case
    ``(name, spec, params, x, ybar, dybar, K)``: ``examples/legacy.json``'s
    5->[20]x20->4 net at K=3 on the 26,691 residual points of ``cli synth
    --legacy --nx 41 --ny 31`` (written under ``tmp``), seeded weights and
    cotangents."""
    import numpy as np
    import torch

    import chip_smoke
    from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy

    x = chip_smoke.legacy_points(dev, tmp, REPO)
    spec = MLPSpec(sizes=(5,) + (20,) * 20 + (4,), init_type="xavier")
    params = params_from_numpy(chip_smoke.numpy_params(spec.sizes, "xavier", 25), dev)
    rng = np.random.RandomState(25)
    n, kt = x.shape[0], 3
    ybar = torch.as_tensor(rng.randn(n, 4).astype(np.float32)).to(dev)
    dybar = torch.as_tensor(rng.randn(kt, n, 4).astype(np.float32)).to(dev)
    return ("legacy net, residual points", spec, params, x, ybar, dybar, kt)


def main_wide(args) -> int:
    """The ``--wide`` check (module docstring)."""
    import torch

    import chip_smoke
    from pinn_depthestimation_tpu_torch.ops import cuda_build, kernels, kernels_step, kernels_vjp
    from tools import wide_check

    if not torch.cuda.is_available():
        print("k1_refactor_check: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(chip_smoke.nvidia_smi("name,power.limit"))
    tiers = args.tiers.split(",")
    wanted = [k for k in ("k1", "k3", "k4", "k2") if k in args.kernels.split(",")]
    widths = tuple(int(w) for w in args.widths.split(","))
    exact = set(args.exact.split(",")) if args.exact else set()  # none by default
    failed, rows = [], []
    with tempfile.TemporaryDirectory() as tmp:
        procs = wide_check.start_builds(args.other_dir, tmp, wanted, tiers, "other")
        built = cuda_build._ensure(cuda_build.WIDE)
        libs = {("ours", k, t): built[k + "w"].libs[0] for k in wanted for t in tiers}
        libs.update(wide_check.finish_builds(procs))
        for label, kind, kt, spec, params, kw in wide_check.path_cases(dev, widths):
            if kind not in wanted:
                continue
            x = kw["x"]

            def outputs(lib, tier, kind=kind, kt=kt, spec=spec, params=params, kw=kw):
                if kind != "k2":
                    flat = wide_check.launch(lib, kind, tier, params, spec, kt=kt, **kw)
                    if kind == "k1":
                        n_p = kernels_step.n_flat(spec)
                        flat = torch.cat([flat[:n_p], flat[n_p:n_p + 5]])
                    return {"": flat}
                fresh = {k: torch.empty_like(v) for k, v in kw.items() if k in ("y", "dy", "fc")}
                wide_check.launch(lib, kind, tier, params, spec, kt=kt, x=x, **fresh)
                return fresh

            def plain(p, xx, tier, kind=kind, kt=kt, spec=spec, kw=kw):
                if kind == "k1":
                    b = kw["batch"]
                    if xx.dtype == torch.float64:
                        b = kernels_step.make_step_batch(
                            xx, b.trues.double(), b.sel.double(), b.mask.double(), [1.0, 1.0], 2,
                            1.0, 1.0, anchor_depth=0.75, has_anchor=True)
                    _, _, _, stats, g = kernels_step._plain_stats_and_grads(p, b, spec, tier)
                    return {"": torch.cat([g[k].reshape(-1) for k in kernels_step.FLAT_KEYS]
                                          + [stats.reshape(-1)[:5]])}
                if kind in ("k3", "k4"):
                    yb, db = kw["ybar"], kw["dybar"]
                    if xx.dtype == torch.float64:
                        yb, db = yb.double(), db.double()
                    g = kernels_vjp.packed_mlp_bwd_plain(p, xx, yb, db, spec, kt, tier)
                    return {"": torch.cat([g[k].reshape(-1) for k in kernels_step.FLAT_KEYS])}
                if "fc" in kw:
                    return {"fc": kernels.residual_continuity_plain(p, xx, spec, tier)}
                y, dy = kernels.mlp_fwd_tangents_plain(p, xx, spec, kt, tier)
                return {"y": y, "dy": dy} if "dy" in kw else {"y": y}

            for tier in tiers:
                name = f"{kind.upper()}-{tier} wide {label}"
                with torch.no_grad():
                    ours = outputs(libs[("ours", kind, tier)], tier)
                    again = outputs(libs[("ours", kind, tier)], tier)
                    theirs = outputs(libs[("other", kind, tier)], tier)
                    torch.cuda.synchronize()
                    same = all(torch.equal(ours[k], again[k]) for k in ours)
                    print(f"{name}: two launches bit-identical {same}")
                    if not same:
                        failed.append(f"{name} (two launches differ)")
                    refs = None
                    if tier != "f32":
                        refs = {"f32": plain(params, x, "f32"),
                                "f64": plain(chip_smoke.f64(params), x.double(), tier)}
                    for k in ours:
                        if kind in exact or f"{kind}:{tier}" in exact:
                            equal = torch.equal(ours[k], theirs[k])
                            print(f"{name} {k}: bit-identical to the other build {equal}")
                            if not equal:
                                failed.append(f"{name} {k} (bits)")
                            continue
                        try:
                            if tier == "f32":
                                chip_smoke.compare(f"{name} {k} against the other build", ours[k],
                                                   theirs[k])
                            else:
                                x3 = tier == "f32x3"
                                chip_smoke.compare_tier(
                                    f"{name} {k} against the other build", ours[k], theirs[k],
                                    refs["f32"][k], refs["f64"][k], tier,
                                    rel_floor=chip_smoke.X3_REL_FLOOR if x3 else chip_smoke.REL_TOL,
                                    distinct=chip_smoke.X3_DISTINCT if x3 else 0.0)
                        except SystemExit:
                            failed.append(f"{name} {k}")
                if not args.time:
                    continue
                calls = {who: (lambda lib=libs[(who, kind, tier)], tier=tier, kind=kind, kt=kt,
                               spec=spec, params=params, kw=kw: wide_check.launch(
                                   lib, kind, tier, params, spec, kt=kt, **kw))
                         for who in ("other", "ours")}
                reps, inner = (3, 3) if kind == "k1" else (5, 5)
                with torch.no_grad():
                    t = wide_check.time_in_turns(calls, ("other", "ours", "ours", "other"), reps,
                                                 inner, wide_check.KERNEL_NAME[kind])
                    plain_ms = chip_smoke.cuda_ms(lambda: plain(params, x, tier), 3, 1)
                plans = {who: wide_check.plan_of(libs[(who, kind, tier)], kind, tier,
                                                 x.shape[0], spec, kt, dev)
                         for who in ("other", "ours")}
                print(f"time {name}: other build {t['other'][0]} ms, this build {t['ours'][0]} "
                      f"ms (CUDA events, median of {reps} x {inner} calls); device time other "
                      f"{t['other'][1]} ms, this {t['ours'][1]} ms (torch.profiler, {inner} "
                      f"calls); plain version {plain_ms:.4f} ms; order other, ours, ours, other; "
                      f"plans {plans}")
                rows.append((name, *(wide_check.mean(t[w][i]) for i in (0, 1)
                                     for w in ("other", "ours")), plain_ms, plans))
    if rows:
        print("| kernel, tier, shape | other (events ms) | this (events ms) | other (device ms) "
              "| this (device ms) | this / other (device) | plain (ms) | this plan: tile, "
              "tiles, rounds, blocks/SM |")
        print("| --- | --- | --- | --- | --- | --- | --- | --- |")
        for name, e_o, e_t, d_o, d_t, plain_ms, plans in rows:
            p = plans["ours"]
            print(f"| {name} | {e_o:.4f} | {e_t:.4f} | {d_o:.4f} | {d_t:.4f} | "
                  f"{d_t / d_o:.3f} | {plain_ms:.4f} | {p['tile']}, {p['tiles']}, "
                  f"{-(-p['tiles'] // p['grid'])}, {p['blocks_per_sm']} |")
    if failed:
        print(f"wide ({'/'.join(tiers)}): {len(failed)} outputs FAIL: {failed}")
        return 1
    print(f"wide {', '.join(k.upper() for k in wanted)} ({'/'.join(tiers)}) agree with the "
          "other build")
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other-dir", required=True,
                        help="a directory with the other version of the kernels' sources")
    parser.add_argument("--tiers", default="f32,bf16,f32x3", help="tiers to compare")
    parser.add_argument("--kernels", default="k2,k1,k3,k4", help="kernels to compare")
    parser.add_argument("--exact", default=None,
                        help="kernels, or kernel:tier pairs, that must give the same bits as "
                             "the other build (default k2:f32; with --wide none)")
    parser.add_argument("--time", action="store_true",
                        help="time K2, K1, K3 and K4 of both builds in turns")
    parser.add_argument("--wide", action="store_true",
                        help="check and time the wide body (mlp_wide.cuh) instead")
    parser.add_argument("--widths", default="64,128", help="--wide: hidden widths")
    args = parser.parse_args()
    if args.wide:
        return main_wide(args)
    tiers = args.tiers.split(",")
    wanted = set(args.kernels.split(","))
    exact_arg = "k2:f32" if args.exact is None else args.exact
    exact = set(exact_arg.split(",")) if exact_arg else set()

    def is_exact(kind: str, tier: str) -> bool:
        return kind in exact or f"{kind}:{tier}" in exact

    import torch

    import chip_smoke
    from pinn_depthestimation_tpu_torch import benchmarks
    from pinn_depthestimation_tpu_torch.config import load_config
    from pinn_depthestimation_tpu_torch.data import load_test_data
    from pinn_depthestimation_tpu_torch.models import params_from_numpy
    from pinn_depthestimation_tpu_torch.ops import (cuda_build, k2_plan, kernels, kernels_step,
                                                    kernels_vjp)

    if not torch.cuda.is_available():
        print("k1_refactor_check: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(chip_smoke.nvidia_smi("name,power.limit"))
    failed = []

    def check(kind: str, tier: str, label: str, ours, theirs, plain=None):
        """Ours against theirs: bits for the ``--exact`` kernels, else each
        output to the tolerance of the tier (above); ``plain``: the outputs'
        plain versions at f32 and at the tier with f64 sums, for
        ``compare_tier``."""
        torch.cuda.synchronize()
        if not isinstance(ours, dict):
            ours, theirs = {"": ours}, {"": theirs}
        equal = all(torch.equal(ours[k], theirs[k]) for k in ours)
        diff = max(float((ours[k] - theirs[k]).abs().max()) if ours[k].numel() else 0.0
                   for k in ours)
        n = sum(v.numel() for v in ours.values())
        print(f"{label}: {n} floats, bit-identical {equal} (max abs diff {diff:.3e})")
        if is_exact(kind, tier):
            if not equal:
                failed.append(label)
            return
        for k in ours:
            if not ours[k].numel():
                continue
            try:
                if tier == "f32":
                    chip_smoke.compare(f"{label} {k}", ours[k], theirs[k])
                else:
                    chip_smoke.compare_tier(
                        f"{label} {k}", ours[k], theirs[k], plain["f32"][k], plain["f64"][k], tier,
                        rel_floor=chip_smoke.X3_REL_FLOOR if tier == "f32x3" else chip_smoke.REL_TOL,
                        distinct=chip_smoke.X3_DISTINCT if tier == "f32x3" else 0.0)
            except SystemExit:
                failed.append(f"{label} {k}")

    with tempfile.TemporaryDirectory() as tmp:
        k2 = chip_smoke.k2_cases(dev) + chip_smoke.k2_ragged_cases(dev)
        if "k2" in wanted:  # the 10M-point residual, with the continuity epilogue
            spec10, p10, c10 = benchmarks.flagship_bench_inputs(10_000_000, dev)
            k2.append((spec10, p10, c10, ()))
        k1, n_grid, _ = chip_smoke.k1_cases(dev, REPO, tmp)
        _, _, res_pts, fid_pts = chip_smoke.cmb_bench_points(dev, tmp)
        k3 = chip_smoke.k3_cases(dev, REPO, tmp, res_pts, fid_pts)
        widths = {"k2": {c[0].width for c in k2}, "k1": {c[1].width for c in k1},
                  "k3": {c[1].width for c in k3} | {20}, "k4": {c[1].width for c in k3} | {20}}
        widths = {k: v for k, v in widths.items() if k in wanted}
        procs = start_build(args.other_dir, tmp, widths, tiers)
        # the port's own build of the wanted kernels, beside the other's
        ours_libs = cuda_build._ensure(tuple(k for k in cuda_build.NARROW if k in wanted))
        other = finish_build(procs)

        for tier in tiers:
            with torch.no_grad():
                for spec, params, x, tangent_counts in (k2 if "k2" in wanted else []):
                    name = f"K2-{tier} {spec.d_in}->[{spec.width}]x{spec.n_hidden}->{spec.d_out}"
                    n, lib = x.shape[0], other[("k2", spec.width)]
                    ours_lib = ours_libs["k2"].libs[spec.width]
                    name = f"{name}, N={n}"
                    with_refs = not is_exact("k2", tier) and tier != "f32"
                    # at f32 also every lane count the body takes, forced
                    lane_counts = (None,) + (k2_plan.F32_LANES if tier == "f32" else ())
                    p64, x64 = (chip_smoke.f64(params), x.double()) if with_refs else (None, None)
                    for k in tangent_counts:
                        theirs = {"y": torch.empty((n, spec.d_out), device=dev),
                                  "dy": torch.empty((k, n, spec.d_out), device=dev)}
                        launch_k2(lib, params, x, spec, k, tier, epilogue=False, y=theirs["y"],
                                  dy=theirs["dy"] if k else None)
                        refs = None
                        if with_refs:
                            refs = {key: dict(zip(("y", "dy"), kernels.mlp_fwd_tangents_plain(
                                pp, xx, spec, k, t))) for key, pp, xx, t in (
                                ("f32", params, x, "f32"), ("f64", p64, x64, tier))}
                        for lanes in lane_counts:
                            ours = {"y": torch.empty((n, spec.d_out), device=dev),
                                    "dy": torch.empty((k, n, spec.d_out), device=dev)}
                            launch_k2(ours_lib, params, x, spec, k, tier, epilogue=False,
                                      lanes=lanes, y=ours["y"], dy=ours["dy"] if k else None)
                            check("k2", tier, f"{name} K={k}" + (f", {lanes} lane(s) a point"
                                                                 if lanes else ""),
                                  ours, theirs, refs)
                    if spec.d_out == 3 and spec.init_type == "xavier":
                        theirs = {"fc": torch.empty((n,), device=dev)}
                        launch_k2(lib, params, x, spec, 2, tier, epilogue=True, fc=theirs["fc"])
                        refs = None
                        if with_refs:
                            refs = {key: {"fc": kernels.residual_continuity_plain(pp, xx, spec, t)}
                                    for key, pp, xx, t in (("f32", params, x, "f32"),
                                                           ("f64", p64, x64, tier))}
                        for lanes in lane_counts:
                            ours = {"fc": torch.empty((n,), device=dev)}
                            launch_k2(ours_lib, params, x, spec, 2, tier, epilogue=True,
                                      lanes=lanes, fc=ours["fc"])
                            check("k2", tier, f"{name} continuity epilogue"
                                  + (f", {lanes} lane(s) a point" if lanes else ""),
                                  ours, theirs, refs)
                    if tier == "f32":
                        print(f"{name}: this build's f32 plan at K={max(tangent_counts, default=2)}: "
                              f"{f32_plan_of(ours_lib, x, spec, max(tangent_counts, default=2))}")
            for name, spec, params, b in (k1 if "k1" in wanted else []):
                n_p = kernels_step.n_flat(spec)

                def k1_outputs(flat):
                    total = kernels_step._combine_stats(flat[n_p:], b.fid_weights, b.n_res,
                                                        b.n_sel, b.n_true, b.w_fid, b.w_res,
                                                        b.has_anchor)[0]
                    return {"total": total.reshape(1),
                            **{f"d{k}": v for k, v in kernels_step.unflatten(flat[:n_p], spec).items()}}

                plain = None
                if tier != "f32" and not is_exact("k1", tier):
                    b64 = dataclasses.replace(b, **{k: getattr(b, k).double() for k in (
                        "coords", "trues", "sel", "mask", "fid_weights", "n_res", "n_sel", "scal")})
                    plain = {}
                    for key, p, batch, t in (("f32", params, b, "f32"),
                                             ("f64", chip_smoke.f64(params), b64, tier)):
                        (tot, _), g = kernels_step.fused_loss_and_grad_plain(p, batch, spec, t)
                        plain[key] = {"total": tot.reshape(1), **{f"d{k}": v for k, v in g.items()}}
                check("k1", tier, f"K1-{tier} {name}",
                      k1_outputs(launch_k1(ours_libs["k1"].libs[spec.width], params, b,
                                           spec, tier)),
                      k1_outputs(launch_k1(other[("k1", spec.width)], params, b, spec, tier)),
                      plain)
            for name, spec, params, x, ybar, dybar, kt in (k3 if wanted & {"k3", "k4"} else []):
                plain = None
                if tier != "f32":
                    plain = {key: {f"d{k}": v for k, v in kernels_vjp.packed_mlp_bwd_plain(
                        p, xx, yb, dyb, spec, kt, t).items()}
                        for key, p, xx, yb, dyb, t in (
                            ("f32", params, x, ybar, dybar, "f32"),
                            ("f64", chip_smoke.f64(params), x.double(), ybar.double(),
                             dybar.double(), tier))}
                for kind, launch in (("k3", launch_k3), ("k4", launch_k4)):
                    if kind in wanted:
                        ours, theirs = (
                            {f"d{k}": v for k, v in kernels_step.unflatten(
                                launch(lib, params, x, ybar, dybar, spec, kt, tier), spec).items()}
                            for lib in (ours_libs[kind].libs[spec.width], other[(kind, spec.width)]))
                        check(kind, tier, f"{kind.upper()}-{tier} {name}", ours, theirs, plain)

        if args.time:
            flag_name, flag, flag_params, flag_batch = k1[0]
            cmb = next(c for c in k3 if c[0] == "CMB net, residual grid")
            fl3 = next(c for c in k3 if c[0] == "flagship, train grid")
            fid = next(c for c in k3 if c[0] == "CMB net, fidelity rows")
            legacy = legacy_case(dev, tmp)
            spec10, p10, c10 = benchmarks.flagship_bench_inputs(10_000_000, dev)
            fc = torch.empty((c10.shape[0],), device=dev)
            # the 81x261 serving grid (phase 17's), and the CMB grid at K=2
            x_serve = torch.as_tensor(load_test_data(load_config(
                chip_smoke.newmethod_config(tmp, REPO))).inputs).to(dev)
            n_serve = x_serve.shape[0]
            serve_params = params_from_numpy(chip_smoke.numpy_params(flag.sizes, "xavier", 3), dev)
            y_serve = torch.empty((n_serve, flag.d_out), device=dev)
            y_cmb = torch.empty((cmb[3].shape[0], cmb[1].d_out), device=dev)
            dy_cmb = torch.empty((2, cmb[3].shape[0], cmb[1].d_out), device=dev)
            y_fid = torch.empty((fid[3].shape[0], fid[1].d_out), device=dev)
            y_leg = torch.empty((legacy[3].shape[0], legacy[1].d_out), device=dev)
            dy_leg = torch.empty((3, legacy[3].shape[0], legacy[1].d_out), device=dev)
            cases = []  # (label, kind, width, call(lib), reps, inner, plan args)
            for tier in tiers:
                if "k1" in wanted:
                    cases.append((f"K1-{tier} {flag_name} ({n_grid} points)", "k1", flag.width,
                                  lambda lib, t=tier: launch_k1(lib, flag_params, flag_batch, flag, t),
                                  7, 20, None))
                for kind, launch in (("k3", launch_k3), ("k4", launch_k4)):
                    shapes = [fl3, cmb, legacy]
                    for name, spec, params, x, ybar, dybar, kt in shapes:
                        if kind in wanted:
                            cases.append((f"{kind.upper()}-{tier} {name} ({x.shape[0]} points, K={kt})",
                                          kind, spec.width,
                                          lambda lib, a=(params, x, ybar, dybar, spec, kt), t=tier,
                                          fn=launch: fn(lib, *a, t), 7, 20, None))
                if "k2" in wanted:
                    f32 = tier == "f32"
                    cases += [
                        (f"K2-{tier} continuity residual at 10M points", "k2", 20,
                         lambda lib, t=tier: launch_k2(lib, p10, c10, spec10, 2, t,
                                                       epilogue=True, fc=fc), 5, 1,
                         (c10, spec10, 2) if f32 else None),
                        (f"K2-{tier} serving grid ({n_serve} points, K=0)", "k2", flag.width,
                         lambda lib, t=tier: launch_k2(lib, serve_params, x_serve, flag, 0, t,
                                                       epilogue=False, y=y_serve), 7, 20,
                         (x_serve, flag, 0) if f32 else None),
                        (f"K2-{tier} CMB grid ({cmb[3].shape[0]} points, K=2)", "k2",
                         cmb[1].width,
                         lambda lib, t=tier: launch_k2(lib, cmb[2], cmb[3], cmb[1], 2, t,
                                                       epilogue=False, y=y_cmb, dy=dy_cmb),
                         7, 20, (cmb[3], cmb[1], 2) if f32 else None),
                        (f"K2-{tier} CMB fidelity rows ({fid[3].shape[0]} points, K=0)", "k2",
                         fid[1].width,
                         lambda lib, t=tier: launch_k2(lib, fid[2], fid[3], fid[1], 0, t,
                                                       epilogue=False, y=y_fid), 7, 20,
                         (fid[3], fid[1], 0) if f32 else None),
                        (f"K2-{tier} legacy shape ({legacy[3].shape[0]} points, K=3)", "k2",
                         legacy[1].width,
                         lambda lib, t=tier: launch_k2(lib, legacy[2], legacy[3], legacy[1], 3, t,
                                                       epilogue=False, y=y_leg, dy=dy_leg),
                         7, 20, (legacy[3], legacy[1], 3) if f32 else None)]
            rows = []
            for label, kind, width, call, reps, inner, plan_args in cases:
                times = {"other": [], "ours": []}
                device = {"other": [], "ours": []}
                for who in ("other", "ours", "ours", "other"):
                    lib = other[(kind, width)] if who == "other" else ours_libs[kind].libs[width]
                    times[who].append(chip_smoke.cuda_ms(lambda: call(lib), reps, inner))
                    d = chip_smoke.device_ms(lambda: call(lib), inner,
                                             chip_smoke.WALK_KERNEL.get(kind, "k2_"))
                    device[who].append(float("nan") if d is None else d)
                plan = "" if plan_args is None else f32_plan_of(
                    ours_libs["k2"].libs[width], *plan_args)
                print(f"time {label}: other build {times['other']} ms, this build "
                      f"{times['ours']} ms (CUDA events, median of {reps} x {inner} calls); "
                      f"device time other {device['other']} ms, this {device['ours']} ms "
                      f"(torch.profiler, {inner} calls); order other, ours, ours, other"
                      + (f"; this build's plan: {plan}" if plan else ""))
                rows.append((label, *(sum(v) / 2 for v in (times["other"], times["ours"],
                                                           device["other"], device["ours"])),
                             plan))
            print("| kernel and shape | other (events ms) | this (events ms) | other (device ms) "
                  "| this (device ms) | this / other (device) | this build's f32 plan |")
            print("| --- | --- | --- | --- | --- | --- | --- |")
            for label, t_other, t_ours, d_other, d_ours, plan in rows:
                print(f"| {label} | {t_other:.4f} | {t_ours:.4f} | {d_other:.4f} | {d_ours:.4f} | "
                      f"{d_ours / d_other:.3f} | {plan or '-'} |")
    what = ", ".join(k.upper() for k in ("k2", "k1", "k3", "k4") if k in wanted)
    if failed:
        print(f"{what} ({'/'.join(tiers)}): {len(failed)} outputs FAIL against the other build: "
              f"{failed}")
        return 1
    print(f"{what} ({'/'.join(tiers)}) agree with the other build (bit for bit: "
          f"{', '.join(sorted(exact)) or 'none'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
