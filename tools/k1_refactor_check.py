#!/usr/bin/env python3
"""Hold the kernels of this tree against another build of their sources, and
time both builds.

    python3 tools/k1_refactor_check.py --other-dir OLD_CSRC [--tiers f32,bf16,f32x3]
                                       [--kernels k2,k1,k3,k4] [--exact k2:f32] [--time]

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
entries their launch plan (``k2_mma_rows``: the tensor-core body).
``--kernels`` limits the check to kernels the other sources have.

``--time`` also times both builds in turns (other, ours, ours, other), with
CUDA events and with the device time ``torch.profiler`` records
(``chip_smoke.device_ms``): K1 on the flagship's 12,516 grid points and K3
on the 20,507-point CMB grid at K=2, at each tier of ``--tiers``; K4 at the
flagship (K=2) and on the CMB grid, at each tier; K2 at each tier: the
continuity residual at 10M points, the 21,141-point serving grid (K=0) and
the CMB grid (K=2). It prints each time with the card's name and power
limit, then a table of the means with the ratio. Exits 1 if a check fails
or a build fails.
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
        per.setdefault((kind, w), []).append(binders[kind](ctypes.CDLL(out)))
    return {key: cuda_build.WidthLibrary(libs) for key, libs in per.items()}


def launch_k2(lib, params, x, spec, kt: int, precision: str, *, epilogue: bool, **out):
    """One K2 launch from ``lib`` into ``out`` (``y``/``dy`` or ``fc``),
    through the port's launcher."""
    from pinn_depthestimation_tpu_torch.ops import kernels

    kernels._launch_k2(params, x, spec, kt, precision, epilogue=epilogue, lib=lib, **out)


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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other-dir", required=True,
                        help="a directory with the other version of the kernels' sources")
    parser.add_argument("--tiers", default="f32,bf16,f32x3", help="tiers to compare")
    parser.add_argument("--kernels", default="k2,k1,k3,k4", help="kernels to compare")
    parser.add_argument("--exact", default="k2:f32",
                        help="kernels, or kernel:tier pairs, that must give the same bits as "
                             "the other build")
    parser.add_argument("--time", action="store_true",
                        help="time K2, K1, K3 and K4 of both builds in turns")
    args = parser.parse_args()
    tiers = args.tiers.split(",")
    wanted = set(args.kernels.split(","))
    exact = set(args.exact.split(",")) if args.exact else set()

    def is_exact(kind: str, tier: str) -> bool:
        return kind in exact or f"{kind}:{tier}" in exact

    import torch

    import chip_smoke
    from pinn_depthestimation_tpu_torch import benchmarks
    from pinn_depthestimation_tpu_torch.config import load_config
    from pinn_depthestimation_tpu_torch.data import load_test_data
    from pinn_depthestimation_tpu_torch.models import params_from_numpy
    from pinn_depthestimation_tpu_torch.ops import cuda_build, kernels, kernels_step, kernels_vjp

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
        k2 = chip_smoke.k2_cases(dev)
        k1, n_grid, _ = chip_smoke.k1_cases(dev, REPO, tmp)
        _, _, res_pts, fid_pts = chip_smoke.cmb_bench_points(dev, tmp)
        k3 = chip_smoke.k3_cases(dev, REPO, tmp, res_pts, fid_pts)
        widths = {"k2": {c[0].width for c in k2}, "k1": {c[1].width for c in k1},
                  "k3": {c[1].width for c in k3}, "k4": {c[1].width for c in k3}}
        widths = {k: v for k, v in widths.items() if k in wanted}
        procs = start_build(args.other_dir, tmp, widths, tiers)
        cuda_build.k2_library()  # the port's own build, beside the other's
        other = finish_build(procs)

        for tier in tiers:
            with torch.no_grad():
                for spec, params, x, tangent_counts in (k2 if "k2" in wanted else []):
                    name = f"K2-{tier} {spec.d_in}->[{spec.width}]x{spec.n_hidden}->{spec.d_out}"
                    n, lib = x.shape[0], other[("k2", spec.width)]
                    ours_lib = kernels.k2_library().libs[spec.width]
                    with_refs = not is_exact("k2", tier) and tier != "f32"
                    p64, x64 = chip_smoke.f64(params), x.double()
                    for k in tangent_counts:
                        outs = []
                        for which in (ours_lib, lib):
                            y = torch.empty((n, spec.d_out), device=dev)
                            dy = torch.empty((k, n, spec.d_out), device=dev)
                            launch_k2(which, params, x, spec, k, tier, epilogue=False, y=y,
                                      dy=dy if k else None)
                            outs.append({"y": y, "dy": dy})
                        refs = None
                        if with_refs:
                            refs = {key: dict(zip(("y", "dy"), kernels.mlp_fwd_tangents_plain(
                                pp, xx, spec, k, t))) for key, pp, xx, t in (
                                ("f32", params, x, "f32"), ("f64", p64, x64, tier))}
                        check("k2", tier, f"{name} K={k}", *outs, refs)
                    if spec.d_out == 3 and spec.init_type == "xavier":
                        outs = []
                        for which in (ours_lib, lib):
                            fc = torch.empty((n,), device=dev)
                            launch_k2(which, params, x, spec, 2, tier, epilogue=True, fc=fc)
                            outs.append({"fc": fc})
                        refs = None
                        if with_refs:
                            refs = {key: {"fc": kernels.residual_continuity_plain(pp, xx, spec, t)}
                                    for key, pp, xx, t in (("f32", params, x, "f32"),
                                                           ("f64", p64, x64, tier))}
                        check("k2", tier, f"{name} continuity epilogue", *outs, refs)
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
                      k1_outputs(launch_k1(kernels_step.k1_library().libs[spec.width], params, b,
                                           spec, tier)),
                      k1_outputs(launch_k1(other[("k1", spec.width)], params, b, spec, tier)),
                      plain)
            for name, spec, params, x, ybar, dybar, kt in k3:
                plain = None
                if tier != "f32":
                    plain = {key: {f"d{k}": v for k, v in kernels_vjp.packed_mlp_bwd_plain(
                        p, xx, yb, dyb, spec, kt, t).items()}
                        for key, p, xx, yb, dyb, t in (
                            ("f32", params, x, ybar, dybar, "f32"),
                            ("f64", chip_smoke.f64(params), x.double(), ybar.double(),
                             dybar.double(), tier))}
                for kind, launch, libs in (("k3", launch_k3, kernels_vjp.k3_library()),
                                           ("k4", launch_k4, kernels_vjp.k4_library())):
                    if kind in wanted:
                        ours, theirs = (
                            {f"d{k}": v for k, v in kernels_step.unflatten(
                                launch(lib, params, x, ybar, dybar, spec, kt, tier), spec).items()}
                            for lib in (libs.libs[spec.width], other[(kind, spec.width)]))
                        check(kind, tier, f"{kind.upper()}-{tier} {name}", ours, theirs, plain)

        if args.time:
            flag_name, flag, flag_params, flag_batch = k1[0]
            cmb = next(c for c in k3 if c[0] == "CMB net, residual grid")
            fl3 = next(c for c in k3 if c[0] == "flagship, train grid")
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
            cases = []  # (label, kind, width, call(lib), reps, inner)
            for tier in tiers:
                if "k1" in wanted:
                    cases.append((f"K1-{tier} {flag_name} ({n_grid} points)", "k1", flag.width,
                                  lambda lib, t=tier: launch_k1(lib, flag_params, flag_batch, flag, t),
                                  7, 20))
                for kind, launch in (("k3", launch_k3), ("k4", launch_k4)):
                    shapes = [cmb] if kind == "k3" else [fl3, cmb]
                    for name, spec, params, x, ybar, dybar, kt in shapes:
                        if kind in wanted:
                            cases.append((f"{kind.upper()}-{tier} {name} ({x.shape[0]} points, K={kt})",
                                          kind, spec.width,
                                          lambda lib, a=(params, x, ybar, dybar, spec, kt), t=tier,
                                          fn=launch: fn(lib, *a, t), 7, 20))
                if "k2" in wanted:
                    cases += [
                        (f"K2-{tier} continuity residual at 10M points", "k2", 20,
                         lambda lib, t=tier: launch_k2(lib, p10, c10, spec10, 2, t,
                                                       epilogue=True, fc=fc), 5, 1),
                        (f"K2-{tier} serving grid ({n_serve} points, K=0)", "k2", flag.width,
                         lambda lib, t=tier: launch_k2(lib, serve_params, x_serve, flag, 0, t,
                                                       epilogue=False, y=y_serve), 7, 20),
                        (f"K2-{tier} CMB grid ({cmb[3].shape[0]} points, K=2)", "k2",
                         cmb[1].width,
                         lambda lib, t=tier: launch_k2(lib, cmb[2], cmb[3], cmb[1], 2, t,
                                                       epilogue=False, y=y_cmb, dy=dy_cmb),
                         7, 20)]
            ours_libs = {"k1": kernels_step.k1_library(), "k3": kernels_vjp.k3_library(),
                         "k4": kernels_vjp.k4_library(), "k2": kernels.k2_library()}
            rows = []
            for label, kind, width, call, reps, inner in cases:
                times = {"other": [], "ours": []}
                device = {"other": [], "ours": []}
                for who in ("other", "ours", "ours", "other"):
                    lib = other[(kind, width)] if who == "other" else ours_libs[kind].libs[width]
                    times[who].append(chip_smoke.cuda_ms(lambda: call(lib), reps, inner))
                    d = chip_smoke.device_ms(lambda: call(lib), inner,
                                             chip_smoke.WALK_KERNEL.get(kind, "k2_"))
                    device[who].append(float("nan") if d is None else d)
                print(f"time {label}: other build {times['other']} ms, this build "
                      f"{times['ours']} ms (CUDA events, median of {reps} x {inner} calls); "
                      f"device time other {device['other']} ms, this {device['ours']} ms "
                      f"(torch.profiler, {inner} calls); order other, ours, ours, other")
                rows.append((label, *(sum(v) / 2 for v in (times["other"], times["ours"],
                                                           device["other"], device["ours"]))))
            print("| kernel and shape | other (events ms) | this (events ms) | other (device ms) "
                  "| this (device ms) | this / other (device) |")
            print("| --- | --- | --- | --- | --- | --- |")
            for label, t_other, t_ours, d_other, d_ours in rows:
                print(f"| {label} | {t_other:.4f} | {t_ours:.4f} | {d_other:.4f} | {d_ours:.4f} | "
                      f"{d_ours / d_other:.3f} |")
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
