#!/usr/bin/env python3
"""Check that the f32 and bf16 builds of K2, K1, K3 and K4 compute the same
bits as another build of their sources, and time both builds.

    python3 tools/k1_refactor_check.py --other-dir OLD_CSRC [--tiers f32,bf16]
                                       [--kernels k2,k1,k3,k4] [--time]

Needs one CUDA card and nvcc. ``OLD_CSRC`` holds another version of the
kernels' sources (for example those of a parent commit:
``mlp_fwd_tangents.cu``, ``continuity_train_step.cu``, ``mlp_bwd.cu``,
``mlp_bwd_rebuild.cu`` and the headers they include, from ``git show
<commit>:pinn_depthestimation_tpu_torch/csrc/<file>``). The tool builds them
into a temporary directory with the port's own nvcc flags, every nvcc
started together, then runs the cases of ``chip_smoke.py``'s phases 3 (K2),
7 (K1) and 11 (K3, and K4 on the same cases) through the port's entry
points and through the other build, at each tier of ``--tiers``, and
compares every output bit for bit: K2's y, dy and continuity residual,
K1's flat result (every gradient and the loss statistics), K3's and K4's
flat gradients. ``--kernels`` limits the check to kernels the other
sources have (K4 and the bf16 entries came later than K2, K1 and K3).
``--time`` also times, with CUDA events, K1 on the flagship's 12,516 grid
points and K2's continuity residual at 10M points at f32, both builds in
turns (other, ours, ours, other), and prints each time with the card's
name and power limit. Exits 1 if any output differs or a build fails.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def build(other_dir: str, tmp: str, widths: dict[str, set[int]]) -> dict:
    """The other sources' libraries ``{(kernel, width): CDLL}``, bound as the
    port binds its own."""
    from pinn_depthestimation_tpu_torch.ops import cuda_build

    src_dir = os.path.join(tmp, "src")
    os.makedirs(src_dir)
    for f in glob.glob(os.path.join(other_dir, "*.cu")) + glob.glob(os.path.join(other_dir, "*.cuh")):
        shutil.copy(f, src_dir)
    kinds = {"k2": (cuda_build.K2_SOURCE, "K2_WIDTH", cuda_build._bind_k2),
             "k1": (cuda_build.K1_SOURCE, "K1_WIDTH", cuda_build._bind_k1),
             "k3": (cuda_build.K3_SOURCE, "K3_WIDTH", cuda_build._bind_k3),
             "k4": (cuda_build.K4_SOURCE, "K4_WIDTH", cuda_build._bind_k4)}
    procs = {}
    for kind, ws in widths.items():
        source, macro, _ = kinds[kind]
        for w in sorted(ws):
            out = os.path.join(tmp, f"lib{kind}_other_{w}.so")
            cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, f"-D{macro}={w}", "-o", out,
                   os.path.join(src_dir, source)]
            procs[(kind, w)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for (kind, w), (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the other {kind} at width {w}:\n{log[-3000:]}")
        libs[(kind, w)] = kinds[kind][2](ctypes.CDLL(out))
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other-dir", required=True,
                        help="a directory with the other version of the kernels' sources")
    parser.add_argument("--tiers", default="f32,bf16", help="tiers to compare (f32, bf16)")
    parser.add_argument("--kernels", default="k2,k1,k3,k4", help="kernels to compare")
    parser.add_argument("--time", action="store_true",
                        help="time K1 (flagship) and K2 (10M-point residual) of both builds")
    args = parser.parse_args()
    tiers = args.tiers.split(",")
    wanted = set(args.kernels.split(","))

    import torch

    import chip_smoke
    from pinn_depthestimation_tpu_torch import benchmarks
    from pinn_depthestimation_tpu_torch.ops import cuda_build, kernels, kernels_step, kernels_vjp

    if not torch.cuda.is_available():
        print("k1_refactor_check: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(chip_smoke.nvidia_smi("name,power.limit"))
    same = True

    def check(label: str, ours, theirs) -> None:
        nonlocal same
        torch.cuda.synchronize()
        equal = torch.equal(ours, theirs)
        diff = float((ours - theirs).abs().max()) if ours.numel() else 0.0
        print(f"{label}: {ours.numel()} floats, bit-identical {equal} (max abs diff {diff:.3e})")
        same &= equal

    with tempfile.TemporaryDirectory() as tmp:
        k2 = chip_smoke.k2_cases(dev)
        k1, _, _ = chip_smoke.k1_cases(dev, REPO, tmp)
        _, _, res_pts, fid_pts = chip_smoke.cmb_bench_points(dev, tmp)
        k3 = chip_smoke.k3_cases(dev, REPO, tmp, res_pts, fid_pts)
        widths = {"k2": {c[0].width for c in k2}, "k1": {c[1].width for c in k1},
                  "k3": {c[1].width for c in k3}, "k4": {c[1].width for c in k3}}
        widths = {k: v for k, v in widths.items() if k in wanted}
        cuda_build.k2_library()  # the port's own build, every nvcc at once
        other = build(args.other_dir, tmp, widths)

        for tier in tiers:
            with torch.no_grad():
                for spec, params, x, tangent_counts in (k2 if "k2" in wanted else []):
                    name = f"K2-{tier} {spec.d_in}->[{spec.width}]x{spec.n_hidden}->{spec.d_out}"
                    n, lib = x.shape[0], other[("k2", spec.width)]
                    for k in tangent_counts:
                        outs = []
                        for which in (None, lib):
                            y = torch.empty((n, spec.d_out), device=dev)
                            dy = torch.empty((k, n, spec.d_out), device=dev)
                            kernels._launch_k2(params, x, spec, k, tier, epilogue=False, y=y,
                                               dy=dy if k else None, lib=which)
                            outs.append(torch.cat([y.reshape(-1), dy.reshape(-1)]))
                        check(f"{name} K={k}", *outs)
                    if spec.d_out == 3 and spec.init_type == "xavier":
                        outs = []
                        for which in (None, lib):
                            fc = torch.empty((n,), device=dev)
                            kernels._launch_k2(params, x, spec, 2, tier, epilogue=True, fc=fc,
                                               lib=which)
                            outs.append(fc)
                        check(f"{name} continuity epilogue", *outs)
            for name, spec, params, b in (k1 if "k1" in wanted else []):
                check(f"K1-{tier} {name}", kernels_step._launch_k1(params, b, spec, precision=tier),
                      kernels_step._launch_k1(params, b, spec, lib=other[("k1", spec.width)],
                                              precision=tier))
            for name, spec, params, x, ybar, dybar, kt in k3:
                if "k3" in wanted:
                    check(f"K3-{tier} {name}",
                          kernels_vjp._launch_k3(params, x, ybar, dybar, spec, kt, tier),
                          kernels_vjp._launch_k3(params, x, ybar, dybar, spec, kt, tier,
                                                 lib=other[("k3", spec.width)]))
                if "k4" in wanted:
                    check(f"K4-{tier} {name}",
                          kernels_vjp._launch_k4(params, x, ybar, dybar, spec, kt, tier),
                          kernels_vjp._launch_k4(params, x, ybar, dybar, spec, kt, tier,
                                                 lib=other[("k4", spec.width)]))

        if args.time and {"k1", "k2"} <= wanted:
            flag_name, flag, flag_params, flag_batch = k1[0]
            spec10, p10, c10 = benchmarks.flagship_bench_inputs(10_000_000, dev)
            fc = torch.empty((c10.shape[0],), device=dev)

            def k1_call(lib):
                return lambda: kernels_step._launch_k1(flag_params, flag_batch, flag, lib=lib)

            def k2_call(lib):
                return lambda: kernels._launch_k2(p10, c10, spec10, 2, "f32", epilogue=True,
                                                  fc=fc, lib=lib)

            for label, make, reps, inner in (
                    (f"K1-f32 {flag_name} ({flag_batch.coords.shape[0]} points)", k1_call, 7, 20),
                    ("K2-f32 continuity residual at 10M points", k2_call, 5, 1)):
                lib_other = other[("k1" if make is k1_call else "k2", 20)]
                times = {"other": [], "ours": []}
                for who in ("other", "ours", "ours", "other"):
                    fn = make(lib_other if who == "other" else None)
                    times[who].append(chip_smoke.cuda_ms(fn, reps, inner))
                print(f"time {label}: other build {times['other']} ms, this build "
                      f"{times['ours']} ms (CUDA events, median of {reps} x {inner} calls; "
                      f"order other, ours, ours, other)")
    what = ", ".join(k.upper() for k in ("k2", "k1", "k3", "k4") if k in wanted)
    print(f"{what} ({'/'.join(tiers)}) are bit-identical to the other build" if same
          else f"{what} ({'/'.join(tiers)}) DIFFER from the other build")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
