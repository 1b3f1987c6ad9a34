#!/usr/bin/env python3
"""Check that the f32 builds of K2, K1 and K3 compute the same bits as
another build of their sources.

    python3 tools/k1_refactor_check.py --other-dir OLD_CSRC

Needs one CUDA card and nvcc. ``OLD_CSRC`` holds another version of the
kernels' sources (for example those of a parent commit:
``mlp_fwd_tangents.cu``, ``continuity_train_step.cu``, ``mlp_bwd.cu`` and
the headers they include, from ``git show <commit>:pinn_depthestimation_tpu_torch/csrc/<file>``).
The tool builds them into a temporary directory with the port's own nvcc
flags, every nvcc started together, then runs the cases of
``chip_smoke.py``'s phases 3 (K2), 7 (K1) and 11 (K3) through the port's
f32 entry points and through the other build, and compares every output
bit for bit: K2's y, dy and continuity residual, K1's flat result (every
gradient and the loss statistics), K3's flat gradients. Exits 1 if any
output differs or a build fails.
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
             "k3": (cuda_build.K3_SOURCE, "K3_WIDTH", cuda_build._bind_k3)}
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
    args = parser.parse_args()

    import torch

    import chip_smoke
    from pinn_depthestimation_tpu_torch.ops import kernels, kernels_step, kernels_vjp

    if not torch.cuda.is_available():
        print("k1_refactor_check: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
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
                  "k3": {c[1].width for c in k3}}
        other = build(args.other_dir, tmp, widths)

        with torch.no_grad():
            for spec, params, x, tangent_counts in k2:
                name = f"K2 {spec.d_in}->[{spec.width}]x{spec.n_hidden}->{spec.d_out}"
                n, lib = x.shape[0], other[("k2", spec.width)]
                for k in tangent_counts:
                    outs = []
                    for which in (None, lib):
                        y = torch.empty((n, spec.d_out), device=dev)
                        dy = torch.empty((k, n, spec.d_out), device=dev)
                        kernels._launch_k2(params, x, spec, k, "f32", epilogue=False, y=y,
                                           dy=dy if k else None, lib=which)
                        outs.append(torch.cat([y.reshape(-1), dy.reshape(-1)]))
                    check(f"{name} K={k}", *outs)
                if spec.d_out == 3 and spec.init_type == "xavier":
                    outs = []
                    for which in (None, lib):
                        fc = torch.empty((n,), device=dev)
                        kernels._launch_k2(params, x, spec, 2, "f32", epilogue=True, fc=fc,
                                           lib=which)
                        outs.append(fc)
                    check(f"{name} continuity epilogue", *outs)
        for name, spec, params, b in k1:
            check(f"K1 {name}", kernels_step._launch_k1(params, b, spec),
                  kernels_step._launch_k1(params, b, spec, lib=other[("k1", spec.width)]))
        for name, spec, params, x, ybar, dybar, kt in k3:
            check(f"K3 {name}", kernels_vjp._launch_k3(params, x, ybar, dybar, spec, kt),
                  kernels_vjp._launch_k3(params, x, ybar, dybar, spec, kt,
                                         lib=other[("k3", spec.width)]))
    print("K2, K1 and K3 (f32) are bit-identical to the other build" if same
          else "K2, K1 or K3 (f32) DIFFERS from the other build")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
