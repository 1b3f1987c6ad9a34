#!/usr/bin/env python3
"""Check that K1 computes the same bits as another build of its source.

    python3 tools/k1_refactor_check.py --other-source OLD/continuity_train_step.cu

Needs one CUDA card and nvcc. Builds ``--other-source`` (for example the
source of K1 before a refactor) into a temporary directory with the port's
own nvcc flags, then runs the cases of ``chip_smoke.py``'s phase 7 through
the port's K1 and through the other build, and compares the whole flat
output (every gradient and the loss statistics) bit for bit. Exits 1 on
the first difference. The source is compiled as it is, so it must include
only what it carries or what sits beside it: the file is copied alone.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other-source", required=True, help="a K1 source file to build and compare")
    args = parser.parse_args()

    import torch

    import chip_smoke
    from pinn_depthestimation_tpu_torch.ops import cuda_build, kernels_step

    if not torch.cuda.is_available():
        print("k1_refactor_check: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "k1_other.cu")
        shutil.copy(args.other_source, src)
        cases, _, _ = chip_smoke.k1_cases(dev, REPO, tmp)
        other = {}
        for width in sorted({spec.width for _, spec, _, _ in cases}):
            out = os.path.join(tmp, f"libk1_other_{width}.so")
            cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, f"-DK1_WIDTH={width}",
                   "-o", out, src]
            done = subprocess.run(cmd, capture_output=True, text=True)
            if done.returncode:
                print(done.stdout + done.stderr, file=sys.stderr)
                return 1
            other[width] = cuda_build._bind_k1(ctypes.CDLL(out))
        same = True
        for name, spec, params, b in cases:
            ours = kernels_step._launch_k1(params, b, spec)
            theirs = kernels_step._launch_k1(params, b, spec, lib=other[spec.width])
            torch.cuda.synchronize()
            equal = torch.equal(ours, theirs)
            diff = float((ours - theirs).abs().max())
            print(f"{name}: {ours.numel()} floats, bit-identical {equal} (max abs diff {diff:.3e})")
            same &= equal
    print("K1 is bit-identical to the other build" if same else "K1 DIFFERS from the other build")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
