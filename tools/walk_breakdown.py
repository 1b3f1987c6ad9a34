#!/usr/bin/env python3
"""Split the time of K1 and K3 between the parts of their shared backward walk.

    python3 tools/walk_breakdown.py [--csrc DIR] [--reps 7] [--inner 20]

Needs one CUDA card and nvcc. The tool copies the kernels' sources (the
package's ``csrc/``, or ``--csrc DIR``, for example another commit's files
from ``git show <commit>:pinn_depthestimation_tpu_torch/csrc/<file>``) to a
temporary directory and patches the copies there into variants that each
drop one part of the walk in ``mlp_bwd_common.cuh``:

  states     every layer state goes to one slot of the scratch and is read
             back from it: the same instructions, with the state traffic
             held in L1/L2 (what the traffic to device memory costs);
  wgrad      the weight-gradient products (``accum_square``, ``accum_rect``)
             return at once;
  barriers   the backward's per-layer ``__syncthreads()`` are removed;
  cotangent  the cotangent product ``[zbar; ubar^k] @ w^T`` of the hidden
             layers is dropped (its accumulators stay at zero);
  all        every one of the four dropped at once.

Each variant is built at the f32 tier (K1 at width 20, K3 at width 10, one
``nvcc`` each, all started together) and timed against the untouched build
in turns (untouched, variant, variant, untouched), with CUDA events and with
the device time ``torch.profiler`` records (``chip_smoke.device_ms``; the
events measure the host's launch rate where a call enqueues slower than it
runs): K1 on the flagship's 12,516 grid points (``chip_smoke.py`` phase 7's
first case) and K3 on the 20,507-point CMB grid at K=2 (phase 11's first
case). A dropped part's cost is the untouched device time less the
variant's. The dropped
variants compute wrong gradients; only their times are read. Every patch
must apply, or the tool stops.

It first asks whether ``ncu`` exists and may read the card's counters, and
prints the answer. Prints the card's name and power limit, every time, and
a table of the split.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

COMMON = "mlp_bwd_common.cuh"

# Patches of mlp_bwd_common.cuh: variant -> [(regex, replacement)]. The
# first table fits walks whose tile is 128 points with one thread each;
# the second the walk with lane pairs and a tile sized per launch. Each
# regex must match at least once.
_BODY_RETURN = r"\1\n  return;"
PATCHES = {
    "fixed-tile": {
        "states": [(r"auto state = \[&\]\(int s\) \{ return st0 \+ static_cast<size_t>\(s\) \* "
                    r"state_floats; \};",
                    "auto state = [&](int s) { (void)s; return st0; };")],
        "wgrad": [(r"(void accum_square\([^{]*\{)", _BODY_RETURN),
                  (r"(void accum_rect\([^{]*\{)", _BODY_RETURN)],
        "barriers": [(r"__syncthreads\(\);  // the previous layer's block product is done", ""),
                     (r"(stage_state<W, ACT, K>\(st_prev, sA\);)\n\s*__syncthreads\(\);", r"\1")],
        "cotangent": [(r"Tier::mac\(nai, cao\[q \+ v\], wv\[v\]\);", "(void)0;"),
                      (r"Tier::mac\(nti\[k\], cto\[k\]\[q \+ v\], wv\[v\]\);", "(void)0;")],
    },
    "lane-pair": {
        "states": [(r"auto state = \[&\]\(int s\) \{ return st0 \+ static_cast<size_t>\(s\) \* "
                    r"state_floats; \};",
                    "auto state = [&](int s) { (void)s; return st0; };")],
        "wgrad": [(r"(int accum_square\([^{]*\{)", r"\1\n  return 1;"),
                  (r"(int accum_rect\([^{]*\{)", r"\1\n  return 1;")],
        "barriers": [(r"__syncthreads\(\);  // the previous product is done: the buffers are free",
                      "(void)0;"),
                     (r"__syncthreads\(\);  // layer barrier", "(void)0;")],
        "cotangent": [(r"Tier::mac\(acc, zo\[q \+ v\], wv\[v\]\);", "(void)0;"),
                      (r"Tier::mac\(acct\[k\], zto\[k\]\[q \+ v\], wv\[v\]\);", "(void)0;")],
    },
}
VARIANTS = ("states", "wgrad", "barriers", "cotangent")


def layout(text: str) -> str:
    """Which patch table fits this walk."""
    return "lane-pair" if "kLanes" in text else "fixed-tile"


def patch(text: str, variant: str) -> str:
    table = PATCHES[layout(text)]
    for v in (VARIANTS if variant == "all" else (variant,)):
        for pattern, repl in table[v]:
            text, n = re.subn(pattern, repl, text)
            if n == 0:
                raise RuntimeError(f"patch {v!r} found no {pattern!r} in {COMMON}")
    return text


def build(src: str, tmp: str, variants) -> dict:
    """``{variant: {"k1": library, "k3": library}}``, each built from a
    patched copy of ``src``, every nvcc started together."""
    from pinn_depthestimation_tpu_torch.ops import cuda_build
    from tools.k1_refactor_check import bind

    procs = {}
    for variant in variants:
        d = os.path.join(tmp, variant)
        shutil.copytree(src, d)
        if variant != "untouched":
            path = os.path.join(d, COMMON)
            with open(path) as f:
                text = f.read()
            with open(path, "w") as f:
                f.write(patch(text, variant))
        for kind, source, macro, width in (("k1", cuda_build.K1_SOURCE, "K1_WIDTH", 20),
                                           ("k3", cuda_build.K3_SOURCE, "K3_WIDTH", 10)):
            out = os.path.join(d, f"lib{kind}.so")
            cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, f"-D{macro}={width}",
                   "-DTIER_ONLY=0", "-o", out, os.path.join(d, source)]
            procs[(variant, kind)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                       stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for (variant, kind), (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {kind} ({variant}):\n{log[-3000:]}")
        if variant == "untouched":  # registers and spills of each kernel (ptxas -v)
            lines = log.splitlines()
            for i, line in enumerate(lines):
                if "Compiling entry function" in line and "reduce_kernel" not in line:
                    usage = [x.strip() for x in lines[i + 1:i + 4] if "spill" in x or "Used" in x]
                    print(f"ptxas {kind}: {line.split(chr(39))[1][:60]}...: {'; '.join(usage)}")
        libs.setdefault(variant, {})[kind] = bind(kind, ctypes.CDLL(out))
    return libs


def ncu_status() -> str:
    """Whether ncu is installed and may read the card's counters."""
    ncu = shutil.which("ncu") or ("/usr/local/cuda/bin/ncu"
                                  if os.path.exists("/usr/local/cuda/bin/ncu") else None)
    if ncu is None:
        return "ncu: not installed"
    probe = [ncu, "--metrics", "sm__cycles_elapsed.avg", "--launch-count", "1",
             sys.executable, "-c", "import torch; torch.ones(1, device='cuda').add_(1); "
             "torch.cuda.synchronize()"]
    try:
        run = subprocess.run(probe, capture_output=True, text=True, timeout=180)
    except subprocess.TimeoutExpired:
        return f"ncu: {ncu} found; a one-kernel profile did not end in 180 s"
    out = (run.stdout + run.stderr).strip().splitlines()
    tail = " | ".join(out[-4:])
    ok = run.returncode == 0 and "sm__cycles_elapsed.avg" in run.stdout
    return f"ncu: {ncu} found; counters {'readable' if ok else 'NOT readable'} (rc {run.returncode}: {tail})"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--csrc", default=os.path.join(REPO, "pinn_depthestimation_tpu_torch", "csrc"),
                        help="the kernels' sources to split (default: the package's)")
    parser.add_argument("--reps", type=int, default=7, help="CUDA-event repetitions per timing")
    parser.add_argument("--inner", type=int, default=20, help="calls per repetition")
    args = parser.parse_args()

    import torch

    import chip_smoke
    from tools.k1_refactor_check import launch_k1, launch_k3

    if not torch.cuda.is_available():
        print("walk_breakdown: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(chip_smoke.nvidia_smi("name,power.limit"))
    print(ncu_status())
    with open(os.path.join(args.csrc, COMMON)) as f:
        print(f"sources {args.csrc}: walk layout {layout(f.read())!r}")

    variants = ("untouched",) + VARIANTS + ("all",)
    with tempfile.TemporaryDirectory() as tmp:
        cases, n_grid, _ = chip_smoke.k1_cases(dev, REPO, tmp)
        _, k1_spec, k1_params, k1_batch = cases[0]
        _, _, res_pts, fid_pts = chip_smoke.cmb_bench_points(dev, tmp)
        _, k3_spec, k3_params, x, ybar, dybar, kt = chip_smoke.k3_cases(
            dev, REPO, tmp, res_pts, fid_pts)[0]
        libs = build(args.csrc, tmp, variants)
        calls = {
            "k1": lambda lib: (lambda: launch_k1(lib, k1_params, k1_batch, k1_spec)),
            "k3": lambda lib: (lambda: launch_k3(lib, k3_params, x, ybar, dybar, k3_spec, kt)),
        }
        labels = {"k1": f"K1-f32 flagship, {n_grid} points",
                  "k3": f"K3-f32 CMB net, {x.shape[0]} points, K={kt}"}
        rows = {}
        for kind in ("k1", "k3"):
            for variant in VARIANTS + ("all",):
                times = {"untouched": [], variant: []}
                device = {"untouched": [], variant: []}
                for who in ("untouched", variant, variant, "untouched"):
                    fn = calls[kind](libs[who][kind])
                    times[who].append(chip_smoke.cuda_ms(fn, args.reps, args.inner))
                    d = chip_smoke.device_ms(fn, args.inner, chip_smoke.WALK_KERNEL[kind])
                    device[who].append(float("nan") if d is None else d)
                mean = lambda v: sum(v) / len(v)  # noqa: E731
                rows[(kind, variant)] = (mean(times["untouched"]), mean(times[variant]),
                                         mean(device["untouched"]), mean(device[variant]))
                print(f"time {labels[kind]}: untouched {times['untouched']} ms, without "
                      f"{variant} {times[variant]} ms (CUDA events, median of {args.reps} x "
                      f"{args.inner} calls); device time untouched {device['untouched']} ms, "
                      f"without {variant} {device[variant]} ms (torch.profiler, {args.inner} "
                      f"calls); order untouched, variant, variant, untouched")
        print("split (ms; untouched is the mean of the two runs beside each variant; the "
              "cost and its share are of the device time):")
        print("| kernel | part dropped | untouched (events) | without it (events) | untouched "
              "(device) | without it (device) | its cost | share |")
        print("| --- | --- | --- | --- | --- | --- | --- | --- |")
        for kind in ("k1", "k3"):
            for variant in VARIANTS + ("all",):
                ref, ms, dref, dms = rows[(kind, variant)]
                print(f"| {labels[kind]} | {variant} | {ref:.4f} | {ms:.4f} | {dref:.4f} | "
                      f"{dms:.4f} | {dref - dms:.4f} | {(dref - dms) / dref:.1%} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
