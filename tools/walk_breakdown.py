#!/usr/bin/env python3
"""Split the time of K1, K3 and K4 between the parts of their shared backward walk.

    python3 tools/walk_breakdown.py [--csrc DIR] [--tiers f32,bf16,f32x3] [--reps 7] [--inner 20]
    python3 tools/walk_breakdown.py --wide [--csrc DIR] [--tiers f32,bf16] [--widths 64,128]
    python3 tools/walk_breakdown.py --k2 [--csrc DIR] [--reps 5] [--inner 10]

Needs one CUDA card and nvcc. The tool copies the kernels' sources (the
package's ``csrc/``, or ``--csrc DIR``, for example another commit's files
from ``git show <commit>:pinn_depthestimation_tpu_torch/csrc/<file>``) to a
temporary directory and patches the copies there into variants that each
drop one part of the walk: in ``mlp_bwd_common.cuh`` (:data:`PATCHES`), or
in ``mlp_bwd_mma.cuh`` (:data:`MMA_PATCHES`) for the bf16 and f32x3 tiers of
sources that run those on the tensor cores:

  states     every layer state goes to one slot of the scratch and is read
             back from it: the same instructions, with the state traffic
             held in L1/L2 (what the traffic to device memory costs);
  wgrad      the weight-gradient products (``accum_square``, ``accum_rect``)
             return at once;
  barriers   the backward's per-layer ``__syncthreads()`` are removed;
  cotangent  the cotangent product ``[zbar; ubar^k] @ w^T`` of the hidden
             layers is dropped (its accumulators stay at zero);
  staging    (the tensor-core walk only) the hidden layers' weight images
             are not staged into shared memory;
  all        every one of them dropped at once.

Each variant is built at each tier of ``--tiers`` (f32 by default; K1 and
K4 at width 20, K3 at width 10, one ``nvcc`` each, all started together)
and timed against the untouched build in turns (untouched, variant,
variant, untouched), with CUDA events and with the device time
``torch.profiler`` records (``chip_smoke.device_ms``; the events measure the
host's launch rate where a call enqueues slower than it runs): K1 on the
flagship's 12,516 grid points (``chip_smoke.py`` phase 7's first case), K3
on the 20,507-point CMB grid at K=2 (phase 11's first case) and K4 at the
legacy shape (5->[20]x20->4 at K=3 on 26,691 points,
``tools/k1_refactor_check.py::legacy_case``). A dropped part's cost is the
untouched device time less the variant's. The dropped
variants compute wrong gradients; only their times are read. Every patch
must apply, or the tool stops.

It first asks whether ``ncu`` exists and may read the card's counters, and
prints the answer. Prints the card's name and power limit, every time, and
a table of the split.

``--wide`` splits the wide body instead (``csrc/mlp_wide.cuh``, K1, K3 and
K4 at the tiers of ``--tiers``; ``tools/wide_check.py`` builds and
launches it at phase 28's path shapes: K1 on the 2->[W]x100->3 flagship at
12,516 points, K3 and K4 on the 2->[W]x10->6 CMB net on the 20,507-point
CMB grid at K = 2, for each W of ``--widths``). Its variants, one part of
the walk dropped each (the patches are :data:`WIDE_PATCHES`, one table per
version of the walk, picked by the source):

  wgrad      the weight-gradient products return at once;
  staging    the layer weights are not staged into shared memory (the
             copies of the weight images are not issued);
  states     the layer states are neither written to nor read from the
             device scratch;
  partials   the walk's partial rows are written without reading them back
             (each tile stores instead of adding);
  barriers   every ``__syncthreads()`` of the walk is removed;
  cotangent  the hidden layers' cotangent product is dropped;
  all        every one of them at once.

``--k2`` splits K2 at f32 (``csrc/mlp_fwd_tangents.cu``, widths 20 and 10)
instead, with one part dropped at a time (:data:`K2_PATCHES`, one table per
version of the f32 body, picked by the source: the redesigned body with
lanes a point, or the one thread a point before it):

  staging    the hidden stack is not copied into shared memory;
  tanh       the activation is the identity (``tanhf`` not called; act'
             stays);
  exchange   (two lanes a point only) a lane takes its own values where it
             would take its partner's by ``__shfl_xor_sync``;
  all        every one of them at once.

Each variant is timed against the untouched build in turns, device time,
at K2-f32's path shapes: the 81x261 serving grid (K=0), the 10M-point
residual (the epilogue), the CMB grid (K=2), the CMB net's 200 fidelity
rows (K=0) and the legacy shape (K=3), on the plan the untouched build's
library gives (``ops/k2_plan.py::f32_plan``). The variants compute wrong
outputs; only their times are read.
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
MMA = "mlp_bwd_mma.cuh"  # the tensor-core walk of the bf16 and f32x3 tiers

# Patches of mlp_bwd_common.cuh (the walk with lane pairs and a tile sized
# per launch): variant -> [(regex, replacement)]. Each regex must match at
# least once.
PATCHES = {
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
}

# The same variants of the tensor-core walk (mlp_bwd_mma.cuh): wgrad drops
# the bf16 tier's CUDA-core products (accum_square, accum_rect) and the
# f32x3 tier's MMA one (wgrad_mma); barriers also the f32x3 tier's barrier
# between the flush and the slots.
MMA_PATCHES = {
    "states": PATCHES["states"],
    "wgrad": [(r"accum_square<Tier, W, S, true>\(s_A, s_B, ld, P, s_red\)", "1"),
              (r"accum_rect<Tier, S>\([^)]*\)", "1"),
              (r"wgrad_mma<W, ACT, K>\([^;]*\);", "(void)0;")],
    "barriers": PATCHES["barriers"] + [(r"__syncthreads\(\);  // the flush has read the slots",
                                        "(void)0;")],
    "cotangent": [(r"cotangent<SP, T>\(ca, zh, bw\);", "(void)0;"),
                  (r"cotangent<SP, T>\(ct\[k\], uh\[k\], bw\);", "(void)0;")],
    "staging": [(r"stage_hidden<SP, W, (false|true)>\(base, src, nl\);", "(void)0;")],
}


def patch(text: str, variant: str, table: dict, target: str) -> str:
    for v in (tuple(table) if variant == "all" else (variant,)):
        for pattern, repl in table[v]:
            text, n = re.subn(pattern, repl, text)
            if n == 0:
                raise RuntimeError(f"patch {v!r} found no {pattern!r} in {target}")
    return text


# The narrow cases: kernel -> (source, width macro, width).
NARROW = {"k1": ("K1_SOURCE", "K1_WIDTH", 20), "k3": ("K3_SOURCE", "K3_WIDTH", 10),
          "k4": ("K4_SOURCE", "K4_WIDTH", 20)}


def patch_target(src: str, tier: str) -> tuple[str, dict]:
    """The file a variant patches and its table: the tensor-core walk's
    header (:data:`MMA_PATCHES`) for the bf16 and f32x3 tiers of sources
    that have one, else ``mlp_bwd_common.cuh`` (:data:`PATCHES`; the
    lane-pair walk runs every tier there)."""
    if tier != "f32" and os.path.exists(os.path.join(src, MMA)):
        return MMA, MMA_PATCHES
    return COMMON, PATCHES


def variants_of(src: str, tier: str) -> tuple:
    """The variants a tier's walk is split into: its patch table's, then
    ``all``."""
    return tuple(patch_target(src, tier)[1]) + ("all",)


def build(src: str, tmp: str, tiers) -> dict:
    """``{(variant, tier): {kernel: library}}`` for the kernels of
    :data:`NARROW`, the untouched build and one patched copy of ``src`` per
    variant of :func:`variants_of`, every nvcc started together."""
    from pinn_depthestimation_tpu_torch.ops import cuda_build
    from tools.k1_refactor_check import TIER_INDEX

    binders = {"k1": cuda_build._bind_k1, "k3": cuda_build._bind_k3, "k4": cuda_build._bind_k4}

    procs = {}
    for tier in tiers:
        for variant in ("untouched",) + variants_of(src, tier):
            d = os.path.join(tmp, f"{variant}_{tier}")
            shutil.copytree(src, d)
            if variant != "untouched":
                target, table = patch_target(src, tier)
                path = os.path.join(d, target)
                with open(path) as f:
                    text = f.read()
                with open(path, "w") as f:
                    f.write(patch(text, variant, table, target))
            for kind, (source, macro, width) in NARROW.items():
                out = os.path.join(d, f"lib{kind}.so")
                cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, f"-D{macro}={width}",
                       f"-DTIER_ONLY={TIER_INDEX[tier]}", "-o", out,
                       os.path.join(d, getattr(cuda_build, source))]
                procs[(variant, tier, kind)] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for (variant, tier, kind), (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {kind} {tier} ({variant}):\n{log[-3000:]}")
        if variant == "untouched":  # registers and spills of each kernel (ptxas -v)
            lines = log.splitlines()
            for i, line in enumerate(lines):
                if "Compiling entry function" in line and "reduce_kernel" not in line:
                    usage = [x.strip() for x in lines[i + 1:i + 4] if "spill" in x or "Used" in x]
                    print(f"ptxas {kind} {tier}: {line.split(chr(39))[1][:60]}...: "
                          f"{'; '.join(usage)}")
        libs.setdefault((variant, tier), {})[kind] = binders[kind](ctypes.CDLL(out))
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


# Patches of mlp_wide.cuh, per version of the wide walk: variant ->
# [(regex, replacement)]. The first wide walk stages each layer with
# `stage`, keeps the states with store_state/load_state and adds to its
# partial rows with `accumulate`.
WIDE_PATCHES = {
    "first": {
        "wgrad": [(r"(__device__ void weight_grad\([^{]*\{)", r"\1\n  return;")],
        "staging": [(r"(__device__ void stage\([^{]*\{)", r"\1\n  return;")],
        "states": [(r"(__device__ void store_state\([^{]*\{)", r"\1\n  return;"),
                   (r"(__device__ void load_state\([^{]*\{)", r"\1\n  return;")],
        "partials": [(r"return first \? v : \*dst \+ v;", "return v;")],
        "barriers": [(r"__syncthreads\(\);", "(void)0;")],
        "cotangent": [(r"product<Tier, S>\(BAR, d\.Wp, sm\.w, d\.Wp, CUR, nullptr, d\);",
                       "(void)0;")],
    },
    # The redesigned walk: images staged by Pipe::issue, states kept
    # through kept_state and read back by load_state and backward_pass.
    "current": {
        "wgrad": [(r"(__device__ void weight_grad_cc\([^{]*\{)", r"\1\n  return;"),
                  (r"(__device__ void weight_grad_mma\([^{]*\{)", r"\1\n  return;")],
        "staging": [(r"(__device__ void issue\(int idx, int chunk\) \{)", r"\1\n    idx = -1;")],
        "states": [(r"(__device__ __forceinline__ float\* kept_state\([^{]*\{)",
                    r"\1\n  return nullptr;"),
                   (r"(__device__ void load_state\([^{]*\{)", r"\1\n  return;"),
                   (r"backward_pass<ACT, K>\(BAR, CUR, PRV, state_ptr\([^;]*;",
                    "backward_pass<ACT, K>(BAR, CUR, PRV, nullptr, d);")],
        "partials": [(r"\*dst = first \? v : \*dst \+ v;", "*dst = v;")],
        "barriers": [(r"__syncthreads\(\);", "(void)0;")],
        "cotangent": [(r"layer<Tier, S>\(pipe, img_bwd\(d, j\),[^;]*;", "(void)0;")],
    },
}
WIDE_VARIANTS = ("wgrad", "staging", "states", "partials", "barriers", "cotangent")


def wide_version(text: str) -> str:
    """Which table of :data:`WIDE_PATCHES` a ``mlp_wide.cuh`` takes."""
    return "current" if "images_kernel" in text else "first"


def wide_patch(text: str, variant: str) -> str:
    table = WIDE_PATCHES[wide_version(text)]
    for v in (WIDE_VARIANTS if variant == "all" else (variant,)):
        for pattern, repl in table[v]:
            text, n = re.subn(pattern, repl, text)
            if n == 0:
                raise RuntimeError(f"patch {v!r} found no {pattern!r} in mlp_wide.cuh")
    return text


def main_wide(args) -> int:
    """The ``--wide`` split (module docstring)."""
    import torch

    import chip_smoke
    from tools import wide_check

    if not torch.cuda.is_available():
        print("walk_breakdown: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(chip_smoke.nvidia_smi("name,power.limit"))
    print(ncu_status())
    tiers = args.tiers.split(",")
    widths = tuple(int(w) for w in args.widths.split(","))
    with open(os.path.join(args.csrc, "mlp_wide.cuh")) as f:
        text = f.read()
    print(f"sources {args.csrc} (wide walk: {wide_version(text)})")
    variants = ("untouched",) + WIDE_VARIANTS + ("all",)
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for variant in variants:
            d = os.path.join(tmp, variant)
            wide_check.copy_sources(args.csrc, d)
            if variant != "untouched":
                with open(os.path.join(d, "mlp_wide.cuh"), "w") as f:
                    f.write(wide_patch(text, variant))
            procs.update(wide_check.start_builds(d, d, ("k1", "k3", "k4"), tiers, variant))
        libs = {}
        for key, value in procs.items():  # the untouched build's registers first
            libs.update(wide_check.finish_builds({key: value}, key[0] == "untouched"))
        cases = [c for c in wide_check.path_cases(dev, widths) if c[1] != "k2"]
        rows = []
        for label, kind, kt, spec, params, kw in cases:
            for tier in tiers:
                plan = wide_check.plan_of(libs[("untouched", kind, tier)], kind, tier,
                                          kw["x"].shape[0], spec, kt, dev)
                for variant in WIDE_VARIANTS + ("all",):
                    calls = {who: (lambda lib=libs[(who, kind, tier)]: wide_check.launch(
                        lib, kind, tier, params, spec, kt=kt, **kw))
                        for who in ("untouched", variant)}
                    with torch.no_grad():
                        t = wide_check.time_in_turns(
                            calls, ("untouched", variant, variant, "untouched"), args.reps,
                            args.inner, wide_check.KERNEL_NAME[kind])
                    print(f"time {label} {tier} (tile {plan['tile']}, {plan['tiles']} tiles on "
                          f"{plan['grid']} blocks): untouched {t['untouched'][0]} ms, without "
                          f"{variant} {t[variant][0]} ms (CUDA events, median of {args.reps} x "
                          f"{args.inner} calls); device time untouched {t['untouched'][1]} ms, "
                          f"without {variant} {t[variant][1]} ms (torch.profiler, {args.inner} "
                          "calls); order untouched, variant, variant, untouched")
                    rows.append((f"{label} {tier}", variant,
                                 *(wide_check.mean(t[w][i]) for i in (0, 1)
                                   for w in ("untouched", variant))))
        print("split (ms; untouched is the mean of the two runs beside each variant; the "
              "cost and its share are of the device time):")
        print("| kernel | part dropped | untouched (events) | without it (events) | untouched "
              "(device) | without it (device) | its cost | share |")
        print("| --- | --- | --- | --- | --- | --- | --- | --- |")
        for label, variant, ref, ms, dref, dms in rows:
            print(f"| {label} | {variant} | {ref:.4f} | {ms:.4f} | {dref:.4f} | {dms:.4f} | "
                  f"{dref - dms:.4f} | {(dref - dms) / dref:.1%} |")
    return 0


# Patches of mlp_fwd_tangents.cu's f32 body, per version: variant ->
# [(regex, replacement)]. The first body stages the stack with `stage` and
# a bias loop per chunk; the redesigned one with `issue_chunk`.
K2_PATCHES = {
    "first": {
        "staging": [(r"stage\(s_wh, src_w, nl \* W \* W\);", "(void)0;"),
                    (r"for \(int i = tid; i < nl \* W; i \+= kThreads\) s_bh\[i\] = src_b\[i\];",
                     "(void)0;")],
        "tanh": [(r"return tanhf\(z\);", "return z;")],
    },
    "current": {
        "staging": [(r"(__device__ void issue_chunk\([^{]*\{)", r"\1\n  return;")],
        "tanh": [(r"return tanhf\(z\);", "return z;")],
        "exchange": [(r"other\[m\] = __shfl_xor_sync\(kFullMask, own\[m\], 1\);",
                      "other[m] = own[m];")],
    },
}


def k2_version(text: str) -> str:
    """Which table of :data:`K2_PATCHES` a ``mlp_fwd_tangents.cu`` takes."""
    return "current" if "namespace k2f32" in text else "first"


def k2_shapes(dev, tmp: str) -> dict:
    """K2-f32's path shapes (``chip_smoke.k2_path_shapes``), the serving
    grid's points from ``cli synth`` under ``tmp``."""
    import torch

    import chip_smoke
    from pinn_depthestimation_tpu_torch import benchmarks
    from pinn_depthestimation_tpu_torch.config import load_config
    from pinn_depthestimation_tpu_torch.data import load_test_data
    from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy

    flag = MLPSpec(sizes=benchmarks.FLAGSHIP_SIZES, init_type="xavier")
    x_serve = torch.as_tensor(load_test_data(load_config(
        chip_smoke.newmethod_config(tmp, REPO))).inputs).to(dev)
    serve = (flag, params_from_numpy(chip_smoke.numpy_params(flag.sizes, "xavier", 3), dev), x_serve)
    return chip_smoke.k2_path_shapes(dev, REPO, serve,
                                     benchmarks.flagship_bench_inputs(10_000_000, dev))


def main_k2(args) -> int:
    """The ``--k2`` split (module docstring)."""
    import torch

    import chip_smoke
    from tools.k1_refactor_check import f32_plan_of, finish_build, launch_k2, start_build

    if not torch.cuda.is_available():
        print("walk_breakdown: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(chip_smoke.nvidia_smi("name,power.limit"))
    with open(os.path.join(args.csrc, "mlp_fwd_tangents.cu")) as f:
        text = f.read()
    table = K2_PATCHES[k2_version(text)]
    variants = tuple(table) + ("all",)
    print(f"sources {args.csrc} (K2-f32 body: {k2_version(text)}); variants {variants}")
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for variant in ("untouched",) + variants:
            d = os.path.join(tmp, variant)
            shutil.copytree(args.csrc, d)
            if variant != "untouched":
                with open(os.path.join(d, "mlp_fwd_tangents.cu"), "w") as f:
                    f.write(patch(text, variant, table, "mlp_fwd_tangents.cu"))
            procs[variant] = start_build(d, os.path.join(tmp, "build_" + variant),
                                         {"k2": {20, 10}}, ["f32"])
        libs = {v: finish_build(p) for v, p in procs.items()}
        rows = []
        for label, (spec, params, x, kt, epi) in k2_shapes(dev, tmp).items():
            n = x.shape[0]
            out = ({"fc": torch.empty(n, device=dev)} if epi else
                   {"y": torch.empty((n, spec.d_out), device=dev),
                    "dy": torch.empty((kt, n, spec.d_out), device=dev) if kt else None})
            inner = 2 if n > 1_000_000 else args.inner
            base = libs["untouched"][("k2", spec.width)]
            plan = (f32_plan_of(base, x, spec, kt) if hasattr(base, "k2_f32_threads")
                    else f"one thread a point, {-(-n // 256)} blocks of 256")
            for variant in variants:
                fns = {who: (lambda lib=libs[who][("k2", spec.width)]: launch_k2(
                    lib, params, x, spec, kt, "f32", epilogue=epi, **out))
                    for who in ("untouched", variant)}
                device = {"untouched": [], variant: []}
                with torch.no_grad():
                    for who in ("untouched", variant, variant, "untouched"):
                        d = chip_smoke.device_ms(fns[who], inner, "k2_")
                        device[who].append(float("nan") if d is None else d)
                print(f"time K2-f32 {label} ({n} points, K={kt}{', epilogue' if epi else ''}; "
                      f"{plan}): device time untouched {device['untouched']} ms, without "
                      f"{variant} {device[variant]} ms (torch.profiler, {inner} calls); order "
                      "untouched, variant, variant, untouched")
                rows.append((label, variant, sum(device["untouched"]) / 2,
                             sum(device[variant]) / 2))
        print("split (device ms; untouched is the mean of the two runs beside each variant; the "
              "cost and its share are of the untouched device time):")
        print("| shape | part dropped | untouched | without it | its cost | share |")
        print("| --- | --- | --- | --- | --- | --- |")
        for label, variant, ref, ms in rows:
            print(f"| {label} | {variant} | {ref:.4f} | {ms:.4f} | {ref - ms:.4f} | "
                  f"{(ref - ms) / ref:.1%} |")
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--csrc", default=os.path.join(REPO, "pinn_depthestimation_tpu_torch", "csrc"),
                        help="the kernels' sources to split (default: the package's)")
    parser.add_argument("--reps", type=int, default=7, help="CUDA-event repetitions per timing")
    parser.add_argument("--inner", type=int, default=20, help="calls per repetition")
    parser.add_argument("--wide", action="store_true",
                        help="split the wide body (mlp_wide.cuh) instead of the narrow walk")
    parser.add_argument("--tiers", default=None,
                        help="tiers to split (default: f32 for the narrow walk, f32,bf16 with "
                             "--wide)")
    parser.add_argument("--widths", default="64,128", help="--wide: hidden widths")
    parser.add_argument("--k2", action="store_true",
                        help="split K2 at f32 (mlp_fwd_tangents.cu) instead of the walk")
    args = parser.parse_args()
    if args.k2:
        return main_k2(args)
    if args.wide:
        args.tiers = args.tiers or "f32,bf16"
        return main_wide(args)

    import torch

    import chip_smoke
    from tools.k1_refactor_check import launch_k1, launch_k3, launch_k4, legacy_case

    if not torch.cuda.is_available():
        print("walk_breakdown: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(chip_smoke.nvidia_smi("name,power.limit"))
    print(ncu_status())
    tiers = (args.tiers or "f32").split(",")
    print(f"sources {args.csrc}; tiers {tiers}; patched: "
          f"{ {t: patch_target(args.csrc, t)[0] for t in tiers} }")

    with tempfile.TemporaryDirectory() as tmp:
        cases, n_grid, _ = chip_smoke.k1_cases(dev, REPO, tmp)
        _, k1_spec, k1_params, k1_batch = cases[0]
        _, _, res_pts, fid_pts = chip_smoke.cmb_bench_points(dev, tmp)
        _, k3_spec, k3_params, x, ybar, dybar, kt = chip_smoke.k3_cases(
            dev, REPO, tmp, res_pts, fid_pts)[0]
        _, k4_spec, k4_params, x4, ybar4, dybar4, kt4 = legacy_case(dev, tmp)
        libs = build(args.csrc, tmp, tiers)
        calls = {
            "k1": lambda lib, t: (lambda: launch_k1(lib, k1_params, k1_batch, k1_spec, t)),
            "k3": lambda lib, t: (lambda: launch_k3(lib, k3_params, x, ybar, dybar, k3_spec, kt,
                                                    t)),
            "k4": lambda lib, t: (lambda: launch_k4(lib, k4_params, x4, ybar4, dybar4, k4_spec,
                                                    kt4, t)),
        }
        labels = {"k1": f"K1-{{}} flagship, {n_grid} points",
                  "k3": f"K3-{{}} CMB net, {x.shape[0]} points, K={kt}",
                  "k4": f"K4-{{}} legacy net, {x4.shape[0]} points, K={kt4}"}
        rows = {}
        for tier in tiers:
            for kind in NARROW:
                label = labels[kind].format(tier)
                for variant in variants_of(args.csrc, tier):
                    times = {"untouched": [], variant: []}
                    device = {"untouched": [], variant: []}
                    for who in ("untouched", variant, variant, "untouched"):
                        fn = calls[kind](libs[(who, tier)][kind], tier)
                        times[who].append(chip_smoke.cuda_ms(fn, args.reps, args.inner))
                        d = chip_smoke.device_ms(fn, args.inner, chip_smoke.WALK_KERNEL[kind])
                        device[who].append(float("nan") if d is None else d)
                    mean = lambda v: sum(v) / len(v)  # noqa: E731
                    rows[(label, variant)] = (mean(times["untouched"]), mean(times[variant]),
                                              mean(device["untouched"]), mean(device[variant]))
                    print(f"time {label}: untouched {times['untouched']} ms, without "
                          f"{variant} {times[variant]} ms (CUDA events, median of {args.reps} x "
                          f"{args.inner} calls); device time untouched {device['untouched']} ms, "
                          f"without {variant} {device[variant]} ms (torch.profiler, "
                          f"{args.inner} calls); order untouched, variant, variant, untouched")
        print("split (ms; untouched is the mean of the two runs beside each variant; the "
              "cost and its share are of the device time):")
        print("| kernel | part dropped | untouched (events) | without it (events) | untouched "
              "(device) | without it (device) | its cost | share |")
        print("| --- | --- | --- | --- | --- | --- | --- | --- |")
        for (label, variant), (ref, ms, dref, dms) in rows.items():
            print(f"| {label} | {variant} | {ref:.4f} | {ms:.4f} | {dref:.4f} | "
                  f"{dms:.4f} | {dref - dms:.4f} | {(dref - dms) / dref:.1%} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
