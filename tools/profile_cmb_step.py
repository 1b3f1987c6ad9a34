#!/usr/bin/env python3
"""Where the CMB or the legacy Adam step's time goes, on one CUDA card.

    python3 tools/profile_cmb_step.py [--steps 50] [--pipeline cmb|legacy]

Builds the Trainer of ``benchmarks.run_cmb_step_bench`` (the reference CMB
net on ~20,500 collocation points and 200 fidelity rows, K2 + K3 on the
card) or, with ``--pipeline legacy``, of ``benchmarks.run_legacy_step_bench``
(``examples/legacy.json``'s net on 26,691 points at K=3 and 300 fidelity
rows), warms it up, then
runs ``--steps`` Adam steps under
``torch.profiler`` (CPU and CUDA activities) and prints: the host-clock
time per step, the device's busy time per step (the sum of the durations
of the device's own events: kernels, copies, fills; one stream, so they do
not overlap) and its idle share, the device operations per step, the
kernels that take the most device time and the host operations that take
the most host time. The profiler adds host overhead, so the host-clock
time of an unprofiled run is printed beside it. The last line is one JSON
object with the step's numbers (``ms_unprofiled``, ``ms_profiled``,
``device_busy_ms``, ``idle_share`` of the profiled step, and
``kernels_us_per_step``, each device kernel's time per step by name; null
where the profiler recorded no device event).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--pipeline", choices=["cmb", "legacy"], default="cmb")
    args = parser.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from pinn_depthestimation_tpu_torch import benchmarks

    if not torch.cuda.is_available():
        print("profile_cmb_step: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    n = args.steps
    with tempfile.TemporaryDirectory() as tmp:
        make = {"cmb": benchmarks.cmb_bench_trainer,
                "legacy": benchmarks.legacy_bench_trainer}[args.pipeline]
        trainer = make(tmp, n, dev)
        trainer._adam_steps(n)  # warm-up: the kernels' build, the allocator
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer._adam_steps(n)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3 / n
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer._adam_steps(n)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
    from torch.autograd import DeviceType

    # the device's own events, without the ranges of user annotations
    # (``Optimizer.step#...``), which span kernels counted already
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False) and "#" not in e.name]
    record = {"pipeline": args.pipeline, "steps": n,
              "ms_unprofiled": plain_ms, "ms_profiled": wall_ms, "device_busy_ms": None,
              "idle_share": None, "kernels_us_per_step": None,
              "device": torch.cuda.get_device_name(dev)}
    print(f"{record['device']}; {args.pipeline} Adam step, {n} steps: {plain_ms:.4f} "
          f"ms per step unprofiled, {wall_ms:.4f} ms profiled (host clock)")
    if not device:
        print("the profiler recorded no device events on this machine")
        print(json.dumps(record))
        return 0
    busy = sum(e.time_range.elapsed_us() for e in device) / 1e3 / n
    print(f"device busy {busy:.4f} ms per step ({len(device) / n:.1f} device operations per "
          f"step), idle share {1 - busy / wall_ms:.1%} of the profiled step, "
          f"{1 - busy / plain_ms:.1%} of the unprofiled one")
    by_name: dict[str, list[float]] = {}
    for e in device:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    print("device time per step by kernel (us per step, launches per step, name):")
    for name, times in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:12]:
        print(f"  {sum(times) / n:9.2f}  {len(times) / n:6.1f}  {name[:110]}")
    print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=15))
    record.update(device_busy_ms=busy, idle_share=1 - busy / wall_ms,
                  kernels_us_per_step={k: sum(v) / n for k, v in by_name.items()})
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
