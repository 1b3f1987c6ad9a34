"""The traced window, read from ``torch.profiler``: device operations, host
operations, busy time, and the breakdown the result line carries.

A traced run wraps its window in ``torch.profiler.profile`` (on the card
the CUDA activity alone: the device's operations and the runtime calls that
issue them) and in a host range named :data:`WINDOW`; everything here is
measured inside the window. Device operations are the profiler's CUDA
events (kernels, copies, fills) without user annotations; the busy time is
the length of their union, so overlapping operations count once (the
arithmetic of the repository's ``tools/profile_cmb_step.py``, with the
union in place of its sum over one stream).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

WINDOW = "portbench.window"


@dataclass
class TraceView:
    """What a per-layer reader reads: the traced window's length, its
    device and host operations as ``(name, start_s, end_s)`` from the
    window's start, the driver's counts of the work done in it (``work``),
    the cell's configuration and the table of peaks."""

    window_s: float
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    work: dict = field(default_factory=dict)
    config: dict = field(default_factory=dict)
    peaks: dict = field(default_factory=dict)

    def ops(self, *patterns: str) -> list:
        """The device operations whose name matches any of the regular
        expressions ``patterns``."""
        return [op for op in self.device if any(re.search(p, op[0]) for p in patterns)]

    def seconds(self, ops) -> float:
        return float(sum(end - start for _, start, end in ops))

    def busy_s(self) -> float:
        """The length of the union of the device operations."""
        return union_length([(s, e) for _, s, e in self.device])


def union_length(intervals) -> float:
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return float(total)


def from_profiler(prof, work: dict, config: dict, peaks: dict, window_s: float) -> TraceView:
    """The :class:`TraceView` of a profile around a window of ``window_s``
    seconds (the host's clock). The window starts at the host range
    :data:`WINDOW` where the profile recorded it, else at its first event;
    operations are clipped to the window. Host operations are what the
    profile recorded on the host: the runtime calls where only the device is
    traced, every operator where the host is too."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if not getattr(e, "is_user_annotation", False)]
    marks = [e for e in events if e.name == WINDOW and e.device_type == DeviceType.CPU]
    events = [e for e in events if e.name != WINDOW]
    if marks:
        w0 = marks[0].time_range.start
    else:
        w0 = min((e.time_range.start for e in events), default=0.0)
    w1 = w0 + window_s * 1e6
    view = TraceView(window_s=window_s, work=work, config=config, peaks=peaks)
    for e in events:
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if t <= s:
            continue
        op = (e.name, (s - w0) / 1e6, (t - w0) / 1e6)
        if e.device_type == DeviceType.CUDA:
            if "#" not in e.name:  # ranges such as Optimizer.step#Adam.step
                view.device.append(op)
        elif e.device_type == DeviceType.CPU:
            view.host.append(op)
    return view


def breakdown(view: TraceView, top: int = 10, gaps_named: int = 2000) -> dict:
    """``device_ops``: the device operations that took most time, summed by
    name; ``idle_gaps``: the device's idle time between operations, summed
    by the innermost host operation running at each gap's middle, over the
    ``gaps_named`` longest gaps (a gap under no host operation is the
    harness's or the program's Python)."""
    by_name: dict[str, float] = {}
    for name, s, e in view.device:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    gaps, end = [], 0.0
    for _, s, e in sorted(view.device, key=lambda op: op[1]):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if view.window_s > end:
        gaps.append((end, view.window_s))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:gaps_named]
    names = [op[0] for op in view.host]
    starts = np.array([op[1] for op in view.host])
    ends = np.array([op[2] for op in view.host])
    idle: dict[str, float] = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        inside = np.nonzero((starts <= mid) & (ends >= mid))[0] if len(names) else []
        name = names[inside[np.argmax(starts[inside])]] if len(inside) else "(python)"
        idle[name] = idle.get(name, 0.0) + (g1 - g0)
    idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in device_ops],
            "idle_gaps": [[n, s] for n, s in idle_gaps]}
