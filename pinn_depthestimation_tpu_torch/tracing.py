"""Spans and counters of the port: where the program records what it did
and how long each layer took.

A span is ``with span("layer#name"):`` around a layer's work. It records
``(name, parent, start_ns, end_ns)`` on ``time.perf_counter_ns()`` into an
in-memory list; the parent is the span open when it began. While a
``torch.profiler`` records, a span also enters ``record_function(name)``,
so it sits on the profiler's timeline beside the kernels it launched (the
chrome trace of CLI ``train --profile``, or a benchmark's profile).

* Hot-path spans (:func:`span`) record only while tracing is on: while a
  profiler records, or after :func:`enable`. Off, a span costs one flag
  test; it reads no clock and enters no ``record_function``, which is a
  dispatcher op and costs microseconds even with no profiler running.
* Set-up spans (:func:`setup_span`) run once a process (the Trainer's
  construction, the kernel libraries' build and load) and always record.

Every name is ``<layer>#<span>``. The ``#`` keeps a range that the
profiler also shows on the device's timeline apart from the device's
operations, as torch's own ``Optimizer.step#Adam.step`` is.

:func:`summary` gives each name's count, total and self seconds (total
less the time its child spans cover) and parent; :func:`spans` the raw
list; :func:`reset` clears it.

The launch counters live here too: :func:`count_launch` raises a kernel
wrapper's ``.launches``, ``.launches_by_tier`` and ``.launches_by_body``
by one, :func:`reset_launches` zeroes them. A CUDA graph's capture launches
nothing: inside :func:`capturing_launches` the launches are noted, not
counted, and :func:`add_launches` counts the noted launches once for each
of a block's replays, so ``.launches`` stays the number of launches the card ran.

Counters of events (:func:`count`, :func:`counts`, :func:`reset_counts`)
always count, traced or not: the Trainer's Adam steps by how they ran
(``step#replay``: one replay of the step's CUDA graph; ``step#eager``: the
step issued op by op).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

from pinn_depthestimation_tpu_torch.ops import tiers, widths


class Span(NamedTuple):
    name: str
    parent: str | None
    start_ns: int
    end_ns: int


_spans: list[Span] = []
_open: list[str] = []  # names of the recording spans now open, innermost last
_enabled = False
_counts: dict[str, int] = {}
_noted: list | None = None  # launches noted, not counted, while a graph captures


class _Recording:
    __slots__ = ("name", "parent", "start", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.parent = _open[-1] if _open else None
        _open.append(self.name)
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _open.pop()
        _spans.append(Span(self.name, self.parent, self.start, end))
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """A hot-path span: records only while tracing is on, after
    :func:`enable` or while a ``torch.profiler`` records."""
    if _enabled or _autograd_profiler._is_profiler_enabled:
        return _Recording(name)
    return _OFF


def setup_span(name: str):
    """A set-up span: always records."""
    return _Recording(name)


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    """Forget every recorded span."""
    _spans.clear()


def spans() -> list[Span]:
    """The recorded spans, in the order they ended."""
    return list(_spans)


def summary() -> dict[str, dict]:
    """Per name: ``count``, ``total_s``, ``self_s`` (total less the time its
    child spans cover) and ``parent`` (its first span's)."""
    # spans nest (each is a ``with`` on one thread), so sorted by start, the
    # open span that contains the next one is its parent
    order = sorted(_spans, key=lambda s: (s.start_ns, -s.end_ns))
    child_ns = {}
    stack: list[Span] = []
    for s in order:
        while stack and stack[-1].end_ns <= s.start_ns:
            stack.pop()
        if stack:
            child_ns[id(stack[-1])] = child_ns.get(id(stack[-1]), 0) + s.end_ns - s.start_ns
        stack.append(s)
    out: dict[str, dict] = {}
    for s in _spans:
        row = out.setdefault(s.name, {"count": 0, "total_s": 0.0, "self_s": 0.0,
                                      "parent": s.parent})
        ns = s.end_ns - s.start_ns
        row["count"] += 1
        row["total_s"] += ns * 1e-9
        row["self_s"] += (ns - child_ns.get(id(s), 0)) * 1e-9
    return out


# ------------------------------------------------------------ event counts

def count(name: str, n: int = 1) -> None:
    """``n`` more events ``name`` (``<layer>#<event>``)."""
    _counts[name] = _counts.get(name, 0) + n


def counts() -> dict[str, int]:
    """Every event's count since the last :func:`reset_counts`."""
    return dict(_counts)


def reset_counts() -> None:
    _counts.clear()


# ------------------------------------------------------------ launch counts

def count_launch(wrapper, precision: str, spec=None) -> None:
    """One more launch of ``wrapper``'s kernel at ``precision``, by the body
    that runs ``spec`` (:func:`ops.widths.body`; none for a kernel that runs
    no net, such as Adam's update). Inside :func:`capturing_launches` the
    launch is noted, not counted."""
    body = None if spec is None else widths.body(spec)
    if _noted is not None:
        _noted.append((wrapper, precision, body))
        return
    wrapper.launches += 1
    wrapper.launches_by_tier[precision] += 1
    if body is not None:
        wrapper.launches_by_body[body] += 1


class capturing_launches:
    """``with capturing_launches() as noted:`` around a CUDA graph's
    capture: each :func:`count_launch` inside appends ``(wrapper, precision,
    body)`` to ``noted`` and counts nothing, on every thread (the backward
    of a captured step runs on autograd's)."""

    def __enter__(self) -> list:
        global _noted
        if _noted is not None:
            raise RuntimeError("capturing_launches does not nest")
        _noted = []
        return _noted

    def __exit__(self, *exc):
        global _noted
        _noted = None
        return False


def add_launches(noted: list, times: int = 1) -> None:
    """Count the launches ``noted`` by :func:`capturing_launches`, ``times``
    over: a captured graph's replays."""
    for wrapper, precision, body in noted:
        wrapper.launches += times
        wrapper.launches_by_tier[precision] += times
        if body is not None:
            wrapper.launches_by_body[body] += times


def reset_launches(wrapper) -> None:
    wrapper.launches = 0
    wrapper.launches_by_tier = {t: 0 for t in tiers.TIERS}
    wrapper.launches_by_body = {b: 0 for b in widths.BODIES}
