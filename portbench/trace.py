"""The traced window: passes under ``torch.profiler``, and the arithmetic
that the per-layer readers and the breakdown take from it.

The idle share is ``profile_calls.profile_call``'s arithmetic (the port's
``benchmarks/profile_calls.py``), copied here: 1 - (union of the device's
intervals: kernels, memsets, copies) / window. Times are microseconds on
the profiler's clock. Each device operation keeps its correlation id, and
the trace the start of the runtime or driver call that has the same id, so
that an operation is paired with the call that launched it whatever stream
it ran on (``spans.launch_times``).
"""

from __future__ import annotations

import heapq
from collections import defaultdict
from dataclasses import dataclass, field

import torch

TRACE_PASSES = 10  # passes a traced run profiles, after the warm-up
NAME_CHARS = 200   # a device kernel's name is cut at its arguments and here
RUNTIME_PREFIX = "cu"  # CUDA's runtime (cuda*) and driver (cu*) calls


@dataclass
class Trace:
    device: list = field(default_factory=list)  # (name, start_us, end_us)
    host: list = field(default_factory=list)    # (name, start_us, end_us)
    window: tuple = (0.0, 0.0)                  # (start_us, end_us)
    passes: int = 0
    corr: list = field(default_factory=list)      # correlation id of each device op
    launched: dict = field(default_factory=dict)  # id: start_us of its runtime call


def union_us(spans) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def gaps(spans, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, at = [], lo
    for a, b in sorted(spans):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def short_name(name: str) -> str:
    """A device operation's name without its argument list."""
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name.strip()[:NAME_CHARS]


def run_traced(one_pass):
    """``(trace, results)``: ``TRACE_PASSES`` passes under the profiler, the
    window from the first pass's call to the last pass's results."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    results = []
    with profile(activities=acts) as prof:
        with torch.profiler.record_function("portbench.window"):
            for _ in range(TRACE_PASSES):
                with torch.profiler.record_function("portbench.pass"):
                    results.append(one_pass())
    tr = Trace(passes=TRACE_PASSES)
    calls = []
    for e in prof.events():
        start = e.time_range.start
        if e.device_type.name == "CUDA":
            if getattr(e, "is_user_annotation", False):
                continue  # a host range drawn on the device's timeline
            tr.device.append((e.name, start, e.time_range.end))
            tr.corr.append(e.id)
        else:
            tr.host.append((e.name, start, e.time_range.end))
            if e.name == "portbench.window":
                tr.window = (start, e.time_range.end)
            elif e.name.startswith(RUNTIME_PREFIX):
                calls.append((e.id, start))
    ids = set(tr.corr)
    for i, start in calls:
        if i in ids:
            tr.launched[i] = min(start, tr.launched.get(i, start))
    return tr, results


def busy_us(tr: Trace) -> float:
    lo, hi = tr.window
    return union_us([(max(a, lo), min(b, hi)) for _, a, b in tr.device
                     if b > lo and a < hi])


def host_ops_at(tr: Trace, times) -> list[str]:
    """For each of ``times``, in ascending order, the innermost host
    operation running then (the latest-started one that covers it, the
    first listed of equal starts), or ``"python"`` where none does. One
    sweep: an operation that ended before a time ends before every later
    one."""
    spans = sorted((a, i, b, name) for i, (name, a, b) in enumerate(tr.host)
                   if name != "portbench.window")
    open_, j, out = [], 0, []
    for t in times:
        while j < len(spans) and spans[j][0] <= t:
            a, i, b, name = spans[j]
            heapq.heappush(open_, (-a, i, b, name))
            j += 1
        while open_ and open_[0][2] < t:
            heapq.heappop(open_)
        out.append(open_[0][3] if open_ else "python")
    return out


def breakdown(tr: Trace, top: int = 10) -> dict:
    """Seconds a pass: the device operations that took most, by name, and
    the idle gaps of the window, summed by the host operation that ran."""
    dev = defaultdict(float)
    for name, a, b in tr.device:
        dev[short_name(name)] += (b - a) / 1e6 / tr.passes
    idle = defaultdict(float)
    lo, hi = tr.window
    idle_gaps = gaps([(a, b) for _, a, b in tr.device], lo, hi)
    at = host_ops_at(tr, [(a + b) / 2 for a, b in idle_gaps])
    for name, (a, b) in zip(at, idle_gaps):
        idle[name] += (b - a) / 1e6 / tr.passes

    def best(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": best(dev), "idle_gaps": best(idle)}
