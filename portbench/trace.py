"""The traced window: passes under ``torch.profiler``, and the arithmetic
that the per-layer readers and the breakdown take from it.

The idle share is ``profile_calls.profile_call``'s arithmetic (the port's
``benchmarks/profile_calls.py``), copied here: 1 - (union of the device's
intervals: kernels, memsets, copies) / window. Times are microseconds on
the profiler's clock.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import torch

TRACE_PASSES = 10  # passes a traced run profiles, after the warm-up
NAME_CHARS = 200   # a device kernel's name is cut at its arguments and here


@dataclass
class Trace:
    device: list = field(default_factory=list)  # (name, start_us, end_us)
    host: list = field(default_factory=list)    # (name, start_us, end_us)
    window: tuple = (0.0, 0.0)                  # (start_us, end_us)
    passes: int = 0


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
    for e in prof.events():
        start = e.time_range.start
        if e.device_type.name == "CUDA":
            if getattr(e, "is_user_annotation", False):
                continue  # a host range drawn on the device's timeline
            tr.device.append((e.name, start, e.time_range.end))
        else:
            tr.host.append((e.name, start, e.time_range.end))
            if e.name == "portbench.window":
                tr.window = (start, e.time_range.end)
    return tr, results


def busy_us(tr: Trace) -> float:
    lo, hi = tr.window
    return union_us([(max(a, lo), min(b, hi)) for _, a, b in tr.device
                     if b > lo and a < hi])


def host_op_at(tr: Trace, t: float) -> str:
    """The innermost host operation running at ``t`` (the latest-started
    one that covers it), or ``"python"`` where none does."""
    best, best_start = "python", float("-inf")
    for name, a, b in tr.host:
        if a <= t <= b and a > best_start and name != "portbench.window":
            best, best_start = name, a
    return best


def breakdown(tr: Trace, top: int = 10) -> dict:
    """Seconds a pass: the device operations that took most, by name, and
    the idle gaps of the window, summed by the host operation that ran."""
    dev = defaultdict(float)
    for name, a, b in tr.device:
        dev[short_name(name)] += (b - a) / 1e6 / tr.passes
    idle = defaultdict(float)
    lo, hi = tr.window
    for a, b in gaps([(a, b) for _, a, b in tr.device], lo, hi):
        idle[host_op_at(tr, (a + b) / 2)] += (b - a) / 1e6 / tr.passes

    def best(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": best(dev), "idle_gaps": best(idle)}
