"""The port's own regions in a traced window: device time by ``mdt.*``
region, idle time inside the public calls, and the host's waits for the
device.

The port opens ``mdt.*`` regions (``torch.profiler.record_function``) at
its layer boundaries; its ``utils/profiling.py`` lists them. A device
operation belongs to the innermost ``mdt.`` region open on the host when it
was launched, which may have closed before the operation ran. A ``Trace``
keeps the device operations and the host events, each ``(name, start,
end)`` on the profiler's clock, each operation's correlation id and the
start of the runtime call with the same id: the launch of each operation,
on whatever stream it ran (NCCL's kernels run on NCCL's own), and in any
rank's trace. Where an operation has no such call, the pairing is unknown
and the readers find nothing (None), as they do on a program that opens no
``mdt.`` region.

    python3 -m portbench.spans --workload <cell> --seed <n>

runs the cell's traced passes on the card and prints the coverage of the
regions, device ms a pass by region and the synchronizing runtime calls by
the region that made them.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from . import trace

PREFIX = "mdt."
CALLS = ("mdt.ess_rhat", "mdt.ess", "mdt.rhat", "mdt.rhat_nested")
RANK = ("mdt.rank.exact", "mdt.rank.fast")
LAUNCHES = {
    "kernel": ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx", "cudaLaunchCooperativeKernel"),
    "memcpy": ("cudaMemcpyAsync", "cudaMemcpy", "cudaMemcpy2DAsync"),
    "memset": ("cudaMemsetAsync", "cudaMemset"),
}
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")


def op_kind(name: str) -> str:
    """A device operation's kind by the profiler's name for it."""
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def launch_times(tr: trace.Trace) -> list | None:
    """The host time of the call that launched each of ``tr.device``, in
    its order, by correlation id, or None where an operation has no
    runtime call with its id."""
    if len(tr.corr) != len(tr.device):
        return None
    out = [tr.launched.get(i) for i in tr.corr]
    return None if None in out else out


class Regions:
    """The host regions whose name ``keep`` accepts, for the innermost one
    open at a time. Regions of one thread nest: the innermost region open
    at ``t`` is the latest-started one before ``t`` or, where that one has
    closed, the innermost of its enclosing regions that is still open."""

    def __init__(self, tr: trace.Trace, keep):
        # by start, an enclosing region before those it encloses
        spans = sorted((a, -b, n) for n, a, b in tr.host if keep(n))
        self.starts = [a for a, _, _ in spans]
        self.ends = [-b for _, b, _ in spans]
        self.names = [n for _, _, n in spans]
        self.parent, open_ = [], []
        for j, a in enumerate(self.starts):
            while open_ and self.ends[open_[-1]] < a:
                open_.pop()
            self.parent.append(open_[-1] if open_ else -1)
            open_.append(j)

    def __bool__(self):
        return bool(self.names)

    def at(self, t: float) -> str | None:
        j = bisect.bisect_right(self.starts, t) - 1
        while j >= 0 and self.ends[j] < t:
            j = self.parent[j]
        return self.names[j] if j >= 0 else None


def attributed(tr: trace.Trace) -> list | None:
    """``(region, launch, start, end)`` for each device operation: the
    innermost ``mdt.`` region open at its launch (None outside every one)
    and the launch's host time, or None where the trace has no such region
    or no pairing."""
    regions = Regions(tr, lambda n: n.startswith(PREFIX))
    if not regions:
        return None
    times = launch_times(tr)
    if times is None:
        return None
    return [(regions.at(t), t, a, b) for t, (_, a, b) in zip(times, tr.device)]


def by_span(tr: trace.Trace) -> dict | None:
    """Device seconds a pass of each ``mdt.`` region (operations launched
    outside every one are left out), or None as ``attributed``."""
    ops = attributed(tr)
    if ops is None:
        return None
    out = defaultdict(float)
    for region, _, a, b in ops:
        if region is not None:
            out[region] += (b - a) / 1e6 / tr.passes
    return dict(out)


def device_ms(tr, names) -> float | None:
    """Device ms a pass of the regions ``names``, or None where none of
    them holds an operation."""
    if tr is None:
        return None
    spans = by_span(tr) or {}
    held = [spans[n] for n in names if n in spans]
    return sum(held) * 1e3 if held else None


def idle_in_calls(tr: trace.Trace) -> float | None:
    """Idle ms a pass inside the public calls' regions: the stretches of the
    window in which no device operation ran, where a call region is open.
    None where the trace has no call region."""
    calls = [(a, b) for n, a, b in tr.host if n in CALLS]
    if not calls or not tr.device:
        return None
    lo, hi = tr.window
    idle = trace.gaps([(a, b) for _, a, b in tr.device], lo, hi)
    inside = 0.0
    for a, b in idle:
        inside += trace.union_us([(max(a, c), min(b, d)) for c, d in calls
                                  if c < b and d > a])
    return inside / 1e3 / tr.passes


def syncs_by_region(tr: trace.Trace) -> dict:
    """Synchronizing runtime calls a pass, by the innermost ``mdt.`` or
    harness (``portbench.``) region open at each (None: outside all)."""
    regions = Regions(tr, lambda n: n.startswith((PREFIX, "portbench."))
                      and n != "portbench.window")
    out = defaultdict(float)
    for n, a, _ in tr.host:
        if n in SYNCS:
            out[regions.at(a)] += 1 / tr.passes
    return dict(out)


def coverage(tr: trace.Trace) -> dict | None:
    """The device seconds a pass given to ``mdt.`` regions against those of
    the window outside the harness's copies to the host
    (``portbench.to_host``), and those of the layer regions against those
    of every region inside a call."""
    ops = attributed(tr)
    if ops is None:
        return None
    to_host = Regions(tr, lambda n: n == "portbench.to_host")
    mdt = rest = layers = 0.0
    for region, t, a, b in ops:
        s = (b - a) / 1e6 / tr.passes
        if region is not None:
            mdt += s
            if region not in CALLS:
                layers += s
        elif to_host.at(t) is None:
            rest += s
    return {"mdt_s": mdt, "outside_s": rest, "mdt_share": mdt / (mdt + rest),
            "layer_share": layers / mdt if mdt else None}


def main(argv=None) -> int:
    import argparse
    import importlib
    import json

    import torch

    from . import spec, traffic
    from .run import PORT, WARMUP_PASSES
    from .sample import make_sample

    ap = argparse.ArgumentParser(prog="python3 -m portbench.spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device")
        return 2
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    config = spec.config(bench, cell["config"])
    port = importlib.import_module(PORT)
    x = make_sample(config, args.seed, "cuda")
    one_pass = traffic.build_pass(spec.mix(cell["traffic"]), config, x, port)
    for _ in range(WARMUP_PASSES):
        one_pass()
    torch.cuda.synchronize()
    tr, _ = trace.run_traced(one_pass)
    counts = defaultdict(int)
    for n, _, _ in tr.host:
        if n in SYNCS or any(n in v for v in LAUNCHES.values()):
            counts[n] += 1
    kinds = defaultdict(int)
    for n, _, _ in tr.device:
        kinds[op_kind(n)] += 1
    spans = by_span(tr) or {}
    print(json.dumps({
        "cell": args.workload, "seed": args.seed, "passes": tr.passes,
        "device_ops": dict(kinds), "runtime_calls": dict(counts),
        "paired": launch_times(tr) is not None,
        "by_span_ms": {k: v * 1e3 for k, v in sorted(spans.items())},
        "idle_in_calls_ms": idle_in_calls(tr),
        "syncs_a_pass": {str(k): v for k, v in syncs_by_region(tr).items()},
        "coverage": coverage(tr),
        "busy_ms_a_pass": trace.busy_us(tr) / 1e3 / tr.passes,
    }, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
