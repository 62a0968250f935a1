"""Walls and peak memory of the flagship ``ess_rhat`` calls of two checkouts
of the port, in turns on one card.

Each run is a fresh process that imports ``mcmcdiagnostictools_jl_tpu_torch``
from one checkout root (so two commits' packages never share a process or a
kernel build), makes the flagship sample (``profile_calls.make_sample``,
10k draws x 128 chains x 256 params, float32) and prints one JSON line: the
median wall of 5 warm calls of ``ess_rhat(kind="rank")`` in the exact and
the fast rank mode, each call ending in ``torch.cuda.synchronize()``, the
peak device memory of one call above what was allocated before it, and the
first parameter's ESS and R-hat. The roots run in the order given, so
``a b b a`` compares two versions in turns.

Run on a machine with the card, e.g. with the parent commit unpacked by
``git archive`` into a git-ignored directory: ``python -m
mcmcdiagnostictools_jl_tpu_torch.benchmarks.ab_walls parent/ . . parent/``.
"""

from __future__ import annotations

import json
import subprocess
import sys

_CHILD = r"""
import json, statistics, sys, time
root, seed = sys.argv[1], int(sys.argv[2])
sys.path.insert(0, root)
import torch
import mcmcdiagnostictools_jl_tpu_torch as mtt
from mcmcdiagnostictools_jl_tpu_torch.benchmarks import profile_calls
x3 = profile_calls.make_sample(seed, device="cuda")

def wall(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return statistics.median(out)

def peak_gb(fn):
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e9

exact = lambda: mtt.ess_rhat(x3, kind="rank")
fast = lambda: mtt.ess_rhat(x3, kind="rank", rank_mode="fast")
res = exact()
print(json.dumps({
    "root": root, "package": mtt.__file__, "exact_s": wall(exact),
    "fast_s": wall(fast), "exact_peak_gb": peak_gb(exact),
    "fast_peak_gb": peak_gb(fast), "ess0": float(res.ess[0]),
    "rhat0": float(res.rhat[0])}))
"""


def main(roots, seed: int = 20261016) -> list:
    """One child process per root, in the order given; their results."""
    out = []
    for root in roots:
        proc = subprocess.run([sys.executable, "-c", _CHILD, root, str(seed)],
                              capture_output=True, text=True, check=True)
        out.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
