"""Walls and peak memory of the flagship ``ess_rhat`` calls of two checkouts
of the port, in turns on one card.

Each run is a fresh process that imports ``mcmcdiagnostictools_jl_tpu_torch``
from one checkout root (so two commits' packages never share a process or a
kernel build), makes the flagship sample (``profile_calls.make_sample``,
10k draws x 128 chains x 256 params, float32) and prints one JSON line: the
median wall of 5 warm calls of ``ess_rhat(kind="rank")`` in the exact and
the fast rank mode, of the exact call with ``param_chunk=64`` (the bench's
setting: 64 parameters a slice) and with ``fold_impl="sort"`` (the fold
sorted, not merged), each call ending in ``torch.cuda.synchronize()``, the
peak device memory of one call above what was allocated before it
(``benchmarks.peak_gb``, whose text the child carries, since an older
checkout's package may lack it), and the first parameter's ESS and R-hat.
The roots run in the order given, so ``a b b a`` compares two versions in
turns.

Run on a machine with the card, e.g. with the parent commit unpacked by
``git archive`` into a git-ignored directory: ``python -m
mcmcdiagnostictools_jl_tpu_torch.benchmarks.ab_walls parent/ . . parent/``.
"""

from __future__ import annotations

import inspect
import json
import subprocess
import sys

from . import peak_gb

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

""" + inspect.getsource(peak_gb) + r"""
exact = lambda: mtt.ess_rhat(x3, kind="rank")
fast = lambda: mtt.ess_rhat(x3, kind="rank", rank_mode="fast")
chunked = lambda: mtt.ess_rhat(x3, kind="rank", param_chunk=64)
fold_sort = lambda: mtt.ess_rhat(x3, kind="rank", fold_impl="sort")
res = exact()
print(json.dumps({
    "root": root, "package": mtt.__file__, "exact_s": wall(exact),
    "fast_s": wall(fast), "exact_chunk64_s": wall(chunked),
    "exact_sort_s": wall(fold_sort), "exact_peak_gb": peak_gb(exact),
    "fast_peak_gb": peak_gb(fast), "exact_chunk64_peak_gb": peak_gb(chunked),
    "exact_sort_peak_gb": peak_gb(fold_sort), "ess0": float(res.ess[0]),
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
