"""K12 (``kernels.tiedrank.tied_blom``) on the flagship exact call's rows:
checkouts against each other, and the pieces of the scatter.

``python -m mcmcdiagnostictools_jl_tpu_torch.benchmarks.tiedrank_study
ROOT ...`` runs one child process a checkout root, in the order given (so
``a b b a`` compares two versions in turns, and a checkout with a kernel
changed by hand stands beside the one it came from). Each child imports the
package from its root, sorts the rows of the flagship sample
(``profile_calls.make_sample``, 10k draws x 128 chains x 256 params,
float32) as the exact call does (``ops.ranknorm.sort_with_positions``) and
prints one JSON line: K12's device time in sorted order and scattered back
by ``order`` with ``bad`` (CUDA events, median of 5).

``... tiedrank_study pieces`` times, in this checkout: the table fill
(``blom_table``); the scatter's two passes, each summed over the groups of
one call (pass A with its cursor memset); the whole scatter in groups of
P/2, P/4, ..., 4 rows, each held bit-equal to ``tied_blom``'s output; and
the peak memory of one call above what was allocated before it.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import torch

_CHILD = r"""
import json, sys
root, seed = sys.argv[1], int(sys.argv[2])
sys.path.insert(0, root)
import torch
import mcmcdiagnostictools_jl_tpu_torch as mtt
from mcmcdiagnostictools_jl_tpu_torch.benchmarks import profile_calls, time_ms
from mcmcdiagnostictools_jl_tpu_torch.kernels import tiedrank as k12
from mcmcdiagnostictools_jl_tpu_torch.ops.ranknorm import sort_with_positions
xs, order, bad = sort_with_positions(profile_calls.make_sample(seed, device="cuda"))
print(json.dumps({
    "root": root, "package": mtt.__file__,
    "sorted_ms": time_ms(lambda: k12.tied_blom(xs)),
    "scattered_ms": time_ms(lambda: k12.tied_blom(xs, order, bad))}))
"""


def compare(roots, seed: int = 20261016) -> list:
    """One child process per root, in the order given; their results."""
    out = []
    for root in roots:
        proc = subprocess.run([sys.executable, "-c", _CHILD, root, str(seed)],
                              capture_output=True, text=True, check=True)
        out.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(out[-1]), flush=True)
    return out


def pass_ms(xs, order, bad, reps: int = 5) -> tuple[float, float]:
    """Device ms of pass A (with its cursor memset) and of pass B of
    ``tied_blom(xs, order, bad)`` with Blom scores from the table, each
    summed over the groups of rows (CUDA events around each launch; median
    of ``reps`` after a warm-up)."""
    from ..kernels import tiedrank as k12

    p, n = xs.shape
    g = k12.group_rows(p)
    table = k12.blom_table(n, xs.device)
    out = torch.empty_like(xs)
    cursor = torch.empty((g, -(-n // k12._BUCKET)), dtype=torch.int32,
                         device=xs.device)
    pairs = torch.empty((g, n, 2), dtype=torch.int32, device=xs.device)
    runs = []
    for _ in range(reps + 1):
        events = [[torch.cuda.Event(enable_timing=True) for _ in range(3)]
                  for _ in range(0, p, g)]
        for (e0, e1, e2), r in zip(events, range(0, p, g)):
            rows = slice(r, r + g)
            e0.record()
            k12._launch_rows(xs[rows], order[rows], bad[rows],
                             k12._BLOM_TABLE, table, k12._inv_b(n),
                             cursor=cursor, pairs=pairs)
            e1.record()
            k12._place(pairs, cursor, bad[rows], out[rows])
            e2.record()
        torch.cuda.synchronize()
        runs.append((sum(e0.elapsed_time(e1) for e0, e1, _ in events),
                     sum(e1.elapsed_time(e2) for _, e1, e2 in events)))
    return (statistics.median(a for a, _ in runs[1:]),
            statistics.median(b for _, b in runs[1:]))


def pieces(seed: int = 20261016) -> dict:
    from ..kernels import tiedrank as k12
    from ..ops.ranknorm import sort_with_positions
    from . import profile_calls, time_ms

    xs, order, bad = sort_with_positions(
        profile_calls.make_sample(seed, device="cuda"))
    p, n = xs.shape
    res = {"rows": [p, n], "group_rows": k12.group_rows(p),
           "table_ms": time_ms(lambda: k12.blom_table(n, xs.device))}
    res["pass_a_ms"], res["pass_b_ms"] = pass_ms(xs, order, bad)
    table = k12.blom_table(n, xs.device)
    want = k12.tied_blom(xs, order, bad)
    res["groups"] = {}
    got = torch.empty_like(xs)

    def scatter(g):
        k12._scatter(xs, order, bad, k12._BLOM_TABLE, table, k12._inv_b(n),
                     got, g)

    g = k12.group_rows(p)
    while g >= 4:
        scatter(g)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise RuntimeError(f"groups of {g} rows differ from tied_blom")
        res["groups"][g] = time_ms(lambda: scatter(g))  # noqa: B023
        g //= 2
    del got, want
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    k12.tied_blom(xs, order, bad)
    torch.cuda.synchronize()
    res["scatter_peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    if sys.argv[1:] == ["pieces"]:
        pieces()
    else:
        compare(sys.argv[1:])
