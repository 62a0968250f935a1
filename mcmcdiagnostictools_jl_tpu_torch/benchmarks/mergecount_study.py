"""K14, the ring route's merge-count, at the sharded cell's block.

``python -m mcmcdiagnostictools_jl_tpu_torch.benchmarks.mergecount_study``
(needs the card) counts sorted standard normal rows ``(50, 6.25M)`` (one
call of ``many_chains_c5x4.sharded`` on one rank: 50 parameters x 10,000
draws x 625 chains) against a second block of as many: K14 in each of its
four modes held bit for bit to its plain version, then timed in turns
behind a sleep on the card (medians of ``ROUNDS``) beside the plain
version of a visit with positions (two ``torch.searchsorted`` and the
int32 adds: the library figure); each mode's bound (its compulsory bytes at 3.35 TB/s, as ``k14_roofline``
counts them) and K14's launches one by one under the profiler (~1.5
min). The block shapes that lost to the kernel's (PERF.md, K14's design) are not
kept.
"""

from __future__ import annotations

import json

import torch

from . import interleaved_ms
from .radix_study import launches_ms

SHAPE = (50, 6_250_000)
SEED = 20261023
ROUNDS = 9
HBM = 3.35e12
# mode: (first, positions, bytes an entry of the local block as
# k14_roofline counts them)
MODES = {"own+pos": (True, True, 12), "visit+pos": (False, True, 24),
         "own t": (True, False, 8), "visit t": (False, False, 16)}


def main() -> dict:
    from ..kernels import mergecount as k14

    p, n = SHAPE
    g = torch.Generator(device="cuda").manual_seed(SEED)
    a = torch.sort(torch.randn(SHAPE, generator=g, device="cuda"), dim=1).values
    b = torch.sort(torch.randn(SHAPE, generator=g, device="cuda"), dim=1).values
    accs = [torch.zeros(SHAPE, dtype=torch.int32, device="cuda")
            for _ in range(2)]
    fns, equal = {}, {}
    for name, (first, pos, _) in MODES.items():
        other = a if first else b
        t, gpos = accs[0], accs[1] if pos else None
        start = [x.clone() for x in accs]
        k14.merge_count(a, other, t, gpos, first=first, earlier=True)
        got = [x.clone() for x in accs]
        for x, s in zip(accs, start):
            x.copy_(s)
        k14.merge_count_plain(a, other, t, gpos, first=first, earlier=True)
        equal[name] = torch.equal(got[0], t) and (
            not pos or torch.equal(got[1], gpos))
        fns[name] = (lambda o=other, f=first, gp=gpos:
                     k14.merge_count(a, o, accs[0], gp, first=f, earlier=True))
    if not all(equal.values()):
        raise RuntimeError(f"K14 differs from its plain version: {equal}")
    fns["plain visit+pos"] = lambda: k14.merge_count_plain(
        a, b, accs[0], accs[1], earlier=True)
    ms = interleaved_ms(fns, ROUNDS)
    bound = {name: p * n * nb / HBM * 1e3
             for name, (_, _, nb) in MODES.items()}
    pieces = launches_ms(lambda: k14.merge_count(a, b, accs[0], accs[1],
                                                 earlier=True))
    row = dict(shape=SHAPE, ms=ms, bound_ms=bound,
               share={k: bound[k] / ms[k] for k in MODES},
               visit_pos_launches=[(k[:60], v) for k, v in pieces],
               device=torch.cuda.get_device_name(0))
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
