"""Distributed rank transform: ring merge-count over the chain shards
(counterpart of the JAX package's ``parallel/ring_rank.py``).

The gather rank transform (``sharded.py``) puts the full ``(draws x
chains_total)`` sample on every device. This module computes the same tied
ranks with O(N_local) memory: every rank's sorted block travels the chain
ring once (``batch_isend_irecv`` to the ring neighbours), and each rank
counts, for every one of its own elements,

- ``cl``: the global count of strictly smaller elements,
- ``ce``: the global count of equal elements (ties),
- ``gpos``: each copy's global sorted position, from the ties held by
  ring-earlier ranks,

from which the reference's tied "average" rank is ``cl + (ce + 1)/2``
(StatsBase.tiedrank, reference src/utils.jl:169-193), the Blom / ``ndtri``
transform is elementwise, and a type-7 quantile is one masked SUM all-reduce
of the elements whose global sorted position is ``floor((N-1) p)`` or the
next.

Each rank sorts its block's rows ``(P, N_local)`` (K13 on the card, as the
one-card exact mode does), and a visiting sorted block is counted against
the local one row by row with ``torch.searchsorted`` (the JAX package
counts with two sorts of the concatenation and run-boundary scans, the
TPU's way around binary search).
Counts are integers (int32 below 2^31 entries a row), and the Blom
scores and the quantiles' order statistics are formed from them exactly
(``rank_normal_from_counts``, ``quantiles_from_positions``), so in float64
the ranks, medians and quantiles are those of the gather path, and in
float32 they stay right on rows of 2^24 entries and more. The exchanges
and the all-reduce go through ``comm.py`` (the ``mdt.comm`` region,
counted); the local work opens ``mdt.rank.ring``. NaN rows are poisoned by
the caller: what the counts say inside them does not matter.
"""

from __future__ import annotations

import torch

from ..kernels.tiedrank import blom_scores
from ..ops.ranknorm import quantile_index
from ..utils.profiling import annotate, host_sync
from .comm import all_reduce, ring_exchange

RING = "mdt.rank.ring"  # the region of the route's local work


def ring_rank_counts(xs: torch.Tensor, group, index: int, kshards: int):
    """Global tie-rank counts of the local rows ``xs`` ``(P, N_loc)``, each
    sorted ascending, of ring position ``index`` among ``kshards`` chain
    shards: ``(cl, ce, gpos)``, each ``(P, N_loc)`` (int32 while a row of
    the chain group holds fewer than 2^31 entries, else int64): the global
    counts of strictly smaller and of equal elements, and each copy's
    0-based global sorted position (ties held by ring-earlier ranks come
    first).
    The counts accumulate in place, so that a visiting block costs its own
    buffer and two count arrays at a time. Called outside the layer
    regions: the counting opens ``mdt.rank.ring``, each exchange
    ``mdt.comm``."""
    # int32 counts while a row of the chain group holds fewer than 2^31
    narrow = xs.shape[1] * kshards < 2**31
    with annotate(RING):
        cl = torch.searchsorted(xs, xs, side="left", out_int32=narrow)
        # each copy's place among its own block's ties, then the ties that
        # ring-earlier blocks hold, then every smaller element
        gpos = torch.arange(xs.shape[1], device=xs.device,
                            dtype=cl.dtype).sub(cl)
        ce = torch.searchsorted(xs, xs, side="right",
                                out_int32=narrow).sub_(cl)
    buf = xs
    for step in range(1, kshards):
        buf = ring_exchange(buf, group, index, kshards)
        with annotate(RING):
            less = torch.searchsorted(buf, xs, side="left", out_int32=narrow)
            neq = torch.searchsorted(buf, xs, side="right",
                                     out_int32=narrow).sub_(less)
            cl.add_(less)
            del less
            ce.add_(neq)
            if (index - step) % kshards < index:  # the block's owner is earlier
                gpos.add_(neq)
            del neq
    with annotate(RING):
        gpos.add_(cl)
    return cl, ce, gpos


def rank_normal_from_counts(cl, ce, ntotal: int, dtype):
    """Blom alpha=3/8 + inverse normal CDF of the tied ranks ``cl + (ce +
    1)/2`` (reference src/utils.jl:189-193), in ``dtype``, formed from the
    integer counts as K12 forms them (``kernels.tiedrank.blom_scores``): the
    twice-rank ``2 cl + ce + 1`` exact, so that the scores stay right on
    rows of 2^24 entries and more; in int64 where it outgrows int32 (rows
    of 2^30 entries and more), whatever the counts' dtype."""
    if 2 * ntotal + 1 >= 2**31:
        ce = ce.long()
    return blom_scores(torch.add(ce, cl, alpha=2).add_(1), ntotal, dtype)


def quantiles_from_positions(xs, gpos, ntotal: int, ps, group):
    """Type-7 quantiles of the global sample, ``(len(ps), P)``, from the
    local rows ``xs`` ``(P, N_loc)`` and their global positions ``gpos`` by
    one SUM all-reduce: each interpolates the order statistics at
    ``floor(h)`` and the next, ``h = (N - 1) p`` in float64 as
    ``ops.ranknorm.sorted_quantile`` forms it, which exactly one rank holds
    per row. Called outside the layer regions, as ``ring_rank_counts``."""
    lows, highs, gs = [], [], []
    with annotate(RING):
        for p in ps:
            lo, hi, g = quantile_index(ntotal, p)
            lows.append(torch.where(gpos == lo, xs, 0.0).sum(1))
            highs.append(torch.where(gpos == hi, xs, 0.0).sum(1))
            gs.append(g)
        vals = torch.stack(lows + highs)
    all_reduce(vals, group)
    with annotate(RING):
        vlo, vhi = vals[:len(ps)], vals[len(ps):]
        with host_sync("quantile_offset"):
            g = torch.tensor(gs, dtype=xs.dtype).to(xs.device)[:, None]
        return vlo + g * (vhi - vlo)
