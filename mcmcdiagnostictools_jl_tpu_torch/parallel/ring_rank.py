"""Distributed rank transform: ring merge-count over the chain shards
(counterpart of the JAX package's ``parallel/ring_rank.py``).

The gather rank transform (``sharded.py``) puts the full ``(draws x
chains_total)`` sample on every device. This module computes the same tied
ranks with O(N_local) memory: every rank's sorted block travels the chain
ring once (``batch_isend_irecv`` to the ring neighbours), and each rank
counts, for every one of its own elements and against every block ``b``
(its own first), ``less_b = #{b < x}`` and ``leq_b = #{b <= x}``, into two
accumulators:

- ``t = sum_b (less_b + leq_b) = 2 cl + ce``, the twice-rank minus 1
  (``cl`` the global count of strictly smaller elements, ``ce`` of equal
  ones, itself included);
- ``gpos = i + sum_{b earlier} leq_b + sum_{b later} less_b``: each copy's
  0-based global sorted position, ``i`` its index in its own sorted block,
  ties held by ring-earlier ranks first,

from which the reference's tied "average" rank is ``(t + 1) / 2``
(StatsBase.tiedrank, reference src/utils.jl:169-193), the Blom / ``ndtri``
transform is elementwise, and a type-7 quantile is one masked SUM all-reduce
of the elements whose global sorted position is ``floor((N-1) p)`` or the
next.

Each rank sorts its block's rows ``(P, N_local)`` (K13 on the card, as the
one-card exact mode does), and a visiting sorted block is counted against
the local one row by row by kernel K14 (``kernels.mergecount.merge_count``:
one merge of the two sorted rows, the counts added in place), or by its
plain version on ``torch.searchsorted`` off the card (the JAX package
counts with two sorts of the concatenation and run-boundary scans, the
TPU's way around binary search).
Counts are integers (int32 while the twice-rank of a row of the chain
group fits, below 2^30 entries, and K14 takes a block's rows, below 2^30 -
2048 entries; ``_count_dtype``), and the Blom scores and the quantiles'
order statistics are formed from them exactly (``rank_normal_from_counts``,
on the card from int32 counts by kernel K15 in one pass,
``quantiles_from_positions``), so in float64 the ranks, medians and
quantiles are those of the gather path, and in float32 they stay right on
rows of 2^24 entries and more. The exchanges and the all-reduce go through
``comm.py`` (the ``mdt.comm`` region, counted); the callers run this
module's functions inside ``mdt.rank.ring``, which ``comm.py`` closes
around each collective. NaN rows are poisoned by the caller: what the
counts say inside them does not matter.
"""

from __future__ import annotations

import torch

from ..kernels.mergecount import fits, merge_count
from ..kernels.tiedrank import blom_from_counts, blom_scores
from ..ops.ranknorm import quantile_index
from ..utils.profiling import host_sync
from .comm import all_reduce, ring_exchange

RING = "mdt.rank.ring"  # the region of the route's work


def _count_dtype(n_loc: int, kshards: int):
    """The accumulators' dtype on a ring of ``kshards`` blocks of rows of
    ``n_loc`` entries: int32 (K14 on the card) while the twice-rank of a row
    of the chain group fits and K14 takes a row against a block, else int64
    (the plain version)."""
    narrow = 2 * n_loc * kshards + 1 < 2**31 and fits(n_loc, n_loc)
    return torch.int32 if narrow else torch.int64


def ring_rank_counts(xs: torch.Tensor, group, index: int, kshards: int, *,
                     positions: bool = True):
    """Global tie-rank counts of the local rows ``xs`` ``(P, N_loc)``, each
    sorted ascending, of ring position ``index`` among ``kshards`` chain
    shards: ``(t, gpos)``, each ``(P, N_loc)`` (module docstring; in
    ``_count_dtype``), ``gpos`` None unless ``positions``.
    The counts accumulate in place (K14 on the card), so that a visiting
    block costs its own buffer alone."""
    t = torch.empty(xs.shape, dtype=_count_dtype(xs.shape[1], kshards),
                    device=xs.device)
    gpos = torch.empty_like(t) if positions else None
    merge_count(xs, xs, t, gpos, first=True)
    buf = xs
    for step in range(1, kshards):
        buf = ring_exchange(buf, group, index, kshards)
        # the block's owner, (index - step) % kshards, earlier or later
        merge_count(xs, buf, t, gpos, earlier=(index - step) % kshards < index)
    return t, gpos


def rank_normal_from_counts(t, ntotal: int, dtype):
    """Blom alpha=3/8 + inverse normal CDF of the tied ranks ``(t + 1) /
    2`` (reference src/utils.jl:189-193), in ``dtype``, formed from the
    integer counts as K12 forms them (``kernels.tiedrank.blom_scores``): the
    twice-rank ``t + 1 = 2 cl + ce + 1`` exact, so that the scores stay
    right on rows of 2^24 entries and more; in int64 where it outgrows
    int32 (rows of 2^30 entries and more), whatever the counts' dtype.
    int32 counts into float32 go through K15 (``blom_from_counts``: one
    pass on the card, written over ``t``'s storage). Consumes ``t``: the 1
    is added in place."""
    if (t.dtype == torch.int32 and dtype == torch.float32
            and 2 * ntotal + 1 < 2**31):
        return blom_from_counts(t, ntotal)
    if 2 * ntotal + 1 >= 2**31:
        t = t.long()
    return blom_scores(t.add_(1), ntotal, dtype)


def quantiles_from_positions(xs, gpos, ntotal: int, ps, group):
    """Type-7 quantiles of the global sample, ``(len(ps), P)``, from the
    local rows ``xs`` ``(P, N_loc)`` and their global positions ``gpos`` by
    one SUM all-reduce: each interpolates the order statistics at
    ``floor(h)`` and the next, ``h = (N - 1) p`` in float64 as
    ``ops.ranknorm.sorted_quantile`` forms it, which exactly one rank holds
    per row."""
    lows, highs, gs = [], [], []
    for p in ps:
        lo, hi, g = quantile_index(ntotal, p)
        lows.append(torch.where(gpos == lo, xs, 0.0).sum(1))
        highs.append(torch.where(gpos == hi, xs, 0.0).sum(1))
        gs.append(g)
    vals = torch.stack(lows + highs)
    all_reduce(vals, group)
    vlo, vhi = vals[:len(ps)], vals[len(ps):]
    with host_sync("quantile_offset"):
        g = torch.tensor(gs, dtype=xs.dtype).to(xs.device)[:, None]
    return vlo + g * (vhi - vlo)
