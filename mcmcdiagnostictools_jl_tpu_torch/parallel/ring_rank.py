"""Distributed rank transform: ring merge-count over the chain shards
(counterpart of the JAX package's ``parallel/ring_rank.py``).

The gather rank transform (``sharded.py``) puts the full ``(draws x
chains_total)`` sample on every device. This module computes the same tied
ranks with O(N_local) memory: every rank's sorted block travels the chain
ring once (``batch_isend_irecv`` to the ring neighbours), and each rank
counts, for every one of its own elements,

- ``cl``: the global count of strictly smaller elements,
- ``ce``: the global count of equal elements (ties),
- ``eq_before``: ties held by ring-earlier ranks (fixes each copy's global
  sorted position),

from which the reference's tied "average" rank is ``cl + (ce + 1)/2``
(StatsBase.tiedrank, reference src/utils.jl:169-193), the Blom / ``ndtri``
transform is elementwise, and a type-7 quantile is one masked SUM all-reduce
of the elements whose global sorted position is ``floor((N-1) p)`` or the
next.

A visiting sorted block is counted against the local one column by column
with ``torch.searchsorted`` (the JAX package counts with two sorts of the
concatenation and run-boundary scans, the TPU's way around binary search).
Counts are int64, so in float64 the ranks, medians and quantiles are those
of the gather path bit for bit. NaN columns are poisoned by the caller: what
the counts say inside them does not matter.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _ring_exchange(buf: torch.Tensor, group, index: int, kshards: int):
    """``buf`` sent to the next rank of the chain ring; returns the block of
    the previous one."""
    recv = torch.empty_like(buf)
    nxt = dist.get_global_rank(group, (index + 1) % kshards)
    prv = dist.get_global_rank(group, (index - 1) % kshards)
    ops = [dist.P2POp(dist.isend, buf, nxt, group),
           dist.P2POp(dist.irecv, recv, prv, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def ring_rank_counts(xs: torch.Tensor, group, index: int, kshards: int):
    """Global tie-rank counts of the local sorted ``(N_loc, P)`` block
    ``xs`` of ring position ``index`` among ``kshards`` chain shards:
    ``(cl, ce, gpos)``, each int64 ``(N_loc, P)``: the global counts of
    strictly smaller and of equal elements, and each copy's 0-based global
    sorted position (ties held by ring-earlier ranks come first)."""
    xt = xs.t().contiguous()  # binary search runs along the last dim
    start = torch.searchsorted(xt, xt, side="left")  # own run: first, end
    cl, ce = start, torch.searchsorted(xt, xt, side="right") - start
    eq_before = torch.zeros_like(cl)
    buf = xt
    for step in range(1, kshards):
        buf = _ring_exchange(buf, group, index, kshards)
        less = torch.searchsorted(buf, xt, side="left")
        neq = torch.searchsorted(buf, xt, side="right") - less
        cl, ce = cl + less, ce + neq
        if (index - step) % kshards < index:  # the block's owner is earlier
            eq_before = eq_before + neq
    idx = torch.arange(xt.shape[1], device=xs.device)
    gpos = cl + eq_before + (idx - start)
    return cl.t(), ce.t(), gpos.t()


def rank_normal_from_counts(cl, ce, ntotal: int, dtype):
    """Blom alpha=3/8 + inverse normal CDF of the tied ranks ``cl + (ce +
    1)/2`` (reference src/utils.jl:189-193)."""
    r = cl.to(dtype) + (ce.to(dtype) + 1.0) * 0.5
    return torch.special.ndtri((r - 0.375) / (ntotal + 0.25))


def quantiles_from_positions(xs, gpos, ntotal: int, ps, group):
    """Type-7 quantiles of the global sample, ``(len(ps), P)``, from one SUM
    all-reduce: each interpolates the order statistics at ``floor(h)`` and
    the next, ``h = (N - 1) p`` rounded as ``ops.ranknorm.sorted_quantile``
    rounds it, which exactly one rank holds per column."""
    lows, highs, gs = [], [], []
    for p in ps:
        h = (ntotal - 1) * torch.tensor(p, dtype=xs.dtype)
        lo = min(max(int(torch.floor(h)), 0), ntotal - 1)
        hi = min(lo + 1, ntotal - 1)
        lows.append(torch.where(gpos == lo, xs, 0.0).sum(0))
        highs.append(torch.where(gpos == hi, xs, 0.0).sum(0))
        gs.append(h - lo)
    vals = torch.stack(lows + highs)
    dist.all_reduce(vals, group=group)
    vlo, vhi = vals[:len(ps)], vals[len(ps):]
    g = torch.stack(gs).to(xs.device)[:, None]
    return vlo + g * (vhi - vlo)
