"""The collectives of the sharded diagnostics, each in the ``mdt.comm``
region and counted (``utils.profiling.comm_counts``), and the chain group
of a mesh (:func:`mesh_chains`).

Every collective of ``sharded.py`` and ``ring_rank.py`` goes through one of
these functions: the SUM and MAX all-reduces, the all-gathers and the ring
route's exchange with its neighbours. A function sends what the bare
``torch.distributed`` call sends; it also counts, on this rank, the bytes
sent and received, by kind, as the ring algorithm moves them in a group of
``k`` ranks: an all-reduce of ``B`` bytes ``2 (k - 1) B / k`` each way, an
all-gather of ``B`` bytes a rank ``(k - 1) B`` each way, an exchange the
bytes of the block sent and of the block received; nothing in a group of
one. (NCCL may take another algorithm for a small all-reduce; the ring's
count is the one a hand count of the route gives.) The layer regions open
around a call close before its ``mdt.comm`` and open again after it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.moments import ChainGroup
from ..utils.profiling import comm_region, count_comm

_all_gather_into = (getattr(dist, "all_gather_single", None)
                    or dist.all_gather_into_tensor)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced in place over ``group`` (SUM unless ``op``)."""
    k = dist.get_world_size(group)
    moved = 2 * (k - 1) * _nbytes(t) // k
    with comm_region():
        count_comm("all_reduce", moved, moved)
        dist.all_reduce(t, op=op, group=group)
    return t


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    return all_reduce(t, group, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` (``size`` ranks), stacked: ``(size,
    *x.shape)`` (gathered concatenated along dim 0, the form gloo takes)."""
    moved = (size - 1) * _nbytes(x)
    with comm_region():
        count_comm("all_gather", moved, moved)
        out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
        _all_gather_into(out, x.contiguous(), group=group)
    return out.view(size, *x.shape)


def ring_exchange(buf: torch.Tensor, group, index: int,
                  kshards: int) -> torch.Tensor:
    """``buf`` sent to the next rank of the chain ring; returns the block of
    the previous one."""
    with comm_region():
        recv = torch.empty_like(buf)
        count_comm("send_recv", _nbytes(buf), _nbytes(recv))
        nxt = dist.get_global_rank(group, (index + 1) % kshards)
        prv = dist.get_global_rank(group, (index - 1) % kshards)
        ops = [dist.P2POp(dist.isend, buf, nxt, group),
               dist.P2POp(dist.irecv, recv, prv, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv


class MeshChains(ChainGroup):
    """The chains of a mesh's chain group, ``ranks`` blocks of them, one a
    rank: the sums over chains end in the collectives above."""

    def __init__(self, group, ranks: int):
        self.group, self.ranks = group, ranks

    def mean(self, *ts):
        n = ts[0].shape[0] * self.ranks
        sums = all_reduce(torch.stack([t.sum(0) for t in ts]), self.group)
        return tuple(sums[i] / n for i in range(len(ts)))

    def sum(self, t):
        return all_reduce(t.sum(0), self.group)

    def mean_of_means(self, t, n: int):
        return all_reduce(t * n, self.group) / (n * self.ranks)

    def all_same(self, samples):
        return self.same(samples.amin((0, 1)), samples.amax((0, 1)))

    def same(self, vmin, vmax):
        flags = all_reduce_max(torch.stack([vmax, -vmin]), self.group)
        return flags[0] == -flags[1]


def mesh_chains(cfg) -> MeshChains:
    """The chain group of a ``MeshConfig``: its ``chains`` process group."""
    return MeshChains(cfg.chain_group, cfg.chain_shards)
