"""The port's rank-local nested R-hat (``parallel.rhat_nested_local``) and the
float32 arithmetic that rows of 2^24 entries and more need.

On gloo worlds of four CPU processes (``tests/torch_dist.py``), each rank
passes its own block of a float32 sample with ties, a NaN column and
superchains that sit whole on each rank, with the global ids: every kind,
through the ring and the gather routes, equals the one-process
``rhat_nested`` to float32 rounding (2 ULP at 1) and the JAX package's
float64 ``rhat_nested`` within ``PARITY_F64``; every rank's result equals
rank 0's bit for bit. A block that splits a superchain raises; the bytes the
collectives send are those counted by hand.

Without a world: the ring's two accumulators ``(t, gpos)`` at every ring
position of rings of 2, 3 and 4 blocks equal the counts the route formed
before them (``cl``, ``ce`` and the global positions by
``torch.searchsorted``), integer for integer; the Blom scores of the ring
route and of K12's plain version (``kernels.tiedrank.blom_scores``) stay
finite and within 2 float32 ULP of float64 at the ends of rows of 2^24 to
2^26 entries, where the float32 quotient gave +inf; the type-7 median of
a row of 25M entries interpolates its two middle order statistics with
weight 1/2, in ``sorted_quantile`` and in the ring route's
``quantiles_from_positions``.
"""

import math

import numpy as np
import pytest
import torch

import mcmcdiagnostictools_jl_tpu as mdt
import mcmcdiagnostictools_jl_tpu_torch as mtt
from mcmcdiagnostictools_jl_tpu_torch import kernels
from mcmcdiagnostictools_jl_tpu_torch.kernels import tiedrank
from mcmcdiagnostictools_jl_tpu_torch.ops.ranknorm import (
    quantile_index,
    sorted_quantile,
)
from mcmcdiagnostictools_jl_tpu_torch.parallel import ring_rank
from torch_dist import MESH, run_world
from torch_parity import assert_close, old_ring_counts

KINDS = ["rank", "bulk", "tail", "basic"]
IMPLS = ["ring", "gather", "auto"]
F32_ROUNDING = dict(rtol=0, atol=2.4e-7)  # 2 ULP of float32 at 1
LOCAL = "parallel.rhat_nested_local"


def _sample():
    rng = np.random.default_rng(20261018)
    x = rng.standard_normal((200, 32, 5)).astype(np.float32)
    x[:, :, 1] = np.round(x[:, :, 1] * 2) / 2  # many ties
    x[:, :, 4] = np.sign(x[:, :, 4])  # two values
    x[7, 3, 2] = np.nan  # poisons parameter 2 only
    x[:, 4:8, 0] += 3.0  # one superchain of parameter 0 off
    return x


X = _sample()
# 8 superchains of 4 chains, two whole ones on each of the 4 ranks
IDS = np.repeat(np.arange(8), 4)
# on each rank its two superchains interleaved, and named out of order
INTERLEAVED = np.concatenate([np.tile([2 * r + 1, 2 * r], 4) for r in range(4)])
# superchains 1 and 2 each hold two chains of rank 0 and two of rank 1
SPLIT = np.repeat(np.arange(8), 4)
SPLIT[[6, 7, 8, 9]] = SPLIT[[8, 9, 6, 7]]


def _local(name, ids=IDS, **kw):
    return (name, "on_own_block", [LOCAL, X, ids, MESH], kw)


def _calls():
    calls = [_local(f"{impl}-{k}", kind=k, rank_impl=impl)
             for impl in IMPLS for k in KINDS]
    calls += [_local(f"interleaved-{impl}", INTERLEAVED, rank_impl=impl)
              for impl in ("ring", "gather")]
    calls += [_local("raises:split", SPLIT),
              _local("raises:length", IDS[:-4]),
              ("comm-ring", "comm_of", [LOCAL, X, IDS, MESH],
               dict(rank_impl="ring")),
              ("comm-gather", "comm_of", [LOCAL, X, IDS, MESH],
               dict(rank_impl="gather"))]
    return calls


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Rank 0's results of every call on a world of four chain shards; the
    world runs once, and every rank's results equal rank 0's bit for bit."""
    return run_world(tmp_path_factory.mktemp("local4"), 4, (4, 1),
                     _calls())[0]


@pytest.fixture(scope="module")
def world_2x2(tmp_path_factory):
    """The first four parameters over two chain shards and two parameter
    shards."""
    calls = [(f"{k}", "on_own_block", [LOCAL, X[:, :, :4], IDS, MESH],
              dict(kind=k, rank_impl="ring")) for k in KINDS]
    return run_world(tmp_path_factory.mktemp("local2x2"), 4, (2, 2),
                     calls)[0]


def _in_core(kind, ids=IDS):
    return mtt.rhat_nested(torch.from_numpy(X), ids, kind=kind)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("impl", IMPLS)
def test_matches_one_process_and_the_float64_reference(world, impl, kind):
    got = world[f"{impl}-{kind}"]
    assert got.dtype == np.float32 and got.shape == (5,)
    assert np.isnan(got[2]) and np.isfinite(got[[0, 1, 3, 4]]).all()
    assert got[0] > 1.1  # the superchain that sits off
    assert_close(got, _in_core(kind), **F32_ROUNDING)
    assert_close(got, mdt.rhat_nested(X.astype(np.float64), IDS, kind=kind))


@pytest.mark.parametrize("kind", KINDS)
def test_parameter_shards(world_2x2, kind):
    assert_close(world_2x2[kind], _in_core(kind)[:4], **F32_ROUNDING)


@pytest.mark.parametrize("impl", ["ring", "gather"])
def test_superchains_in_any_order_on_their_rank(world, impl):
    got = world[f"interleaved-{impl}"]
    assert_close(got, _in_core("rank", INTERLEAVED), **F32_ROUNDING)
    assert_close(got, mdt.rhat_nested(X.astype(np.float64), INTERLEAVED))


def test_a_block_that_splits_a_superchain_raises(world):
    kind, msg = world["raises:split"]
    assert kind == "ValueError" and "whole superchains" in msg
    kind, msg = world["raises:length"]
    assert kind == "ValueError" and "superchain_ids" in msg


def test_comm_counts_are_the_hand_counts(world):
    """Per rank, in a group of k = 4: an exchange sends and receives the
    block ``(P, N_local)``, three a ring pass, two passes (the bulk and the
    fold); an all-reduce of B bytes moves 2 (k - 1) B / k each way; the
    parameter group holds one rank, so its all-gather moves nothing."""
    p, itemsize, k = 5, 4, 4
    block = p * 200 * 8 * itemsize
    reduces = [p, 2 * p,  # the NaN flags (MAX); the median's order statistics
               2 * p, 2 * p, p,  # bulk: degenerate (MAX), two SUM levels
               2 * p, 2 * p, p]  # tail
    moved = sum(2 * (k - 1) * b * itemsize // k for b in reduces)
    assert world["comm-ring"] == {
        "send_recv": {"sent": 6 * block, "received": 6 * block},
        "all_reduce": {"sent": moved, "received": moved},
        "all_gather": {"sent": 0, "received": 0}}
    # the gather route: every rank's block once, and the two degenerate
    # checks of the nested reductions run on the gathered sample
    got = world["comm-gather"]
    assert got["all_gather"] == {"sent": (k - 1) * block,
                                 "received": (k - 1) * block}
    assert "send_recv" not in got


# ---- rows of 2^24 entries and more, without a sort ---------------------------


def _ulps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """``|got - want|`` in float32 ULPs of ``want`` (float64)."""
    w = want.float().abs()
    ulp = (torch.nextafter(w, torch.full_like(w, math.inf)) - w).double()
    return (got.double() - want).abs() / ulp


@pytest.mark.parametrize("n", [2**24, 2**24 + 1000, 25_000_000, 2**26,
                               2**30 + 1000])
def test_ring_scores_at_the_ends_of_long_rows(n):
    """Synthetic counts ``t = 2 cl + ce``, in the dtype
    ``ring_rank_counts`` gives them (int32 while the twice-rank fits, int64
    from rows of 2^30 entries on): the lowest and highest element, a tie of
    three at each end, and the two middle ranks."""
    dtype = torch.int32 if 2 * n + 1 < 2**31 else torch.int64
    cl = torch.tensor([[0], [1], [n - 1], [n - 3], [n // 2 - 1], [n // 2]],
                      dtype=torch.int64)
    ce = torch.tensor([[1], [3], [1], [3], [1], [1]], dtype=torch.int64)
    t = (2 * cl + ce).to(dtype)
    z = ring_rank.rank_normal_from_counts(t, n, torch.float32)
    r = cl.double() + (ce.double() + 1) / 2
    want = torch.special.ndtri((r - 0.375) / (n + 0.25))
    assert z.dtype == torch.float32 and bool(torch.isfinite(z).all())
    assert float(_ulps(z[:4], want[:4]).max()) <= 2
    assert float((z[4:].double() - want[4:]).abs().max()) < 1e-6
    # what the float32 quotient gave at the top
    old = torch.special.ndtri(((r.float() - 0.375) / (n + 0.25)))
    assert bool(torch.isinf(old[2]))


def test_k12_plain_scores_on_a_long_row_with_ties():
    """K12's plain version on a sorted row of 2^24 + 1000 entries in runs of
    two and three: finite, the ends within 2 ULP of float64, and the same
    arithmetic as the ring route's."""
    n = 2**24 + 1000
    xs = (torch.arange(n, dtype=torch.int64) * 2 // 5).float()[None]
    assert bool((xs[:, 1:] >= xs[:, :-1]).all())
    z = tiedrank.tied_blom_plain(xs)[0]
    assert bool(torch.isfinite(z).all())
    k = tiedrank._run_sums(xs)[0].double()
    want = torch.special.ndtri((k / 2 - 0.375) / (n + 0.25))
    ends = torch.cat([torch.arange(4), torch.arange(n - 4, n)])
    assert float(_ulps(z[ends], want[ends]).max()) <= 2
    assert torch.equal(z, tiedrank.blom_scores(tiedrank._run_sums(xs)[0], n,
                                               torch.float32))


def test_blom_scores_of_every_rank_of_a_row_of_the_exact_cell():
    """Every tied rank of a row of 1.28M entries (the batched cells' rows):
    within 4 ULP of float64 where ``|z| > 1`` (float32 ``ndtri``'s own
    error), within 1e-6 everywhere (near the middle the scores lie near 0),
    and the upper half the mirror of the lower. The float32 quotient's top
    score was thousands of ULP off."""
    n = 1_280_000
    k = torch.arange(2, 2 * n + 1)
    z = tiedrank.blom_scores(k, n, torch.float32)
    want = torch.special.ndtri((k.double() / 2 - 0.375) / (n + 0.25))
    tails = want.abs() > 1
    assert float(_ulps(z[tails], want[tails]).max()) <= 4
    assert float((z.double() - want).abs().max()) < 1e-6
    assert torch.equal(z.flip(0)[: n - 1], -z[: n - 1])
    old = torch.special.ndtri((k.float() * 0.5 - 0.375) / (n + 0.25))
    assert float(_ulps(old[-1:], want[-1:])) > 1000


@pytest.mark.parametrize("counts, dtype, to_k15", [
    (torch.int32, torch.float32, True),
    (torch.int64, torch.float32, False),
    (torch.int32, torch.float64, False),
    (torch.int64, torch.float64, False),
])
def test_ring_scores_go_to_k15_by_their_input(monkeypatch, counts, dtype,
                                              to_k15):
    """``rank_normal_from_counts`` hands int32 counts into float32 scores
    to K15's wrapper (``blom_from_counts``), and every other input to the
    plain ``blom_scores`` as before: no option decides it. Either way the
    scores are ``blom_scores(t + 1, n)``."""
    n = 5000
    t = torch.arange(1, 2 * n, 7, dtype=counts)[None].repeat(2, 1)
    seen = []

    def recorder(c, m):
        seen.append((c.dtype, m))
        return tiedrank.blom_from_counts(c, m)

    monkeypatch.setattr(ring_rank, "blom_from_counts", recorder)
    z = ring_rank.rank_normal_from_counts(t.clone(), n, dtype)
    assert seen == ([(torch.int32, n)] if to_k15 else [])
    assert z.dtype == dtype
    assert torch.equal(z, tiedrank.blom_scores(t + 1, n, dtype))


@pytest.mark.parametrize("n", [1, 1000, 2**24, 25_000_000])
def test_k15_wrapper_is_the_plain_version_on_the_cpu(n):
    """On the CPU ``blom_from_counts`` is ``blom_scores(t + 1, n)`` and
    launches nothing; it takes int32 counts of rows whose twice-rank fits
    int32 and raises for any other."""
    t = torch.cat([torch.arange(0, min(2 * n + 1, 4096)),
                   torch.arange(max(0, 2 * n - 4095), 2 * n + 1)]).int()
    kernels.reset_launch_counts()
    z = tiedrank.blom_from_counts(t.clone(), n)
    assert kernels.launch_counts()["K15"] == 0
    assert z.dtype == torch.float32 and bool(torch.isfinite(z).all())
    assert torch.equal(z, tiedrank.blom_scores(t + 1, n, torch.float32))
    with pytest.raises(ValueError):
        tiedrank.blom_from_counts(t.long(), n)
    with pytest.raises(ValueError):
        tiedrank.blom_from_counts(t, 2**30)


def test_the_median_of_an_even_row_of_25m_entries():
    n = 25_000_000
    assert quantile_index(n, 0.5) == (12_499_999, 12_500_000, 0.5)
    # float32 gave h = 12500000: the upper middle value alone
    assert float((n - 1) * torch.tensor(0.5, dtype=torch.float32)) == 12_500_000
    row = (torch.arange(n) >= n // 2).float()[None] * 2.0
    assert sorted_quantile(row, 0.5).tolist() == [1.0]


def test_ring_quantiles_pick_the_two_middle_order_statistics(monkeypatch):
    """A rank holding global sorted positions around the middle of 25M
    entries: its sums are what the all-reduce would add up."""
    monkeypatch.setattr(ring_rank, "all_reduce", lambda t, group: t)
    n = 25_000_000
    gpos = torch.tensor([[12_499_998, 12_499_999, 12_500_000, 12_500_001]])
    xs = torch.tensor([[1.0, 2.0, 4.0, 8.0]])
    got = ring_rank.quantiles_from_positions(xs, gpos, n, (0.5,), None)
    assert got.tolist() == [[3.0]]


# ---- the ring's two accumulators against the three counts they replace -----


def _tied_blocks(k, seed, p=4, n=60):
    """``k`` sorted blocks ``(p, n)`` with ties inside and across blocks:
    a row of normals, one on a coarse grid, one of +-0.0 and +-inf among
    integers, one of a single value."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((k, p, n), generator=g)
    x[:, 1] = torch.round(x[:, 1] * 2) / 2
    x[:, 2] = torch.randint(-2, 3, (k, n), generator=g).float()
    signed_zero = torch.tensor([-0.0, 0.0])[
        torch.randint(0, 2, (k, n), generator=g)]
    x[:, 2] = torch.where(x[:, 2] == 0, signed_zero, x[:, 2])
    x[:, 2, 0], x[:, 2, 1] = -torch.inf, torch.inf
    x[:, 3] = 1.5
    return [torch.sort(b, dim=1, stable=True).values for b in x]


def _fake_ring(monkeypatch, blocks, index):
    """``ring_rank``'s exchanges hand block ``index`` the blocks of its
    ring-earlier neighbours in turn, as the ring would."""
    steps = iter(range(1, len(blocks)))
    monkeypatch.setattr(
        ring_rank, "ring_exchange",
        lambda buf, group, i, k: blocks[(index - next(steps)) % k])


@pytest.mark.parametrize("kshards", [2, 3, 4])
def test_ring_accumulators_equal_the_searchsorted_counts(monkeypatch,
                                                         kshards):
    blocks = _tied_blocks(kshards, 20261018 + kshards)
    n_all = sum(b.shape[1] for b in blocks)
    positions = []
    kernels.reset_launch_counts()
    for index in range(kshards):
        _fake_ring(monkeypatch, blocks, index)
        t, gpos = ring_rank.ring_rank_counts(blocks[index], None, index,
                                             kshards)
        cl, ce, want_gpos = old_ring_counts(blocks, index)
        assert t.dtype == gpos.dtype == torch.int32
        assert torch.equal(t.long() + 1, 2 * cl + ce + 1)
        assert torch.equal(gpos.long(), want_gpos)
        _fake_ring(monkeypatch, blocks, index)
        t_alone, none = ring_rank.ring_rank_counts(
            blocks[index], None, index, kshards, positions=False)
        assert none is None and torch.equal(t_alone, t)
        positions.append(gpos)
    # the copies' global positions: each row a permutation of 0..N-1
    every = torch.sort(torch.cat(positions, dim=1).long(), dim=1).values
    assert torch.equal(every, torch.arange(n_all).expand_as(every))
    assert kernels.launch_counts()["K14"] == 0  # the plain version on the CPU


@pytest.mark.parametrize("kshards", [1, 2, 3, 4])
def test_ring_counts_are_int64_where_k14_cannot_count(kshards):
    """The accumulators are int32, which sends a block to K14 on the card,
    only where the twice-rank of a row of the chain group fits and K14
    takes a block's rows against a block; on a ring of one block K14's
    limit comes first: int64 from 2^30 - 2048 entries, where the twice-rank
    would still fit."""
    from mcmcdiagnostictools_jl_tpu_torch.kernels import mergecount

    twice_rank_edge = -(-(2**31 - 1) // (2 * kshards))  # first n it outgrows
    for n in sorted({2**30 - 2049, 2**30 - 2048, 2**30 - 1, 2**30,
                     twice_rank_edge - 1, twice_rank_edge}):
        narrow = ring_rank._count_dtype(n, kshards) == torch.int32
        assert narrow == (2 * n * kshards + 1 < 2**31
                          and mergecount.fits(n, n)), n
        if narrow:  # the kernel's own check passes
            assert n + n < 2**31 - mergecount._TILE
    if kshards == 1:
        assert ring_rank._count_dtype(2**30 - 2049, 1) == torch.int32
        assert ring_rank._count_dtype(2**30 - 2048, 1) == torch.int64

