"""The exact rank mode's fold sort in the port against the JAX package's:
``valley_sort_2d``, ``folded_rank_values_sorted(merge=)`` and the public
``fold_impl`` of ``ess``, ``rhat`` and ``ess_rhat``.

The port works on rows ``(P, N)``, one a parameter; the JAX package on
``(N, P)``, so each comparison takes the JAX function on the transpose.

- ``valley_sort_2d`` on rows at a block of 16 entries with N off a multiple
  of 16, and K10's plain version at the JAX package's block of 8192 with N
  below and above one block and off K10's tile of 2048: keys bit-identical
  to the JAX package's ``valley_sort_2d`` on the transpose and to
  ``torch.sort``'s, payloads a permutation and equal up to the order of
  tied keys (checked by routing the tied-average ranks back by payload),
  with heavy ties, +-inf, a NaN row (its median NaN), a constant row and a
  row whose median is NaN for being mostly +inf;
- the tied-average ranks on rows against the JAX package's
  ``_avg_ranks_sorted`` on the transpose, float64 within 1e-12;
- every kind with a tail R-hat (``tail``, ``rank``) x ``fold_impl`` in
  ``auto`` / ``sort`` / ``merge``, float64 on the CPU, within BASELINE.md's
  1e-6 of the JAX package at the same ``fold_impl``, and every exact kind of
  ``ess``, ``rhat`` and ``ess_rhat`` with each ``fold_impl``;
- the JAX package's ``ValueError`` for an unknown ``fold_impl``;
- the port's two routes agree on a column whose median is NaN although it
  holds no NaN (75 % of it +inf: the type-7 median is inf + g (inf - inf)).
  There every folded key is NaN, and the JAX package's two routes disagree
  (its unstable sorts leave the all-NaN keys in whatever order, and the
  tied ranks of NaN keys follow it), so it is held to no JAX result there;
  the port's stable sort and merge both keep the column's sorted order.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmcdiagnostictools_jl_tpu as mdt
import mcmcdiagnostictools_jl_tpu_torch as mtt
from conftest import ar1
from mcmcdiagnostictools_jl_tpu.ops import ranknorm as jrn
from mcmcdiagnostictools_jl_tpu_torch.diagnostics.ess_rhat import (
    _resolve_fold_merge)
from mcmcdiagnostictools_jl_tpu_torch.kernels import valley
from mcmcdiagnostictools_jl_tpu_torch.ops import ranknorm as rn
from torch_parity import assert_close, t

FOLD_IMPLS = ["auto", "sort", "merge"]


def _sample(rng, n, p):
    """``(n, 1, p)``: normal parameters, then heavy ties, +-inf, a NaN
    parameter, a constant one and a mostly +inf one."""
    x = rng.standard_normal((n, 1, p))
    x[:, 0, 1] = np.round(x[:, 0, 1] * 2) / 2
    x[:3, 0, 2] = [np.inf, -np.inf, np.inf]
    x[5, 0, 3] = np.nan
    x[:, 0, 4] = 0.75
    x[rng.random(n) < 0.75, 0, 5] = np.inf
    return x


def _sorted_fold(x):
    """``(xs, order, med, folded)``, rows ``(P, N)``, through the port's own
    sort, ``med`` NaN where the row holds a NaN, as the tail transform makes
    them."""
    xs, order, bad = rn.sort_with_positions(t(x))
    med = torch.where(bad, torch.nan, rn.sorted_quantile(xs, 0.5))
    return xs, order, med, torch.abs(xs - med[:, None])


def _keys_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(a)
    np.testing.assert_array_equal(a[ok].view(np.int64), b[ok].view(np.int64))


def _routed_ranks(fs, forder):
    """Tied-average ranks of the sorted keys ``(P, N)``, routed back by
    payload: equal for two sorts that differ only in the payload order of
    tied keys."""
    r = rn._avg_ranks_sorted(torch.as_tensor(np.array(fs)))
    idx = torch.as_tensor(np.array(forder)).long()
    return torch.empty_like(r).scatter_(1, idx, r)


def _check_valley_sort(fs, forder, order, med, folded, s):
    """``(fs, forder)``, a sort of the valleys ``folded`` ``(P, N)`` carrying
    ``order``, against the JAX package's ``valley_sort_2d`` at block ``s``
    on the transpose and against a stable ``torch.sort`` along the rows."""
    jfs, jorder = jrn.valley_sort_2d(jnp.asarray(folded.numpy().T),
                                     jnp.asarray(order.numpy().T), s=s)
    jfs, jorder = np.asarray(jfs).T, np.asarray(jorder).T
    ref_k, ref_i = torch.sort(folded, dim=1, stable=True)
    _keys_equal(fs.numpy(), jfs)
    _keys_equal(fs.numpy(), ref_k.numpy())
    # payloads: the entries of each row once, tied keys in any order
    np.testing.assert_array_equal(np.sort(forder.numpy(), 1),
                                  np.sort(order.numpy(), 1))
    clean = ~torch.isnan(med)  # the JAX sorts order all-NaN keys freely
    want = _routed_ranks(ref_k, order.gather(1, ref_i))
    assert torch.equal(_routed_ranks(fs, forder), want)
    assert torch.equal(_routed_ranks(jfs, jorder)[clean], want[clean])
    # a row whose median is NaN keeps its sorted order
    assert torch.equal(forder[~clean], order[~clean])


@pytest.mark.parametrize("n", [16 * 7 + 5, 1000, 16])
def test_valley_sort_2d_matches_jax_and_torch_sort(n):
    rng = np.random.default_rng(n)
    xs, order, med, folded = _sorted_fold(_sample(rng, n, 6))
    fs, forder = rn.valley_sort_2d(folded, order, s=16)
    _check_valley_sort(fs, forder, order, med, folded, s=16)


# N below one valley block (8192), above it, and off K10's tile (2048)
@pytest.mark.parametrize("n", [5000, 8192 + 2048 * 3 + 77, 2 * 8192 + 1])
def test_valley_merge_plain_matches_jax_on_the_transpose(n):
    rng = np.random.default_rng(n + 7)
    xs, order, med, folded = _sorted_fold(_sample(rng, n, 6))
    assert bool(torch.isnan(med[3])) and bool(torch.isnan(med[5]))
    fs, forder = valley.valley_merge_plain(xs, order, med)
    assert fs.shape == forder.shape == (6, n)
    _check_valley_sort(fs, forder, order, med, folded,
                       s=valley._VALLEY_BLOCK)


@pytest.mark.parametrize("n,p", [(1, 3), (2, 1), (257, 6), (4000, 5)])
def test_avg_ranks_on_rows_match_jax_on_the_transpose(n, p):
    rng = np.random.default_rng(n * p)
    x = np.round(rng.standard_normal((p, n)) * 3) / 2  # heavy ties
    x[0, : n // 3] = np.inf
    if p > 2:
        x[2] = 0.5
        x[1, n // 2] = np.nan
    xs = np.sort(x, axis=1)
    got = rn._avg_ranks_sorted(t(xs))
    want = np.asarray(jrn._avg_ranks_sorted(jnp.asarray(xs.T))).T
    assert got.dtype == torch.float64 and got.shape == (p, n)
    assert_close(got, want, rtol=0, atol=1e-12)


def test_valley_merge_on_the_cpu_is_its_plain_version():
    rng = np.random.default_rng(3)
    xs, order, med, _ = _sorted_fold(_sample(rng, 777, 6))
    before = valley.valley_merge.launches
    got = valley.valley_merge(xs, order, med)
    assert valley.valley_merge.launches == before
    want = valley.valley_merge_plain(xs, order, med)
    for g, w in zip(got, want):
        assert torch.equal(torch.nan_to_num(g.double()),
                           torch.nan_to_num(w.double()))


def test_folded_routes_give_the_same_values_by_position():
    rng = np.random.default_rng(4)
    xs, order, med, _ = _sorted_fold(_sample(rng, 3001, 6))
    routed = []
    for merge in (None, "two_sort"):
        zf, forder = rn.folded_rank_values_sorted(xs, order, med, merge=merge)
        routed.append(torch.empty_like(zf).scatter_(1, forder, zf))
    assert torch.equal(routed[0], routed[1])


def _chains(rng, shape):
    x = ar1(rng, 0.5, 1.0, shape)
    x[:, 0, 0] += 1.5
    x[:, :, 1] = np.round(x[:, :, 1])  # ties
    return x


@pytest.mark.parametrize("fold_impl", FOLD_IMPLS)
@pytest.mark.parametrize("kind", ["tail", "rank"])
def test_ess_rhat_fold_impl_matches_jax(rng, kind, fold_impl):
    x = _chains(rng, (1001, 4, 3))
    got = mtt.ess_rhat(x, kind=kind, fold_impl=fold_impl, device="cpu")
    want = mdt.ess_rhat(x, kind=kind, fold_impl=fold_impl)
    assert_close(got.ess, want.ess)
    assert_close(got.rhat, want.rhat)


@pytest.mark.parametrize("fold_impl", FOLD_IMPLS)
@pytest.mark.parametrize("kind", ["tail", "rank"])
def test_rhat_fold_impl_matches_jax(rng, kind, fold_impl):
    x = _chains(rng, (600, 3, 4)) * 2.0 + 1.0
    assert_close(mtt.rhat(x, kind=kind, fold_impl=fold_impl, split_chains=3,
                          device="cpu"),
                 mdt.rhat(x, kind=kind, fold_impl=fold_impl, split_chains=3))


@pytest.mark.parametrize("fold_impl", FOLD_IMPLS)
def test_ess_tail_fold_impl_matches_jax(rng, fold_impl):
    x = _chains(rng, (800, 4, 3))
    assert_close(mtt.ess(x, kind="tail", fold_impl=fold_impl, tail_prob=0.2,
                         device="cpu"),
                 mdt.ess(x, kind="tail", fold_impl=fold_impl, tail_prob=0.2))


def test_short_chains_take_fold_impl(rng):
    x = _chains(rng, (8, 4, 3))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = mtt.ess_rhat(x, fold_impl="merge", device="cpu")
        want = mdt.ess_rhat(x, fold_impl="merge")
    assert_close(got.rhat, want.rhat)


@pytest.mark.parametrize("call", ["ess", "rhat", "ess_rhat"])
def test_unknown_fold_impl_raises_like_jax(call):
    x = np.random.default_rng(0).standard_normal((100, 2, 2))
    with pytest.raises(ValueError, match="unsupported fold_impl 'nope'"):
        getattr(mdt, call)(x, fold_impl="nope")
    with pytest.raises(ValueError, match="unsupported fold_impl 'nope'"):
        getattr(mtt, call)(x, fold_impl="nope", device="cpu")


def test_auto_sorts_on_the_cpu():
    x = torch.zeros((10_000, 4, 2), dtype=torch.float64)
    assert _resolve_fold_merge(x, "auto") is None
    assert _resolve_fold_merge(x, "sort") is None
    assert _resolve_fold_merge(x, "merge") == "two_sort"


@pytest.mark.parametrize("kind", ["tail", "rank"])
def test_nan_median_column_same_in_both_routes(rng, kind):
    """A column that is 75 % +inf has a NaN median and no NaN, so it is not
    masked: the port's sort and merge routes agree on it (the JAX
    package's do not, and it is held to no JAX value there)."""
    x = _chains(rng, (64, 4, 3))
    x[rng.random((64, 4)) < 0.75, 1] = np.inf
    got = {f: mtt.ess_rhat(x, kind=kind, fold_impl=f, device="cpu")
           for f in ("sort", "merge")}
    assert bool(torch.isfinite(got["sort"].rhat[1]))
    assert_close(got["merge"].rhat, got["sort"].rhat)
    assert_close(got["merge"].ess, got["sort"].ess)
    want = mdt.ess_rhat(x, kind=kind, fold_impl="sort")
    assert_close(got["sort"].rhat[[0, 2]], np.asarray(want.rhat)[[0, 2]])


def test_tile_agrees_with_the_cuda_source():
    """The wrapper sizes the merge kernel's split table by its tile."""
    import re

    from mcmcdiagnostictools_jl_tpu_torch.kernels import _build

    src = (_build.CSRC_DIR / "valley_merge.cu").read_text()
    assert int(re.search(r"constexpr int kTile = (\d+);", src)[1]) == valley._TILE


def test_main_sort_keeps_tied_rows_in_order():
    """The sort of the sample is stable, so a NaN-median row (every folded
    key NaN) is ranked in one flat order on every device."""
    x = np.zeros((50, 2, 2))
    x[::3, :, 0] = np.inf
    x[:, :, 1] = np.round(np.random.default_rng(1).standard_normal((50, 2)))
    xs, order, _ = rn.sort_with_positions(t(x))
    assert xs.shape == order.shape == (2, 100)
    for c in range(2):
        for v in torch.unique(xs[c]):
            flat = order[c][xs[c] == v]
            assert torch.equal(flat, torch.sort(flat).values)


ESS_KINDS = ["bulk", "tail", "basic", "mean", "median", "std", "mad",
             "quantile"]


@pytest.mark.parametrize("fold_impl", FOLD_IMPLS)
@pytest.mark.parametrize("kind", ESS_KINDS)
def test_every_exact_ess_kind_with_fold_impl_matches_jax(rng, kind,
                                                         fold_impl):
    x = _chains(rng, (301, 4, 3))
    jkind, tkind = ((mdt.Quantile(0.3), mtt.Quantile(0.3))
                    if kind == "quantile" else (kind, kind))
    assert_close(mtt.ess(x, kind=tkind, fold_impl=fold_impl, device="cpu"),
                 mdt.ess(x, kind=jkind, fold_impl=fold_impl))


@pytest.mark.parametrize("fold_impl", FOLD_IMPLS)
@pytest.mark.parametrize("kind", ["rank", "bulk", "tail", "basic"])
@pytest.mark.parametrize("call", ["rhat", "ess_rhat"])
def test_every_exact_rhat_kind_with_fold_impl_matches_jax(rng, call, kind,
                                                          fold_impl):
    x = _chains(rng, (301, 4, 3)) * 0.5 - 1.0
    got = getattr(mtt, call)(x, kind=kind, fold_impl=fold_impl, device="cpu")
    want = getattr(mdt, call)(x, kind=kind, fold_impl=fold_impl)
    assert_close(got, want)
