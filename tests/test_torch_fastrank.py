"""Kernels K2-K4 (fast rank mode) of the port.

- The plain versions against the JAX Pallas kernels in interpret mode, at
  float32 (their scratch is float32): minmax exactly equal; histogram counts
  equal; frac sums within 1e-5 absolute per element of the bin (float32
  sums in another order: 1e-5 for a singleton bin, more for a crowded tie
  bin); ranks within 1e-6 * N absolute.
- The port's histogram CDF transforms against the JAX package's XLA path at
  float64. Both keep the bin tables in float32 and sum them in different
  orders, so the within-bin means agree to 1e-5, ranks to 1e-6 * N
  absolute (the rank bound above) and z to 1e-5; counts, ranges and flags
  exactly.
- The CUDA kernels against the plain versions: tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from mcmcdiagnostictools_jl_tpu.ops import fastrank as jfr
from mcmcdiagnostictools_jl_tpu.ops.pallas import fastrank_kernel as jpk
from mcmcdiagnostictools_jl_tpu.ops.ranknorm import rank_normalize as jrank_normalize
from mcmcdiagnostictools_jl_tpu_torch.kernels import fastrank as kfr
from mcmcdiagnostictools_jl_tpu_torch.ops import fastrank as fr
from torch_parity import assert_close, t


def _sample(rng, n, p, dtype=np.float32):
    """Normal columns plus heavy ties, a constant column, a NaN column, an
    all-NaN column and an infinity (when p allows)."""
    x = rng.standard_normal((n, p)).astype(dtype)
    x[:, 1] = np.round(x[:, 1] * 2) / 2
    x[:, 2] = 1.25
    if p > 3:
        x[7, 3] = np.nan
    if p > 4:
        x[:, 4] = np.nan
    if p > 5:
        x[3, 5] = np.inf
    return x


def _scale(lo, hi, nbins):
    w = hi - lo
    return np.where(w > 0, nbins / np.where(w > 0, w, 1), 0).astype(np.float32)


# ---- plain kernels vs Pallas (interpret), float32 -------------------------


@pytest.mark.parametrize("n,p", [(333, 3), (4096, 7)])
def test_minmax_matches_pallas(rng, n, p):
    x = _sample(rng, n, p)
    got = kfr.column_minmax_plain(t(x))
    want = jpk.pallas_column_minmax(x, interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_minmax_empty_sample_falls_back_to_unit_range():
    lo, hi, bad = kfr.column_minmax_plain(torch.zeros((0, 3)))
    assert lo.tolist() == [0.0] * 3 and hi.tolist() == [1.0] * 3
    assert not bad.any()


@pytest.mark.parametrize("n,p,nbins", [(333, 3, 256), (4096, 7, 1024), (2500, 5, 512)])
def test_hist_moments_matches_pallas(rng, n, p, nbins):
    x = _sample(rng, n, p)[:, :4]  # NaN columns' bins differ by design
    lo, hi, _ = kfr.column_minmax_plain(t(x))
    scale = _scale(lo.numpy(), hi.numpy(), nbins)
    cnt, s1 = kfr.hist_moments_plain(t(x), lo, t(scale), nbins)
    jcnt, js1 = jpk.pallas_hist_moments(x, lo.numpy(), scale, nbins,
                                        interpret=True)
    keep = [0, 1, 2]  # column 3 holds a NaN: Pallas bins it without cleaning
    np.testing.assert_array_equal(cnt.numpy()[:, keep], np.asarray(jcnt)[:, keep])
    ds1 = np.abs(s1.numpy() - np.asarray(js1))[:, keep]
    assert np.all(ds1 <= 1e-5 * np.maximum(cnt.numpy()[:, keep], 1))
    assert np.all(ds1[:, 0] <= 1e-5)  # the continuous column
    assert float(cnt.sum(0)[0]) == n


@pytest.mark.parametrize("n,p,nbins", [(333, 3, 256), (4096, 7, 1024)])
def test_rank_lookup_matches_pallas(rng, n, p, nbins):
    x = _sample(rng, n, p)[:, :3]
    cdf = fr.build_hist_cdf(t(x), nbins)
    cnt = cdf.counts
    tables = torch.stack([cdf.cum[:-1], cnt, cnt * (0.5 - cdf.fm)])
    scale = fr._hist_scale(cdf.lo, cdf.hi, nbins)
    got = kfr.rank_lookup_plain(t(x), cdf.lo, scale, tables, nbins)
    want = jpk.pallas_rank_lookup(x, cdf.lo.numpy(), scale.numpy(),
                                  tables.numpy(), nbins, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6 * n)


def test_wrappers_run_plain_versions_for_cpu_tensors(rng):
    x = t(_sample(rng, 500, 6))
    counts = (kfr.column_minmax.launches, kfr.hist_moments.launches,
              kfr.rank_lookup.launches)
    for g, w in zip(kfr.column_minmax(x), kfr.column_minmax_plain(x)):
        assert torch.equal(g, w)
    lo, hi, _ = kfr.column_minmax(x)
    scale = fr._hist_scale(lo, hi, 256)
    for g, w in zip(kfr.hist_moments(x, lo, scale, 256),
                    kfr.hist_moments_plain(x, lo, scale, 256)):
        assert torch.equal(g, w)
    tables = torch.rand(3, 256, 6)
    assert torch.equal(kfr.rank_lookup(x, lo, scale, tables, 256),
                       kfr.rank_lookup_plain(x, lo, scale, tables, 256))
    assert counts == (kfr.column_minmax.launches, kfr.hist_moments.launches,
                      kfr.rank_lookup.launches)


def test_bins_are_safe_for_nan_and_infinities():
    x = torch.tensor([[np.nan], [np.inf], [-np.inf], [0.5], [1.0]],
                     dtype=torch.float32)
    b, frac = kfr.bins_from_scale(x, torch.tensor([0.0]), torch.tensor([8.0]), 8)
    assert b.flatten().tolist() == [0, 7, 0, 4, 7]
    assert frac.flatten().tolist() == [0.0, 1.0, 0.0, 0.0, 1.0]
    # inf * 0 (a degenerate column) is a NaN coordinate: bin 0
    b, frac = kfr.bins_from_scale(x, torch.tensor([0.0]), torch.tensor([0.0]), 8)
    assert int(b.max()) == 0 and not torch.isnan(frac).any()


# ---- the CDF transforms vs the JAX XLA path, float64 ------------------------


@pytest.mark.parametrize("nbins", [256, 4096])
def test_build_hist_cdf_matches_jax(rng, nbins):
    x = _sample(rng, 3000, 6, np.float64)
    got = fr.build_hist_cdf(t(x), nbins)
    want = jfr.build_hist_cdf(x, nbins, impl="xla")
    np.testing.assert_array_equal(got.cum.numpy(), np.asarray(want.cum))
    np.testing.assert_allclose(got.fm.numpy(), np.asarray(want.fm), atol=1e-5)
    for g, w in ((got.lo, want.lo), (got.hi, want.hi), (got.bad, want.bad)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_ranks_and_quantiles_match_jax(rng):
    x = _sample(rng, 3000, 6, np.float64)
    cdf = fr.build_hist_cdf(t(x), 1024)
    jcdf = jfr.build_hist_cdf(x, 1024, impl="xla")
    assert_close(fr.interpolated_ranks(t(x), cdf, 1024),
                 jfr.interpolated_ranks(x, jcdf, 1024, impl="xla"),
                 rtol=0, atol=1e-6 * len(x))
    ps = (0.05, 0.5, 0.95)
    assert_close(fr.hist_quantile(cdf, ps, 1024),
                 jfr.hist_quantile(jcdf, ps, 1024), equal_nan=True,
                 rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("nbins", [256, 4096])
def test_fast_rank_bulk_tail_matches_jax(rng, nbins):
    x3 = _sample(rng, 4000, 6, np.float64).reshape(1000, 4, 6)
    got = fr.fast_rank_bulk_tail(t(x3), nbins)
    want = jfr.fast_rank_bulk_tail(x3, nbins, impl="xla")
    for g, w in zip(got, want):
        assert_close(g, w, rtol=1e-6, atol=1e-5, equal_nan=True)
    assert_close(fr.fast_rank_normalize(t(x3), nbins),
                 jfr.fast_rank_normalize(x3, nbins, impl="xla"),
                 rtol=1e-6, atol=1e-5, equal_nan=True)


def test_fast_ranks_within_occupancy_bound_of_exact(rng):
    """|rank_fast - rank_exact| <= cnt[b] (ops/fastrank.py's bound); pure
    tie bins are exact up to the float32 tables (1e-6 * N)."""
    from scipy.stats import rankdata

    x = rng.standard_normal((2000, 3))
    x[:, 1] = np.round(x[:, 1] * 4) / 4
    cdf = fr.build_hist_cdf(t(x), 256)
    rank = fr.interpolated_ranks(t(x), cdf, 256).numpy()
    b, _ = fr._bin_coords(t(x), cdf.lo, cdf.hi, 256)
    occ = np.take_along_axis(cdf.counts.numpy(), b.numpy(), axis=0)
    exact = np.stack([rankdata(x[:, j]) for j in range(3)], axis=1)
    assert np.all(np.abs(rank - exact) <= occ + 1e-9)
    np.testing.assert_allclose(rank[:, 1], exact[:, 1], rtol=0, atol=1e-6 * 2000)
    z_exact = np.asarray(jrank_normalize(x.reshape(500, 4, 3))).reshape(2000, 3)
    z_fast, _ = fr.fast_rank_normalize_flat(t(x), 256)
    np.testing.assert_allclose(z_fast.numpy()[:, 1], z_exact[:, 1], rtol=0,
                               atol=1e-5)
