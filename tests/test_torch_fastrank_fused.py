"""The passes folded into kernels K3 and K4, on the CPU through their plain
versions: ``shift`` (the fold ``|x - shift|`` inside the kernel), ``fill``
and ``bad`` (constant and NaN columns written by the kernel), K3's finishing
entry point ``hist_cdf_tables`` and K4's ``(cum, fm)`` table, and the plans by
which the wrappers pick a kernel.

- New arguments against the compositions they replace (``_fold``, lookup,
  ``torch.where`` masks): exactly equal, float32 and float64.
- ``hist_cdf_tables_plain`` against the JAX package's ``build_hist_cdf``
  (``impl="xla"`` and ``"pallas_interpret"``) at float32: counts, ranges and
  flags exactly, ``fm`` within 1e-6 where both add the same float32 terms in
  another order (bins of up to a few elements; 1e-5 for crowded tie bins, as
  tests/test_torch_fastrank.py states).
- The transforms that use them against the JAX package as
  tests/test_torch_fastrank.py and tests/test_torch_ess_rhat.py state it.
- The CUDA kernels against these plain versions: tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import mcmcdiagnostictools_jl_tpu as mdt
import mcmcdiagnostictools_jl_tpu_torch as mtt
from mcmcdiagnostictools_jl_tpu.ops import fastrank as jfr
from mcmcdiagnostictools_jl_tpu_torch.kernels import fastrank as kfr
from mcmcdiagnostictools_jl_tpu_torch.ops import fastrank as fr
from torch_parity import PARITY_F64, assert_close, t


def _sample(rng, n=3000, p=7, dtype=np.float32):
    """Normal columns, heavy ties (1), a constant column (2), a NaN (3), an
    all-NaN column (4), an infinity (5)."""
    x = rng.standard_normal((n, p)).astype(dtype)
    x[:, 1] = np.round(x[:, 1] * 2) / 2
    x[:, 2] = 1.25
    x[7, 3] = np.nan
    x[:, 4] = np.nan
    x[3, 5] = np.inf
    return x


def _setup(x, nbins):
    lo, hi, bad = kfr.column_minmax_plain(x)
    med = torch.nan_to_num(x.nanmedian(0).values)
    return lo, hi, bad, fr._hist_scale(lo, hi, nbins), med


# ---- shift, fill, bad ---------------------------------------------------------


@pytest.mark.parametrize("nbins", [64, 4096])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_hist_moments_shift_is_the_fold(rng, nbins, dtype):
    x = t(_sample(rng, dtype=dtype))
    lo, hi, _, _, med = _setup(x, nbins)
    lo_f = torch.zeros_like(lo)
    scale_f = fr._hist_scale(lo_f, torch.maximum(hi - med, med - lo), nbins)
    got = kfr.hist_moments_plain(x, lo_f, scale_f, nbins, shift=med)
    want = kfr.hist_moments_plain(torch.abs(x - med[None, :]), lo_f, scale_f,
                                  nbins)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert float(got[0].sum(0)[0]) == x.shape[0]
    # the wrapper on a CPU tensor is the plain version
    for g, w in zip(kfr.hist_moments(x, lo_f, scale_f, nbins, med), want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("nbins", [64, 4096])
@pytest.mark.parametrize("blom", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rank_lookup_shift_fill_bad_equal_the_passes_they_replace(
        rng, nbins, blom, dtype):
    """``rank_lookup_plain(x, ..., shift, fill, bad)`` equals fold, lookup
    and the two ``torch.where`` masks, bit for bit, for both table forms."""
    x = t(_sample(rng, dtype=dtype))
    n = x.shape[0]
    lo, hi, bad, _, med = _setup(x, nbins)
    lo_f = torch.zeros_like(lo)
    scale_f = fr._hist_scale(lo_f, torch.maximum(hi - med, med - lo), nbins)
    folded = torch.abs(x - med[None, :])
    cum, fm, tab = kfr.hist_cdf_tables_plain(folded, lo_f, scale_f, nbins)
    cnt = cum[1:] - cum[:-1]
    stack = torch.stack([cum[:-1], cnt, cnt * (0.5 - fm)])
    blom_n = n if blom else None
    degenerate = hi <= lo
    fill_value = 0.125 if blom else (n + 1) * 0.5
    fill = torch.full_like(lo, torch.nan).masked_fill(degenerate, fill_value)
    want = kfr.rank_lookup_plain(folded, lo_f, scale_f, stack, nbins, blom_n)
    want = torch.where(degenerate[None, :], fill_value, want)
    want = torch.where(bad[None, :], torch.nan, want)
    for tables in (tab, stack):
        got = kfr.rank_lookup_plain(x, lo_f, scale_f, tables, nbins, blom_n,
                                    shift=med, fill=fill, bad=bad)
        assert got.dtype == want.dtype
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
        assert torch.equal(
            kfr.rank_lookup(x, lo_f, scale_f, tables, nbins, blom_n,
                            shift=med, fill=fill, bad=bad).nan_to_num(),
            want.nan_to_num())
    assert torch.isnan(want[:, 3]).all() and torch.isnan(want[:, 4]).all()
    assert bool((want[:, 2] == fill_value).all())
    # without fill and bad: nothing is masked
    plain = kfr.rank_lookup_plain(x, lo_f, scale_f, tab, nbins, blom_n,
                                  shift=med)
    assert torch.equal(plain, kfr.rank_lookup_plain(folded, lo_f, scale_f,
                                                    stack, nbins, blom_n))


def test_table_forms_and_their_errors(rng):
    x = t(_sample(rng, 500, 6))
    lo, hi, _, scale, _ = _setup(x, 32)
    cum, fm, tab = kfr.hist_cdf_tables_plain(x, lo, scale, 32)
    assert tab.shape == (6, 33, 2) and tab.dtype == torch.float32
    assert torch.equal(tab, kfr.pack_tables(cum, fm))
    assert torch.equal(tab[:, :, 0].t(), cum)
    assert torch.equal(tab[:, :-1, 1].t(), fm) and not tab[:, -1, 1].any()
    c_lo, cnt, off = kfr._unpack_tables(tab, 32, 6)
    assert torch.equal(c_lo, cum[:-1]) and torch.equal(cnt, cum[1:] - cum[:-1])
    assert torch.equal(off, cnt * (0.5 - fm))
    assert float(cum[-1, 0]) == 500 and float(cum[0].abs().max()) == 0
    with pytest.raises(ValueError, match="tables must be"):
        kfr.rank_lookup_plain(x, lo, scale, tab[:, :-1], 32)
    with pytest.raises(ValueError, match="tables must be"):
        kfr.rank_lookup(x, lo, scale, torch.zeros(2, 32, 6), 32)


# ---- the finished CDF against the JAX package, float32 --------------------


@pytest.mark.parametrize("nbins", [64, 4096])
@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_hist_cdf_tables_match_jax_build_hist_cdf(rng, nbins, impl):
    x = _sample(rng)
    lo, hi, bad, scale, _ = _setup(t(x), nbins)
    cum, fm, tab = kfr.hist_cdf_tables(t(x), lo, scale, nbins)
    want = jfr.build_hist_cdf(x, nbins, impl=impl)
    for g, w in ((lo, want.lo), (hi, want.hi), (bad, want.bad)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    clean = [0, 1, 2, 5, 6]  # JAX's kernel bins a NaN without cleaning it
    np.testing.assert_array_equal(cum.numpy()[:, clean],
                                  np.asarray(want.cum)[:, clean])
    dfm = np.abs(fm.numpy() - np.asarray(want.fm))[:, clean]
    cnt = (cum[1:] - cum[:-1]).numpy()[:, clean]
    assert np.all(dfm[cnt <= 8] <= 1e-6)
    assert np.all(dfm <= 1e-5)
    got = fr.build_hist_cdf(t(x), nbins)
    assert got.n == x.shape[0] and torch.equal(got.tab, tab)
    for g, w in zip(got[:4], (cum, fm, lo, hi)):
        assert torch.equal(g, w)


# ---- the transforms that use them ---------------------------------------------


@pytest.mark.parametrize("nbins", [256, 4096])
def test_fold_transform_needs_no_folded_copy(rng, nbins, monkeypatch):
    """``fast_rank_bulk_tail`` never materialises ``|x - med|``: ``_fold`` is
    not called, and its tail transform equals the transform of a folded copy
    (as it was computed before the fold moved into the kernels)."""
    x3 = t(_sample(rng, 4000, 6, np.float64).reshape(1000, 4, 6))
    xf = x3.reshape(4000, 6)
    monkeypatch.setattr(fr, "_fold", None)
    z_bulk, z_tail, med = fr.fast_rank_bulk_tail(x3, nbins)
    monkeypatch.undo()
    _, cdf = fr.fast_rank_normalize_flat(xf, nbins)
    folded = fr._fold(xf, med)
    fcdf = fr._folded_cdf(xf, cdf, med, nbins)
    want = fr.build_hist_cdf(folded, nbins, minmax=(fcdf.lo, fcdf.hi, cdf.bad))
    for g, w in zip(fcdf[:4], want[:4]):
        assert torch.equal(g, w)
    z_want, _ = fr.fast_rank_normalize_flat(folded, nbins, cdf=want)
    assert torch.equal(z_tail.reshape(4000, 6).nan_to_num(),
                       z_want.nan_to_num())
    assert torch.isnan(z_tail[..., 3]).all() and torch.isnan(z_tail[..., 4]).all()
    jz = jfr.fast_rank_bulk_tail(x3.numpy(), nbins, impl="xla")
    for g, w in zip((z_bulk, z_tail, med), jz):
        assert_close(g, w, rtol=1e-6, atol=1e-5, equal_nan=True)


@pytest.mark.parametrize("fused", [False, True])
def test_constant_and_nan_columns_come_from_the_lookup(rng, fused, monkeypatch):
    """No pass after K4: ranks carry NaN for poisoned columns into Blom and
    ``ndtri``, the fused route writes both constants itself."""
    x = t(_sample(rng, 2000, 6))
    monkeypatch.setattr(fr, "FUSE_BLOM_Z", fused)
    z, cdf = fr.fast_rank_normalize_flat(x, 256)
    assert torch.isnan(z[:, 3]).all() and torch.isnan(z[:, 4]).all()
    assert not z[:, 2].any()  # the tied rank (n + 1) / 2 has z = 0
    assert torch.isfinite(z[:, [0, 1, 5]]).all()
    ranks = fr.interpolated_ranks(x, cdf, 256)
    assert torch.isfinite(ranks).all()  # the public ranks mask nothing
    assert bool((ranks[:, 2] == 1000.5).all())
    assert torch.equal(fr.z_from_ranks(ranks, 2000, cdf.bad).nan_to_num(),
                       z.nan_to_num()) or fused


@pytest.mark.parametrize("kind", ["rank", "bulk", "tail"])
def test_fast_ess_rhat_still_matches_jax(rng, kind):
    """float64 on the CPU against the JAX package's XLA path (the bound of
    tests/test_torch_ess_rhat.py: float32 tables summed in another order)."""
    x = _sample(rng, 4000, 6, np.float64).reshape(1000, 4, 6)
    got = mtt.ess_rhat(x, kind=kind, rank_mode="fast", device="cpu")
    want = mdt.ess_rhat(x, kind=kind, rank_mode="fast")
    assert_close(got.ess, want.ess, rtol=1e-4, atol=1e-8, equal_nan=True)
    assert_close(got.rhat, want.rhat, rtol=1e-5, atol=1e-8, equal_nan=True)


def test_mad_proxy_keeps_its_fold(rng):
    x = rng.standard_normal((800, 4, 3))
    assert_close(mtt.ess(x, kind="mad", rank_mode="fast", device="cpu"),
                 mdt.ess(x, kind="mad", rank_mode="fast"), **PARITY_F64)


# ---- the plans ------------------------------------------------------------------


def test_slab_plan_columns_vectors_and_chunks():
    plan = kfr.slab_plan
    # the flagship shape on 132 multiprocessors: 4 columns, vectors, 9 chunks
    assert plan(1_280_000, 256, 4096, 132, True) == (4, 1, 9)
    # P off 4, or a tensor off 16 bytes: float by float
    assert plan(50_001, 37, 4096, 132, True)[:2] == (4, 0)
    assert plan(50_000, 40, 4096, 132, False)[:2] == (4, 0)
    # more bins leave room for fewer columns, then for none
    assert plan(5000, 10, 10_000, 132, True)[:2] == (2, 1)
    assert plan(5000, 9, 10_000, 132, True)[:2] == (2, 0)
    assert plan(3000, 8, 20_000, 132, True)[:2] == (1, 1)
    assert plan(100, 3, 40_000, 132, True) is None
    assert plan(100, 3, 0, 132, True) is None
    # chunks: never below one tile of rows, never 2^20 rows or more
    assert plan(100, 3, 64, 132, True)[2] == 1
    for n in (2**20 - 1, 2**20, 5 * 2**20 + 3):
        nchunks = plan(n, 4096, 64, 132, True)[2]
        assert -(-n // nchunks) <= 2**20 - 1


def test_lookup_route_is_by_shape():
    route = kfr.lookup_route
    assert route(1_280_000, 256, 4096, True, 132, True) == ("wide", 8, 33)
    assert route(1_280_000, 232, 4096, True, 132, True)[:2] == ("wide", 8)
    assert route(3000, 64, 1024, True, 132, True)[:2] == ("wide", 32)
    assert route(4096, 16, 2048, True, 132, True)[:2] == ("wide", 16)
    assert route(4096, 48, 2048, True, 132, True)[:2] == ("wide", 16)
    # the widest table the wide kernel holds: 8 columns of 4148 bins
    assert route(4097, 8, 4148, True, 132, True)[:2] == ("wide", 8)
    assert route(4097, 8, 4149, True, 132, True) == ("gather",)
    # P off 8, an unaligned tensor, 2^24 rows, or the [C, cnt, off] stack
    assert route(5000, 12, 64, True, 132, True) == ("gather",)
    assert route(5000, 16, 64, True, 132, False) == ("gather",)
    assert route(2**24, 8, 64, True, 132, True) == ("gather",)
    assert route(100, 8, 40_000, True, 132, True) == ("gather",)
    assert route(1_280_000, 256, 4096, False, 132, True) == ("gather",)
