"""The port's CUDA kernels on the card (``cuda`` marker; skipped without a
CUDA device).

This file imports neither JAX nor ``conftest.py``, so it also runs where only
PyTorch is installed:

    python -m pytest -o addopts="" --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances: K2 and K4 round exactly like their plain versions (equal);
K4's z mode adds AS241's ``ppnd7`` on identical ranks with the same
round-to-nearest operations (within 4 float32 ULP of z: equal where the
kernel's ``logf`` and PyTorch's come from one toolkit, an ULP or two apart
where they do not);
K3's counts and prefix counts are exact and its frac sums exact fixed-point
sums rounded once, the plain version's float32 sums in scatter order (within
1e-4 of the bin count; two runs of K3 bit-equal); K4 also with ``shift``,
``fill`` and ``bad`` and through each of its kernels; K1 and K5 sum in another float32 order (2e-5
abs at unit variance, min/max equal, K5's lags at or beyond niter exactly
0); K6's two variants sum in the same tile-by-tile order as K5 (2e-5 abs at
unit variance against the plain version and against each other); K7, K8 and
K9 equal their plain versions (K9 on distinct keys), and K1 and K5 equal
K6's variant A where their tile is its 128 draws; a streamed call runs the
same kernels on the same columns as the resident one (ESS 1e-5 relative,
R-hat 1e-6: the reductions' tiling differs); the whole slice on the card tracks the plain CPU path to 1e-3 relative
ESS and MCSE and 1e-4 absolute R-hat (a quantile MCSE may differ beyond
that only where an ESS within 1e-3 moved an interval rank); the classical
suite on the card tracks the CPU to 1e-3 (Geweke z, abs + rel), 1e-4
(Heidelberger p-values, abs; decisions equal), 1e-4 relative (PSRF), and
Raftery's run lengths exactly (the dependence factor within 1 float64
ULP). K10 reads the exact mode's rows ``(P, N)``: its keys are
bit-identical to ``valley_sort_2d``'s and to ``torch.sort(dim=1)``'s, its
payloads a permutation of each row's and equal up to the order of tied keys
(the tied-average ranks routed back by payload are equal), a row whose
median is NaN unmoved; K11 takes rows and the ring route's transposed
``(N, P)`` blocks: two runs bit-equal (fixed-point integer sums), the two
layouts bit-equal, and its sums within 1e-6 of the float64
plain version relative to max(|sum|, 1) (the float32 rounding of an exact
sum), min and max equal, the R-hat of its moments within 1e-4; the exact
calls through K10 and K11 track the CPU to 1e-4 R-hat. K12's ranks are
bit-equal to its plain version's and its z within 4 float32 ULP (the same
Cephes operations on equal ranks; only ``logf`` may come from another
toolkit), its scatter equal to the plain scatter of its own values, two
runs bit-equal, at the edges of its tiles and scatter buckets, in ragged
groups of rows and on both sides of its Blom table's limit; every entry of
the table follows the plain score and equals the sorted z. A column of
sign-bit NaNs (which the card's radix sort puts first) comes out NaN in
every exact call, the other columns bit-equal to the ``+nan`` sample's and
within the slice's limits of the CPU (BASELINE.md's 1e-6 in float64). The
K13's keys are bit for bit those of the card's ``torch.sort(dim=1,
stable=True)`` and its positions equal, on rows with ties, +-0.0, +-inf and
NaNs of either sign, off its tile and its parts, with ten times more tiles
than its persistent grid and fewer, on rows that start off 16-byte
boundaries and at the flagship width, two runs bit-equal; a sort launches
one ``radix_histogram`` and four ``radix_digit_pass``, one of them
``<true, true>`` with positions and none alone; the exact calls through K13
equal, bit for bit, the same calls through its plain version. K14's
accumulators ``t`` and ``gpos`` are bit for bit its plain version's in every
mode, on random rows, tie runs across its tiles, rows of one value, blocks
wholly below or above, +-0.0 and +-inf and a row of 25M entries; beside NaN
rows the clean rows stay exact and the rows around them untouched; at every
ring position they equal the ``torch.searchsorted`` counts the ring formed
before them; float64 takes the plain version. The
HMC core on float64 draws tracks the CPU to 1e-8; the JAX method names
launch K5 (``pallas``) and K1 (``fused``). Float32 matrix
products run in full float32:
``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's default), and
the Gelman test checks that it is.
"""

import math

import numpy as np
import pytest
import torch

import mcmcdiagnostictools_jl_tpu_torch as mtt
from mcmcdiagnostictools_jl_tpu_torch import kernels
from mcmcdiagnostictools_jl_tpu_torch.convert import to_tensor
from mcmcdiagnostictools_jl_tpu_torch.utils import canonicalize
from mcmcdiagnostictools_jl_tpu_torch.diagnostics.mcse import _beta_interval_ranks
from mcmcdiagnostictools_jl_tpu_torch.kernels import _build
from mcmcdiagnostictools_jl_tpu_torch.kernels import autocov as k5
from mcmcdiagnostictools_jl_tpu_torch.benchmarks import micro_lagloop, sort_microbench
from mcmcdiagnostictools_jl_tpu_torch.kernels import fastrank as kfr
from mcmcdiagnostictools_jl_tpu_torch.kernels import lagloop_study as k6
from mcmcdiagnostictools_jl_tpu_torch.kernels import moments_autocov as k1
from mcmcdiagnostictools_jl_tpu_torch.kernels import seghist as k11
from mcmcdiagnostictools_jl_tpu_torch.kernels import sort_study as k789
from mcmcdiagnostictools_jl_tpu_torch.kernels import tiedrank as k12
from mcmcdiagnostictools_jl_tpu_torch.kernels import valley as k10
from mcmcdiagnostictools_jl_tpu_torch.ops import fastrank as fr
from mcmcdiagnostictools_jl_tpu_torch.ops.fastrank import _hist_scale
from torch_parity import (  # noqa: F401  (fixture)
    assert_close, cuda_device, old_ring_counts, t)

pytestmark = pytest.mark.cuda


def _ar1(seed, shape, phi=0.5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    for i in range(1, shape[0]):
        x[i] += phi * x[i - 1]
    return x


# lag counts on both sides of a block's span (68, 128, 256 lags), 1001 draws
# (off every tile), series counts of 320 (whole 32-series blocks), 259 (off 4:
# the 4-byte copies) and 148 (of 4, off 32), more lags than draws
_LAG_SHAPES = (
    [(1001, 8, 40, m) for m in (0, 10, 64, 65, 100, 250, 255, 256, 300)]
    + [(1001, 7, 37, m) for m in (0, 64, 65, 250, 255, 256, 300)]
    + [(1001, 4, 37, 250), (300, 3, 7, 303), (7, 5, 3, 12)])


@pytest.mark.parametrize("niter,nchains,nparams,maxlag", _LAG_SHAPES)
def test_k1_matches_plain(cuda_device, niter, nchains, nparams,  # noqa: F811
                          maxlag):
    x = _ar1(0, (niter, nchains, nparams))
    x[:, 0, 1] = 0.75
    x[5, 1, 2] = np.nan
    xc = t(x, torch.float32).to(cuda_device)
    before = k1.moments_autocov.launches
    got = k1.moments_autocov(xc, maxlag)
    want = k1.moments_autocov_plain(xc, maxlag)
    assert k1.moments_autocov.launches == before + 1
    for i, (g, w) in enumerate(zip(got, want)):
        tol = dict(rtol=0, atol=0) if i in (2, 3) else dict(rtol=0, atol=2e-5)
        assert_close(g, w, equal_nan=True, **tol)
    assert got[4].shape == (maxlag + 1, nchains, nparams)
    tail = got[4][niter:]
    assert torch.equal(tail, torch.zeros_like(tail))


@pytest.mark.parametrize("niter,nchains,nparams,maxlag",
                         _LAG_SHAPES + [(1, 2, 3, 4)])
def test_k5_matches_plain(cuda_device, niter, nchains, nparams,  # noqa: F811
                          maxlag):
    """Series counts off the 32-series block width, lags past niter (zeros),
    and a constant series."""
    x = _ar1(3, (niter, nchains, nparams))
    x[:, 0, 1] = 0.75
    xc = t(x - x.mean(0), torch.float32).to(cuda_device)
    before = k5.direct_autocov.launches
    got = k5.direct_autocov(xc, maxlag)
    want = k5.direct_autocov_plain(xc, maxlag)
    assert k5.direct_autocov.launches == before + 1
    assert got.shape == (maxlag + 1, nchains, nparams)
    assert_close(got, want, rtol=0, atol=2e-5)
    assert torch.equal(got[niter:], torch.zeros_like(got[niter:]))


@pytest.mark.parametrize("niter,nchains,nparams,maxlag", [
    (1000, 6, 50, 250), (1001, 7, 37, 64), (1001, 7, 37, 65),
    (1001, 7, 37, 256), (1001, 4, 37, 300), (300, 3, 7, 303)])
def test_k5_matches_k1_acov(cuda_device, niter, nchains, nparams,  # noqa: F811
                            maxlag):
    """The same estimator: K5 on the series centered with K1's means."""
    x = t(_ar1(4, (niter, nchains, nparams)), torch.float32).to(cuda_device)
    mean, _, _, _, acov = k1.moments_autocov(x, maxlag)
    assert_close(k5.direct_autocov((x - mean).contiguous(), maxlag), acov,
                 rtol=0, atol=2e-5)


@pytest.mark.parametrize("maxlag", [100, 250, 300])
def test_k1_k5_equal_k6a_at_a_tile_of_128(cuda_device, maxlag):  # noqa: F811
    """Where the production loop's tile is the first form's 128 draws, both
    add the same products in the same order (more than 68 lags): equal bit
    for bit."""
    x = t(_ar1(16, (1001, 7, 37)), torch.float32).to(cuda_device)
    mean, _, _, _, acov = k1.moments_autocov(x, maxlag)
    centered = (x - mean).contiguous()
    first = k6.lag_products(centered.reshape(1001, -1), maxlag, "a")
    assert torch.equal(acov.reshape(maxlag + 1, -1), first)
    assert torch.equal(k5.direct_autocov(centered, maxlag).reshape(
        maxlag + 1, -1), first)


@pytest.mark.parametrize("method", [
    mtt.AutocovMethod(), "direct", mtt.DirectKernelAutocovMethod(),
    mtt.PallasAutocovMethod(), mtt.PallasAutocovMethod(interpret=True),
    "pallas", "pallas_interpret"])
def test_direct_autocov_methods_launch_k5(cuda_device, method):  # noqa: F811
    """Every name of the direct estimator runs K5 on a card tensor, never its
    plain version."""
    x = torch.from_numpy(_ar1(7, (600, 8, 6)).astype(np.float32))
    before = k5.direct_autocov.launches
    g = mtt.ess(x.to(cuda_device), kind="basic", autocov_method=method)
    assert k5.direct_autocov.launches > before
    assert_close(g.cpu(), mtt.ess(x, kind="basic", autocov_method=method),
                 rtol=1e-3, atol=0)


@pytest.mark.parametrize("method", [
    "auto", mtt.KernelAutocovMethod(), mtt.FusedAutocovMethod(),
    mtt.FusedAutocovMethod(interpret=True), "fused", "fused_interpret"])
def test_fused_autocov_methods_launch_k1(cuda_device, method):  # noqa: F811
    """Every name of the fused route runs K1 on a card tensor (K5 never)."""
    x = torch.from_numpy(_ar1(7, (600, 8, 6)).astype(np.float32))
    kernels.reset_launch_counts()
    g = mtt.ess(x.to(cuda_device), kind="basic", autocov_method=method)
    counts = kernels.launch_counts()
    assert counts["K1"] >= 1 and counts["K5"] == 0
    assert_close(g.cpu(), mtt.ess(x, kind="basic", autocov_method=method),
                 rtol=1e-3, atol=0)


def _fast_sample(n, p, device, seed=1):
    """Normal columns with, where ``p`` allows: ties, a constant column, a
    NaN, an all-NaN column, an infinity."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, p)).astype(np.float32)
    for col, put in enumerate((None, lambda c: np.round(c * 2) / 2,
                               lambda c: 1.25)):
        if put is not None and col < p:
            x[:, col] = put(x[:, col])
    if p > 3:
        x[min(7, n - 1), 3] = np.nan
    if p > 4:
        x[:, 4] = np.nan
    if p > 5:
        x[min(3, n - 1), 5] = np.inf
    return t(x).to(device)


@pytest.mark.parametrize("n,p,nbins", [(50001, 37, 4096), (4096, 7, 256)])
def test_fast_kernels_match_plain(cuda_device, n, p, nbins):  # noqa: F811
    x = _fast_sample(n, p, cuda_device)
    lo, hi, bad = kfr.column_minmax(x)
    for g, w in zip((lo, hi, bad), kfr.column_minmax_plain(x)):
        assert torch.equal(g, w)
    scale = _hist_scale(lo, hi, nbins)
    cnt, s1 = kfr.hist_moments(x, lo, scale, nbins)
    cnt_p, s1_p = kfr.hist_moments_plain(x, lo, scale, nbins)
    assert torch.equal(cnt, cnt_p)
    assert float(((s1 - s1_p).abs() / cnt.clamp(min=1)).max()) <= 1e-4
    fm = torch.where(cnt > 0, s1 / cnt.clamp(min=1.0), 0.5)
    cum = torch.cat([cnt.new_zeros((1, p)), cnt.cumsum(0)])
    tables = torch.stack([cum[:-1], cnt, cnt * (0.5 - fm)])
    assert torch.equal(kfr.rank_lookup(x, lo, scale, tables, nbins),
                       kfr.rank_lookup_plain(x, lo, scale, tables, nbins))
    assert kfr.rank_lookup.route == ("gather",)  # the [C, cnt, off] stack
    tab = kfr.pack_tables(cum, fm)
    assert torch.equal(kfr.rank_lookup(x, lo, scale, tab, nbins),
                       kfr.rank_lookup_plain(x, lo, scale, tab, nbins))
    assert kfr.rank_lookup.route == ("gather",)  # p is no multiple of 8


# shapes across K3's and K4's kernels: P off 4 and off 8, N below one tile,
# 1 to 20,000 bins (K3: 4, 2 and 1 columns a block), K4's wide kernel at 8, 16
# and 32 columns a block and one bin past what it holds
_SLAB_SHAPES = [(50001, 37, 4096), (4096, 7, 256), (100, 6, 64), (333, 6, 1),
                (1000, 1, 64), (5000, 10, 10000), (3000, 8, 20000),
                (4096, 8, 256), (5000, 40, 4096), (4096, 16, 256),
                (3001, 96, 500), (4097, 8, 4149), (100, 12, 64)]


@pytest.mark.parametrize("n,p,nbins", _SLAB_SHAPES)
def test_k3_finished_cdf_matches_plain(cuda_device, n, p, nbins):  # noqa: F811
    """K3's second pass: prefix counts equal, fm within 1e-4 (the plain
    version adds float32 in scatter order, the kernel exact fixed point),
    K4's table the kernel's own cum and fm, two runs bit-equal; plain and
    folded around a shift."""
    x = _fast_sample(n, p, cuda_device)
    lo, hi, _ = kfr.column_minmax(x)
    scale = _hist_scale(lo, hi, nbins)
    shift = torch.nan_to_num(x.nanmedian(0).values)
    for sh in (None, shift):
        before = kfr.hist_moments.launches
        cum, fm, tab = kfr.hist_cdf_tables(x, lo, scale, nbins, sh)
        assert kfr.hist_moments.launches == before + 1
        cum_p, fm_p, _ = kfr.hist_cdf_tables_plain(x, lo, scale, nbins, sh)
        assert torch.equal(cum, cum_p)
        assert float((fm - fm_p).abs().max()) <= 1e-4
        assert torch.equal(tab, kfr.pack_tables(cum, fm))
        for a, b in zip((cum, fm, tab),
                        kfr.hist_cdf_tables(x, lo, scale, nbins, sh)):
            assert torch.equal(a, b)
        cnt, s1 = kfr.hist_moments(x, lo, scale, nbins, sh)
        assert torch.equal(cnt, cum[1:] - cum[:-1])
        assert torch.equal(torch.where(cnt > 0, s1 / cnt.clamp(min=1.0), 0.5),
                           fm)


@pytest.mark.parametrize("n,p,nbins", _SLAB_SHAPES + [(100, 3, 40000)])
def test_k4_shift_fill_bad_match_plain(cuda_device, n, p, nbins):  # noqa: F811
    """K4 on the (cum, fm) table, with and without shift, fill and bad:
    ranks bit-equal, z within 4 float32 ULP; the kernel is chosen by shape."""
    x = _fast_sample(n, p, cuda_device)
    lo, hi, bad = kfr.column_minmax(x)
    scale = _hist_scale(lo, hi, nbins)
    shift = torch.nan_to_num(x.nanmedian(0).values)
    fill = torch.full_like(lo, torch.nan).masked_fill(hi <= lo, (n + 1) * 0.5)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    want_route = kfr.lookup_route(n, p, nbins, True, sms, True)
    assert want_route[0] == ("wide" if p % 8 == 0 and nbins <= 4148
                             else "gather")
    for kw in ({}, dict(shift=shift, fill=fill, bad=bad)):
        _, _, tab = kfr.hist_cdf_tables_plain(x, lo, scale, nbins,
                                              kw.get("shift"))
        before = (kfr.rank_lookup.launches, kfr.rank_lookup.z_launches)
        got = kfr.rank_lookup(x, lo, scale, tab, nbins, **kw)
        assert kfr.rank_lookup.route == want_route
        want = kfr.rank_lookup_plain(x, lo, scale, tab, nbins, **kw)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
        z = kfr.rank_lookup(x, lo, scale, tab, nbins, blom_n=n, **kw)
        assert (kfr.rank_lookup.launches, kfr.rank_lookup.z_launches) == (
            before[0] + 2, before[1] + 1)
        assert _max_ulp(z, kfr.rank_lookup_plain(x, lo, scale, tab, nbins,
                                                 blom_n=n, **kw)) <= 4
        if kw:
            assert torch.isnan(got[:, bad]).all() and torch.isnan(z[:, bad]).all()
            if p > 2:
                assert bool((got[:, 2] == (n + 1) * 0.5).all())


def test_fast_transforms_pass_the_sample_through_kernels_only(
        cuda_device):  # noqa: F811
    """The rank kind's two transforms launch K3 and K4 twice each, fold and
    mask inside them, and match the CPU route."""
    x = torch.from_numpy(_ar1(12, (1500, 8, 16)).astype(np.float32))
    x[:, :, 2] = 0.5
    x[3, 1, 5] = np.nan
    kernels.reset_launch_counts()
    z_bulk, z_tail, med = fr.fast_rank_bulk_tail(x.to(cuda_device))
    counts = kernels.launch_counts()
    assert (counts["K2"], counts["K3"], counts["K4"]) == (1, 2, 2)
    for got, want in zip((z_bulk, z_tail, med), fr.fast_rank_bulk_tail(x)):
        # an fm that differs in its last bits moves a rank by a fraction of
        # its bin's count: 1e-3 in z
        assert_close(got.cpu(), want, rtol=0, atol=1e-3, equal_nan=True)
    assert torch.isnan(z_tail[:, :, 5]).all() and not z_bulk[:, :, 2].any()


@pytest.mark.parametrize("n,p,nbins", [(50001, 37, 4096), (4096, 7, 256),
                                       (1000, 1, 64)])
def test_k4_z_mode_matches_plain(cuda_device, n, p, nbins):  # noqa: F811
    """Series and row counts off any block size; ties, a constant column."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((n, p)).astype(np.float32)
    if p > 2:
        x[:, 1] = np.round(x[:, 1] * 2) / 2
        x[:, 2] = 1.25
    x = t(x).to(cuda_device)
    cdf = fr.build_hist_cdf(x, nbins)
    cnt = cdf.counts
    tables = torch.stack([cdf.cum[:-1], cnt, cnt * (0.5 - cdf.fm)])
    scale = _hist_scale(cdf.lo, cdf.hi, nbins)
    before = (kfr.rank_lookup.launches, kfr.rank_lookup.z_launches)
    got = kfr.rank_lookup(x, cdf.lo, scale, tables, nbins, blom_n=n)
    assert (kfr.rank_lookup.launches, kfr.rank_lookup.z_launches) == (
        before[0] + 1, before[1] + 1)
    want = kfr.rank_lookup_plain(x, cdf.lo, scale, tables, nbins, blom_n=n)
    assert _max_ulp(got, want) <= 4
    ranks = kfr.rank_lookup(x, cdf.lo, scale, tables, nbins)
    assert kfr.rank_lookup.z_launches == before[1] + 1  # rank mode: not counted
    assert _max_ulp(got, kfr.ppnd7((ranks - 0.375) * (1.0 / (n + 0.25)))) <= 4


def _max_ulp(got, want):
    """Largest ``|got - want|`` in float32 ULPs of ``want``; the NaN masks
    must agree."""
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    w = want[ok].abs()
    ulp = torch.nextafter(w, torch.full_like(w, math.inf)) - w
    return float(((got[ok].double() - want[ok].double()).abs()
                  / ulp.double()).max())


def test_fused_route_launches_z_mode(cuda_device, monkeypatch):  # noqa: F811
    """With FUSE_BLOM_Z the fast rank kind runs K4's z mode (bulk and fold)
    on the card, and tracks the unfused route and the CPU's fused route."""
    x = torch.from_numpy(_ar1(9, (2000, 16, 24)).astype(np.float32))
    xg = x.to(cuda_device)
    unfused = mtt.ess_rhat(xg, rank_mode="fast")
    monkeypatch.setattr(fr, "FUSE_BLOM_Z", True)
    before = kfr.rank_lookup.z_launches
    fused = mtt.ess_rhat(xg, rank_mode="fast")
    assert kfr.rank_lookup.z_launches == before + 2
    assert_close(fused.ess.cpu(), unfused.ess.cpu(), rtol=1e-3, atol=0)
    assert_close(fused.rhat.cpu(), unfused.rhat.cpu(), rtol=0, atol=1e-4)
    cpu = mtt.ess_rhat(x, rank_mode="fast")
    assert_close(fused.ess.cpu(), cpu.ess, rtol=1e-3, atol=0)
    assert_close(fused.rhat.cpu(), cpu.rhat, rtol=0, atol=1e-4)


def _classical_sample():
    x = _ar1(10, (2000, 8, 16)).astype(np.float32)
    x[:400, 0, 0] += 2.0  # a transient
    return torch.from_numpy(x + 3.0)  # halfwidth ratios ~0.03, off eps = 0.1


@pytest.mark.parametrize("fn", ["gewekediag", "heideldiag"])
def test_windowed_mcse_launches_k5(cuda_device, fn):  # noqa: F811
    x = _classical_sample()
    before = k5.direct_autocov.launches
    g = getattr(mtt, fn)(x.to(cuda_device))
    assert k5.direct_autocov.launches == before + 1  # one stack, every window
    c = getattr(mtt, fn)(x)
    for name, gv, cv in zip(g._fields, g, c):
        assert gv.device.type == "cuda" and gv.shape == (8, 16), name
    if fn == "gewekediag":
        assert_close(g.zscore.cpu(), c.zscore, rtol=1e-3, atol=1e-3)
        return
    assert_close(g.pvalue.cpu(), c.pvalue, rtol=0, atol=1e-4)
    # decisions equal, except for a series whose float32 value sits at a
    # threshold (p-value within 1e-4 of alpha, halfwidth ratio within 1e-3
    # of eps); none in this sample
    near = ((c.pvalue - 0.05).abs() <= 1e-4) | (
        (c.halfwidth / c.mean.abs() - 0.1).abs() <= 1e-3)
    assert not near.any()
    for name in ("burnin", "stationarity", "test"):
        assert torch.equal(getattr(g, name).cpu(), getattr(c, name)), name
    assert_close(g.mean.cpu(), c.mean, rtol=1e-5, atol=1e-6)
    assert_close(g.halfwidth.cpu(), c.halfwidth, rtol=1e-3, atol=0)


def test_gelman_raftery_on_card_match_cpu(cuda_device):  # noqa: F811
    assert torch.backends.cuda.matmul.allow_tf32 is False
    x = _classical_sample()
    xg = x.to(cuda_device)
    g, c = mtt.gelmandiag_multivariate(xg), mtt.gelmandiag_multivariate(x)
    assert g.psrf.device.type == "cuda"
    for gv, cv in zip(g[:2], c[:2]):
        assert_close(gv.cpu(), cv, rtol=1e-4, atol=0)
    assert_close(g.psrfmultivariate, c.psrfmultivariate, rtol=1e-4, atol=0)
    # r = 0.01: nmin 937 draws, below the sample's 2000
    g, c = mtt.rafterydiag(xg, r=0.01), mtt.rafterydiag(x, r=0.01)
    for name, gv, cv in zip(g._fields, g, c):
        assert gv.device.type == "cuda", name
        rtol = 2.0 ** -52 if name == "dependencefactor" else 0  # 1 ULP
        assert_close(gv.cpu(), cv, rtol=rtol, atol=0, equal_nan=True)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):  # noqa: F811
    x = torch.zeros((64, 8), device=cuda_device)
    with pytest.raises(ValueError):
        kfr.column_minmax(x.t())  # not contiguous
    lo = torch.zeros(8, device=cuda_device)
    with pytest.raises(ValueError):
        kfr.hist_moments(x, lo.double(), lo, 16)
    with pytest.raises(ValueError):
        kfr.hist_moments(x, lo, lo, 100_000)  # does not fit shared memory
    with pytest.raises(NotImplementedError):
        k1.moments_autocov(x[:8].half().reshape(8, 2, 4), 2)
    with pytest.raises(ValueError):
        k5.direct_autocov(x.reshape(64, 2, 4).transpose(1, 2), 3)
    with pytest.raises(NotImplementedError):
        k5.direct_autocov(x.half().reshape(64, 2, 4), 3)


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_slice_on_card_matches_cpu(cuda_device, mode):  # noqa: F811
    x = torch.from_numpy(_ar1(2, (2000, 32, 64)).astype(np.float32))
    g = mtt.ess_rhat(x.to(cuda_device), rank_mode=mode)
    c = mtt.ess_rhat(x, rank_mode=mode)
    assert g.ess.device.type == "cuda"
    assert_close(g.ess.cpu(), c.ess, rtol=1e-3, atol=0)
    assert_close(g.rhat.cpu(), c.rhat, rtol=0, atol=1e-4)


_CALLS = [
    ("ess", dict(kind="mean")), ("ess", dict(kind="std")),
    ("ess", dict(kind="median")), ("ess", dict(kind="mad")),
    ("ess", dict(kind=mtt.Quantile(0.99))),
    ("mcse", dict(kind="mean")), ("mcse", dict(kind="std")),
    ("mcse", dict(kind="median")), ("mcse", dict(kind=mtt.Quantile(0.05))),
]


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("fn,kw", _CALLS)
def test_estimators_on_card_match_cpu(cuda_device, fn, kw, mode):  # noqa: F811
    """Each estimator call with the K5 marker on the card launches K5 and
    tracks the CPU path."""
    x = torch.from_numpy(_ar1(5, (2000, 16, 24)).astype(np.float32))
    marker = mtt.DirectKernelAutocovMethod()
    before = k5.direct_autocov.launches
    g = getattr(mtt, fn)(x.to(cuda_device), rank_mode=mode,
                         autocov_method=marker, **kw)
    assert k5.direct_autocov.launches > before
    c = getattr(mtt, fn)(x, rank_mode=mode, autocov_method=marker, **kw)
    assert g.device.type == "cuda" and g.shape == (24,)
    off = ~((g.cpu() / c - 1).abs() <= 1e-3)
    if fn == "mcse" and kw["kind"] not in ("mean", "std") and off.any():
        # a quantile MCSE reads the order statistics at the Beta interval's
        # ranks: it may differ only where an ESS within 1e-3 moved a rank
        p = 0.5 if kw["kind"] == "median" else kw["kind"].p
        (sg, lg, ug), (sc, lc, uc) = (_interval_ranks(v, p, mode, marker)
                                      for v in (x.to(cuda_device), x))
        assert ((lg != lc) | (ug != uc))[off].all()
        assert_close(sg, sc, rtol=1e-3, atol=0)
        off &= (lg == lc) & (ug == uc)
    assert not off.any()


def _interval_ranks(x, p, mode, marker):
    """The proxy ESS and the Beta interval ranks of ``mcse(x,
    kind=Quantile(p))``, on the host."""
    s = mtt.ess(x, kind=mtt.Quantile(p), rank_mode=mode, autocov_method=marker)
    l, u = _beta_interval_ranks(s, p, x.shape[0] * x.shape[1])
    return s.cpu(), l.cpu(), u.cpu()


def test_sbm_nested_bfmi_on_card_match_cpu(cuda_device):  # noqa: F811
    x = torch.from_numpy(_ar1(6, (400, 8, 5)).astype(np.float32))
    xg = x.to(cuda_device)
    assert_close(mtt.mcse(xg, kind=lambda w: w.mean()).cpu(),
                 mtt.mcse(x, kind=lambda w: w.mean()), rtol=1e-3, atol=0)
    ids = [0, 0, 1, 1, 2, 2, 3, 3]
    assert_close(mtt.rhat_nested(xg, ids).cpu(), mtt.rhat_nested(x, ids),
                 rtol=0, atol=1e-4)
    e = x[:, :, 0]
    assert_close(mtt.bfmi(e.to(cuda_device)).cpu(), mtt.bfmi(e),
                 rtol=1e-5, atol=0)


def test_cuda_float16_tensor_raises(cuda_device):  # noqa: F811
    x = torch.zeros((20, 2, 2), dtype=torch.float16, device=cuda_device)
    with pytest.raises(NotImplementedError, match="float32"):
        mtt.ess_rhat(x)
    for fn in (mtt.mcse, mtt.ess, lambda v: mtt.rhat_nested(v, [0, 1]),
               lambda v: mtt.bfmi(v[:, :, 0]), mtt.gelmandiag,
               mtt.gelmandiag_multivariate, mtt.gewekediag, mtt.heideldiag,
               mtt.rafterydiag, lambda v: mtt.gewekediag(v[:, 0, 0]),
               lambda v: mtt.heideldiag(v[:, 0, 0])):
        with pytest.raises(NotImplementedError, match="float32"):
            fn(x)


# ---- the kernel studies (K6-K9) and the out-of-core path ---------------------

@pytest.mark.parametrize("variant", ["a", "b"])
@pytest.mark.parametrize("niter,series,maxlag", [
    (1001, 320, 0), (1001, 320, 10), (1001, 320, 63), (1000, 70, 64),
    (1001, 320, 100), (1000, 33, 250), (300, 37, 303), (7, 5, 12), (1, 6, 4),
    (129, 31, 130), (1001, 259, 65), (1001, 259, 255), (1001, 148, 256),
])
def test_k6_matches_plain(cuda_device, variant, niter, series,  # noqa: F811
                          maxlag):
    """Every window length of variant B (17, 16, 32) and lag count of A,
    series counts off the 32-series block and off 4, draws off the tile and
    off the window length, more than one lag span, lags past niter (zeros);
    the series are not centered."""
    x = t(_ar1(11, (niter, series)) + 0.5, torch.float32).to(cuda_device)
    before = dict(kernels.launch_counts())
    got = k6.lag_products(x, maxlag, variant)
    want = k6.lag_products_plain(x, maxlag)
    after = kernels.launch_counts()
    other = "b" if variant == "a" else "a"
    assert after["K6" + variant] == before["K6" + variant] + 1
    assert after["K6" + other] == before["K6" + other]
    assert got.shape == (maxlag + 1, series)
    assert_close(got, want, rtol=0, atol=2e-5)
    assert torch.equal(got[niter:], torch.zeros_like(got[niter:]))
    assert_close(got, k6.lag_products(x, maxlag, other), rtol=0, atol=2e-5)


@pytest.mark.parametrize("rows,cols,tile,pods,stride,seg", [
    (64, 8, 8, 2, 2, None), (64, 8, 8, 2, 1, 2), (64, 8, 8, 8, 1, 1),
    (96, 12, 8, 3, 2, 4), (96, 132, 8, 2, 3, 8), (16384, 128, 2048, 2, 2, None),
    (16384, 128, 2048, 4, 1, 32), (8192, 128, 2048, 1, 4, 64),
])
def test_k7_k8_match_plain(cuda_device, rows, cols, tile, pods,  # noqa: F811
                           stride, seg):
    """In place, equal to the plain version, for column counts off 128,
    segment lengths given and chosen, and blocks up to 128 KB."""
    rng = np.random.default_rng(12)
    keys = torch.from_numpy(rng.random((rows, cols), dtype=np.float32))
    keys = keys.to(cuda_device)
    payload = torch.arange(rows * cols, dtype=torch.int32,
                           device=cuda_device).reshape(rows, cols)
    want_k, want_p = k789.pass_plain(keys, payload, pods, stride, tile)
    before = kernels.launch_counts()
    k, p = keys.clone(), payload.clone()
    assert k789.pass_strided(k, p, pods, stride, tile_rows=tile,
                             seg_rows=seg)[0] is k
    assert torch.equal(k, want_k) and torch.equal(p, want_p)
    k, p = keys.clone(), payload.clone()
    k789.pass_contig(k, p, pods * stride, tile_rows=tile, seg_rows=(
        seg if seg is None or pods * stride * seg * cols * 8 <= 227 * 1024
        else 1))
    assert torch.equal(k, want_k) and torch.equal(p, want_p)
    after = kernels.launch_counts()
    assert (after["K7"], after["K8"]) == (before["K7"] + 1, before["K8"] + 1)


@pytest.mark.parametrize("rows,cols,tile,pods,stride,seg,stages,grid", [
    (4096, 4, 8, 2, 1, 1, 2, 1),        # the smallest ring, one block:
    (4096, 4, 8, 2, 2, 1, 2, 3),        # 2048 stages through 2 slots; 3
    (2048, 12, 16, 4, 2, 2, 3, 5),      # blocks, a ring of 3, 5 blocks
    (64, 8, 8, 2, 1, 8, None, None),    # 4 tasks: fewer than the blocks
    (64, 4, 8, 2, 2, 1, None, None),    # seg_rows 1, 4 columns: 16 bytes
    (160, 12, 8, 2, 2, 4, None, None),  # 12, 20 and 132 columns
    (160, 20, 8, 2, 2, None, None, None),
    (256, 132, 8, 2, 1, 4, None, None),
    (96, 8, 8, 1, 4, None, None, None),  # stride > 1 with pods 1
    (8192, 20, 2048, 2, 2, 1, 2, None),  # 2 stages on the card's grid
])
@pytest.mark.parametrize("contiguous", [False, True])
def test_k7_k8_ring_edges(cuda_device, rows, cols, tile, pods,  # noqa: F811
                          stride, seg, stages, grid, contiguous):
    """The ring at its edges, equal to the plain version, two runs
    bit-equal: the smallest ring (2 stages) wrapped thousands of times by
    one block and by a few, fewer tasks than blocks, 1-row segments (16-byte
    copies), column counts 4, 12, 20 and 132, a stride with pods of one.
    A forced ring or grid runs through ``run_pass`` (no launch counted);
    the others through the wrappers, which count one launch each."""
    if contiguous:
        pods, stride = pods * stride, 1
    rng = np.random.default_rng(rows + cols)
    keys = torch.from_numpy(rng.random((rows, cols), dtype=np.float32))
    keys = keys.to(cuda_device)
    payload = torch.arange(rows * cols, dtype=torch.int32,
                           device=cuda_device).reshape(rows, cols)
    want_k, want_p = k789.pass_plain(keys, payload, pods, stride, tile)
    lib = _build.library()
    kw = {"contiguous": contiguous}
    if stages is not None:
        kw["stages"] = stages
    plan = k789.card_pass_plan(lib, keys, pods, stride, tile, seg, **kw)
    if grid is not None:
        plan = k789.pass_plan(rows, cols, pods, stride, tile, seg, sms=grid,
                              occupancy=lambda smem: 1, **kw)
        assert plan["grid"] == grid
    if (rows, pods) == (64, 2) and seg == 8:
        assert plan["tasks"] == plan["grid"] == 4
    outs = []
    for _ in range(2):
        k, p = keys.clone(), payload.clone()
        before = kernels.launch_counts()
        if stages is None and grid is None:
            if contiguous:
                k789.pass_contig(k, p, pods, tile_rows=tile, seg_rows=seg)
            else:
                k789.pass_strided(k, p, pods, stride, tile_rows=tile,
                                  seg_rows=seg)
            after = kernels.launch_counts()
            kid, other = ("K8", "K7") if contiguous else ("K7", "K8")
            assert after[kid] == before[kid] + 1
            assert after[other] == before[other]
        else:
            k789.run_pass(lib, plan, k, p)
        torch.cuda.synchronize()
        outs.append((k, p))
    for k, p in outs:
        assert torch.equal(k, want_k) and torch.equal(p, want_p)
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_k7_k8_reject_a_misaligned_view(cuda_device):  # noqa: F811
    """A view 4 bytes into a flat buffer: the wrappers raise before any
    launch, and the C entry point refuses such a walk."""
    flat = torch.zeros(64 * 8 + 1, device=cuda_device)
    k = flat[1:].view(64, 8)
    p = torch.zeros((64, 8), dtype=torch.int32, device=cuda_device)
    pflat = torch.zeros(64 * 8 + 1, dtype=torch.int32, device=cuda_device)
    before = kernels.launch_counts()
    for call in (lambda: k789.pass_strided(k, p, 2, 1, tile_rows=8),
                 lambda: k789.pass_contig(k, p, 2, tile_rows=8),
                 lambda: k789.pass_strided(p.float(), pflat[1:].view(64, 8),
                                           2, 1, tile_rows=8)):
        with pytest.raises(ValueError, match="16-byte"):
            call()
    after = kernels.launch_counts()
    assert (after["K7"], after["K8"]) == (before["K7"], before["K8"])
    lib = _build.library()
    plan = k789.pass_plan(64, 8, 2, 1, 8)
    with pytest.raises(RuntimeError, match="mdt_sort_pass"):
        k789.run_pass(lib, plan, k, p)


@pytest.mark.parametrize("rows,cols,pod_rows", [
    (64, 8, 2), (64, 8, 16), (64, 12, 64), (4096, 4, 2048), (8192, 20, 4096),
    (16384, 8, 8192), (32768, 8, 16384), (65536, 4, 32768), (48, 4, 8),
    (96, 12, 32), (1536, 20, 512), (6144, 20, 2048), (131072, 4, 65536),
])
def test_k9_matches_plain(cuda_device, rows, cols, pod_rows):  # noqa: F811
    """Pods below the 16 rows of a thread, below, at and above the 1024-row
    chunk (wide passes of 1 to 5 strides through device memory, two for a
    pod of 65,536), an odd number of pods, a last chunk that passes the end
    of the array, column counts off the 8-column block."""
    g = torch.Generator().manual_seed(13)
    keys = torch.randperm(rows * cols, generator=g).float().reshape(rows, cols)
    keys = keys.to(cuda_device)
    payload = torch.arange(rows * cols, dtype=torch.int32,
                           device=cuda_device).reshape(rows, cols)
    want_k, want_p = k789.bitonic_pod_sort_plain(keys, payload, pod_rows)
    before = kernels.launch_counts()["K9"]
    k, p = k789.bitonic_pod_sort(keys.clone(), payload.clone(), pod_rows)
    assert kernels.launch_counts()["K9"] == before + 1
    assert torch.equal(k, want_k) and torch.equal(p, want_p)
    assert torch.equal(keys.reshape(-1)[p.long()], k)
    pods = k.reshape(-1, pod_rows, cols)
    up = torch.sort(keys.reshape(-1, pod_rows, cols), dim=1).values
    assert torch.equal(pods[0::2], up[0::2])
    assert torch.equal(pods[1::2], up[1::2].flip(1))


def test_study_wrappers_reject_what_the_kernels_do_not_take(cuda_device):  # noqa: F811
    k = torch.zeros((64, 6), device=cuda_device)
    p = torch.zeros((64, 6), dtype=torch.int32, device=cuda_device)
    for call in (lambda: k789.pass_strided(k, p, 2, 1, tile_rows=8),
                 lambda: k789.pass_contig(k, p, 2, tile_rows=8),
                 lambda: k789.bitonic_pod_sort(k, p, 8)):
        with pytest.raises(ValueError, match="multiple of 4"):
            call()
    k = torch.zeros((64, 8), device=cuda_device)
    p = torch.zeros((64, 8), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        k789.bitonic_pod_sort(k.t().contiguous().t(), p, 8)
    with pytest.raises(ValueError, match="seg_rows"):
        k789.pass_strided(k, p, 2, 1, tile_rows=8, seg_rows=3)
    big = torch.zeros((2048, 128), device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        k789.pass_contig(big, big.int(), 1, seg_rows=512)
    with pytest.raises(NotImplementedError):
        k789.pass_contig(k.half(), p, 2, tile_rows=8)
    with pytest.raises(ValueError, match="contiguous"):
        k6.lag_products(k.t(), 3)
    with pytest.raises(NotImplementedError):
        k6.lag_products(k.half(), 3)


def test_study_entry_points_run_on_the_card(cuda_device):  # noqa: F811
    """The benchmarks' functions return outputs and times."""
    x = micro_lagloop.make_input(1, niter=200, series=64, device=cuda_device)
    out, times = micro_lagloop.run("b", x, maxlag=20, reps=2)
    assert out.shape == (21, 64) and times["ms"] > 0
    keys, payload = sort_microbench.make_arrays(4, seed=2, device=cuda_device)
    (k, p), times = sort_microbench.bench_dma_pass(
        4, 2, 2, seed=2, device=cuda_device, reps=2)
    assert torch.equal(k, keys + 1) and torch.equal(p, payload + 1)
    assert times["ms"] > 0 and times["gbps"] > 0
    (k, p), _ = sort_microbench.bench_dma_contig(
        4, 2, seed=2, device=cuda_device, reps=2)
    assert torch.equal(k, keys + 1) and torch.equal(p, payload + 1)
    (k, p), times = sort_microbench.bench_phase_a(
        4, 2, seed=2, device=cuda_device, reps=2)
    assert times["stages"] == 78  # 12 * 13 / 2 for pods of 4096 rows
    assert torch.equal(keys.reshape(-1)[p.long()], k)
    (ks, ps), _ = sort_microbench.bench_sort(4, 2, seed=2, device=cuda_device,
                                             reps=2)
    assert torch.equal(k[:4096], ks[:4096])
    assert torch.equal(keys.reshape(-1)[ps.long()], ks)


@pytest.mark.parametrize("mode,chunk", [("fast", 16), ("exact", 16),
                                        ("fast", 64), ("fast", 7)])
def test_streamed_matches_resident(cuda_device, mode, chunk):  # noqa: F811
    """One chunk, even chunks and a ragged last chunk, from a host array."""
    x = _ar1(14, (2000, 16, 40)).astype(np.float32)
    resident = mtt.ess_rhat(torch.from_numpy(x).to(cuda_device),
                            rank_mode=mode)
    before = kernels.launch_counts()
    got, stats = mtt.ess_rhat_streaming(x, param_chunk=chunk, rank_mode=mode,
                                        return_stats=True)
    after = kernels.launch_counts()
    n = -(-40 // chunk)
    assert stats.n_chunks == n and after["K1"] >= before["K1"] + n
    if mode == "fast":
        assert after["K2"] == before["K2"] + n
        assert after["K3"] == before["K3"] + 2 * n
        assert after["K4"] == before["K4"] + 2 * n
    assert got.ess.device.type == "cuda" and got.ess.shape == (40,)
    assert_close(got.ess, resident.ess, rtol=1e-5, atol=0)
    assert_close(got.rhat, resident.rhat, rtol=0, atol=1e-6)
    for name in ("fetch_s", "wait_s", "h2d_s", "compute_s"):
        assert len(getattr(stats, name)) == n
    assert min(stats.h2d_s) > 0 and min(stats.compute_s) > 0


def test_streaming_sources_on_the_card(cuda_device, tmp_path):  # noqa: F811
    """A callable, a read-only memmap and a float64 array (cast on the way
    to the staging buffer) give what the array gives; other streams keep
    working beside the copy stream."""
    x = _ar1(15, (1000, 8, 21)).astype(np.float32)
    want = mtt.ess_rhat_streaming(x, param_chunk=8)
    reads = []

    def source(start, size):
        reads.append((start, size))
        return x[:, :, start:start + size]

    got = mtt.ess_rhat_streaming(source, nparams=21, param_chunk=8)
    assert reads == [(0, 1), (0, 8), (8, 8), (16, 5)]
    assert_close(got.ess, want.ess, rtol=1e-5, atol=0)
    f = tmp_path / "chains.dat"
    m = np.memmap(f, dtype=np.float32, mode="w+", shape=x.shape)
    m[:] = x
    m.flush()
    ro = np.memmap(f, dtype=np.float32, mode="r", shape=x.shape)
    assert_close(mtt.ess_rhat_streaming(ro, param_chunk=8).ess, want.ess,
                 rtol=1e-5, atol=0)
    assert_close(mtt.ess_rhat_streaming(x.astype(np.float64),
                                        param_chunk=8).ess, want.ess,
                 rtol=1e-5, atol=0)
    assert_close(mtt.ess_rhat_streaming(x, dtype=torch.float64,
                                        param_chunk=8).ess,
                 mtt.ess_rhat_streaming(x, dtype=torch.float64, device="cpu",
                                        param_chunk=8).ess,
                 rtol=1e-9, atol=0)
    with pytest.raises(NotImplementedError, match="float32"):
        mtt.ess_rhat_streaming(x, dtype=torch.float16)
    with pytest.raises(ValueError, match="host sample"):
        mtt.ess_rhat_streaming(torch.from_numpy(x).to(cuda_device))
    out = mtt.stream_param_chunks(lambda c: c[0, 0], x, param_chunk=4)
    assert torch.equal(out.cpu(), torch.from_numpy(x[0, 0]))


# ---- float64 on the card, numpy input, discretediag and R* -------------------

def _inf_heavy(v):
    """Parameter 5 at +inf in 3 of every 4 draws: a NaN median, no NaN."""
    v = v.clone()
    v[torch.arange(v.shape[0], device=v.device) % 4 != 0, :, 5] = torch.inf
    return v


_F64_CALLS = [
    lambda v: mtt.ess_rhat(v, kind="rank", rank_mode="fast"),
    lambda v: mtt.ess_rhat(v, kind="rank"),
    lambda v: mtt.ess(v, kind="tail", rank_mode="fast"),
    lambda v: mtt.mcse(v, kind="mean"),
    lambda v: mtt.mcse(v, kind=mtt.Quantile(0.1), rank_mode="fast"),
    lambda v: mtt.rhat_nested(v, [0, 0, 1, 1]),
    lambda v: mtt.gewekediag(v),
    lambda v: mtt.heideldiag(v),
    lambda v: mtt.gelmandiag(v),
    lambda v: mtt.rafterydiag(v, r=0.05),
    lambda v: mtt.bfmi(v[:, 0, 0]),
    lambda v: mtt.ess_rhat(v, kind="rank", fold_impl="merge"),
    lambda v: mtt.rhat(_inf_heavy(v), kind="tail", fold_impl="merge"),
]


@pytest.mark.parametrize("call", range(len(_F64_CALLS)))
def test_float64_runs_plain_versions_on_the_card(cuda_device, call):  # noqa: F811
    """A CUDA float64 tensor computes on the card through the plain
    versions (no kernel launches) and agrees with the CPU within 1e-6."""
    fn = _F64_CALLS[call]
    x = t(_ar1(21, (600, 4, 6)))
    kernels.reset_launch_counts()
    g = fn(x.to(cuda_device))
    assert not any(kernels.launch_counts().values())
    c = fn(x)
    g = g if isinstance(g, tuple) else (g,)
    c = c if isinstance(c, tuple) else (c,)
    for gv, cv in zip(g, c):
        if isinstance(gv, torch.Tensor):
            assert gv.device.type == "cuda" and gv.dtype in (
                torch.float64, torch.bool, torch.int64), gv.dtype
            gv = gv.cpu()
        assert_close(gv, cv, rtol=1e-6, atol=1e-9, equal_nan=True)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_numpy_input_runs_on_the_current_card(cuda_device, dtype):  # noqa: F811
    """Numpy with no device lands on the current card, float64 as float32
    (the JAX package's default), and launches K1-K4: the float32 tensor's
    result."""
    x = _ar1(22, (300, 4, 3)).astype(dtype)
    want = torch.device("cuda", torch.cuda.current_device())
    assert to_tensor(x).device == want
    assert canonicalize(x)[0].device == want
    kernels.reset_launch_counts()
    res = mtt.ess_rhat(x, rank_mode="fast")
    counts = kernels.launch_counts()
    assert all(counts[k] >= 1 for k in ("K1", "K2", "K3", "K4")), counts
    assert res.ess.device == want and res.ess.dtype == torch.float32
    f32 = mtt.ess_rhat(torch.from_numpy(x.astype(np.float32)).to(want),
                       rank_mode="fast")
    assert torch.equal(res.ess, f32.ess) and torch.equal(res.rhat, f32.rhat)
    assert mtt.gewekediag(x).zscore.device == want
    assert mtt.discretediag(np.round(x)).between_chain.stat.device == want
    cpu = mtt.ess_rhat(x, rank_mode="fast", device="cpu")
    assert cpu.ess.device.type == "cpu"


_DISCRETE = ("weiss", "hangartner", "billingsley", "DARBOOT", "MCBOOT",
             "billingsleyBOOT")


@pytest.mark.parametrize("method", _DISCRETE)
def test_discretediag_on_card_matches_cpu(cuda_device, method):  # noqa: F811
    """Chi-squared methods: stat, df and p within 1e-9 relative; bootstrap
    methods: the statistic (independent of the draws) within 1e-12, df
    finite, p-values in [0, 1] (the draws differ between devices)."""
    rng = np.random.default_rng(23)
    x = np.concatenate([rng.integers(0, 3, size=(400, 4, 3)),
                        rng.integers(0, 6, size=(400, 4, 2))], axis=2)
    g = mtt.discretediag(t(x).to(cuda_device), method=method, nsim=100, rng=1)
    c = mtt.discretediag(t(x), method=method, nsim=100, rng=1)
    for part in ("between_chain", "within_chain"):
        gp, cp = getattr(g, part), getattr(c, part)
        assert all(v.device.type == "cuda" and v.dtype == torch.float64
                   for v in gp)
        if method.endswith("BOOT"):
            assert_close(gp.stat.cpu(), cp.stat, rtol=1e-12, atol=0,
                         equal_nan=True)
            assert torch.isfinite(gp.df).all()
            assert ((gp.pvalue >= 0) & (gp.pvalue <= 1)).all()
        else:
            for gv, cv in zip(gp, cp):
                assert_close(gv.cpu(), cv, rtol=1e-9, atol=0, equal_nan=True)


def _gbt_rows(seed, n=3000, nf=4, k=12):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, nf)).astype(np.float32)
    y = rng.integers(0, k, n)
    x[:, 0] += y * 0.5
    return t(x), y, k


def test_gbt_predict_on_card_matches_cpu(cuda_device):  # noqa: F811
    """One state (fitted on the card), predicted on the card and on the
    CPU: logits within 1e-5, labels equal where the top two logits are
    apart."""
    x, y, k = _gbt_rows(24)
    clf = mtt.models.GBTClassifier(n_rounds=20, n_bins=32)
    state = clf.fit(x.to(cuda_device), y, k)
    assert state.leaf_value.device.type == "cuda"
    state_cpu = type(state)(*(v.cpu() if isinstance(v, torch.Tensor) else v
                              for v in state))
    lg = clf.predict_logits(state, x.to(cuda_device))
    lc = clf.predict_logits(state_cpu, x)
    assert_close(lg.cpu(), lc, rtol=0, atol=1e-5)
    assert_close(clf.predict_true_proba(state, x.to(cuda_device), y).cpu(),
                 clf.predict_true_proba(state_cpu, x, y), rtol=0, atol=1e-6)


def test_gbt_class_chunked_fit_runs_on_the_card(cuda_device):  # noqa: F811
    """The class-chunked fit on the card gives the dense fit's forest (the
    JAX package's bigk-vs-dense test, on the card)."""
    x, y, k = _gbt_rows(25)
    xg = x.to(cuda_device)
    dense = mtt.models.GBTClassifier(n_rounds=12, n_bins=16, class_chunk=-1)
    bigk = mtt.models.GBTClassifier(n_rounds=12, n_bins=16, class_chunk=5)
    s1, s2 = dense.fit(xg, y, k), bigk.fit(xg, y, k)
    assert s2.split_feature.device.type == "cuda"
    assert torch.equal(s1.split_feature, s2.split_feature)
    assert torch.equal(s1.split_bin, s2.split_bin)
    assert_close(s1.leaf_value.cpu(), s2.leaf_value.cpu(), rtol=0, atol=5e-6)
    assert torch.equal(dense.predict(s1, xg), bigk.predict(s2, xg))
    assert_close(bigk.predict_true_proba(s2, xg, y).cpu(),
                 dense.predict_true_proba(s1, xg, y).cpu(), rtol=0, atol=5e-6)


def test_rstar_on_the_card(cuda_device):  # noqa: F811
    """Separated chains give R* near the number of chains on the card, and
    the deterministic R* is a float."""
    rng = np.random.default_rng(26)
    x = rng.standard_normal((400, 4, 2)) * 0.1
    x += np.arange(4)[None, :, None] * 10.0
    clf = mtt.models.GBTClassifier(n_rounds=10, n_bins=16)
    assert mtt.rstar(clf, t(x).to(cuda_device), rng=0).mean() > 0.7 * 4
    val = mtt.rstar(mtt.models.deterministic(clf), x, rng=0)
    assert isinstance(val, float) and 0.0 <= val <= 8.0


# ---- the sharded path on a world of one rank over NCCL ------------------------


def test_make_mesh_without_a_process_group_raises():
    """No process group started: ``make_mesh()`` raises (it neither starts
    one nor falls back to the CPU). Runs before the NCCL world below starts
    and after it ends."""
    import torch.distributed as dist

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        mtt.parallel.make_mesh()


@pytest.fixture(scope="class")
def nccl_mesh():
    """A ``(1, 1)`` mesh of a world of one rank over NCCL on card 0; the
    group ends with the class."""
    import torch.distributed as dist

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield mtt.parallel.make_mesh()
    finally:
        dist.destroy_process_group()


class TestShardedOnTheCard:
    """Every rank transform of ``ess_rhat_sharded`` and the nested R-hat on
    the card, against the in-core card call within PERF.md section 2's K5
    limits (ESS 1e-3 relative, R-hat 1e-4 absolute); the hist transform
    launches K3 and K4 twice each, every kind K5."""

    @staticmethod
    def _x(cuda_device, seed=27, shape=(2000, 16, 32)):
        return t(_ar1(seed, shape)).to(torch.float32).to(cuda_device)

    @pytest.mark.parametrize("impl", ["gather", "ring", "hist"])
    def test_rank_impl_matches_in_core(self, nccl_mesh, cuda_device,  # noqa: F811
                                       impl):
        x = self._x(cuda_device)
        mode = "fast" if impl == "hist" else "exact"
        kernels.reset_launch_counts()
        got = mtt.parallel.ess_rhat_sharded(x, nccl_mesh, kind="rank",
                                            rank_impl=impl)
        counts = kernels.launch_counts()
        assert counts["K5"] >= 1 and counts["K1"] == 0 and counts["K2"] == 0
        if impl == "hist":
            assert counts["K3"] == 2 and counts["K4"] == 2
        else:
            assert counts["K3"] == 0 and counts["K4"] == 0
        want = mtt.ess_rhat(x, kind="rank", rank_mode=mode)
        assert got.ess.device == x.device and got.ess.shape == (32,)
        assert_close(got.ess.cpu(), want.ess.cpu(), rtol=1e-3, atol=0)
        assert_close(got.rhat.cpu(), want.rhat.cpu(), rtol=0, atol=1e-4)

    @pytest.mark.parametrize("impl", ["gather", "ring", "hist"])
    def test_nested_matches_in_core(self, nccl_mesh, cuda_device,  # noqa: F811
                                    impl):
        x = self._x(cuda_device, 28)
        ids = np.repeat(np.arange(8), 2)
        kernels.reset_launch_counts()
        got = mtt.parallel.rhat_nested_sharded(x, ids, nccl_mesh,
                                               rank_impl=impl)
        counts = kernels.launch_counts()
        assert (counts["K3"], counts["K4"]) == ((2, 2) if impl == "hist"
                                                else (0, 0))
        want = mtt.rhat_nested(x, ids)
        assert_close(got.cpu(), want.cpu(), rtol=0,
                     atol=1e-3 if impl == "hist" else 1e-4)

    @pytest.mark.parametrize("impl", ["gather", "ring", "hist"])
    def test_repeat_calls_are_bit_equal(self, nccl_mesh, cuda_device,  # noqa: F811
                                        impl):
        """Ranks on several cards must compute the replicated values (the
        gather path's tail R-hat, the reduced moments) bit for bit alike:
        on one card, two calls on the same block give the same bits (K3,
        K5, ``torch.sort`` and the reductions are deterministic)."""
        x = self._x(cuda_device, 31)
        a, b = (mtt.parallel.ess_rhat_sharded(x, nccl_mesh, rank_impl=impl)
                for _ in range(2))
        assert torch.equal(a.ess, b.ess) and torch.equal(a.rhat, b.rhat)

    def test_ring_scores_through_k15_are_bit_equal(self, nccl_mesh,  # noqa: F811
                                                   cuda_device, monkeypatch):
        """One ring ``ess_rhat_sharded(kind="rank")`` call and one ring
        ``rhat_nested_local`` call, bit for bit the same calls with K15 off
        (the plain ``blom_scores`` in its place); K15 launches twice a call,
        bulk and fold."""
        from mcmcdiagnostictools_jl_tpu_torch.kernels import tiedrank as k12
        from mcmcdiagnostictools_jl_tpu_torch.parallel import ring_rank

        x = self._x(cuda_device, 32)
        ids = np.repeat(np.arange(8), 2)
        calls = [
            lambda: tuple(mtt.parallel.ess_rhat_sharded(
                x, nccl_mesh, kind="rank", rank_impl="ring")),
            lambda: (mtt.parallel.rhat_nested_local(
                x, ids, nccl_mesh, kind="rank", rank_impl="ring"),),
        ]
        for fn in calls:
            kernels.reset_launch_counts()
            got = fn()
            assert kernels.launch_counts()["K15"] == 2
            with monkeypatch.context() as m:
                m.setattr(ring_rank, "blom_from_counts",
                          lambda c, n: k12.blom_scores(c.add_(1), n,
                                                       torch.float32))
                want = fn()
            assert kernels.launch_counts()["K15"] == 2
            for g, w in zip(got, want):
                assert g.dtype == torch.float32 and torch.equal(
                    g.view(torch.int32), w.view(torch.int32))

    def test_float64_launches_no_kernel(self, nccl_mesh,  # noqa: F811
                                        cuda_device):
        x = self._x(cuda_device).double()
        kernels.reset_launch_counts()
        got = mtt.parallel.ess_rhat_sharded(x, nccl_mesh, rank_impl="hist")
        assert not any(kernels.launch_counts().values())
        assert got.ess.dtype == torch.float64
        want = mtt.ess_rhat(x.cpu(), kind="rank", rank_mode="fast")
        assert_close(got.ess.cpu(), want.ess, rtol=1e-6, atol=0)

    def test_streaming_on_the_mesh(self, nccl_mesh):
        x = _ar1(29, (1000, 8, 40)).astype(np.float32)
        kernels.reset_launch_counts()
        got = mtt.ess_rhat_streaming(x, param_chunk=16, mesh_cfg=nccl_mesh)
        counts = kernels.launch_counts()
        assert counts["K3"] == 6 and counts["K4"] == 6 and counts["K5"] >= 3
        want = mtt.ess_rhat_streaming(x, param_chunk=16)
        assert got.ess.device.type == "cuda"
        assert_close(got.ess.cpu(), want.ess.cpu(), rtol=1e-3, atol=0)
        assert_close(got.rhat.cpu(), want.rhat.cpu(), rtol=0, atol=1e-4)

    @pytest.mark.parametrize("impl", ["gather", "ring"])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    def test_sign_bit_nan_columns(self, nccl_mesh, cuda_device,  # noqa: F811
                                  impl, dtype):
        """Sign-bit NaNs poison their columns of the exact sharded call
        (see ``test_sign_bit_nan_columns_are_poisoned``)."""
        neg = _signed_nan_sample(-np.nan).to(dtype)
        pos = _signed_nan_sample(np.nan).to(dtype)
        got, want = (mtt.parallel.ess_rhat_sharded(v.to(cuda_device),
                                                   nccl_mesh, rank_impl=impl)
                     for v in (neg, pos))
        cpu = mtt.ess_rhat(pos, kind="rank")
        for g, w, c, tol in zip(got, want, cpu, _SIGNED_NAN_TOL[dtype]):
            _check_signed_nan_columns(g, w, c, tol)

    def test_sharded_gbt_equals_single(self, nccl_mesh,  # noqa: F811
                                       cuda_device):
        x, y, k = _gbt_rows(30)
        xg = x.to(cuda_device)
        kw = dict(n_rounds=10, n_bins=16)
        s1 = mtt.models.GBTClassifier(**kw).fit(xg, y, k)
        s2 = mtt.models.ShardedGBTClassifier(**kw).fit(xg, y, k)
        assert torch.equal(s1.split_feature, s2.split_feature)
        assert torch.equal(s1.split_bin, s2.split_bin)
        assert_close(s1.leaf_value.cpu(), s2.leaf_value.cpu(), rtol=0,
                     atol=1e-5)


# ---- K10 and K11: the exact tail transform's fold merge and moments --------

def _fold_inputs(n, p, seed, device):
    """The sort of an ``(n, p)`` sample into rows ``(p, n)`` (NaN row 1,
    constant 2, heavy ties 3, 75 % +inf 4: a NaN median and no NaN) and its
    medians, as the tail transform makes them."""
    from mcmcdiagnostictools_jl_tpu_torch.ops.ranknorm import (
        sort_with_positions, sorted_quantile)

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 1, p)).astype(np.float32)
    x[::97, 0, 1] = np.nan
    x[:, 0, 2] = 0.75
    x[:, 0, 3] = np.round(x[:, 0, 3] * 2) / 2
    x[rng.random(n) < 0.75, 0, 4] = np.inf
    xs, order, bad = sort_with_positions(torch.from_numpy(x).to(device))
    return xs, order, torch.where(bad, torch.nan,
                                  sorted_quantile(xs, 0.5))


def _keys_equal(a, b):
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a.view(torch.int32)[~na],
                                               b.view(torch.int32)[~nb])


def _routed(fs, forder):
    from mcmcdiagnostictools_jl_tpu_torch.ops.ranknorm import _avg_ranks_sorted

    r = _avg_ranks_sorted(fs)
    return torch.empty_like(r).scatter_(1, forder, r)


@pytest.mark.parametrize("n,p", [(1, 5), (127, 5), (128, 33), (4099, 37),
                                 (8191, 6), (50_000, 64), (300_001, 70)])
def test_k10_matches_valley_sort_2d(cuda_device, n, p):  # noqa: F811
    xs, order, med = _fold_inputs(n, p, n + p, cuda_device)
    before = k10.valley_merge.launches
    fs, forder = k10.valley_merge(xs, order, med)
    assert k10.valley_merge.launches == before + 1
    assert fs.shape == forder.shape == (p, n)
    fp, fop = k10.valley_merge_plain(xs, order, med)
    ref_k, ref_i = torch.sort(torch.abs(xs - med[:, None]), dim=1, stable=True)
    torch.cuda.synchronize()
    assert _keys_equal(fs, fp) and _keys_equal(fs, ref_k)
    flat = torch.arange(n, device=cuda_device).expand(p, n)
    assert torch.equal(torch.sort(forder, dim=1).values, flat)
    want = _routed(ref_k, order.gather(1, ref_i))
    assert torch.equal(_routed(fs, forder), want)
    assert torch.equal(_routed(fp, fop), want)
    nan_med = torch.isnan(med)
    assert (n < 100 or bool(nan_med[4]))
    assert torch.equal(forder[nan_med], order[nan_med])


@pytest.mark.parametrize("ndraws,nchains,split,p", [
    (1001, 4, 2, 7), (999, 3, 3, 33), (500, 1, 2, 5), (2000, 32, 2, 64),
    (20, 4000, 2, 3),  # 8000 split chains: the global accumulators
    (3, 5, 4, 2)])     # fewer draws than splits: no draw kept
def test_k11_bit_equal_runs_and_float64_plain(cuda_device, ndraws, nchains,  # noqa: F811
                                              split, p):
    rng = np.random.default_rng(ndraws + nchains + p)
    n = ndraws * nchains
    v = torch.from_numpy(rng.standard_normal((p, n)).astype(np.float32))
    order = torch.from_numpy(np.stack([rng.permutation(n) for _ in range(p)]))
    v, order = v.to(cuda_device), order.to(cuda_device)
    a = k11.segment_moments(v, order, ndraws, nchains, split)
    b = k11.segment_moments(v, order, ndraws, nchains, split)
    # the ring route's layout: (N, P) blocks passed transposed
    d = k11.segment_moments(v.t().contiguous().t(), order.t().contiguous().t(),
                            ndraws, nchains, split)
    c = k11.segment_moments_plain(v.double(), order, ndraws, nchains, split)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x, y) for x, y in zip(a, d))
    for x, y in zip(a[:2], c[:2]):
        assert x.dtype == torch.float32 and x.shape == (nchains * split, p)
        rel = (x.double() - y).abs() / y.abs().clamp(min=1.0)
        assert float(rel.max()) <= 1e-6
    assert torch.equal(a[2].double(), c[2]) and torch.equal(a[3].double(), c[3])


def test_k11_values_outside_its_range_give_nan(cuda_device):  # noqa: F811
    v = torch.randn((3, 400), device=cuda_device)
    v[1, 7] = 9.0
    order = torch.arange(400, device=cuda_device).repeat(3, 1)
    s, s2, lo, hi = k11.segment_moments(v, order, 100, 4, 2)
    assert bool(torch.isnan(s[:, 1]).all()) and bool(torch.isnan(lo[1]))
    assert bool(torch.isfinite(s[:, [0, 2]]).all())


@pytest.mark.parametrize("kind", ["tail", "rank"])
def test_exact_call_runs_k10_and_k11_and_matches_cpu(cuda_device, kind):  # noqa: F811
    x = torch.from_numpy(_ar1(5, (2000, 32, 64)).astype(np.float32))
    x[:, :, 3] = torch.round(x[:, :, 3])
    c = mtt.ess_rhat(x, kind=kind, fold_impl="merge")
    runs = {}
    for impl in ("auto", "merge", "sort"):
        kernels.reset_launch_counts()
        runs[impl] = mtt.ess_rhat(x.to(cuda_device), kind=kind,
                                  fold_impl=impl)
        counts = kernels.launch_counts()
        assert counts["K10"] == (impl != "sort") and counts["K11"] == 1
        assert_close(runs[impl].rhat.cpu(), c.rhat, rtol=0, atol=1e-4)
    for impl in ("merge", "sort"):
        assert torch.equal(runs[impl].ess, runs["auto"].ess)
        assert torch.equal(runs[impl].rhat, runs["auto"].rhat)


def test_fold_wrappers_reject_what_the_kernels_do_not_take(cuda_device):  # noqa: F811
    xs = torch.zeros((8, 64), device=cuda_device)
    order = torch.zeros((8, 64), dtype=torch.int64, device=cuda_device)
    med = torch.zeros(8, device=cuda_device)
    with pytest.raises(ValueError):
        k10.valley_merge(xs, order.int(), med)
    with pytest.raises(ValueError):
        k10.valley_merge(xs.t().contiguous().t(), order, med)
    with pytest.raises(ValueError):  # rows off a 16-byte boundary
        k10.valley_merge(torch.zeros(8 * 64 + 1, device=cuda_device)[1:]
                         .view(8, 64), order, med)
    with pytest.raises(ValueError):
        k11.segment_moments(xs, order, 10, 8, 2)  # 80 entries, not 64
    with pytest.raises(ValueError):  # neither rows nor columns contiguous
        k11.segment_moments(xs[:, ::2], order[:, ::2], 4, 8, 2)
    with pytest.raises(ValueError):  # values and positions strided apart
        k11.segment_moments(xs, order.t().contiguous().t(), 8, 8, 2)
    with pytest.raises(NotImplementedError):
        k11.segment_moments(xs.half(), order, 8, 8, 2)


# ---- sign-bit NaNs: the card's sort puts them first -------------------------

# the poisoned columns of ``_signed_nan_sample``: all NaN, and one NaN among
# numbers; the others finite
_NAN_COLS, _FINITE_COLS = [1, 3], [0, 2, 4, 5]
# (ESS or MCSE relative, R-hat absolute) of the card against the CPU: the
# slice's float32 limits, BASELINE.md's 1e-6 in float64
_SIGNED_NAN_TOL = {torch.float32: ((1e-3, 0), (0, 1e-4)),
                   torch.float64: ((1e-6, 0), (0, 1e-6))}


def _signed_nan_sample(nan_value):
    """(2000, 16, 6) AR(1) draws, rows of 32,000 entries (the card sorts
    rows that long by radix), with ``nan_value`` filling column 1 and once
    in column 3."""
    x = _ar1(41, (2000, 16, 6))
    x[:, :, 1] = nan_value
    x[777, 5, 3] = nan_value
    return torch.from_numpy(x)


def _check_signed_nan_columns(got, pos, cpu, tol):
    """``got`` (the sample with sign-bit NaNs, on the card) is NaN in the
    poisoned columns and bit-equal elsewhere to ``pos`` (the same sample
    with ``+nan``, on the card), which tracks ``cpu`` there."""
    assert bool(torch.isnan(got[_NAN_COLS]).all())
    assert bool(torch.isfinite(got[_FINITE_COLS]).all())
    assert torch.equal(got[_FINITE_COLS], pos[_FINITE_COLS])
    assert_close(pos[_FINITE_COLS].cpu(), cpu[_FINITE_COLS],
                 rtol=tol[0], atol=tol[1])


_SIGNED_NAN_CALLS = [
    ("ess_rhat", dict(kind="rank", fold_impl="sort")),
    ("ess_rhat", dict(kind="rank", fold_impl="merge")),
    ("ess", dict(kind="median")),
    ("ess", dict(kind="mad")),
    ("mcse", dict(kind=mtt.Quantile(0.25))),
    ("ess_rhat_streaming", dict(rank_mode="exact", param_chunk=4)),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("fn,kw", _SIGNED_NAN_CALLS, ids=str)
def test_sign_bit_nan_columns_are_poisoned(cuda_device, fn, kw,  # noqa: F811
                                           dtype):
    """A column of sign-bit NaNs (``0xffc00000`` / ``0xfff8000000000000``:
    ``-np.nan``) and a column with one among numbers come out NaN on the
    card, whichever end of a sorted row the card's sort puts them at, and
    the other columns as with ``+nan`` there and as on the CPU. The quantile
    MCSE is held to the CPU only where the interval ranks agree (see
    ``test_estimators_on_card_match_cpu``)."""
    neg = _signed_nan_sample(-np.nan).to(dtype)
    pos = _signed_nan_sample(np.nan).to(dtype)
    bits = {torch.float32: (torch.int32, -0x400000),
            torch.float64: (torch.int64, -0x8000000000000)}[dtype]
    assert int(neg[0, 0, 1].view(bits[0])) == bits[1]
    call = getattr(mtt, fn)
    if fn == "ess_rhat_streaming":
        got, want = (call(v.numpy(), dtype=dtype, device=cuda_device, **kw)
                     for v in (neg, pos))
        cpu = call(pos.numpy(), dtype=dtype, device="cpu", **kw)
    else:
        got, want = (call(v.to(cuda_device), **kw) for v in (neg, pos))
        cpu = call(pos, **kw)
    if not isinstance(got, tuple):
        got, want, cpu = (got,), (want,), (cpu,)
    if fn == "mcse" and dtype == torch.float32:
        # an ESS within 1e-3 may move a Beta interval rank, and then the
        # card reads other order statistics than the CPU
        (sg, lg, ug), (sc, lc, uc) = (
            _interval_ranks(v, 0.25, "exact", "auto")
            for v in (pos.to(cuda_device), pos))
        assert_close(sg[_FINITE_COLS], sc[_FINITE_COLS], rtol=1e-3, atol=0)
        moved = (lg != lc) | (ug != uc)
        cpu = (torch.where(moved, want[0].cpu(), cpu[0]),)
    for g, w, c, tol in zip(got, want, cpu, _SIGNED_NAN_TOL[dtype]):
        _check_signed_nan_columns(g, w, c, tol)


# ---- the HMC sampler and the profiling hooks on the card ------------------

@pytest.mark.parametrize("target,dim,step", [("cauchy", 64, 0.25),
                                             ("eight_schools", 10, 0.2)])
def test_hmc_core_on_card_matches_cpu(cuda_device, target, dim,  # noqa: F811
                                      step):
    """The deterministic core on the same float64 draws on the card and on
    the CPU: samples and energy within 1e-8 (the targets' transcendental
    functions may round differently on the two)."""
    logpdf = getattr(mtt.models, f"{target}_logpdf")
    g = torch.Generator().manual_seed(3)
    chains, draws = 8, 40
    init = 0.5 * torch.randn((chains, dim), dtype=torch.float64, generator=g)
    p = torch.randn((draws, chains, dim), dtype=torch.float64, generator=g)
    n = torch.randint(1, 17, (draws, chains), generator=g)
    u = torch.rand((draws, chains), dtype=torch.float64, generator=g)
    cpu = mtt.models.hmc.hmc_transitions(logpdf, init, p, n, u,
                                         step_size=step, max_leapfrog=16)
    card = mtt.models.hmc.hmc_transitions(
        logpdf, *(v.to(cuda_device) for v in (init, p, n, u)),
        step_size=step, max_leapfrog=16)
    assert card.samples.device.type == "cuda"
    for a, b in zip(card, cpu):
        assert_close(a.cpu(), b, rtol=0, atol=1e-8)


def test_hmc_sample_on_card_in_float32(cuda_device):  # noqa: F811
    init = torch.zeros((16, 32), device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    tr = mtt.models.hmc_sample(mtt.models.cauchy_logpdf, init, gen,
                               num_samples=50, step_size=0.25,
                               max_leapfrog=16)
    assert all(v.device.type == "cuda" and v.dtype == torch.float32
               for v in tr)
    assert bool((tr.accept_rate > 0.5).all())
    assert bool(torch.isfinite(mtt.bfmi(tr.energy)).all())


def test_trace_on_card_records_a_kernel(cuda_device, tmp_path):  # noqa: F811
    import json

    x = torch.from_numpy(_ar1(9, (1000, 8, 16)).astype(np.float32))
    xg = x.to(cuda_device)
    mtt.ess_rhat(xg, rank_mode="fast")  # builds and warms the kernels
    with mtt.utils.trace(str(tmp_path)) as prof:
        with mtt.utils.annotate("mdt.fast_ess_rhat"):
            mtt.ess_rhat(xg, rank_mode="fast")
    cuda_events = [e.name for e in prof.events()
                   if e.device_type.name == "CUDA"]
    assert any("moments_autocov_kernel" in name for name in cuda_events)
    (path,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("cat") == "kernel"
               and "moments_autocov_kernel" in e.get("name", "")
               for e in events)


# ---- K12: the exact rank mode's tied ranks and Blom scores ------------------

# z of K12 against its plain version: the same Cephes operations on
# bit-equal ranks; ``logf`` in the tails may come from another toolkit than
# PyTorch's runtime-compiled ``ndtri`` (as for K4's z mode)
_K12_Z_ULP = 4


def _assert_equal_nan(a, b):
    """Equal, NaN where NaN (whatever its bits)."""
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


def _k12_rows(n, device, seed=12):
    """Rows ``(8, n)`` sorted on the card with their positions: heavy ties,
    a constant row, -0.0 and +0.0 together, 75 % +inf, NaN last, runs
    straddling every tile edge, runs ending on every tile edge, and runs of
    three."""
    rng = np.random.default_rng(seed + n)
    j = np.arange(n)
    x = rng.standard_normal((8, n)).astype(np.float32)
    x[0] = np.round(x[0] * 2) / 2
    x[1] = 0.75
    x[2] = np.where(j % 2 == 0, -0.0, 0.0)
    x[2, : n // 3] = -1.0
    x[3, rng.random(n) < 0.75] = np.inf
    x[4, ::997] = np.nan
    x[5] = (j + k12._TILE // 2) // k12._TILE
    x[6] = j // k12._TILE
    x[7] = (j + 1) // 3
    xs, order = torch.sort(torch.from_numpy(x).to(device), dim=1, stable=True)
    return xs, order


@pytest.mark.parametrize("n", [1, 2, k12._TILE - 1, k12._TILE, k12._TILE + 1,
                               3 * k12._TILE + 5, k12._BUCKET - 1,
                               k12._BUCKET, k12._BUCKET + 1,
                               2 * k12._BUCKET + 3, 1_280_000])
def test_k12_matches_its_plain_version(cuda_device, n):  # noqa: F811
    xs, order = _k12_rows(n, cuda_device)
    bad = torch.isnan(xs).any(1)
    before = k12.tied_blom.launches
    ranks = k12.tied_blom(xs, blom=False)
    z = k12.tied_blom(xs)
    z2 = k12.tied_blom(xs)
    zs = k12.tied_blom(xs, order, bad)
    assert k12.tied_blom.launches == before + 4
    assert ranks.shape == z.shape == zs.shape == (8, n)
    want_r = k12.tied_blom_plain(xs, blom=False)
    want_z = k12.tied_blom_plain(xs)
    torch.cuda.synchronize()
    assert torch.equal(ranks, want_r)
    assert torch.equal(z, z2)
    assert _max_ulp(z, want_z) <= _K12_Z_ULP
    # the scatter: the kernel's sorted values, masked, put back by position
    _assert_equal_nan(zs, k12._scatter_rows(
        z.masked_fill(bad[:, None], torch.nan), order))
    assert _max_ulp(zs, k12.tied_blom_plain(xs, order, bad)) <= _K12_Z_ULP
    assert torch.equal(k12.tied_blom(xs, order, blom=False),
                       k12._scatter_rows(want_r, order))


def test_k12_scatters_in_ragged_groups(cuda_device):  # noqa: F811
    """Five rows go in groups of 2, 2 and 1 (the last holds the NaN row);
    the output is the scatter of the sorted values, as with any grouping."""
    xs, order = _k12_rows(k12._BUCKET + 1, cuda_device)
    xs, order = xs[:5].contiguous(), order[:5].contiguous()
    assert k12.group_rows(5) == 2
    bad = torch.isnan(xs).any(1)
    assert bad.tolist() == [False, False, False, False, True]
    zs = k12.tied_blom(xs, order, bad)
    z = k12.tied_blom(xs)
    torch.cuda.synchronize()
    _assert_equal_nan(zs, k12._scatter_rows(
        z.masked_fill(bad[:, None], torch.nan), order))
    assert _max_ulp(zs, k12.tied_blom_plain(xs, order, bad)) <= _K12_Z_ULP
    assert torch.equal(zs.view(torch.int32),
                       k12.tied_blom(xs, order, bad).view(torch.int32))


@pytest.mark.parametrize("n", [k12._TABLE_MAX_N, k12._TABLE_MAX_N + 1])
def test_k12_on_both_sides_of_the_table_limit(cuda_device, n):  # noqa: F811
    """Up to 2^22 entries a row the scores come from the call's table,
    past it they are computed an entry: both follow the plain version."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((2, n)).astype(np.float32)
    x[1] = np.round(x[1] * 4) / 4
    xs, order = torch.sort(torch.from_numpy(x).to(cuda_device), dim=1,
                           stable=True)
    z = k12.tied_blom(xs)
    zs = k12.tied_blom(xs, order)
    want = k12.tied_blom_plain(xs)
    torch.cuda.synchronize()
    assert torch.equal(k12.tied_blom(xs, blom=False),
                       k12.tied_blom_plain(xs, blom=False))
    assert _max_ulp(z, want) <= _K12_Z_ULP
    assert torch.equal(zs, k12._scatter_rows(z, order))


def test_k12_table_holds_every_score_of_a_row(cuda_device):  # noqa: F811
    """Each entry ``k`` in [2, 2n] of the table at n = 1.28M against the
    plain version's score of a run whose 1-based ends add up to ``k``, and
    bit-equal to the sorted-mode z where a row meets it: a tie-free row
    (k = 2j + 2) and a row of pairs (k = 4m + 3)."""
    n = 1_280_000
    table = k12.blom_table(n, cuda_device)
    assert table.shape == (2 * n + 1,) and table.dtype == torch.float32
    k = torch.arange(2, 2 * n + 1, device=cuda_device)
    assert _max_ulp(table[2:], k12.blom_scores(k, n, torch.float32)) <= _K12_Z_ULP
    j = torch.arange(n, device=cuda_device)
    rows = torch.stack([j, j // 2]).float()
    z = k12.tied_blom(rows)
    bits = table.view(torch.int32)
    assert torch.equal(z[0].view(torch.int32), bits[2 * j + 2])
    assert torch.equal(z[1].view(torch.int32), bits[4 * (j // 2) + 3])


def test_k12_on_rows_past_2_24_entries(cuda_device):  # noqa: F811
    """Rows of 2^24 + 1000 entries with ties (runs of two and three, and
    runs of up to ~1000 from rounded normals): every score finite, the
    lowest and highest within 2 float32 ULP of float64's (the float32
    quotient gives +inf at the top from 2^24 on), sorted and scattered
    modes the plain version's."""
    n = 2**24 + 1000
    rng = np.random.default_rng(n)
    x = np.stack([np.arange(n) * 2 // 5,
                  np.round(rng.standard_normal(n) * 100)]).astype(np.float32)
    xs, order = torch.sort(torch.from_numpy(x).to(cuda_device), dim=1,
                           stable=True)
    z = k12.tied_blom(xs)
    zs = k12.tied_blom(xs, order)
    want = k12.tied_blom_plain(xs)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(z).all())
    assert _max_ulp(z, want) <= _K12_Z_ULP
    assert torch.equal(zs, k12._scatter_rows(z, order))
    k = k12._run_sums(xs).double()
    exact = torch.special.ndtri((k / 2 - 0.375) / (n + 0.25))
    ends = torch.tensor([0, n - 1], device=cuda_device)
    assert _max_ulp(z[:, ends], exact[:, ends].float()) <= 2


def test_k12_masks_a_sign_bit_nan_row(cuda_device):  # noqa: F811
    """The card's sort puts a sign-bit NaN first in a long row; with ``bad``
    set the row is NaN, and without it the kernel stays in bounds and the
    other rows are untouched."""
    from mcmcdiagnostictools_jl_tpu_torch.ops.ranknorm import _nan_rows

    xs, order = _k12_rows(40_000, cuda_device)
    x = torch.empty_like(xs).scatter_(1, order, xs)
    neg = torch.tensor([-0x400000], dtype=torch.int32).view(torch.float32)
    x[1, 123] = neg.to(cuda_device)[0]
    x[6, :7] = neg.to(cuda_device)
    xs, order = torch.sort(x, dim=1, stable=True)
    bad = _nan_rows(xs)
    assert bad.tolist() == [False, True, False, False, True, False, True,
                            False]
    got = k12.tied_blom(xs, order, bad)
    loose = k12.tied_blom(xs)
    want = k12.tied_blom_plain(xs, order, bad)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[bad]).all())
    assert _max_ulp(got, want) <= _K12_Z_ULP
    keep = ~bad
    assert _max_ulp(loose[keep], k12.tied_blom_plain(xs)[keep]) <= _K12_Z_ULP


def test_k12_float64_on_the_card_launches_nothing(cuda_device):  # noqa: F811
    xs, order = _k12_rows(5000, cuda_device)
    xs = xs.double()
    kernels.reset_launch_counts()
    got = k12.tied_blom(xs, order, torch.isnan(xs).any(1))
    assert kernels.launch_counts()["K12"] == 0
    assert got.dtype == torch.float64 and got.device == xs.device
    want = k12.tied_blom(xs.cpu(), order.cpu(), torch.isnan(xs).any(1).cpu())
    assert torch.equal(torch.isnan(got.cpu()), torch.isnan(want))
    assert_close(got.cpu(), want, rtol=1e-12, atol=1e-12)


def test_k12_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):  # noqa: F811
    xs = torch.zeros((8, 64), device=cuda_device)
    order = torch.arange(64, device=cuda_device).repeat(8, 1)
    bad = torch.zeros(8, dtype=torch.bool, device=cuda_device)
    with pytest.raises(NotImplementedError):
        k12.tied_blom(xs.half())
    with pytest.raises(ValueError):
        k12.tied_blom(xs.t().contiguous().t())
    with pytest.raises(ValueError):
        k12.tied_blom(xs[0])
    with pytest.raises(ValueError):
        k12.tied_blom(xs, order.int())
    with pytest.raises(ValueError):
        k12.tied_blom(xs, order[:, :32])
    with pytest.raises(ValueError):
        k12.tied_blom(xs, order.t().contiguous().t())
    with pytest.raises(ValueError):
        k12.tied_blom(xs, order, bad.float())
    with pytest.raises(ValueError):
        k12.tied_blom(xs, order, bad[:4])
    with pytest.raises(ValueError):
        k12.tied_blom(xs, order, bad.cpu())


@pytest.mark.parametrize("kind,launches", [("rank", 2), ("tail", 1),
                                           ("bulk", 1)])
def test_exact_calls_launch_k12(cuda_device, kind, launches):  # noqa: F811
    x = torch.from_numpy(_ar1(6, (2000, 32, 64)).astype(np.float32))
    x[:, :, 3] = torch.round(x[:, :, 3])
    c = mtt.ess_rhat(x, kind=kind)
    for impl in ("auto", "sort"):
        kernels.reset_launch_counts()
        g = mtt.ess_rhat(x.to(cuda_device), kind=kind, fold_impl=impl)
        assert kernels.launch_counts()["K12"] == launches
        assert_close(g.rhat.cpu(), c.rhat, rtol=0, atol=1e-4)
        assert_close(g.ess.cpu(), c.ess, rtol=1e-3, atol=0)


def test_tiedrank_on_the_card_runs_k12(cuda_device):  # noqa: F811
    x = torch.from_numpy(np.round(_ar1(7, (3000, 16)) * 2).astype(np.float32))
    x[5, 3] = np.nan
    kernels.reset_launch_counts()
    got = mtt.ops.tiedrank(x.to(cuda_device))
    assert kernels.launch_counts()["K12"] == 1
    assert torch.equal(got.cpu(), mtt.ops.tiedrank(x))


# ---- K13: the exact mode's row sort -----------------------------------------

_K13_KINDS = ["normal", "ties", "all_equal", "infinities", "signed_zeros",
              "nan", "signed_nan", "mixed"]


def _k13_rows(kind, p, n, seed=0):
    """``(p, n)`` float32 rows holding what ``kind`` names (as in
    ``tests/test_torch_radix_sort.py``)."""
    rng = np.random.default_rng(seed + 7 * n + p)
    x = rng.standard_normal((p, n))
    if kind == "ties":
        x = np.round(x * 2) / 2
    elif kind == "all_equal":
        x[:] = 0.75
    elif kind == "infinities":
        x[:, ::3] = np.inf
        x[:, 1::4] = -np.inf
    elif kind == "signed_zeros":
        x[:, ::2] = -0.0
        x[:, 1::3] = 0.0
    elif kind == "nan":
        x[:, ::3] = np.nan
    elif kind == "signed_nan":
        x[:, ::3] = -np.nan
        x[:, 1::5] = np.nan
    elif kind == "mixed":
        x = np.round(x * 2) / 2
        x[:, ::7] = -0.0
        x[:, 1::11] = -np.nan
        x[:, 2::13] = np.nan
        x[:, 3::5] = -np.inf
        x[:, 4::9] = np.inf
    return torch.from_numpy(x.astype(np.float32))


def _same_sort(a, b):
    """Keys bit for bit, positions equal."""
    return (torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
            and torch.equal(a[1], b[1]))


@pytest.mark.parametrize("shape", [(1, 1), (4, 1), (1, 7), (3, 300),
                                   (2, 3841), (2, 2 * 3840 - 5), (3, 4096),
                                   (3, 4097), (5, 100_003)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", _K13_KINDS)
def test_k13_matches_torch_sort(cuda_device, kind, shape):  # noqa: F811
    from mcmcdiagnostictools_jl_tpu_torch.kernels import radix_sort as k13

    x = _k13_rows(kind, *shape).to(cuda_device)
    before = k13.sort_rows.launches
    got = k13.sort_rows(x)
    keys = k13.sort_rows_keys(x)
    assert k13.sort_rows.launches == before + 2
    assert got[1].dtype == torch.int64 and got[1].is_contiguous()
    want = torch.sort(x, dim=1, stable=True)
    torch.cuda.synchronize()
    assert _same_sort(got, want)
    assert _same_sort(got, k13.sort_rows_plain(x))
    assert torch.equal(keys.view(torch.int32), want[0].view(torch.int32))


@pytest.mark.parametrize("rows", [64, 256])
def test_k13_at_the_flagship_width(cuda_device, rows):  # noqa: F811
    from mcmcdiagnostictools_jl_tpu_torch.kernels import radix_sort as k13

    g = torch.Generator(device=cuda_device).manual_seed(rows)
    x = torch.randn((rows, 1_280_000), generator=g, device=cuda_device)
    x[1] = torch.round(x[1] * 4) / 4
    x[2, ::5] = -0.0
    x[3, ::1001] = -torch.nan
    got = k13.sort_rows(x)
    again = k13.sort_rows(x)
    want = torch.sort(x, dim=1, stable=True)
    torch.cuda.synchronize()
    assert _same_sort(got, want)
    assert _same_sort(got, again)


# the digit pass's geometry (kernels/radix_sort.py: PART keys ranked at
# once, TILE = 2 PART keys a ticket; a persistent grid of 3 blocks a
# multiprocessor, 396 on an H100)
_K13_PART, _K13_TILE, _K13_GRID = 3840, 7680, 396


@pytest.mark.parametrize("shape", [
    (4, 1000 * _K13_TILE),  # 4000 tiles: ten times the persistent grid
    (5, 3 * _K13_TILE - 1), (5, 3 * _K13_TILE), (5, 3 * _K13_TILE + 1),
    (3, _K13_PART - 1), (3, _K13_PART), (3, _K13_PART + 1),
    (3, _K13_TILE + _K13_PART - 1), (3, _K13_TILE + _K13_PART + 1),
    (7, 5000), (1, 7),  # fewer tiles than the grid
], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["normal", "mixed"])
def test_k13_persistent_grid_and_tile_edges(cuda_device, kind, shape):  # noqa: F811
    """More tiles than the persistent grid by ten times, rows one short of,
    at and one past a tile and a part, and fewer tiles than the grid: keys
    and positions bit for bit ``torch.sort(dim=1, stable=True)``'s, with
    positions and keys alone."""
    from mcmcdiagnostictools_jl_tpu_torch.kernels import radix_sort as k13

    assert (k13.PART, k13.TILE) == (_K13_PART, _K13_TILE)
    if shape[1] == 1000 * _K13_TILE:
        assert k13.sort_plan(*shape)["tickets"] >= 10 * _K13_GRID
    x = _k13_rows(kind, *shape).to(cuda_device)
    got = k13.sort_rows(x)
    keys = k13.sort_rows_keys(x)
    want = torch.sort(x, dim=1, stable=True)
    torch.cuda.synchronize()
    assert _same_sort(got, want)
    assert torch.equal(keys.view(torch.int32), want[0].view(torch.int32))


@pytest.mark.parametrize("n", [4097, 3 * _K13_TILE + 3, 100_003])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_k13_rows_off_16_byte_boundaries(cuda_device, offset, n):  # noqa: F811
    """A contiguous view that starts ``offset`` floats into its storage, with
    n not a multiple of 4, so that rows start off 16-byte boundaries: the
    same sort as ``torch.sort``."""
    from mcmcdiagnostictools_jl_tpu_torch.kernels import radix_sort as k13

    p = 5
    rows = _k13_rows("mixed", p, n).reshape(-1)
    buf = torch.zeros(p * n + offset, dtype=torch.float32)
    buf[offset:] = rows
    x = buf.to(cuda_device)[offset:].view(p, n)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4 * offset
    got = k13.sort_rows(x)
    keys = k13.sort_rows_keys(x)
    want = torch.sort(x, dim=1, stable=True)
    torch.cuda.synchronize()
    assert _same_sort(got, want)
    assert torch.equal(keys.view(torch.int32), want[0].view(torch.int32))


def test_k13_launches_by_name(cuda_device):  # noqa: F811
    """What the benchmark's readers count, read by name from the profiler:
    a sort with positions launches one ``radix_histogram`` and four
    ``radix_digit_pass`` (three ``<true, false>``, one ``<true, true>``), a
    sort of the keys alone one histogram and four ``<false, false>``."""
    from torch.profiler import ProfilerActivity, profile

    from mcmcdiagnostictools_jl_tpu_torch.kernels import radix_sort as k13

    x = _k13_rows("normal", 6, 50_000).to(cuda_device)
    k13.sort_rows(x)
    k13.sort_rows_keys(x)
    torch.cuda.synchronize()

    def names(fn):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return [e.name for e in prof.events()
                if e.device_type.name == "CUDA"
                and ("radix_histogram" in e.name
                     or "radix_digit_pass" in e.name)]

    def count(ns, key):
        return sum(key in nm for nm in ns)

    with_pos = names(lambda: k13.sort_rows(x))
    assert count(with_pos, "radix_histogram") == 1
    assert count(with_pos, "radix_digit_pass") == 4
    assert count(with_pos, "radix_digit_pass<true, true>") == 1
    assert count(with_pos, "radix_digit_pass<true, false>") == 3
    keys_only = names(lambda: k13.sort_rows_keys(x))
    assert count(keys_only, "radix_histogram") == 1
    assert count(keys_only, "radix_digit_pass<false, false>") == 4
    assert count(keys_only, "radix_digit_pass<true, true>") == 0


def test_k13_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):  # noqa: F811
    from mcmcdiagnostictools_jl_tpu_torch.kernels import radix_sort as k13

    x = torch.zeros((4, 64), device=cuda_device)
    with pytest.raises(NotImplementedError):
        k13.sort_rows(x.half())
    with pytest.raises(NotImplementedError):
        k13.sort_rows_keys(x.half())
    with pytest.raises(ValueError):
        k13.sort_rows(x.t())
    with pytest.raises(ValueError):
        k13.sort_rows(x[None])


def test_k13_float64_on_the_card_launches_nothing(cuda_device):  # noqa: F811
    from mcmcdiagnostictools_jl_tpu_torch.kernels import radix_sort as k13

    x = _k13_rows("mixed", 3, 5000).double().to(cuda_device)
    before = k13.sort_rows.launches
    got = k13.sort_rows(x)
    assert k13.sort_rows.launches == before
    assert torch.equal(got[1], torch.sort(x, dim=1, stable=True).indices)
    assert torch.equal(got[1].cpu(), k13.sort_rows_plain(x.cpu())[1])


@pytest.mark.parametrize("fn,kw,launches", [
    ("ess_rhat", dict(kind="rank"), 1),
    ("ess_rhat", dict(kind="rank", fold_impl="sort"), 2),
    ("ess_rhat", dict(kind="tail"), 1),
    ("ess_rhat", dict(kind="bulk"), 1),
    ("ess", dict(kind="median"), 1),
    ("mcse", dict(kind=mtt.Quantile(0.3)), 1),
], ids=lambda v: str(v))
def test_exact_calls_launch_k13_and_equal_the_plain_route(
        cuda_device, monkeypatch, fn, kw, launches):  # noqa: F811
    """The exact calls on the card sort through K13, and give what the same
    calls give with K13's plain version in its place, bit for bit."""
    from mcmcdiagnostictools_jl_tpu_torch.diagnostics import mcse as mcse_mod
    from mcmcdiagnostictools_jl_tpu_torch.kernels import radix_sort as k13
    from mcmcdiagnostictools_jl_tpu_torch.ops import ranknorm as rn

    x = torch.from_numpy(_ar1(8, (2000, 32, 64)).astype(np.float32))
    x[:, :, 3] = torch.round(x[:, :, 3])
    x[5, 2, 4] = -np.nan
    x = x.to(cuda_device)
    kernels.reset_launch_counts()
    got = getattr(mtt, fn)(x, **kw)
    assert kernels.launch_counts()["K13"] == launches
    monkeypatch.setattr(rn, "sort_rows", k13.sort_rows_plain)
    monkeypatch.setattr(rn, "sort_rows_keys",
                        lambda v: k13.sort_rows_plain(v)[0])
    monkeypatch.setattr(mcse_mod, "sort_rows_keys",
                        lambda v: k13.sort_rows_plain(v)[0])
    kernels.reset_launch_counts()
    want = getattr(mtt, fn)(x, **kw)
    assert kernels.launch_counts()["K13"] == 0
    for g, w in zip(got, want) if isinstance(got, tuple) else [(got, want)]:
        assert bool(torch.isnan(g[4]))
        _assert_equal_nan(g, w)


# ---- K14: the ring route's merge-count ----------------------------------------

_K14_TILE = 4096  # merged entries a block (kernels/mergecount.py's _TILE)
# (first, positions, earlier): the own block with and without positions, a
# ring-earlier and a ring-later visit with them, a visit of t alone
_K14_MODES = [(True, True, False), (True, False, False), (False, True, True),
              (False, True, False), (False, False, False)]


def _k14_rows(kind, p, n, seed):
    """Sorted float32 rows ``(p, n)`` (float order, ``-0.0`` beside
    ``+0.0``) holding what ``kind`` names."""
    rng = np.random.default_rng(seed + 11 * n + p)
    x = rng.standard_normal((p, n))
    if kind == "ties":  # runs of hundreds to thousands, across tile edges
        x = np.round(x * 2) / 2
    elif kind == "few":  # a handful of values, runs past many tiles
        x = np.round(x)
    elif kind == "one_value":
        x[:] = 0.5
    elif kind == "zeros_infs":
        x = np.round(x)
        x[x == 0] = np.where(rng.random((x == 0).sum()) < 0.5, -0.0, 0.0)
        x[:, ::7] = np.inf
        x[:, 1::11] = -np.inf
    elif kind == "below":
        x -= 100.0
    elif kind == "above":
        x += 100.0
    return torch.sort(torch.from_numpy(x.astype(np.float32)), dim=1,
                      stable=True).values


def _k14_both(a, b, first, pos, earlier, seed=3):
    """K14 and its plain version from the same accumulators: ``(got,
    want)``, each ``(t, gpos or None)``."""
    from mcmcdiagnostictools_jl_tpu_torch.kernels import mergecount as k14

    g = torch.Generator(device=a.device).manual_seed(seed)
    start = [torch.randint(0, 2**20, a.shape, generator=g, device=a.device,
                           dtype=torch.int32) for _ in range(2)]
    got = [s.clone() for s in start]
    want = [s.clone() for s in start]
    if not pos:
        got[1] = want[1] = None
    before = k14.merge_count.launches
    k14.merge_count(a, b, *got, first=first, earlier=earlier)
    assert k14.merge_count.launches == before + 1
    k14.merge_count_plain(a, b, *want, first=first, earlier=earlier)
    torch.cuda.synchronize()
    return got, want


def _k14_equal(got, want):
    return all((g is None and w is None) or torch.equal(g, w)
               for g, w in zip(got, want))


@pytest.mark.parametrize("shape", [
    (1, 1, 1), (2, 7, 3001), (4, 3001, 7), (3, 5000, 5000),
    (5, _K14_TILE, _K14_TILE), (3, _K14_TILE - 1, _K14_TILE + 1),
    (2, 3 * _K14_TILE + 5, 2 * _K14_TILE - 3), (3, 40_000, 40_000),
], ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kinds", [
    ("normal", "normal"), ("ties", "ties"), ("few", "few"),
    ("one_value", "one_value"), ("one_value", "ties"), ("ties", "one_value"),
    ("normal", "below"), ("normal", "above"), ("zeros_infs", "zeros_infs"),
], ids=lambda k: "-".join(k))
def test_k14_equals_its_plain_version(cuda_device, kinds, shape):  # noqa: F811
    """Every mode, bit for bit the plain version's integers: random rows,
    tie runs across tile edges, whole rows of one value, a visiting block
    wholly below or above, +-0.0 and +-inf; the own block's modes count
    ``a`` against itself."""
    p, n, m = shape
    a = _k14_rows(kinds[0], p, n, 1).to(cuda_device)
    b = _k14_rows(kinds[1], p, m, 2).to(cuda_device)
    for first, pos, earlier in _K14_MODES:
        got, want = _k14_both(a, a if first else b, first, pos, earlier)
        assert _k14_equal(got, want), (first, pos, earlier)


@pytest.mark.parametrize("first, pos, earlier", _K14_MODES)
def test_k14_nan_rows_stay_in_their_rows(cuda_device, first, pos,  # noqa: F811
                                         earlier):
    """Rows that hold NaNs (a sign-bit NaN first and NaNs last, as the
    card's sort puts them, in ``a``, in ``b`` or in both) beside clean rows:
    the clean rows' counts exact, and the accumulators' rows around them
    untouched (the block sits between two guard rows of one buffer)."""
    from mcmcdiagnostictools_jl_tpu_torch.kernels import mergecount as k14

    p, n, m = 6, 3 * _K14_TILE + 4, 2 * _K14_TILE + 9
    a = _k14_rows("ties", p, n, 4)
    b = a.clone() if first else _k14_rows("ties", p, m, 5)
    for r, where in ((1, a), (2, b), (3, a), (3, b)):
        where[r, 0] = -np.nan
        where[r, -40:] = np.nan
    a, b = a.to(cuda_device), b.to(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(9)
    bufs = [torch.randint(0, 2**20, (p + 2, n), generator=g, dtype=torch.int32,
                          device=cuda_device) for _ in range(2)]
    guards = [x.clone() for x in bufs]
    acc = [x[1:-1] for x in bufs]
    want = [x.clone() for x in acc]
    if not pos:
        acc[1] = want[1] = None
    assert acc[0].is_contiguous() and acc[0].data_ptr() % 16 == 0
    k14.merge_count(a, b, *acc, first=first, earlier=earlier)
    k14.merge_count_plain(a, b, *want, first=first, earlier=earlier)
    torch.cuda.synchronize()
    clean = [0, 4, 5]
    for got, w in zip(acc, want):
        if got is not None:
            assert torch.equal(got[clean], w[clean])
    for x, guard in zip(bufs, guards):
        assert torch.equal(x[0], guard[0]) and torch.equal(x[-1], guard[-1])


@pytest.mark.parametrize("kshards", [2, 3, 4])
def test_k14_every_ring_position_equals_the_searchsorted_counts(
        cuda_device, monkeypatch, kshards):  # noqa: F811
    """The ring's two accumulators through K14 at every position of a ring
    of ``kshards`` blocks on one card (each visiting block ring-earlier or
    later): ``t + 1`` the twice-rank ``2 cl + ce + 1`` and ``gpos`` the
    global positions that the route formed with ``torch.searchsorted``,
    and one K14 launch a counted block."""
    from mcmcdiagnostictools_jl_tpu_torch.parallel import ring_rank

    blocks = [torch.cat([_k14_rows("ties", 2, 5003, 20 + i),
                         _k14_rows("normal", 2, 5003, 30 + i)]).to(cuda_device)
              for i in range(kshards)]
    for index in range(kshards):
        xs = blocks[index]
        cl, ce, gpos = old_ring_counts(blocks, index)
        for positions in (True, False):
            steps = iter(range(1, kshards))
            monkeypatch.setattr(
                ring_rank, "ring_exchange",
                lambda buf, group, i, k, index=index, steps=steps:
                blocks[(index - next(steps)) % k])
            kernels.reset_launch_counts()
            t, got_gpos = ring_rank.ring_rank_counts(xs, None, index, kshards,
                                                     positions=positions)
            assert kernels.launch_counts()["K14"] == kshards
            assert t.dtype == torch.int32
            assert torch.equal(t.long() + 1, 2 * cl + ce + 1)
            if positions:
                assert torch.equal(got_gpos.long(), gpos)
            else:
                assert got_gpos is None


def test_k14_on_a_row_of_25m_entries(cuda_device):  # noqa: F811
    """A row of 25M entries (past 2^24) against another: the own block with
    positions and a ring-earlier visit, bit for bit the plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(25)
    a = torch.sort(torch.randn((1, 25_000_000), generator=g,
                               device=cuda_device), dim=1).values
    b = torch.sort(torch.randn((1, 25_000_000), generator=g,
                               device=cuda_device), dim=1).values
    for first, pos, earlier in [(True, True, False), (False, True, True)]:
        got, want = _k14_both(a, a if first else b, first, pos, earlier)
        assert _k14_equal(got, want)


def test_k14_float64_takes_the_plain_version(cuda_device):  # noqa: F811
    """float64 rows on the card launch nothing, and count what the float32
    rows they hold count through K14 (the same comparisons)."""
    from mcmcdiagnostictools_jl_tpu_torch.kernels import mergecount as k14

    a = _k14_rows("ties", 3, 5000, 6).to(cuda_device)
    b = _k14_rows("ties", 3, 4000, 7).to(cuda_device)
    for first, pos, earlier in _K14_MODES:
        got, _ = _k14_both(a, a if first else b, first, pos, earlier)
        g = torch.Generator(device=cuda_device).manual_seed(3)
        wide = [torch.randint(0, 2**20, a.shape, generator=g, dtype=torch.int32,
                              device=cuda_device) for _ in range(2)]
        if not pos:
            wide[1] = None
        before = k14.merge_count.launches
        k14.merge_count(a.double(), (a if first else b).double(), *wide,
                        first=first, earlier=earlier)
        assert k14.merge_count.launches == before
        assert _k14_equal(got, wide)


def test_k14_launches_by_name(cuda_device):  # noqa: F811
    """What ``k14_roofline`` reads by name: a call launches one
    ``merge_count_partition`` and one ``merge_count_kernel<kFirst, kPos>``
    of its mode."""
    from torch.profiler import ProfilerActivity, profile

    from mcmcdiagnostictools_jl_tpu_torch.kernels import mergecount as k14

    a = _k14_rows("normal", 4, 9000, 8).to(cuda_device)
    b = _k14_rows("normal", 4, 9000, 9).to(cuda_device)
    t = torch.zeros(a.shape, dtype=torch.int32, device=cuda_device)
    gpos = torch.zeros_like(t)
    for first, pos, earlier in _K14_MODES:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            k14.merge_count(a, a if first else b, t, gpos if pos else None,
                            first=first, earlier=earlier)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type.name == "CUDA" and "merge_count" in e.name]
        want = (f"merge_count_kernel<{str(first).lower()}, "
                f"{str(pos).lower()}>")
        assert len(names) == 2, names
        assert sum("merge_count_partition" in nm for nm in names) == 1
        assert sum(want in nm for nm in names) == 1, names


def test_k14_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):  # noqa: F811
    from mcmcdiagnostictools_jl_tpu_torch.kernels import mergecount as k14

    a = _k14_rows("normal", 4, 64, 1).to(cuda_device)
    t = torch.zeros((4, 64), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):  # off a 16-byte boundary
        k14.merge_count(a.reshape(-1)[1:].reshape(-1)[:252].view(4, 63),
                        a, t[:, :63].contiguous())
    with pytest.raises(ValueError):  # rows of b that do not match
        k14.merge_count(a, a[:3], t)
    with pytest.raises(ValueError):  # accumulators of another shape
        k14.merge_count(a, a, t[:, :32].contiguous())
    with pytest.raises(NotImplementedError):
        k14.merge_count(a.half(), a.half(), t)


# ---- K15: the ring route's Blom scores from its counts -----------------------

# rows of the chain group: a few entries, past K15's vectors, just below and
# at 2^24 (where the float32 quotient's top score turned +inf) and the
# sharded cell's 25M
_K15_SHORT_N = [1, 2, 3, 5, 1000, 65_537]
_K15_LONG_N = [2**24 - 1, 2**24, 25_000_000]


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _k15_both(t, n):
    """K15's scores of the int32 counts ``t`` (a copy, which it consumes)
    and the plain version's, ``blom_scores(t + 1, n)``."""
    want = k12.blom_scores(t + 1, n, torch.float32)
    got = k12.blom_from_counts(t.clone(), n)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("n", _K15_SHORT_N)
def test_k15_every_count_of_a_short_row(cuda_device, n):  # noqa: F811
    """Every count t from 0 to 2n (both halves and the k = n / n + 1 edge
    between them) bit for bit the plain version's, whole and in pieces of
    1-15 entries from either end (1-7 past a multiple of 4: the scalar
    tail)."""
    t = torch.arange(2 * n + 1, dtype=torch.int32, device=cuda_device)
    got, want = _k15_both(t, n)
    assert _same_bits(got, want)
    for length in range(1, min(16, t.numel() + 1)):
        for part in (t[:length], t[-length:]):
            assert _same_bits(*_k15_both(part, n)), length


@pytest.mark.parametrize("n", _K15_LONG_N)
def test_k15_on_long_rows(cuda_device, n):  # noqa: F811
    """Counts at both ends and around the middle of a row of the chain
    group of ``n`` entries, and random counts in rows ``(3, 4m + 3)``: bit
    for bit the plain version's, every score finite (the top one too) and
    the ends the mirror of each other."""
    g = torch.Generator(device=cuda_device).manual_seed(n)
    ends = torch.cat([torch.arange(4099), torch.arange(n - 4099, n + 4099),
                      torch.arange(2 * n - 4098, 2 * n + 1)])
    rand = torch.randint(0, 2 * n + 1, (3, 400_003), generator=g,
                         dtype=torch.int32, device=cuda_device)
    for t in (ends.to(torch.int32).to(cuda_device), rand):
        got, want = _k15_both(t, n)
        assert _same_bits(got, want)
        assert bool(torch.isfinite(got).all())
    z, _ = _k15_both(ends.to(torch.int32).to(cuda_device), n)
    assert torch.equal(z[:4099], -z.flip(0)[:4099])
    assert float(z[-2]) > 5  # t = 2n - 1: the top element, k = 2n


def test_k15_counts_one_launch_a_call(cuda_device):  # noqa: F811
    """``launch_counts()["K15"]``: one a wrapper call, one a call of the
    ring's ``rank_normal_from_counts`` on int32 counts into float32, and
    one ``blom_counts_kernel`` on the device a call (what ``k15_roofline``
    reads by name)."""
    from torch.profiler import ProfilerActivity, profile

    from mcmcdiagnostictools_jl_tpu_torch.parallel import ring_rank

    n = 100_000
    t = torch.arange(1, 2 * n, 3, dtype=torch.int32, device=cuda_device)
    kernels.reset_launch_counts()
    k12.blom_from_counts(t.clone(), n)
    assert kernels.launch_counts()["K15"] == 1
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        z = ring_rank.rank_normal_from_counts(t.clone(), n, torch.float32)
        torch.cuda.synchronize()
    assert kernels.launch_counts()["K15"] == 2
    names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    assert sum("blom_counts_kernel" in nm for nm in names) == 1, names
    assert _same_bits(z, k12.blom_scores(t + 1, n, torch.float32))


def test_k15_int64_and_float64_take_the_plain_version(cuda_device):  # noqa: F811
    """int64 counts (rows of 2^30 entries and more, or where K14 cannot
    count) and float64 scores launch nothing and give the plain scores:
    the int64 counts' float32 scores bit for bit K15's."""
    from mcmcdiagnostictools_jl_tpu_torch.parallel import ring_rank

    n = 300_001
    g = torch.Generator(device=cuda_device).manual_seed(15)
    t = torch.randint(0, 2 * n + 1, (2, 5001), generator=g, dtype=torch.int32,
                      device=cuda_device)
    kernels.reset_launch_counts()
    z64 = ring_rank.rank_normal_from_counts(t.long(), n, torch.float32)
    zd = ring_rank.rank_normal_from_counts(t.clone(), n, torch.float64)
    assert kernels.launch_counts()["K15"] == 0
    assert zd.dtype == torch.float64
    assert torch.equal(zd, k12.blom_scores(t + 1, n, torch.float64))
    assert _same_bits(z64, k12.blom_from_counts(t.clone(), n))
    assert kernels.launch_counts()["K15"] == 1


def test_k15_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):  # noqa: F811
    t = torch.arange(64, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):  # off a 16-byte boundary
        k12.blom_from_counts(t[1:], 1000)
    with pytest.raises(ValueError):  # not contiguous
        k12.blom_from_counts(t.view(8, 8).t(), 1000)
    with pytest.raises(ValueError):  # int64 counts
        k12.blom_from_counts(t.long(), 1000)
    with pytest.raises(ValueError):  # a twice-rank past int32
        k12.blom_from_counts(t, 2**30)


def test_one_card_calls_launch_no_k15(cuda_device):  # noqa: F811
    """The one-card exact and fast ``ess_rhat`` and ``rhat_nested`` form
    their scores in K12 and K4 or its glue: K15 never launches."""
    x = t(_ar1(33, (1000, 8, 16))).to(torch.float32).to(cuda_device)
    ids = np.repeat(np.arange(4), 2)
    for fn in (lambda: mtt.ess_rhat(x, kind="rank"),
               lambda: mtt.ess_rhat(x, kind="rank", rank_mode="fast"),
               lambda: mtt.rhat_nested(x, ids)):
        kernels.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        assert kernels.launch_counts()["K15"] == 0
