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
ULP). Float32 matrix products run in full float32:
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
from mcmcdiagnostictools_jl_tpu_torch.kernels import autocov as k5
from mcmcdiagnostictools_jl_tpu_torch.benchmarks import micro_lagloop, sort_microbench
from mcmcdiagnostictools_jl_tpu_torch.kernels import fastrank as kfr
from mcmcdiagnostictools_jl_tpu_torch.kernels import lagloop_study as k6
from mcmcdiagnostictools_jl_tpu_torch.kernels import moments_autocov as k1
from mcmcdiagnostictools_jl_tpu_torch.kernels import sort_study as k789
from mcmcdiagnostictools_jl_tpu_torch.ops import fastrank as fr
from mcmcdiagnostictools_jl_tpu_torch.ops.fastrank import _hist_scale
from torch_parity import assert_close, cuda_device, t  # noqa: F401  (fixture)

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
    mtt.AutocovMethod(), "direct", mtt.DirectKernelAutocovMethod()])
def test_direct_autocov_methods_launch_k5(cuda_device, method):  # noqa: F811
    """Every name of the direct estimator runs K5 on a card tensor, never its
    plain version."""
    x = torch.from_numpy(_ar1(7, (600, 8, 6)).astype(np.float32))
    before = k5.direct_autocov.launches
    g = mtt.ess(x.to(cuda_device), kind="basic", autocov_method=method)
    assert k5.direct_autocov.launches > before
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
