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
K3's counts are exact and its frac sums are float32 atomics in another order
(within 1e-4 of the bin count); K1 and K5 sum in another float32 order (2e-5
abs at unit variance, min/max equal, K5's lags at or beyond niter exactly
0); the whole slice on the card tracks the plain CPU path to 1e-3 relative
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
from mcmcdiagnostictools_jl_tpu_torch.diagnostics.mcse import _beta_interval_ranks
from mcmcdiagnostictools_jl_tpu_torch.kernels import autocov as k5
from mcmcdiagnostictools_jl_tpu_torch.kernels import fastrank as kfr
from mcmcdiagnostictools_jl_tpu_torch.kernels import moments_autocov as k1
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


@pytest.mark.parametrize("maxlag", [10, 64, 100, 250, 300])
def test_k1_matches_plain(cuda_device, maxlag):  # noqa: F811
    x = _ar1(0, (1001, 8, 40))
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


@pytest.mark.parametrize("niter,nchains,nparams,maxlag", [
    (1001, 8, 40, 0), (1001, 8, 40, 10), (1001, 8, 40, 100),
    (1001, 8, 40, 250), (1001, 8, 40, 300), (300, 3, 7, 303),
    (7, 5, 3, 12), (1, 2, 3, 4),
])
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


def test_k5_matches_k1_acov(cuda_device):  # noqa: F811
    """The same estimator: K5 on the series centered with K1's means."""
    x = t(_ar1(4, (1000, 6, 50)), torch.float32).to(cuda_device)
    mean, _, _, _, acov = k1.moments_autocov(x, 250)
    assert_close(k5.direct_autocov((x - mean).contiguous(), 250), acov,
                 rtol=0, atol=2e-5)


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


@pytest.mark.parametrize("n,p,nbins", [(50001, 37, 4096), (4096, 7, 256)])
def test_fast_kernels_match_plain(cuda_device, n, p, nbins):  # noqa: F811
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n, p)).astype(np.float32)
    x[:, 1] = np.round(x[:, 1] * 2) / 2
    x[:, 2] = 1.25
    x[7, 3] = np.nan
    x[:, 4] = np.nan
    x[3, 5] = np.inf
    x = t(x).to(cuda_device)
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
        k1.moments_autocov(x[:8].double().reshape(8, 2, 4), 2)
    with pytest.raises(ValueError):
        k5.direct_autocov(x.reshape(64, 2, 4).transpose(1, 2), 3)
    with pytest.raises(NotImplementedError):
        k5.direct_autocov(x.double().reshape(64, 2, 4), 3)


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


def test_cuda_float64_tensor_raises(cuda_device):  # noqa: F811
    x = torch.zeros((20, 2, 2), dtype=torch.float64, device=cuda_device)
    with pytest.raises(NotImplementedError, match="float32"):
        mtt.ess_rhat(x)
    for fn in (mtt.mcse, mtt.ess, lambda v: mtt.rhat_nested(v, [0, 1]),
               lambda v: mtt.bfmi(v[:, :, 0]), mtt.gelmandiag,
               mtt.gelmandiag_multivariate, mtt.gewekediag, mtt.heideldiag,
               mtt.rafterydiag, lambda v: mtt.gewekediag(v[:, 0, 0]),
               lambda v: mtt.heideldiag(v[:, 0, 0])):
        with pytest.raises(NotImplementedError, match="float32"):
            fn(x)
