"""The port's CUDA kernels on the card (``cuda`` marker; skipped without a
CUDA device).

This file imports neither JAX nor ``conftest.py``, so it also runs where only
PyTorch is installed:

    python -m pytest -o addopts="" --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances: K2 and K4 round exactly like their plain versions (equal);
K3's counts are exact and its frac sums are float32 atomics in another order
(within 1e-4 of the bin count); K1 sums in another float32 order (2e-5 abs
at unit variance, min/max equal); the whole slice on the card tracks the
plain CPU path to 1e-3 relative ESS and 1e-4 absolute R-hat.
"""

import numpy as np
import pytest
import torch

import mcmcdiagnostictools_jl_tpu_torch as mtt
from mcmcdiagnostictools_jl_tpu_torch.kernels import fastrank as kfr
from mcmcdiagnostictools_jl_tpu_torch.kernels import moments_autocov as k1
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


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_slice_on_card_matches_cpu(cuda_device, mode):  # noqa: F811
    x = torch.from_numpy(_ar1(2, (2000, 32, 64)).astype(np.float32))
    g = mtt.ess_rhat(x.to(cuda_device), rank_mode=mode)
    c = mtt.ess_rhat(x, rank_mode=mode)
    assert g.ess.device.type == "cuda"
    assert_close(g.ess.cpu(), c.ess, rtol=1e-3, atol=0)
    assert_close(g.rhat.cpu(), c.rhat, rtol=0, atol=1e-4)


def test_cuda_float64_tensor_raises(cuda_device):  # noqa: F811
    x = torch.zeros((20, 2, 2), dtype=torch.float64, device=cuda_device)
    with pytest.raises(NotImplementedError, match="float32"):
        mtt.ess_rhat(x)
