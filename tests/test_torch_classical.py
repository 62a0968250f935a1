"""The classical suite of the port (Gelman PSRF, Geweke, Heidelberger-Welch,
Raftery-Lewis), its batched scans and the functions under them, against the
JAX package at float64 on the CPU.

The Gelman functions are also held to ``tests/ref_impl.py``'s oracle.

Tolerance: BASELINE.md's parity bound, 1e-6 relative
(``torch_parity.PARITY_F64``), for every result; integers, flags and
Raftery's run lengths exactly. The JAX package's scalar Heidelberger path
evaluates ``pcramer`` of a Python float in float32 (its p-values differ
from the port's float64 ones by ~4e-8 relative), inside the bound.

Raftery on a sample above 2^24 elements is not run here; its quantile
helper ``quantile_f64`` is held to ``np.quantile`` bit for bit instead. The card:
tests/test_torch_cuda.py.
"""

import math
import warnings

import numpy as np
import pytest
import torch

import mcmcdiagnostictools_jl_tpu as mdt
import mcmcdiagnostictools_jl_tpu_torch as mtt
import ref_impl
from conftest import ar1
from mcmcdiagnostictools_jl_tpu.ops import geyer as jgeyer
from mcmcdiagnostictools_jl_tpu.ops import special as jspecial
from mcmcdiagnostictools_jl_tpu_torch.convert import to_numpy
from mcmcdiagnostictools_jl_tpu_torch.diagnostics.batch import (
    _heidel_starts,
    _heidel_windows,
    _masked_window_stack,
    _window_mcse_mean,
    quantile_f64,
)
from mcmcdiagnostictools_jl_tpu_torch.kernels.autocov import direct_autocov
from mcmcdiagnostictools_jl_tpu_torch.ops import geyer, special
from torch_parity import PARITY_F64, assert_close, t


@pytest.fixture
def chains(rng):
    """AR(1) chains (600, 3, 2) with a transient in one series."""
    x = ar1(rng, 0.5, 1.0, (600, 3, 2))
    x[:150, 0, 0] += 3.0
    return x


def _shaped(x, ndim):
    """1-d: one series; 2-d: (draws, chains); 3-d as is; 4-d: params (2, 1)."""
    return {1: x[:, 1, 0], 2: x[:, :, 0], 3: x, 4: x[..., None]}[ndim]


def assert_result(port, ref, ndim):
    """Field by field within the parity bound; 1-d results as Python scalars,
    N-d ones as tensors shaped like the reference's arrays."""
    assert port._fields == ref._fields
    for name, p, r in zip(ref._fields, port, ref):
        if ndim == 1:
            assert isinstance(p, (bool, int, float)), (name, type(p))
        else:
            assert isinstance(p, torch.Tensor), name
            assert tuple(p.shape) == np.shape(r), name
        pv, rv = np.asarray(to_numpy(p)), np.asarray(r)
        if pv.dtype == bool or rv.dtype == bool:
            np.testing.assert_array_equal(pv, rv, err_msg=name)
        else:
            np.testing.assert_allclose(pv.astype(float), rv.astype(float),
                                       equal_nan=True, err_msg=name,
                                       **PARITY_F64)


# ---- ops: dynamic Geyer, special functions ----------------------------------


def _rho_curves():
    """Decaying curves with sign noise, one NaN past its break and one at
    its breaking even lag."""
    lags = np.arange(251)[:, None]
    rho = 0.9 ** lags * np.cos(0.3 * lags * (1 + np.arange(6)[None, :]))
    rho[0] = 1.0
    rho[40:42, 4] = -0.5
    rho[200, 4] = np.nan
    rho[40, 5] = np.nan
    return rho


@pytest.mark.parametrize("eff", [250, 249, 101, 37, 8, 5, 3, 2, 1])
def test_dynamic_geyer_matches_jax_and_static(eff):
    rho = _rho_curves()
    got = geyer.geyer_ess_from_rho_dynamic(t(rho), 4000, eff)
    assert_close(got, jgeyer.geyer_ess_from_rho_dynamic(rho, 4000, eff),
                 equal_nan=True, **PARITY_F64)
    static = geyer.geyer_ess_from_rho(t(rho[: eff + 1]), 4000)
    assert_close(got, static, equal_nan=True, rtol=1e-12, atol=0)


def test_dynamic_geyer_per_column_lengths():
    rho = _rho_curves()
    eff = np.array([250, 101, 37, 8, 3, 2])
    ntotal = np.array([4000.0, 300, 50, 20, 9, 7])
    got = geyer.geyer_ess_from_rho_dynamic(t(rho), t(ntotal), t(eff))
    assert_close(got, jgeyer.geyer_ess_from_rho_dynamic(rho, ntotal, eff),
                 equal_nan=True, **PARITY_F64)
    for j in range(6):
        static = geyer.geyer_ess_from_rho(t(rho[: eff[j] + 1, j:j + 1]),
                                          int(ntotal[j]))
        assert_close(got[j:j + 1], static, equal_nan=True, rtol=1e-12, atol=0)
    rel = geyer.geyer_ess_from_rho_dynamic(t(rho), t(ntotal), t(eff),
                                           relative=True)
    assert_close(rel * t(ntotal), got, equal_nan=True, rtol=1e-15, atol=0)


def test_special_functions_match_jax():
    x = np.geomspace(1e-6, 700, 60)
    assert_close(special.besselk_quarter(t(x)), jspecial.besselk_quarter(x),
                 **PARITY_F64)
    assert torch.isnan(special.besselk_quarter(t(np.array([0.0, -1.0])))).all()
    q = np.geomspace(0.01, 3.0, 40)
    assert_close(special.pcramer(t(q)), jspecial.pcramer(q), **PARITY_F64)
    d2 = np.array([3.0, 10.5, 40.0, 250.0, 4e3])
    for d1, p in ((1.0, 0.975), (3.0, 0.5), (7.0, 0.9)):
        assert_close(special.fdist_quantile(d1, t(d2), p),
                     jspecial.fdist_quantile(np.full_like(d2, d1), d2, p),
                     **PARITY_F64)


def test_window_mcse_equals_full_series_mcse(rng):
    """A (0, n) window is the plain single-chain mean-MCSE; a shorter one
    equals the MCSE of the sliced window."""
    x = ar1(rng, 0.6, 1.0, (800, 3))
    s, m, _ = _window_mcse_mean(t(x), [(0, 800), (100, 530)])
    assert_close(s[0], mtt.mcse(t(x[:, None, :]), split_chains=1, device="cpu"), **PARITY_F64)
    assert_close(s[1], mtt.mcse(t(x[100:530, None, :]), split_chains=1, device="cpu"),
                 **PARITY_F64)
    assert_close(m, np.stack([x.mean(0), x[100:530].mean(0)]), **PARITY_F64)


# ---- Gelman -----------------------------------------------------------------


@pytest.mark.parametrize("ndim", [3, 4])
def test_gelman_matches_jax(chains, ndim):
    x = _shaped(chains, ndim)
    assert_result(mtt.gelmandiag(x, device="cpu"), mdt.gelmandiag(x), ndim)
    got = mtt.gelmandiag_multivariate(x, device="cpu")
    want = mdt.gelmandiag_multivariate(x)
    assert isinstance(got.psrfmultivariate, float)
    for g, w in zip(got[:2], want[:2]):
        assert_close(g, w, **PARITY_F64)
    assert_close(got.psrfmultivariate, want.psrfmultivariate, **PARITY_F64)
    assert float(got.psrf.reshape(-1)[0]) > 1.05  # the transient is flagged


@pytest.mark.parametrize("shape,phi,alpha", [
    ((600, 4, 5), 0.3, 0.05), ((250, 3, 2), 0.7, 0.2), ((1000, 6, 3), 0.0, 0.05)])
def test_gelman_matches_the_oracle(rng, shape, phi, alpha):
    """The port against ``tests/ref_impl.py``'s literal Brooks-Gelman PSRF
    (an oracle that shares no code with either package), float64 within 1e-6."""
    x = ref_impl.ar1_matrix(rng, phi, 1.0, shape)
    x[: shape[0] // 4, 0, 0] += 2.0  # a transient: one PSRF well above 1
    want_psrf, want_ci, _, _ = ref_impl.gelmandiag(x, alpha)
    got = mtt.gelmandiag(x, alpha=alpha, device="cpu")
    assert got.psrf.dtype == torch.float64
    assert_close(got.psrf, want_psrf, **PARITY_F64)
    assert_close(got.psrfci, want_ci, **PARITY_F64)
    assert float(got.psrf[0]) > 1.02


@pytest.mark.parametrize("shape,phi", [((600, 4, 5), 0.3), ((250, 3, 2), 0.7)])
def test_gelman_multivariate_matches_the_oracle(rng, shape, phi):
    x = ref_impl.ar1_matrix(rng, phi, 1.0, shape)
    want_psrf, want_ci, want_mv = ref_impl.gelman_multivariate(x)
    got = mtt.gelmandiag_multivariate(x, device="cpu")
    assert_close(got.psrf, want_psrf, **PARITY_F64)
    assert_close(got.psrfci, want_ci, **PARITY_F64)
    assert_close(got.psrfmultivariate, want_mv, **PARITY_F64)


def test_gelman_alpha_and_tensor_input(chains):
    got = mtt.gelmandiag(t(chains), alpha=0.2, device="cpu")
    assert isinstance(got.psrf, torch.Tensor)
    assert_result(got, mdt.gelmandiag(chains, alpha=0.2), 3)


def test_gelman_errors(rng):
    with pytest.raises(ValueError, match="2 chains"):
        mtt.gelmandiag(rng.standard_normal((100, 1, 3)), device="cpu")
    with pytest.raises(ValueError, match="2 chains"):
        mtt.gelmandiag_multivariate(rng.standard_normal((100, 1, 3)), device="cpu")
    with pytest.raises(ValueError, match="two variables"):
        mtt.gelmandiag_multivariate(rng.standard_normal((100, 4, 1)), device="cpu")
    with pytest.raises(ValueError):
        mtt.gelmandiag(rng.standard_normal((100, 4)), device="cpu")  # not 3-d


# ---- Geweke -----------------------------------------------------------------


@pytest.mark.parametrize("ndim", [1, 2, 3, 4])
def test_geweke_matches_jax(chains, ndim):
    x = _shaped(chains, ndim)
    assert_result(mtt.gewekediag(x, device="cpu"), mdt.gewekediag(x), ndim)


@pytest.mark.parametrize("ndim", [1, 3])
@pytest.mark.parametrize("kw", [
    dict(first=0.2, last=0.4, maxlag=30),  # masked windows, maxlag forwarded
    dict(autocov_method="fft"),  # any other MCSE keyword: per-window mcse
    dict(first=0.005),  # a first window of 3 draws: per-window mcse
])
def test_geweke_kwargs_match_jax(chains, ndim, kw):
    x = _shaped(chains, ndim)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the 3-draw window's short-chain warning
        assert_result(mtt.gewekediag(x, **kw, device="cpu"), mdt.gewekediag(x, **kw), ndim)


@pytest.mark.parametrize("kw", [dict(first=0.0), dict(last=1.0),
                                dict(first=0.6, last=0.5)])
def test_geweke_errors(rng, kw):
    with pytest.raises(ValueError):
        mtt.gewekediag(rng.standard_normal(100), **kw, device="cpu")
    with pytest.raises(ValueError):
        mtt.gewekediag(rng.standard_normal((100, 2, 2)), **kw, device="cpu")


# ---- Heidelberger-Welch -----------------------------------------------------


@pytest.mark.parametrize("ndim", [1, 2, 3, 4])
def test_heidel_matches_jax(chains, ndim):
    x = _shaped(chains, ndim) + 2.0
    assert_result(mtt.heideldiag(x, device="cpu"), mdt.heideldiag(x), ndim)


@pytest.mark.parametrize("ndim", [1, 3])
@pytest.mark.parametrize("kw", [dict(maxlag=30, start=101, eps=0.3),
                                dict(autocov_method="fft", alpha=0.2)])
def test_heidel_kwargs_match_jax(chains, ndim, kw):
    x = _shaped(chains, ndim) + 2.0
    assert_result(mtt.heideldiag(x, **kw, device="cpu"), mdt.heideldiag(x, **kw), ndim)


def test_masked_window_stack_lag_sums(rng):
    """The stack of the Heidelberger scan's windows: each column block's lag
    sums are its window's own (numpy, float64), zero past the window."""
    x = ar1(rng, 0.6, 1.0, (230, 3))
    windows = _heidel_windows(230, _heidel_starts(230)[0])
    assert windows == [(114, 230), (0, 230), (23, 230), (46, 230),
                       (69, 230), (92, 230)]
    z, mean = _masked_window_stack(t(x), windows)
    assert z.shape == (230, 1, 18) and z.is_contiguous()
    c = direct_autocov(z, 120)[:, 0] * 230
    for w, (a, b) in enumerate(windows):
        y = x[a:b] - x[a:b].mean(0)
        want = np.stack([(y[: b - a - k] * y[k:]).sum(0) if k < b - a
                         else np.zeros(3) for k in range(121)])
        assert_close(c[:, 3 * w:3 * w + 3], want, rtol=1e-12, atol=1e-12)
        assert_close(mean[w], x[a:b].mean(0), rtol=1e-14, atol=0)


def test_heidel_needs_ten_draws():
    """With fewer than 10 draws the scan step int(n/10) is 0: the reference
    loops forever, the port raises."""
    with pytest.raises(ValueError, match="10 draws"):
        mtt.heideldiag(np.arange(9.0), device="cpu")
    with pytest.raises(ValueError, match="10 draws"):
        mtt.heideldiag(np.ones((9, 2)), device="cpu")


# ---- Raftery-Lewis ----------------------------------------------------------


@pytest.fixture
def long_chains(rng):
    return ar1(rng, 0.8, 1.0, (8000, 2, 2))


@pytest.mark.parametrize("ndim", [1, 2, 3, 4])
def test_raftery_matches_jax(long_chains, ndim):
    x = _shaped(long_chains, ndim)
    got = mtt.rafterydiag(x, device="cpu")
    want = mdt.rafterydiag(x)
    assert_result(got, want, ndim)
    if ndim == 1:
        assert all(isinstance(v, int) for v in got[:4])
    else:
        assert got.nmin.dtype == torch.int64
        assert got.thinning.dtype == torch.float64


@pytest.mark.parametrize("kw", [dict(q=0.5, r=0.0125, range_step=3, range_start=11),
                                dict(q=0.975, s=0.9, eps=0.01)])
def test_raftery_kwargs_match_jax(long_chains, kw):
    for ndim in (1, 3):
        x = _shaped(long_chains, ndim)
        assert_result(mtt.rafterydiag(x, **kw, device="cpu"), mdt.rafterydiag(x, **kw), ndim)


def test_raftery_too_few_draws_warns(rng):
    x = rng.standard_normal((100, 2, 3))
    with pytest.warns(UserWarning, match="samples are needed"):
        got = mtt.rafterydiag(x, device="cpu")
    with pytest.warns(UserWarning, match="samples are needed"):
        want = mdt.rafterydiag(x)
    assert_result(got, want, 3)
    with pytest.warns(UserWarning, match="samples are needed"):
        one = mtt.rafterydiag(x[:, 0, 0], device="cpu")
    assert one.thinning == -1 and one.nmin == 3746
    assert all(math.isnan(v) for v in (one.burnin, one.total,
                                       one.dependencefactor))


def test_raftery_ties_and_nan(rng):
    """Heavy ties put draws on the threshold itself (the float64 comparison
    decides), and a NaN series follows numpy's NaN quantile."""
    x = np.round(ar1(rng, 0.5, 1.0, (6000, 2, 3)) * 4) / 4
    x[10, 1, 2] = np.nan
    assert_result(mtt.rafterydiag(x, device="cpu"), mdt.rafterydiag(x), 3)


@pytest.mark.parametrize("q", [0.025, 0.5, 0.975, 0.3337, 0.0, 1.0])
@pytest.mark.parametrize("n", [1, 2, 7, 1001])
def test_quantile_matches_numpy(rng, q, n):
    """Both sides of the partial sort, ties, and a NaN column, bit for bit."""
    x = rng.standard_normal((n, 5)).astype(np.float32)
    x[:, 1] = np.round(x[:, 1])  # ties
    x[0, 4] = np.nan
    got = quantile_f64(t(x), q)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(),
                                  np.quantile(x.astype(np.float64), q, axis=0))
