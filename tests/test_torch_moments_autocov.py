"""Kernel K1's module and the basic-kind ops of the port against the JAX
package at float64 (tolerance: BASELINE.md's 1e-6 relative parity bound).

The plain version of K1 is held against the Pallas kernel in interpret mode
and against ``chain_stats`` + the direct autocovariance; the CUDA kernel is
held against the plain version in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from conftest import ar1
from mcmcdiagnostictools_jl_tpu.ops import autocov as jautocov
from mcmcdiagnostictools_jl_tpu.ops import moments as jmoments
from mcmcdiagnostictools_jl_tpu.ops.geyer import geyer_ess_from_rho as jgeyer
from mcmcdiagnostictools_jl_tpu.ops.pallas.fused_basic_kernel import (
    pallas_moments_autocov,
)
from mcmcdiagnostictools_jl_tpu_torch.kernels import moments_autocov as k1
from mcmcdiagnostictools_jl_tpu_torch.ops import autocov, moments
from mcmcdiagnostictools_jl_tpu_torch.ops.geyer import geyer_ess_from_rho
from torch_parity import assert_close, t


def _with_edge_series(x):
    """A constant series and a NaN series among the ordinary ones."""
    x = x.copy()
    x[:, 0, 1] = 0.75
    x[5, 1, 2] = np.nan
    return x


@pytest.mark.parametrize("shape", [(60, 4, 3), (317, 3, 5)])
def test_chain_stats_matches_jax(rng, shape):
    x = ar1(rng, 0.6, 1.0, shape)
    x[:, :, 0] = 2.5  # degenerate slice -> NaN var_plus
    got = moments.chain_stats(t(x))
    want = jmoments.chain_stats(x)
    for g, w in zip(got, want):
        assert_close(g, w, rtol=1e-6, atol=1e-12, equal_nan=True)
    assert bool(got.degenerate[0]) and np.isnan(got.rhat[0].item())


def test_single_chain_drops_between_term(rng):
    x = rng.standard_normal((50, 1, 2))
    got = moments.chain_stats(t(x))
    want = jmoments.chain_stats(x)
    assert_close(got.var_plus, want.var_plus)


@pytest.mark.parametrize("shape,maxlag", [((60, 4, 3), 19), ((317, 3, 5), 100)])
def test_plain_k1_matches_pallas_interpret(rng, shape, maxlag):
    x = _with_edge_series(ar1(rng, 0.6, 1.0, shape))
    got = k1.moments_autocov_plain(t(x), maxlag)
    want = pallas_moments_autocov(x, maxlag, interpret=True)
    for g, w in zip(got, want):
        assert_close(g, w, rtol=1e-6, atol=1e-12, equal_nan=True)
    # min/max propagate NaN, as jnp.min/jnp.max do
    assert np.isnan(got[2][1, 2].item()) and np.isnan(got[3][1, 2].item())


@pytest.mark.parametrize("maxlag", [10, 64, 250])
def test_fused_stats_autocov_matches_chain_stats_and_direct(rng, maxlag):
    x = ar1(rng, 0.5, 1.0, (300, 4, 3))
    stats, curve = moments.fused_chain_stats_autocov(t(x), maxlag)
    ref = jmoments.chain_stats(x)
    centered = x - np.asarray(ref.chain_mean)[None]
    want = jautocov.mean_autocov_curve(centered, ref.chain_var, maxlag, "direct")
    assert_close(curve, want)
    for g, w in zip(stats, ref):
        assert_close(g, w)


def test_wrapper_runs_plain_version_for_cpu_tensors(rng):
    x = t(rng.standard_normal((40, 2, 3)))
    before = k1.moments_autocov.launches
    for g, w in zip(k1.moments_autocov(x, 8), k1.moments_autocov_plain(x, 8)):
        assert torch.equal(g, w)
    assert k1.moments_autocov.launches == before  # no kernel launch on CPU


@pytest.mark.parametrize("method", ["fft", "direct", "bda"])
@pytest.mark.parametrize("maxlag", [1, 37, 250])
def test_autocov_methods_match_jax(rng, method, maxlag):
    x = ar1(rng, 0.7, 1.0, (301, 3, 4))
    x[:, 0, 0] = 1.0  # a constant chain: c_0 = 0 guard of the fft method
    ref = jmoments.chain_stats(x)
    centered = x - np.asarray(ref.chain_mean)[None]
    got = autocov.mean_autocov_curve(t(centered), t(np.asarray(ref.chain_var)),
                                     maxlag, method)
    want = jautocov.mean_autocov_curve(centered, ref.chain_var, maxlag, method)
    assert_close(got, want, rtol=1e-6, atol=1e-10)


def test_autocov_callable_seam_and_unknown_method(rng):
    c = t(rng.standard_normal((20, 2, 3)))
    v = c.var(0)
    got = autocov.mean_autocov_curve(c, v, 4, lambda cc, vv, L: cc[: L + 1].mean(1))
    assert tuple(got.shape) == (5, 3)
    with pytest.raises(ValueError, match="unknown autocov method"):
        autocov.mean_autocov_curve(c, v, 4, "no_such_method")
    # the JAX package's names of its Pallas lag kernel are the direct one
    for name in ("pallas", "pallas_interpret"):
        assert torch.equal(autocov.mean_autocov_curve(c, v, 4, name),
                           autocov.mean_autocov_curve(c, v, 4, "direct"))


@pytest.mark.parametrize("n", [1, 2, 7, 100, 1000, 2049])
def test_next_fft_size_matches_jax(n):
    assert autocov.next_fft_size(n) == jautocov.next_fft_size(n)


@pytest.mark.parametrize("maxlag", [1, 2, 3, 4, 9, 64])
@pytest.mark.parametrize("relative", [False, True])
def test_geyer_matches_jax(rng, maxlag, relative):
    """Random curves: breaking and non-breaking walks, a NaN pair, a NaN
    lag-1 value, and an all-positive curve."""
    rho = np.concatenate([np.ones((1, 6)), rng.uniform(-0.3, 0.9, (maxlag, 6))])
    rho[1:, 0] = np.linspace(0.9, 0.05, maxlag)  # never breaks
    if maxlag >= 5:
        rho[4, 1] = np.nan  # NaN pair
    rho[1, 2] = np.nan  # poisons the always-summed pair
    got = geyer_ess_from_rho(t(rho), 4000, relative)
    want = jgeyer(rho, 4000, relative)
    assert_close(got, want, rtol=1e-6, atol=1e-12, equal_nan=True)


def test_geyer_rejects_lag_zero():
    with pytest.raises(ValueError):
        geyer_ess_from_rho(torch.ones(1, 2), 10)
