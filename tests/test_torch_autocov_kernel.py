"""Kernel K5 (direct autocovariance of centered series) and the
``DirectKernelAutocovMethod`` marker against the JAX package at float64
(tolerance: BASELINE.md's 1e-6 relative parity bound).

K5's plain version is held against the Pallas kernel ``pallas_autocov`` in
interpret mode; the ``"direct_kernel"`` curve and the ESS through the marker
against the JAX package's ``"pallas_interpret"`` method. The CUDA kernel is
held against the plain version in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import mcmcdiagnostictools_jl_tpu as mdt
import mcmcdiagnostictools_jl_tpu_torch as mtt
from conftest import ar1
from mcmcdiagnostictools_jl_tpu.ops import autocov as jautocov
from mcmcdiagnostictools_jl_tpu.ops import moments as jmoments
from mcmcdiagnostictools_jl_tpu.ops.pallas.autocov_kernel import pallas_autocov
from mcmcdiagnostictools_jl_tpu_torch.diagnostics.ess_rhat import _method_name
from mcmcdiagnostictools_jl_tpu_torch.kernels import autocov as k5
from mcmcdiagnostictools_jl_tpu_torch.kernels import moments_autocov as k1
from mcmcdiagnostictools_jl_tpu_torch.ops import autocov
from torch_parity import assert_close, t

PALLAS = mdt.PallasAutocovMethod(interpret=True)


def _centered(rng, shape):
    x = ar1(rng, 0.6, 1.0, shape)
    x[:, 0, 1] = 0.75  # a constant series: every lag exactly 0
    return x - x.mean(0)


@pytest.mark.parametrize("shape", [(60, 4, 3), (37, 3, 11)])
@pytest.mark.parametrize("maxlag", [1, 7, "niter + 3"])
def test_plain_k5_matches_pallas_interpret(rng, shape, maxlag):
    """Lags at or beyond niter are 0, as the TPU kernel's zero padding makes
    them."""
    x = _centered(rng, shape)
    niter = shape[0]
    if maxlag == "niter + 3":
        maxlag = niter + 3
    got = k5.direct_autocov_plain(t(x), maxlag)
    want = pallas_autocov(x, maxlag, interpret=True)
    assert tuple(got.shape) == (maxlag + 1,) + shape[1:]
    assert_close(got, want, rtol=1e-6, atol=1e-12)
    assert not got[niter:].any()


def test_plain_k5_poisons_a_nan_series_only(rng):
    x = _centered(rng, (60, 4, 3))
    x[5, 1, 2] = np.nan
    got = k5.direct_autocov_plain(t(x), 7)
    assert_close(got, pallas_autocov(x, 7, interpret=True), equal_nan=True)
    assert np.isnan(got[:, 1, 2].numpy()).all()
    assert np.isfinite(got[:, 0].numpy()).all()


def test_wrapper_runs_plain_version_for_cpu_tensors(rng):
    x = t(_centered(rng, (40, 2, 3)))
    before = k5.direct_autocov.launches
    assert torch.equal(k5.direct_autocov(x, 8), k5.direct_autocov_plain(x, 8))
    assert k5.direct_autocov.launches == before  # no kernel launch on CPU


def test_k1_acov_is_k5_on_the_centered_series(rng):
    x = t(ar1(rng, 0.5, 1.0, (200, 3, 4)))
    mean, _, _, _, acov = k1.moments_autocov_plain(x, 30)
    assert torch.equal(acov, k5.direct_autocov_plain(x - mean, 30))


@pytest.mark.parametrize("maxlag", [1, 37, 250])
def test_direct_kernel_curve_matches_jax_pallas(rng, maxlag):
    x = ar1(rng, 0.7, 1.0, (301, 3, 4))
    ref = jmoments.chain_stats(x)
    centered = x - np.asarray(ref.chain_mean)[None]
    got = autocov.mean_autocov_curve(t(centered), t(np.asarray(ref.chain_var)),
                                     maxlag, "direct_kernel")
    want = jautocov.mean_autocov_curve(centered, ref.chain_var, maxlag,
                                       "pallas_interpret")
    assert_close(got, want, rtol=1e-6, atol=1e-10)


def test_marker_ess_matches_jax_pallas_method(rng):
    x = ar1(rng, 0.6, 1.0, (500, 4, 3))
    got = mtt.ess(x, kind="basic", autocov_method=mtt.DirectKernelAutocovMethod(), device="cpu")
    assert_close(got, mdt.ess(x, kind="basic", autocov_method=PALLAS))
    assert_close(got, mtt.ess(x, kind="basic", autocov_method=mtt.AutocovMethod(), device="cpu"))


def test_marker_rank_pipeline_matches_jax_pallas_method(rng):
    x = rng.standard_normal((300, 4, 2))
    marker = mtt.DirectKernelAutocovMethod()
    got = mtt.ess_rhat(x, kind="rank", autocov_method=marker, device="cpu")
    want = mdt.ess_rhat(x, kind="rank", autocov_method=PALLAS)
    assert_close(got.ess, want.ess)
    assert_close(got.rhat, want.rhat)


def test_marker_names_and_auto_still_selects_k1():
    assert mtt.DirectKernelAutocovMethod().name == "direct_kernel"
    assert _method_name(mtt.DirectKernelAutocovMethod()) == "direct_kernel"
    assert _method_name("auto") == "kernel"
    assert "direct_kernel" in autocov._METHODS
    # one route for the direct estimator: K5 on the card, its plain version here
    assert autocov._METHODS["direct"] is autocov._METHODS["direct_kernel"]
