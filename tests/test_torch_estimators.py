"""The estimator kinds of the port's ``ess`` against the JAX package.

- float64 on the CPU, every estimator kind, every autocov marker, both rank
  modes: within BASELINE.md's 1e-6 relative parity bound of ``mdt.ess``
  (the JAX package runs its FFT autocovariance on the CPU, the port the
  marker's method: the same estimator, other rounding; BDA against BDA);
- float32 fast mode against the JAX pipeline with its Pallas kernels
  interpreted: ESS within 1e-4 relative (the float32 rounding of ranks near
  n = 4000, one ulp 2.4e-4, and of the sums);
- the exact mode against the NumPy float64 oracle ``tests/ref_impl.py``;
- the per-column ``hist_rank_value`` against the JAX function at float64;
- the contracts: NaN poisoning, constant slices, scalar output, chunking.
"""

import functools

import numpy as np
import pytest
import torch

import mcmcdiagnostictools_jl_tpu as mdt
import mcmcdiagnostictools_jl_tpu_torch as mtt
import ref_impl
from conftest import ar1
from mcmcdiagnostictools_jl_tpu.diagnostics.ess_rhat import _ess_rhat_pipeline
from mcmcdiagnostictools_jl_tpu.ops import fastrank as jfr
from mcmcdiagnostictools_jl_tpu_torch.ops import fastrank as fr
from torch_parity import assert_close, t

KINDS = ["mean", "std", "median", "mad", 0.05, 0.8]  # floats: Quantile(p)
MODES = ["exact", "fast"]
METHODS = ["auto", "direct", "fft", "bda", mtt.AutocovMethod(),
           mtt.FFTAutocovMethod(), mtt.BDAAutocovMethod(),
           mtt.KernelAutocovMethod(), mtt.DirectKernelAutocovMethod()]


def _kinds(kind):
    """(port kind, JAX kind)."""
    if isinstance(kind, float):
        return mtt.Quantile(kind), mdt.Quantile(kind)
    return kind, kind


def _chains(seed, shape, phi=0.5):
    """AR(1) chains with one chain of parameter 0 shifted (poor mixing)."""
    x = ar1(np.random.default_rng(seed), phi, 1.0, shape)
    x[:, 0, 0] += 1.5
    return x


_X = _chains(42, (500, 4, 3))


@functools.cache
def _jax_ess(kind, mode, bda):
    return np.asarray(mdt.ess(_X, kind=_kinds(kind)[1], rank_mode=mode,
                              autocov_method="bda" if bda else "auto"))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", KINDS)
def test_ess_estimators_match_jax(rng, kind, mode):
    x = _chains(int(rng.integers(1 << 30)), (700, 4, 3))
    got = mtt.ess(x, kind=_kinds(kind)[0], rank_mode=mode, device="cpu")
    assert_close(got, mdt.ess(x, kind=_kinds(kind)[1], rank_mode=mode))


@pytest.mark.parametrize("method", METHODS, ids=str)
@pytest.mark.parametrize("mode", MODES)
def test_every_marker_matches_jax(method, mode):
    """Each autocov method, every estimator kind (one call per kind)."""
    bda = getattr(method, "name", method) == "bda"
    for kind in KINDS:
        got = mtt.ess(_X, kind=_kinds(kind)[0], rank_mode=mode,
                      autocov_method=method, device="cpu")
        assert_close(got, _jax_ess(kind, mode, bda))


@pytest.mark.parametrize("kind", ["median", "mad", 0.1, 0.95, "mean", "std"])
def test_fast_f32_matches_jax_pipeline_with_interpreted_kernels(rng, kind):
    x = _chains(int(rng.integers(1 << 30)), (1000, 4, 3)).astype(np.float32)
    got = mtt.ess(x, kind=_kinds(kind)[0], rank_mode="fast", device="cpu")
    assert got.dtype == torch.float32
    q = kind if isinstance(kind, float) else None
    want, _ = _ess_rhat_pipeline(
        x, kind="quantile" if q else kind, split_chains=2, maxlag=250,
        method="fused_interpret", relative=False, q=q,
        fast_impl="pallas_interpret", rank_mode="fast",
    )
    assert_close(got, want, rtol=1e-4, atol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_exact_mode_matches_numpy_oracle(rng, kind):
    x = rng.standard_normal((600, 4, 3)) * 1.3 + 0.2
    okind, q = ("quantile", kind) if isinstance(kind, float) else (kind, None)
    assert_close(mtt.ess(x, kind=_kinds(kind)[0], device="cpu"),
                 ref_impl.ess(x, kind=okind, q=q))


@pytest.mark.parametrize("opts", [dict(relative=True), dict(split_chains=3),
                                  dict(maxlag=10)])
def test_options_match_jax(rng, opts):
    x = _chains(int(rng.integers(1 << 30)), (301, 4, 3))
    for kind in ("std", 0.3):
        for mode in MODES:
            assert_close(mtt.ess(x, kind=_kinds(kind)[0], rank_mode=mode, **opts, device="cpu"),
                         mdt.ess(x, kind=_kinds(kind)[1], rank_mode=mode, **opts))


@pytest.mark.parametrize("mode", MODES)
def test_param_chunk_is_exact(rng, mode):
    x = _chains(int(rng.integers(1 << 30)), (300, 4, 7))
    for kind in ("mad", mtt.Quantile(0.2)):
        whole = mtt.ess(x, kind=kind, rank_mode=mode, device="cpu")
        chunked = mtt.ess(x, kind=kind, rank_mode=mode, param_chunk=3, device="cpu")
        assert_close(chunked, whole, rtol=1e-12, atol=0)


# ---- contracts ---------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", KINDS)
def test_nan_poisons_only_its_parameter(rng, kind, mode):
    x = rng.standard_normal((200, 4, 3))
    x[10, 2, 1] = np.nan
    v = mtt.ess(x, kind=_kinds(kind)[0], rank_mode=mode, device="cpu").numpy()
    assert np.isnan(v[1]) and np.all(np.isfinite(v[[0, 2]]))


@pytest.mark.parametrize("mode", MODES)
def test_constant_slice_gives_nan(rng, mode):
    x = rng.standard_normal((200, 4, 3))
    x[:, :, 2] = 1.5
    for kind in KINDS:
        v = mtt.ess(x, kind=_kinds(kind)[0], rank_mode=mode, device="cpu").numpy()
        assert np.isnan(v[2]) and np.all(np.isfinite(v[:2]))


@pytest.mark.parametrize("mode", MODES)
def test_scalar_output_for_2d_input(rng, mode):
    x = rng.standard_normal((200, 4))
    for kind in KINDS:
        assert isinstance(mtt.ess(x, kind=_kinds(kind)[0], rank_mode=mode, device="cpu"),
                          float)


def test_kind_errors(rng):
    x = rng.standard_normal((100, 4, 2))
    for bad in ("rank", "bogus", 0.5, None):
        with pytest.raises(ValueError):
            mtt.ess(x, kind=bad, device="cpu")
    with pytest.raises(ValueError):
        mtt.Quantile(0.0)


# ---- the per-column rank inversion of the fast mode --------------------------


def test_hist_rank_value_per_column_matches_jax(rng):
    x = rng.standard_normal((3000, 5))
    x[:, 1] = np.round(x[:, 1] * 2) / 2  # ties
    x[:, 2] = 0.25  # constant
    x[4, 3] = np.nan
    nbins = 512
    cdf = fr.build_hist_cdf(t(x), nbins)
    jcdf = jfr.build_hist_cdf(x, nbins)
    h = np.array([1.0, 17.5, 1500.0, 2999.0, 3000.0])
    got = fr.hist_rank_value(cdf, t(h), nbins)
    want = jfr.hist_rank_value(jcdf, h, nbins)
    assert_close(got, want, rtol=1e-6, atol=1e-12, equal_nan=True)
    # a float rank is the same rank in every column
    assert_close(fr.hist_rank_value(cdf, 700.0, nbins),
                 fr.hist_rank_value(cdf, t(np.full(5, 700.0)), nbins),
                 rtol=0, atol=0, equal_nan=True)
    assert_close(fr.hist_quantile(cdf, (0.1, 0.5), nbins),
                 jfr.hist_quantile(jcdf, (0.1, 0.5), nbins), equal_nan=True)
