"""The port's ``mcse`` against the JAX package and the float64 oracles.

- every kind, both rank modes, at float64 on the CPU: within BASELINE.md's
  1e-6 relative parity bound of ``mdt.mcse``; the exact kinds and the SBM
  also against ``ref_impl.mcse_mean``/``mcse_std``/``mcse_quantile``/
  ``mcse_sbm``;
- the fast quantile MCSE against the exact one: the pinned bound
  ``FAST_QUANTILE_BOUND``;
- ``Quantile(0.99)`` on a float32 sample with ESS ~ 2e5 against the float64
  oracle (ROADMAP.md fault C1: the JAX package's float32 Beta inverse is
  25% off there);
- ``betaincinv`` against SciPy; the keyword surface (fault C2); the
  contracts.
"""

import warnings

import numpy as np
import pytest
import scipy.special
import torch

import mcmcdiagnostictools_jl_tpu as mdt
import mcmcdiagnostictools_jl_tpu_torch as mtt
import ref_impl
from conftest import ar1
from mcmcdiagnostictools_jl_tpu_torch.ops.special import betaincinv
from torch_parity import assert_close, t

MODES = ["exact", "fast"]
KINDS = ["mean", "std", "median", 0.05, 0.3, 0.99]  # floats: Quantile(p)

# Fast against exact quantile MCSE, relative. Measured on the CPU at
# 4000 x 16 x 32 (AR(1) 0.5, float64 and float32 alike): 1.62e-2 at
# p = 0.05, 5.92e-3 at p = 0.5, 3.3e-8 at p = 0.99. The residual is the
# proxy's threshold, read off the histogram, moving the ESS behind the Beta
# interval, and hence the interval's order statistics, by a rank or so.
FAST_QUANTILE_BOUND = 2.5e-2


def _kinds(kind):
    """(port kind, JAX kind)."""
    if isinstance(kind, float):
        return mtt.Quantile(kind), mdt.Quantile(kind)
    return kind, kind


def _chains(rng, shape, phi=0.5):
    x = ar1(rng, phi, 1.0, shape)
    x[:, 0, 0] += 1.0
    return x


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", KINDS)
def test_mcse_matches_jax(rng, kind, mode):
    x = _chains(rng, (600, 4, 3))
    pk, jk = _kinds(kind)
    for marker, jmarker in ((mtt.DirectKernelAutocovMethod(),
                             mdt.PallasAutocovMethod(interpret=True)),
                            ("auto", "auto")):
        got = mtt.mcse(x, kind=pk, rank_mode=mode, autocov_method=marker, device="cpu")
        assert_close(got, mdt.mcse(x, kind=jk, rank_mode=mode,
                                   autocov_method=jmarker))


def test_exact_kinds_match_numpy_oracles(rng):
    x = rng.standard_normal((500, 4, 3)) * 2.0 + 1.0
    assert_close(mtt.mcse(x, device="cpu"), ref_impl.mcse_mean(x))
    assert_close(mtt.mcse(x, kind="std", device="cpu"), ref_impl.mcse_std(x))
    for p in (0.1, 0.5, 0.9):
        assert_close(mtt.mcse(x, kind=mtt.Quantile(p), device="cpu"),
                     ref_impl.mcse_quantile(x, p))
    assert_close(mtt.mcse(x, kind="median", device="cpu"), ref_impl.mcse_quantile(x, 0.5))


@pytest.mark.parametrize("batch_size", [None, 10])
def test_sbm_matches_jax_and_oracle(rng, batch_size):
    x = rng.standard_normal((300, 3, 2))
    got = mtt.mcse(x, kind=lambda w: w.mean(), batch_size=batch_size, device="cpu")
    assert_close(got, mdt.mcse(x, kind=lambda w: w.mean(),
                               batch_size=batch_size))
    assert_close(got, ref_impl.mcse_sbm(x, np.mean, batch_size=batch_size))


def test_sbm_batches_windows_by_memory(rng, monkeypatch):
    """Many small batches give the one-batch result."""
    from mcmcdiagnostictools_jl_tpu_torch.diagnostics import mcse as m

    x = rng.standard_normal((200, 4, 3))
    whole = mtt.mcse(x, kind=lambda w: (w * w).mean(), device="cpu")
    monkeypatch.setattr(m, "_SBM_BATCH_BYTES", 1)  # one window per batch
    assert_close(mtt.mcse(x, kind=lambda w: (w * w).mean(), device="cpu"), whole,
                 rtol=1e-12, atol=0)


def test_sbm_callable_vmap_cannot_trace_fails_loudly(rng):
    x = rng.standard_normal((100, 2, 2))
    with pytest.raises(RuntimeError):
        mtt.mcse(x, kind=lambda w: float(w.mean()), device="cpu")


def test_sbm_constant_and_nan_slices(rng):
    x = rng.standard_normal((100, 2, 3))
    x[:, :, 0] = 2.0
    x[4, 1, 2] = np.nan
    v = mtt.mcse(x, kind=lambda w: w.mean(), device="cpu").numpy()
    assert np.isnan(v[0]) and np.isfinite(v[1]) and np.isnan(v[2])
    with pytest.raises(ValueError):
        mtt.mcse(x, kind=lambda w: w.mean(), batch_size=0, device="cpu")


@pytest.mark.parametrize("p", [0.05, 0.5, 0.99])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fast_quantile_within_pinned_bound(p, dtype):
    x = ar1(np.random.default_rng(7), 0.5, 1.0, (4000, 16, 32)).astype(dtype)
    exact = mtt.mcse(x, kind=mtt.Quantile(p), device="cpu")
    fast = mtt.mcse(x, kind=mtt.Quantile(p), rank_mode="fast", device="cpu")
    assert_close(fast, exact, rtol=FAST_QUANTILE_BOUND, atol=0)


def test_quantile_f32_large_ess_matches_f64_oracle():
    """S ~ 1.98e5 at p = 0.99 (Beta(196400, 1985)): the float64 Beta
    inverse keeps the order statistics; bound one order statistic of the
    ~88-rank interval (1.1e-2)."""
    y = np.random.default_rng(11).standard_normal((49500, 4, 2))
    y = y.astype(np.float32)
    s = mtt.ess(y, kind=mtt.Quantile(0.99), device="cpu").numpy()
    assert np.all((s > 1.9e5) & (s * 0.01 + 1 < 2000))
    got = mtt.mcse(y, kind=mtt.Quantile(0.99), device="cpu")
    assert_close(got, ref_impl.mcse_quantile(y.astype(np.float64), 0.99),
                 rtol=1.1e-2, atol=0)


def test_betaincinv_matches_scipy():
    a = t([0.5, 2.0, 30.0, 196401.0, 1e3, np.nan])
    b = t([0.5, 5.0, 3.0, 1985.0, 1e5, 1.0])
    for y in (0.15865525393145705, 0.5, 0.8413447460685429):
        got = betaincinv(a, b, y)
        assert got.dtype == torch.float64 and got.device == a.device
        assert_close(got, scipy.special.betaincinv(a.numpy(), b.numpy(), y),
                     rtol=1e-10, atol=0, equal_nan=True)
    assert np.isnan(betaincinv(a, b, 0.5)[-1].item())


# ---- the keyword surface (fault C2) -----------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_both_modes_take_the_same_keywords(rng, mode):
    x = _chains(rng, (400, 4, 3))
    kw = dict(split_chains=3, maxlag=40, relative=False,
              autocov_method=mtt.FFTAutocovMethod(), rank_nbins=1024)
    for kind in ("mean", "std", "median", mtt.Quantile(0.2)):
        v = mtt.mcse(x, kind=kind, rank_mode=mode, **kw, device="cpu")
        assert np.all(np.isfinite(v.numpy()))
        with pytest.raises(TypeError, match="unexpected mcse kwargs"):
            mtt.mcse(x, kind=kind, rank_mode=mode, tail_prob=0.1, device="cpu")
        with pytest.raises(TypeError, match="batch_size"):
            mtt.mcse(x, kind=kind, rank_mode=mode, batch_size=10, device="cpu")


@pytest.mark.parametrize("kind", ["median", 0.3])
def test_fast_quantile_honours_split_maxlag_and_relative(rng, kind):
    x = _chains(rng, (800, 4, 3))
    pk, jk = _kinds(kind)
    for opts in (dict(split_chains=1), dict(maxlag=20)):
        assert_close(mtt.mcse(x, kind=pk, rank_mode="fast", **opts, device="cpu"),
                     mdt.mcse(x, kind=jk, rank_mode="fast", **opts))
    # relative=True feeds ESS / (draws * chains) to the Beta interval in
    # both modes; the fast one tracks the exact one
    assert_close(mtt.mcse(x, kind=pk, rank_mode="fast", relative=True, device="cpu"),
                 mtt.mcse(x, kind=pk, relative=True, device="cpu"),
                 rtol=FAST_QUANTILE_BOUND, atol=0)
    assert_close(mtt.mcse(x, kind=pk, relative=True, device="cpu"),
                 mdt.mcse(x, kind=jk, relative=True))


def test_sbm_rejects_ess_keywords(rng):
    x = rng.standard_normal((100, 4))
    with pytest.raises(TypeError):
        mtt.mcse(x, kind=lambda w: w.mean(), maxlag=10, device="cpu")


# ---- contracts ---------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_nan_and_constant_slices(rng, mode):
    x = rng.standard_normal((300, 4, 3))
    x[7, 1, 1] = np.nan
    x[:, :, 2] = 0.5
    for kind in KINDS:
        v = mtt.mcse(x, kind=_kinds(kind)[0], rank_mode=mode, device="cpu").numpy()
        assert np.isnan(v[1]) and np.isfinite(v[0]), kind
        assert np.isnan(v[2]), kind


@pytest.mark.parametrize("mode", MODES)
def test_shapes_and_scalars(rng, mode):
    x = rng.standard_normal((200, 4, 3, 2))
    for kind in KINDS:
        pk = _kinds(kind)[0]
        assert tuple(mtt.mcse(x, kind=pk, rank_mode=mode, device="cpu").shape) == (3, 2)
        assert isinstance(mtt.mcse(x[:, :, 0, 0], kind=pk, rank_mode=mode, device="cpu"),
                          float)
    assert isinstance(mtt.mcse(x[:, 0, 0, 0], kind=lambda w: w.mean(), device="cpu"), float)


def test_short_chains_warn_with_nan(rng):
    x = rng.standard_normal((9, 4, 2))
    for mode in MODES:
        for kind in ("mean", mtt.Quantile(0.4)):
            with pytest.warns(UserWarning, match="must be >4"):
                v = mtt.mcse(x, kind=kind, rank_mode=mode, device="cpu")
            assert np.all(np.isnan(v.numpy()))


def test_unknown_kind_raises(rng):
    with pytest.raises(ValueError):
        mtt.mcse(rng.standard_normal((100, 4)), kind="bogus", device="cpu")
    with pytest.raises(ValueError):
        mtt.mcse(rng.standard_normal((100, 4)), rank_mode="nope", device="cpu")


def test_no_warnings_on_the_path(rng):
    x = _chains(rng, (400, 4, 3)).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for mode in MODES:
            mtt.mcse(x, kind=mtt.Quantile(0.9), rank_mode=mode, device="cpu")
