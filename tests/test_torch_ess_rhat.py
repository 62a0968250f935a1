"""The port's ``ess`` / ``rhat`` / ``ess_rhat`` against the JAX package.

- float64 on the CPU, both rank modes, every kind of the slice: within
  BASELINE.md's 1e-6 relative parity bound of ``mdt.ess_rhat(...,
  rank_mode=...)`` (the JAX package picks its FFT autocovariance on the CPU,
  the port its fused direct one: the same estimator, other rounding);
- float32 fast mode against the JAX pipeline with its Pallas kernels
  interpreted (``method="fused_interpret"``, ``fast_impl="pallas_interpret"``):
  ESS within 1e-4 relative and R-hat within 1e-5 absolute, the float32
  rounding of ranks near n = 4000 (one ulp is 2.4e-4) and of the sums;
- the exact mode against the NumPy float64 oracle ``tests/ref_impl.py``;
- the contracts: scalar output, NaN poisoning, degenerate samples, short
  chains, the kinds' errors, both branches of the adaptive Geyer probe, and
  the device rule.
"""

import warnings

import numpy as np
import pytest
import torch

import mcmcdiagnostictools_jl_tpu as mdt
import mcmcdiagnostictools_jl_tpu_torch as mtt
import ref_impl
from conftest import ar1
from mcmcdiagnostictools_jl_tpu.diagnostics.ess_rhat import _ess_rhat_pipeline
from mcmcdiagnostictools_jl_tpu_torch.kernels import moments_autocov as k1
from torch_parity import assert_close

KINDS = ["basic", "bulk", "tail", "rank"]
MODES = ["exact", "fast"]


def _chains(rng, shape, phi=0.5):
    """AR(1) chains with one chain of parameter 0 shifted (poor mixing)."""
    x = ar1(rng, phi, 1.0, shape)
    if x.ndim >= 3:
        x[:, 0, 0] += 1.5
    return x


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", KINDS)
def test_ess_rhat_matches_jax(rng, kind, mode):
    x = _chains(rng, (1000, 4, 3))
    got = mtt.ess_rhat(x, kind=kind, rank_mode=mode, device="cpu")
    want = mdt.ess_rhat(x, kind=kind, rank_mode=mode)
    assert_close(got.ess, want.ess)
    assert_close(got.rhat, want.rhat)


@pytest.mark.parametrize("mode", MODES)
def test_odd_draws_and_param_dims_match_jax(rng, mode):
    x = _chains(rng, (237, 3, 2, 2))
    got = mtt.ess_rhat(x, rank_mode=mode, device="cpu")
    want = mdt.ess_rhat(x, rank_mode=mode)
    assert tuple(got.ess.shape) == (2, 2)
    assert_close(got.ess, want.ess)
    assert_close(got.rhat, want.rhat)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", KINDS)
def test_rhat_matches_jax(rng, kind, mode):
    x = _chains(rng, (600, 4, 5)) * 2.0 + 1.0
    assert_close(mtt.rhat(x, kind=kind, rank_mode=mode, device="cpu"),
                 mdt.rhat(x, kind=kind, rank_mode=mode))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["bulk", "tail", "basic"])
def test_ess_matches_jax(rng, kind, mode):
    x = _chains(rng, (800, 4, 3))
    assert_close(mtt.ess(x, kind=kind, rank_mode=mode, tail_prob=0.2, device="cpu"),
                 mdt.ess(x, kind=kind, rank_mode=mode, tail_prob=0.2))


@pytest.mark.parametrize("method", [
    "fft", "direct", "bda", mtt.AutocovMethod(), mtt.FFTAutocovMethod(),
    mtt.BDAAutocovMethod(), mtt.KernelAutocovMethod(),
])
def test_autocov_methods_match_jax(rng, method):
    x = _chains(rng, (500, 4, 3))
    jmethod = getattr(method, "name", method)
    jmethod = {"kernel": "direct"}.get(jmethod, jmethod)
    got = mtt.ess_rhat(x, kind="basic", autocov_method=method, device="cpu")
    want = mdt.ess_rhat(x, kind="basic", autocov_method=jmethod)
    assert_close(got.ess, want.ess)


def test_callable_autocov_method(rng):
    from mcmcdiagnostictools_jl_tpu_torch.ops.autocov import _mean_autocov_fft

    x = _chains(rng, (400, 4, 2))
    got = mtt.ess(x, kind="basic", autocov_method=_mean_autocov_fft, device="cpu")
    assert_close(got, mdt.ess(x, kind="basic", autocov_method="fft"))
    with pytest.raises(TypeError):
        mtt.ess(x, autocov_method=3, device="cpu")


@pytest.mark.parametrize("opts", [
    dict(relative=True), dict(split_chains=1), dict(split_chains=3),
    dict(maxlag=10), dict(maxlag=100000), dict(kind="basic", maxlag=3),
])
def test_options_match_jax(rng, opts):
    x = _chains(rng, (301, 4, 3))
    opts = {"kind": "rank", **opts}
    got = mtt.ess_rhat(x, **opts, device="cpu")
    want = mdt.ess_rhat(x, **opts)
    assert_close(got.ess, want.ess)
    assert_close(got.rhat, want.rhat)


@pytest.mark.parametrize("mode", MODES)
def test_param_chunk_is_exact(rng, mode):
    x = _chains(rng, (300, 4, 7))
    whole = mtt.ess_rhat(x, rank_mode=mode, device="cpu")
    chunked = mtt.ess_rhat(x, rank_mode=mode, param_chunk=3, device="cpu")
    # per-parameter independence: equal up to the last bits of float64
    # reductions whose vector width follows the batch
    assert_close(chunked.ess, whole.ess, rtol=1e-12, atol=0)
    assert_close(chunked.rhat, whole.rhat, rtol=1e-12, atol=0)


@pytest.mark.parametrize("kind", ["rank", "tail"])
def test_fast_f32_matches_jax_pipeline_with_interpreted_kernels(rng, kind):
    x = _chains(rng, (1000, 4, 3)).astype(np.float32)
    got = mtt.ess_rhat(x, kind=kind, rank_mode="fast", device="cpu")
    assert got.ess.dtype == torch.float32
    want_ess, want_rhat = _ess_rhat_pipeline(
        x, kind=kind, split_chains=2, maxlag=250, method="fused_interpret",
        relative=False, q=0.1 if kind == "tail" else None,
        fast_impl="pallas_interpret", rank_mode="fast",
    )
    assert_close(got.ess, want_ess, rtol=1e-4, atol=0)
    assert_close(got.rhat, want_rhat, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_exact_mode_matches_numpy_oracle(rng, kind):
    x = ref_impl.rank_normalize(rng.standard_normal((1000, 4, 3))) * 1.3 + 0.2
    got = mtt.ess_rhat(x, kind=kind, device="cpu")
    want_ess, want_rhat = ref_impl.ess_rhat(x, kind=kind)
    assert_close(got.ess, want_ess)
    assert_close(got.rhat, want_rhat)
    assert_close(mtt.rhat(x, kind=kind, device="cpu"), ref_impl.rhat(x, kind=kind))


def test_exact_ess_kinds_match_numpy_oracle(rng):
    x = rng.standard_normal((800, 4, 3))
    for kind in ("bulk", "tail", "basic"):
        assert_close(mtt.ess(x, kind=kind, device="cpu"), ref_impl.ess(x, kind=kind))


# ---- contracts ---------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_scalar_output_for_2d_input(rng, mode):
    res = mtt.ess_rhat(rng.standard_normal((200, 4)), rank_mode=mode, device="cpu")
    assert isinstance(res.ess, float) and isinstance(res.rhat, float)
    assert isinstance(mtt.rhat(rng.standard_normal(200), device="cpu"), float)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", KINDS)
def test_nan_poisons_only_its_parameter(rng, kind, mode):
    x = rng.standard_normal((200, 4, 3))
    x[10, 2, 1] = np.nan
    res = mtt.ess_rhat(x, kind=kind, rank_mode=mode, device="cpu")
    for v in res:
        assert np.isnan(v[1].item())
        assert np.all(np.isfinite(v[[0, 2]].numpy()))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", KINDS)
def test_identical_sample_gives_nan(kind, mode):
    res = mtt.ess_rhat(np.full((100, 4, 2), 1.5), kind=kind, rank_mode=mode, device="cpu")
    assert np.all(np.isnan(res.ess.numpy())) and np.all(np.isnan(res.rhat.numpy()))


def test_short_chains_warn_with_nan_ess_and_finite_rhat(rng):
    x = rng.standard_normal((9, 4, 2))
    with pytest.warns(UserWarning, match="must be >4"):
        res = mtt.ess_rhat(x, device="cpu")
    assert np.all(np.isnan(res.ess.numpy())) and np.all(np.isfinite(res.rhat.numpy()))
    with pytest.warns(UserWarning):
        want = mdt.ess_rhat(x)
    assert_close(res.rhat, want.rhat)
    with pytest.warns(UserWarning):
        assert np.isnan(mtt.ess(x[:, :, 0], device="cpu"))


def test_kind_errors(rng):
    x = rng.standard_normal((100, 4, 2))
    with pytest.raises(ValueError):
        mtt.ess(x, kind="rank", device="cpu")
    for kind in ("mean", "median", "std", "mad", mtt.Quantile(0.3)):
        assert np.all(np.isfinite(mtt.ess(x, kind=kind, device="cpu").numpy()))
    with pytest.raises(ValueError):
        mtt.rhat(x, kind="nope", device="cpu")
    with pytest.raises(ValueError):
        mtt.ess_rhat(x, kind="mean", device="cpu")
    with pytest.raises(ValueError):
        mtt.ess_rhat(x, rank_mode="nope", device="cpu")
    with pytest.raises(ValueError):
        mtt.ess_rhat(x, maxlag=0, device="cpu")
    with pytest.raises(ValueError):
        mtt.ess(x, kind="tail", tail_prob=1.0, device="cpu")
    with pytest.raises(ValueError):
        mtt.Quantile(1.5)


@pytest.mark.parametrize("phi,lags", [(0.0, [64]), (0.99, [64, 250])])
def test_adaptive_geyer_probe_branches(rng, monkeypatch, phi, lags):
    """i.i.d. chains stop within the 64-lag probe; AR(1) at 0.99 needs the
    full 250 lags. Either way the result equals the direct method's."""
    seen = []
    plain = k1.moments_autocov_plain

    def record(samples, maxlag):
        seen.append(maxlag)
        return plain(samples, maxlag)

    monkeypatch.setattr(k1, "moments_autocov_plain", record)
    x = ar1(rng, phi, 1.0, (1200, 4, 3))
    got = mtt.ess(x, kind="basic", device="cpu")
    assert seen == lags
    assert_close(got, mtt.ess(x, kind="basic", autocov_method="direct", device="cpu"))


def test_numpy_input_goes_to_the_named_device(rng):
    x = rng.standard_normal((100, 4, 2))
    res = mtt.ess_rhat(x, device="cpu")
    assert res.ess.device.type == "cpu" and res.ess.dtype == torch.float64
    res32 = mtt.ess_rhat(torch.from_numpy(x.astype(np.float32)), device="cpu")
    assert res32.rhat.dtype == torch.float32
    with pytest.raises(ValueError):
        mtt.ess_rhat(torch.from_numpy(x), device="meta")


def test_no_warnings_on_the_main_path(rng):
    x = _chains(rng, (400, 4, 3)).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        mtt.ess_rhat(x, rank_mode="fast", device="cpu")
        mtt.ess_rhat(x, device="cpu")
