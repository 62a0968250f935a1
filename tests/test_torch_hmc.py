"""The port's HMC sampler (``models/hmc.py``) against the JAX package's.

- the targets ``cauchy_logpdf`` and ``eight_schools_logpdf`` and their
  gradients against the JAX functions and ``jax.grad``, float64 within
  1e-12;
- the deterministic core ``hmc_transitions`` fed the JAX sampler's own
  random draws, rebuilt with the JAX API as the JAX ``hmc_sample`` derives
  them (one key a chain and draw, split three ways: ``normal``,
  ``randint(1, max_leapfrog + 1)``, ``uniform``), against the JAX
  ``hmc_sample`` on the same key: samples and energy within 1e-9, the
  accept rate within 1e-6 (the JAX package may return it in float32);
- the port's own ``hmc_sample`` with a seeded ``torch.Generator``: the same
  seed gives the same trace, the shapes and dtypes of ``HMCTrace``, and a
  small Cauchy run accepts more than 60 % with finite energies that
  ``bfmi`` takes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmcdiagnostictools_jl_tpu_torch as mtt
from mcmcdiagnostictools_jl_tpu.models import hmc as jhmc
from mcmcdiagnostictools_jl_tpu_torch.models import hmc
from torch_parity import assert_close, t

TARGETS = {
    "cauchy": (jhmc.cauchy_logpdf, hmc.cauchy_logpdf, 50),
    "eight_schools": (jhmc.eight_schools_logpdf, hmc.eight_schools_logpdf, 10),
}


@pytest.mark.parametrize("target", sorted(TARGETS))
def test_logpdf_and_gradient_match_jax(target):
    jf, tf, dim = TARGETS[target]
    x = np.random.default_rng(3).standard_normal((6, dim))
    want = np.array([float(jf(jnp.asarray(r))) for r in x])
    want_g = np.stack([np.asarray(jax.grad(jf)(jnp.asarray(r))) for r in x])
    got = torch.stack([tf(r) for r in t(x)])
    got_g = torch.func.vmap(torch.func.grad(tf))(t(x))
    assert got.dtype == torch.float64
    assert_close(got, want, rtol=1e-12, atol=1e-12)
    assert_close(got_g, want_g, rtol=1e-12, atol=1e-12)


def jax_random_inputs(key, nchains, num_samples, dim, max_leapfrog):
    """The random inputs the JAX ``hmc_sample`` draws from ``key``, as
    ``(draws, chains, ...)`` numpy arrays: momenta, lengths, uniforms."""
    keys = jax.random.split(key, nchains * num_samples).reshape(
        nchains, num_samples, 2)

    def one(k):
        k_mom, k_len, k_acc = jax.random.split(k, 3)
        return (jax.random.normal(k_mom, (dim,)),
                jax.random.randint(k_len, (), 1, max_leapfrog + 1),
                jax.random.uniform(k_acc, ()))

    p, n, u = jax.vmap(jax.vmap(one))(keys)
    return tuple(np.moveaxis(np.asarray(a), 0, 1) for a in (p, n, u))


@pytest.mark.parametrize("target,nchains,draws,step,max_leapfrog", [
    ("cauchy", 4, 300, 0.25, 16),
    ("eight_schools", 8, 150, 0.2, 16),
])
def test_core_fed_jax_draws_reproduces_jax_sampler(target, nchains, draws,
                                                   step, max_leapfrog):
    jf, tf, dim = TARGETS[target]
    init = 0.5 * np.random.default_rng(11).standard_normal((nchains, dim))
    key = jax.random.PRNGKey(5)
    want = jhmc.hmc_sample(jf, jnp.asarray(init), key, num_samples=draws,
                           step_size=step, max_leapfrog=max_leapfrog)
    p, n, u = jax_random_inputs(key, nchains, draws, dim, max_leapfrog)
    assert p.dtype == np.float64 and u.dtype == np.float64
    got = hmc.hmc_transitions(tf, t(init), t(p), t(n).long(), t(u),
                              step_size=step, max_leapfrog=max_leapfrog)
    assert got.samples.shape == (draws, nchains, dim)
    assert_close(got.samples, np.asarray(want.samples), rtol=0, atol=1e-9)
    assert_close(got.energy, np.asarray(want.energy), rtol=0, atol=1e-9)
    assert_close(got.accept_rate, np.asarray(want.accept_rate), rtol=0,
                 atol=1e-6)
    # the run exercised both branches of the Metropolis correction
    acc = got.accept_rate.numpy()
    assert 0.3 < acc.min() and acc.max() < 1.0


def _run(seed, dtype=torch.float64, draws=120):
    init = 0.5 * torch.randn((4, 20), dtype=dtype,
                             generator=torch.Generator().manual_seed(1))
    return mtt.models.hmc_sample(
        mtt.models.cauchy_logpdf, init, torch.Generator().manual_seed(seed),
        num_samples=draws, step_size=0.25, max_leapfrog=16)


def test_seeded_sampler_repeats_and_feeds_bfmi():
    a, b, c = _run(7), _run(7), _run(8)
    assert isinstance(a, mtt.models.HMCTrace)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a.samples, c.samples)
    assert a.samples.shape == (120, 4, 20) and a.energy.shape == (120, 4)
    assert a.accept_rate.shape == (4,)
    assert all(v.dtype == torch.float64 and v.device.type == "cpu" for v in a)
    assert bool((a.accept_rate > 0.6).all())
    assert bool(torch.isfinite(a.energy).all())
    b = mtt.bfmi(a.energy)
    assert b.shape == (4,) and bool(((b > 0) & torch.isfinite(b)).all())
    f32 = _run(7, torch.float32, 20)
    assert all(v.dtype == torch.float32 for v in f32)


def test_sampler_rejects_bad_shapes():
    init = torch.zeros((2, 3), dtype=torch.float64)
    with pytest.raises(ValueError):
        mtt.models.hmc_sample(hmc.cauchy_logpdf, init[0], num_samples=2,
                              step_size=0.1)
    with pytest.raises(ValueError):
        hmc.hmc_transitions(hmc.cauchy_logpdf, init, torch.zeros((4, 2, 3)),
                            torch.ones((4, 3), dtype=torch.long),
                            torch.zeros((4, 2)), step_size=0.1,
                            max_leapfrog=2)
