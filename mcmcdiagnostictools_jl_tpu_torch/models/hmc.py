"""Jittered-trajectory HMC, the test-data sampler (counterpart of the JAX
package's ``models/hmc.py``).

Leapfrog trajectories of a uniformly random length in ``[1, max_leapfrog]``
with a unit mass matrix and a Metropolis correction, batched over chains:
the gradient of the potential is ``torch.func.vmap(torch.func.grad(...))``
over the chains of a ``logpdf`` that takes one ``(dim,)`` state, as
``jax.grad`` under ``vmap`` in the JAX package. It produces the samples and
the Hamiltonian energy trace that ``bfmi`` takes (BASELINE.md config 2) and
the heavy-tailed Cauchy draws of the integration tests.

The sampler is split in two. ``hmc_sample`` draws every random input up
front from a ``torch.Generator`` on the device of ``init``: the momenta, the
trajectory lengths and the accept uniforms of all draws. The deterministic
core ``hmc_transitions`` then runs the draws from them, as the JAX
``one_step`` does: a fixed ``max_leapfrog`` loop whose steps past a chain's
length are masked, the Hamiltonian before and after, acceptance where
``log(u) < min(0, h0 - h1)``. The core makes no host sync inside its loop
over draws, so the host queues launches ahead of the card. Fed the JAX
sampler's own draws, it reproduces the JAX package's ``hmc_sample``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..convert import to_tensor


class HMCTrace(NamedTuple):
    samples: torch.Tensor  # (draws, chains, dim)
    energy: torch.Tensor  # (draws, chains) Hamiltonian at accepted states
    accept_rate: torch.Tensor  # (chains,)


def hmc_transitions(logpdf, init: torch.Tensor, momenta: torch.Tensor,
                    nsteps: torch.Tensor, uniforms: torch.Tensor, *,
                    step_size: float, max_leapfrog: int) -> HMCTrace:
    """The draws of HMC from given random inputs: ``init`` ``(chains,
    dim)``; for each draw and chain the initial momentum ``momenta``
    ``(draws, chains, dim)``, the trajectory length ``nsteps`` ``(draws,
    chains)`` (integers in ``[1, max_leapfrog]``) and the accept uniform
    ``uniforms`` ``(draws, chains)``, all on the device of ``init``.

    One gradient of the potential a leapfrog step: the second half-kick's
    gradient is the next step's first, masked like the state, and the
    potential comes with it (``torch.func.grad_and_value``)."""
    if init.ndim != 2:
        raise ValueError(f"init must be (chains, dim), got {tuple(init.shape)}")
    nchains, dim = init.shape
    draws = momenta.shape[0]
    if (momenta.shape != (draws, nchains, dim)
            or nsteps.shape != (draws, nchains)
            or uniforms.shape != (draws, nchains)):
        raise ValueError(
            f"random inputs must be momenta ({draws}, {nchains}, {dim}), "
            f"nsteps and uniforms ({draws}, {nchains}); got "
            f"{tuple(momenta.shape)}, {tuple(nsteps.shape)}, "
            f"{tuple(uniforms.shape)}")
    if max_leapfrog < 1:
        raise ValueError("max_leapfrog must be >= 1")

    def potential(x):
        return -logpdf(x)

    grad_pot = torch.func.vmap(torch.func.grad_and_value(potential))
    half = 0.5 * step_size
    x = init
    g, u = grad_pot(x)  # gradient and potential at the current states
    samples = init.new_empty((draws, nchains, dim))
    energy = init.new_empty((draws, nchains))
    accepted = torch.empty((draws, nchains), dtype=torch.bool,
                           device=init.device)
    for t in range(draws):
        p0, n = momenta[t], nsteps[t]
        xp, pp, gp, up = x, p0, g, u
        for i in range(max_leapfrog):
            do = n > i
            p_half = pp - half * gp
            x_new = xp + step_size * p_half
            g_new, u_new = grad_pot(x_new)
            p_new = p_half - half * g_new
            xp = torch.where(do[:, None], x_new, xp)
            pp = torch.where(do[:, None], p_new, pp)
            gp = torch.where(do[:, None], g_new, gp)
            up = torch.where(do, u_new, up)
        h0 = u + 0.5 * (p0 * p0).sum(1)
        h1 = up + 0.5 * (pp * pp).sum(1)
        # NaN in h0 - h1 rejects, as jnp.minimum's NaN does in the JAX one
        accept = torch.log(uniforms[t]) < torch.clamp(h0 - h1, max=0.0)
        x = torch.where(accept[:, None], xp, x)
        g = torch.where(accept[:, None], gp, g)
        u = torch.where(accept, up, u)
        samples[t] = x
        torch.where(accept, h1, h0, out=energy[t])
        accepted[t] = accept
    return HMCTrace(samples, energy, accepted.to(init.dtype).mean(0))


def hmc_sample(logpdf, init, generator: torch.Generator | None = None, *,
               num_samples: int, step_size: float,
               max_leapfrog: int = 32) -> HMCTrace:
    """Sample with jittered-trajectory HMC.

    ``logpdf(x) -> scalar`` is the unnormalized log density of one
    ``(dim,)`` state, written with torch operations; ``init`` is ``(chains,
    dim)``: a tensor samples on its own device and in its dtype (a CUDA
    float32 tensor in float32 on the card), numpy on the card as float32
    (``convert.to_tensor``). Each draw runs a leapfrog trajectory of
    uniformly random length in ``[1, max_leapfrog]``. ``generator``, a
    ``torch.Generator`` on the device of ``init`` (the JAX ``key``), draws
    every random input before the first draw; ``None`` takes the device's
    default generator."""
    init = to_tensor(init)
    if init.ndim != 2:
        raise ValueError(f"init must be (chains, dim), got {tuple(init.shape)}")
    if num_samples < 1 or max_leapfrog < 1:
        raise ValueError("num_samples and max_leapfrog must be >= 1")
    nchains, dim = init.shape
    shape = (num_samples, nchains)
    kw = dict(generator=generator, device=init.device)
    momenta = torch.randn(shape + (dim,), dtype=init.dtype, **kw)
    nsteps = torch.randint(1, max_leapfrog + 1, shape, **kw)
    uniforms = torch.rand(shape, dtype=init.dtype, **kw)
    return hmc_transitions(logpdf, init, momenta, nsteps, uniforms,
                           step_size=step_size, max_leapfrog=max_leapfrog)


def cauchy_logpdf(x: torch.Tensor) -> torch.Tensor:
    """Product of independent standard Cauchy densities: the heavy-tailed
    target of the reference integration test."""
    return -torch.sum(torch.log1p(x * x))


@functools.lru_cache(maxsize=16)
def _eight_schools_data(device: torch.device, dtype: torch.dtype):
    """The schools' effects and standard errors on ``device`` in ``dtype``,
    made once: a tensor made from host data on the card waits for the card
    (a synchronous copy), which every gradient would otherwise do."""
    return (torch.tensor([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0],
                         device=device, dtype=dtype),
            torch.tensor([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0],
                         device=device, dtype=dtype))


def eight_schools_logpdf(params: torch.Tensor) -> torch.Tensor:
    """Non-centered 8-schools posterior, ``params = (mu, log_tau, z_1..z_8)``
    (BASELINE.md config 2); the data follow the device and dtype of
    ``params``."""
    y, sigma = _eight_schools_data(params.device, params.dtype)
    mu, log_tau, z = params[0], params[1], params[2:]
    tau = torch.exp(log_tau)
    theta = mu + tau * z
    lp = -0.5 * torch.sum(((y - theta) / sigma) ** 2)
    lp = lp - 0.5 * torch.sum(z * z)  # z ~ N(0, 1)
    lp = lp - 0.5 * (mu / 5.0) ** 2  # mu ~ N(0, 5)
    # half-normal-ish tau, plus the Jacobian of log_tau
    return lp + (-0.5 * (log_tau / 5.0) ** 2 + log_tau)
