"""Plain float64 pieces shared by the references: chain splitting, split-chain
moments, the autocovariance and Geyer's initial monotone sequence, in blocks
of parameters.

Written from the reference's documented conventions (MCMCDiagnosticTools.jl
src/ess_rhat.jl and src/utils.jl; Vehtari et al. 2021, Geyer 1992): the
split-chain remainder rule, ``ddof=1`` chain variances, the ``(n-1)/n``
within-chain weight, the autocovariance by FFT, the pair walk that stops at
the first nonpositive pair with a running minimum, ``maxlag`` clamped to
``niter - 4`` and the ``log10(ntotal)`` cap. Nothing here imports the
program under test.

``lowp`` (a torch dtype or None) is the control: every floating intermediate
that a stage stores is rounded to that dtype and back, as a computation that
keeps its arrays in the lower precision and accumulates in float32 would.
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64
BLOCK_ENTRIES = 1 << 25  # entries of a parameter block (draws x chains x Pb)


def rounder(lowp):
    """The rounding of stored intermediates: identity, or through ``lowp``."""
    if lowp is None:
        return lambda t: t
    return lambda t: t.to(lowp).to(F64)


def param_blocks(nparams: int, per_param: int):
    """``(start, stop)`` slices of the parameter axis, each block holding at
    most ``BLOCK_ENTRIES`` draws x chains entries (at least one parameter)."""
    step = max(1, BLOCK_ENTRIES // max(per_param, 1))
    return [(s, min(s + step, nparams)) for s in range(0, nparams, step)]


def split_chains(x3: torch.Tensor, split: int = 2) -> torch.Tensor:
    """``(draws, chains, P) -> (niter, chains * split, P)``, chain-major:
    column ``c * split + k`` is split ``k`` of chain ``c``; with ``d = draws %
    split`` one draw is skipped after each of the first ``d`` splits."""
    draws, chains = x3.shape[0], x3.shape[1]
    niter, d = divmod(draws, split)
    parts = [x3[k * niter + min(k, d): k * niter + min(k, d) + niter]
             for k in range(split)]
    return torch.stack(parts, dim=2).reshape(niter, chains * split,
                                             *x3.shape[2:])


def chain_moments(s: torch.Tensor, r):
    """Per split chain mean and ``ddof=1`` variance of ``(niter, m, P)``."""
    return r(s.mean(0)), r(s.var(0, unbiased=True))


def rhat_basic(x3: torch.Tensor, split: int = 2, r=rounder(None)):
    """Split R-hat ``sqrt(var_plus / W)`` of ``(draws, chains, P)``."""
    s = split_chains(x3, split)
    niter, m = s.shape[0], s.shape[1]
    cm, cv = chain_moments(s, r)
    w = r(cv.mean(0))
    b = r(cm.var(0, unbiased=True)) if m > 1 else torch.zeros_like(w)
    var_plus = r((niter - 1) / niter * w + b)
    return torch.sqrt(var_plus / w)


def autocov_table(centered: torch.Tensor, nlags: int) -> torch.Tensor:
    """Unnormalised ``sum_i x_i x_(i+k)`` of each series along dim 0, lags
    ``0..nlags-1``, by a real FFT of twice the length."""
    n = centered.shape[0]
    f = torch.fft.rfft(centered, n=2 * n, dim=0)
    return torch.fft.irfft(f.real ** 2 + f.imag ** 2, n=2 * n, dim=0)[:nlags]


def geyer_ess(rho: torch.Tensor, lag_cap: int, ntotal: int) -> torch.Tensor:
    """ESS ``(P,)`` from ``rho`` ``(>= lag_cap + 1, P)``: the pair
    ``1 + rho(1)``, then pairs ``rho(k) + rho(k+1)`` for ``k = 2, 4, ...
    < lag_cap - 1`` until the first that is not positive, each clamped to
    the running minimum; ``tau = max(0, 2 sum + max(0, rho(k_stop)) - 1)``."""
    p0 = 1.0 + rho[1]
    ks = list(range(2, lag_cap - 1, 2))
    if ks:
        k = torch.tensor(ks, device=rho.device)
        delta = rho[k] + rho[k + 1]
        alive = torch.cumprod((delta > 0).to(torch.int64), dim=0).bool()
        run = torch.cummin(torch.cat([p0[None], delta]), dim=0).values[1:]
        sum_p = p0 + torch.where(alive, run, 0.0).sum(0)
        k_stop = 2 + 2 * alive.sum(0)
    else:
        sum_p = p0
        k_stop = torch.full_like(p0, 2, dtype=torch.int64)
    if lag_cap > 1:
        rho_even = rho.gather(0, k_stop[None])[0]
    else:
        rho_even = torch.zeros_like(p0)
    tau = (2.0 * sum_p + rho_even.clamp(min=0.0) - 1.0).clamp(min=0.0)
    ess_rel = torch.minimum(1.0 / tau, torch.full_like(tau, math.log10(ntotal)))
    return ess_rel * ntotal


def ess_rhat_basic(x3: torch.Tensor, maxlag: int = 250, split: int = 2,
                   r=rounder(None)):
    """``(ess, rhat)`` ``(P,)`` of ``(draws, chains, P)`` float64: split
    chains, moments, autocovariance, Geyer."""
    s = split_chains(x3, split)
    niter, m = s.shape[0], s.shape[1]
    ntotal = niter * m
    lag_cap = min(maxlag, niter - 4)
    cm, cv = chain_moments(s, r)
    w = r(cv.mean(0))
    b = r(cm.var(0, unbiased=True)) if m > 1 else torch.zeros_like(w)
    var_plus = r((niter - 1) / niter * w + b)
    rhat = torch.sqrt(var_plus / w)
    if niter <= 4:
        return torch.full_like(rhat, math.nan), rhat
    table = r(autocov_table(r(s - cm[None]), lag_cap + 1))
    acov = r((table / table[0:1] * cv[None]).mean(1) * ((niter - 1) / niter))
    rho = r(1.0 - (w[None] - acov) / var_plus[None])
    return geyer_ess(rho, lag_cap, ntotal), rhat
