"""Vectorized Geyer initial-monotone-positive-sequence ESS (counterpart of
the JAX package's ``ops/geyer.py``: the static form, and the dynamic form
with a live lag count per column that the windowed MCSEs of the classical
suite use).

The reference walks the lags per parameter, summing pairs
``rho(2t) + rho(2t+1)`` until the first nonpositive pair, with a running-min
clamp and an antithetic tail term (src/ess_rhat.jl:553-601). Here the same
recurrence is masked prefix work over the whole lag axis, batched over every
parameter:

- ``Delta_t = rho(2t) + rho(2t+1)``; the t=0 pair ``1 + rho(1)`` is always
  summed;
- alive(t) = all ``Delta_s > 0`` for 1 <= s <= t (a NaN pair breaks too);
- ``p_t = min(Delta_0, ..., Delta_t)``;
- ``tau = max(0, 2 sum_p + max(0, rho(k_final)) - 1)``, ``k_final`` the first
  even lag after the stop;
- ``ess_rel = min(1/tau, log10(ntotal))``.
"""

from __future__ import annotations

import math

import torch

from ..utils.profiling import annotate


def geyer_ess_from_rho(rho: torch.Tensor, ntotal: int, relative: bool = False):
    """ESS from the autocorrelation curve ``rho`` of shape ``(maxlag+1, P)``,
    ``maxlag >= 1``. Returns ``(P,)``: absolute ESS, or ESS / ntotal when
    ``relative``."""
    with annotate("mdt.geyer"):
        maxlag = rho.shape[0] - 1
        nparams = rho.shape[1]
        if maxlag < 1:
            raise ValueError("maxlag must be >= 1")
        delta0 = 1.0 + rho[1]
        num_pairs = max(0, (maxlag - 2) // 2)
        # lag at loop exit without a break: smallest even >= max(2, maxlag - 1)
        k_nobreak = 2 * ((max(2, maxlag - 1) + 1) // 2)

        if num_pairs > 0:
            t = torch.arange(1, num_pairs + 1, device=rho.device)
            delta = rho[2 * t] + rho[2 * t + 1]  # (T, P)
            positive = delta > 0
            alive = torch.cumprod(positive.to(torch.int32), dim=0).bool()
            p = torch.cummin(torch.cat([delta0[None], delta], dim=0), dim=0).values[1:]
            tail_sum = torch.where(alive, p, 0.0).sum(0)
            # a NaN pair breaks the walk like a nonpositive one and is never
            # summed; NaN reaches the result only through sum_p or rho[k_final]
            stop = (~positive).to(torch.int32)
            broke = stop.any(0)
            t_break = 1 + torch.argmax(stop, dim=0)
            k_final = torch.where(broke, 2 * t_break, k_nobreak)
        else:
            tail_sum = rho.new_zeros(nparams)
            k_final = torch.full((nparams,), 2, dtype=torch.int64, device=rho.device)

        sum_p = delta0 + tail_sum
        if maxlag > 1:
            rho_even = rho.gather(0, k_final[None].to(torch.int64))[0]
        else:
            rho_even = rho.new_zeros(nparams)  # src/ess_rhat.jl:590

        tau = (2.0 * sum_p + rho_even.clamp(min=0.0) - 1.0).clamp(min=0.0)
        ess_rel = torch.minimum(1.0 / tau, torch.full_like(tau, math.log10(ntotal)))
        ess_rel = torch.where(torch.isnan(sum_p) | torch.isnan(rho_even),
                              torch.nan, ess_rel)
        return ess_rel if relative else ess_rel * ntotal


def geyer_ess_from_rho_dynamic(rho: torch.Tensor, ntotal, eff_maxlag,
                               relative: bool = False):
    """Dynamic-length form of :func:`geyer_ess_from_rho`: ``rho`` has shape
    ``(Lmax+1, P)`` but only lags ``0..eff_maxlag`` count; ``ntotal`` and
    ``eff_maxlag`` are scalars or per-column ``(P,)`` values. Equals the
    static reduction of ``rho[:eff_maxlag + 1]`` column by column, so one
    lag curve serves windows of different lengths."""
    lmax = rho.shape[0] - 1
    nparams = rho.shape[1]
    if lmax < 1:
        raise ValueError("rho must cover at least lag 1")
    ntotal = torch.as_tensor(ntotal, dtype=rho.dtype, device=rho.device)
    eff = torch.as_tensor(eff_maxlag, dtype=torch.int64, device=rho.device)
    delta0 = 1.0 + rho[1]
    num_pairs = max(0, (lmax - 2) // 2)
    # without a break the walk exits at the smallest even >= max(2, eff - 1)
    k_nobreak = 2 * ((torch.clamp(eff - 1, min=2) + 1) // 2)

    if num_pairs > 0:
        t = torch.arange(1, num_pairs + 1, device=rho.device)
        # (T, 1) for a scalar eff_maxlag, (T, P) for per-column lengths
        in_range = t[:, None] <= torch.atleast_1d((eff - 2) // 2)[None]
        delta = rho[2 * t] + rho[2 * t + 1]  # (T, P)
        positive = delta > 0
        # pairs past the live length neither break the walk nor add to it
        alive = torch.cumprod((positive | ~in_range).to(torch.int32),
                              dim=0).bool() & in_range
        p = torch.cummin(torch.cat([delta0[None], delta], dim=0), dim=0).values[1:]
        tail_sum = torch.where(alive, p, 0.0).sum(0)
        stop = ((~positive) & in_range).to(torch.int32)
        t_break = 1 + torch.argmax(stop, dim=0)
        k_final = torch.where(stop.any(0), 2 * t_break, k_nobreak)
    else:
        tail_sum = rho.new_zeros(nparams)
        k_final = torch.full((nparams,), 2, dtype=torch.int64, device=rho.device)

    sum_p = delta0 + tail_sum
    rho_even = rho.gather(0, k_final.clamp(0, lmax)[None])[0]
    rho_even = torch.where(eff > 1, rho_even, 0.0)
    tau = (2.0 * sum_p + rho_even.clamp(min=0.0) - 1.0).clamp(min=0.0)
    ess_rel = torch.minimum(1.0 / tau, torch.log10(ntotal))
    ess_rel = torch.where(torch.isnan(sum_p) | torch.isnan(rho_even),
                          torch.nan, ess_rel)
    return ess_rel if relative else ess_rel * ntotal
