"""Batched classical diagnostics over ``(draws, chains[, params...])``
(counterpart of the JAX package's ``diagnostics/batch.py``).

The reference's Geweke, Heidelberger-Welch and Raftery-Lewis functions take
one chain at a time. These functions run every (chain, parameter) series at
once, as columns of an ``(n, S)`` series matrix (series ``chain * P +
param``), and return results shaped ``(chains, *params)`` on the sample's
device:

- Geweke: the two windows' means and single-chain (``split_chains=1``)
  mean-MCSEs in one call of ``_window_mcse_mean``;
- Heidelberger-Welch: the burn-in candidates form a fixed list (starts 1,
  1 + delta, ... below n/2), so every candidate's mean, MCSE and Cramer-von
  Mises p-value is computed, and each series takes its first converged
  candidate;
- Raftery-Lewis: dichotomy, pattern counts, G^2 and BIC for all series at
  once on the device, in one host loop over thinning factors.

``_window_mcse_mean`` builds the masked, centred ``(n, W, S)`` stack of all
windows and hands it to the direct autocovariance estimator as one
``(n, 1, W S)`` sample (kernel K5 on a CUDA tensor): masking makes the lag
sums of the zero-padded series exactly the window's own, and the dynamic
Geyer reduction clamps each window's ``maxlag`` to its length minus 4.
"""

from __future__ import annotations

import math
import warnings

import torch
from scipy.special import erfcinv, erfinv  # host-side scalar constants

from ..kernels.autocov import direct_autocov
from ..ops.geyer import geyer_ess_from_rho_dynamic
from ..ops.special import pcramer
from .ess_rhat import _canonical_input
from .mcse import mcse


def _series_matrix(samples: torch.Tensor):
    """The ``(n, S)`` series matrix of a ``(draws, chains[, params...])``
    tensor and the output shape ``(chains, *pshape)``."""
    x3, pshape = _canonical_input(samples, None, min_ndim=2)
    d, c, p = x3.shape
    return x3.reshape(d, c * p), (c,) + pshape


def _mcse_series(windows: torch.Tensor, **mcse_kwargs) -> torch.Tensor:
    """Mean-MCSE of each column of ``(m, S)`` as one chain (split_chains=1):
    the route for MCSE keywords other than ``maxlag`` and for windows of 4
    draws or fewer."""
    return mcse(windows[:, None, :], split_chains=1, **mcse_kwargs)


def _masked_window_stack(flat: torch.Tensor, windows):
    """The ``(n, 1, W S)`` sample that the direct estimator reads for the
    windows ``flat[a:b]`` of ``(n, S)``, and the windows' means ``(W, S)``:
    window w's centred draws in rows a..b-1 of column block w, 0 elsewhere
    (the ``(n, W, S)`` stack as one sample, without a copy)."""
    n, nser = flat.shape
    z = flat.new_zeros((n, len(windows), nser))
    means = []
    for w, (a, b) in enumerate(windows):
        means.append(flat[a:b].mean(0))
        z[a:b, w] = flat[a:b] - means[-1]
    return z.view(n, 1, len(windows) * nser), torch.stack(means)


def _window_mcse_mean(flat: torch.Tensor, windows, maxlag: int = 250):
    """Single-chain mean-MCSE, mean and ESS of the windows ``flat[a:b]``,
    ``(a, b)`` in ``windows`` (host ints, each longer than 4 draws), every
    series at once: ``(mcse, mean, ess)``, each ``(W, S)``."""
    n, nser = flat.shape
    nwin = len(windows)
    m = torch.tensor([b - a for a, b in windows], dtype=flat.dtype,
                     device=flat.device)
    z, mean = _masked_window_stack(flat, windows)
    # unnormalised lag sums c_k = sum_i z_i z_{i+k} of every window
    c = direct_autocov(z, maxlag)[:, 0] * n
    del z
    c = c.reshape(maxlag + 1, nwin, nser)
    acov = c / m[None, :, None]
    var = c[0] / (m[:, None] - 1.0)  # single chain: W = chain variance
    var_plus = (m[:, None] - 1.0) / m[:, None] * var
    rho = (1.0 - (var[None] - acov) / var_plus[None]).reshape(
        maxlag + 1, nwin * nser)
    eff = torch.tensor([min(maxlag, b - a - 4) for a, b in windows],
                       device=flat.device)
    # window-major columns, as the stack's reshape orders them
    ess = geyer_ess_from_rho_dynamic(
        rho, m.repeat_interleave(nser), eff.repeat_interleave(nser),
    ).reshape(nwin, nser)
    return torch.sqrt(var) / torch.sqrt(ess), mean, ess


def _cvm(yt: torch.Tensor, ybar: torch.Tensor, s0) -> torch.Tensor:
    """Cramer-von Mises statistic of the suffix ``yt``, draws along the last
    axis (``([S,] m)``): the mean square of its Brownian bridge
    ``cumsum(y - ybar)`` over ``m * s0`` (src/heideldiag.jl:30-33). The
    scan runs along the contiguous axis: along an outer one PyTorch gives
    each column one thread (13 ms for 800 columns of 10k draws on an H100)."""
    m = yt.shape[-1]
    bridge = torch.cumsum(yt - ybar[..., None], dim=-1)
    return (bridge * bridge).sum(-1) / (m * s0) / m


def _geweke_windows(n: int, first: float, last: float):
    """0-based ``(stop1, start2)``: ``x[:stop1]`` and ``x[start2:]``, with
    Julia's round-half-to-even (Python's ``round`` on host numbers)."""
    return round(first * n), round(n - last * n + 1) - 1


def gewekediag_batch(samples, *, first: float, last: float, **mcse_kwargs):
    """``(zscore, pvalue)`` of every series, each ``(chains, *params)``."""
    flat, out_shape = _series_matrix(samples)
    n = flat.shape[0]
    stop1, start2 = _geweke_windows(n, first, last)
    if set(mcse_kwargs) <= {"maxlag"} and min(stop1, n - start2) > 4:
        s, m, _ = _window_mcse_mean(flat, [(0, stop1), (start2, n)],
                                    mcse_kwargs.get("maxlag", 250))
        (s1, s2), (m1, m2) = s, m
    else:
        s1 = _mcse_series(flat[:stop1], **mcse_kwargs)
        s2 = _mcse_series(flat[start2:], **mcse_kwargs)
        m1, m2 = flat[:stop1].mean(0), flat[start2:].mean(0)
    z = (m1 - m2) / torch.hypot(s1, s2)
    p = torch.special.erfc(z.abs() / math.sqrt(2.0))
    return z.reshape(out_shape), p.reshape(out_shape)


def _heidel_starts(n: int):
    """1-based burn-in candidates ``1, 1 + delta, ...`` below ``n/2`` and the
    loop's exit value (the burn-in when no candidate converges,
    src/heideldiag.jl:25-39); ``delta = int(n/10)``, which must be >= 1."""
    delta = int(0.10 * n)
    if delta < 1:
        raise ValueError(f"heideldiag needs at least 10 draws, got {n}")
    starts = list(range(1, math.ceil(n / 2), delta))
    return starts, starts[-1] + delta


def _heidel_windows(n: int, starts):
    """The scan's windows as 0-based ``(a, b)``: the second half (> 4 draws),
    whose MCSE sizes the Brownian bridge, then each candidate's suffix."""
    return [(int(n / 2) - 1, n)] + [(i - 1, n) for i in starts]


def heideldiag_batch(samples, *, alpha: float, eps: float, start: int,
                     **mcse_kwargs):
    """``(burnin, stationarity, pvalue, mean, halfwidth, test)`` of every
    series, each ``(chains, *params)``."""
    flat, out_shape = _series_matrix(samples)
    n = flat.shape[0]
    starts, i_exit = _heidel_starts(n)
    windows = _heidel_windows(n, starts)
    half = windows[0][0]
    cands = [a for a, _ in windows[1:]]
    if set(mcse_kwargs) <= {"maxlag"}:
        # every suffix window's MCSE and mean in one masked stack
        s, mean, _ = _window_mcse_mean(flat, windows,
                                       mcse_kwargs.get("maxlag", 250))
        s_half, mcse_c, ybars = s[0], s[1:], mean[1:]
    else:
        s_half = _mcse_series(flat[half:], **mcse_kwargs)
        mcse_c = torch.stack([_mcse_series(flat[a:], **mcse_kwargs)
                              for a in cands])
        ybars = torch.stack([flat[a:].mean(0) for a in cands])
    s0 = (n - half) * s_half ** 2
    # one suffix's Brownian bridge at a time (<= 5), not a (W, n, S) stack
    series = flat.t().contiguous()
    pvals = 1.0 - pcramer(torch.stack(
        [_cvm(series[:, a:], ybars[k], s0) for k, a in enumerate(cands)]))
    del series

    converged = pvals > alpha  # (W, S)
    has_conv = converged.any(0)
    sel = torch.where(has_conv, converged.to(torch.int32).argmax(0),
                      len(starts) - 1)[None]
    pvalue, ybar = pvals.gather(0, sel)[0], ybars.gather(0, sel)[0]
    halfwidth = math.sqrt(2.0) * float(erfcinv(alpha)) * mcse_c.gather(0, sel)[0]
    starts_t = torch.tensor(starts, device=flat.device)
    burnin = torch.where(has_conv, starts_t[sel[0]], i_exit) + start - 2
    passed = halfwidth / ybar.abs() <= eps
    return tuple(v.reshape(out_shape) for v in
                 (burnin, has_conv, pvalue, ybar, halfwidth, passed))


def quantile_f64(flat: torch.Tensor, q: float) -> torch.Tensor:
    """numpy's default (type-7, "linear") ``q``-quantile of each column of
    ``(n, S)``, in float64 with numpy's two-sided interpolation, so a
    threshold equals ``np.quantile``'s to the bit (NaN where the column
    holds one). ``torch.quantile`` refuses more than 2^24 elements; the two
    order statistics come from a partial sort of the nearer side
    (``topk``), which at 10k x 32,768 took a third of a full sort's time
    and a hundredth of its memory on an H100."""
    n = flat.shape[0]
    h = (n - 1) * q
    lo = min(math.floor(h), n - 1)
    hi = min(lo + 1, n - 1)
    gamma = h - lo
    if hi < n - lo:  # the hi + 1 smallest, ascending
        xs = torch.topk(flat, hi + 1, dim=0, largest=False).values
        a, b = xs[lo], xs[hi]
    else:  # the n - lo largest, descending
        xs = torch.topk(flat, n - lo, dim=0, largest=True).values
        a, b = xs[n - 1 - lo], xs[n - 1 - hi]
    a, b = a.double(), b.double()
    diff = b - a
    thr = b - diff * (1.0 - gamma) if gamma >= 0.5 else a + diff * gamma
    return torch.where(torch.isnan(flat).any(0), torch.nan, thr)


def rafterydiag_batch(samples, *, q: float, r: float, s: float, eps: float,
                      range_start: int, range_step: int):
    """``(thinning, burnin, total, nmin, dependencefactor)`` of every series,
    each ``(chains, *params)``, float64 (``nmin`` int64). Thresholds, G^2
    and BIC are float64; a series that no thinning factor passes before the
    thinned chain has <= 4 draws gets NaN."""
    flat, out_shape = _series_matrix(samples)
    n, nser = flat.shape
    f64 = dict(dtype=torch.float64, device=flat.device)
    # the normal quantile of (1 + s)/2 and the draws an independent chain
    # needs (src/rafterydiag.jl:29-35)
    phi = math.sqrt(2.0) * float(erfinv(s))
    nmin = math.ceil(q * (1.0 - q) * (phi / r) ** 2)
    nmin_t = torch.full(out_shape, nmin, dtype=torch.int64, device=flat.device)
    if nmin > n:
        warnings.warn(
            f"At least {nmin} samples are needed for specified q, r, and s")
        nan = torch.full(out_shape, torch.nan, **f64)
        return (torch.full(out_shape, -1.0, **f64), nan, nan.clone(), nmin_t,
                nan.clone())

    dichot = (flat <= quantile_f64(flat, q)).to(torch.uint8)  # in float64

    kthin_res = torch.zeros(nser, dtype=torch.int64, device=flat.device)
    alpha = torch.full((nser,), torch.nan, **f64)
    beta = torch.full((nser,), torch.nan, **f64)
    active = torch.ones(nser, dtype=torch.bool, device=flat.device)
    kthin = 0
    while True:
        kthin += 1
        test = dichot[::kthin]
        ntest = test.shape[0]
        if ntest <= 4:
            break  # the stragglers stay NaN
        # 3-step patterns t0 + 2 t1 + 4 t2 counted per series: (8, S)
        pat = (test[:-2] + 2 * test[1:-1] + 4 * test[2:]).long()
        counts = torch.zeros((8, nser), **f64).scatter_add_(
            0, pat, torch.ones((), **f64).expand(pat.shape))
        # trantest[i1, i2, i3] = counts[i1 + 2 i2 + 4 i3] (src/rafterydiag.jl:44-47)
        tran = counts.reshape(2, 2, 2, nser).permute(2, 1, 0, 3)
        fitted = (tran.sum(0, keepdim=True) * tran.sum(2, keepdim=True)
                  / tran.sum((0, 2), keepdim=True))
        g2 = torch.where(tran > 0, 2.0 * tran * torch.log(tran / fitted),
                         0.0).sum((0, 1, 2))
        bic = g2 - 2.0 * math.log(ntest - 2.0)
        done = active & (bic < 0.0)
        # 2-step transition counts: the 3-step patterns' first pairs plus
        # the last pair
        tf = counts[:4] + counts[4:]
        last = (test[-2] + 2 * test[-1]).long()[None]
        tf.scatter_add_(0, last, torch.ones((), **f64).expand(last.shape))
        kthin_res = torch.where(done, kthin, kthin_res)
        alpha = torch.where(done, tf[2] / (tf[0] + tf[2]), alpha)
        beta = torch.where(done, tf[1] / (tf[1] + tf[3]), beta)
        active &= ~done
        if not bool(active.any()):  # the loop's one host sync
            break

    kthin_eff = torch.where(kthin_res > 0,
                            (kthin_res * range_step).to(torch.float64), torch.nan)
    m = torch.log(eps * (alpha + beta) / torch.maximum(alpha, beta)) / torch.log(
        (1.0 - alpha - beta).abs())
    burnin = kthin_eff * torch.ceil(m) + range_start - 1
    ntot = ((2.0 - alpha - beta) * alpha * beta * phi ** 2) / (
        r ** 2 * (alpha + beta) ** 3)
    total = (burnin + kthin_eff * torch.ceil(ntot)).reshape(out_shape)
    # a tensor divisor, the correctly rounded quotient on either device (a
    # Python-scalar divisor may become a multiply by its reciprocal)
    return (kthin_eff.reshape(out_shape), burnin.reshape(out_shape), total,
            nmin_t, total / nmin_t)
