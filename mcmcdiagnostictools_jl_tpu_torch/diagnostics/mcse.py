"""Monte Carlo standard error (counterpart of the JAX package's
``diagnostics/mcse.py``; reference mcse.jl):

- ``kind="mean"``: ``std / sqrt(ESS_mean)`` (src/mcse.jl:45-51);
- ``kind="std"``: the delta method on the proxy ``(x - mean)^2``,
  ``sqrt((E[mu4]/E[var] - E[var]) / S) / 2`` (src/mcse.jl:52-65);
- ``kind="median"`` / ``Quantile(p)``: the Beta(S p + 1, S (1-p) + 1) error
  distribution at normcdf(-1) and normcdf(+1), mapped through the inverse
  ECDF, ``(x_u - x_l) / 2`` (src/mcse.jl:96-118). The exact mode reads the
  order statistics off one sort; ``rank_mode="fast"`` off two histograms (a
  coarse one, then one zoomed onto the interval);
- any callable: the subsampling bootstrap (SBM) over overlapping windows of
  ``batch_size`` draws (default ``floor(sqrt(draws * chains))``) of the
  chain-major flattened sample, scaled by ``sqrt(b / n)``
  (src/mcse.jl:120-148).

Both rank modes take the same ESS keywords (``_ESS_KWARGS``) and raise
``TypeError`` for any other (the JAX package's fast quantile path took
fewer, ROADMAP.md fault C2). The Beta quantiles are computed in float64
(ops/special.py), and so are the ranks ``l`` and ``u``.
"""

from __future__ import annotations

import math

import torch

from ..ops.fastrank import (
    DEFAULT_NBINS,
    build_hist_cdf,
    hist_quantile,
    hist_rank_value,
)
from ..ops.ranknorm import (_flatten_sample, _has_nan_cols, _nan_rows,
                             _rows, sort_rows_keys, sorted_quantile)
from ..ops.special import betaincinv
from ..utils.layout import maybe_scalar
from .ess_rhat import (
    Quantile,
    _canonical_input,
    _check_rank_mode,
    _ess_array,
    _indicator_leq,
    _warn_short,
    basic_ess_rhat,
    check_maxlag,
    method_name,
)

# standard normal CDF at +1 / -1 (reference src/mcse.jl:1-2)
_NORMCDF1 = 0.8413447460685429
_NORMCDFN1 = 0.15865525393145705

# the keywords mcse forwards to the ESS computation, in both rank modes
_ESS_KWARGS = frozenset({"split_chains", "maxlag", "relative",
                         "autocov_method", "rank_mode", "rank_nbins"})

# the SBM evaluates the estimator on as many windows at once as keep one
# batch of window values (windows x params x batch_size) near this size
_SBM_BATCH_BYTES = 256 * 2**20


def mcse(samples, *, kind="mean", batch_size: int | None = None,
         device=None, **ess_kwargs):
    """MCSE of the estimator ``kind`` on ``samples`` shaped
    ``(draws[, chains[, params...]])``.

    ``kind``: ``"mean"`` (default), ``"std"``, ``"median"``,
    ``Quantile(p)``, or a callable (the SBM fallback, which takes only
    ``batch_size``; the callable receives 1-d tensors and must work under
    ``torch.func.vmap``). ``ess_kwargs`` go to the ESS computation:
    ``split_chains``, ``maxlag``, ``relative``, ``autocov_method``,
    ``rank_mode`` and ``rank_nbins``. Outputs and devices as in ``ess``.
    """
    x3, pshape = _canonical_input(samples, device)
    if callable(kind) and not isinstance(kind, Quantile):
        if ess_kwargs:
            raise TypeError("the SBM fallback only accepts `batch_size`; got "
                            f"extra kwargs {sorted(ess_kwargs)}")
        return maybe_scalar(_mcse_sbm(x3, kind, batch_size), pshape)
    if batch_size is not None:
        raise TypeError("`batch_size` only applies to the SBM (callable) "
                        "fallback")
    unknown = set(ess_kwargs) - _ESS_KWARGS
    if unknown:
        raise TypeError(f"unexpected mcse kwargs: {sorted(unknown)}")
    if kind == "mean":
        return maybe_scalar(_mcse_mean(x3, ess_kwargs), pshape)
    if kind == "std":
        return maybe_scalar(_mcse_std(x3, ess_kwargs), pshape)
    if kind == "median":
        return maybe_scalar(_mcse_quantile(x3, 0.5, ess_kwargs), pshape)
    if isinstance(kind, Quantile):
        return maybe_scalar(_mcse_quantile(x3, float(kind.p), ess_kwargs),
                            pshape)
    raise ValueError(f"the `kind` `{kind!r}` is not supported by `mcse`")


def _mcse_mean(x3, ess_kwargs):
    s = _ess_array(x3, "mean", None, **ess_kwargs)
    n = x3.shape[0] * x3.shape[1]
    c = x3 - x3.mean((0, 1), keepdim=True)
    std = torch.sqrt((c * c).sum((0, 1)) / (n - 1))
    return std / torch.sqrt(s)


def _mcse_std(x3, ess_kwargs):
    x2 = (x3 - x3.mean((0, 1), keepdim=True)) ** 2  # the std proxy
    s = _ess_array(x2, "mean", None, **ess_kwargs)
    mean_var = x2.mean((0, 1))
    mean_moment4 = (x2 * x2).mean((0, 1))
    return torch.sqrt((mean_moment4 / mean_var - mean_var) / s) / 2.0


def _beta_interval_ranks(s_eff, p: float, n: int):
    """1-based ranks ``(l, u)`` of the order statistics that bound the Beta
    error interval (src/mcse.jl:106-112), float64 ``(P,)``; 1 where the ESS
    is NaN (those columns are masked by the caller)."""
    s64 = s_eff.double()
    alpha = s64 * p + 1.0
    beta = s64 * (1.0 - p) + 1.0
    prob_lower = betaincinv(alpha, beta, _NORMCDFN1)
    prob_upper = betaincinv(alpha, beta, _NORMCDF1)
    l = torch.nan_to_num(torch.floor(prob_lower * n), nan=1.0).clamp(1, n)
    u = torch.nan_to_num(torch.ceil(prob_upper * n), nan=1.0).clamp(1, n)
    return l, u


def _mcse_quantile(x3, p: float, ess_kwargs):
    if ess_kwargs.get("rank_mode", "exact") == "fast":
        return _mcse_quantile_fast(x3, p, **ess_kwargs)
    return _mcse_quantile_exact(x3, p, **ess_kwargs)


def _mcse_quantile_exact(x3, p: float, *, split_chains: int = 2,
                         maxlag: int = 250, relative: bool = False,
                         autocov_method="auto", rank_mode: str = "exact",
                         rank_nbins: int = DEFAULT_NBINS):
    """One sort gives both the proxy's threshold (the type-7 quantile, as
    ``ess(kind=Quantile(p))`` takes it) and the order statistics ``x_l``,
    ``x_u``."""
    del rank_nbins
    _check_rank_mode(rank_mode)
    check_maxlag(maxlag)
    niter = x3.shape[0] // split_chains
    if niter <= 4:
        _warn_short(niter)
        return torch.full((x3.shape[2],), torch.nan, dtype=x3.dtype,
                          device=x3.device)
    xs = sort_rows_keys(_rows(x3))  # (P, N), NaNs at the ends
    bad = _nan_rows(xs)
    thr = torch.where(bad, torch.nan, sorted_quantile(xs, p))
    s_eff, _ = basic_ess_rhat(_indicator_leq(x3, thr), split_chains,
                              min(maxlag, niter - 4),
                              method_name(autocov_method), relative)
    l, u = _beta_interval_ranks(s_eff, p, xs.shape[1])
    x_l = xs.gather(1, (l.long() - 1)[:, None])[:, 0]
    x_u = xs.gather(1, (u.long() - 1)[:, None])[:, 0]
    out = (x_u - x_l) / 2.0
    return torch.where(torch.isnan(s_eff) | bad, torch.nan, out)


def _mcse_quantile_fast(x3, p: float, *, split_chains: int = 2,
                        maxlag: int = 250, relative: bool = False,
                        autocov_method="auto", rank_mode: str = "fast",
                        rank_nbins: int = DEFAULT_NBINS):
    """Sort-free quantile MCSE: one coarse histogram CDF gives the proxy's
    threshold and the bins that cover ranks ``l`` and ``u``; a second
    histogram over just those bins (one coarse bin of padding on each side,
    per column) inverts both ranks at ``nbins`` times the resolution. The
    output ``(x_u - x_l) / 2`` is a difference of nearby order statistics,
    so one coarse inversion alone would carry an error of order one bin over
    the interval width; the zoom leaves about interval / nbins."""
    del rank_mode
    check_maxlag(maxlag)
    niter = x3.shape[0] // split_chains
    if niter <= 4:
        _warn_short(niter)
        return torch.full((x3.shape[2],), torch.nan, dtype=x3.dtype,
                          device=x3.device)
    nbins = rank_nbins
    xf = _flatten_sample(x3).contiguous()
    n = xf.shape[0]
    cdf = build_hist_cdf(xf, nbins)
    thr = hist_quantile(cdf, (p,), nbins)[0]
    s_eff, _ = basic_ess_rhat(_indicator_leq(x3, thr), split_chains,
                              min(maxlag, niter - 4),
                              method_name(autocov_method), relative)
    l, u = _beta_interval_ranks(s_eff, p, n)
    # coarse pass: the element of rank h lies in the bin with
    # cum + 1/2 <= h, the last such bin
    width = (cdf.hi - cdf.lo) / nbins
    k_l = ((cdf.cum + 0.5 <= l[None, :]).sum(0) - 1).clamp(0, nbins - 1)
    k_u = ((cdf.cum + 0.5 <= u[None, :]).sum(0) - 1).clamp(0, nbins - 1)
    lo_z = torch.nan_to_num(torch.maximum(cdf.lo + (k_l - 1) * width, cdf.lo))
    hi_z = torch.nan_to_num(torch.minimum(cdf.lo + (k_u + 2) * width, cdf.hi))
    # zoom pass: elements outside the range clip into the boundary bins,
    # which keeps every rank inside it exact
    cdf_z = build_hist_cdf(xf, nbins, minmax=(lo_z, hi_z, cdf.bad))
    out = (hist_rank_value(cdf_z, u, nbins)
           - hist_rank_value(cdf_z, l, nbins)) / 2.0
    return torch.where(torch.isnan(s_eff) | cdf.bad, torch.nan, out)


def _mcse_sbm(x3, f, batch_size: int | None):
    """Subsampling bootstrap MCSE of an arbitrary estimator ``f``
    (src/mcse.jl:120-148). ``f`` gets 1-d windows of the chain-major
    flattened sample (the draws of chain 0, then chain 1, ...) and returns
    a 0-d tensor; it runs under ``torch.func.vmap`` over parameters and over
    a batch of windows, and an ``f`` that vmap cannot trace raises."""
    ndraws, nchains, nparams = x3.shape
    n = ndraws * nchains
    b = math.isqrt(n) if batch_size is None else int(batch_size)
    if not 0 < b <= n:
        raise ValueError("batch_size must be in [1, draws*chains]")
    flat = x3.permute(1, 0, 2).reshape(n, nparams)  # Julia's vec() order
    windows = flat.unfold(0, b, 1)  # (n - b + 1, P, b), a view
    stat = torch.func.vmap(torch.func.vmap(f))
    per = max(1, _SBM_BATCH_BYTES // (nparams * b * flat.element_size()))
    vals = torch.cat([stat(windows[i:i + per])
                      for i in range(0, windows.shape[0], per)])
    var = ((vals - vals.mean(0, keepdim=True)) ** 2).mean(0)  # ddof = 0
    out = torch.sqrt(var * (b / n))
    # all-equal slices and NaN slices give NaN (src/mcse.jl:136-142)
    bad = (flat == flat[:1]).all(0) | _has_nan_cols(flat)
    return torch.where(bad, torch.nan, out)
