"""ESS and R-hat, the flagship diagnostics (counterpart of the JAX package's
``diagnostics/ess_rhat.py``).

Split chains -> per-chain moments -> autocovariance -> Geyer, batched over
the parameter axis. Kinds (reference src/ess_rhat.jl:276-311, 335-349,
438-455, 604-624):

- ``rhat``: ``"rank"`` (default) = max of bulk and tail, ``"bulk"`` = basic
  on rank-normalized draws, ``"tail"`` = bulk of draws folded around the
  median, ``"basic"`` = classic split-R-hat;
- ``ess``: ``"bulk"`` (default), ``"tail"`` (min of the quantile ESS at
  ``tail_prob/2`` and ``1 - tail_prob/2``), ``"basic"``, or an estimator:
  ``"mean"``, ``"median"``, ``"std"``, ``"mad"``, ``Quantile(p)``;
- ``ess_rhat``: ``"rank"`` (bulk ESS, max(bulk, tail) R-hat), ``"bulk"``,
  ``"tail"``, ``"basic"``.

Estimator-ESS proxies (src/ess_rhat.jl:626-659): mean -> x, median ->
indicator(x <= median), std -> (x - mean)^2, mad -> the median proxy of the
folded draws, quantile(p) -> indicator(x <= quantile_p).

``rank_mode="exact"`` ranks with ``torch.sort``; ``"fast"`` uses the
histogram CDF (ops/fastrank.py) for the rank transforms and for every
median/quantile threshold. On a CUDA float32 tensor the fused moments +
autocovariance (or, with ``DirectKernelAutocovMethod``, the direct
autocovariance alone) and the fast rank transform run the hand-written
kernels (kernels/); on a CPU tensor their plain versions.

Numeric contracts: the split-chain remainder-discard rule, the ``(n-1)/n``
correction, the ``corrected=(nchains>1)`` guard, the ``min(1/tau,
log10(ntotal))`` cap, ``maxlag`` clamped to ``niter - 4``, and NaN ESS with
a warning (R-hat still computed) when ``niter <= 4``.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple

import torch

from .. import backend
from ..ops.autocov import mean_autocov_curve
from ..ops.fastrank import (
    DEFAULT_NBINS,
    _fold,
    _folded_cdf,
    build_hist_cdf,
    fast_rank_bulk_tail,
    fast_rank_fold,
    fast_rank_normalize,
    hist_quantile,
)
from ..ops.geyer import geyer_ess_from_rho
from ..ops.moments import chain_stats, fused_chain_stats_autocov
from ..ops.ranknorm import (
    batched_median,
    batched_quantile,
    fold_around_median,
    folded_rank_normalize,
    rank_normalize,
    rank_normalize_from_sort,
    sort_with_positions,
    sorted_quantile,
)
from ..utils.layout import canonicalize, maybe_scalar
from ..utils.split import split_chains_reshape


class ESSRhat(NamedTuple):
    ess: object
    rhat: object


@dataclass(frozen=True)
class AutocovMethod:
    """Direct biased Geyer autocovariance estimator (reference
    src/ess_rhat.jl:22-38,161-179) on the centered split chains, after the
    moments in PyTorch: kernel K5 on a CUDA tensor, its plain version on a
    CPU tensor."""

    name: str = "direct"


@dataclass(frozen=True)
class FFTAutocovMethod:
    """Batched real-FFT autocovariance estimator (reference
    src/ess_rhat.jl:40-55,103-118,181-195)."""

    name: str = "fft"


@dataclass(frozen=True)
class BDAAutocovMethod:
    """BDA3 variogram autocovariance estimator (reference
    src/ess_rhat.jl:57-73,197-213)."""

    name: str = "bda"


@dataclass(frozen=True)
class KernelAutocovMethod:
    """The direct estimator fused with the chain moments in one read of the
    sample: kernel K1 on a CUDA tensor, its plain version on a CPU tensor.
    What ``autocov_method="auto"`` selects; numerically ``AutocovMethod``."""

    name: str = "kernel"


@dataclass(frozen=True)
class DirectKernelAutocovMethod:
    """The counterpart of the JAX package's ``PallasAutocovMethod``: another
    name for ``AutocovMethod``, which already runs kernel K5 on a CUDA
    tensor."""

    name: str = "direct_kernel"


@dataclass(frozen=True)
class Quantile:
    """Estimator marker for quantile ESS / quantile MCSE, the analogue of the
    reference's ``Base.Fix2(Statistics.quantile, p)``."""

    p: float

    def __post_init__(self):
        if not 0 < self.p < 1:
            raise ValueError("quantile probability must be in (0, 1)")


_SYMBOL_KINDS_ESS = ("bulk", "tail", "basic")
_ESTIMATOR_KINDS = ("mean", "median", "std", "mad")
_PROXY_KINDS = _ESTIMATOR_KINDS + ("quantile",)
_RHAT_KINDS = ("rank", "bulk", "tail", "basic")
_MARKERS = (AutocovMethod, FFTAutocovMethod, BDAAutocovMethod,
            KernelAutocovMethod, DirectKernelAutocovMethod)


def _method_name(autocov_method):
    if isinstance(autocov_method, _MARKERS):
        return autocov_method.name
    if autocov_method == "auto":
        return "kernel"
    if isinstance(autocov_method, str) or callable(autocov_method):
        return autocov_method
    raise TypeError(f"unsupported autocov_method: {autocov_method!r}")


def _indicator_leq(x3, threshold):
    """Float indicator of ``x <= threshold``, NaN where the threshold is."""
    y = (x3 <= threshold[None, None, :]).to(x3.dtype)
    return torch.where(torch.isnan(threshold)[None, None, :], torch.nan, y)


def _expectand_proxy(estimator: str, x3, q: float | None):
    """The series whose ESS is the estimator's (src/ess_rhat.jl:626-659),
    thresholds from one sort."""
    if estimator == "mean":
        return x3
    if estimator == "median":
        return _indicator_leq(x3, batched_median(x3))
    if estimator == "std":
        return (x3 - x3.mean((0, 1), keepdim=True)) ** 2
    if estimator == "mad":
        folded = fold_around_median(x3)
        return _indicator_leq(folded, batched_median(folded))
    if estimator == "quantile":
        return _indicator_leq(x3, batched_quantile(x3, q))
    raise ValueError(f"the estimator {estimator!r} is not supported by `ess`")


def _fast_expectand_proxy(estimator: str, x3, q: float | None, nbins: int):
    """The same proxies with every median/quantile threshold read off the
    histogram CDF (one bin width from the sorted value, which moves only
    the boundary elements of the 0/1 indicator); mean and std never sort."""
    if estimator in ("mean", "std"):
        return _expectand_proxy(estimator, x3, q)
    d, c, p = x3.shape
    xf = x3.reshape(d * c, p).contiguous()
    cdf = build_hist_cdf(xf, nbins)
    if estimator == "median":
        return _indicator_leq(x3, hist_quantile(cdf, (0.5,), nbins)[0])
    if estimator == "quantile":
        return _indicator_leq(x3, hist_quantile(cdf, (q,), nbins)[0])
    if estimator == "mad":
        med = hist_quantile(cdf, (0.5,), nbins)[0]
        fcdf = _folded_cdf(xf, cdf, med, nbins)
        folded = _fold(xf, med)  # the indicator needs the fold itself
        med_f = torch.where(cdf.bad, torch.nan,
                            hist_quantile(fcdf, (0.5,), nbins)[0])
        return _indicator_leq(folded.reshape(d, c, p), med_f)
    raise ValueError(f"the estimator {estimator!r} is not supported by `ess`")


# First-stage lag budget of the adaptive Geyer walk. The reference's loop
# stops at the first nonpositive lag pair (src/ess_rhat.jl:563-581). The
# fused path computes lags 0.._ADAPTIVE_L0 first; if every series' walk
# provably stopped inside that window, the result equals the full
# computation's and the remaining lags are never computed.
_ADAPTIVE_L0 = 64


def _geyer_walk_stopped(rho):
    """(P,) True where the pair walk stops within ``rho``'s lags: some pair
    ``rho[2t] + rho[2t+1]`` is nonpositive or NaN."""
    lmax = rho.shape[0] - 1
    num_pairs = max(0, (lmax - 2) // 2)
    if num_pairs == 0:
        return torch.zeros(rho.shape[1], dtype=torch.bool, device=rho.device)
    delta = rho[2:2 + 2 * num_pairs:2] + rho[3:3 + 2 * num_pairs:2]
    return (~(delta > 0)).any(0)


def _basic_ess_rhat(x3, split_chains: int, maxlag: int, method,
                    relative: bool):
    """Split -> moments -> autocov curve -> rho -> Geyer on (draws, C, P)
    (reference ``_ess_rhat_basic!``, src/ess_rhat.jl:488-602)."""
    samples = split_chains_reshape(x3, split_chains)
    niter, nchains, _ = samples.shape
    ntotal = niter * nchains
    if method == "kernel":

        def stats_rho(lag):
            stats, acov = fused_chain_stats_autocov(samples, lag)
            rho = 1.0 - (stats.w[None] - acov) / stats.var_plus[None]
            return stats, rho

        if maxlag >= 2 * _ADAPTIVE_L0:
            stats0, rho0 = stats_rho(_ADAPTIVE_L0)
            # host branch: one device-to-host sync per call
            if bool(_geyer_walk_stopped(rho0).all()):
                return geyer_ess_from_rho(rho0, ntotal, relative), stats0.rhat
        stats, rho = stats_rho(maxlag)
        return geyer_ess_from_rho(rho, ntotal, relative), stats.rhat
    stats = chain_stats(samples)
    centered = samples - stats.chain_mean[None]
    acov = mean_autocov_curve(centered, stats.chain_var, maxlag, method)
    rho = 1.0 - (stats.w[None] - acov) * (1.0 / stats.var_plus)[None]
    return geyer_ess_from_rho(rho, ntotal, relative), stats.rhat


def _basic_rhat(x3, split_chains: int):
    return chain_stats(split_chains_reshape(x3, split_chains)).rhat


def _tail_rhat_exact(xs, order, med, bad, shape3, split_chains: int):
    """Tail R-hat: rank-normal ``|x - med|`` scattered back to (draw, chain)
    order, then split-chain moments (reference src/ess_rhat.jl:413-415)."""
    zf = folded_rank_normalize(xs, order, med, shape3)
    return torch.where(bad, torch.nan, _basic_rhat(zf, split_chains))


def _tail_parts(x3, tail_prob: float, rank_mode: str, nbins: int,
                split_chains: int):
    """``(t_lo, t_hi, rhat_tail)`` of the tail kind from one histogram
    (fast) or one sort (exact): the quantiles at ``tail_prob/2`` and
    ``1 - tail_prob/2``, and the R-hat of the rank-normal ``|x - med|``."""
    ps = (tail_prob / 2, 1 - tail_prob / 2, 0.5)
    d, c, p = x3.shape
    if rank_mode == "fast":
        xf = x3.reshape(d * c, p).contiguous()
        cdf = build_hist_cdf(xf, nbins)
        t_lo, t_hi, med = hist_quantile(cdf, ps, nbins)
        z_tail = fast_rank_fold(xf, cdf, med, nbins)
        return t_lo, t_hi, _basic_rhat(z_tail.reshape(d, c, p), split_chains)
    xs, order, bad = sort_with_positions(x3)
    t_lo, t_hi, med = (torch.where(bad, torch.nan, sorted_quantile(xs, q))
                       for q in ps)
    return t_lo, t_hi, _tail_rhat_exact(xs, order, med, bad, x3.shape,
                                        split_chains)


def _tail_ess_rhat(x3, *, split_chains, maxlag, method, relative, tail_prob,
                   rank_mode, nbins):
    """Tail ESS (the two quantile-indicator proxies as one 2P-wide basic
    call) and tail R-hat."""
    p = x3.shape[2]
    t_lo, t_hi, rhat_tail = _tail_parts(x3, tail_prob, rank_mode, nbins,
                                        split_chains)
    proxies = torch.cat([_indicator_leq(x3, t_lo), _indicator_leq(x3, t_hi)],
                        dim=2)
    ess2, _ = _basic_ess_rhat(proxies, split_chains, maxlag, method, relative)
    return torch.minimum(ess2[:p], ess2[p:]), rhat_tail


def _bulk_tail_transforms(x3, rank_mode: str, nbins: int, split_chains: int):
    """``(z_bulk, rhat_tail)`` for the rank kind."""
    if rank_mode == "fast":
        z_bulk, z_tail, _ = fast_rank_bulk_tail(x3, nbins)
        return z_bulk, _basic_rhat(z_tail, split_chains)
    xs, order, bad = sort_with_positions(x3)
    med = torch.where(bad, torch.nan, sorted_quantile(xs, 0.5))
    z = rank_normalize_from_sort(xs, order, bad).reshape(x3.shape)
    return z, _tail_rhat_exact(xs, order, med, bad, x3.shape, split_chains)


def _bulk_transform(x3, rank_mode: str, nbins: int):
    if rank_mode == "fast":
        return fast_rank_normalize(x3, nbins)
    return rank_normalize(x3)


def _ess_rhat_pipeline(x3, *, kind: str, split_chains: int, maxlag: int,
                       method, relative: bool, q: float | None = None,
                       param_chunk: int | None = None,
                       rank_mode: str = "exact",
                       rank_nbins: int = DEFAULT_NBINS):
    """``(ess, rhat)`` of one kind on ``(draws, chains, P)``; for an
    estimator kind the R-hat is that of its proxy. ``q``: the tail kind's
    ``tail_prob`` (default 0.1), the quantile kind's probability.

    ``param_chunk`` bounds peak memory: parameters go through in slices of
    that size (every step is per-parameter independent, so this is exact).
    """
    nparams = x3.shape[2]
    if param_chunk is not None and nparams > param_chunk:
        parts = [
            _ess_rhat_pipeline(
                x3[:, :, s:s + param_chunk], kind=kind,
                split_chains=split_chains, maxlag=maxlag, method=method,
                relative=relative, q=q, rank_mode=rank_mode,
                rank_nbins=rank_nbins,
            )
            for s in range(0, nparams, param_chunk)
        ]
        return (torch.cat([e for e, _ in parts]),
                torch.cat([r for _, r in parts]))
    basic = dict(split_chains=split_chains, maxlag=maxlag, method=method,
                 relative=relative)
    if kind == "basic":
        return _basic_ess_rhat(x3, **basic)
    if kind == "bulk":
        return _basic_ess_rhat(_bulk_transform(x3, rank_mode, rank_nbins),
                               **basic)
    if kind == "tail":
        return _tail_ess_rhat(x3, **basic, tail_prob=0.1 if q is None else q,
                              rank_mode=rank_mode, nbins=rank_nbins)
    if kind == "rank":
        z_bulk, rhat_tail = _bulk_tail_transforms(x3, rank_mode, rank_nbins,
                                                  split_chains)
        ess_bulk, rhat_bulk = _basic_ess_rhat(z_bulk, **basic)
        return ess_bulk, torch.maximum(rhat_tail, rhat_bulk)
    if kind in _PROXY_KINDS:
        proxy = (_fast_expectand_proxy(kind, x3, q, rank_nbins)
                 if rank_mode == "fast" else _expectand_proxy(kind, x3, q))
        return _basic_ess_rhat(proxy, **basic)
    raise ValueError(f"unsupported kind {kind!r}")


def _rhat_pipeline(x3, *, kind: str, split_chains: int,
                   rank_mode: str = "exact", rank_nbins: int = DEFAULT_NBINS):
    if kind == "basic":
        return _basic_rhat(x3, split_chains)
    if kind == "bulk":
        return _basic_rhat(_bulk_transform(x3, rank_mode, rank_nbins),
                           split_chains)
    z_bulk, rhat_tail = _bulk_tail_transforms(x3, rank_mode, rank_nbins,
                                              split_chains)
    if kind == "tail":
        return rhat_tail
    if kind == "rank":
        return torch.maximum(rhat_tail, _basic_rhat(z_bulk, split_chains))
    raise ValueError(f"unsupported kind {kind!r}")


def _check_maxlag(maxlag: int):
    if maxlag <= 0:
        raise ValueError("maxlag must be >0.")


def _check_rank_mode(rank_mode: str):
    if rank_mode not in ("exact", "fast"):
        raise ValueError(
            f"rank_mode must be 'exact' or 'fast', got {rank_mode!r}"
        )


# the short-chain warning points at the caller's first frame outside the
# package, whichever entry point (ess, ess_rhat, mcse) reached it
_PKG_DIR = str(Path(__file__).resolve().parent.parent)


def _warn_short(niter: int):
    warnings.warn(
        f"number of draws after splitting must be >4 but is {niter}. "
        "ESS cannot be computed.",
        skip_file_prefixes=(_PKG_DIR,),
    )


def _normalize_estimator(kind):
    """A public ``ess`` kind as ``(pipeline kind, q)``."""
    if isinstance(kind, Quantile):
        return "quantile", float(kind.p)
    if isinstance(kind, str) and (kind in _SYMBOL_KINDS_ESS
                                  or kind in _ESTIMATOR_KINDS):
        return kind, None
    raise ValueError(f"the `kind` `{kind!r}` is not supported by `ess`")


def _canonical_input(samples, device, min_ndim: int = 1):
    x3, pshape = canonicalize(samples, device, min_ndim)
    backend.use_kernels(x3)  # a CUDA tensor that is not float32 raises here
    return x3, pshape


def ess(samples, *, kind="bulk", relative: bool = False,
        autocov_method="auto", split_chains: int = 2, maxlag: int = 250,
        tail_prob: float = 0.1, param_chunk: int | None = None,
        rank_mode: str = "exact", rank_nbins: int = DEFAULT_NBINS,
        device=None):
    """Effective sample size of ``samples`` shaped
    ``(draws[, chains[, params...]])`` (reference ``ess``,
    src/ess_rhat.jl:215-311).

    ``kind``: ``"bulk"`` (default), ``"tail"``, ``"basic"``, an estimator
    name (``"mean"``, ``"median"``, ``"std"``, ``"mad"``) or
    ``Quantile(p)``. ``relative=True`` returns ESS / (draws * chains). A
    Python float for <=2-d input, else a tensor shaped like the parameter
    dims, on the sample's device. A tensor is computed where it lives; other
    input (numpy) goes to ``device`` (default: the CPU).
    ``rank_mode="fast"`` replaces every sort (rank transforms, median and
    quantile thresholds) with the histogram CDF over ``rank_nbins`` bins.
    ``autocov_method``: ``"auto"`` (the fused K1 path), a marker
    (``DirectKernelAutocovMethod()`` runs K5), a method name or a callable.
    """
    _check_rank_mode(rank_mode)
    x3, pshape = _canonical_input(samples, device)
    kind, q = _normalize_estimator(kind)
    if kind == "tail":
        if not 0 < tail_prob < 1:
            raise ValueError("tail_prob must be in (0, 1)")
        q = tail_prob
    vals = _ess_array(x3, kind, q, split_chains=split_chains, maxlag=maxlag,
                      relative=relative, autocov_method=autocov_method,
                      rank_mode=rank_mode, rank_nbins=rank_nbins,
                      param_chunk=param_chunk)
    return maybe_scalar(vals, pshape)


def rhat(samples, *, kind: str = "rank", split_chains: int = 2,
         rank_mode: str = "exact", rank_nbins: int = DEFAULT_NBINS,
         device=None):
    """R-hat of ``samples`` shaped ``(draws[, chains[, params...]])``
    (reference ``rhat``, src/ess_rhat.jl:313-420). ``kind``: ``"rank"``
    (default), ``"bulk"``, ``"tail"`` or ``"basic"``. Devices and outputs as
    in :func:`ess`."""
    if kind not in _RHAT_KINDS:
        raise ValueError(f"the `kind` `{kind}` is not supported by `rhat`")
    _check_rank_mode(rank_mode)
    x3, pshape = _canonical_input(samples, device)
    vals = _rhat_pipeline(x3, kind=kind, split_chains=split_chains,
                          rank_mode=rank_mode, rank_nbins=rank_nbins)
    return maybe_scalar(vals, pshape)


def ess_rhat(samples, *, kind: str = "rank", relative: bool = False,
             autocov_method="auto", split_chains: int = 2, maxlag: int = 250,
             tail_prob: float = 0.1, param_chunk: int | None = None,
             rank_mode: str = "exact", rank_nbins: int = DEFAULT_NBINS,
             device=None):
    """Joint ESS and R-hat, an ``ESSRhat(ess, rhat)`` (reference
    ``ess_rhat``, src/ess_rhat.jl:422-487,604-624): ``"rank"`` gives the
    bulk ESS and max(bulk, tail) R-hat, ``"tail"`` the tail pair, plus
    ``"bulk"`` and ``"basic"``. Options, devices and outputs as in
    :func:`ess`."""
    if kind not in _RHAT_KINDS:
        raise ValueError(f"the `kind` `{kind}` is not supported by `ess_rhat`")
    _check_rank_mode(rank_mode)
    x3, pshape = _canonical_input(samples, device)
    _check_maxlag(maxlag)
    niter = x3.shape[0] // split_chains
    if niter <= 4:
        _warn_short(niter)
        ess_vals = torch.full((x3.shape[2],), torch.nan, dtype=x3.dtype,
                              device=x3.device)
        rhat_vals = _rhat_pipeline(x3, kind=kind, split_chains=split_chains,
                                   rank_mode=rank_mode, rank_nbins=rank_nbins)
        return ESSRhat(maybe_scalar(ess_vals, pshape),
                       maybe_scalar(rhat_vals, pshape))
    ess_vals, rhat_vals = _ess_rhat_pipeline(
        x3, kind=kind, split_chains=split_chains,
        maxlag=min(maxlag, niter - 4), method=_method_name(autocov_method),
        relative=relative, q=tail_prob, param_chunk=param_chunk,
        rank_mode=rank_mode, rank_nbins=rank_nbins,
    )
    return ESSRhat(maybe_scalar(ess_vals, pshape),
                   maybe_scalar(rhat_vals, pshape))


def _ess_array(x3, estimator: str, q: float | None, *, split_chains: int = 2,
               maxlag: int = 250, relative: bool = False,
               autocov_method="auto", rank_mode: str = "exact",
               rank_nbins: int = DEFAULT_NBINS,
               param_chunk: int | None = None):
    """ESS of one kind on canonical ``(draws, chains, P)``, ``(P,)``: the
    core of ``ess``, shared with ``mcse``."""
    _check_rank_mode(rank_mode)
    _check_maxlag(maxlag)
    niter = x3.shape[0] // split_chains
    if niter <= 4:
        _warn_short(niter)
        return torch.full((x3.shape[2],), torch.nan, dtype=x3.dtype,
                          device=x3.device)
    ess_vals, _ = _ess_rhat_pipeline(
        x3, kind=estimator, split_chains=split_chains,
        maxlag=min(maxlag, niter - 4), method=_method_name(autocov_method),
        relative=relative, q=q, param_chunk=param_chunk, rank_mode=rank_mode,
        rank_nbins=rank_nbins,
    )
    return ess_vals
