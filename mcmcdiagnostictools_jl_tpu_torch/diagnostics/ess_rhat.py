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

``rank_mode="exact"`` ranks by kernel K13's sort along the sample's rows
``(P, draws * chains)`` (one transposing copy in, the bulk values scattered
along the rows and transposed back to ``(draws, chains, P)``) and takes the
tail R-hat from the sort of ``x``: the fold ``|x - median|`` sorted
(``fold_impl``: a stable sort, or the merge of its two sorted runs) and its
split-chain moments read off the positions the sort carries
(ops/seghist.py); ``"fast"`` uses the histogram CDF (ops/fastrank.py) for
the rank transforms and for every median/quantile threshold. On a CUDA
float32 tensor the fused moments + autocovariance (or, with
``DirectKernelAutocovMethod``, the direct autocovariance alone), the fold
merge (K10), the split-chain moments (K11) and the fast rank transform run
the hand-written kernels (kernels/); on any other tensor their plain
versions.

Numeric contracts: the split-chain remainder-discard rule, the ``(n-1)/n``
correction, the ``corrected=(nchains>1)`` guard, the ``min(1/tau,
log10(ntotal))`` cap, ``maxlag`` clamped to ``niter - 4``, and NaN ESS with
a warning (R-hat still computed) when ``niter <= 4``. The sharded
diagnostics call the public helpers with the mesh's chain group.
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
from ..ops.moments import (
    ONE_CARD,
    ChainGroup,
    chain_moments,
    chain_stats,
    fused_chain_stats_autocov,
    stats_from_chain_moments,
)
from ..ops.ranknorm import (
    _VALLEY_BLOCK,
    batched_median,
    batched_quantile,
    fold_around_median,
    folded_rank_values_sorted,
    rank_normalize,
    rank_normalize_from_sort,
    sort_with_positions,
    sorted_quantile,
)
from ..ops.seghist import split_chain_stats_from_sorted
from ..utils.layout import canonicalize, maybe_scalar
from ..utils.profiling import annotate, host_sync
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
    """Another name for ``AutocovMethod``, which already runs kernel K5 on a
    CUDA tensor (as does the JAX package's name, ``PallasAutocovMethod``)."""

    name: str = "direct_kernel"


@dataclass(frozen=True)
class PallasAutocovMethod:
    """The JAX package's marker for its Pallas lag kernel: the direct
    estimator, here kernel K5 on a CUDA float32 tensor (the route of
    ``DirectKernelAutocovMethod``) and its plain version on any other.
    ``interpret`` is kept so that code written for the JAX package builds
    the marker; the tensor's device decides the route, never this field."""

    interpret: bool = False

    @property
    def name(self) -> str:
        return "pallas_interpret" if self.interpret else "pallas"


@dataclass(frozen=True)
class FusedAutocovMethod:
    """The JAX package's marker for its fused moments + autocovariance
    kernel: here kernel K1 on a CUDA float32 tensor (the route of
    ``KernelAutocovMethod`` and of ``"auto"``) and its plain version on any
    other. ``interpret`` as in ``PallasAutocovMethod``: the tensor's device
    decides the route."""

    interpret: bool = False

    @property
    def name(self) -> str:
        return "fused_interpret" if self.interpret else "fused"


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
            KernelAutocovMethod, DirectKernelAutocovMethod,
            PallasAutocovMethod, FusedAutocovMethod)
# names of the fused route (K1); the JAX package's "fused" and
# "fused_interpret" differ only in how it ran its kernel
_FUSED_NAMES = ("auto", "fused", "fused_interpret")


def _resolve_fold_merge(x3, fold_impl: str = "auto") -> str | None:
    """The fold sort of the tail and rank kinds: ``"sort"`` (K13's stable
    sort of the folded rows) -> ``None``, ``"merge"`` (the valley merge) ->
    ``"two_sort"``; ``"auto"`` merges where the kernels run (a CUDA float32
    tensor: K10) and the flattened sample spans two of the JAX package's
    valley blocks, and sorts elsewhere (as the JAX package does off its
    TPU). The two give bit-identical keys; only the order of ties differs,
    which the tied-average ranks absorb."""
    if fold_impl == "sort":
        return None
    if fold_impl == "merge":
        return "two_sort"
    if fold_impl != "auto":
        raise ValueError(f"unsupported fold_impl {fold_impl!r}")
    n = x3.shape[0] * x3.shape[1]
    if backend.use_kernels(x3) and n >= 2 * _VALLEY_BLOCK:
        return "two_sort"
    return None


def method_name(autocov_method):
    """The route of an ``autocov_method``: ``"kernel"`` for the fused one
    (K1), else a name of ``ops.autocov``'s table or a callable."""
    if isinstance(autocov_method, _MARKERS):
        autocov_method = autocov_method.name
    if isinstance(autocov_method, str) and autocov_method in _FUSED_NAMES:
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


def basic_ess_rhat(x3, split_chains: int, maxlag: int, method,
                   relative: bool, group: ChainGroup = ONE_CARD):
    """Basic ESS and R-hat of this rank's ``(draws, C_local, P)``: split ->
    moments -> autocov -> rho -> Geyer (src/ess_rhat.jl:488-602)."""
    with annotate("mdt.moments"):
        samples = split_chains_reshape(x3, split_chains)
        niter, nchains, _ = samples.shape
        stats, rho = _stats_rho(samples, maxlag, method, group)
    return (geyer_ess_from_rho(rho, niter * nchains * group.ranks, relative),
            stats.rhat)


def _stats_rho(samples, maxlag: int, method, group: ChainGroup):
    """``(ChainStats, rho)`` of the split chains: moments, autocovariance
    and autocorrelation up to ``maxlag`` (the fused route, one card's only,
    up to ``_ADAPTIVE_L0`` lags alone where every Geyer walk stops inside
    them)."""
    if method == "kernel":

        def stats_rho(lag):
            stats, acov = fused_chain_stats_autocov(samples, lag)
            return stats, 1.0 - (stats.w[None] - acov) / stats.var_plus[None]

        if maxlag >= 2 * _ADAPTIVE_L0:
            stats0, rho0 = stats_rho(_ADAPTIVE_L0)
            with host_sync("geyer_probe"):
                stopped = bool(_geyer_walk_stopped(rho0).all())
            if stopped:
                return stats0, rho0
        return stats_rho(maxlag)
    chain_mean, centered, chain_var = chain_moments(samples)
    stats = stats_from_chain_moments(chain_mean, chain_var, samples.shape[0],
                                     group.all_same(samples), group)
    acov = group.mean_of_means(
        mean_autocov_curve(centered, chain_var, maxlag, method),
        samples.shape[1])
    return stats, 1.0 - (stats.w[None] - acov) / stats.var_plus[None]


def basic_rhat(x3, split_chains: int, group: ChainGroup = ONE_CARD):
    """Basic split R-hat of this rank's ``(draws, C_local, P)``."""
    return chain_stats(split_chains_reshape(x3, split_chains), group).rhat


def _tail_rhat_from_sort(xs, order, med, bad, shape3, split_chains: int,
                         fold_merge: str | None = None):
    """Tail R-hat (reference src/ess_rhat.jl:413-415) from the sort of
    ``x``: the rank-normal ``|x - med|`` in fold-sorted order
    (``fold_merge`` as ``folded_rank_values_sorted``'s ``merge``), its
    split-chain moments straight from the positions the fold sort carries
    (``ops/seghist.py``: kernel K11 on a CUDA float32 tensor), nothing
    routed back to (draw, chain) order."""
    d, c, _ = shape3
    zf_sorted, forder = folded_rank_values_sorted(xs, order, med,
                                                  merge=fold_merge)
    stats = split_chain_stats_from_sorted(zf_sorted, forder, d, c,
                                          split_chains)
    return torch.where(bad, torch.nan, stats.rhat)


def tail_parts(x3, tail_prob: float, rank_mode: str, nbins: int,
               split_chains: int, fold_merge: str | None = None):
    """``(t_lo, t_hi, rhat_tail)`` of the tail kind from one histogram
    (fast) or one sort (exact): the quantiles at ``tail_prob/2`` and
    ``1 - tail_prob/2``, and the R-hat of the rank-normal ``|x - med|``."""
    ps = (tail_prob / 2, 1 - tail_prob / 2, 0.5)
    d, c, p = x3.shape
    with annotate("mdt.rank." + rank_mode):
        if rank_mode == "fast":
            xf = x3.reshape(d * c, p).contiguous()
            cdf = build_hist_cdf(xf, nbins)
            t_lo, t_hi, med = hist_quantile(cdf, ps, nbins)
            z_tail = fast_rank_fold(xf, cdf, med, nbins)
            return t_lo, t_hi, basic_rhat(z_tail.reshape(d, c, p),
                                          split_chains)
        xs, order, bad = sort_with_positions(x3)
        t_lo, t_hi, med = (torch.where(bad, torch.nan, sorted_quantile(xs, q))
                           for q in ps)
        return t_lo, t_hi, _tail_rhat_from_sort(xs, order, med, bad, x3.shape,
                                                split_chains, fold_merge)


def tail_ess(x3, t_lo, t_hi, *, split_chains: int, maxlag: int, method,
             relative: bool, group: ChainGroup = ONE_CARD):
    """Tail ESS: the two quantile indicators as one 2P-wide basic call."""
    p = x3.shape[2]
    proxies = torch.cat([_indicator_leq(x3, t_lo), _indicator_leq(x3, t_hi)],
                        dim=2)
    ess2, _ = basic_ess_rhat(proxies, split_chains, maxlag, method, relative,
                             group)
    return torch.minimum(ess2[:p], ess2[p:])


def bulk_tail_transforms(x3, rank_mode: str, nbins: int, split_chains: int,
                         fold_merge: str | None = None):
    """``(z_bulk, rhat_tail)`` for the rank kind."""
    with annotate("mdt.rank." + rank_mode):
        if rank_mode == "fast":
            z_bulk, z_tail, _ = fast_rank_bulk_tail(x3, nbins)
            return z_bulk, basic_rhat(z_tail, split_chains)
        xs, order, bad = sort_with_positions(x3)
        med = torch.where(bad, torch.nan, sorted_quantile(xs, 0.5))
        z = rank_normalize_from_sort(xs, order, bad).reshape(x3.shape)
        return z, _tail_rhat_from_sort(xs, order, med, bad, x3.shape,
                                       split_chains, fold_merge)


def bulk_transform(x3, rank_mode: str, nbins: int):
    """The bulk kind's rank-normal sample."""
    with annotate("mdt.rank." + rank_mode):
        if rank_mode == "fast":
            return fast_rank_normalize(x3, nbins)
        return rank_normalize(x3)


def _ess_rhat_pipeline(x3, *, kind: str, split_chains: int, maxlag: int,
                       method, relative: bool, q: float | None = None,
                       param_chunk: int | None = None,
                       fold_merge: str | None = None,
                       rank_mode: str = "exact",
                       rank_nbins: int = DEFAULT_NBINS):
    """``(ess, rhat)`` of one kind on ``(draws, chains, P)``; for an
    estimator kind the R-hat is that of its proxy. ``q``: the tail kind's
    ``tail_prob`` (default 0.1), the quantile kind's probability.
    ``fold_merge``: the exact tail transform's fold sort
    (``_resolve_fold_merge``).

    ``param_chunk`` bounds peak memory: parameters go through in slices of
    that size (every step is per-parameter independent, so this is exact).
    """
    nparams = x3.shape[2]
    if param_chunk is not None and nparams > param_chunk:
        parts = [
            _ess_rhat_pipeline(
                x3[:, :, s:s + param_chunk], kind=kind,
                split_chains=split_chains, maxlag=maxlag, method=method,
                relative=relative, q=q, fold_merge=fold_merge,
                rank_mode=rank_mode, rank_nbins=rank_nbins,
            )
            for s in range(0, nparams, param_chunk)
        ]
        return (torch.cat([e for e, _ in parts]),
                torch.cat([r for _, r in parts]))
    basic = dict(split_chains=split_chains, maxlag=maxlag, method=method,
                 relative=relative)
    if kind == "basic":
        return basic_ess_rhat(x3, **basic)
    if kind == "bulk":
        return basic_ess_rhat(bulk_transform(x3, rank_mode, rank_nbins),
                              **basic)
    if kind == "tail":
        t_lo, t_hi, rhat_tail = tail_parts(x3, 0.1 if q is None else q,
                                           rank_mode, rank_nbins,
                                           split_chains, fold_merge)
        return tail_ess(x3, t_lo, t_hi, **basic), rhat_tail
    if kind == "rank":
        z_bulk, rhat_tail = bulk_tail_transforms(x3, rank_mode, rank_nbins,
                                                 split_chains, fold_merge)
        ess_bulk, rhat_bulk = basic_ess_rhat(z_bulk, **basic)
        return ess_bulk, torch.maximum(rhat_tail, rhat_bulk)
    if kind in _PROXY_KINDS:
        proxy = (_fast_expectand_proxy(kind, x3, q, rank_nbins)
                 if rank_mode == "fast" else _expectand_proxy(kind, x3, q))
        return basic_ess_rhat(proxy, **basic)
    raise ValueError(f"unsupported kind {kind!r}")


def _rhat_pipeline(x3, *, kind: str, split_chains: int,
                   fold_merge: str | None = None, rank_mode: str = "exact",
                   rank_nbins: int = DEFAULT_NBINS):
    if kind == "basic":
        return basic_rhat(x3, split_chains)
    if kind == "bulk":
        return basic_rhat(bulk_transform(x3, rank_mode, rank_nbins),
                          split_chains)
    z_bulk, rhat_tail = bulk_tail_transforms(x3, rank_mode, rank_nbins,
                                             split_chains, fold_merge)
    if kind == "tail":
        return rhat_tail
    if kind == "rank":
        return torch.maximum(rhat_tail, basic_rhat(z_bulk, split_chains))
    raise ValueError(f"unsupported kind {kind!r}")


def check_maxlag(maxlag: int):
    """Raise unless ``maxlag`` is positive."""
    if maxlag <= 0:
        raise ValueError("maxlag must be >0.")


# the names streaming.py and the tests import
_method_name, _check_maxlag = method_name, check_maxlag


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
        fold_impl: str = "auto", rank_mode: str = "exact",
        rank_nbins: int = DEFAULT_NBINS, device=None):
    """Effective sample size of ``samples`` shaped
    ``(draws[, chains[, params...]])`` (reference ``ess``,
    src/ess_rhat.jl:215-311).

    ``kind``: ``"bulk"`` (default), ``"tail"``, ``"basic"``, an estimator
    name (``"mean"``, ``"median"``, ``"std"``, ``"mad"``) or
    ``Quantile(p)``. ``relative=True`` returns ESS / (draws * chains). A
    Python float for <=2-d input, else a tensor shaped like the parameter
    dims, on the sample's device. A tensor is computed where it lives; other
    input (numpy, lists) goes to ``device``, by default the current card
    (float64 as float32 there); ``device="cpu"`` computes on the host.
    ``rank_mode="fast"`` replaces every sort (rank transforms, median and
    quantile thresholds) with the histogram CDF over ``rank_nbins`` bins.
    ``fold_impl``: the exact tail transform's sort of ``|x - median|``:
    ``"sort"`` (``torch.sort``), ``"merge"`` (the merge of its two sorted
    runs: kernel K10 on a CUDA float32 tensor), or ``"auto"`` (the merge
    where K10 runs and the sample has at least 16,384 draws x chains, else
    the sort); the results agree up to summation order.
    ``autocov_method``: ``"auto"`` (the fused K1 path; also
    ``FusedAutocovMethod()``, ``"fused"``), a marker
    (``DirectKernelAutocovMethod()`` and ``PallasAutocovMethod()`` run K5),
    a method name or a callable.
    """
    _check_rank_mode(rank_mode)
    with annotate("mdt.ess"):
        x3, pshape = _canonical_input(samples, device)
        kind, q = _normalize_estimator(kind)
        if kind == "tail":
            if not 0 < tail_prob < 1:
                raise ValueError("tail_prob must be in (0, 1)")
            q = tail_prob
        vals = _ess_array(x3, kind, q, split_chains=split_chains,
                          maxlag=maxlag, relative=relative,
                          autocov_method=autocov_method, rank_mode=rank_mode,
                          rank_nbins=rank_nbins, param_chunk=param_chunk,
                          fold_merge=_resolve_fold_merge(x3, fold_impl))
        return maybe_scalar(vals, pshape)


def rhat(samples, *, kind: str = "rank", split_chains: int = 2,
         fold_impl: str = "auto", rank_mode: str = "exact",
         rank_nbins: int = DEFAULT_NBINS, device=None):
    """R-hat of ``samples`` shaped ``(draws[, chains[, params...]])``
    (reference ``rhat``, src/ess_rhat.jl:313-420). ``kind``: ``"rank"``
    (default), ``"bulk"``, ``"tail"`` or ``"basic"``. Devices and outputs as
    in :func:`ess`."""
    if kind not in _RHAT_KINDS:
        raise ValueError(f"the `kind` `{kind}` is not supported by `rhat`")
    _check_rank_mode(rank_mode)
    with annotate("mdt.rhat"):
        x3, pshape = _canonical_input(samples, device)
        vals = _rhat_pipeline(x3, kind=kind, split_chains=split_chains,
                              fold_merge=_resolve_fold_merge(x3, fold_impl),
                              rank_mode=rank_mode, rank_nbins=rank_nbins)
        return maybe_scalar(vals, pshape)


def ess_rhat(samples, *, kind: str = "rank", relative: bool = False,
             autocov_method="auto", split_chains: int = 2, maxlag: int = 250,
             tail_prob: float = 0.1, param_chunk: int | None = None,
             fold_impl: str = "auto", rank_mode: str = "exact",
             rank_nbins: int = DEFAULT_NBINS, device=None):
    """Joint ESS and R-hat, an ``ESSRhat(ess, rhat)`` (reference
    ``ess_rhat``, src/ess_rhat.jl:422-487,604-624): ``"rank"`` gives the
    bulk ESS and max(bulk, tail) R-hat, ``"tail"`` the tail pair, plus
    ``"bulk"`` and ``"basic"``. Options, devices and outputs as in
    :func:`ess`."""
    if kind not in _RHAT_KINDS:
        raise ValueError(f"the `kind` `{kind}` is not supported by `ess_rhat`")
    _check_rank_mode(rank_mode)
    with annotate("mdt.ess_rhat"):
        x3, pshape = _canonical_input(samples, device)
        check_maxlag(maxlag)
        fold_merge = _resolve_fold_merge(x3, fold_impl)
        niter = x3.shape[0] // split_chains
        if niter <= 4:
            _warn_short(niter)
            ess_vals = torch.full((x3.shape[2],), torch.nan, dtype=x3.dtype,
                                  device=x3.device)
            rhat_vals = _rhat_pipeline(
                x3, kind=kind, split_chains=split_chains,
                fold_merge=fold_merge, rank_mode=rank_mode,
                rank_nbins=rank_nbins)
        else:
            ess_vals, rhat_vals = _ess_rhat_pipeline(
                x3, kind=kind, split_chains=split_chains,
                maxlag=min(maxlag, niter - 4),
                method=method_name(autocov_method), relative=relative,
                q=tail_prob, param_chunk=param_chunk, fold_merge=fold_merge,
                rank_mode=rank_mode, rank_nbins=rank_nbins,
            )
        return ESSRhat(maybe_scalar(ess_vals, pshape),
                       maybe_scalar(rhat_vals, pshape))


def _ess_array(x3, estimator: str, q: float | None, *, split_chains: int = 2,
               maxlag: int = 250, relative: bool = False,
               autocov_method="auto", rank_mode: str = "exact",
               rank_nbins: int = DEFAULT_NBINS,
               param_chunk: int | None = None,
               fold_merge: str | None = None):
    """ESS of one kind on canonical ``(draws, chains, P)``, ``(P,)``: the
    core of ``ess``, shared with ``mcse``."""
    _check_rank_mode(rank_mode)
    check_maxlag(maxlag)
    niter = x3.shape[0] // split_chains
    if niter <= 4:
        _warn_short(niter)
        return torch.full((x3.shape[2],), torch.nan, dtype=x3.dtype,
                          device=x3.device)
    ess_vals, _ = _ess_rhat_pipeline(
        x3, kind=estimator, split_chains=split_chains,
        maxlag=min(maxlag, niter - 4), method=method_name(autocov_method),
        relative=relative, q=q, param_chunk=param_chunk,
        fold_merge=fold_merge, rank_mode=rank_mode, rank_nbins=rank_nbins,
    )
    return ess_vals
