"""ESS / R-hat and nested R-hat over a ``(chains, params)`` process mesh
(counterpart of the JAX package's ``parallel/sharded.py``).

The single-device pipeline of ``diagnostics/ess_rhat.py`` re-expressed with
explicit collectives on the mesh's ``chains`` group (``mesh.py``): every rank
runs the same code on its own ``(draws, chains / k, params / m)`` block.

- cross-chain statistics (W, var_plus, B): SUM all-reduces of per-chain
  partial sums, two-pass (grand mean first, then centered second moments);
  the all-identical check (global min == max) is one MAX all-reduce;
- the mean autocovariance curve: one SUM all-reduce of the local
  ``(maxlag + 1, P_local)`` curve, computed by kernel K5 on a CUDA float32
  block (``autocov_method="auto"`` means K5 here: the fused K1 of the
  in-core path computes moments this path takes from collectives);
- the rank transforms (``rank_impl``):

  - ``"gather"``: one ``all_gather`` of the chain blocks, one ``torch.sort``
    of the full sample on every rank, this rank's chains sliced back out;
  - ``"ring"``: tied ranks by the ring merge-count of ``ring_rank.py``,
    O(N_local) memory;
  - ``"hist"`` (opt-in, approximate like ``rank_mode="fast"``): local
    histograms by kernel K3, one SUM all-reduce of the bin moments, then the
    local lookup by kernel K4 against the global CDF: no element leaves its
    rank.

Results come back on every rank as full ``(P,)`` tensors (one ``all_gather``
over the ``params`` group), as JAX returns global arrays. Ranks compute the
replicated values (the gather path's tail R-hat) from identical inputs with
identical operations, so they agree bit for bit; the JAX package's
``_replicated_pmax`` exists only for ``shard_map``'s check of replicated
outputs, which has no counterpart here, and is left out.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from .. import backend
from ..diagnostics.ess_rhat import (
    ESSRhat,
    _check_maxlag,
    _indicator_leq,
    _method_name,
    _tail_rhat_exact,
)
from ..diagnostics.rhat_nested import (
    _rhat_nested_basic,
    _validate_superchain_ids,
)
from ..kernels.fastrank import hist_moments, pack_tables
from ..ops.autocov import mean_autocov_curve
from ..ops.fastrank import (
    DEFAULT_NBINS,
    HistCDF,
    _fold_shift,
    _hist_scale,
    fast_rank_normalize_flat,
    fold_range,
    hist_quantile,
)
from ..ops.geyer import geyer_ess_from_rho
from ..ops.ranknorm import (
    _unsort,
    fold_around_median,
    rank_normalize,
    rank_normalize_from_sort,
    sort_with_positions,
    sorted_quantile,
)
from ..utils.layout import maybe_scalar
from ..utils.split import split_chains_reshape
from .mesh import MeshConfig, canonical_host, shard_canonical
from .ring_rank import (
    quantiles_from_positions,
    rank_normal_from_counts,
    ring_rank_counts,
)

_KINDS = ("rank", "bulk", "tail", "basic")
_RANK_IMPLS = ("auto", "gather", "ring", "hist")
_RING_AUTO_BYTES = 1 << 27  # ring above this full-sample size
# the hist path's bin counts are float32 sums: exact below 2^24 elements
_HIST_MAX_N = 1 << 24

_all_gather_into = (getattr(dist, "all_gather_single", None)
                    or dist.all_gather_into_tensor)


def _all_gather(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` (``size`` ranks), stacked: ``(size,
    *x.shape)`` (gathered concatenated along dim 0, the form gloo takes)."""
    out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
    _all_gather_into(out, x.contiguous(), group=group)
    return out.view(size, *x.shape)


def _sum(t: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(t, group=group)
    return t


def _max(t: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def _all_gather_chains(xb: torch.Tensor, cfg: MeshConfig) -> torch.Tensor:
    """The full ``(draws, chains, P_local)`` sample from every rank's chain
    block (gathered stacked, then laid side by side along the chains)."""
    d, c_loc, p = xb.shape
    k = cfg.chain_shards
    out = _all_gather(xb, cfg.chain_group, k)
    return out.permute(1, 0, 2, 3).reshape(d, k * c_loc, p)


def _my_chains(full: torch.Tensor, cfg: MeshConfig, c_loc: int):
    i = cfg.chain_index
    return full[:, i * c_loc:(i + 1) * c_loc]


def gather_params(values: torch.Tensor, cfg: MeshConfig) -> torch.Tensor:
    """``(..., P_local)`` results of every parameter block laid side by
    side: ``(..., P)``, the same on every rank."""
    out = _all_gather(values, cfg.param_group, cfg.param_shards)
    return torch.movedim(out, 0, -2).reshape(*values.shape[:-1], -1)


# ---------------------------------------------------------------------------
# moments and the basic pipeline
# ---------------------------------------------------------------------------


def _all_same(samples: torch.Tensor, group) -> torch.Tensor:
    """``(P,)`` True where every element of the ``(n, c, P)`` slices, on
    every rank, is one value: the global min equals the global max, from one
    MAX all-reduce of the local max and -min. A slice holding a NaN is NaN
    whatever this says."""
    flags = _max(torch.stack([samples.amax((0, 1)), -samples.amin((0, 1))]),
                 group)
    return flags[0] == -flags[1]


def _chain_moments(samples: torch.Tensor):
    """Per split chain of ``(niter, c, P)``: ``(mean, centered, var)``."""
    chain_mean = samples.mean(0)
    centered = samples - chain_mean[None]
    return chain_mean, centered, (centered * centered).sum(0) / (
        samples.shape[0] - 1)


def _pooled(chain_mean, chain_var, niter: int, degenerate, cfg: MeshConfig):
    """W and var_plus across every rank's split chains (the all-reduce
    algebra of ``stats_from_chain_moments``), var_plus NaN where
    ``degenerate``."""
    g = cfg.chain_group
    nchains = chain_mean.shape[0] * cfg.chain_shards
    sums = _sum(torch.stack([chain_var.sum(0), chain_mean.sum(0)]), g)
    w, grand = sums[0] / nchains, sums[1] / nchains
    dm = chain_mean - grand[None]
    if nchains > 1:
        between = _sum((dm * dm).sum(0), g) / (nchains - 1)
    else:
        between = torch.zeros_like(grand)
    var_plus = (niter - 1) / niter * w + between
    return w, torch.where(degenerate, torch.nan, var_plus)


def _split_rhat(z3, split_chains: int, cfg: MeshConfig, bad):
    """Basic split R-hat of a transform in (draw, chain) order, NaN where
    ``bad``."""
    samples = split_chains_reshape(z3, split_chains)
    chain_mean, _, chain_var = _chain_moments(samples)
    w, var_plus = _pooled(chain_mean, chain_var, samples.shape[0],
                          _all_same(samples, cfg.chain_group), cfg)
    return torch.where(bad, torch.nan, torch.sqrt(var_plus / w))


def _sharded_basic(xb, cfg: MeshConfig, *, split_chains, maxlag, method,
                   relative):
    """Basic ESS and R-hat of this rank's ``(draws, c, P)`` block."""
    samples = split_chains_reshape(xb, split_chains)
    niter, c_loc, _ = samples.shape
    nchains = c_loc * cfg.chain_shards
    chain_mean, centered, chain_var = _chain_moments(samples)
    w, var_plus = _pooled(chain_mean, chain_var, niter,
                          _all_same(samples, cfg.chain_group), cfg)
    acov_local = mean_autocov_curve(centered, chain_var, maxlag, method)
    acov = _sum(acov_local * c_loc, cfg.chain_group) / nchains
    rho = 1.0 - (w[None] - acov) / var_plus[None]
    return (geyer_ess_from_rho(rho, niter * nchains, relative),
            torch.sqrt(var_plus / w))


def _tail_ess(xb, t_lo, t_hi, cfg, basic):
    """Tail ESS: the two quantile-indicator proxies as one 2P-wide basic
    pipeline (one autocovariance all-reduce, not two)."""
    p = xb.shape[2]
    proxies = torch.cat([_indicator_leq(xb, t_lo), _indicator_leq(xb, t_hi)],
                        dim=2)
    ess2, _ = _sharded_basic(proxies, cfg, **basic)
    return torch.minimum(ess2[:p], ess2[p:])


def _tail_probs(q):
    tail_prob = 0.1 if q is None else q
    return tail_prob / 2, 1 - tail_prob / 2


# ---------------------------------------------------------------------------
# gather rank transform
# ---------------------------------------------------------------------------


def _gather_kernel(xb, cfg, kind, basic, q):
    if kind == "basic":
        return _sharded_basic(xb, cfg, **basic)
    c_loc = xb.shape[1]
    full = _all_gather_chains(xb, cfg)
    if kind == "bulk":
        z = _my_chains(rank_normalize(full), cfg, c_loc)
        return _sharded_basic(z, cfg, **basic)
    # one sort of the gathered sample serves the thresholds, the median and
    # both transforms; the tail R-hat is the same on every rank
    xs, order, bad = sort_with_positions(full)
    med = torch.where(bad, torch.nan, sorted_quantile(xs, 0.5))
    rhat_tail = _tail_rhat_exact(xs, order, med, bad, full.shape,
                                 basic["split_chains"])
    if kind == "tail":
        t_lo, t_hi = (torch.where(bad, torch.nan, sorted_quantile(xs, p))
                      for p in _tail_probs(q))
        return _tail_ess(xb, t_lo, t_hi, cfg, basic), rhat_tail
    z = rank_normalize_from_sort(xs, order, bad).reshape(full.shape)
    ess, rhat_bulk = _sharded_basic(_my_chains(z, cfg, c_loc), cfg, **basic)
    return ess, torch.maximum(rhat_tail, rhat_bulk)


# ---------------------------------------------------------------------------
# ring rank transform
# ---------------------------------------------------------------------------


def _ring_rank_parts(xb, cfg: MeshConfig, ps):
    """One local sort and one ring pass: ``(xs, order, z_sorted, quants,
    bad)``: the local sorted values, their local flat rows, the rank-normal
    values in sorted order, the global type-7 quantiles ``(len(ps), P)`` and
    the NaN-poisoned columns."""
    d, c_loc, p = xb.shape
    xf = xb.reshape(d * c_loc, p)
    xs, order = torch.sort(xf, dim=0)
    g = cfg.chain_group
    bad = _max(torch.isnan(xf).any(0).to(xf.dtype), g) > 0
    cl, ce, gpos = ring_rank_counts(xs, g, cfg.chain_index, cfg.chain_shards)
    ntot = d * c_loc * cfg.chain_shards
    z_sorted = rank_normal_from_counts(cl, ce, ntot, xs.dtype)
    quants = quantiles_from_positions(xs, gpos, ntot, ps, g)
    return xs, order, z_sorted, torch.where(bad[None], torch.nan, quants), bad


def _ring_fold(xs, order, med, cfg: MeshConfig, shape3):
    """Rank-normal values of ``|x - med|`` in this rank's (draw, chain)
    order: a second local sort and ring pass, then one scatter back (the
    in-core tail path's route; a scatter of unique rows is deterministic,
    where the JAX package's segment sums by split-chain id would add
    atomically)."""
    fs, fidx = torch.sort(torch.abs(xs - med[None, :]), dim=0)
    cl, ce, _ = ring_rank_counts(fs, cfg.chain_group, cfg.chain_index,
                                 cfg.chain_shards)
    zf = rank_normal_from_counts(cl, ce, math.prod(shape3[:2])
                                 * cfg.chain_shards, xs.dtype)
    return _unsort(zf, order.gather(0, fidx)).reshape(shape3)


def _ring_kernel(xb, cfg, kind, basic, q):
    d, c_loc, p = xb.shape
    split = basic["split_chains"]
    ps = _tail_probs(q) + (0.5,) if kind == "tail" else (0.5,)
    xs, order, z_sorted, quants, bad = _ring_rank_parts(xb, cfg, ps)

    def tail_rhat():
        return _split_rhat(_ring_fold(xs, order, quants[-1], cfg, xb.shape),
                           split, cfg, bad)

    if kind == "tail":
        return _tail_ess(xb, quants[0], quants[1], cfg, basic), tail_rhat()
    z = torch.where(bad[None], torch.nan, _unsort(z_sorted, order))
    ess, rhat_bulk = _sharded_basic(z.reshape(d, c_loc, p), cfg, **basic)
    if kind == "bulk":
        return ess, rhat_bulk
    return ess, torch.maximum(tail_rhat(), rhat_bulk)


# ---------------------------------------------------------------------------
# histogram rank transform (kernels K3 and K4 on each rank)
# ---------------------------------------------------------------------------


def _sharded_minmax(xf, cfg: MeshConfig):
    """Global per-column ``(lo, hi, bad)``: one MAX all-reduce of the local
    NaN flags, ``-min`` and ``max`` (NaNs ignored through +-inf sentinels).
    The ``[0, 1]`` range of a column whose lo or hi is not finite is applied
    after the reduction, so every rank agrees on it (kernel K2 applies it per
    call, which a shard holding an infinity would get wrong)."""
    nan = torch.isnan(xf)
    flags = _max(torch.stack([nan.any(0).to(xf.dtype),
                              -torch.where(nan, torch.inf, xf).amin(0),
                              torch.where(nan, -torch.inf, xf).amax(0)]),
                 cfg.chain_group)
    lo, hi = -flags[1], flags[2]
    ok = torch.isfinite(lo) & torch.isfinite(hi)
    return torch.where(ok, lo, 0.0), torch.where(ok, hi, 1.0), flags[0] > 0


def _sharded_hist_cdf(xf, cfg: MeshConfig, nbins: int, minmax, shift=None):
    """The global histogram CDF: kernel K3 (moments mode) on the local
    block, or on its fold ``|xf - shift|``, one SUM all-reduce of the bin
    counts and frac sums, then the prefix counts, within-bin means and K4's
    table in PyTorch (``hist_cdf_tables_plain``'s finish)."""
    lo, hi, bad = minmax
    n = xf.shape[0] * cfg.chain_shards
    if n >= _HIST_MAX_N:
        raise ValueError(
            f"rank_impl='hist' sums float32 bin counts, exact below 2^24 "
            f"elements a parameter; this sample has {n}: use 'gather' or "
            "'ring'")
    cnt, s1 = hist_moments(xf, lo, _hist_scale(lo, hi, nbins), nbins, shift)
    both = _sum(torch.stack([cnt, s1]), cfg.chain_group)
    cnt, s1 = both[0], both[1]
    fm = torch.where(cnt > 0, s1 / cnt.clamp(min=1.0), 0.5)
    cum = torch.cat([cnt.new_zeros((1, cnt.shape[1])), cnt.cumsum(0)])
    return HistCDF(cum, fm, lo, hi, n, bad, pack_tables(cum, fm))


def _sharded_fast_rank(xf, cfg, nbins: int, minmax=None, shift=None):
    """Rank-normal values of the local flat block (or of its fold around
    ``shift``) against the global CDF: ``(z, cdf)``, z by kernel K4 in this
    rank's (draw, chain) order, no element leaving its rank."""
    if minmax is None:
        minmax = _sharded_minmax(xf, cfg)
    cdf = _sharded_hist_cdf(xf, cfg, nbins, minmax, shift)
    return fast_rank_normalize_flat(xf, nbins, cdf=cdf, shift=shift)


def _sharded_fold_rank(xf, cdf: HistCDF, med, cfg, nbins: int):
    """Rank-normal values of ``|xf - med|``, the range derived from the
    bulk CDF (no extra reduction round)."""
    z, _ = _sharded_fast_rank(xf, cfg, nbins, minmax=fold_range(cdf, med),
                              shift=_fold_shift(med))
    return z


def _hist_kernel(xb, cfg, kind, basic, q, nbins: int):
    d, c_loc, p = xb.shape
    split = basic["split_chains"]
    xf = xb.reshape(d * c_loc, p).contiguous()
    z, cdf = _sharded_fast_rank(xf, cfg, nbins)
    if kind == "tail":
        t_lo, t_hi, med = hist_quantile(cdf, _tail_probs(q) + (0.5,), nbins)
        ess = _tail_ess(xb, t_lo, t_hi, cfg, basic)
    else:
        med = hist_quantile(cdf, (0.5,), nbins)[0]
        ess, rhat_bulk = _sharded_basic(z.reshape(d, c_loc, p), cfg, **basic)
        if kind == "bulk":
            return ess, rhat_bulk
    z_tail = _sharded_fold_rank(xf, cdf, med, cfg, nbins)
    rhat_tail = _split_rhat(z_tail.reshape(d, c_loc, p), split, cfg, cdf.bad)
    if kind == "tail":
        return ess, rhat_tail
    return ess, torch.maximum(rhat_tail, rhat_bulk)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _resolve_rank_impl(rank_impl: str, shape, itemsize: int, kind: str) -> str:
    """Gather or ring for the sort-based kinds: ``"auto"`` takes the ring
    where the gathered full sample (``shape``, ``itemsize`` bytes an
    element) would pass 2^27 bytes on every device; ``"hist"`` only on
    request (it is approximate); the basic kind has no rank transform."""
    if rank_impl not in _RANK_IMPLS:
        raise ValueError(f"unknown rank_impl {rank_impl!r}")
    if kind == "basic":
        return "gather"
    if rank_impl != "auto":
        return rank_impl
    return "ring" if math.prod(shape) * itemsize > _RING_AUTO_BYTES else "gather"


def sharded_method(autocov_method) -> str:
    """The autocovariance method of the sharded path: ``"auto"`` (and the
    fused ``KernelAutocovMethod``) become kernel K5's direct estimator."""
    method = _method_name(autocov_method)
    return "direct" if method == "kernel" else method


def local_ess_rhat(xb, cfg: MeshConfig, *, kind: str, split_chains: int,
                   maxlag: int, method, relative: bool, q, rank_impl: str,
                   rank_nbins: int):
    """``(ess, rhat)`` of this rank's parameter block, ``(P_local,)`` each,
    from its ``(draws, chains / k, P_local)`` block; ``rank_impl`` resolved,
    ``maxlag`` already clamped to ``niter - 4``."""
    if kind not in _KINDS:
        raise ValueError(f"unsupported kind {kind!r}")
    basic = dict(split_chains=split_chains, maxlag=maxlag, method=method,
                 relative=relative)
    if rank_impl == "hist" and kind != "basic":
        return _hist_kernel(xb, cfg, kind, basic, q, rank_nbins)
    if rank_impl == "ring" and kind != "basic":
        return _ring_kernel(xb, cfg, kind, basic, q)
    return _gather_kernel(xb, cfg, kind, basic, q)


def ess_rhat_sharded(samples, cfg: MeshConfig, *, kind: str = "rank",
                     split_chains: int = 2, maxlag: int = 250,
                     autocov_method="auto", relative: bool = False,
                     tail_prob: float = 0.1, rank_impl: str = "auto",
                     rank_nbins: int = DEFAULT_NBINS):
    """ESS and R-hat over the mesh; every rank calls it with the same global
    ``(draws, chains[, params...])`` sample and gets the same
    ``ESSRhat``.

    Only this rank's ``(draws, chains / k, P / m)`` block goes to its device
    (a CUDA float32 block runs the kernels, as in-core calls do; numpy
    float64 becomes float32 on the card). ``rank_impl``: ``"gather"``,
    ``"ring"``, ``"hist"`` (the distributed ``rank_mode="fast"``: local
    histograms by K3, one all-reduce of the bin moments, the lookup by K4),
    or ``"auto"`` (gather, or ring above 2^27 bytes of full sample). Kinds
    and the other options as in ``ess_rhat``; ``autocov_method="auto"`` is
    kernel K5's direct estimator. Results are full ``(P,)`` tensors on this
    rank's device (a float for input without parameter dims).
    """
    if kind not in _KINDS:
        raise ValueError(
            f"the `kind` `{kind}` is not supported by `ess_rhat_sharded`")
    _check_maxlag(maxlag)
    x3, pshape = canonical_host(samples)
    niter = x3.shape[0] // split_chains
    if niter <= 4:
        raise ValueError("sharded ess_rhat requires >4 draws per split chain")
    xb = shard_canonical(x3, cfg)
    backend.use_kernels(xb)  # a CUDA block of another dtype raises here
    impl = _resolve_rank_impl(rank_impl, x3.shape, xb.element_size(), kind)
    ess, rhat = local_ess_rhat(
        xb, cfg, kind=kind, split_chains=split_chains,
        maxlag=min(maxlag, niter - 4), method=sharded_method(autocov_method),
        relative=relative, q=tail_prob if kind == "tail" else None,
        rank_impl=impl, rank_nbins=rank_nbins)
    ess, rhat = gather_params(torch.stack([ess, rhat]), cfg)
    return ESSRhat(maybe_scalar(ess, pshape), maybe_scalar(rhat, pshape))


# ---------------------------------------------------------------------------
# nested R-hat
# ---------------------------------------------------------------------------


def _nested_rhat_dist(chain_mean, chain_var, nsuper_local: int,
                      cfg: MeshConfig, degenerate):
    """Nested R-hat from per-rank split-chain moments ``(C_local, P)``,
    superchains whole and contiguous on their rank: the within level reduces
    locally, the across level is SUM all-reduces (src/rhat_nested.jl:144-185);
    NaN where ``degenerate``."""
    ctot_loc, nparams = chain_mean.shape
    m = ctot_loc // nsuper_local
    g = cfg.chain_group
    nsuper = nsuper_local * cfg.chain_shards
    cm = chain_mean.reshape(nsuper_local, m, nparams)
    cv = chain_var.reshape(nsuper_local, m, nparams)
    wk = cv.mean(1)
    sm = cm.mean(1)
    if m > 1:
        dm = cm - sm[:, None]
        bk = (dm * dm).sum(1) / (m - 1)
    else:
        bk = torch.zeros_like(wk)
    sums = _sum(torch.stack([(wk + bk).sum(0), sm.sum(0)]), g)
    var_within, grand = sums[0] / nsuper, sums[1] / nsuper
    ds = sm - grand[None]
    var_between = _sum((ds * ds).sum(0), g) / (nsuper - 1)
    var_between = torch.where(degenerate, torch.nan, var_between)
    return torch.sqrt(1.0 + var_between / var_within)


def _nested_split(z3, nsuper_local: int, split: int, cfg: MeshConfig):
    """Nested R-hat of a block in (draw, chain) order."""
    samples = split_chains_reshape(z3, split)
    chain_mean, _, chain_var = _chain_moments(samples)
    return _nested_rhat_dist(chain_mean, chain_var, nsuper_local, cfg,
                             _all_same(samples, cfg.chain_group))


def _nested_gather(xb, cfg, kind, nsuper: int, split: int):
    """The rank kinds from the gathered sample, the same on every rank (the
    in-core transforms and reduction)."""
    full = _all_gather_chains(xb, cfg)
    ident = torch.arange(full.shape[1], device=full.device)

    def nested(z3):
        return _rhat_nested_basic(z3, ident, nsuper, split)

    if kind == "bulk":
        return nested(rank_normalize(full))
    tail = nested(rank_normalize(fold_around_median(full)))
    if kind == "tail":
        return tail
    return torch.maximum(nested(rank_normalize(full)), tail)


def _nested_ring(xb, cfg, kind, nsuper_local: int, split: int):
    """Ranks by the ring merge-count."""
    xs, order, z_sorted, quants, bad = _ring_rank_parts(xb, cfg, (0.5,))

    def nested(z3):
        r = _nested_split(z3, nsuper_local, split, cfg)
        return torch.where(bad, torch.nan, r)

    if kind != "tail":
        bulk = nested(_unsort(z_sorted, order).reshape(xb.shape))
        if kind == "bulk":
            return bulk
    tail = nested(_ring_fold(xs, order, quants[0], cfg, xb.shape))
    if kind == "tail":
        return tail
    return torch.maximum(bulk, tail)


def _nested_hist(xb, cfg, kind, nsuper_local: int, split: int, nbins: int):
    """Ranks by the distributed histogram (K3, one all-reduce, K4)."""
    d, c_loc, p = xb.shape
    xf = xb.reshape(d * c_loc, p).contiguous()

    def nested(z, bad):
        r = _nested_split(z.reshape(d, c_loc, p), nsuper_local, split, cfg)
        return torch.where(bad, torch.nan, r)

    z, cdf = _sharded_fast_rank(xf, cfg, nbins)
    if kind == "bulk":
        return nested(z, cdf.bad)
    med = hist_quantile(cdf, (0.5,), nbins)[0]
    tail = nested(_sharded_fold_rank(xf, cdf, med, cfg, nbins), cdf.bad)
    if kind == "tail":
        return tail
    return torch.maximum(nested(z, cdf.bad), tail)


def rhat_nested_sharded(samples, superchain_ids, cfg: MeshConfig, *,
                        kind: str = "rank", split_chains: int = 2,
                        rank_impl: str = "auto",
                        rank_nbins: int = DEFAULT_NBINS):
    """Nested R-hat over the mesh; every rank calls it with the same global
    sample and ids and gets the same result.

    The chains are permuted on the host so that superchains are contiguous,
    and each chain shard holds whole superchains: the number of superchains
    must divide evenly across the chain shards. The within-superchain level
    then reduces locally and the across level is SUM all-reduces.
    ``rank_impl`` and outputs as in :func:`ess_rhat_sharded`.
    """
    if kind not in _KINDS:
        raise ValueError(
            f"the `kind` `{kind}` is not supported by `rhat_nested_sharded`")
    x3, pshape = canonical_host(samples, min_ndim=2)
    perm, nsuper = _validate_superchain_ids(superchain_ids, x3.shape[1])
    kshards = cfg.chain_shards
    if nsuper % kshards:
        raise ValueError(
            f"number of superchains ({nsuper}) must divide evenly across the "
            f"chain shards ({kshards})")
    xb = shard_canonical(x3, cfg, chain_order=perm)
    backend.use_kernels(xb)
    impl = _resolve_rank_impl(rank_impl, x3.shape, xb.element_size(), kind)
    nsuper_local = nsuper // kshards
    if kind == "basic":
        r = _nested_split(xb, nsuper_local, split_chains, cfg)
    elif impl == "hist":
        r = _nested_hist(xb, cfg, kind, nsuper_local, split_chains,
                         rank_nbins)
    elif impl == "ring":
        r = _nested_ring(xb, cfg, kind, nsuper_local, split_chains)
    else:
        r = _nested_gather(xb, cfg, kind, nsuper, split_chains)
    return maybe_scalar(gather_params(r, cfg), pshape)
