"""ESS / R-hat and nested R-hat over a ``(chains, params)`` process mesh
(counterpart of the JAX package's ``parallel/sharded.py``).

The single-device pipeline of ``diagnostics/ess_rhat.py`` run on the mesh's
``chains`` group (``mesh.py``): every rank runs the same code on its own
``(draws, chains / k, params / m)`` block, and the cross-chain algebra is the
in-core code's own, given the mesh's chain group (``comm.mesh_chains``):

- W, var_plus, B and nested R-hat's across level: SUM all-reduces of
  per-chain partial sums, two-pass (grand mean first, then centered second
  moments); the all-identical check (global min == max) one MAX all-reduce;
- the mean autocovariance curve: one SUM all-reduce of the local
  ``(maxlag + 1, P_local)`` curve, kernel K5's on a CUDA float32 block
  (``autocov_method="auto"`` means K5 here: the fused K1 of the in-core
  path computes moments this path takes from collectives);
- the rank transforms (``rank_impl``):

  - ``"gather"``: one ``all_gather`` of the chain blocks, the in-core rank
    transforms on the full sample on every rank (kernel K13's sort on a
    CUDA float32 block), this rank's chains sliced back out;
  - ``"ring"``: tied ranks by the ring merge-count of ``ring_rank.py``,
    O(N_local) memory, on this rank's rows ``(P, N_local)`` (sorted by
    kernel K13 on a CUDA float32 block, as in the gather path);
  - ``"hist"`` (opt-in, approximate like ``rank_mode="fast"``): local
    histograms by kernel K3, one SUM all-reduce of the bin moments, then the
    local lookup by kernel K4 against the global CDF: no element leaves its
    rank;

- in gather and ring, the split-chain moments of a transform that only an
  R-hat reads (the tail R-hat; both transforms of the nested R-hat) come
  straight off the sort that ranked it, by the positions it carries
  (``ops/seghist.py``, kernel K11 on a CUDA float32 block): only the bulk
  values, whose ESS needs it, go back to (draw, chain) order.

Nested R-hat has a rank-local entry, ``rhat_nested_local``: each rank
passes its own block of chains, where the sampler left it, with the global
superchain ids, and its superchains must sit whole on it.
``rhat_nested_sharded`` hands each rank its block of the global sample,
superchains made contiguous, and calls it. Every collective goes through
``comm.py`` (the ``mdt.comm`` region, counted), which closes the layer
regions open around it and opens them again.

Results come back on every rank as full ``(P,)`` tensors (one ``all_gather``
over the ``params`` group), as JAX returns global arrays. Ranks compute the
replicated values (the gather path's tail R-hat) from identical inputs with
identical operations, so they agree bit for bit; the JAX package's
``_replicated_pmax`` exists only for ``shard_map``'s check of replicated
outputs, which has no counterpart here, and is left out.
"""

from __future__ import annotations

import math
from functools import partial

import numpy as np
import torch

from .. import backend
from ..diagnostics.ess_rhat import (
    ESSRhat,
    basic_ess_rhat,
    basic_rhat,
    bulk_tail_transforms,
    bulk_transform,
    check_maxlag,
    method_name,
    tail_ess,
    tail_parts,
)
from ..diagnostics.rhat_nested import by_kind, validate_superchain_ids
from ..kernels.fastrank import hist_moments, pack_tables
from ..kernels.radix_sort import sort_rows
from ..kernels.tiedrank import tied_blom
from ..ops.fastrank import (
    DEFAULT_NBINS,
    HistCDF,
    _fold_shift,
    _hist_scale,
    fast_rank_normalize_flat,
    fold_range,
    hist_quantile,
)
from ..ops.moments import ONE_CARD, nested_rhat_split
from ..ops.ranknorm import (
    _unsort,
    folded_rank_values_sorted,
    sort_with_positions,
    sorted_quantile,
)
from ..ops.seghist import nested_rhat_from_sorted, split_chain_stats_from_sorted
from ..utils.indices import unique_indices
from ..utils.layout import maybe_scalar
from ..utils.profiling import annotate, host_sync
from .comm import all_gather as _all_gather
from .comm import all_reduce as _sum
from .comm import all_reduce_max as _max
from .comm import mesh_chains
from .mesh import MeshConfig, canonical_host, shard_canonical
from .ring_rank import (
    RING,
    quantiles_from_positions,
    rank_normal_from_counts,
    ring_rank_counts,
)

_KINDS = ("rank", "bulk", "tail", "basic")
_RANK_IMPLS = ("auto", "gather", "ring", "hist")
_RING_AUTO_BYTES = 1 << 27  # ring above this full-sample size
# the hist path's bin counts are float32 sums: exact below 2^24 elements
_HIST_MAX_N = 1 << 24
NESTED = "mdt.nested"  # the region of the nested reductions' local work


def _all_gather_chains(xb: torch.Tensor, cfg: MeshConfig) -> torch.Tensor:
    """The full ``(draws, chains, P_local)`` sample from every rank's chain
    block (gathered stacked, then laid side by side along the chains)."""
    d, c_loc, p = xb.shape
    k = cfg.chain_shards
    out = _all_gather(xb, cfg.chain_group, k)
    return out.permute(1, 0, 2, 3).reshape(d, k * c_loc, p)


def gather_params(values: torch.Tensor, cfg: MeshConfig) -> torch.Tensor:
    """``(..., P_local)`` results of every parameter block laid side by
    side: ``(..., P)``, the same on every rank."""
    out = _all_gather(values, cfg.param_group, cfg.param_shards)
    return torch.movedim(out, 0, -2).reshape(*values.shape[:-1], -1)


# ---------------------------------------------------------------------------
# gather rank transform
# ---------------------------------------------------------------------------


def _gather_kernel(xb, cfg, kind, basic, q):
    """The in-core rank transforms on the gathered sample, the same on every
    rank; the ESS of this rank's chains of it."""
    if kind == "basic":
        return basic_ess_rhat(xb, **basic)
    c_loc, split = xb.shape[1], basic["split_chains"]
    mine = slice(cfg.chain_index * c_loc, (cfg.chain_index + 1) * c_loc)
    full = _all_gather_chains(xb, cfg)
    if kind == "bulk":
        z = bulk_transform(full, "exact", DEFAULT_NBINS)
        return basic_ess_rhat(z[:, mine], **basic)
    # one sort of the gathered sample serves the thresholds, the median and
    # both transforms
    if kind == "tail":
        t_lo, t_hi, rhat_tail = tail_parts(full, q, "exact", DEFAULT_NBINS,
                                           split)
        return tail_ess(xb, t_lo, t_hi, **basic), rhat_tail
    z, rhat_tail = bulk_tail_transforms(full, "exact", DEFAULT_NBINS, split)
    ess, rhat_bulk = basic_ess_rhat(z[:, mine], **basic)
    return ess, torch.maximum(rhat_tail, rhat_bulk)


# ---------------------------------------------------------------------------
# ring rank transform
# ---------------------------------------------------------------------------


def _ring_rank_parts(xb, cfg: MeshConfig, ps):
    """One local sort and one ring pass: ``(xs, order, z_sorted, quants,
    bad)``: this rank's rows ``(P, N_local)`` sorted (K13 on the card), the
    flat position of each value in its row, the rank-normal values in
    sorted order, the global type-7 quantiles ``(len(ps), P)`` and the
    NaN-poisoned rows."""
    d, c_loc, _ = xb.shape
    g = cfg.chain_group
    ntot = d * c_loc * cfg.chain_shards
    with annotate(RING):
        xs, order, nan = sort_with_positions(xb)
        bad = _max(nan.to(xs.dtype), g) > 0
        t, gpos = ring_rank_counts(xs, g, cfg.chain_index, cfg.chain_shards)
        z_sorted = rank_normal_from_counts(t, ntot, xs.dtype)
        del t
        quants = quantiles_from_positions(xs, gpos, ntot, ps, g)
        return (xs, order, z_sorted,
                torch.where(bad[None], torch.nan, quants), bad)


def _ring_fold(xs, order, med, cfg: MeshConfig, ntot: int):
    """Rank-normal values of ``|x - med|`` in this rank's fold-sorted order,
    with their local flat positions: a second local sort of the rows and
    ring pass over the ``ntot`` elements of the chain group."""
    with annotate(RING):
        fs, fidx = sort_rows(torch.abs(xs - med[:, None]))
        forder = order.gather(1, fidx)
        del fidx
        t, _ = ring_rank_counts(fs, cfg.chain_group, cfg.chain_index,
                                cfg.chain_shards, positions=False)
        return rank_normal_from_counts(t, ntot, xs.dtype), forder


def _ring_kernel(xb, cfg, kind, basic, q):
    d, c_loc, p = xb.shape
    ps = (q / 2, 1 - q / 2, 0.5) if kind == "tail" else (0.5,)
    xs, order, z_sorted, quants, bad = _ring_rank_parts(xb, cfg, ps)

    def tail_rhat():  # a second ring pass, on the folded values
        zf, forder = _ring_fold(xs, order, quants[-1], cfg,
                                d * c_loc * cfg.chain_shards)
        with annotate(RING):
            stats = split_chain_stats_from_sorted(
                zf, forder, d, c_loc, basic["split_chains"], basic["group"])
            return torch.where(bad, torch.nan, stats.rhat)

    if kind == "tail":
        return tail_ess(xb, quants[0], quants[1], **basic), tail_rhat()
    # the ESS needs the bulk values in (draw, chain) order: one scatter
    z = torch.where(bad[None], torch.nan, _unsort(z_sorted, order))
    ess, rhat_bulk = basic_ess_rhat(z.reshape(d, c_loc, p), **basic)
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
    xf = xb.reshape(d * c_loc, p).contiguous()
    z, cdf = _sharded_fast_rank(xf, cfg, nbins)
    if kind == "tail":
        t_lo, t_hi, med = hist_quantile(cdf, (q / 2, 1 - q / 2, 0.5), nbins)
        ess = tail_ess(xb, t_lo, t_hi, **basic)
    else:
        med = hist_quantile(cdf, (0.5,), nbins)[0]
        ess, rhat_bulk = basic_ess_rhat(z.reshape(d, c_loc, p), **basic)
        if kind == "bulk":
            return ess, rhat_bulk
    z_tail = _sharded_fold_rank(xf, cdf, med, cfg, nbins)
    rhat_tail = torch.where(cdf.bad, torch.nan,
                            basic_rhat(z_tail.reshape(d, c_loc, p),
                                       basic["split_chains"], basic["group"]))
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
    method = method_name(autocov_method)
    return "direct" if method == "kernel" else method


def local_ess_rhat(xb, cfg: MeshConfig, *, kind: str, split_chains: int,
                   maxlag: int, method, relative: bool, q, rank_impl: str,
                   rank_nbins: int):
    """``(ess, rhat)`` of this rank's parameter block, ``(P_local,)`` each,
    from its ``(draws, chains / k, P_local)`` block; ``rank_impl`` resolved,
    ``maxlag`` already clamped to ``niter - 4``, ``q`` the tail kind's
    ``tail_prob``."""
    if kind not in _KINDS:
        raise ValueError(f"unsupported kind {kind!r}")
    basic = dict(split_chains=split_chains, maxlag=maxlag, method=method,
                 relative=relative, group=mesh_chains(cfg))
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
    check_maxlag(maxlag)
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


def _nested_from_sort(values_sorted, positions, *, shape, split: int,
                      nsuper: int, group, rows, bad):
    """Nested R-hat of a transform's values in sorted order, by the positions
    the sort carries in a sample of ``shape``; NaN where ``bad``."""
    with annotate(NESTED):
        r = nested_rhat_from_sorted(values_sorted, positions, shape[0],
                                    shape[1], split, nsuper, group, rows)
        return torch.where(bad, torch.nan, r)


def _nested_gather(xb, cfg, kind, nsuper: int, split: int, rows):
    """The rank kinds from one sort of the gathered sample, the same on
    every rank: both transforms' split-chain moments straight off the sort,
    neither routed back to (draw, chain) order. ``rows``: the global split
    chains' order that makes superchains contiguous (None: they are)."""
    full = _all_gather_chains(xb, cfg)
    with annotate("mdt.rank.exact"):
        xs, order, bad = sort_with_positions(full)
    nested = partial(_nested_from_sort, shape=full.shape, split=split,
                     nsuper=nsuper, group=ONE_CARD, rows=rows, bad=bad)

    def bulk():
        with annotate("mdt.rank.exact"):
            z = tied_blom(xs)
        return nested(z, order)

    def tail():
        with annotate("mdt.rank.exact"):
            med = torch.where(bad, torch.nan, sorted_quantile(xs, 0.5))
            zf, forder = folded_rank_values_sorted(xs, order, med)
        return nested(zf, forder)

    return by_kind(kind, bulk, tail)


def _nested_ring(xb, cfg, kind, nsuper_local: int, split: int, rows):
    """Ranks by the ring merge-count; both transforms' split-chain moments
    straight off this rank's sorts."""
    d, c_loc, _ = xb.shape
    xs, order, z_sorted, quants, bad = _ring_rank_parts(xb, cfg, (0.5,))
    nested = partial(_nested_from_sort, shape=(d, c_loc), split=split,
                     nsuper=nsuper_local, group=mesh_chains(cfg), rows=rows,
                     bad=bad)
    held = [z_sorted]  # the bulk values, let go before the fold's are made
    del z_sorted
    return by_kind(kind, lambda: nested(held.pop(), order),
                   lambda: nested(*_ring_fold(xs, order, quants[0], cfg,
                                              d * c_loc * cfg.chain_shards)))


def _nested_hist(xb, cfg, kind, nsuper_local: int, split: int, nbins: int,
                 rows):
    """Ranks by the distributed histogram (K3, one all-reduce, K4)."""
    d, c_loc, p = xb.shape
    xf = xb.reshape(d * c_loc, p).contiguous()
    z, cdf = _sharded_fast_rank(xf, cfg, nbins)

    def nested(values):
        with annotate(NESTED):
            r = nested_rhat_split(values.reshape(d, c_loc, p), nsuper_local,
                                  split, mesh_chains(cfg), rows)
            return torch.where(cdf.bad, torch.nan, r)

    def tail():
        med = hist_quantile(cdf, (0.5,), nbins)[0]
        return nested(_sharded_fold_rank(xf, cdf, med, cfg, nbins))

    return by_kind(kind, lambda: nested(z), tail)


def _local_superchains(superchain_ids, c_loc: int, cfg: MeshConfig):
    """``(global chain order, local chain order, nsuper)`` of the global
    ids, one a chain in global chain order, for this rank's block of
    ``c_loc`` chains: each order makes the superchains contiguous (None
    where they already are), and every superchain must lie whole in one
    rank's block."""
    k = cfg.chain_shards
    ids = np.asarray(superchain_ids)
    if ids.ndim != 1 or len(ids) != c_loc * k:
        raise ValueError(
            f"`superchain_ids` has length {ids.size} but the mesh's "
            f"{k} chain shards hold {c_loc} chains each ({c_loc * k})")
    perm, nsuper = validate_superchain_ids(ids, c_loc * k)
    groups = perm.reshape(nsuper, -1)
    owner = groups // c_loc
    split = np.flatnonzero((owner != owner[:, :1]).any(1))
    if split.size:
        uniq, _ = unique_indices(ids)
        raise ValueError(
            f"superchain {uniq[split[0]]!r} spans the blocks of several "
            f"chain shards: each rank's {c_loc} chains must hold whole "
            "superchains (permute the chains so that each superchain sits "
            "on one rank, as rhat_nested_sharded does)")
    i = cfg.chain_index
    local = groups[owner[:, 0] == i].reshape(-1) - i * c_loc
    return _unless_identity(perm), _unless_identity(local), nsuper


def _unless_identity(order):
    return None if np.array_equal(order, np.arange(len(order))) else order


def _moment_rows(chain_order, split: int, device):
    """The split chains' rows (chain-major) in ``chain_order``, on the
    device, or None."""
    if chain_order is None:
        return None
    rows = (chain_order[:, None] * split + np.arange(split)).reshape(-1)
    with host_sync("superchain_ids"):
        return torch.as_tensor(rows, device=device)


def rhat_nested_local(block, superchain_ids, cfg: MeshConfig, *,
                      kind: str = "rank", split_chains: int = 2,
                      rank_impl: str = "auto",
                      rank_nbins: int = DEFAULT_NBINS):
    """Nested R-hat over the mesh from the chains each rank holds: every
    rank calls it with its own ``(draws, chains / k, P / m)`` block, on its
    device, and the **global** ``superchain_ids`` (one a global chain, in
    global chain order: rank ``i`` of the chain shards holds chains ``[i
    c, (i + 1) c)``), and gets the same ``(P,)`` result bit for bit.

    Each rank's chains must form whole superchains, in any order; no data
    crosses ranks to regroup them (a ``ValueError`` says which superchain
    does not). The within-superchain level reduces locally and the across
    level is SUM all-reduces. ``rank_impl`` is resolved from the global
    shape as in :func:`ess_rhat_sharded` (``"auto"``: the ring above 2^27
    bytes of global sample). Kinds as in ``rhat_nested``.
    """
    if kind not in _KINDS:
        raise ValueError(
            f"the `kind` `{kind}` is not supported by `rhat_nested_local`")
    with annotate("mdt.rhat_nested"):
        if block.dim() != 3:
            raise ValueError("rhat_nested_local takes a (draws, chains, "
                             f"params) block, got {tuple(block.shape)}")
        d, c_loc, p_loc = block.shape
        if not block.is_floating_point():  # as utils.layout.canonicalize
            block = block.to(torch.get_default_dtype())
        backend.use_kernels(block)  # a CUDA block of another dtype raises
        gperm, lperm, nsuper = _local_superchains(superchain_ids, c_loc, cfg)
        shape = (d, c_loc * cfg.chain_shards, p_loc * cfg.param_shards)
        impl = _resolve_rank_impl(rank_impl, shape, block.element_size(),
                                  kind)
        nsuper_local = nsuper // cfg.chain_shards
        if impl == "gather" and kind != "basic":
            r = _nested_gather(block, cfg, kind, nsuper, split_chains,
                               _moment_rows(gperm, split_chains, block.device))
        else:
            rows = _moment_rows(lperm, split_chains, block.device)
            if kind == "basic":
                with annotate(NESTED):
                    r = nested_rhat_split(block, nsuper_local, split_chains,
                                          mesh_chains(cfg), rows)
            elif impl == "hist":
                r = _nested_hist(block, cfg, kind, nsuper_local, split_chains,
                                 rank_nbins, rows)
            else:
                r = _nested_ring(block, cfg, kind, nsuper_local, split_chains,
                                 rows)
        return gather_params(r, cfg)


def rhat_nested_sharded(samples, superchain_ids, cfg: MeshConfig, *,
                        kind: str = "rank", split_chains: int = 2,
                        rank_impl: str = "auto",
                        rank_nbins: int = DEFAULT_NBINS):
    """Nested R-hat over the mesh; every rank calls it with the same global
    sample and ids and gets the same result.

    The chains are permuted on the host so that superchains are contiguous,
    and each chain shard holds whole superchains: the number of superchains
    must divide evenly across the chain shards. Each rank's block then goes
    to :func:`rhat_nested_local`. ``rank_impl`` and outputs as in
    :func:`ess_rhat_sharded`.
    """
    x3, pshape = canonical_host(samples, min_ndim=2)
    perm, nsuper = validate_superchain_ids(superchain_ids, x3.shape[1])
    kshards = cfg.chain_shards
    if nsuper % kshards:
        raise ValueError(
            f"number of superchains ({nsuper}) must divide evenly across the "
            f"chain shards ({kshards})")
    xb = shard_canonical(x3, cfg, chain_order=perm)
    ids = np.asarray(superchain_ids)[perm]
    r = rhat_nested_local(xb, ids, cfg, kind=kind, split_chains=split_chains,
                          rank_impl=rank_impl, rank_nbins=rank_nbins)
    return maybe_scalar(r, pshape)
