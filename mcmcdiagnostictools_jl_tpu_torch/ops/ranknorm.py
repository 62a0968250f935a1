"""Sort-based rank transforms, the exact rank mode (counterpart of the JAX
package's ``ops/ranknorm.py``).

On the canonical ``(draws, chains, P)`` layout, batched over parameters with
one ``torch.sort`` along the joint (draw, chain) axis. Reference conventions
(src/utils.jl:148-193): tied ("average") ranks, the Blom alpha=3/8 transform
``(r - 3/8) / (n + 1/4)``, the inverse normal CDF, type-7 quantiles, folding
around the per-parameter median. A NaN in a parameter slice poisons that
slice.

The tail transform reuses the sort of ``x``: along sorted ``x`` the folded
keys ``|x - med|`` fall, then rise, so ``folded_rank_values_sorted`` sorts
them either with a stable ``torch.sort`` or, with ``merge="two_sort"``, as
the merge of two sorted runs (kernel K10 on a CUDA float32 tensor, the JAX
package's two-axis ``valley_sort_2d`` on any other). It returns the values in
fold-sorted order with their original positions, and the tail R-hat takes
its split-chain moments straight from them (``ops/seghist.py``): nothing is
scattered back to (draw, chain) order.
"""

from __future__ import annotations

import torch

from ..kernels.valley import _VALLEY_BLOCK, valley_merge, valley_sort_2d

__all__ = ["_VALLEY_BLOCK", "valley_sort_2d", "folded_rank_values_sorted",
           "sort_with_positions", "rank_normalize", "rank_normalize_from_sort",
           "sorted_quantile", "batched_quantile", "batched_median",
           "fold_around_median"]


def _flatten_sample(x3: torch.Tensor) -> torch.Tensor:
    d, c, p = x3.shape
    return x3.reshape(d * c, p)


def _has_nan_cols(xf: torch.Tensor) -> torch.Tensor:
    """``(N, P) -> (P,)`` bool, True where the column holds a NaN."""
    return torch.isnan(xf).any(0)


def sort_with_positions(x3: torch.Tensor):
    """One sort of the flattened sample: ``(xs, order, bad)`` — ascending
    values ``(N, P)`` (NaN last), the original row of each, and the
    ``(P,)`` NaN-poisoned columns. The sort is stable: tied values keep
    their row order on every device, and that is the order in which a
    column whose median is NaN (every folded key NaN) is ranked."""
    xf = _flatten_sample(x3)
    xs, order = torch.sort(xf, dim=0, stable=True)
    return xs, order, _has_nan_cols(xf)


def _avg_ranks_sorted(xs: torch.Tensor) -> torch.Tensor:
    """Tied ("average") 1-based ranks of presorted ``(N, P)`` values, in
    sorted order: each run of equal values gets the mean of its positions
    (run start and end by cummax / reverse cummin over the run boundaries).

    The scans run along the last, contiguous axis of the transposed values:
    PyTorch's scan along an outer axis gives each column to one thread, which
    took ~0.5 s per scan at (1.28M, 256) on an H100.
    """
    xt = xs.t().contiguous()
    p, n = xt.shape
    idx = torch.arange(n, dtype=torch.int32, device=xs.device).expand(p, n)
    neq_prev = xt[:, 1:] != xt[:, :-1]
    edge = torch.ones((p, 1), dtype=torch.bool, device=xs.device)
    first_of_group = torch.cat([edge, neq_prev], dim=1)
    last_of_group = torch.cat([neq_prev, edge], dim=1)
    start = torch.cummax(torch.where(first_of_group, idx, 0), dim=1).values
    end = torch.where(last_of_group, idx, n - 1).flip(1)
    end = torch.cummin(end, dim=1).values.flip(1)
    ranks = (start.to(xs.dtype) + end.to(xs.dtype)) * 0.5 + 1.0
    return ranks.t().contiguous()


def _blom_normal(ranks: torch.Tensor, n: int) -> torch.Tensor:
    return torch.special.ndtri((ranks - 0.375) / (n + 0.25))


def _unsort(values_sorted: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Scatter sorted values back to their original rows."""
    return torch.empty_like(values_sorted).scatter_(0, order, values_sorted)


def rank_normalize_from_sort(xs, order, bad):
    """Flat ``(N, P)`` rank-normal sample in original row order, from a
    ``sort_with_positions`` result."""
    z = _unsort(_blom_normal(_avg_ranks_sorted(xs), xs.shape[0]), order)
    return torch.where(bad[None, :], torch.nan, z)


def rank_normalize(x3: torch.Tensor) -> torch.Tensor:
    """Rank-normalize each parameter slice over its joint (draw, chain)
    sample (reference ``_rank_normalize``, src/utils.jl:169-193)."""
    xs, order, bad = sort_with_positions(x3)
    return rank_normalize_from_sort(xs, order, bad).reshape(x3.shape)


def sorted_quantile(xs: torch.Tensor, p: float) -> torch.Tensor:
    """Type-7 quantile from presorted ``(N, P)`` values: linear
    interpolation at ``h = (N-1) p`` (Julia ``Statistics.quantile``)."""
    n = xs.shape[0]
    h = (n - 1) * torch.tensor(p, dtype=xs.dtype)  # host scalar, xs's dtype
    lo = min(max(int(torch.floor(h)), 0), n - 1)
    hi = min(lo + 1, n - 1)
    g = (h - lo).to(xs.device)
    return xs[lo] + g * (xs[hi] - xs[lo])


def folded_rank_values_sorted(xs, order, med, *, merge: str | None = None):
    """Rank-normal values of ``|x - med|`` in fold-sorted order, with the
    original flat row of each: ``(zf_sorted, forder)``, from the sort of
    ``x`` (``xs``, ``order``) and the column medians ``med``.

    ``merge``: ``None`` sorts the folded keys with a stable ``torch.sort``;
    ``"two_sort"`` merges the valley (``kernels.valley.valley_merge``: K10 on
    a CUDA float32 tensor, ``valley_sort_2d`` on any other). The keys are
    bit-identical either way and only the order of tied keys differs, which
    the tied-average ranks absorb. A column whose median is NaN keeps its
    ``xs`` order in both.
    """
    if merge == "two_sort":
        fs, forder = valley_merge(xs, order, med)
    else:
        fs, fidx = torch.sort(torch.abs(xs - med[None, :]), dim=0, stable=True)
        forder = order.gather(0, fidx)
    return _blom_normal(_avg_ranks_sorted(fs), xs.shape[0]), forder


def batched_quantile(x3: torch.Tensor, p: float) -> torch.Tensor:
    """Per-parameter type-7 quantile over the joint (draw, chain) sample,
    ``(P,)``, NaN where the parameter slice holds a NaN."""
    xf = _flatten_sample(x3)
    q = sorted_quantile(torch.sort(xf, dim=0).values, p)
    return torch.where(_has_nan_cols(xf), torch.nan, q)


def batched_median(x3: torch.Tensor) -> torch.Tensor:
    """Per-parameter median (type-7 quantile at 1/2), ``(P,)``."""
    return batched_quantile(x3, 0.5)


def fold_around_median(x3: torch.Tensor) -> torch.Tensor:
    """``|x - median|`` per parameter slice (reference
    ``_fold_around_median``, src/utils.jl:148-158)."""
    return torch.abs(x3 - batched_median(x3)[None, None, :])
