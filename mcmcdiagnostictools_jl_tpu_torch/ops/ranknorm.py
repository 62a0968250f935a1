"""Sort-based rank transforms, the exact rank mode (counterpart of the JAX
package's ``ops/ranknorm.py``).

On the canonical ``(draws, chains, P)`` layout, batched over parameters with
one ``torch.sort`` along the joint (draw, chain) axis. Reference conventions
(src/utils.jl:148-193): tied ("average") ranks, the Blom alpha=3/8 transform
``(r - 3/8) / (n + 1/4)``, the inverse normal CDF, type-7 quantiles, folding
around the per-parameter median. A NaN in a parameter slice poisons that
slice.

The TPU's workarounds for its bitonic sort (``valley_sort_2d``, the
``fold_impl`` plumbing, the seghist routing) are not ported: a GPU sorts
with ``torch.sort`` and scatters values back to (draw, chain) order cheaply.
"""

from __future__ import annotations

import torch


def _flatten_sample(x3: torch.Tensor) -> torch.Tensor:
    d, c, p = x3.shape
    return x3.reshape(d * c, p)


def sort_with_positions(x3: torch.Tensor):
    """One sort of the flattened sample: ``(xs, order, bad)`` — ascending
    values ``(N, P)`` (NaN last), the original row of each, and the
    ``(P,)`` NaN-poisoned columns."""
    xf = _flatten_sample(x3)
    xs, order = torch.sort(xf, dim=0)
    return xs, order, torch.isnan(xf).any(0)


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


def folded_rank_values_sorted(xs, order, med):
    """Rank-normal values of ``|x - med|`` in fold-sorted order, with the
    original flat row of each: ``(zf_sorted, forder)``."""
    folded = torch.abs(xs - med[None, :])
    fs, fidx = torch.sort(folded, dim=0)
    forder = order.gather(0, fidx)
    return _blom_normal(_avg_ranks_sorted(fs), xs.shape[0]), forder


def folded_rank_normalize(xs, order, med, shape3) -> torch.Tensor:
    """``rank_normalize(|x - med|)`` back in ``(draws, chains, P)`` order,
    reusing the sort of ``x`` (the tail transform, src/ess_rhat.jl:413)."""
    zf_sorted, forder = folded_rank_values_sorted(xs, order, med)
    return _unsort(zf_sorted, forder).reshape(shape3)
