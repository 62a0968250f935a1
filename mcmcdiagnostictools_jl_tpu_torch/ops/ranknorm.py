"""Sort-based rank transforms, the exact rank mode (counterpart of the JAX
package's ``ops/ranknorm.py``).

The public functions take the canonical ``(draws, chains, P)`` layout. Inside,
the flattened sample ``(N, P)`` (``N = draws * chains``, flat row ``draw *
chains + chain``) is transposed once into ``(P, N)``, so that each
parameter's joint sample is one contiguous row: the sort (K13, a stable
radix sort of all rows at once that carries each value's flat row), the
tied ranks with their Blom normal scores (K12, which also scatters the
bulk's back along the rows), the fold merge (K10) and the split-chain
moments (K11) all run along the last, contiguous axis. Reference
conventions (src/utils.jl:148-193): tied ("average") ranks, the Blom
alpha=3/8 transform ``(r - 3/8) / (n + 1/4)``, the inverse normal CDF,
type-7 quantiles, folding around the per-parameter median. A NaN in a
parameter slice poisons that slice.

The tail transform reuses the sort of ``x``: along a sorted row the folded
keys ``|x - med|`` fall, then rise, so ``folded_rank_values_sorted`` sorts
them either with K13 or, with ``merge="two_sort"``, as the merge of two
sorted runs (kernel K10 on a CUDA float32 tensor, the JAX package's
two-axis ``valley_sort_2d`` written for rows on any other). It returns the
values in fold-sorted order with their original flat rows, and the tail
R-hat takes its split-chain moments straight from them
(``ops/seghist.py``): nothing is scattered back to (draw, chain) order.
"""

from __future__ import annotations

import math

import torch

from ..kernels.radix_sort import sort_rows, sort_rows_keys
from ..kernels.tiedrank import (  # noqa: F401  (K12's plain pieces)
    _avg_ranks_sorted, _scatter_rows, blom_scores, tied_blom)
from ..kernels.valley import _VALLEY_BLOCK, valley_merge, valley_sort_2d
from ..utils.profiling import host_sync

__all__ = ["_VALLEY_BLOCK", "valley_sort_2d", "folded_rank_values_sorted",
           "sort_with_positions", "rank_normalize", "rank_normalize_from_sort",
           "sorted_quantile", "batched_quantile", "batched_median",
           "fold_around_median", "tiedrank"]


def _flatten_sample(x3: torch.Tensor) -> torch.Tensor:
    d, c, p = x3.shape
    return x3.reshape(d * c, p)


def _has_nan_cols(xf: torch.Tensor) -> torch.Tensor:
    """``(N, P) -> (P,)`` bool, True where the column holds a NaN: one read
    of an unsorted sample."""
    return torch.isnan(xf).any(0)


def _nan_rows(xs: torch.Tensor) -> torch.Tensor:
    """``(P, N) -> (P,)`` bool, True where the SORTED row holds a NaN,
    reading only its two ends. The exact mode's row sort (K13, and its plain
    version on every other device) orders floats by their bits as the
    card's radix sort does, so a NaN with the sign bit set (``0xffc00000``:
    ``-np.nan``, or ``inf - inf`` on the host) sorts before ``-inf`` and one
    without it after ``+inf``; the CPU's ``torch.sort`` puts every NaN
    last. Either way a row's NaNs sit at its ends, and its first or last
    entry is NaN exactly when it holds one."""
    return torch.isnan(xs[:, 0]) | torch.isnan(xs[:, -1])


# rows a block of the two-pass transpose (picked from 8-128 on an H100): 2.5
# ms each way at (1.28M, 256) against 11.1 and 5.3 ms for
# ``.t().contiguous()`` (chip_smoke.py phase 3; PERF.md, Findings PR 10)
_TBLOCK = 16


def _transpose(x: torch.Tensor) -> torch.Tensor:
    """``(a, b) -> (b, a)``, contiguous, in two copies that each read and
    write whole sectors: blocks of ``_TBLOCK`` rows to ``(a / _TBLOCK, b,
    _TBLOCK)`` (a block's rows are read together), then the blocks into
    place (runs of ``_TBLOCK`` on both sides). PyTorch's one transposing
    copy reads or writes 4 bytes a sector. The rows past the last whole
    block go in one small copy."""
    a, b = x.shape
    out = x.new_empty((b, a))
    m = a - a % _TBLOCK
    if m:
        y = x[:m].reshape(m // _TBLOCK, _TBLOCK, b).transpose(1, 2).contiguous()
        out[:, :m].view(b, m // _TBLOCK, _TBLOCK).copy_(y.transpose(0, 1))
    if m < a:
        out[:, m:] = x[m:].t()
    return out


def _rows(x3: torch.Tensor) -> torch.Tensor:
    """``(draws, chains, P) -> (P, N)``, contiguous: each parameter's joint
    sample one row, in flat row order."""
    return _transpose(_flatten_sample(x3))


def sort_with_positions(x3: torch.Tensor):
    """One sort of the sample's rows (K13): ``(xs, order, bad)`` — ``xs``
    ``(P, N)``, each row ascending (its NaNs at one end or both:
    ``_nan_rows``), ``order`` the original flat row ``draw * chains +
    chain`` of each value, and the ``(P,)`` NaN-poisoned rows. What is
    computed from a poisoned row is masked by ``bad``, and its median set to
    NaN before the fold. The sort is stable: tied values keep their flat
    order on every device, and that is the order in which a row whose
    median is NaN (every folded key NaN) is ranked."""
    xs, order = sort_rows(_rows(x3))
    return xs, order, _nan_rows(xs)


def _unsort(values_sorted: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """``(N, P)`` row-major, value ``values_sorted[p, j]`` at row ``order[p,
    j]`` of column ``p``: the sorted rows ``(P, N)`` scattered along each row
    (a row's scattered writes fill its sectors while they sit in the L2),
    then transposed. A scatter straight into the row-major output writes 4
    bytes to a new sector each time: 24 ms against 10 at (1.28M, 256) on an
    H100 (PERF.md). The plain version of the bulk's way back; K12 scatters
    along the rows itself (``tied_blom(xs, order)``)."""
    return _transpose(_scatter_rows(values_sorted, order))


def tiedrank(xf: torch.Tensor) -> torch.Tensor:
    """Tied ("average") 1-based ranks along axis 0 of ``xf`` ``(N, P)``
    (the JAX package's ``ops.tiedrank``; StatsBase.tiedrank, reference
    src/utils.jl:180): equal values share the mean of their positions. A NaN
    equals nothing and ranks after every number, the NaNs of a column in
    their order along it, on every device: their sign bits are cleared
    first, since the row sort (K13) puts a sign-bit NaN first."""
    x = torch.where(torch.isnan(xf), torch.nan, xf)
    xs, order = sort_rows(_transpose(x))
    return _transpose(tied_blom(xs, order, blom=False))


def rank_normalize_from_sort(xs, order, bad):
    """Flat ``(N, P)`` rank-normal sample in original row order, from a
    ``sort_with_positions`` result: the scores scattered back along the rows
    (K12 with ``order`` and ``bad``), then transposed."""
    return _transpose(tied_blom(xs, order, bad))


def rank_normalize(x3: torch.Tensor) -> torch.Tensor:
    """Rank-normalize each parameter slice over its joint (draw, chain)
    sample (reference ``_rank_normalize``, src/utils.jl:169-193)."""
    xs, order, bad = sort_with_positions(x3)
    return rank_normalize_from_sort(xs, order, bad).reshape(x3.shape)


def sorted_quantile(xs: torch.Tensor, p: float) -> torch.Tensor:
    """Type-7 quantile ``(P,)`` of presorted rows ``xs`` ``(P, N)``: linear
    interpolation at ``h = (N-1) p`` (Julia ``Statistics.quantile``), ``h``
    formed in float64 as Julia forms it (in float32 ``h`` rounds from ``N =
    2^24`` on, and the median of an even row of 25M entries became its upper
    middle value), the weight ``g = h - floor(h)`` applied in ``xs``'s
    dtype."""
    n = xs.shape[1]
    lo, hi, g = quantile_index(n, p)
    with host_sync("quantile_offset"):
        g = torch.tensor(g, dtype=xs.dtype).to(xs.device)
    return xs[:, lo] + g * (xs[:, hi] - xs[:, lo])


def quantile_index(n: int, p: float) -> tuple[int, int, float]:
    """``(lo, hi, g)`` of the type-7 quantile ``p`` of ``n`` sorted values:
    the 0-based order statistics it interpolates and the weight of ``hi``,
    from ``h = (n - 1) p`` in float64."""
    h = (n - 1) * float(p)
    lo = min(max(math.floor(h), 0), n - 1)
    return lo, min(lo + 1, n - 1), h - lo


def folded_rank_values_sorted(xs, order, med, *, merge: str | None = None):
    """Rank-normal values of ``|x - med|`` in fold-sorted order, with the
    original flat row of each: ``(zf_sorted, forder)``, both ``(P, N)``,
    from the sort of ``x`` (``xs``, ``order``) and the row medians ``med``.

    ``merge``: ``None`` sorts the folded keys along each row (K13) and
    gathers ``order`` by their positions; ``"two_sort"`` merges the valley
    (``kernels.valley.valley_merge``: K10 on a CUDA float32 tensor,
    ``valley_sort_2d`` on any other). The keys are bit-identical either way
    and only the order of tied keys differs, which the tied-average ranks
    absorb. A row whose median is NaN keeps its ``xs`` order in both.
    """
    if merge == "two_sort":
        fs, forder = valley_merge(xs, order, med)
    else:
        fs, fidx = sort_rows(torch.abs(xs - med[:, None]))
        forder = order.gather(1, fidx)
    return tied_blom(fs), forder


def batched_quantile(x3: torch.Tensor, p: float) -> torch.Tensor:
    """Per-parameter type-7 quantile over the joint (draw, chain) sample,
    ``(P,)``, NaN where the parameter slice holds a NaN."""
    xs = sort_rows_keys(_rows(x3))
    return torch.where(_nan_rows(xs), torch.nan, sorted_quantile(xs, p))


def batched_median(x3: torch.Tensor) -> torch.Tensor:
    """Per-parameter median (type-7 quantile at 1/2), ``(P,)``."""
    return batched_quantile(x3, 0.5)


def fold_around_median(x3: torch.Tensor) -> torch.Tensor:
    """``|x - median|`` per parameter slice (reference
    ``_fold_around_median``, src/utils.jl:148-158)."""
    return torch.abs(x3 - batched_median(x3)[None, None, :])
