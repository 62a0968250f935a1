"""Histogram/CDF rank transform, the fast rank mode (counterpart of the JAX
package's ``ops/fastrank.py``; the method, its tie-exactness and its error
bound are documented there).

1. per-column ``[lo, hi]`` from one min/max pass (kernel K2);
2. per-column bin counts and within-bin frac sums over ``nbins`` equal-width
   bins (kernel K3);
3. exclusive prefix ``C[k]`` = elements in bins below ``k``;
4. per element, in place, the mean-anchored interpolated rank (kernel K4)
   ``C[b] + clip(frac * cnt[b] + cnt[b] (1/2 - fm[b]), 0, cnt[b]) + 1/2``,
   then Blom + ``ndtri`` as in the exact mode.

Error bound: ``|rank_fast - rank_exact| <= cnt[b]`` for an element of a
mixed bin, exact for pure and singleton bins, so ESS/R-hat track the exact
mode to ~1e-3 at the default 4096 bins on continuous samples. No sort, no
inverse permutation: (draw, chain) order never leaves the array.

On the card the three steps are the hand-written kernels; on the CPU their
plain versions (``kernels/fastrank.py``). The small per-column work (prefix
sums, the Blom transform, quantile inversion) is plain PyTorch on both, as
the JAX package keeps it outside Pallas.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.fastrank import (
    bins_from_scale,
    column_minmax,
    hist_moments,
    rank_lookup,
)

DEFAULT_NBINS = 4096

__all__ = [
    "DEFAULT_NBINS", "HistCDF", "build_hist_cdf", "column_minmax",
    "fast_rank_bulk_tail", "fast_rank_normalize", "fast_rank_normalize_flat",
    "hist_quantile", "hist_rank_value", "interpolated_ranks", "z_from_ranks",
]


class HistCDF(NamedTuple):
    """Per-column histogram CDF over ``nbins`` equal-width bins.

    ``cum``: (nbins+1, P) float32 prefix counts (``cum[0] = 0``);
    ``fm``: (nbins, P) mean within-bin position (1/2 for empty bins);
    ``lo``/``hi``: (P,) bin range (degenerate columns: lo == hi);
    ``n``: element count; ``bad``: (P,) NaN-poisoned columns.
    """

    cum: torch.Tensor
    fm: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    n: int
    bad: torch.Tensor

    @property
    def counts(self):
        return self.cum[1:] - self.cum[:-1]


def _hist_scale(lo, hi, nbins: int):
    """``nbins / (hi - lo)``, 0 for degenerate columns, in at least f32."""
    ct = torch.promote_types(lo.dtype, torch.float32)
    width = hi.to(ct) - lo.to(ct)
    return torch.where(width > 0, nbins / width, 0.0)


def _bin_coords(xf, lo, hi, nbins: int):
    """Bin index and within-bin position of every element (NaN -> bin 0;
    elements at ``hi`` land in the last bin with frac 1)."""
    return bins_from_scale(xf, lo, _hist_scale(lo, hi, nbins), nbins)


def build_hist_cdf(xf: torch.Tensor, nbins: int = DEFAULT_NBINS,
                   minmax=None) -> HistCDF:
    """Histogram CDF of a flat contiguous ``(N, P)`` sample. ``minmax``: a
    precomputed ``(lo, hi, bad)`` (the fold transform derives it)."""
    lo, hi, bad = column_minmax(xf) if minmax is None else minmax
    cnt, s1 = hist_moments(xf, lo, _hist_scale(lo, hi, nbins), nbins)
    fm = torch.where(cnt > 0, s1 / cnt.clamp(min=1.0), 0.5)
    cum = torch.cat([cnt.new_zeros((1, cnt.shape[1])), cnt.cumsum(0)], dim=0)
    return HistCDF(cum, fm, lo, hi, xf.shape[0], bad)


def interpolated_ranks(xf: torch.Tensor, cdf: HistCDF, nbins: int):
    """Per-element mean-anchored rank in ``[1/2, n + 1/2]``, original order.
    Degenerate (constant) columns get the exact tied rank ``(n+1)/2``."""
    cnt = cdf.counts
    tables = torch.stack([cdf.cum[:-1], cnt, cnt * (0.5 - cdf.fm)], dim=0)
    rank = rank_lookup(xf, cdf.lo, _hist_scale(cdf.lo, cdf.hi, nbins), tables,
                       nbins).to(xf.dtype)
    degenerate = (cdf.hi <= cdf.lo)[None, :]
    return torch.where(degenerate, (cdf.n + 1) * 0.5, rank)


def z_from_ranks(rank, n: int, bad):
    """Blom alpha=3/8 + inverse normal CDF, NaN-poisoned columns masked."""
    z = torch.special.ndtri((rank - 0.375) / (n + 0.25))
    return torch.where(bad[None, :], torch.nan, z)


def hist_rank_value(cdf: HistCDF, h: float, nbins: int):
    """Value at 1-based rank ``h`` — the inverse of the mean-anchored rank
    map, ``(P,)``, accurate to one bin width."""
    cum = cdf.cum
    width = (cdf.hi - cdf.lo) / nbins
    hv = torch.full(cdf.lo.shape, h, dtype=cum.dtype, device=cum.device)
    # ranks in bin b span [cum[b] + 1/2, cum[b+1] + 1/2]
    k = ((cum + 0.5 <= hv[None, :]).sum(0) - 1).clamp(0, nbins - 1)
    kk = k[None, :]
    c_lo = cum.gather(0, kk)[0]
    cnt = cdf.counts.gather(0, kk)[0]
    fm = cdf.fm.gather(0, kk)[0]
    # invert rank = c_lo + clip(frac*cnt + cnt*(1/2 - fm), 0, cnt) + 1/2
    g = torch.minimum((hv - 0.5 - c_lo).clamp(min=0.0), cnt)
    frac = torch.where(cnt > 0, g / cnt.clamp(min=1.0) + fm - 0.5, 0.5)
    frac = frac.clamp(0.0, 1.0)
    v = cdf.lo + (k.to(cum.dtype) + frac) * width
    v = torch.where(cdf.hi <= cdf.lo, cdf.lo, v)
    return torch.where(cdf.bad, torch.nan, v)


def hist_quantile(cdf: HistCDF, ps, nbins: int):
    """Approximate type-7 quantiles, ``(len(ps), P)``: the order statistic
    at probability ``p`` sits at 1-based rank ``(n-1) p + 1``."""
    return torch.stack(
        [hist_rank_value(cdf, (cdf.n - 1) * p + 1.0, nbins) for p in ps], dim=0
    )


def fast_rank_normalize_flat(xf: torch.Tensor, nbins: int = DEFAULT_NBINS,
                             cdf: HistCDF | None = None):
    """Histogram rank-normal transform of a flat ``(N, P)`` sample, in
    place: ``(z, cdf)`` with ``z`` in original row order."""
    xf = xf.contiguous()
    if cdf is None:
        cdf = build_hist_cdf(xf, nbins)
    rank = interpolated_ranks(xf, cdf, nbins)
    return z_from_ranks(rank, cdf.n, cdf.bad), cdf


def fast_rank_normalize(x3: torch.Tensor, nbins: int = DEFAULT_NBINS):
    """Histogram rank-normal transform on ``(draws, chains, P)``."""
    d, c, p = x3.shape
    z, _ = fast_rank_normalize_flat(x3.reshape(d * c, p), nbins)
    return z.reshape(d, c, p)


def _folded_cdf(folded, cdf: HistCDF, med, nbins: int) -> HistCDF:
    """Histogram CDF of ``|x - med|`` with its range derived from the bulk
    CDF (lo = 0, hi = max(hi - med, med - lo)): no second min/max pass."""
    m = torch.nan_to_num(med)
    hi_f = torch.maximum(cdf.hi - m, m - cdf.lo)
    hi_f = torch.where(hi_f > 0, hi_f, 1.0)
    lo_f = torch.zeros_like(hi_f)
    # degenerate columns keep hi <= lo so the tied-rank override fires
    hi_f = torch.where(cdf.hi <= cdf.lo, lo_f, hi_f)
    return build_hist_cdf(folded, nbins, minmax=(lo_f, hi_f, cdf.bad))


def _fold(xf, med):
    return torch.abs(xf - torch.nan_to_num(med)[None, :])


def fast_rank_bulk_tail(x3: torch.Tensor, nbins: int = DEFAULT_NBINS):
    """The rank kind's two transforms with no sort: ``(z_bulk, z_tail,
    med)``, both in (draw, chain) order. The fold ``|x - med|`` is
    histogrammed anew (it is no bin-aligned reflection of the bulk)."""
    d, c, p = x3.shape
    xf = x3.reshape(d * c, p).contiguous()
    z_bulk, cdf = fast_rank_normalize_flat(xf, nbins)
    med = hist_quantile(cdf, (0.5,), nbins)[0]
    folded = _fold(xf, med)
    z_tail, _ = fast_rank_normalize_flat(
        folded, nbins, cdf=_folded_cdf(folded, cdf, med, nbins))
    z_tail = torch.where(cdf.bad[None, :], torch.nan, z_tail)
    return z_bulk.reshape(d, c, p), z_tail.reshape(d, c, p), med
