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
plain versions (``kernels/fastrank.py``). K3 finishes the CDF itself (prefix
counts, within-bin means, K4's table), and K3 and K4 fold the sample
(``shift``) and write the constant columns (``fill``, ``bad``) themselves, so
no step here passes over the sample outside a kernel except Blom +
``ndtri``. The small per-column work (quantile inversion, ranges) is plain
PyTorch on both, as the JAX package keeps it outside Pallas.

``FUSE_BLOM_Z`` (default off, the JAX package's default) moves the Blom
transform and the inverse normal CDF into step 4: K4's z mode emits z
directly with AS241's ``ppnd7`` (about 1.5e-7 relative; ``torch.special.
ndtri`` otherwise), which saves one full read and write of the sample. The
route is the same on the CPU (plain version) and on the card (kernel).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.fastrank import (
    bins_from_scale,
    column_minmax,
    hist_cdf_tables,
    pack_tables,
    rank_lookup,
)
from ..utils.profiling import host_sync

DEFAULT_NBINS = 4096
# Fuse Blom + ppnd7 into kernel K4 (the JAX package's flag, same default:
# its TPU measurement found the fused kernel slower; the H100 figures are in
# PERF.md)
FUSE_BLOM_Z = False

__all__ = [
    "DEFAULT_NBINS", "FUSE_BLOM_Z", "HistCDF", "build_hist_cdf", "column_minmax",
    "fast_rank_bulk_tail", "fast_rank_normalize", "fast_rank_normalize_flat",
    "hist_quantile", "hist_rank_value", "interpolated_ranks", "z_from_ranks",
]


class HistCDF(NamedTuple):
    """Per-column histogram CDF over ``nbins`` equal-width bins.

    ``cum``: (nbins+1, P) float32 prefix counts (``cum[0] = 0``);
    ``fm``: (nbins, P) mean within-bin position (1/2 for empty bins);
    ``lo``/``hi``: (P,) bin range (degenerate columns: lo == hi);
    ``n``: element count; ``bad``: (P,) NaN-poisoned columns;
    ``tab``: K4's (P, nbins+1, 2) table of ``cum`` and ``fm``
    (``kernels.fastrank.pack_tables``; built on demand when None).
    """

    cum: torch.Tensor
    fm: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    n: int
    bad: torch.Tensor
    tab: torch.Tensor | None = None

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
                   minmax=None, shift=None) -> HistCDF:
    """Histogram CDF of a flat contiguous ``(N, P)`` sample, or with the
    ``(P,)`` vector ``shift`` of its fold ``|xf - shift|``. ``minmax``: a
    precomputed ``(lo, hi, bad)`` (the fold transform derives it)."""
    lo, hi, bad = column_minmax(xf) if minmax is None else minmax
    cum, fm, tab = hist_cdf_tables(xf, lo, _hist_scale(lo, hi, nbins), nbins,
                                   shift)
    return HistCDF(cum, fm, lo, hi, xf.shape[0], bad, tab)


def _lookup(xf: torch.Tensor, cdf: HistCDF, nbins: int, fill: float,
            blom_n: int | None = None, shift=None, bad=None):
    """K4 on the CDF's table: ranks, or z values with ``blom_n``, of ``xf``
    or of its fold; degenerate (constant) columns get ``fill``, the columns
    ``bad`` NaN."""
    tab = pack_tables(cdf.cum, cdf.fm) if cdf.tab is None else cdf.tab
    fills = torch.full_like(cdf.lo, torch.nan).masked_fill(cdf.hi <= cdf.lo,
                                                          fill)
    return rank_lookup(xf, cdf.lo, _hist_scale(cdf.lo, cdf.hi, nbins), tab,
                       nbins, blom_n, shift=shift, fill=fills,
                       bad=bad).to(xf.dtype)


def interpolated_ranks(xf: torch.Tensor, cdf: HistCDF, nbins: int, *,
                       shift=None, bad=None):
    """Per-element mean-anchored rank in ``[1/2, n + 1/2]``, original order,
    of ``xf`` or with ``shift`` of ``|xf - shift|`` (``cdf`` is then the
    fold's). Degenerate (constant) columns get the exact tied rank
    ``(n+1)/2``, the columns ``bad`` (a ``(P,)`` mask) NaN."""
    return _lookup(xf, cdf, nbins, (cdf.n + 1) * 0.5, shift=shift, bad=bad)


def _blom(rank, n: int):
    return (rank - 0.375) / (n + 0.25)


def z_from_ranks(rank, n: int, bad=None):
    """Blom alpha=3/8 + inverse normal CDF. NaN ranks stay NaN; ``bad``
    masks NaN-poisoned columns whose ranks are not NaN already."""
    z = torch.special.ndtri(_blom(rank, n))
    return z if bad is None else torch.where(bad[None, :], torch.nan, z)


def _fused_z(xf: torch.Tensor, cdf: HistCDF, nbins: int, shift=None):
    """The ``FUSE_BLOM_Z`` route: z straight from K4's z mode; degenerate
    columns get the z of the tied rank ``(n+1)/2`` and NaN-poisoned columns
    NaN, both written by the kernel (JAX ``ops/fastrank.py:408-411``)."""
    z_deg = torch.special.ndtri(torch.tensor(_blom((cdf.n + 1) * 0.5, cdf.n),
                                             dtype=torch.float64))
    return _lookup(xf, cdf, nbins, float(z_deg), blom_n=cdf.n, shift=shift,
                   bad=cdf.bad)


def hist_rank_value(cdf: HistCDF, h, nbins: int):
    """Value at 1-based rank ``h`` — the inverse of the mean-anchored rank
    map, ``(P,)``, accurate to one bin width. ``h`` is a float or a ``(P,)``
    tensor of per-column ranks (the quantile MCSE inverts a different rank
    in each column)."""
    cum = cdf.cum
    width = (cdf.hi - cdf.lo) / nbins
    if isinstance(h, torch.Tensor):
        hv = h.to(cum.device, cum.dtype)
    else:  # a host number copied to the device
        with host_sync("hist_rank"):
            hv = torch.as_tensor(h, dtype=cum.dtype, device=cum.device)
    hv = hv.expand(cdf.lo.shape)
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
                             cdf: HistCDF | None = None, shift=None):
    """Histogram rank-normal transform of a flat ``(N, P)`` sample, in
    place: ``(z, cdf)`` with ``z`` in original row order. With ``shift``
    (and the fold's ``cdf``) the transform of ``|xf - shift|``. With
    ``FUSE_BLOM_Z`` set, K4 emits z itself (``ppnd7``)."""
    xf = xf.contiguous()
    if cdf is None:
        cdf = build_hist_cdf(xf, nbins, shift=shift)
    if FUSE_BLOM_Z:
        return _fused_z(xf, cdf, nbins, shift), cdf
    rank = interpolated_ranks(xf, cdf, nbins, shift=shift, bad=cdf.bad)
    return z_from_ranks(rank, cdf.n), cdf


def fast_rank_normalize(x3: torch.Tensor, nbins: int = DEFAULT_NBINS):
    """Histogram rank-normal transform on ``(draws, chains, P)``."""
    d, c, p = x3.shape
    z, _ = fast_rank_normalize_flat(x3.reshape(d * c, p), nbins)
    return z.reshape(d, c, p)


def _fold_shift(med):
    """The shift of the fold around ``med``: 0 where the median is NaN."""
    return torch.nan_to_num(med)


def _fold(xf, med):
    return torch.abs(xf - _fold_shift(med)[None, :])


def fold_range(cdf: HistCDF, med):
    """``(lo, hi, bad)`` of ``|x - med|`` derived from the bulk CDF ``cdf``
    (lo = 0, hi = max(hi - med, med - lo)): no second min/max pass."""
    m = _fold_shift(med)
    hi_f = torch.maximum(cdf.hi - m, m - cdf.lo)
    hi_f = torch.where(hi_f > 0, hi_f, 1.0)
    lo_f = torch.zeros_like(hi_f)
    # degenerate columns keep hi <= lo so the tied-rank override fires
    hi_f = torch.where(cdf.hi <= cdf.lo, lo_f, hi_f)
    return lo_f, hi_f, cdf.bad


def _folded_cdf(xf, cdf: HistCDF, med, nbins: int) -> HistCDF:
    """Histogram CDF of ``|xf - med|`` (folded inside K3) with its range
    from ``fold_range``: no folded copy."""
    return build_hist_cdf(xf, nbins, minmax=fold_range(cdf, med),
                          shift=_fold_shift(med))


def fast_rank_fold(xf: torch.Tensor, cdf: HistCDF, med, nbins: int):
    """Rank-normal transform of the fold ``|xf - med|`` of a flat sample
    whose bulk CDF is ``cdf``; the fold is never materialised. NaN-poisoned
    columns come out NaN (the fold's CDF carries the bulk's ``bad``)."""
    z, _ = fast_rank_normalize_flat(
        xf, nbins, cdf=_folded_cdf(xf, cdf, med, nbins), shift=_fold_shift(med))
    return z


def fast_rank_bulk_tail(x3: torch.Tensor, nbins: int = DEFAULT_NBINS):
    """The rank kind's two transforms with no sort: ``(z_bulk, z_tail,
    med)``, both in (draw, chain) order. The fold ``|x - med|`` is
    histogrammed anew (it is no bin-aligned reflection of the bulk)."""
    d, c, p = x3.shape
    xf = x3.reshape(d * c, p).contiguous()
    z_bulk, cdf = fast_rank_normalize_flat(xf, nbins)
    med = hist_quantile(cdf, (0.5,), nbins)[0]
    z_tail = fast_rank_fold(xf, cdf, med, nbins)
    return z_bulk.reshape(d, c, p), z_tail.reshape(d, c, p), med
