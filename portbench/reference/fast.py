"""Plain float64 reference of the fast rank mode: ``ess_rhat(x, kind="rank",
rank_mode="fast")`` with every default (4096 bins).

The method as the program documents it (the port's ``ops/fastrank.py``
module docstring, and the JAX package's): per parameter, ``nbins``
equal-width bins over ``[min, max]``; an element at ``s = (x - lo) nbins /
(hi - lo)`` lies in bin ``b = min(floor(s), nbins - 1)`` at ``frac = s -
b``; with ``C[b]`` the elements in the bins below, ``cnt[b]`` its count and
``fm[b]`` the mean ``frac`` of its elements (1/2 for an empty bin), the
rank is ``C[b] + clip(frac cnt[b] + cnt[b] (1/2 - fm[b]), 0, cnt[b]) +
1/2``; then Blom and the inverse normal CDF. The median is the value at
rank ``(n - 1) / 2 + 1`` of the inverse of that map. The tail transform
bins ``|x - med|`` over ``[0, max(hi - med, med - lo)]``. A constant
parameter ranks every element ``(n + 1) / 2``.

Computed on the sample's device in blocks of parameters.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import F64, ess_rhat_basic, param_blocks, rhat_basic, rounder
from .exact import rows_of, sample_of

NBINS = 4096


def _bins(rows, lo, scale, nbins: int):
    s = ((rows - lo[:, None]) * scale[:, None]).clamp(0.0, float(nbins))
    b = s.floor().to(torch.int64).clamp(0, nbins - 1)
    return b, s - b.to(F64)


def _cdf(b, frac, nbins: int):
    """``(cum (B, nbins + 1) exclusive prefix counts, cnt, fm)``."""
    cnt = torch.zeros((b.shape[0], nbins), dtype=F64, device=b.device)
    cnt.scatter_add_(1, b, torch.ones_like(frac))
    fsum = torch.zeros_like(cnt).scatter_add_(1, b, frac)
    fm = torch.where(cnt > 0, fsum / cnt.clamp(min=1.0), 0.5)
    cum = torch.cat([torch.zeros_like(cnt[:, :1]), cnt.cumsum(1)], dim=1)
    return cum, cnt, fm


def _ranks(rows, lo, hi, nbins: int):
    """Mean-anchored ranks of ``rows`` binned over ``[lo, hi]``, and the
    CDF."""
    width = hi - lo
    scale = torch.where(width > 0, nbins / width, 0.0)
    b, frac = _bins(rows, lo, scale, nbins)
    cum, cnt, fm = _cdf(b, frac, nbins)
    c = cnt.gather(1, b)
    g = torch.minimum((frac * c + c * (0.5 - fm.gather(1, b))).clamp(min=0.0),
                      c)
    ranks = cum.gather(1, b) + g + 0.5
    n = rows.shape[1]
    ranks = torch.where((hi <= lo)[:, None], (n + 1) * 0.5, ranks)
    return ranks, (cum, cnt, fm)


def _median(cdf, lo, hi, n: int, nbins: int):
    """Value at 1-based rank ``(n - 1) / 2 + 1`` of the inverse rank map."""
    cum, cnt, fm = cdf
    h = (n - 1) * 0.5 + 1.0
    k = ((cum + 0.5 <= h).sum(1) - 1).clamp(0, nbins - 1)[:, None]
    c_lo, c, f = cum.gather(1, k)[:, 0], cnt.gather(1, k)[:, 0], fm.gather(1, k)[:, 0]
    g = torch.minimum((h - 0.5 - c_lo).clamp(min=0.0), c)
    frac = torch.where(c > 0, g / c.clamp(min=1.0) + f - 0.5, 0.5).clamp(0.0, 1.0)
    v = lo + (k[:, 0].to(F64) + frac) * (hi - lo) / nbins
    return torch.where(hi <= lo, lo, v)


def _z(ranks, n: int, r):
    return r(torch.special.ndtri((ranks - 0.375) / (n + 0.25)))


def bulk_tail(xb: torch.Tensor, r, nbins: int = NBINS):
    """``(z_bulk, z_tail)`` ``(draws, chains, B)`` of a float64 block."""
    d, c, _ = xb.shape
    rows = rows_of(xb)
    n = rows.shape[1]
    lo, hi = rows.min(1).values, rows.max(1).values
    ranks, cdf = _ranks(rows, lo, hi, nbins)
    z_bulk = _z(ranks, n, r)
    med = r(_median(cdf, lo, hi, n, nbins))
    hi_f = torch.maximum(hi - med, med - lo)
    hi_f = torch.where(hi_f > 0, hi_f, 1.0)
    hi_f = torch.where(hi <= lo, 0.0, hi_f)
    fold = r(torch.abs(rows - med[:, None]))
    ranks_f, _ = _ranks(fold, torch.zeros_like(hi_f), hi_f, nbins)
    return sample_of(z_bulk, d, c), sample_of(_z(ranks_f, n, r), d, c)


def ess_rhat_rank(sample: torch.Tensor, config: dict, *, lowp=None,
                  maxlag: int = 250) -> dict:
    """``{"ess", "rhat"}``, float64 numpy ``(P,)``, of ``sample`` ``(draws,
    chains, P)``."""
    r = rounder(lowp)
    d, c, p = sample.shape
    ess, rhat = np.empty(p), np.empty(p)
    for s0, s1 in param_blocks(p, d * c):
        xb = r(sample[:, :, s0:s1].to(F64))
        z_bulk, z_tail = bulk_tail(xb, r)
        e, rb = ess_rhat_basic(z_bulk, maxlag, r=r)
        rt = rhat_basic(z_tail, r=r)
        ess[s0:s1] = e.cpu().numpy()
        rhat[s0:s1] = torch.maximum(rb, rt).cpu().numpy()
    return {"ess": ess, "rhat": rhat}
