"""Plain float64 reference of the exact rank mode: ``ess_rhat(x,
kind="rank")`` with every default (bulk ESS, the larger of the bulk and the
tail R-hat; maxlag 250; two splits a chain).

Rank normalisation as the reference defines it (src/utils.jl:148-193): tied
("average") 1-based ranks over each parameter's joint (draw, chain) sample,
Blom's ``(r - 3/8) / (n + 1/4)``, the inverse normal CDF; the tail is the
same transform of ``|x - median|``. Ranks come from a sort and two binary
searches of each row (``left + right + 1) / 2``), so ties need no scatter.
Computed on the sample's device in blocks of parameters.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import F64, ess_rhat_basic, param_blocks, rhat_basic, rounder


def tied_ranks(rows: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Average 1-based ranks of each row of ``(B, N)``, in place order, from
    its sorted rows ``xs``; a row that holds a NaN is NaN."""
    left = torch.searchsorted(xs, rows, side="left")
    right = torch.searchsorted(xs, rows, side="right")
    ranks = (left + right + 1).to(F64) * 0.5
    bad = torch.isnan(rows).any(1, keepdim=True)
    return torch.where(bad, torch.nan, ranks)


def rank_normal(rows: torch.Tensor, xs: torch.Tensor, r) -> torch.Tensor:
    n = rows.shape[1]
    return r(torch.special.ndtri((tied_ranks(rows, xs) - 0.375) / (n + 0.25)))


def median_sorted(xs: torch.Tensor) -> torch.Tensor:
    """Type-7 median of each sorted row (the mean of the two middle values
    for an even length)."""
    n = xs.shape[1]
    lo = (n - 1) // 2
    hi = min(lo + 1, n - 1)
    g = (n - 1) * 0.5 - lo
    return xs[:, lo] + g * (xs[:, hi] - xs[:, lo])


def rows_of(xb: torch.Tensor) -> torch.Tensor:
    """``(draws, chains, B) -> (B, draws * chains)``."""
    d, c, b = xb.shape
    return xb.permute(2, 0, 1).reshape(b, d * c).contiguous()


def sample_of(rows: torch.Tensor, d: int, c: int) -> torch.Tensor:
    """The inverse of ``rows_of``."""
    return rows.reshape(rows.shape[0], d, c).permute(1, 2, 0)


def bulk_tail(xb: torch.Tensor, r):
    """``(z_bulk, z_tail)`` ``(draws, chains, B)`` of a float64 block."""
    d, c, _ = xb.shape
    rows = rows_of(xb)
    xs = torch.sort(rows, dim=1).values
    z_bulk = rank_normal(rows, xs, r)
    fold = r(torch.abs(rows - median_sorted(xs)[:, None]))
    del xs
    z_tail = rank_normal(fold, torch.sort(fold, dim=1).values, r)
    return sample_of(z_bulk, d, c), sample_of(z_tail, d, c)


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
