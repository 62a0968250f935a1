"""Plain float64 reference of nested R-hat, ``rhat_nested(x, superchain_ids,
kind="rank")``: the larger of the nested R-hat of the rank-normal sample and
of the rank-normal ``|x - median|`` (Margossian et al., arXiv:2110.13017;
MCMCDiagnosticTools.jl src/rhat_nested.jl:98-188).

Superchains are ``config["superchains"]`` contiguous runs of chains, as the
traffic's ``superchain_ids`` make them. Per superchain, ``Wk`` is the mean
within-split-chain variance and ``Bk`` the ``ddof=1`` variance of its split
chains' means; ``rhat = sqrt(1 + var(superchain means) / mean(Wk + Bk))``.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import F64, param_blocks, rounder, split_chains
from .exact import bulk_tail


def nested_basic(x3: torch.Tensor, nsuper: int, r, split: int = 2):
    """Nested R-hat ``(P,)`` of ``(draws, chains, P)``, superchains
    contiguous."""
    s = split_chains(x3, split)  # chain-major: a chain's splits side by side
    m = s.shape[1] // nsuper
    cm = r(s.mean(0)).reshape(nsuper, m, -1)
    cv = r(s.var(0, unbiased=True)).reshape(nsuper, m, -1)
    wk = cv.mean(1)
    bk = cm.var(1, unbiased=True) if m > 1 else torch.zeros_like(wk)
    var_within = r((wk + bk).mean(0))
    var_between = r(cm.mean(1).var(0, unbiased=True))
    return torch.sqrt(1.0 + var_between / var_within)


def rhat_nested_rank(sample: torch.Tensor, config: dict, *,
                     lowp=None) -> dict:
    """``{"rhat"}``, float64 numpy ``(P,)``, of ``sample`` ``(draws, chains,
    P)``."""
    r = rounder(lowp)
    d, c, p = sample.shape
    nsuper = int(config["superchains"])
    rhat = np.empty(p)
    for s0, s1 in param_blocks(p, d * c):
        xb = r(sample[:, :, s0:s1].to(F64))
        z_bulk, z_tail = bulk_tail(xb, r)
        rh = torch.maximum(nested_basic(z_bulk, nsuper, r),
                           nested_basic(z_tail, nsuper, r))
        rhat[s0:s1] = rh.cpu().numpy()
    return {"rhat": rhat}
