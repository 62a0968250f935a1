"""Raftery and Lewis (1992) run-length diagnostic (counterpart of the JAX
package's ``diagnostics/rafterydiag.py``).

Dichotomize each chain at its ``q``-quantile, find the smallest thinning
whose thinned indicator passes a second-order Markov BIC test, then size
the burn-in and the run length from the 2-state transition probabilities
(src/rafterydiag.jl:27-74). Every series runs on the sample's device at
once (``diagnostics/batch.py``), a 1-d chain as a batch of one; thresholds,
G^2 and BIC are float64.
"""

from __future__ import annotations

import math
from typing import NamedTuple

from ..convert import to_tensor
from .batch import rafterydiag_batch


class RafteryResult(NamedTuple):
    thinning: object
    burnin: object
    total: object
    nmin: object
    dependencefactor: object


def _scalar(v):
    """A 1-element result as the reference's scalar: an int where the value
    is a whole number, else a float (NaN included)."""
    v = float(v.reshape(()))
    return int(v) if math.isfinite(v) and v == int(v) else v


def rafterydiag(x, *, q: float = 0.025, r: float = 0.005, s: float = 0.95,
                eps: float = 0.001, range_start: int = 1, range_step: int = 1,
                device=None) -> RafteryResult:
    """Raftery-Lewis diagnostic of ``x`` shaped ``(draws[, chains[,
    params...]])``. ``range_start``/``range_step`` describe the iteration
    numbering of ``x`` (the reference's ``range``, default
    ``1:length(x)``). 1-d input returns Python scalars (``thinning``,
    ``burnin``, ``total``, ``nmin`` ints, ``dependencefactor`` a float; NaN
    where the reference has none); N-d input returns float64 tensors shaped
    ``(chains, *params)`` on the sample's device (``nmin`` int64). Too
    short a chain for ``nmin`` warns and gives thinning -1 and NaN. A
    series that no thinning factor passes before the thinned chain has <= 4
    draws gets NaN (the reference fails there). Numpy input goes to
    ``device``."""
    x = to_tensor(x, device)
    res = rafterydiag_batch(x[:, None] if x.ndim == 1 else x, q=q, r=r, s=s,
                            eps=eps, range_start=range_start,
                            range_step=range_step)
    if x.ndim == 1:
        thinning, burnin, total, nmin = (_scalar(v) for v in res[:4])
        # the quotient of the two host numbers, correctly rounded
        return RafteryResult(thinning, burnin, total, nmin, total / nmin)
    return RafteryResult(*res)
