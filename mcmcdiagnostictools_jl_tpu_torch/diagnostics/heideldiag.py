"""Heidelberger and Welch (1983) stationarity and halfwidth diagnostic
(counterpart of the JAX package's ``diagnostics/heideldiag.py``).

A burn-in scan in steps of 10 % of the draws: at each candidate start the
Cramer-von Mises statistic of the Brownian bridge of the suffix is tested
with the asymptotic ``pcramer`` series; the halfwidth test compares
``sqrt(2) * erfcinv(alpha) * mcse`` against ``eps * |mean|``
(src/heideldiag.jl:16-68). Fewer than 10 draws raise ``ValueError``: the
reference's scan would never advance.
"""

from __future__ import annotations

from typing import NamedTuple

from ..convert import to_tensor
from .batch import heideldiag_batch


class HeidelResult(NamedTuple):
    burnin: object
    stationarity: object
    pvalue: object
    mean: object
    halfwidth: object
    test: object


def heideldiag(x, *, alpha: float = 0.05, eps: float = 0.1, start: int = 1,
               device=None, **mcse_kwargs) -> HeidelResult:
    """Heidelberger-Welch diagnostic of ``x`` shaped ``(draws[, chains[,
    params...]])``: ``(burnin, stationarity, pvalue, mean, halfwidth,
    test)``; ``start`` offsets the reported burn-in (1-based, as the
    reference). Every (chain, parameter) series is scanned at once
    (``diagnostics/batch.py``), a 1-d chain as a batch of one: 1-d input
    returns Python scalars, N-d input tensors shaped ``(chains, *params)``.
    ``mcse_kwargs`` go to :func:`mcse`. Numpy input goes to ``device``.
    """
    x = to_tensor(x, device)
    res = heideldiag_batch(x[:, None] if x.ndim == 1 else x, alpha=alpha,
                           eps=eps, start=start, **mcse_kwargs)
    if x.ndim != 1:
        return HeidelResult(*res)
    burnin, stationarity, pvalue, mean, halfwidth, test = (
        v.reshape(()) for v in res)
    return HeidelResult(int(burnin), bool(stationarity), float(pvalue),
                        float(mean), float(halfwidth), bool(test))
