"""Geweke (1991) convergence diagnostic (counterpart of the JAX package's
``diagnostics/gewekediag.py``).

``z = (mean(first window) - mean(last window)) / hypot(mcse1, mcse2)`` over
the first ``first`` and the last ``last`` fractions of the draws, each
window's MCSE with ``split_chains=1``, and ``p = erfc(|z| / sqrt(2))``
(reference src/gewekediag.jl:19-35).
"""

from __future__ import annotations

from typing import NamedTuple

from ..convert import to_tensor
from .batch import gewekediag_batch


class GewekeResult(NamedTuple):
    zscore: object
    pvalue: object


def gewekediag(x, *, first: float = 0.1, last: float = 0.5, device=None,
               **mcse_kwargs) -> GewekeResult:
    """Geweke diagnostic of ``x`` shaped ``(draws[, chains[, params...]])``.

    Every (chain, parameter) series runs at once (``diagnostics/batch.py``),
    a 1-d chain as a batch of one: 1-d input returns Python floats, N-d
    input tensors shaped ``(chains, *params)`` on the sample's device.
    ``mcse_kwargs`` go to :func:`mcse` (e.g. ``maxlag``,
    ``autocov_method``). Numpy input goes to ``device``.
    """
    if not 0 < first < 1:
        raise ValueError("`first` is not in (0, 1)")
    if not 0 < last < 1:
        raise ValueError("`last` is not in (0, 1)")
    if first + last > 1:
        raise ValueError("`first` and `last` proportions overlap")
    x = to_tensor(x, device)
    z, p = gewekediag_batch(x[:, None] if x.ndim == 1 else x, first=first,
                            last=last, **mcse_kwargs)
    if x.ndim == 1:
        return GewekeResult(zscore=float(z.reshape(())),
                            pvalue=float(p.reshape(())))
    return GewekeResult(z, p)
