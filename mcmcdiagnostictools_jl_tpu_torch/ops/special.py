"""Special functions the port needs that PyTorch lacks (counterpart of the
JAX package's ``ops/special.py``).

``betaincinv``, the inverse regularized incomplete beta function of the
quantile MCSE's Beta error distribution (reference src/mcse.jl:106-109).
PyTorch has no ``betainc``, and the quantile MCSE inverts it only on two
``(P,)`` vectors per call, so the port hands those to SciPy in float64 on
the host: one copy of ``P`` floats from the card and one back. That also
keeps the inverse accurate at the large Beta parameters (ESS ~ 1e5) where
the JAX package's float32 bisection and its Cornish-Fisher branch lose
digits (ROADMAP.md, fault C1). ``fdist_quantile``, ``besselk_quarter`` and
``pcramer`` come with the classical suite.
"""

from __future__ import annotations

import torch
from scipy import special


def betaincinv(a: torch.Tensor, b: torch.Tensor, y: float) -> torch.Tensor:
    """``x`` with ``I_x(a, b) = y``, elementwise over ``a`` and ``b``, as a
    float64 tensor on ``a``'s device. NaN parameters give NaN."""
    a64 = a.detach().to("cpu", torch.float64).numpy()
    b64 = b.detach().to("cpu", torch.float64).numpy()
    return torch.from_numpy(special.betaincinv(a64, b64, y)).to(a.device)
