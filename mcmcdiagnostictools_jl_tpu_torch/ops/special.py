"""Special functions the port needs that PyTorch lacks (counterpart of the
JAX package's ``ops/special.py``).

- ``betaincinv``, the inverse regularized incomplete beta function of the
  quantile MCSE's Beta error distribution (reference src/mcse.jl:106-109),
  and ``fdist_quantile`` on top of it (the Gelman PSRF's upper limit,
  src/gelmandiag.jl:47). PyTorch has no ``betainc``, and both callers
  invert it only on ``(P,)`` vectors, so the port hands those to SciPy in
  float64 on the host: one copy of ``P`` floats from the card and one back.
  That also keeps the inverse accurate at the large Beta parameters (ESS ~
  1e5) where the JAX package's float32 bisection and its Cornish-Fisher
  branch lose digits (ROADMAP.md, fault C1).
- ``chi2_sf``, the chi-squared survival function of the discrete
  diagnostic's p-values, likewise: SciPy on the host in float64 for ``(P,)``
  vectors, as the JAX package computes them (``torch.special.gammaincc`` is
  up to 2e-9 off SciPy at the degrees of freedom those tests meet).
- ``besselk_quarter`` and ``pcramer``, the Cramer-von Mises p-value of the
  Heidelberger-Welch test (src/heideldiag.jl:56-68): batched tensor
  functions on the argument's device and in its dtype.
"""

from __future__ import annotations

import math

import torch
from scipy import special


def betaincinv(a: torch.Tensor, b: torch.Tensor, y: float) -> torch.Tensor:
    """``x`` with ``I_x(a, b) = y``, elementwise over ``a`` and ``b``
    (broadcast together), as a float64 tensor on ``a``'s device. NaN
    parameters give NaN."""
    a64 = a.detach().to("cpu", torch.float64).numpy()
    b64 = b.detach().to("cpu", torch.float64).numpy()
    return torch.from_numpy(special.betaincinv(a64, b64, y)).to(a.device)


def fdist_quantile(d1, d2, q: float) -> torch.Tensor:
    """Quantile ``q`` of the F(d1, d2) distribution, float64 on ``d2``'s
    device: ``y = betaincinv(d1/2, d2/2, q)``, ``x = d2 y / (d1 (1 - y))``.
    ``d1`` and ``d2`` are numbers or tensors that broadcast together."""
    d2 = torch.as_tensor(d2).double()
    d1 = torch.as_tensor(d1, dtype=torch.float64, device=d2.device)
    y = betaincinv(d1 / 2, d2 / 2, q)
    return d2 * y / (d1 * (1.0 - y))


def chi2_sf(stat: torch.Tensor, df: torch.Tensor) -> torch.Tensor:
    """``scipy.stats.chi2.sf(stat, df)`` elementwise (broadcast together), as
    a float64 tensor on ``stat``'s device."""
    s64 = stat.detach().to("cpu", torch.float64).numpy()
    d64 = df.detach().to("cpu", torch.float64).numpy()
    return torch.from_numpy(special.chdtrc(d64, s64)).to(stat.device)


def besselk_quarter(x: torch.Tensor) -> torch.Tensor:
    """Modified Bessel function of the second kind ``K_{1/4}(x)``, ``x > 0``
    (NaN elsewhere): the trapezoidal rule on ``int_0^inf exp(-x cosh t)
    cosh(t/4) dt`` with step 0.05 up to t = 20, ~1e-14 for x in [1e-6,
    700]. Elementwise over ``x``; works on a ``(..., 401)`` intermediate."""
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        x = x.to(torch.get_default_dtype())
    h, n = 0.05, 400  # exp(-x cosh 20) underflows for any x >= 1e-8
    t = torch.arange(n + 1, dtype=x.dtype, device=x.device) * h
    w = torch.full((n + 1,), h, dtype=x.dtype, device=x.device)
    w[0] = h / 2
    # the exponent is clipped to keep inf * 0 out of the sum
    expo = (x[..., None] * torch.cosh(t)).clamp(max=745.0)
    res = (torch.exp(-expo) * torch.cosh(0.25 * t) * w).sum(-1)
    return torch.where(x > 0, res, torch.nan)


# gamma(k + 1/2) for k = 0..3
_GAMMA_K_HALF = (1.7724538509055160273, 0.8862269254527580137,
                 1.3293403881791370205, 3.3233509704478425512)


def pcramer(q: torch.Tensor) -> torch.Tensor:
    """Asymptotic CDF of the Cramer-von Mises statistic: the four-term
    series of Csorgo and Faraway (1996) as the reference evaluates it
    (src/heideldiag.jl:56-68). Elementwise over ``q``."""
    q = torch.as_tensor(q)
    if not q.is_floating_point():
        q = q.to(torch.get_default_dtype())
    p = torch.zeros_like(q)
    for k in range(4):
        c1 = 4.0 * k + 1.0
        c2 = c1 * c1 / (16.0 * q)
        p = p + (_GAMMA_K_HALF[k] / math.factorial(k) * math.sqrt(c1)
                 * torch.exp(-c2) * besselk_quarter(c2))
    return p / (math.pi ** 1.5 * torch.sqrt(q))
