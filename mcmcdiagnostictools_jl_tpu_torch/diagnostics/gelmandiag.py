"""Gelman, Rubin and Brooks PSRF diagnostics (counterpart of the JAX
package's ``diagnostics/gelmandiag.py``; reference gelmandiag.jl).

Per-chain variances, moment-matched degrees of freedom for the F-based
upper confidence limit (src/gelmandiag.jl:1-53), and the multivariate PSRF
from the largest eigenvalue of the whitened between-chain matrix
``L^-1 B L^-T`` with ``W = L L^T`` (src/gelmandiag.jl:80-105).

The univariate PSRF needs only the diagonals of the covariance matrices, so
it takes the chain variances from ``torch.var`` (no centred copy of the
sample); the multivariate one forms ``W`` and
``B`` as plain matrix products (the JAX package's ``(C, P, P)`` per-chain
einsum averaged over chains is one ``(P, n C) x (n C, P)`` product). On the
card a float32 product runs in full float32 only while
``torch.backends.cuda.matmul.allow_tf32`` is False, PyTorch's default. The
F quantile goes through SciPy in float64 on the host (ops/special.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.special import fdist_quantile
from ..utils.layout import restore_param_shape
from .ess_rhat import _canonical_input


class GelmanResult(NamedTuple):
    psrf: torch.Tensor
    psrfci: torch.Tensor


class GelmanMultivariateResult(NamedTuple):
    psrf: torch.Tensor
    psrfci: torch.Tensor
    psrfmultivariate: float


def _as3d(chains, device):
    """``(draws, chains, P)`` and the parameter shape; at least 2 chains."""
    x3, pshape = _canonical_input(chains, device, min_ndim=3)
    if x3.shape[1] < 2:
        raise ValueError("Gelman diagnostic requires at least 2 chains")
    return x3, pshape


def _covdiag(x, y):
    """Per-column covariance of ``(C, P)`` matrices, ddof=1."""
    xc = x - x.mean(0, keepdim=True)
    yc = y - y.mean(0, keepdim=True)
    return (xc * yc).sum(0) / (x.shape[0] - 1)


def _gelman_core(psi, alpha: float):
    """``(psrf, psrfci, chain_mean)`` of ``(n, C, P)``."""
    niters, nchains, _ = psi.shape
    rfixed = (niters - 1) / niters
    rrandomscale = (nchains + 1) / (nchains * niters)

    chain_mean = psi.mean(0)  # (C, P)
    s2 = psi.var(0, correction=1)  # (C, P) chain variances, no centred copy
    w = s2.mean(0)
    pb_centered = chain_mean - chain_mean.mean(0, keepdim=True)
    b = niters * (pb_centered * pb_centered).sum(0) / (nchains - 1)
    psibar2 = chain_mean.mean(0)

    var_w = s2.var(0, correction=1) / nchains
    var_b = (2.0 / (nchains - 1)) * b ** 2
    var_wb = (niters / nchains) * (
        _covdiag(s2, chain_mean ** 2) - 2.0 * psibar2 * _covdiag(s2, chain_mean)
    )
    v = rfixed * w + rrandomscale * b
    var_v = (rfixed ** 2 * var_w + rrandomscale ** 2 * var_b
             + 2.0 * rfixed * rrandomscale * var_wb)
    df = 2.0 * v ** 2 / var_v
    w_df = 2.0 * w ** 2 / var_w

    correction = (df + 3.0) / (df + 1.0)
    rrandom = rrandomscale * b / w
    psrf = torch.sqrt(correction * (rfixed + rrandom))
    fq = fdist_quantile(nchains - 1, w_df, 1.0 - alpha / 2.0).to(psi.dtype)
    rrandom_ci = torch.where(torch.isnan(rrandom), rrandom, rrandom * fq)
    psrfci = torch.sqrt(correction * (rfixed + rrandom_ci))
    return psrf, psrfci, chain_mean


def gelmandiag(chains, *, alpha: float = 0.05, device=None) -> GelmanResult:
    """PSRF point estimates and upper confidence limits for ``chains`` of
    shape ``(draws, chains, parameters...)``, tensors shaped like the
    parameter dims on the sample's device. Requires >= 2 chains
    (src/gelmandiag.jl:3). Numpy input goes to ``device`` (default: CPU)."""
    psi, pshape = _as3d(chains, device)
    psrf, psrfci, _ = _gelman_core(psi, alpha)
    return GelmanResult(restore_param_shape(psrf, pshape),
                        restore_param_shape(psrfci, pshape))


def gelmandiag_multivariate(chains, *, alpha: float = 0.05,
                            device=None) -> GelmanMultivariateResult:
    """Univariate PSRFs plus the multivariate PSRF ``rfixed + rrandomscale *
    eigmax(L^-1 B L^-T)`` (a Python float); requires >= 2 parameters."""
    psi, pshape = _as3d(chains, device)
    niters, nchains, nparams = psi.shape
    if nparams < 2:
        raise ValueError(
            "computation of the multivariate potential scale reduction factor "
            "requires at least two variables"
        )
    psrf, psrfci, chain_mean = _gelman_core(psi, alpha)
    flat = (psi - chain_mean[None]).reshape(niters * nchains, nparams)
    w_full = flat.T @ flat / ((niters - 1) * nchains)
    pb_centered = chain_mean - chain_mean.mean(0, keepdim=True)
    b_full = niters * (pb_centered.T @ pb_centered) / (nchains - 1)
    rfixed = (niters - 1) / niters
    rrandomscale = (nchains + 1) / (nchains * niters)
    l = torch.linalg.cholesky(w_full)
    y1 = torch.linalg.solve_triangular(l, b_full, upper=False)
    y = torch.linalg.solve_triangular(l, y1.T, upper=False)
    lam_max = torch.linalg.eigvalsh((y + y.T) / 2.0).max()
    return GelmanMultivariateResult(
        restore_param_shape(psrf, pshape), restore_param_shape(psrfci, pshape),
        rfixed + rrandomscale * float(lam_max))
