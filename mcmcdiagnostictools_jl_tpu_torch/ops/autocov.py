"""Batched autocovariance estimators (counterpart of the JAX package's
``ops/autocov.py``).

The chain-mean autocovariance curve for lags ``0..maxlag`` over all (chain,
parameter) series at once, from centered ``(niter, C, P)`` series:

- ``"fft"``: zero-pad to the next ``2^a 3^b >= niter + maxlag``, real FFT,
  ``|.|^2``, inverse; ``acov_k = c_k / c_0 * chain_var * (n-1)/n``
  (reference FFTAutocovMethod, src/ess_rhat.jl:103-118,181-195);
- ``"direct"`` (aliases ``"direct_kernel"``, and the JAX package's
  ``"pallas"`` and ``"pallas_interpret"``): the biased Geyer estimator
  ``sum_i x_i x_{i+k} / n`` (reference AutocovMethod,
  src/ess_rhat.jl:161-179), through kernel K5 on a CUDA tensor and its plain
  PyTorch lag loop on a CPU tensor;
- ``"bda"``: the BDA3 variogram estimator (src/ess_rhat.jl:197-213), from the
  FFT cross term and prefix sums of squares;
- or a callable ``(centered, chain_var, maxlag) -> (maxlag+1, P)``.

All of them return ``(maxlag+1, P)``.
"""

from __future__ import annotations

import torch

from ..kernels.autocov import direct_autocov


def next_fft_size(n: int) -> int:
    """Smallest ``2^a * 3^b >= n`` (``nextprod([2, 3], n)``,
    src/ess_rhat.jl:110)."""
    if n <= 1:
        return 1
    best = None
    p3 = 1
    while p3 < 3 * n:
        q = (n + p3 - 1) // p3
        cand = p3 * (1 << max(0, (q - 1).bit_length()))
        if cand >= n and (best is None or cand < best):
            best = cand
        p3 *= 3
    return best


def _fft_unnormalized(centered: torch.Tensor, maxlag: int) -> torch.Tensor:
    """``c_k = sum_i x_i x_{i+k}`` for k = 0..maxlag via the real FFT; the
    pad ``>= niter + maxlag`` keeps every consumed lag free of wrap-around."""
    m = next_fft_size(centered.shape[0] + maxlag)
    f = torch.fft.rfft(centered, n=m, dim=0)
    s = f.real ** 2 + f.imag ** 2
    return torch.fft.irfft(s, n=m, dim=0)[: maxlag + 1]


def _mean_autocov_fft(centered, chain_var, maxlag: int):
    niter = centered.shape[0]
    c = _fft_unnormalized(centered, maxlag)
    # a constant chain has c_0 = 0 and autocovariance exactly 0 (the direct
    # estimator's value), so the 0/0 is guarded
    c0 = c[0][None]
    ratio = torch.where(c0 > 0, c / torch.where(c0 > 0, c0, 1.0), 0.0)
    acov = ratio * (chain_var * ((niter - 1) / niter))[None]
    return acov.mean(1)


def _mean_autocov_direct(centered, chain_var, maxlag: int):
    """Literal biased estimator ``dot(x[:n-k], x[k:]) / n`` through K5, then
    the mean over chains (kept in PyTorch, as the JAX package keeps it
    outside its Pallas kernel)."""
    del chain_var
    return direct_autocov(centered.contiguous(), maxlag).mean(1)


def _mean_autocov_bda(centered, chain_var, maxlag: int):
    """BDA3 variogram: ``sum_i (x_i - x_{i+k})^2 = S1_k + S2_k - 2 c_k``
    with ``S1_k = sum_{i < n-k} x_i^2`` and ``S2_k = sum_{i >= k} x_i^2``."""
    niter = centered.shape[0]
    c = _fft_unnormalized(centered, maxlag)
    csum = torch.cumsum(centered * centered, dim=0)
    total = csum[-1]
    lags = torch.arange(maxlag + 1, device=centered.device)
    s1 = csum[niter - 1 - lags]
    prev = torch.cat([torch.zeros_like(csum[:1]), csum[:maxlag]], dim=0)
    s2 = total[None] - prev
    nk = (niter - lags).to(centered.dtype)[:, None, None]
    vario = (s1 + s2 - 2.0 * c) / (2.0 * nk)
    return chain_var.mean(0)[None] - vario.mean(1)


_METHODS = {
    "fft": _mean_autocov_fft,
    "direct": _mean_autocov_direct,
    "direct_kernel": _mean_autocov_direct,
    "pallas": _mean_autocov_direct,
    "pallas_interpret": _mean_autocov_direct,
    "bda": _mean_autocov_bda,
}


def mean_autocov_curve(centered, chain_var, maxlag: int, method="fft"):
    """Mean-over-chains autocovariance curve for lags ``0..maxlag``.

    ``centered``: ``(niter, C, P)`` per-chain centered samples;
    ``chain_var``: ``(C, P)`` unbiased chain variances; ``method``: a name
    above or a callable with this signature (the reference's
    AbstractAutocovMethod seam, src/ess_rhat.jl:2,95-126).
    """
    if callable(method):
        return method(centered, chain_var, maxlag)
    try:
        fn = _METHODS[method]
    except KeyError:
        raise ValueError(
            f"unknown autocov method {method!r}; expected one of "
            f"{sorted(_METHODS)} or a callable"
        ) from None
    return fn(centered, chain_var, maxlag)
