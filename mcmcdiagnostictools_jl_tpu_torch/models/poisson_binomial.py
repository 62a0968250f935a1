"""Scaled Poisson-binomial distribution for probabilistic R* (a copy of the
JAX package's ``models/poisson_binomial.py``, which imports no JAX; the port
keeps its own).

The reference returns ``(nclasses // ntest) * PoissonBinomial(p)`` for
probabilistic classifiers (src/rstar.jl:249-265): the distribution of the R*
statistic when each test prediction independently "counts" with its predicted
true-class probability. Like the reference (which returns the distribution
object without materializing a pmf), construction is O(n): moments come
straight from ``probs`` and the pmf is computed lazily on the first
``pdf``/``cdf``/``quantile`` call — at config-5 scale (ntest ~ 3e5) the
eager O(n^2) DP would be ~9e10 host FLOPs that ``mean()`` (what most
callers read) never needs. When the pmf IS
needed, n > ~2k uses the divide-and-conquer FFT polynomial product
(O(n log^2 n), SURVEY.md section 7) instead of the O(n^2) DP; the two agree
to ~1e-12 (tests/test_torch_rstar.py).
"""

from __future__ import annotations

import numpy as np


class ScaledPoissonBinomial:
    """Distribution of ``scale * N`` with ``N ~ PoissonBinomial(probs)``.

    ``support`` is ``scale * {0, 1, ..., n}``; ``pdf``/``cdf`` accept values
    on that grid (cdf interpolates as a right-continuous step function).
    """

    def __init__(self, probs, scale: float):
        probs = np.asarray(probs, dtype=np.float64)
        if probs.ndim != 1:
            raise ValueError("probs must be a vector")
        if np.any((probs < 0) | (probs > 1)):
            raise ValueError("probs must lie in [0, 1]")
        self.probs = probs
        self.scale = float(scale)
        self._pmf_cache = None

    @property
    def _pmf(self) -> np.ndarray:
        """Lazy exact pmf: DP for small n, FFT product tree for large n."""
        if self._pmf_cache is None:
            self._pmf_cache = _poisson_binomial_pmf(self.probs)
        return self._pmf_cache

    @property
    def n(self) -> int:
        return len(self.probs)

    def support(self) -> np.ndarray:
        return self.scale * np.arange(self.n + 1)

    def mean(self) -> float:
        return self.scale * float(np.sum(self.probs))

    def var(self) -> float:
        return self.scale**2 * float(np.sum(self.probs * (1 - self.probs)))

    def std(self) -> float:
        return float(np.sqrt(self.var()))

    def pdf(self, x) -> np.ndarray:
        """pmf at ``x`` (0 off the support grid)."""
        x = np.asarray(x, dtype=np.float64)
        k = np.rint(x / self.scale).astype(int)
        on_grid = np.isclose(k * self.scale, x) & (k >= 0) & (k <= self.n)
        k = np.clip(k, 0, self.n)
        out = np.where(on_grid, self._pmf[k], 0.0)
        return out if out.ndim else float(out)

    def cdf(self, x) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        k = np.floor(x / self.scale + 1e-12).astype(int)
        csum = np.concatenate([[0.0], np.cumsum(self._pmf)])
        k = np.clip(k + 1, 0, self.n + 1)
        out = csum[k]
        return out if out.ndim else float(out)

    def quantile(self, q: float) -> float:
        csum = np.cumsum(self._pmf)
        k = int(np.searchsorted(csum, q))
        return self.scale * min(k, self.n)

    def __repr__(self) -> str:
        return (
            f"ScaledPoissonBinomial(n={self.n}, scale={self.scale:.6g}, "
            f"mean={self.mean():.4f}, std={self.std():.4f})"
        )


_FFT_THRESHOLD = 2048


def _poisson_binomial_pmf(probs: np.ndarray) -> np.ndarray:
    """Exact float64 pmf of ``sum_j Bernoulli(p_j)``.

    n <= {t}: O(n^2) DP convolution (bit-stable baseline).
    n  > {t}: divide-and-conquer product of the per-trial polynomials
    ``(1 - p_j) + p_j x`` with batched real-FFT multiplication per level —
    O(n log^2 n) work, ~1e-12 agreement with the DP.
    """.format(t=_FFT_THRESHOLD)
    if len(probs) <= _FFT_THRESHOLD:
        return _poisson_binomial_pmf_dp(probs)
    return _poisson_binomial_pmf_fft(probs)


def _poisson_binomial_pmf_dp(probs: np.ndarray) -> np.ndarray:
    """Exact DP convolution: O(n^2) float64, vectorized inner updates."""
    n = len(probs)
    pmf = np.zeros(n + 1)
    pmf[0] = 1.0
    for i, p in enumerate(probs):
        pmf[1 : i + 2] = pmf[1 : i + 2] * (1 - p) + pmf[: i + 1] * p
        pmf[0] *= 1 - p
    return pmf


def _poisson_binomial_pmf_fft(probs: np.ndarray) -> np.ndarray:
    """FFT product tree over the per-trial polynomials.

    Level 0 holds the m = n degree-1 polynomials as rows of an (m, 2)
    array; each level convolves adjacent row pairs with one batched rFFT
    (coefficients are nonnegative and sum to 1 per row, so float64 FFT
    rounding stays ~1e-15 relative per level, log2(n) levels total). Odd
    rows carry to the next level unchanged.
    """
    n = len(probs)
    polys = np.stack([1.0 - probs, probs], axis=1)  # (n, 2)
    carry = []
    while polys.shape[0] > 1:
        m, width = polys.shape
        if m % 2:
            carry.append(polys[-1])
            polys = polys[:-1]
            m -= 1
        out_width = 2 * width - 1
        nfft = 1 << (out_width - 1).bit_length()
        fa = np.fft.rfft(polys[0::2], nfft, axis=1)
        fb = np.fft.rfft(polys[1::2], nfft, axis=1)
        polys = np.fft.irfft(fa * fb, nfft, axis=1)[:, :out_width]
    acc = polys[0]
    for extra in reversed(carry):
        out_width = len(acc) + len(extra) - 1
        nfft = 1 << (out_width - 1).bit_length()
        acc = np.fft.irfft(
            np.fft.rfft(acc, nfft) * np.fft.rfft(extra, nfft), nfft
        )[:out_width]
    pmf = np.clip(acc[: n + 1], 0.0, None)
    return pmf / pmf.sum()
