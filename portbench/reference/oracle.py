"""Float64 oracle for the references' CPU tests: a frozen copy of the parts
of the repository's loop-based NumPy oracle (``tests/ref_impl.py``) that the
cells need: the layout, the rank and fold transforms, the sequential Geyer
ESS and split R-hat, and the nested R-hat, one parameter at a time. Kept here so that the benchmark's
yardstick does not change when the test suite's oracle does.
"""

from __future__ import annotations

import numpy as np
from scipy.special import ndtri
from scipy.stats import rankdata


# ---------------------------------------------------------------------------
# layout / splitting
# ---------------------------------------------------------------------------


def split_matrix(x: np.ndarray, split: int) -> np.ndarray:
    """Split (draws, chains) into (draws//split, split*chains), chain-major,
    discarding one draw after each of the first draws%split splits."""
    ndraws, nchains = x.shape
    niter = ndraws // split
    d = ndraws % split
    cols = []
    for c in range(nchains):
        for k in range(split):
            start = k * niter + min(k, d)
            cols.append(x[start : start + niter, c])
    return np.stack(cols, axis=1)


def params_iter(x: np.ndarray):
    """Yield (index, (draws, chains) slice) over flattened parameter dims."""
    if x.ndim == 1:
        yield 0, x[:, None]
        return
    flat = x.reshape(x.shape[0], x.shape[1], -1)
    for p in range(flat.shape[2]):
        yield p, flat[:, :, p]


def out_shape(x: np.ndarray):
    return x.shape[2:] if x.ndim > 2 else ()


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------


def rank_normalize(x: np.ndarray) -> np.ndarray:
    y = np.empty_like(np.asarray(x, dtype=np.float64))
    if x.ndim == 1:
        r = rankdata(x, method="average")
        return ndtri((r - 0.375) / (len(x) + 0.25))
    yf = y.reshape(y.shape[0], y.shape[1], -1)
    for p, xs in params_iter(x):
        flat = xs.reshape(-1, order="F")  # column-major like Julia vec
        r = rankdata(flat, method="average")
        z = ndtri((r - 0.375) / (len(flat) + 0.25))
        yf[:, :, p] = z.reshape(xs.shape, order="F")
    return y


def fold_around_median(x: np.ndarray) -> np.ndarray:
    y = np.empty_like(np.asarray(x, dtype=np.float64))
    if x.ndim == 1:
        return np.abs(x - np.median(x))
    yf = y.reshape(y.shape[0], y.shape[1], -1)
    for p, xs in params_iter(x):
        yf[:, :, p] = np.abs(xs - np.median(xs))
    return y


# ---------------------------------------------------------------------------
# autocovariance + Geyer ESS (sequential, matching reference semantics)
# ---------------------------------------------------------------------------


def _fft_autocov_table(samples: np.ndarray) -> np.ndarray:
    """Unnormalized autocovariance sum_i x_i x_{i+k} per chain via FFT.
    samples: (niter, nchains) centered. Returns (niter, nchains)."""
    niter, nchains = samples.shape
    n = 2 * niter  # any size >= 2*niter - 1 works for the linear correlation
    f = np.fft.rfft(samples, n=n, axis=0)
    c = np.fft.irfft(np.abs(f) ** 2, n=n, axis=0)
    return c[:niter]


def _mean_autocov(k: int, table: np.ndarray, chain_var: np.ndarray, niter: int):
    ratio = table[k] / table[0]
    return np.mean(ratio * chain_var) * (niter - 1) / niter


def ess_rhat_basic(
    x: np.ndarray,
    split_chains: int = 2,
    maxlag: int = 250,
    relative: bool = False,
):
    """Per-parameter sequential Geyer ESS + split R-hat. x: (draws, chains[, ...])."""
    shp = out_shape(x)
    nparam = int(np.prod(shp)) if shp else 1
    ess = np.full(nparam, np.nan)
    rh = np.full(nparam, np.nan)
    for p, xs in params_iter(np.asarray(x, dtype=np.float64)):
        samples = split_matrix(xs, split_chains)
        niter, nchains = samples.shape
        ntotal = niter * nchains
        lag_cap = min(maxlag, niter - 4)
        chain_mean = samples.mean(axis=0)
        chain_var = samples.var(axis=0, ddof=1)
        w = chain_var.mean()
        between = chain_mean.var(ddof=1) if nchains > 1 else 0.0
        var_plus = (niter - 1) / niter * w + between
        rh[p] = np.sqrt(var_plus / w)
        if niter <= 4:
            continue
        centered = samples - chain_mean
        table = _fft_autocov_table(centered)
        inv_vp = 1.0 / var_plus

        rho_odd = 1 - inv_vp * (w - _mean_autocov(1, table, chain_var, niter))
        p_t = 1.0 + rho_odd
        sum_p = p_t
        k = 2
        while k < lag_cap - 1:
            rho_even = 1 - inv_vp * (w - _mean_autocov(k, table, chain_var, niter))
            rho_odd = 1 - inv_vp * (w - _mean_autocov(k + 1, table, chain_var, niter))
            delta = rho_even + rho_odd
            if not delta > 0:
                break
            p_t = min(delta, p_t)
            sum_p += p_t
            k += 2
        if lag_cap > 1:
            rho_even = 1 - inv_vp * (w - _mean_autocov(k, table, chain_var, niter))
        else:
            rho_even = 0.0
        tau = max(0.0, 2 * sum_p + max(0.0, rho_even) - 1)
        with np.errstate(divide="ignore"):
            e = min(1.0 / tau if tau > 0 else np.inf, np.log10(ntotal))
        ess[p] = e if relative else e * ntotal
    return ess.reshape(shp) if shp else ess[0], rh.reshape(shp) if shp else rh[0]


def rhat_basic(x: np.ndarray, split_chains: int = 2):
    shp = out_shape(x)
    nparam = int(np.prod(shp)) if shp else 1
    rh = np.full(nparam, np.nan)
    for p, xs in params_iter(np.asarray(x, dtype=np.float64)):
        samples = split_matrix(xs, split_chains)
        niter, nchains = samples.shape
        chain_mean = samples.mean(axis=0)
        chain_var = samples.var(axis=0, ddof=1)
        w = chain_var.mean()
        between = chain_mean.var(ddof=1) if nchains > 1 else 0.0
        var_plus = (niter - 1) / niter * w + between
        rh[p] = np.sqrt(var_plus / w)
    return rh.reshape(shp) if shp else rh[0]


# ---------------------------------------------------------------------------
# kinds
# ---------------------------------------------------------------------------


def rhat(x, kind="rank", split_chains=2):
    if kind == "basic":
        return rhat_basic(x, split_chains)
    if kind == "bulk":
        return rhat_basic(rank_normalize(x), split_chains)
    if kind == "tail":
        return rhat_basic(rank_normalize(fold_around_median(x)), split_chains)
    if kind == "rank":
        return np.maximum(rhat(x, "bulk", split_chains), rhat(x, "tail", split_chains))
    raise ValueError(kind)


def ess_rhat(x, kind="rank", split_chains=2, maxlag=250, relative=False):
    if kind in ("basic", "bulk"):
        y = rank_normalize(x) if kind == "bulk" else x
        return ess_rhat_basic(y, split_chains, maxlag, relative)
    if kind == "rank":
        e, rb = ess_rhat(x, "bulk", split_chains, maxlag, relative)
        rt = rhat(x, "tail", split_chains)
        return e, np.maximum(rb, rt)
    raise ValueError(kind)


def rhat_nested_basic(x, superchain_ids, split_chains=2):
    ids = np.asarray(superchain_ids)
    uniq = np.unique(ids)
    shp = out_shape(x)
    nparam = int(np.prod(shp)) if shp else 1
    rh = np.full(nparam, np.nan)
    for pidx, xs in params_iter(np.asarray(x, float)):
        var_within = 0.0
        sc_means = []
        for u in uniq:
            cols = np.flatnonzero(ids == u)
            samples = split_matrix(xs[:, cols], split_chains)
            m = samples.shape[1]
            cm = samples.mean(axis=0)
            cv = samples.var(axis=0, ddof=1)
            wk = cv.mean()
            bk = cm.var(ddof=1) if m > 1 else 0.0
            sc_means.append(cm.mean())
            var_within += wk + bk
        var_within /= len(uniq)
        var_between = np.var(sc_means, ddof=1)
        rh[pidx] = np.sqrt(1 + var_between / var_within)
    return rh.reshape(shp) if shp else rh[0]


def rhat_nested(x, superchain_ids, kind="rank", split_chains=2):
    if kind == "basic":
        return rhat_nested_basic(x, superchain_ids, split_chains)
    if kind == "bulk":
        return rhat_nested_basic(rank_normalize(x), superchain_ids, split_chains)
    if kind == "tail":
        return rhat_nested_basic(
            rank_normalize(fold_around_median(x)), superchain_ids, split_chains
        )
    if kind == "rank":
        return np.maximum(
            rhat_nested(x, superchain_ids, "bulk", split_chains),
            rhat_nested(x, superchain_ids, "tail", split_chains),
        )
    raise ValueError(kind)
