"""Convergence diagnostics for discrete (categorical) chains (counterpart of
the JAX package's ``diagnostics/discretediag.py``).

Re-derivation of the reference discretediag.jl (Deonovic & Smith 2017):
between-chain and within-chain tests for samples of a categorical variable,
with six methods:

- ``"hangartner"``: chi^2 test of per-chain category frequencies
  (src/discretediag.jl:302-307)
- ``"weiss"``: Hangartner chi^2 with a serial-dependence correction
  ``c = (1+phi)/(1-phi)`` (src/discretediag.jl:80-119,308-314)
- ``"DARBOOT"``: parametric bootstrap of a DAR(1) process
  (src/discretediag.jl:187-228,315-328)
- ``"MCBOOT"``: Markov-chain bootstrap (src/discretediag.jl:230-238,329-337)
- ``"billingsley"``: transition-matrix chi^2 (src/discretediag.jl:130-173)
- ``"billingsleyBOOT"``: its Markov-chain bootstrap
  (src/discretediag.jl:344-356)

Everything runs on the sample's device, with no loop over parameters or
chains: the category codes of every parameter (and of every within-chain
test) come from one sort of the columns; the observed counts are flat
``torch.bincount`` reductions in int64, with the category axis padded to the
largest category count (padded categories have zero counts and are masked
out of every statistic, so padding is exact). The observed statistics are
float64 even for float32 input, as in the JAX package, and the p-values are
SciPy's ``chi2.sf`` on the host (``ops.special.chi2_sf``), as there.

The bootstrap methods loop over draws, vectorised over (chains, simulations,
tests), carrying the previous codes and the count accumulator; the
statistics of every replica are float32 on the device. Its draws come from
one ``torch.Generator`` for the between-chain and one for the within-chain
tests, seeded from ``rng``: they are not the JAX package's draws (its
``rbg`` stream cannot be reproduced), so bootstrap ``df`` and ``pvalue`` agree
with it in distribution; ``stat`` does not depend on the draws.

The statistics keep the reference's conventions, including its
time-reversed transition tensor in the diag_all path (``f[to, from,
chain]``, src/discretediag.jl:283-284) and MCBOOT's NaN statistic / 0.0
p-value (``stat`` is never assigned in the :MCBOOT branch,
src/discretediag.jl:329-337).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..convert import to_tensor
from ..ops.special import chi2_sf

_METHODS = ("weiss", "hangartner", "DARBOOT", "MCBOOT", "billingsley",
            "billingsleyBOOT")

# cap on the per-chunk bootstrap state (counts tensors) in bytes; nsim is
# processed in chunks so the (d, m[, m], S, B) accumulators stay bounded
_BOOT_STATE_BUDGET = 256 * 1024 * 1024


class DiscreteDiagValues(NamedTuple):
    stat: torch.Tensor
    df: torch.Tensor
    pvalue: torch.Tensor


class DiscreteDiagResult(NamedTuple):
    between_chain: DiscreteDiagValues
    within_chain: DiscreteDiagValues


def discretediag(chains, *, frac: float = 0.3, method: str = "weiss",
                 nsim: int = 1000, rng=None, device=None) -> DiscreteDiagResult:
    """Discrete diagnostic on ``chains`` of shape (draws, chains, parameters).

    Returns between-chain values (per parameter, ``(P,)``) and within-chain
    values (``(P, chains)``) comparing the first ``frac`` draws against the
    last ``frac`` within each chain (src/discretediag.jl:399-424), as float64
    tensors on the sample's device. ``rng`` seeds the bootstrap methods
    (NumPy Generator or seed). A tensor is computed where it lives; other
    input goes to ``device`` (default: the card).
    """
    if method not in _METHODS:
        raise ValueError(
            "`method` must be one of :" + ", :".join(_METHODS)
        )
    if not 0 < frac < 1:
        raise ValueError("`frac` must be in (0,1)")
    x = to_tensor(chains, device)
    if x.ndim != 3:
        raise ValueError("samples must have shape (draws, chains, parameters)")
    rng = np.random.default_rng(rng)
    num_iters, num_chains, num_vars = x.shape

    codes, m_arr = _integer_codes_batched(x.reshape(num_iters * num_chains,
                                                    num_vars))
    codes = codes.reshape(num_iters, num_chains, num_vars)

    # the JAX package's two draws from rng, seeding one stream each
    seeds = rng.integers(0, 2**62, size=2)
    gen_b, gen_w = (torch.Generator(device=x.device).manual_seed(int(s))
                    for s in seeds)

    between = _diag_batched(codes, m_arr, method, nsim, gen_b)

    # within-chain: first `frac` draws vs last `frac` draws of each chain,
    # one 2-pseudo-chain test per (parameter, chain) (src/discretediag.jl:399-424)
    n1 = round(frac * num_iters)
    start2 = round(num_iters - frac * num_iters + 1) - 1
    x1 = codes[:n1]                       # (n1, d, P)
    x2 = codes[start2:]                   # (n2, d, P)
    n_min = min(x1.shape[0], x2.shape[0])
    # tests ordered (param, chain): y_w[:, :, j*d + k] = chain k of param j
    y_w = torch.stack([x1[:n_min], x2[x2.shape[0] - n_min:]], dim=1)
    nw = num_vars * num_chains
    y_w = y_w.permute(0, 1, 3, 2).reshape(n_min * 2, nw)
    # the reference's diag_all recomputes the category set from the windowed
    # data only (src/discretediag.jl:252): recode each test's codes to the
    # contiguous categories present in its two frac windows
    y_w, m_w = _integer_codes_batched(y_w)
    within = _diag_batched(y_w.reshape(n_min, 2, nw), m_w, method, nsim,
                           gen_w)

    shape_w = (num_vars, num_chains)
    return DiscreteDiagResult(
        DiscreteDiagValues(*between),
        DiscreteDiagValues(*(v.reshape(shape_w) for v in within)),
    )


# ---------------------------------------------------------------------------
# category codes and counts
# ---------------------------------------------------------------------------


def _integer_codes_batched(x: torch.Tensor):
    """Per-column category codes ``0..m_j-1`` of ``x`` (N, B) in sorted value
    order (what ``np.unique(..., return_inverse=True)`` gives each column;
    NaNs form one category, the last), and ``m`` (B,), in one sort of the
    columns. Category labelling does not affect any statistic, so sorted
    codes replace the reference's first-appearance dict
    (src/discretediag.jl:246-289). The NaNs' sign bits are cleared first:
    the card's sort orders NaNs by their bits, and would put a sign-bit NaN
    first, apart from the others."""
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.nan, x)
    vals, order = torch.sort(x, dim=0)
    new = torch.ones_like(vals, dtype=torch.int64)
    if vals.shape[0] > 1:
        differ = vals[1:] != vals[:-1]
        if vals.is_floating_point():
            differ &= ~(torch.isnan(vals[1:]) & torch.isnan(vals[:-1]))
        new[1:] = differ
    ranks = torch.cumsum(new, dim=0) - 1
    codes = torch.empty_like(ranks).scatter_(0, order, ranks)
    return codes, ranks[-1] + 1


def _counts_batched(y: torch.Tensor, m: int):
    """All observed count tensors for codes ``y`` (n, d, B) in one pass of
    flat int64 bincounts: u (B, m, d) category counts, v (B, m, d)
    self-transition counts, f (B, m, m, d) time-reversed (to, from)
    transition tensors."""
    n, d, B = y.shape
    dev = y.device
    bi = torch.arange(B, device=dev)[None, None, :]
    ci = torch.arange(d, device=dev)[None, :, None]
    size = B * m * d
    u = torch.bincount(((bi * m + y) * d + ci).reshape(-1),
                       minlength=size).reshape(B, m, d)
    # the transitions that are no self-transition count into a spill slot
    flat_v = torch.where(y[1:] == y[:-1], (bi * m + y[1:]) * d + ci, size)
    v = torch.bincount(flat_v.reshape(-1), minlength=size + 1)[:size]
    pair = y[1:] * m + y[:-1]  # to * m + from
    f = torch.bincount(((bi * (m * m) + pair) * d + ci).reshape(-1),
                       minlength=B * m * m * d).reshape(B, m, m, d)
    return u, v.reshape(B, m, d), f


# ---------------------------------------------------------------------------
# observed statistics (float64, batch-safe)
# ---------------------------------------------------------------------------


def _weiss_sub(u, v, t):
    """(phi_hat, per-chain chi^2 contributions, #nonempty categories)
    (src/discretediag.jl:80-119). Supports leading batch dims on u/v."""
    u, v = u.to(torch.float64), v.to(torch.float64)
    d = u.shape[-1]
    p1 = v.sum(-1) / (d * (t - 1))  # (..., m)
    p2 = u.sum(-1) / (d * t)
    nt = p1.sum(-1)
    dt_ = (p2**2).sum(-1)
    mp = u / t  # (..., m, d)
    ma = u.sum(-1) / (d * t)  # (..., m)
    nonempty = ma > 0
    m_tot = nonempty.sum(-1)
    contrib = (mp - ma[..., None]) ** 2 / ma[..., None]
    contrib = torch.where(nonempty[..., None], contrib, 0.0)
    chi_stat = contrib.sum(-2)  # (..., d)
    phia = 1.0 + 1.0 / t - (1.0 - nt) / (1.0 - dt_)
    phia = phia.clamp(0.0, 1.0 - np.finfo(float).eps)
    return phia, chi_stat, m_tot


def _billingsley_sub(f):
    """Transition chi^2 statistic + df + pooled transition matrix
    (src/discretediag.jl:130-173). Supports leading batch dims."""
    f = f.to(torch.float64)
    mf = f.sum(-2)  # (..., m, d) outgoing totals per category/chain
    a = (mf > 0).sum(-1)  # (..., m) chains where category occurs
    b = (f.sum(-1) > 0).sum(-1)  # (..., m) distinct successors
    p = f / mf[..., :, None, :]  # per-chain transition probs
    mp = f.sum(-1) / mf.sum(-1)[..., :, None]
    mp = torch.nan_to_num(mp, nan=0.0)
    active = (a * b) > 0  # (..., m)
    df = torch.where(active, (a - 1) * (b - 1), 0).sum(-1).to(torch.float64)

    mask = (
        active[..., :, None, None]
        & active[..., None, :, None]
        & (mp[..., :, :, None] > 0)
        & (mf[..., :, None, :] > 0)
        & torch.isfinite(p)
    )
    terms = mf[..., :, None, :] * (p - mp[..., :, :, None]) ** 2 / mp[..., :, :, None]
    stat = torch.where(mask, terms, 0.0).sum((-3, -2, -1))
    return stat, df, mp


# ---------------------------------------------------------------------------
# batched per-test evaluation (the reference's diag_all at t = n, over all
# tests at once)
# ---------------------------------------------------------------------------


def _diag_batched(y, m_true, method, nsim, gen):
    """stat/df/pvalue vectors for codes ``y`` (n, d, B) with per-test true
    category counts ``m_true`` (B,), all categories padded to the largest
    (src/discretediag.jl:240-366 with start_iter=n, batched over tests)."""
    n, d, B = y.shape
    m_pad = int(m_true.max())
    u, v, f = _counts_batched(y, m_pad)

    phia, chi_stat, _ = _weiss_sub(u, v, n)           # (B,), (B, d)
    hot_stat, bdf, mp = _billingsley_sub(f)           # (B,), (B,), (B, m, m)
    ca = (1.0 + phia) / (1.0 - phia)

    nan = torch.full((B,), torch.nan, dtype=torch.float64, device=y.device)
    hang = n * chi_stat.sum(-1)                        # (B,)

    if method in ("hangartner", "weiss"):
        stat = hang if method == "hangartner" else hang / ca
        df0 = ((m_true - 1) * (d - 1)).to(torch.float64)
        pval = torch.where((m_true > 1) & ~torch.isnan(stat),
                           chi2_sf(stat, df0.clamp(min=1e-300)), nan)
        return stat, df0, pval

    if method == "billingsley":
        pval = torch.where((bdf > 0) & ~torch.isnan(hot_stat),
                           chi2_sf(hot_stat, bdf.clamp(min=1e-300)), nan)
        return hot_stat, bdf, pval

    # bootstrap methods: simulate, and the replicas' statistics, on device
    phat = u.sum(-1) / u.sum((-2, -1)).clamp(min=1)[..., None]
    boot = dict(phia=phia, phat=phat, mp=mp, m_true=m_true, gen=gen)
    if method == "DARBOOT":
        bstats = _bootstrap_stats(n, d, m_pad, nsim, "dar", "hang", **boot)
        stat = hang
    elif method == "MCBOOT":
        bstats = _bootstrap_stats(n, d, m_pad, nsim, "mc", "hang", **boot)
        # reference quirk: `stat` is never assigned in the :MCBOOT branch, so
        # the reported statistic is NaN and `mean(NaN <= x)` is 0.0
        # (src/discretediag.jl:329-337)
        stat = nan
    else:  # billingsleyBOOT
        bstats = _bootstrap_stats(n, d, m_pad, nsim, "mc", "bill", **boot)
        stat = hot_stat
        hang = hot_stat / bdf  # compared against bootstrap stat/df ratios

    valid = ~torch.isnan(bstats)                        # (nsim, B)
    nvalid = valid.sum(0)
    cnt = nvalid.clamp(min=1)
    # all-NaN bootstrap column -> NaN (the reference's mean over an empty
    # NaN-filtered vector, src/discretediag.jl:315-337), not 0.0
    bvals = torch.where(valid, bstats.to(torch.float64), 0.0)
    df0 = torch.where(nvalid > 0, bvals.sum(0) / cnt, nan)
    cmp_stat = hang if method != "MCBOOT" else nan
    hits = (valid & (cmp_stat[None, :] <= bstats)).sum(0)
    pval = torch.where(nvalid > 0, hits.to(torch.float64) / cnt, nan)
    return stat, df0, pval


# ---------------------------------------------------------------------------
# bootstrap simulation + statistics (on the device)
# ---------------------------------------------------------------------------


def _bootstrap_stats(n, d, m, nsim, kind, stat_kind, *, phia, phat, mp,
                     m_true, gen):
    """Bootstrap statistic matrix (nsim, B) float32: simulate ``nsim``
    replicas of each of the B tests (DAR(1) or Markov chains,
    src/discretediag.jl:187-238) and evaluate the hangartner or billingsley
    statistic of each replica. nsim is chunked so the count accumulators
    stay under the state budget."""
    B = phat.shape[0]
    state_elems = B * m * d * (m if stat_kind == "bill" else 1)
    chunk = max(1, min(nsim, _BOOT_STATE_BUDGET // (8 * max(state_elems, 1))))

    f32 = torch.float32
    cdf_fresh = torch.cumsum(phat, -1).to(f32)          # (B, m)
    # pooled transition matrix rows normalized; zero rows hold their state
    rowsum = mp.sum(-1, keepdim=True)
    safe = torch.where(rowsum > 0, mp / torch.where(rowsum > 0, rowsum, 1.0),
                       0.0)
    cdf_trans = torch.cumsum(safe, -1).to(f32)          # (B, m_from, m_to)
    zero_row = rowsum[..., 0] == 0                      # (B, m)
    out = []
    for s0 in range(0, nsim, chunk):
        acc = _draw_loop(n, d, m, min(chunk, nsim - s0), kind, stat_kind,
                         phia.to(f32), cdf_fresh, cdf_trans, zero_row,
                         m_true, gen)
        if stat_kind == "hang":
            out.append(_hangartner_stat(acc.to(f32), n))
        else:
            s_b, d_b = _billingsley_stat(acc.to(f32))
            out.append(s_b / d_b)  # 0/0 -> NaN, s/0 -> inf (reference nan-filter)
    return torch.cat(out, 0)


def _cell_base(d, width, S, B, device):
    """Flat offset of each (chain, sim, test) cell in a (d, width, S, B)
    count tensor, shaped (d, S, B)."""
    return (torch.arange(d, device=device)[:, None, None] * (width * S * B)
            + torch.arange(S, device=device)[None, :, None] * B
            + torch.arange(B, device=device)[None, None, :])


def _count_into(acc, base, code, ones):
    """``acc`` += 1 at ``base + code * S * B`` for every (chain, sim, test)
    cell of ``code`` (d, S, B): the cell's category (``acc`` (d, m, S, B)) or
    its ``from * m + to`` transition (``acc`` (d, m * m, S, B)). Each cell
    has its own offsets, so the adds never collide. ``ones``: int32, one a
    cell."""
    S, B = code.shape[1:]
    acc.view(-1).index_add_(0, (base + code * (S * B)).reshape(-1), ones)


def _draw_loop(n, d, m, S, kind, stat_kind, phia, cdf_fresh, cdf_trans,
               zero_row, m_true, gen):
    """One nsim-chunk of bootstrap replicas: a loop over the n draws with
    state (previous codes, count accumulator), vectorised over the (d, S, B)
    cells (chains, sims, tests). Returns the int32 counts: (d, m, S, B)
    category counts (``stat_kind="hang"``) or (d, m_from, m_to, S, B)
    transition counts (``"bill"``). Each cell adds exactly one count a draw,
    at its own offset, so the index adds never collide."""
    B = phia.shape[0]
    dev = phia.device
    shape = (d, S, B)
    mt = m_true[None, None, :]
    top = mt - 1
    cdf_fresh_t = cdf_fresh.T[None, :, None, :]          # (1, m, 1, B)
    # entries ``(prev * B + b) * m + k``: test b's CDF at k after category
    # prev, read with ``torch.take`` (indexing rows of m floats goes through
    # a gather that runs a block a row: ~0.6 ms a draw at config 3 on an
    # H100)
    cdf_rows = cdf_trans.permute(1, 0, 2).reshape(-1)
    zrows = zero_row.T.reshape(m * B)
    bidx = torch.arange(B, device=dev)
    kidx = torch.arange(m, device=dev)

    def rand(*lead):
        return torch.rand(lead + shape, generator=gen, device=dev,
                          dtype=torch.float32)

    def fresh_draw(u):  # categorical from each test's CDF; u (d, S, B)
        # clamp per test to m_true-1, not the pad m-1: float32 cumsum CDFs
        # can end ~1 ulp below 1.0, and a uniform in that gap must not select
        # a padded out-of-support category (absorbing in MC mode)
        return torch.minimum((u[:, None] > cdf_fresh_t).sum(1), top)

    u0 = rand()
    if kind == "dar":
        prev = fresh_draw(u0)
    else:
        prev = torch.minimum((u0 * mt.to(torch.float32)).to(torch.int64), top)

    width = m * m if stat_kind == "bill" else m
    acc = torch.zeros((d, width, S, B), dtype=torch.int32, device=dev)
    base = _cell_base(d, width, S, B, dev)
    ones = torch.ones(d * S * B, dtype=torch.int32, device=dev)
    if stat_kind == "hang":
        _count_into(acc, base, prev, ones)

    for _ in range(1, n):
        if kind == "dar":
            u12 = rand(2)
            new = torch.where(u12[1] <= phia, prev, fresh_draw(u12[0]))
        else:
            row = prev * B + bidx
            cdf = torch.take(cdf_rows, row[..., None] * m + kidx)
            nxt = torch.minimum((rand()[..., None] > cdf).sum(-1), top)
            new = torch.where(torch.take(zrows, row), prev, nxt)
        # transitions in (from, to) orientation, matching the reference's
        # bd_inner
        _count_into(acc, base, prev * m + new if stat_kind == "bill" else new,
                    ones)
        prev = new

    if stat_kind == "bill":
        return acc.view(d, m, m, S, B)
    return acc


def _hangartner_stat(u, t):
    """Hangartner statistic (float32) from counts u (d, m, S, B) -> (S, B)."""
    d = u.shape[0]
    ma = u.sum(0) / (d * t)  # (m, S, B)
    nonempty = ma > 0
    denom = torch.where(nonempty, ma, 1.0)
    contrib = torch.where(nonempty[None], (u / t - ma[None]) ** 2 / denom[None],
                          0.0)
    return t * contrib.sum((0, 1))


def _billingsley_stat(f):
    """Billingsley statistic + df (float32) from transition counts
    f (d, m_from, m_to, S, B) -> (S, B) each."""
    mf = f.sum(2)  # (d, m, S, B) outgoing totals per category/chain
    a = (mf > 0).sum(0)  # (m, S, B) chains where category occurs
    b = (f.sum(0) > 0).sum(1)  # (m, S, B) distinct successors
    mf_safe = torch.where(mf > 0, mf, 1.0)
    p = f / mf_safe[:, :, None]  # (d, m, m, S, B)
    fsum_d = f.sum(0)  # (m, m, S, B)
    mft = mf.sum(0)  # (m, S, B)
    mp = fsum_d / torch.where(mft > 0, mft, 1.0)[:, None]  # (m, m, S, B)
    active = (a * b) > 0  # (m, S, B)
    df = torch.where(active, (a - 1) * (b - 1), 0).sum(0).to(f.dtype)
    mask = ((active[:, None] & active[None, :] & (mp > 0))[None]
            & (mf[:, :, None] > 0))
    mp_safe = torch.where(mp > 0, mp, 1.0)
    terms = mf[:, :, None] * (p - mp[None]) ** 2 / mp_safe[None]
    stat = torch.where(mask, terms, 0.0).sum((0, 1, 2))  # (S, B)
    return stat, df
