"""The port's discretediag against the JAX package's and the loop oracles of
tests/ref_impl.py (float64 on the CPU).

Tolerances: counts, category codes and within-chain recodings exact; the
observed statistics' helpers within 1e-12 of the JAX package's and the
loops'; the chi-squared methods' stat, df and p-value within 1e-9 relative
of the JAX package (p-values: SciPy's ``chi2.sf`` in both); the bootstrap
methods' statistic within 1e-12 (it does not depend on the draws). The
bootstrap draws are the port's own (JAX's ``rbg`` stream cannot be reproduced), so
bootstrap p-values are held statistically: on the same side of 0.05 as the
JAX package's wherever the JAX p-value lies more than three Monte Carlo
standard errors from 0.05.
"""

import numpy as np
import pytest
import torch
from scipy.stats import chi2

import mcmcdiagnostictools_jl_tpu as mdt
import mcmcdiagnostictools_jl_tpu_torch as mtt
import ref_impl
from mcmcdiagnostictools_jl_tpu.diagnostics import discretediag as jdd
from mcmcdiagnostictools_jl_tpu_torch.diagnostics import discretediag as pdd
from mcmcdiagnostictools_jl_tpu_torch.ops.special import chi2_sf
from torch_parity import t

METHODS = ("weiss", "hangartner", "DARBOOT", "MCBOOT", "billingsley",
           "billingsleyBOOT")
CHI2 = ("weiss", "hangartner", "billingsley")
BOOT = ("DARBOOT", "MCBOOT", "billingsleyBOOT")


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _mixed_sample(rng, n=150):
    """Parameters with 3 and 7 categories (so categories are padded), one
    with negative and non-integer values."""
    return np.concatenate([
        rng.integers(0, 3, size=(n, 3, 2)),
        rng.integers(0, 7, size=(n, 3, 1)),
        rng.choice([-2.5, 0.0, 1.25, 4.0], size=(n, 3, 1)),
    ], axis=2).astype(float)


# ---- codes and counts -------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int64])
def test_codes_match_np_unique(rng, dtype):
    x = np.concatenate([rng.integers(-3, 4, size=(60, 3)),
                        rng.integers(0, 2, size=(60, 1)),
                        np.full((60, 1), 7)], axis=1).astype(dtype)
    codes, m = pdd._integer_codes_batched(t(x))
    for j in range(x.shape[1]):
        uniq, inv = np.unique(x[:, j], return_inverse=True)
        np.testing.assert_array_equal(codes[:, j].numpy(), inv)
        assert int(m[j]) == len(uniq)


def test_codes_gather_nans_into_one_category(rng):
    x = rng.integers(0, 3, size=(40, 2)).astype(float)
    x[::7, 0] = np.nan
    codes, m = pdd._integer_codes_batched(t(x))
    uniq, inv = np.unique(x[:, 0], return_inverse=True)
    np.testing.assert_array_equal(codes[:, 0].numpy(), inv.reshape(-1))
    assert int(m[0]) == len(uniq) == 4


def test_codes_match_the_jax_package(rng):
    x = _mixed_sample(rng)
    n, d, p = x.shape
    codes, m = pdd._integer_codes_batched(t(x.reshape(n * d, p)))
    want, want_m = jdd._integer_codes_batched(x)
    np.testing.assert_array_equal(codes.reshape(n, d, p).numpy(), want)
    np.testing.assert_array_equal(m.numpy(), want_m)


def test_within_chain_recoding_matches_np_unique_per_test(rng):
    """The batched recoding of the (first, last) windows equals the JAX
    package's per-test ``np.unique`` loop (discretediag.py:114-121)."""
    x = rng.integers(0, 6, size=(50, 2, 12))
    x[:, :, 3] = 4  # one category in every window
    y = np.ascontiguousarray(x.reshape(100, 12))
    got, m = pdd._integer_codes_batched(t(y))
    want = y.copy()
    for s in range(12):
        uniq, inv = np.unique(want[:, s], return_inverse=True)
        want[:, s] = inv
        assert int(m[s]) == len(uniq)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m_pad", [5, 8])
def test_counts_match_jax_and_loop(rng, m_pad):
    y = rng.integers(0, 5, size=(200, 3, 4))
    got = pdd._counts_batched(t(y), m_pad)
    want = jdd._counts_batched(y, m_pad)
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), w)
    for b in range(4):
        for g, w in zip(got, ref_impl.discrete_counts_loop(y[:, :, b], m_pad)):
            np.testing.assert_array_equal(g[b].numpy(), w)


def _batch_counts_f(y: torch.Tensor, m: int) -> torch.Tensor:
    """(from, to) transition tensors over a leading batch: y (nsim, n, d)
    -> (nsim, m, m, d), counted as the billingsleyBOOT replicas count
    theirs in ``_draw_loop``: one ``_count_into`` a draw."""
    nsim, n, d = y.shape
    ycells = y.permute(1, 2, 0)[..., None]  # (n, d, S=nsim, B=1)
    acc = torch.zeros((d, m, m, nsim, 1), dtype=torch.int32)
    base = pdd._cell_base(d, m * m, nsim, 1, y.device)
    ones = torch.ones(d * nsim, dtype=torch.int32)
    for i in range(1, n):
        pdd._count_into(acc, base, ycells[i - 1] * m + ycells[i], ones)
    return acc[..., 0].permute(3, 1, 2, 0).to(torch.int64)


def test_batch_counts_f_matches_jax_and_loop(rng):
    """The (from, to) counts the billingsleyBOOT replicas accumulate, one
    draw at a time."""
    ys = rng.integers(0, 3, size=(5, 100, 2))
    got = _batch_counts_f(t(ys), 3)
    np.testing.assert_array_equal(got.numpy(), jdd._batch_counts_f(ys, 3))
    for i in range(5):
        _, _, fi = ref_impl.discrete_counts_loop(ys[i], 3)
        np.testing.assert_array_equal(got[i].numpy(), fi.transpose(1, 0, 2))


# ---- statistics -------------------------------------------------------------

@pytest.mark.parametrize("hi,m", [(4, 4), (3, 4)], ids=["full", "empty_category"])
def test_weiss_sub_matches_jax_and_loop(rng, hi, m):
    y = rng.integers(0, hi, size=(150, 3))
    u, v, _ = ref_impl.discrete_counts_loop(y, m)
    got = pdd._weiss_sub(t(u), t(v), 150)
    for want in (ref_impl.weiss_sub_loop(u, v, 150), jdd._weiss_sub(u, v, 150)):
        np.testing.assert_allclose(float(got[0]), want[0], rtol=1e-12)
        np.testing.assert_allclose(got[1].numpy(), want[1], rtol=1e-12)
        assert int(got[2]) == want[2] == hi


@pytest.mark.parametrize("hi,m", [(4, 4), (3, 4)], ids=["full", "empty_category"])
def test_billingsley_sub_matches_jax_and_loop(rng, hi, m):
    y = rng.integers(0, hi, size=(150, 3))
    _, _, f = ref_impl.discrete_counts_loop(y, m)
    got = pdd._billingsley_sub(t(f))
    for want in (ref_impl.billingsley_sub_loop(f), jdd._billingsley_sub(f)):
        np.testing.assert_allclose(float(got[0]), want[0], rtol=1e-12)
        assert float(got[1]) == want[1]
        np.testing.assert_allclose(got[2].numpy(), want[2], rtol=1e-12)


def test_billingsley_batch_consistent(rng):
    ys = rng.integers(0, 3, size=(5, 100, 2))
    s_b, d_b, _ = pdd._billingsley_sub(_batch_counts_f(t(ys), 3))
    for i in range(5):
        _, _, fi = ref_impl.discrete_counts_loop(ys[i], 3)
        want = ref_impl.billingsley_sub_loop(fi.transpose(1, 0, 2))
        np.testing.assert_allclose(float(s_b[i]), want[0], rtol=1e-12)
        assert float(d_b[i]) == want[1]


def test_replica_statistics_match_jax(rng):
    """The float32 statistics of the bootstrap replicas (hangartner from
    category counts, billingsley from transition counts) against the JAX
    package's on the same counts."""
    u = rng.integers(0, 30, size=(3, 4, 5, 6)).astype(np.float32)
    u[:, 3] = 0  # a padded category
    np.testing.assert_allclose(pdd._hangartner_stat(t(u), 50).numpy(),
                               np.asarray(jdd._hangartner_jnp(u, 50)),
                               rtol=1e-5)
    f = rng.integers(0, 9, size=(3, 4, 4, 5, 6)).astype(np.float32)
    f[:, 2] = 0  # a category never left
    for g, w in zip(pdd._billingsley_stat(t(f)), jdd._billingsley_jnp(f)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)


def test_chi2_sf_matches_scipy(rng):
    df = np.concatenate([np.arange(1, 40), rng.integers(40, 5000, 200)])
    df = np.repeat(df, 6).astype(float)
    stat = df * np.tile([0.01, 0.5, 0.95, 1.1, 3.0, 20.0], len(df) // 6)
    got = chi2_sf(t(stat), t(df))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), chi2.sf(stat, df), rtol=1e-12,
                               atol=0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_chi2_sf_edges(dtype):
    """0 -> 1, inf -> 0, NaN -> NaN, float32 statistics in float64 out."""
    got = chi2_sf(torch.tensor([0.0, np.inf, np.nan, 2.0], dtype=dtype),
                  t([3.0, 3.0, 3.0, 6.0]))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got[:2].numpy(), [1.0, 0.0])
    assert np.isnan(got[2].item())
    np.testing.assert_allclose(got[3].item(), chi2.sf(2.0, 6.0), rtol=1e-12)


# ---- end to end -------------------------------------------------------------

def _assert_values(got, want, rtol, fields=("stat", "df", "pvalue")):
    for part in ("between_chain", "within_chain"):
        g, w = getattr(got, part), getattr(want, part)
        for name in fields:
            gv, wv = _np(getattr(g, name)), np.asarray(getattr(w, name))
            assert gv.shape == wv.shape, (part, name)
            np.testing.assert_allclose(gv, wv, rtol=rtol, atol=0,
                                       equal_nan=True, err_msg=f"{part}.{name}")


@pytest.mark.parametrize("method", CHI2)
@pytest.mark.parametrize("case", ["mixed", "flagged", "float32"])
def test_chi2_methods_match_jax(rng, method, case):
    if case == "mixed":
        x = _mixed_sample(rng)
    elif case == "flagged":
        x = np.concatenate([rng.choice(3, size=(400, 2, 2), p=[0.8, 0.1, 0.1]),
                            rng.choice(3, size=(400, 2, 2), p=[0.1, 0.1, 0.8])],
                           axis=1).astype(float)
    else:
        x = rng.integers(0, 4, size=(300, 4, 3)).astype(np.float32)
    got = mtt.discretediag(t(x), method=method)
    _assert_values(got, mdt.discretediag(x, method=method), 1e-9)
    assert all(v.dtype == torch.float64 for v in got.between_chain)


@pytest.mark.parametrize("method", BOOT)
def test_bootstrap_statistic_matches_jax(rng, method):
    x = _mixed_sample(rng, n=120)
    got = mtt.discretediag(t(x), method=method, nsim=50, rng=0)
    want = mdt.discretediag(x, method=method, nsim=50, rng=0)
    _assert_values(got, want, 1e-12, fields=("stat",))
    for part in (got.between_chain, got.within_chain):
        assert torch.isfinite(part.df).all()
        assert ((part.pvalue >= 0) & (part.pvalue <= 1)).all()


@pytest.mark.parametrize("method", ["DARBOOT", "billingsleyBOOT"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bootstrap_pvalues_agree_with_jax(method, seed):
    """Same distributions (between-chain) and a chain drawn from other
    category probabilities: p-values on the same side of 0.05 as the JAX
    package's wherever the JAX p-value is more than three Monte Carlo
    standard errors (sqrt(0.05 * 0.95 / nsim)) from 0.05; the bootstrap
    statistic's mean (``df``) within 15 % of JAX's."""
    rng = np.random.default_rng(100 + seed)
    nsim = 200
    same = rng.integers(0, 3, size=(200, 3, 2)).astype(float)
    odd = same.copy()
    odd[:, 0, 1] = rng.choice(3, size=200, p=[0.7, 0.2, 0.1])
    margin = 3 * np.sqrt(0.05 * 0.95 / nsim)
    for x in (same, odd):
        got = mtt.discretediag(t(x), method=method, nsim=nsim, rng=seed)
        want = mdt.discretediag(x, method=method, nsim=nsim, rng=seed)
        g, w = got.between_chain, want.between_chain
        wp = np.asarray(w.pvalue)
        clear = np.abs(wp - 0.05) > margin
        np.testing.assert_array_equal((g.pvalue.numpy() < 0.05)[clear],
                                      (wp < 0.05)[clear])
        np.testing.assert_allclose(g.df.numpy(), np.asarray(w.df), rtol=0.15)
    assert float(got.between_chain.pvalue[1]) < 0.05  # the odd chain


def test_mcboot_reference_quirk(rng):
    x = rng.integers(0, 3, size=(200, 2, 1)).astype(float)
    res = mtt.discretediag(t(x), method="MCBOOT", nsim=50, rng=0)
    for part in (res.between_chain, res.within_chain):
        assert torch.isnan(part.stat).all()
        assert (part.pvalue == 0.0).all()
        assert torch.isfinite(part.df).all()


@pytest.mark.parametrize("method", METHODS)
def test_shapes(rng, method):
    x = rng.integers(-100, 101, size=(100, 2, 4))
    res = mtt.discretediag(x, method=method, nsim=20, rng=0, device="cpu")
    for field in res.between_chain:
        assert field.shape == (4,) and field.dtype == torch.float64
    for field in res.within_chain:
        assert field.shape == (4, 2) and field.dtype == torch.float64


def test_errors(rng):
    x = rng.integers(0, 3, size=(100, 2, 1))
    with pytest.raises(ValueError, match="method"):
        mtt.discretediag(x, method="somemethod", device="cpu")
    for frac in (-0.3, 0.0, 1.0, 1.2):
        with pytest.raises(ValueError, match="frac"):
            mtt.discretediag(x, frac=frac, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        mtt.discretediag(x[:, :, 0], device="cpu")


@pytest.mark.parametrize("method", CHI2)
def test_slicing_invariance(rng, method):
    """A parameter alone (padded to its own category count) gives what it
    gives inside a batch padded to the largest."""
    x = np.concatenate([rng.integers(0, 3, size=(150, 3, 2)),
                        rng.integers(0, 7, size=(150, 3, 1))], axis=2)
    full = mtt.discretediag(t(x), method=method)
    for j in range(3):
        single = mtt.discretediag(t(x[:, :, j:j + 1]), method=method)
        np.testing.assert_allclose(single.between_chain.stat[0],
                                   full.between_chain.stat[j], rtol=1e-12)
        np.testing.assert_allclose(single.within_chain.pvalue[0],
                                   full.within_chain.pvalue[j], rtol=1e-12)


def test_deterministic_with_seed(rng):
    x = t(rng.integers(0, 3, size=(200, 2, 2)).astype(float))
    a = mtt.discretediag(x, method="DARBOOT", nsim=100, rng=7)
    b = mtt.discretediag(x, method="DARBOOT", nsim=100, rng=7)
    c = mtt.discretediag(x, method="DARBOOT", nsim=100, rng=8)
    assert torch.equal(a.between_chain.pvalue, b.between_chain.pvalue)
    assert torch.equal(a.within_chain.df, b.within_chain.df)
    assert not torch.equal(a.within_chain.df, c.within_chain.df)


def test_bootstrap_chunks_give_the_unchunked_statistics(rng, monkeypatch):
    """nsim split into chunks under the state budget: the statistic is
    unchanged and every replica is counted."""
    x = t(rng.integers(0, 3, size=(80, 2, 2)).astype(float))
    whole = mtt.discretediag(x, method="billingsleyBOOT", nsim=30, rng=3)
    monkeypatch.setattr(pdd, "_BOOT_STATE_BUDGET", 1)  # one replica a chunk
    chunked = mtt.discretediag(x, method="billingsleyBOOT", nsim=30, rng=3)
    assert torch.equal(whole.between_chain.stat, chunked.between_chain.stat)
    assert torch.isfinite(chunked.between_chain.df).all()
