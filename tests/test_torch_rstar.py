"""The port's R*, its histogram GBT and ScaledPoissonBinomial against the
JAX package (float64 samples, float32 forest, on the CPU).

Tolerances: index utilities, binned features and fitted splits exact; the
Poisson-binomial moments, pdf and cdf within 1e-12; bin edges within 2
float32 ULP (JAX interpolates in its default float type); one level's
histograms and gains within 1e-5 relative (float32 sums in another order);
a forest fitted by the JAX package and carried across predicts
probabilities within 1e-6 and the same labels; deterministic R* equal
where the fits are equal. Fitted splits are compared only where every split
of every round wins by more than 1e-4 of its gain, which the test asserts.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import mcmcdiagnostictools_jl_tpu as mdt
import mcmcdiagnostictools_jl_tpu_torch as mtt
from mcmcdiagnostictools_jl_tpu.models import gbt as jgbt
from mcmcdiagnostictools_jl_tpu.models import poisson_binomial as jpb
from mcmcdiagnostictools_jl_tpu.utils import indices as jind
from mcmcdiagnostictools_jl_tpu_torch.convert import gbt_state_from_numpy
from mcmcdiagnostictools_jl_tpu_torch.models import gbt as pgbt
from mcmcdiagnostictools_jl_tpu_torch.models import poisson_binomial as ppb
from mcmcdiagnostictools_jl_tpu_torch.utils import indices as pind
from torch_parity import t


def _clf(**kw):
    return mtt.models.GBTClassifier(n_rounds=10, max_depth=3, n_bins=16, **kw)


def _jclf(**kw):
    return jgbt.GBTClassifier(n_rounds=10, max_depth=3, n_bins=16, **kw)


# ---- index utilities ----------------------------------------------------------

@pytest.mark.parametrize("split", [1, 2, 3])
def test_split_chain_indices_match_jax(rng, split):
    ids = np.concatenate([np.full(7, 3), np.full(10, 1), np.full(5, 2)])
    np.testing.assert_array_equal(pind.split_chain_indices(ids, split),
                                  jind.split_chain_indices(ids, split))


@pytest.mark.parametrize("frac", [0.3, 0.5, 0.7])
def test_shuffle_split_stratified_matches_jax(frac):
    """One generator state gives both packages the same split."""
    ids = np.repeat(np.arange(1, 9), [11, 10, 10, 9, 13, 10, 10, 7])
    a = pind.shuffle_split_stratified(np.random.default_rng(5), ids, frac)
    b = jind.shuffle_split_stratified(np.random.default_rng(5), ids, frac)
    for g, w in zip(a, b):
        np.testing.assert_array_equal(g, w)


# ---- ScaledPoissonBinomial ----------------------------------------------------

@pytest.mark.parametrize("n", [50, 3000], ids=["dp", "fft"])
def test_poisson_binomial_matches_jax(rng, n):
    p = rng.uniform(0, 1, n)
    a, b = ppb.ScaledPoissonBinomial(p, 0.25), jpb.ScaledPoissonBinomial(p, 0.25)
    assert a.mean() == b.mean() and a.var() == b.var()
    grid = a.support()[:: max(1, n // 40)]
    np.testing.assert_allclose(a.pdf(grid), b.pdf(grid), rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose(a.cdf(grid), b.cdf(grid), rtol=1e-12, atol=1e-300)
    assert a.quantile(0.5) == b.quantile(0.5)
    assert a.pdf(0.1) == 0.0  # off the support grid


def test_poisson_binomial_matches_binomial_and_is_lazy():
    from scipy.stats import binom

    d = ppb.ScaledPoissonBinomial(np.full(50, 0.3), 1.0)
    assert d._pmf_cache is None
    k = np.arange(51)
    np.testing.assert_allclose(d.pdf(k.astype(float)), binom.pmf(k, 50, 0.3),
                               rtol=1e-10, atol=1e-12)
    with pytest.raises(ValueError):
        ppb.ScaledPoissonBinomial(np.array([0.5, 1.5]), 1.0)


# ---- binning ------------------------------------------------------------------

def test_bin_edges_within_two_ulp_of_jax(rng):
    x = rng.standard_normal((301, 5)).astype(np.float32)
    x[:, 2] = np.round(x[:, 2])  # ties
    for n_bins in (16, 64):
        got = pgbt._quantile_bin_edges(t(x), n_bins).numpy()
        want = np.asarray(jgbt._quantile_bin_edges(x, n_bins))
        assert got.dtype == np.float32 and got.shape == (5, n_bins - 1)
        ulp = np.spacing(np.abs(want).astype(np.float32))
        assert np.all(np.abs(got - want) <= 2 * ulp)


def test_binned_features_match_jax(rng):
    x = rng.standard_normal((400, 4)).astype(np.float32)
    edges = np.asarray(jgbt._quantile_bin_edges(x, 16))
    # keep rows with no value within an ULP of an edge
    near = np.abs(x[:, :, None] - edges[None]) <= np.spacing(np.abs(edges))[None]
    x = x[~near.any(axis=(1, 2))]
    got = pgbt._bin_features(t(x), t(edges)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jgbt._bin_features(x, edges)))


def test_nan_gets_bin_zero_and_poisons_its_column_edges(rng):
    x = rng.standard_normal((50, 2)).astype(np.float32)
    x[3, 0] = np.nan
    edges = pgbt._quantile_bin_edges(t(x), 8)
    want = np.asarray(jgbt._quantile_bin_edges(x, 8))
    assert torch.isnan(edges[0]).all() and np.isnan(want[0]).all()
    assert not torch.isnan(edges[1]).any()
    binned = pgbt._bin_features(t(x), edges)
    np.testing.assert_array_equal(binned.numpy(),
                                  np.asarray(jgbt._bin_features(x, want)))
    fixed = pgbt._bin_features(t(x), edges.nan_to_num(0.0))
    assert int(fixed[3, 0]) == 0


# ---- one level ----------------------------------------------------------------

def _jax_level(binned, node, gh, n_nodes, n_bins, k, reg_lambda):
    """One level's histogram and gains as the JAX package's fit computes
    them (gbt.py:303-354), on its own."""
    import jax
    import jax.numpy as jnp

    n, nfeat = binned.shape
    seg = node[:, None] * n_bins + binned
    oh = jax.nn.one_hot(seg, n_nodes * n_bins, dtype=jnp.float32)
    hist = jnp.einsum("nfc,nk->fck", oh, gh,
                      precision=jax.lax.Precision.HIGHEST)
    hist = hist.reshape(nfeat, n_nodes, n_bins, 2 * k).transpose(1, 0, 2, 3)
    gl = jnp.cumsum(hist[..., :k], axis=2)
    hl = jnp.cumsum(hist[..., k:], axis=2)
    gtot, htot = gl[:, :, -1:, :], hl[:, :, -1:, :]
    gr, hr = gtot - gl, htot - hl
    gain = jnp.sum(gl**2 / (hl + reg_lambda) + gr**2 / (hr + reg_lambda)
                   - gtot**2 / (htot + reg_lambda), axis=3)
    return (np.asarray(hist), np.asarray(gain), np.asarray(hl.sum(3)),
            np.asarray(hr.sum(3)))


@pytest.mark.parametrize("n_nodes", [1, 4])
def test_level_histograms_and_gains_match_jax(rng, n_nodes, monkeypatch):
    n, nfeat, n_bins, k = 500, 3, 16, 5
    binned = rng.integers(0, n_bins, size=(n, nfeat))
    node = rng.integers(0, n_nodes, size=n)
    p = rng.dirichlet(np.ones(k), size=n).astype(np.float32)
    y = rng.integers(0, k, n)
    gh = np.concatenate([p - np.eye(k, dtype=np.float32)[y], p * (1 - p)], 1)
    want = _jax_level(binned, node, gh, n_nodes, n_bins, k, 1.0)
    monkeypatch.setattr(pgbt, "_ONEHOT_BYTES", 1)  # one feature a chunk
    chunks = pgbt._onehot_chunks(t(binned), t(node), n_nodes, n_bins)
    hist = pgbt._level_hist(chunks, t(gh), nfeat, n_nodes, n_bins)
    got = (hist,) + pgbt._split_gains(hist, k, 1.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)


# ---- forests ------------------------------------------------------------------

def _rows(rng, n=300, nf=3, k=4, sep=1.5):
    x = rng.standard_normal((n, nf)).astype(np.float32)
    y = rng.integers(0, k, n)
    x[:, 0] += y * sep
    return x, y, k


@pytest.mark.parametrize("class_chunk", [-1, 3], ids=["dense", "chunked"])
def test_jax_forest_predicts_the_same_in_the_port(rng, class_chunk):
    x, y, k = _rows(rng)
    jc = _jclf(class_chunk=class_chunk)
    jstate = jc.fit(x, y, k)
    state = gbt_state_from_numpy(jstate, "cpu")
    assert state.split_feature.dtype == torch.int64
    pc = _clf(class_chunk=class_chunk)
    np.testing.assert_allclose(pc.predict_proba(state, t(x)).numpy(),
                               np.asarray(jc.predict_proba(jstate, x)),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(pc.predict(state, t(x)).numpy(),
                                  np.asarray(jc.predict(jstate, x)))
    np.testing.assert_allclose(
        pc.predict_true_proba(state, t(x), y).numpy(),
        np.asarray(jc.predict_true_proba(jstate, x, y)), rtol=0, atol=1e-6)


def test_fitted_splits_match_jax_where_they_win_clearly(rng, monkeypatch):
    """Well-separated classes: every split wins by more than 1e-4 of its
    gain (asserted), and the port's forest has the JAX package's splits in
    every round, leaf values within 1e-5."""
    x, y, k = _rows(rng, n=400, nf=3, k=3, sep=3.0)
    margins = []
    best_split = pgbt._best_split

    def recording(gain, hl_sum, hr_sum, n_bins, min_child_weight):
        valid = (hl_sum >= min_child_weight) & (hr_sum >= min_child_weight)
        g = torch.where(valid, gain, -torch.inf)[:, :, :-1]
        top = g.reshape(g.shape[0], -1).topk(2, dim=1).values
        usable = torch.isfinite(top[:, 0]) & (top[:, 0] > 0)
        margins.append(((top[:, 0] - top[:, 1]) / top[:, 0].abs())[usable])
        return best_split(gain, hl_sum, hr_sum, n_bins, min_child_weight)

    monkeypatch.setattr(pgbt, "_best_split", recording)
    clf = mtt.models.GBTClassifier(n_rounds=6, max_depth=2, n_bins=16)
    got = clf.fit(t(x), y, k)
    want = jgbt.GBTClassifier(n_rounds=6, max_depth=2, n_bins=16).fit(x, y, k)
    assert float(torch.cat(margins).min()) > 1e-4
    np.testing.assert_array_equal(got.split_feature.numpy(),
                                  np.asarray(want.split_feature))
    np.testing.assert_array_equal(got.split_bin.numpy(),
                                  np.asarray(want.split_bin))
    np.testing.assert_allclose(got.leaf_value.numpy(),
                               np.asarray(want.leaf_value), rtol=0, atol=1e-5)


def test_bigk_matches_dense(rng):
    """The class-chunked fit and predict equal the dense ones (the JAX
    package's tests/test_rstar.py:216-250, in the port)."""
    n, nf, k = 1500, 4, 12
    x = rng.standard_normal((n, nf)).astype(np.float32)
    y = rng.integers(0, k, n)
    x[:, 0] += y * 0.5
    dense = mtt.models.GBTClassifier(n_rounds=8, n_bins=16, class_chunk=-1)
    bigk = mtt.models.GBTClassifier(n_rounds=8, n_bins=16, class_chunk=5)
    s1, s2 = dense.fit(t(x), y, k), bigk.fit(t(x), y, k)
    assert torch.equal(s1.split_feature, s2.split_feature)
    assert torch.equal(s1.split_bin, s2.split_bin)
    np.testing.assert_allclose(s1.leaf_value.numpy(), s2.leaf_value.numpy(),
                               atol=5e-6)
    assert torch.equal(dense.predict(s1, t(x)), bigk.predict(s2, t(x)))
    np.testing.assert_allclose(dense.predict_true_proba(s1, t(x), y).numpy(),
                               bigk.predict_true_proba(s2, t(x), y).numpy(),
                               atol=5e-6)


def test_chunk_width_rule():
    assert _clf()._chunk_width(1000, 20) == 0
    assert _clf()._chunk_width(1_000_000, 200) == 256
    assert _clf(class_chunk=-1)._chunk_width(1_000_000, 20_000) == 0
    assert _clf(class_chunk=64)._chunk_width(10, 20) == 20


# ---- R* -----------------------------------------------------------------------

def test_deterministic_rstar_matches_jax(rng):
    x = rng.standard_normal((200, 3, 2))
    x[:, 0] += 2.0
    got = mtt.rstar(mtt.models.deterministic(_clf()), t(x), rng=0)
    want = mdt.rstar(mdt.models.deterministic(_jclf()), x, rng=0)
    assert isinstance(got, float) and got == want


def test_probabilistic_rstar_tracks_jax(rng):
    x = rng.standard_normal((200, 3, 2))
    got = mtt.rstar(_clf(), t(x), rng=0)
    want = mdt.rstar(_jclf(), x, rng=0)
    assert isinstance(got, mtt.models.ScaledPoissonBinomial)
    assert got.n == want.n and got.scale == want.scale
    np.testing.assert_allclose(got.probs, want.probs, rtol=0, atol=1e-5)


def test_mixed_chains_near_one(rng):
    x = rng.standard_normal((400, 4, 2))
    dist = mtt.rstar(_clf(), t(x), rng=0)
    assert 0.5 < dist.mean() < 1.6


def test_separated_chains_near_nchains(rng):
    x = rng.standard_normal((400, 4, 2)) * 0.1
    x += np.arange(4)[None, :, None] * 10.0
    assert mtt.rstar(_clf(), t(x), rng=0).mean() > 0.7 * 4


def test_constant_samples():
    dist = mtt.rstar(_clf(), t(np.full((100, 3, 2), 4.0)), rng=0)
    assert dist.mean() == pytest.approx(1.0, rel=0.3)


def test_matrix_plus_chain_indices_ragged(rng):
    rows = rng.standard_normal((350, 2))
    ids = np.concatenate([np.full(200, 1), np.full(150, 2)])
    got = mtt.rstar(_clf(), t(rows), ids, rng=0)
    want = mdt.rstar(_jclf(), rows, ids, rng=0)
    assert 0.3 < got.mean() < 2.0
    assert got.n == want.n and got.scale == want.scale


def test_vector_input(rng):
    x = rng.standard_normal(300)
    dist = mtt.rstar(_clf(), t(x), rng=0)
    assert dist.n == 90 and 0.3 < dist.mean() < 2.0  # 2 classes x 45 rows


def test_tabular_inputs(rng):
    cols = {"a": rng.standard_normal(200), "b": rng.standard_normal(200)}
    ids = np.repeat([1, 2], 100)
    from_dict = mtt.rstar(_clf(), cols, ids, rng=0, device="cpu")
    frame = SimpleNamespace(to_numpy=lambda: np.column_stack(list(cols.values())))
    from_frame = mtt.rstar(_clf(), frame, ids, rng=0, device="cpu")
    assert from_dict.mean() == from_frame.mean()
    with pytest.raises(ValueError, match="chain_indices"):
        mtt.rstar(_clf(), cols, rng=0, device="cpu")


def test_default_classifier(rng):
    x = rng.standard_normal((100, 2, 1))
    dist = mtt.rstar(None, t(x), rng=0)
    assert isinstance(dist, mtt.models.ScaledPoissonBinomial)


def test_split_chains_1(rng):
    x = rng.standard_normal((300, 3, 1)) * 0.1
    x += np.arange(3)[None, :, None] * 5.0
    assert mtt.rstar(_clf(), t(x), split_chains=1, rng=0).mean() > 0.8 * 3


def test_errors(rng):
    x = t(rng.standard_normal((100, 2, 1)))
    for subset in (0.0, 1.0):
        with pytest.raises(ValueError, match="subset"):
            mtt.rstar(_clf(), x, subset=subset)
    with pytest.raises(ValueError, match="matching lengths"):
        mtt.rstar(_clf(), t(rng.standard_normal((100, 2))),
                  np.ones(99, dtype=int))
    with pytest.raises(ValueError, match="matrix"):
        mtt.rstar(_clf(), x, np.ones(100, dtype=int))


def test_seed_reproducible(rng):
    x = t(rng.standard_normal((200, 3, 2)))
    a = mtt.rstar(_clf(), x, rng=42)
    b = mtt.rstar(_clf(), x, rng=42)
    assert a.mean() == b.mean()


def test_many_chains_take_the_chunked_fit(rng, monkeypatch):
    calls = []
    fit = pgbt._fit_gbt_bigk
    monkeypatch.setattr(pgbt, "_fit_gbt_bigk",
                        lambda *a, **kw: calls.append(1) or fit(*a, **kw))
    x = rng.standard_normal((40, 64, 3))
    dist = mtt.rstar(mtt.models.GBTClassifier(n_rounds=6, n_bins=16,
                                              class_chunk=32), t(x), rng=0)
    assert calls and 0.2 < dist.mean() < 2.5
