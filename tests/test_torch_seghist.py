"""The port's ``ops/seghist.py`` against the JAX package's.

Per-split-chain moments read straight off a sorted sample by the flat
positions it carries: the split-chain ids (equal), the segment sums and the
``ChainStats`` they give (float64, within BASELINE.md's 1e-6), on seeded
numpy input through both packages, with odd draw counts (the remainder
rule), ``split=3`` and a single chain. The port takes rows ``(P, N)``, the
JAX package ``(N, P)``: the JAX functions get the transpose. Also against
the port's own ``chain_stats`` of the values routed back to (draw, chain)
order, the degenerate (constant) slice, and the ring route's ``(N, P)``
blocks passed as transposed views.
"""

import numpy as np
import pytest
import torch

import mcmcdiagnostictools_jl_tpu.ops.seghist as jsh
from mcmcdiagnostictools_jl_tpu_torch.kernels import seghist as kseg
from mcmcdiagnostictools_jl_tpu_torch.ops import seghist
from mcmcdiagnostictools_jl_tpu_torch.ops.moments import chain_stats
from mcmcdiagnostictools_jl_tpu_torch.utils.split import split_chains_reshape
from torch_parity import assert_close, t

# (ndraws, nchains, split): even and odd draws, split 3 (a remainder of 1 and
# of 2), one chain, fewer draws than a split needs
SPLITS = [(1000, 4, 2), (1001, 4, 2), (1000, 3, 3), (1001, 5, 3),
          (999, 1, 2), (7, 2, 4), (3, 2, 4)]


def _positions(rng, ndraws, nchains, p):
    """``(P, N)``: each row a random permutation of the flat positions, the
    order a sort leaves them in."""
    n = ndraws * nchains
    return np.stack([rng.permutation(n) for _ in range(p)])


@pytest.mark.parametrize("ndraws,nchains,split", SPLITS)
def test_split_chain_ids_match_jax(ndraws, nchains, split):
    rng = np.random.default_rng(ndraws + 10 * nchains + split)
    order = _positions(rng, ndraws, nchains, 3)
    seg, valid = seghist.split_chain_ids_from_flat(t(order), ndraws, nchains,
                                                   split)
    want_seg, want_valid = jsh.split_chain_ids_from_flat(
        order.T.astype(np.int32), ndraws, nchains, split)
    np.testing.assert_array_equal(seg.numpy(), np.asarray(want_seg).T)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid).T)
    # every split chain keeps ndraws // split draws
    kept = np.bincount(seg.numpy()[0][valid.numpy()[0]],
                       minlength=nchains * split)
    assert (kept == ndraws // split).all()


@pytest.mark.parametrize("ndraws,nchains,split", SPLITS)
def test_weighted_segment_moments_match_jax(ndraws, nchains, split):
    rng = np.random.default_rng(ndraws * nchains + split)
    p = 4
    order = _positions(rng, ndraws, nchains, p)
    values = rng.standard_normal(order.shape)
    seg, valid = seghist.split_chain_ids_from_flat(t(order), ndraws, nchains,
                                                   split)
    got = seghist.weighted_segment_moments(t(values), seg, valid,
                                           nchains * split)
    want = jsh.weighted_segment_moments(
        values.T, np.asarray(seg, dtype=np.int32).T, valid.numpy().T,
        nseg=nchains * split)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (nchains * split, p)
        assert_close(g, w)


@pytest.mark.parametrize("ndraws,nchains,split",
                         [s for s in SPLITS if s[0] // s[2] > 1])
def test_split_chain_stats_match_jax_and_routed_chain_stats(ndraws, nchains,
                                                            split):
    rng = np.random.default_rng(3 * ndraws + nchains + split)
    p = 5
    x = rng.standard_normal((ndraws, nchains, p)) * 2.0 + 1.0
    x[:, :, 4] = 0.25  # constant: degenerate, NaN R-hat
    order = _positions(rng, ndraws, nchains, p)
    values = x.reshape(ndraws * nchains, p).T[np.arange(p)[:, None], order]
    got = seghist.split_chain_stats_from_sorted(t(values), t(order), ndraws,
                                                nchains, split)
    want = jsh.split_chain_stats_from_sorted(values.T,
                                             order.T.astype(np.int32),
                                             ndraws, nchains, split)
    for name in ("chain_mean", "chain_var", "w", "var_plus", "rhat"):
        assert_close(getattr(got, name), getattr(want, name),
                     rtol=1e-6, atol=1e-12, equal_nan=True)
    np.testing.assert_array_equal(got.degenerate.numpy(),
                                  np.asarray(want.degenerate))
    assert bool(got.degenerate[4]) and bool(torch.isnan(got.rhat[4]))
    # the same statistics as routing the values back and splitting them
    routed = chain_stats(split_chains_reshape(t(x), split))
    for name in ("chain_mean", "chain_var", "rhat"):
        assert_close(getattr(got, name)[..., :4], getattr(routed, name)[..., :4])


def test_segment_moments_plain_min_max_over_kept_draws():
    """The min and max skip the draws the remainder rule discards."""
    ndraws, nchains, split = 5, 2, 2  # draw 2 is discarded
    x = np.arange(10.0).reshape(5, 2, 1)
    x[2] = [[-100.0], [100.0]]
    order = np.arange(10)[None, :]
    before = kseg.segment_moments.launches
    s, s2, lo, hi = kseg.segment_moments(t(x.reshape(1, 10)), t(order),
                                         ndraws, nchains, split)
    assert kseg.segment_moments.launches == before  # CPU: the plain version
    assert float(lo[0]) == 0.0 and float(hi[0]) == 9.0
    assert float(s.sum()) == float(x.sum() - x[2].sum())
    assert float(s2.sum()) == float((x ** 2).sum() - (x[2] ** 2).sum())


@pytest.mark.parametrize("ndraws,nchains,split", SPLITS)
def test_segment_moments_take_sample_major_blocks_transposed(ndraws, nchains,
                                                             split):
    """The ring route's ``(N, P)`` values and positions, passed as their
    transposed views, give the rows' results."""
    rng = np.random.default_rng(7 * ndraws + nchains + split)
    order = _positions(rng, ndraws, nchains, 3)
    values = rng.standard_normal(order.shape)
    want = kseg.segment_moments(t(values), t(order), ndraws, nchains, split)
    got = kseg.segment_moments(t(values.T).t(), t(order.T).t(), ndraws,
                               nchains, split)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
