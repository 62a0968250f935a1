"""The port's ``rhat_nested`` and ``bfmi`` against the JAX package at float64
(tolerance: BASELINE.md's 1e-6 relative parity bound), plus the float64
oracle ``ref_impl.rhat_nested`` and the contracts: superchain validation,
the ``m = 1`` correction, the degeneracy guard, ``dims``."""

import numpy as np
import pytest
import torch

import mcmcdiagnostictools_jl_tpu as mdt
import mcmcdiagnostictools_jl_tpu_torch as mtt
import ref_impl
from conftest import ar1
from torch_parity import assert_close, t

KINDS = ["rank", "bulk", "tail", "basic"]


@pytest.mark.parametrize("split_chains", [1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_rhat_nested_matches_jax_and_oracle(rng, kind, split_chains):
    x = ar1(rng, 0.5, 1.0, (101, 8, 3))
    x[:, 6:, 1] += 0.8  # one superchain off for parameter 1
    ids = np.repeat([3, 1, 4, 2], 2)
    got = mtt.rhat_nested(x, ids, kind=kind, split_chains=split_chains, device="cpu")
    assert_close(got, mdt.rhat_nested(x, ids, kind=kind,
                                      split_chains=split_chains))
    assert_close(got, ref_impl.rhat_nested(x, ids, kind=kind,
                                           split_chains=split_chains))


@pytest.mark.parametrize("kind", KINDS)
def test_one_chain_per_superchain_and_interleaved_ids(rng, kind):
    """m = 1 drops the between-chain term (corrected = m > 1); ids that
    interleave superchains are permuted contiguous first."""
    x = rng.standard_normal((80, 6, 2))
    for ids, split in (([0, 1, 2, 3, 4, 5], 1), ([0, 1, 2, 0, 1, 2], 2)):
        assert_close(mtt.rhat_nested(x, ids, kind=kind, split_chains=split, device="cpu"),
                     mdt.rhat_nested(x, ids, kind=kind, split_chains=split))


def test_param_dims_and_scalar_output(rng):
    x = rng.standard_normal((60, 4, 2, 3))
    got = mtt.rhat_nested(x, [0, 0, 1, 1], device="cpu")
    assert tuple(got.shape) == (2, 3)
    assert_close(got, mdt.rhat_nested(x, [0, 0, 1, 1]))
    assert isinstance(mtt.rhat_nested(x[:, :, 0, 0], [0, 0, 1, 1], device="cpu"), float)


def test_label_invariance(rng):
    x = t(rng.standard_normal((100, 4, 10)))
    assert torch.equal(mtt.rhat_nested(x, [1, 1, 2, 2], device="cpu"),
                       mtt.rhat_nested(x, [42, 42, 99, 99], device="cpu"))


@pytest.mark.parametrize("kind", KINDS)
def test_identical_and_nan_slices(rng, kind):
    x = rng.standard_normal((50, 4, 3))
    x[:, :, 0] = 1.5
    x[3, 2, 2] = np.nan
    v = mtt.rhat_nested(x, [0, 0, 1, 1], kind=kind, device="cpu").numpy()
    assert np.isnan(v[0]) and np.isfinite(v[1]) and np.isnan(v[2])


def test_rhat_nested_errors(rng):
    x = rng.standard_normal((50, 4, 2))
    with pytest.raises(ValueError, match="kind"):
        mtt.rhat_nested(x, [0, 0, 1, 1], kind="nope", device="cpu")
    with pytest.raises(ValueError, match="length"):
        mtt.rhat_nested(x, [0, 0, 1], device="cpu")
    with pytest.raises(ValueError, match="at least 2"):
        mtt.rhat_nested(x, [0, 0, 0, 0], device="cpu")
    with pytest.raises(ValueError, match="same number"):
        mtt.rhat_nested(x, [0, 0, 0, 1], device="cpu")
    with pytest.raises(ValueError, match="at least 2 dimensions"):
        mtt.rhat_nested(x[:, 0, 0], [0], device="cpu")


# ---- bfmi --------------------------------------------------------------------


def test_bfmi_vector_matrix_and_dims(rng):
    e = rng.standard_normal((500, 4)).cumsum(0) * 0.1 + rng.standard_normal((500, 4))
    v = mtt.bfmi(e[:, 0], device="cpu")
    assert isinstance(v, float)
    assert_close(v, mdt.bfmi(e[:, 0]))
    assert_close(mtt.bfmi(e, device="cpu"), mdt.bfmi(e))
    assert_close(mtt.bfmi(e.T, dims=1, device="cpu"), mdt.bfmi(e.T, dims=1))
    assert_close(mtt.bfmi(e.T, dims=1, device="cpu"), mtt.bfmi(e, device="cpu"), rtol=0, atol=0)


def test_bfmi_hand_computed_and_integer_input():
    e = np.array([1.0, 3.0, 2.0, 5.0])
    want = np.mean(np.diff(e) ** 2) / np.var(e, ddof=1)
    assert_close(mtt.bfmi(e, device="cpu"), want)
    assert_close(mtt.bfmi(np.array([1, 3, 2, 5]), device="cpu"), want, rtol=1e-6, atol=0)


def test_bfmi_errors(rng):
    with pytest.raises(ValueError):
        mtt.bfmi(rng.standard_normal((10, 2, 2)), device="cpu")
    with pytest.raises(ValueError):
        mtt.bfmi(rng.standard_normal((10, 2)), dims=2, device="cpu")
