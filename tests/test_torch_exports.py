"""The port's public names against the JAX package's.

- every ``__all__`` of the JAX package (the package, ``ops``, ``utils``,
  ``models``) is in the port's counterpart, less ``enable_compilation_cache``
  (an XLA compile cache: the port builds its kernels once into a cached
  directory), and each listed name exists;
- ``ops.tiedrank`` (ties, a NaN column, NaN among numbers, +-inf),
  ``utils.sample_dims``, ``utils.param_shape`` and
  ``utils.split_draw_indices`` equal the JAX functions' output (float64
  within 1e-6; shapes and index arrays exactly);
- on the CPU the markers ``PallasAutocovMethod`` and ``FusedAutocovMethod``
  (either ``interpret``) and the strings ``"pallas"``,
  ``"pallas_interpret"``, ``"fused"`` and ``"fused_interpret"`` give the
  ESS and R-hat of ``AutocovMethod()`` (BASELINE.md's 1e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmcdiagnostictools_jl_tpu as mdt
import mcmcdiagnostictools_jl_tpu_torch as mtt
from conftest import ar1
from mcmcdiagnostictools_jl_tpu import models as jmodels
from mcmcdiagnostictools_jl_tpu import ops as jops
from mcmcdiagnostictools_jl_tpu import utils as jutils
from mcmcdiagnostictools_jl_tpu_torch import models, ops, utils
from torch_parity import assert_close, t

NOT_PORTED = {"enable_compilation_cache"}


@pytest.mark.parametrize("jax_mod,port_mod", [
    (mdt, mtt), (jops, ops), (jutils, utils), (jmodels, models)],
    ids=["package", "ops", "utils", "models"])
def test_port_exports_the_jax_names(jax_mod, port_mod):
    missing = set(jax_mod.__all__) - set(port_mod.__all__) - NOT_PORTED
    assert not missing
    for name in port_mod.__all__:
        assert hasattr(port_mod, name), name


def _rank_input():
    rng = np.random.default_rng(4)
    x = np.round(rng.standard_normal((40, 5)), 1)  # heavy ties
    x[:, 1] = np.nan
    x[[3, 17], 2] = np.nan
    x[5, 3], x[9, 3], x[11, 3] = np.inf, -np.inf, np.inf
    x[:, 4] = 2.5
    return x


def test_tiedrank_matches_jax():
    """Equal ranks for the numbers; the NaNs of a column take the ranks
    after them in both, each its own, in column order in the port and in
    whatever order the JAX package's unstable sort leaves them."""
    x = _rank_input()
    want = np.asarray(jops.tiedrank(jnp.asarray(x)))
    got = ops.tiedrank(t(x))
    assert got.shape == x.shape and got.dtype == torch.float64
    nan = np.isnan(x)
    assert_close(got[~t(nan)], want[~nan], rtol=1e-6, atol=1e-12)
    for j in range(x.shape[1]):
        col = got[:, j].numpy()[nan[:, j]]
        assert np.array_equal(np.sort(col), np.sort(want[nan[:, j], j]))
        assert np.array_equal(col, np.arange(41 - len(col), 41))


def test_tiedrank_ranks_sign_bit_nans_last():
    """A NaN with the sign bit set ranks where any other NaN does."""
    x = _rank_input()
    neg = x.copy()
    neg[np.isnan(neg)] = -np.nan
    assert np.signbit(neg[0, 1])
    assert torch.equal(ops.tiedrank(t(neg)), ops.tiedrank(t(x)))


@pytest.mark.parametrize("shape", [(7,), (7, 3), (7, 3, 2), (7, 3, 2, 4)])
def test_layout_helpers_match_jax(shape):
    x = np.zeros(shape)
    for arg in (x, t(x), x.tolist()):
        assert utils.sample_dims(arg) == jutils.sample_dims(x)
        assert utils.param_shape(arg) == tuple(jutils.param_shape(x))


@pytest.mark.parametrize("ndraws,split", [(10, 2), (11, 2), (11, 3), (9, 4),
                                          (5, 1), (3, 5)])
def test_split_draw_indices_match_jax(ndraws, split):
    got = utils.split_draw_indices(ndraws, split)
    want = jutils.split_draw_indices(ndraws, split)
    assert got.shape == want.shape and np.array_equal(got, want)


def test_split_draw_indices_rejects_zero_splits():
    with pytest.raises(ValueError):
        utils.split_draw_indices(10, 0)


MARKERS = [mtt.PallasAutocovMethod(), mtt.PallasAutocovMethod(interpret=True),
           mtt.FusedAutocovMethod(), mtt.FusedAutocovMethod(interpret=True),
           "pallas", "pallas_interpret", "fused", "fused_interpret"]


@pytest.mark.parametrize("method", MARKERS, ids=str)
def test_jax_method_names_give_the_direct_estimator(method):
    x = t(ar1(np.random.default_rng(8), 0.6, 1.0, (300, 4, 6)))
    want = mtt.ess_rhat(x, kind="basic", autocov_method=mtt.AutocovMethod())
    got = mtt.ess_rhat(x, kind="basic", autocov_method=method)
    assert_close(got.ess, want.ess)
    assert_close(got.rhat, want.rhat)
    assert_close(mtt.mcse(x, kind="mean", autocov_method=method),
                 mtt.mcse(x, kind="mean", autocov_method=mtt.AutocovMethod()))


def test_marker_names_match_jax():
    for interpret in (False, True):
        assert (mtt.PallasAutocovMethod(interpret).name
                == mdt.PallasAutocovMethod(interpret).name)
        assert (mtt.FusedAutocovMethod(interpret).name
                == mdt.FusedAutocovMethod(interpret).name)
