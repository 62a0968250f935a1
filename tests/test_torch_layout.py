"""The port's layout, split, conversion and device rules against the JAX
package (float64, exact where the operation is a copy)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mcmcdiagnostictools_jl_tpu.utils.layout import canonicalize as jcanon
from mcmcdiagnostictools_jl_tpu.utils.layout import maybe_scalar as jmaybe
from mcmcdiagnostictools_jl_tpu.utils.split import split_chains_reshape as jsplit
from mcmcdiagnostictools_jl_tpu_torch import backend
from mcmcdiagnostictools_jl_tpu_torch.convert import to_numpy, to_tensor
from mcmcdiagnostictools_jl_tpu_torch.utils import (
    canonicalize,
    maybe_scalar,
    restore_param_shape,
    split_chains_reshape,
)
from torch_parity import t


@pytest.mark.parametrize("shape", [(11,), (11, 3), (11, 3, 2), (9, 2, 3, 4)])
def test_canonicalize_matches_jax(rng, shape):
    x = rng.standard_normal(shape)
    got, pshape = canonicalize(x)
    want, want_pshape = jcanon(x)
    assert pshape == tuple(want_pshape)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_canonicalize_promotes_integers_to_default_dtype():
    got, _ = canonicalize(np.arange(12).reshape(6, 2))
    assert got.dtype == torch.get_default_dtype()
    with pytest.raises(ValueError):
        canonicalize(np.float64(1.0))


@pytest.mark.parametrize("pshape", [(), (3,), (2, 2)])
def test_maybe_scalar_matches_jax(rng, pshape):
    vals = rng.standard_normal(int(np.prod(pshape)))
    got = maybe_scalar(t(vals), pshape)
    want = jmaybe(vals, pshape)
    if pshape == ():
        assert isinstance(got, float) and got == want
    else:
        assert tuple(got.shape) == pshape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_restore_param_shape_keeps_leading_axes(rng):
    v = t(rng.standard_normal((5, 6)))
    assert tuple(restore_param_shape(v, (2, 3)).shape) == (5, 2, 3)


@pytest.mark.parametrize("ndraws", [10, 11, 13])
@pytest.mark.parametrize("split", [1, 2, 3, 4])
def test_split_chains_matches_jax(rng, ndraws, split):
    """The remainder-discard rule, odd draw counts included: a copy, so
    exactly equal."""
    x = rng.standard_normal((ndraws, 3, 2))
    got = split_chains_reshape(t(x), split)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsplit(x, split)))


def test_split_chains_rejects_zero():
    with pytest.raises(ValueError):
        split_chains_reshape(torch.zeros(4, 1, 1), 0)


def test_numpy_goes_to_named_device_and_tensors_stay(rng):
    x = rng.standard_normal((8, 2))
    assert to_tensor(x).device.type == "cpu"
    assert to_tensor(x, device="cpu").device.type == "cpu"
    xt = t(x)
    assert to_tensor(xt) is xt
    with pytest.raises(ValueError):
        to_tensor(xt, device="meta")


def test_to_numpy_converts_named_tuples_and_scalars():
    from mcmcdiagnostictools_jl_tpu_torch import ESSRhat

    out = to_numpy(ESSRhat(torch.ones(2), 1.5))
    assert isinstance(out, ESSRhat) and isinstance(out.ess, np.ndarray)
    assert out.rhat == 1.5
    assert to_numpy((torch.zeros(1), 2.0))[1] == 2.0


def test_resolver_routes_by_device_and_dtype():
    assert backend.use_kernels(torch.zeros(2)) is False
    assert backend.use_kernels(torch.zeros(2, dtype=torch.float64)) is False
    fake = SimpleNamespace(device=torch.device("cuda", 0), dtype=torch.float32)
    assert backend.use_kernels(fake) is True
    fake64 = SimpleNamespace(device=torch.device("cuda", 0), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="float32"):
        backend.use_kernels(fake64)
    with pytest.raises(NotImplementedError):
        backend.use_kernels(torch.zeros(2, device="meta"))
