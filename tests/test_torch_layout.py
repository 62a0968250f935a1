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
    got, pshape = canonicalize(x, "cpu")
    want, want_pshape = jcanon(x)
    assert pshape == tuple(want_pshape)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_canonicalize_promotes_integers_to_default_dtype():
    got, _ = canonicalize(np.arange(12).reshape(6, 2), "cpu")
    assert got.dtype == torch.get_default_dtype()
    with pytest.raises(ValueError):
        canonicalize(np.float64(1.0), "cpu")


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


@pytest.fixture
def no_card(monkeypatch):
    """As on a machine without a CUDA device, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("x", [np.ones((8, 2)), [[1.0, 2.0]], 3.0],
                         ids=["numpy", "list", "scalar"])
def test_non_tensor_input_without_device_needs_a_card(no_card, x):
    """Numpy, lists and scalars go to the card unless the caller names a
    device; with no card that raises and says how to ask for the host."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        to_tensor(x)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        canonicalize(np.ones((8, 2)))


def test_entry_points_with_numpy_and_no_device_need_a_card(no_card, rng):
    import mcmcdiagnostictools_jl_tpu_torch as mtt

    x = rng.standard_normal((40, 2, 3))
    for fn in (mtt.ess_rhat, mtt.mcse, mtt.gewekediag, mtt.gelmandiag,
               lambda v: mtt.bfmi(v[:, 0, 0])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(x)
    assert mtt.ess_rhat(x, device="cpu").ess.device.type == "cpu"


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
def test_named_cpu_device_is_honoured(no_card, rng, device):
    x = rng.standard_normal((8, 2))
    got = to_tensor(x, device=device)
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), x)


@pytest.mark.parametrize("dtype,want", [
    (np.float64, torch.float32), (np.float32, torch.float32),
    (np.int64, torch.int64)], ids=["float64", "float32", "int64"])
def test_non_tensor_float64_input_becomes_float32_on_the_card(
        monkeypatch, dtype, want):
    """On the card numpy float64 becomes float32, the dtype the kernels take
    (the JAX package's default casts it so); the card is faked by catching
    the array on its way to it."""
    from mcmcdiagnostictools_jl_tpu_torch import convert

    card = torch.device("cuda", 0)
    monkeypatch.setattr(convert, "resolve_device", lambda device: card)
    seen = {}

    def as_tensor(arr, device):
        seen["device"] = device
        return torch.from_numpy(arr)

    monkeypatch.setattr(torch, "as_tensor", as_tensor)
    got = to_tensor(np.ones((4, 2), dtype=dtype))
    assert seen["device"] == card and got.dtype == want
    assert to_tensor([[1.0, 2.0]]).dtype == torch.float32


def test_named_cpu_device_keeps_float64(no_card):
    assert to_tensor(np.ones(3), device="cpu").dtype == torch.float64
    assert canonicalize([[1.0], [2.0]], device="cpu")[0].dtype == torch.float64


def test_tensors_stay_where_they_are(no_card, rng):
    """A CPU tensor is the caller's request for the CPU: no card needed."""
    xt = t(rng.standard_normal((8, 2)))
    assert to_tensor(xt) is xt
    assert to_tensor(xt, device="cpu") is xt
    assert canonicalize(xt)[0].device.type == "cpu"
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
    assert backend.use_kernels(fake64) is False  # plain versions, on the card
    for dtype in (torch.float16, torch.bfloat16, torch.int64):
        fake = SimpleNamespace(device=torch.device("cuda", 0), dtype=dtype)
        with pytest.raises(NotImplementedError, match="float32"):
            backend.use_kernels(fake)
    with pytest.raises(NotImplementedError):
        backend.use_kernels(torch.zeros(2, device="meta"))
