"""The plain versions of kernels K6-K9 against the JAX kernel bodies.

The Pallas bodies of ``benchmarks/micro_lagloop.py`` (K6) and
``benchmarks/sort_microbench.py`` (K7-K9) run here in interpret mode on seeded
numpy inputs at small sizes: ``micro_lagloop._run`` as it is, with
``pallas_call`` interpreted and the module's sizes patched; the sort file's
``bench_*`` functions return only a time, so the same ``pallas_call`` is built
around the imported bodies to get the arrays. On the CPU the port's wrappers
take their plain versions, which is what is compared.

Tolerances: K6 within 1e-6 of the largest lag-0 sum (float32 sums in another
order); K7, K8 and K9 exact (K9 on distinct keys: a bitonic network is not
stable).
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mcmcdiagnostictools_jl_tpu_torch import kernels
from mcmcdiagnostictools_jl_tpu_torch.benchmarks import (
    micro_lagloop as port_lagloop,
    sort_microbench as port_sort,
    time_ms,
)
from mcmcdiagnostictools_jl_tpu_torch.kernels import lagloop_study, sort_study

_ROOT = Path(__file__).resolve().parent.parent
LANES = 128
TILE = 8  # rows of a tile here (2048 in the studies)


def _load(name):
    """A file of the JAX-era ``benchmarks/`` folder as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_era_{name}", _ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_lagloop():
    return _load("micro_lagloop")


@pytest.fixture(scope="module")
def jax_sort():
    return _load("sort_microbench")


# ---- K6 ---------------------------------------------------------------------

@pytest.mark.parametrize("niter,maxlag,series", [(64, 10, 256), (24, 30, 128)])
@pytest.mark.parametrize("variant", ["a", "b"])
def test_k6_plain_matches_jax_kernels(jax_lagloop, monkeypatch, variant,
                                      niter, maxlag, series):
    """Both JAX formulations against the port's function (lags at or past
    niter: 0 in both)."""
    monkeypatch.setattr(jax_lagloop, "NITER", niter)
    monkeypatch.setattr(jax_lagloop, "MAXLAG", maxlag)
    monkeypatch.setattr(jax_lagloop, "SERIES", series)
    monkeypatch.setattr(jax_lagloop.pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=True))
    x = np.random.default_rng(0).standard_normal(
        (niter, series)).astype(np.float32)
    body = {"a": jax_lagloop._kernel_a, "b": jax_lagloop._kernel_b}[variant]
    want = np.asarray(jax_lagloop._run(body, variant, jnp.asarray(x)))
    got = lagloop_study.lag_products(torch.from_numpy(x), maxlag, variant)
    assert got.dtype == torch.float32 and got.shape == (maxlag + 1, series)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * float(want[0].max()))
    assert torch.equal(got[niter:], torch.zeros_like(got[niter:]))
    assert torch.equal(
        got, lagloop_study.lag_products_plain(torch.from_numpy(x), maxlag))


def test_k6_is_not_centered():
    """c_0 of a constant series is its square (K5 would be handed zeros)."""
    x = torch.full((10, 3), 2.0)
    out = lagloop_study.lag_products(x, 4, "a")
    assert torch.allclose(out[0], torch.full((3,), 4.0))
    assert torch.allclose(out[4], torch.full((3,), 4.0 * 6 / 10))


@pytest.mark.parametrize("call", [
    lambda x: lagloop_study.lag_products(x, 3, "c"),
    lambda x: lagloop_study.lag_products(x[0], 3),
    lambda x: lagloop_study.lag_products(x, -1),
    lambda x: lagloop_study.lag_products(x[:0], 3),
])
def test_k6_rejects(call):
    with pytest.raises(ValueError):
        call(torch.zeros((8, 4)))


# ---- K7-K9 ------------------------------------------------------------------

def _arrays(ntiles, seed=0):
    """Distinct float32 keys (a permutation) and the arange payload."""
    n = ntiles * TILE
    rng = np.random.default_rng(seed)
    keys = rng.permutation(n * LANES).reshape(n, LANES).astype(np.float32)
    payload = np.arange(n * LANES, dtype=np.int32).reshape(n, LANES)
    return keys, payload


def _jax_in_place(body, grid, pod_rows, keys, payload):
    """``body`` in the ``pallas_call`` its ``bench_*`` function builds,
    interpreted; returns numpy ``(keys, payload)``."""
    any_spec = pl.BlockSpec(memory_space=pltpu.ANY)
    fn = pl.pallas_call(
        body, grid=grid, in_specs=[any_spec, any_spec],
        out_specs=(any_spec, any_spec),
        out_shape=(jax.ShapeDtypeStruct(keys.shape, jnp.float32),
                   jax.ShapeDtypeStruct(payload.shape, jnp.int32)),
        scratch_shapes=[pltpu.VMEM((pod_rows, LANES), jnp.float32),
                        pltpu.VMEM((pod_rows, LANES), jnp.int32),
                        pltpu.SemaphoreType.DMA((4,))],
        input_output_aliases={0: 0, 1: 1}, interpret=True)
    k, p = fn(jnp.asarray(keys), jnp.asarray(payload))
    return np.asarray(k), np.asarray(p)


def _port_in_place(fn, keys, payload):
    """The port's wrapper on CPU copies: in place, and returns its inputs."""
    k, p = torch.from_numpy(keys.copy()), torch.from_numpy(payload.copy())
    rk, rp = fn(k, p)
    assert rk is k and rp is p
    return k.numpy(), p.numpy()


@pytest.mark.parametrize("pod_tiles,stride_tiles", [
    (2, 1), (2, 2), (2, 4), (4, 2), (8, 1), (1, 8)])
def test_k7_plain_matches_jax_kernel(jax_sort, monkeypatch, pod_tiles,
                                     stride_tiles):
    monkeypatch.setattr(jax_sort, "TILE", TILE)
    ntiles = 8
    keys, payload = _arrays(ntiles)
    body = functools.partial(jax_sort._pass_kernel, ntiles_pod=pod_tiles,
                             stride_tiles=stride_tiles)
    want = _jax_in_place(body, (ntiles // pod_tiles, 1), pod_tiles * TILE,
                         keys, payload)
    got = _port_in_place(
        lambda k, p: sort_study.pass_strided(k, p, pod_tiles, stride_tiles,
                                             tile_rows=TILE), keys, payload)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("pod_tiles", [1, 2, 4, 8])
def test_k8_plain_matches_jax_kernel(jax_sort, monkeypatch, pod_tiles):
    monkeypatch.setattr(jax_sort, "TILE", TILE)
    ntiles = 8
    keys, payload = _arrays(ntiles, seed=1)
    body = functools.partial(jax_sort._pass_kernel_contig,
                             ntiles_pod=pod_tiles)
    want = _jax_in_place(body, (ntiles // pod_tiles,), pod_tiles * TILE, keys,
                         payload)
    got = _port_in_place(
        lambda k, p: sort_study.pass_contig(k, p, pod_tiles, tile_rows=TILE),
        keys, payload)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("pod_tiles", [1, 2, 4])
def test_k9_plain_matches_jax_kernel(jax_sort, monkeypatch, pod_tiles):
    """Keys equal, payload equal (distinct keys), direction by pod parity,
    payload consistent with the keys it started beside."""
    monkeypatch.setattr(jax_sort, "TILE", TILE)
    ntiles, pod_rows = 8, pod_tiles * TILE
    keys, payload = _arrays(ntiles, seed=2)
    body = functools.partial(jax_sort._phase_a_kernel, pod_rows=pod_rows)
    want_k, want_p = _jax_in_place(body, (ntiles // pod_tiles, 1), pod_rows,
                                   keys, payload)
    got_k, got_p = _port_in_place(
        lambda k, p: sort_study.bitonic_pod_sort(k, p, pod_rows), keys,
        payload)
    assert np.array_equal(got_k, want_k)
    assert np.array_equal(got_p, want_p)
    for pod in range(ntiles // pod_tiles):
        rows = slice(pod * pod_rows, (pod + 1) * pod_rows)
        ref = np.sort(keys[rows], axis=0)
        assert np.array_equal(got_k[rows], ref[::-1] if pod % 2 else ref)
    assert np.array_equal(keys.reshape(-1)[got_p], got_k)


@pytest.mark.parametrize("pod_rows", [2, 4, 64])
def test_k9_plain_sorts_other_widths(pod_rows):
    """Column counts off 128, pods of 2 rows, one pod only."""
    rng = np.random.default_rng(3)
    keys = rng.permutation(64 * 12).reshape(64, 12).astype(np.float32)
    payload = np.arange(64 * 12, dtype=np.int32).reshape(64, 12)
    k, p = sort_study.bitonic_pod_sort_plain(
        torch.from_numpy(keys), torch.from_numpy(payload), pod_rows)
    for pod in range(64 // pod_rows):
        rows = slice(pod * pod_rows, (pod + 1) * pod_rows)
        ref = np.sort(keys[rows], axis=0)
        assert np.array_equal(k[rows].numpy(), ref[::-1] if pod % 2 else ref)
    assert np.array_equal(keys.reshape(-1)[p.numpy()], k.numpy())


@pytest.mark.parametrize("pod_rows", [0, 1, 3, 12, 48, 128])
def test_k9_rejects_pod_rows(pod_rows):
    """Not a power of two, below 2, or not dividing the 64 rows."""
    k = torch.zeros((64, 4))
    p = torch.zeros((64, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        sort_study.bitonic_pod_sort(k, p, pod_rows)
    with pytest.raises(ValueError):
        sort_study.bitonic_pod_sort_plain(k, p, pod_rows)


@pytest.mark.parametrize("pod_tiles,stride_tiles,rows", [
    (3, 1, 64), (2, 3, 64), (4, 4, 64), (16, 1, 64), (2, 2, 60), (0, 1, 64),
    (2, 0, 64)])
def test_pass_rejects_pods_that_do_not_tile(pod_tiles, stride_tiles, rows):
    k = torch.zeros((rows, 4))
    p = torch.zeros((rows, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        sort_study.pass_strided(k, p, pod_tiles, stride_tiles, tile_rows=TILE)
    if stride_tiles == 1:
        with pytest.raises(ValueError):
            sort_study.pass_contig(k, p, pod_tiles, tile_rows=TILE)


@pytest.mark.parametrize("keys,payload", [
    (torch.zeros((8, 4)), torch.zeros((8, 4))),                     # payload type
    (torch.zeros((8, 4), dtype=torch.float64),
     torch.zeros((8, 4), dtype=torch.int32)),                       # keys type
    (torch.zeros((8, 4)), torch.zeros((8, 8), dtype=torch.int32)),  # shapes
    (torch.zeros((8,)), torch.zeros((8,), dtype=torch.int32)),      # 1-d
])
def test_sort_study_rejects_arrays(keys, payload):
    for call in (lambda: sort_study.pass_strided(keys, payload, 1, 1, tile_rows=8),
                 lambda: sort_study.pass_contig(keys, payload, 1, tile_rows=8),
                 lambda: sort_study.bitonic_pod_sort(keys, payload, 8)):
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("pod_tiles,ncols,want", [
    (16, 128, 4), (8, 128, 8), (4, 128, 16), (1, 128, 64), (16, 8, 64),
    (64, 128, 1), (512, 128, 1)])
def test_default_seg_rows_keeps_a_block_within_64_kb(pod_tiles, ncols, want):
    seg = sort_study.default_seg_rows(pod_tiles, ncols)
    assert seg == want and sort_study.TILE % seg == 0
    assert seg == 1 or pod_tiles * seg * ncols * 8 <= 64 * 1024


def test_cpu_tensors_launch_nothing():
    kernels.reset_launch_counts()
    lagloop_study.lag_products(torch.zeros((8, 4)), 2, "a")
    lagloop_study.lag_products(torch.zeros((8, 4)), 2, "b")
    k = torch.zeros((16, 4))
    p = torch.zeros((16, 4), dtype=torch.int32)
    sort_study.pass_strided(k, p, 2, 1, tile_rows=8)
    sort_study.pass_contig(k, p, 2, tile_rows=8)
    sort_study.bitonic_pod_sort(k, p, 8)
    counts = kernels.launch_counts()
    assert set(counts) >= {"K6a", "K6b", "K7", "K8", "K9"}
    assert not any(counts.values())


# ---- the entry points --------------------------------------------------------

def test_benchmark_data_comes_from_the_seed():
    a = port_lagloop.make_input(5, niter=16, series=8, device="cpu")
    b = port_lagloop.make_input(5, niter=16, series=8, device="cpu")
    c = port_lagloop.make_input(6, niter=16, series=8, device="cpu")
    assert a.dtype == torch.float32 and torch.equal(a, b)
    assert not torch.equal(a, c)
    k, p = port_sort.make_arrays(2, seed=5, lanes=8, device="cpu")
    k2, _ = port_sort.make_arrays(2, seed=5, lanes=8, device="cpu")
    assert k.shape == (2 * port_sort.TILE, 8) and torch.equal(k, k2)
    assert p.dtype == torch.int32
    assert torch.equal(p.reshape(-1), torch.arange(p.numel(), dtype=torch.int32))


@pytest.mark.parametrize("call", [
    lambda: port_lagloop.make_input(),
    lambda: port_sort.make_arrays(1),
    lambda: time_ms(lambda: None),
    lambda: port_sort.bench_phase_a(1, 1, device="cpu"),
])
def test_entry_points_need_the_card(call):
    """No card here: the default device raises, and so does timing."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        call()


def test_the_port_keeps_the_studies_settings(jax_lagloop, jax_sort):
    assert (port_lagloop.NITER, port_lagloop.MAXLAG, port_lagloop.SERIES) == (
        jax_lagloop.NITER, jax_lagloop.MAXLAG, jax_lagloop.SERIES)
    assert (port_sort.TILE, port_sort.LANES) == (jax_sort.TILE, jax_sort.LANES)
