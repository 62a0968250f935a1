"""The port's out-of-core executor against the JAX package's.

The cases of ``tests/test_streaming.py`` (``TestESSRhatStreaming``,
``TestGenericExecutor``) on one seeded numpy sample through both packages,
with ``device="cpu"`` (no card here: the schedule is a plain loop and the
pipeline takes the kernels' plain versions). The mesh cases
(``TestMeshStreaming``) run in one gloo world of 8 CPU processes over a 4 x 2
mesh (``tests/torch_dist.py``), against the JAX package's streaming on its
8 virtual CPU devices with the same layout.

Tolerances: float64 in either rank mode within BASELINE.md's 1e-6 of the JAX
package's streamed result; float32 fast mode within ESS 1e-4 relative and
R-hat 1e-5 absolute (float32 rounding of ranks and sums, as in
``tests/test_torch_ess_rhat.py``); streamed against the port's own monolithic
call 5e-6 relative (chunk width changes the tiling of float32 reductions),
and on a mesh against the port's sharded call 5e-6 relative and against the
in-core fast mode 1e-5 (as ``tests/test_streaming.py``).
"""

import inspect

import numpy as np
import pytest
import torch

import mcmcdiagnostictools_jl_tpu as mdt
import mcmcdiagnostictools_jl_tpu_torch as mtt
from mcmcdiagnostictools_jl_tpu_torch.streaming import (
    StreamStats,
    stream_param_chunks,
)
from torch_dist import MESH, run_world
from torch_parity import assert_close

KINDS = ["rank", "bulk", "tail", "basic"]


def _sample(rng, shape, dtype=np.float32):
    x = rng.standard_normal(shape)
    for t in range(1, shape[0]):
        x[t] += 0.5 * x[t - 1]
    return x.astype(dtype)


def _stream(x, **kw):
    return mtt.ess_rhat_streaming(x, device="cpu", **kw)


@pytest.mark.parametrize("rank_mode", ["fast", "exact"])
@pytest.mark.parametrize("kind", KINDS)
def test_float64_matches_jax_streaming(rng, kind, rank_mode):
    x = _sample(rng, (600, 4, 19), np.float64)
    got = _stream(x, param_chunk=8, kind=kind, rank_mode=rank_mode,
                  dtype=torch.float64)
    want = mdt.ess_rhat_streaming(x, param_chunk=8, kind=kind,
                                  rank_mode=rank_mode, dtype=np.float64)
    assert got.ess.dtype == torch.float64 and got.ess.shape == (19,)
    assert_close(got.ess, want.ess)
    assert_close(got.rhat, want.rhat)


@pytest.mark.parametrize("kind", KINDS)
def test_float32_fast_matches_jax_streaming(rng, kind):
    x = _sample(rng, (600, 4, 19))
    got = _stream(x, param_chunk=8, kind=kind)
    want = mdt.ess_rhat_streaming(x, param_chunk=8, kind=kind)
    assert got.ess.dtype == torch.float32
    assert_close(got.ess, want.ess, rtol=1e-4, atol=0)
    assert_close(got.rhat, want.rhat, rtol=0, atol=1e-5)


@pytest.mark.parametrize("rank_mode", ["fast", "exact"])
def test_matches_monolithic(rng, rank_mode):
    x = _sample(rng, (600, 4, 37))
    a = mtt.ess_rhat(x, kind="rank", rank_mode=rank_mode, device="cpu")
    b = _stream(x, param_chunk=8, kind="rank", rank_mode=rank_mode)
    assert_close(b.ess, a.ess, rtol=5e-6, atol=0)
    assert_close(b.rhat, a.rhat, rtol=5e-6, atol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_every_kind_matches_monolithic_with_options(rng, kind):
    """The options reach the pipeline: relative, split_chains, maxlag,
    tail_prob, rank_nbins, the autocovariance method."""
    x = _sample(rng, (402, 3, 11))
    kw = dict(kind=kind, relative=True, split_chains=3, maxlag=40,
              tail_prob=0.2, rank_mode="fast", rank_nbins=512,
              autocov_method=mtt.FFTAutocovMethod())
    a = mtt.ess_rhat(x, **kw, device="cpu")
    b = _stream(x, param_chunk=4, **kw)
    assert_close(b.ess, a.ess, rtol=5e-6, atol=0)
    assert_close(b.rhat, a.rhat, rtol=5e-6, atol=0)


def test_ragged_final_chunk(rng):
    # 37 params / chunk 16 -> chunks 16, 16, 5 (zero-padded)
    x = _sample(rng, (400, 4, 37))
    b = _stream(x, param_chunk=16)
    want = mdt.ess_rhat_streaming(x, param_chunk=16)
    assert b.ess.shape == (37,) and b.rhat.shape == (37,)
    assert bool(torch.isfinite(b.ess).all())
    assert_close(b.ess, want.ess, rtol=1e-4, atol=0)


@pytest.mark.parametrize("param_chunk", [6, 256])
def test_exactly_one_chunk(rng, param_chunk):
    x = _sample(rng, (400, 4, 6))
    a = mtt.ess_rhat(x, kind="rank", rank_mode="fast", device="cpu")
    b, stats = _stream(x, param_chunk=param_chunk, return_stats=True)
    assert stats.n_chunks == 1
    assert_close(b.ess, a.ess, rtol=1e-6, atol=0)


def test_callable_source_never_materializes():
    """The full array never needs to exist anywhere: the source generates
    each chunk on demand (deterministically per start)."""
    d, c, p = 500, 4, 24

    def source(start, size):
        cols = []
        for j in range(start, start + size):
            r = np.random.default_rng(1000 + j)
            cols.append(r.standard_normal((d, c)))
        return np.stack(cols, axis=2).astype(np.float32)

    b = _stream(source, nparams=p, param_chunk=7)
    a = mtt.ess_rhat(source(0, p), kind="rank", rank_mode="fast", device="cpu")
    want = mdt.ess_rhat_streaming(source, nparams=p, param_chunk=7)
    assert b.ess.shape == (p,)
    assert_close(b.ess, a.ess, rtol=1e-6, atol=0)
    assert_close(b.ess, want.ess, rtol=1e-4, atol=0)


def test_callable_source_is_cast_to_dtype(rng):
    x = _sample(rng, (300, 2, 5), np.float64)
    b = _stream(lambda s, n: x[:, :, s:s + n], nparams=5, param_chunk=2)
    a = _stream(x.astype(np.float32), param_chunk=2)
    assert b.ess.dtype == torch.float32
    assert torch.equal(b.ess, a.ess)


def test_stats_shape(rng):
    x = _sample(rng, (400, 4, 20))
    r, stats = _stream(x, param_chunk=8, return_stats=True)
    assert isinstance(stats, StreamStats)
    assert stats.n_chunks == 3 and stats.param_chunk == 8
    for name in ("fetch_s", "wait_s", "h2d_s", "compute_s"):
        vals = getattr(stats, name)
        assert len(vals) == 3 and all(v >= 0 for v in vals), name
    assert stats.h2d_s == [0.0, 0.0, 0.0]  # no card, no copy
    assert stats.wall_s >= sum(stats.compute_s) > 0
    assert isinstance(r, mtt.ESSRhat)


def test_param_shape_preserved(rng):
    x = _sample(rng, (400, 4, 3, 5))
    a = mtt.ess_rhat(x, kind="rank", rank_mode="fast", device="cpu")
    b = _stream(x, param_chunk=4)
    want = mdt.ess_rhat_streaming(x, param_chunk=4)
    assert b.ess.shape == (3, 5) and b.rhat.shape == (3, 5)
    assert_close(b.ess, a.ess, rtol=5e-6, atol=0)
    assert_close(b.ess, want.ess, rtol=1e-4, atol=0)


def test_2d_input_gives_0d_results(rng):
    x2 = _sample(rng, (400, 4))
    s = _stream(x2)
    want = mdt.ess_rhat_streaming(x2)
    assert s.ess.ndim == 0 and s.rhat.ndim == 0
    assert_close(s.ess, want.ess, rtol=1e-4, atol=0)
    assert_close(s.rhat, want.rhat, rtol=0, atol=1e-5)


def test_cpu_tensor_source(rng):
    x = _sample(rng, (300, 4, 5))
    a = _stream(x, param_chunk=2)
    b = _stream(torch.from_numpy(x), param_chunk=2)
    assert torch.equal(a.ess, b.ess) and torch.equal(a.rhat, b.rhat)


def test_array_source_is_not_read_for_probing():
    """A callable: exactly one (0, 1) discovery read, then the chunk reads."""
    reads = []

    def counting_source(start, size):
        reads.append((start, size))
        r = np.random.default_rng(123)
        return r.standard_normal((300, 4, size)).astype(np.float32)

    _stream(counting_source, nparams=6, param_chunk=6)
    assert reads == [(0, 1), (0, 6)], reads


def test_array_chunks_are_views(rng):
    """An array (or memmap) is sliced, not copied, before the gather into
    the staging buffer."""
    from mcmcdiagnostictools_jl_tpu_torch.streaming import _make_source

    x = _sample(rng, (50, 2, 9))
    src, nparams, pshape, dims = _make_source(x, None)
    assert (nparams, pshape, dims) == (9, (9,), (50, 2))
    assert np.shares_memory(src(3, 4), x) and src(3, 4).shape == (50, 2, 4)


def test_nan_poisoning_streams(rng):
    x = _sample(rng, (400, 4, 10))
    x[3, 1, 4] = np.nan
    b = _stream(x, param_chunk=4)
    ess, rhat = b.ess.numpy(), b.rhat.numpy()
    assert np.isnan(ess[4]) and np.all(np.isfinite(np.delete(ess, 4)))
    assert np.isnan(rhat[4]) and np.all(np.isfinite(np.delete(rhat, 4)))


def test_memmap_source(rng, tmp_path):
    """np.memmap input, read-only: streaming from outside host RAM."""
    x = _sample(rng, (400, 4, 12))
    f = tmp_path / "chains.dat"
    m = np.memmap(f, dtype=np.float32, mode="w+", shape=x.shape)
    m[:] = x
    m.flush()
    ro = np.memmap(f, dtype=np.float32, mode="r", shape=x.shape)
    a = mtt.ess_rhat(x, kind="rank", rank_mode="fast", device="cpu")
    b = _stream(ro, param_chunk=5)
    assert_close(b.ess, a.ess, rtol=1e-6, atol=0)
    assert_close(b.ess, mdt.ess_rhat_streaming(ro, param_chunk=5).ess,
                 rtol=1e-4, atol=0)


# ---- what raises -------------------------------------------------------------

def test_unsupported_kind_raises(rng):
    with pytest.raises(ValueError, match="kind"):
        _stream(_sample(rng, (400, 4, 3)), kind="quantile")


def test_bad_rank_mode_raises(rng):
    with pytest.raises(ValueError, match="rank_mode"):
        _stream(_sample(rng, (400, 4, 3)), rank_mode="nope")


def test_zero_params_raises(rng):
    x = rng.standard_normal((400, 4, 0)).astype(np.float32)
    with pytest.raises(ValueError, match="at least one parameter"):
        _stream(x)


def test_short_chain_raises(rng):
    with pytest.raises(ValueError, match="streaming"):
        _stream(rng.standard_normal((8, 4, 3)).astype(np.float32))


def test_1d_input_raises(rng):
    with pytest.raises(ValueError, match="draws, chains"):
        _stream(rng.standard_normal(100).astype(np.float32))


def test_mesh_parameters_are_not_accepted(rng):
    """``rank_impl`` is not accepted without ``mesh_cfg`` (JAX's
    ``test_rank_impl_requires_mesh``); ``mesh_cfg=None`` is the default."""
    params = inspect.signature(mtt.ess_rhat_streaming).parameters
    assert params["mesh_cfg"].default is None
    assert params["rank_impl"].default is None
    x = _sample(rng, (400, 4, 3))
    for rank_impl in ("hist", "gather"):
        with pytest.raises(ValueError, match="mesh_cfg"):
            _stream(x, rank_impl=rank_impl)
    assert _stream(x, mesh_cfg=None).ess.shape == (3,)


@pytest.mark.parametrize("param_chunk,err", [
    (0, ValueError), (-4, ValueError), (2.5, TypeError), ("8", TypeError),
    (True, TypeError)])
def test_bad_param_chunk_raises_before_any_read(param_chunk, err):
    reads = []

    def source(start, size):
        reads.append((start, size))
        return np.zeros((100, 2, size), np.float32)

    with pytest.raises(err, match="param_chunk"):
        stream_param_chunks(lambda c: c.sum((0, 1)), source, nparams=4,
                            param_chunk=param_chunk, device="cpu")
    assert reads == []


def test_nparams_must_match_an_array(rng):
    x = _sample(rng, (100, 2, 6))
    with pytest.raises(ValueError, match="nparams"):
        _stream(x, nparams=7)
    assert _stream(x, nparams=6).ess.shape == (6,)


@pytest.mark.parametrize("shape", [(100, 2), (100, 2, 3), (100, 2, 1, 1)])
def test_bad_first_chunk_raises_before_the_pipeline_runs(shape):
    """The probe column of a callable must be (draws, chains, 1)."""
    calls = []

    def source(start, size):
        calls.append((start, size))
        return np.zeros(shape, np.float32)

    with pytest.raises(ValueError, match="source returned"):
        _stream(source, nparams=10, param_chunk=5)
    assert calls == [(0, 1)]


def test_chunk_with_other_draws_or_chains_raises():
    def source(start, size):
        draws = 100 if start == 0 else 90
        return np.ones((draws, 2, size), np.float32)

    with pytest.raises(ValueError, match=r"\(draws, chains\)"):
        _stream(source, nparams=10, param_chunk=5)


def test_default_device_is_the_card(rng):
    """No card here: the default raises instead of running on the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mtt.ess_rhat_streaming(_sample(rng, (100, 2, 3)))


# ---- the generic executor ----------------------------------------------------

def test_arbitrary_pipeline(rng):
    """Any per-parameter function streams, here a dict of mean and std in
    float64, against the JAX executor on the same sample."""
    import jax.numpy as jnp

    from mcmcdiagnostictools_jl_tpu.streaming import (
        stream_param_chunks as jax_stream)

    x = rng.standard_normal((300, 2, 21))

    def fn(chunk):
        return {"mean": chunk.mean((0, 1)), "std": chunk.std((0, 1),
                                                             unbiased=False)}

    out = stream_param_chunks(fn, x, param_chunk=6, device="cpu",
                              dtype=np.float64)  # a numpy dtype, as JAX takes
    want = jax_stream(lambda c: {"mean": jnp.mean(c, axis=(0, 1)),
                                 "std": jnp.std(c, axis=(0, 1))}, x,
                      param_chunk=6)
    assert set(out) == {"mean", "std"} and out["mean"].shape == (21,)
    for name in ("mean", "std"):
        np.testing.assert_allclose(out[name].numpy(), want[name], rtol=1e-12)
    np.testing.assert_allclose(out["mean"].numpy(), x.mean(axis=(0, 1)),
                               rtol=1e-12)


@pytest.mark.parametrize("make", [
    lambda c: c.sum((0, 1)),
    lambda c: (c.sum((0, 1)), c.amax((0, 1))),
    lambda c: [c.sum((0, 1))],
    lambda c: mtt.ESSRhat(c.sum((0, 1)), c.amax((0, 1))),
    lambda c: c[0, 0],  # a view of the chunk: copied out of its buffer
])
def test_output_trees(rng, make):
    x = rng.standard_normal((30, 2, 11)).astype(np.float32)
    out = stream_param_chunks(make, x, param_chunk=4, device="cpu")
    want = make(torch.from_numpy(x))
    assert type(out) is type(want)
    for g, w in zip(out if isinstance(out, (tuple, list)) else [out],
                    want if isinstance(want, (tuple, list)) else [want]):
        assert g.shape == (11,)
        assert_close(g, w, rtol=1e-6, atol=1e-6)


def test_output_that_is_no_tensor_raises(rng):
    x = rng.standard_normal((30, 2, 4)).astype(np.float32)
    with pytest.raises(TypeError, match="fn must return"):
        stream_param_chunks(lambda c: 1.0, x, device="cpu")


def test_bad_source_shape_raises():
    def bad(start, size):
        return np.zeros((100, 2, size + 1))

    with pytest.raises(ValueError, match="source returned"):
        stream_param_chunks(lambda c: c.sum((0, 1)), bad, nparams=10,
                            param_chunk=5, device="cpu")


def test_nparams_required_for_callable():
    with pytest.raises(ValueError, match="nparams"):
        stream_param_chunks(lambda c: c, lambda s, n: None, device="cpu")


def test_chunks_are_padded_to_one_width(rng):
    """Every call of fn sees (draws, chains, param_chunk); the ragged chunk's
    surplus columns are zeros and their results are dropped."""
    x = rng.standard_normal((20, 3, 10)).astype(np.float32) + 5.0
    seen = []

    def fn(chunk):
        seen.append((tuple(chunk.shape), float(chunk[:, :, 2:].abs().sum())))
        return chunk.sum((0, 1))

    out = stream_param_chunks(fn, x, param_chunk=4, device="cpu")
    assert [s for s, _ in seen] == [(20, 3, 4)] * 3
    assert seen[2][1] == 0.0 and seen[0][1] > 0
    assert out.shape == (10,)
    assert_close(out, x.sum((0, 1)), rtol=1e-5, atol=0)


# ---- streaming onto a mesh ---------------------------------------------------


def _mesh_inputs():
    rng = np.random.default_rng(20261018)
    return {"x": _sample(rng, (800, 8, 20)),
            "ragged": _sample(rng, (600, 4, 18)),
            "exact": _sample(rng, (600, 8, 8)),
            "f64": _sample(rng, (600, 8, 12), np.float64),
            "bad": _sample(rng, (100, 4, 8))}


MX = _mesh_inputs()


def _mesh_calls():
    def stream(name, data, **kw):
        return (name, "ess_rhat_streaming", [MX[data]], dict(mesh_cfg=MESH,
                                                             **kw))

    return [
        ("sharded-hist", "parallel.ess_rhat_sharded", [MX["x"], MESH],
         dict(kind="rank", rank_impl="hist")),
        stream("x", "x", param_chunk=4, rank_impl="hist"),
        stream("ragged", "ragged", param_chunk=8),
        ("sharded-gather", "parallel.ess_rhat_sharded", [MX["exact"], MESH],
         dict(kind="rank", rank_impl="gather")),
        stream("exact", "exact", param_chunk=4, rank_mode="exact"),
        stream("ring", "exact", param_chunk=4, rank_mode="exact",
               rank_impl="ring"),
        *(stream(f"f64-{mode}-{kind}", "f64", param_chunk=4, kind=kind,
                 rank_mode=mode, dtype=torch.float64)
          for mode in ("fast", "exact") for kind in KINDS),
        stream("raises:auto", "bad", rank_impl="auto"),
        stream("raises:exact-hist", "bad", rank_mode="exact",
               rank_impl="hist"),
        stream("raises:fast-gather", "bad", rank_mode="fast",
               rank_impl="gather"),
        stream("raises:odd-chunk", "bad", param_chunk=3),
    ]


@pytest.fixture(scope="module")
def mesh_world(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("mesh_streaming"), 8, (4, 2),
                     _mesh_calls())[0]


@pytest.fixture(scope="module")
def jax_mesh():
    import jax

    from mcmcdiagnostictools_jl_tpu.parallel import make_mesh

    return make_mesh(4, 2, devices=jax.local_devices(backend="cpu")[:8])


class TestMeshStreaming:
    """Streaming onto a 4 x 2 mesh: chains sharded across the ranks while
    the parameters stream through them."""

    def test_matches_sharded_and_fast(self, mesh_world, jax_mesh):
        x = MX["x"]
        ess, rhat = mesh_world["x"]
        s_ess, s_rhat = mesh_world["sharded-hist"]
        assert_close(ess, s_ess, rtol=5e-6, atol=0)
        assert_close(rhat, s_rhat, rtol=5e-6, atol=0)
        c = mtt.ess_rhat(x, kind="rank", rank_mode="fast", device="cpu")
        assert_close(ess, c.ess, rtol=1e-5, atol=0)
        want = mdt.ess_rhat_streaming(x, param_chunk=4, mesh_cfg=jax_mesh,
                                      rank_impl="hist")
        assert_close(ess, want.ess, rtol=1e-4, atol=0)
        assert_close(rhat, want.rhat, rtol=0, atol=1e-5)

    def test_ragged_chunk_on_mesh(self, mesh_world, jax_mesh):
        # 18 params, chunks of 8 (4 a parameter shard): the last chunk holds
        # 2 parameters, both on the first parameter shard
        ess, rhat = mesh_world["ragged"]
        assert ess.shape == (18,) and rhat.shape == (18,)
        assert np.all(np.isfinite(ess)) and np.all(np.isfinite(rhat))
        want = mdt.ess_rhat_streaming(MX["ragged"], param_chunk=8,
                                      mesh_cfg=jax_mesh)
        assert_close(ess, want.ess, rtol=1e-4, atol=0)
        assert_close(rhat, want.rhat, rtol=0, atol=1e-5)

    def test_bad_rank_impl_raises(self, mesh_world):
        for name, exc, match in (
                ("raises:auto", "ValueError", "rank_impl"),
                ("raises:exact-hist", "ValueError", "conflicts"),
                ("raises:fast-gather", "ValueError", "conflicts"),
                ("raises:odd-chunk", "ValueError", "param_chunk")):
            err = mesh_world[name]
            assert err is not None and err[0] == exc and match in err[1], name

    def test_exact_mode_on_mesh_defaults_to_gather(self, mesh_world,
                                                   jax_mesh):
        ess, rhat = mesh_world["exact"]
        s_ess, _ = mesh_world["sharded-gather"]
        assert_close(ess, s_ess, rtol=5e-6, atol=0)
        # the ring gives the gather's ranks
        assert_close(mesh_world["ring"][0], ess, rtol=5e-6, atol=0)
        want = mdt.ess_rhat_streaming(MX["exact"], param_chunk=4,
                                      mesh_cfg=jax_mesh, rank_mode="exact")
        assert_close(ess, want.ess, rtol=1e-4, atol=0)
        assert_close(rhat, want.rhat, rtol=0, atol=1e-5)

    @pytest.mark.parametrize("rank_mode", ["fast", "exact"])
    @pytest.mark.parametrize("kind", KINDS)
    def test_float64_matches_jax_mesh_streaming(self, mesh_world, jax_mesh,
                                                kind, rank_mode):
        ess, rhat = mesh_world[f"f64-{rank_mode}-{kind}"]
        assert ess.dtype == np.float64 and ess.shape == (12,)
        want = mdt.ess_rhat_streaming(MX["f64"], param_chunk=4, kind=kind,
                                      rank_mode=rank_mode, mesh_cfg=jax_mesh,
                                      dtype=np.float64)
        assert_close(ess, want.ess)
        assert_close(rhat, want.rhat)
