"""The port's sharded diagnostics (``parallel/``) against the JAX package's.

The cases of ``tests/test_sharded.py`` on gloo worlds of CPU processes
(``tests/torch_dist.py``): every case of a mesh layout runs in one world of
``chain_shards * param_shards`` ranks, and every rank's results must equal
rank 0's bit for bit. The inputs are made from one seed with numpy, at
float64, and go through the JAX package's ``ess_rhat_sharded`` /
``rhat_nested_sharded`` on its 8 virtual CPU devices with the same layout
(or, where ``tests/test_sharded.py`` holds a case to the single-device
function, through that), and through the port's in-core functions.

Tolerances: the exact kinds within BASELINE.md's 1e-6 of the JAX package
(``PARITY_F64``) and within 1e-10 of the port's in-core call (the same
operations, sums split across ranks); ring equal to gather within 1e-12;
the histogram kinds (``rank_impl="hist"``) within 1e-6 relative and 1e-5
absolute of the JAX package's and of the port's in-core fast mode (float32
bin moments summed across ranks in another order), as
``tests/test_torch_fastrank.py`` holds the fast mode; the histogram kinds
against the exact ones as ``tests/test_sharded.py`` holds them (ESS 1e-3
relative, R-hat 1e-4 absolute; discrete data 1e-9).
"""

import functools

import jax
import numpy as np
import pytest

import mcmcdiagnostictools_jl_tpu as mdt
import mcmcdiagnostictools_jl_tpu_torch as mtt
from mcmcdiagnostictools_jl_tpu.parallel import (
    ess_rhat_sharded as jax_sharded,
    make_mesh as jax_make_mesh,
    rhat_nested_sharded as jax_nested,
)
from mcmcdiagnostictools_jl_tpu_torch.parallel.sharded import _resolve_rank_impl
from torch_dist import MESH, run_world
from torch_parity import assert_close, t

SEED = 20261017
KINDS = ["basic", "bulk", "tail", "rank"]
RANK_KINDS = ["bulk", "tail", "rank"]
LAYOUTS = [(8, 1), (4, 2), (2, 4), (1, 8)]
IN_CORE = dict(rtol=1e-10, atol=1e-12)
RING_GATHER = dict(rtol=1e-12, atol=1e-14)
HIST = dict(rtol=1e-6, atol=1e-5)

cpu_devices = jax.local_devices(backend="cpu")
needs8 = pytest.mark.skipif(len(cpu_devices) < 8,
                            reason="needs 8 virtual devices")


def _tied(rng, d, c, p):
    x = rng.standard_normal((d, c, p))
    x[:, :, 3] = np.round(x[:, :, 3] * 2) / 2  # many ties
    x[:, :, 4] = np.round(x[:, :, 4])
    x[:, :, 5] = np.sign(x[:, :, 5])  # only two distinct values
    x[7, 3, 2] = np.nan  # poisons param 2 only
    return x


def _make_inputs():
    rng = np.random.default_rng(SEED)
    x = {
        "x": rng.standard_normal((300, 8, 8)),
        "small": rng.standard_normal((200, 4, 4)),
        "const": np.full((96, 8, 2), 1.25),
        "methods": rng.standard_normal((300, 8, 4)),
        "odd": rng.standard_normal((301, 8, 4)),
        "nested": rng.standard_normal((100, 16, 4)),
        "uneven": rng.standard_normal((100, 6, 4)),
        "tied": _tied(rng, 300, 16, 6),
        "tied8": _tied(rng, 300, 16, 8),
        "nan_col": rng.standard_normal((240, 16, 3)),
        "degen": rng.standard_normal((120, 8, 3)),
        "nested_ring": rng.standard_normal((200, 32, 4)),
        "hist": rng.standard_normal((2000, 16, 6)),
        "hist_exact": rng.standard_normal((4000, 16, 4)) * 2.0 - 1.0,
        "hist_nan": rng.standard_normal((1000, 16, 4)),
        "hist_int": rng.integers(0, 5, size=(1000, 16, 4)).astype(float),
        "hist_inf": rng.standard_normal((1000, 16, 4)),
    }
    x["nan_col"][0, 0, 1] = np.nan
    x["degen"][:, :, 1] = 7.0
    x["nested_ring"][:, :, 2] = np.round(x["nested_ring"][:, :, 2])
    x["hist_nan"][3, 5, 2] = np.nan
    # an infinity in chain 0 only: on the first chain shard of every layout
    x["hist_inf"][5, 0, 1] = np.inf
    return x


X = _make_inputs()
IDS = {"nested": np.repeat(np.arange(8), 2), "uneven": np.repeat(np.arange(3), 2),
       "nested_ring": np.repeat(np.arange(8), 4)}


def _ess(name, data, **kw):
    return (name, "parallel.ess_rhat_sharded", [X[data], MESH], kw)


def _nested(name, data, ids=None, **kw):
    return (name, "parallel.rhat_nested_sharded",
            [X[data], IDS[ids or data], MESH], kw)


def _calls():
    calls = {layout: [_ess(f"x-{k}", "x", kind=k) for k in KINDS]
             for layout in LAYOUTS}
    calls[(1, 1)] = [_ess("small-rank", "small", kind="rank")]
    calls[(8, 1)] += [
        _ess("const-basic", "const", kind="basic"),
        _ess("odd-split3", "odd", kind="basic", split_chains=3),
        *(_ess(f"tied-{k}-{impl}", "tied", kind=k, rank_impl=impl)
          for k in RANK_KINDS for impl in ("gather", "ring")),
        *(_ess(f"nan_col-{impl}", "nan_col", kind="tail", rank_impl=impl)
          for impl in ("gather", "ring")),
        *(_ess(f"degen-{k}", "degen", kind=k, rank_impl="ring")
          for k in ("rank", "tail")),
        *(_nested(f"nested_ring-{k}", "nested_ring", kind=k, rank_impl="ring")
          for k in RANK_KINDS),
    ]
    calls[(4, 2)] += [
        *(_ess(f"methods-{m}", "methods", kind="basic", autocov_method=m)
          for m in ("fft", "direct", "bda")),
        *(_nested(f"nested-{k}", "nested", kind=k) for k in KINDS),
        _ess("tied8-ring", "tied8", kind="rank", rank_impl="ring"),
        *(_ess(f"hist-{k}", "hist", kind=k, rank_impl="hist")
          for k in RANK_KINDS),
        _ess("hist_exact", "hist_exact", kind="rank", rank_impl="hist"),
        _ess("hist_nan", "hist_nan", kind="rank", rank_impl="hist"),
        _ess("hist_int", "hist_int", kind="rank", rank_impl="hist"),
        _ess("hist_inf", "hist_inf", kind="rank", rank_impl="hist"),
        *(_nested(f"nested-hist-{k}-{impl}", "hist", "nested", kind=k,
                  rank_impl=impl)
          for k in RANK_KINDS for impl in ("hist", "gather")),
    ]
    calls[(2, 4)] += [_nested("raises:uneven", "uneven")]
    return calls


CALLS = _calls()


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """``port(layout, name)``: rank 0's result of a call; the layout's world
    runs once, on the first call that needs it."""
    results = {}

    def get(layout, name):
        if layout not in results:
            k, m = layout
            results[layout] = run_world(
                tmp_path_factory.mktemp(f"world{k}x{m}"), k * m, layout,
                CALLS[layout])[0]
        return results[layout][name]

    return get


@functools.lru_cache(maxsize=None)
def _jax_mesh(layout):
    k, m = layout
    return jax_make_mesh(k, m, devices=cpu_devices[:k * m])


def jax_ess(layout, data, **kw):
    return jax_sharded(X[data], _jax_mesh(layout), **kw)


def in_core(data, **kw):
    return mtt.ess_rhat(t(X[data]), **kw)


def assert_pair(got, want, **tol):
    assert_close(got[0], want[0], **tol)
    assert_close(got[1], want[1], **tol)


def test_public_names():
    for name in ("MeshConfig", "make_mesh", "shard_canonical",
                 "ess_rhat_sharded", "rhat_nested_sharded"):
        assert hasattr(mtt.parallel, name)
    assert mtt.models.ShardedGBTClassifier is not None


def test_make_mesh_needs_a_process_group():
    """No process group started: the mesh raises, and never starts one or
    falls back to the CPU."""
    for device_type in ("cuda", "cpu"):
        with pytest.raises(RuntimeError, match="process group"):
            mtt.parallel.make_mesh(device_type=device_type)


@needs8
class TestShardedParity:
    @pytest.mark.parametrize("kind", KINDS)
    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_matches_single_device(self, port, kind, layout):
        got = port(layout, f"x-{kind}")
        assert_pair(got, jax_ess(layout, "x", kind=kind))
        assert_pair(got, in_core("x", kind=kind), **IN_CORE)

    def test_single_device_mesh_is_special_case(self, port):
        got = port((1, 1), "small-rank")
        assert_pair(got, jax_ess((1, 1), "small", kind="rank"))
        assert_pair(got, in_core("small", kind="rank"), **IN_CORE)

    def test_degenerate_nan_through_collectives(self, port):
        ess, rhat = port((8, 1), "const-basic")
        assert np.all(np.isnan(ess)) and np.all(np.isnan(rhat))

    @pytest.mark.parametrize("method", ["fft", "direct", "bda"])
    def test_autocov_methods(self, port, method):
        got = port((4, 2), f"methods-{method}")
        assert_pair(got, jax_ess((4, 2), "methods", kind="basic",
                                 autocov_method=method))
        assert_pair(got, in_core("methods", kind="basic",
                                 autocov_method=method), **IN_CORE)

    def test_split_chains_discard_rule(self, port):
        got = port((8, 1), "odd-split3")
        assert_pair(got, jax_ess((8, 1), "odd", kind="basic", split_chains=3))
        assert_pair(got, in_core("odd", kind="basic", split_chains=3),
                    **IN_CORE)


@needs8
class TestNestedSharded:
    @pytest.mark.parametrize("kind", KINDS)
    def test_matches_single_device(self, port, kind):
        got = port((4, 2), f"nested-{kind}")
        assert_close(got, jax_nested(X["nested"], IDS["nested"],
                                     _jax_mesh((4, 2)), kind=kind))
        assert_close(got, mtt.rhat_nested(t(X["nested"]), IDS["nested"],
                                          kind=kind), **IN_CORE)

    def test_uneven_superchains_rejected(self, port):
        err = port((2, 4), "raises:uneven")
        assert err is not None and err[0] == "ValueError"
        assert "superchains" in err[1]


@needs8
class TestRingRank:
    """Ring merge-count ranks == gather == single device, through ties, NaN
    poisoning and degenerate slices."""

    @pytest.mark.parametrize("kind", RANK_KINDS)
    def test_ring_matches_gather_and_single(self, port, kind):
        ring = port((8, 1), f"tied-{kind}-ring")
        gather = port((8, 1), f"tied-{kind}-gather")
        assert_pair(ring, gather, **RING_GATHER)
        assert_pair(ring, jax_ess((8, 1), "tied", kind=kind,
                                  rank_impl="gather"))
        assert_pair(ring, in_core("tied", kind=kind), **IN_CORE)

    def test_ring_2d_mesh_layout(self, port):
        got = port((4, 2), "tied8-ring")
        assert_pair(got, jax_ess((4, 2), "tied8", kind="rank",
                                 rank_impl="ring"))
        assert_pair(got, in_core("tied8", kind="rank"), **IN_CORE)

    def test_nan_column_stays_nan_not_neg_inf(self, port):
        for impl in ("gather", "ring"):
            _, rhat = port((8, 1), f"nan_col-{impl}")
            assert np.isnan(rhat[1]), impl
            assert np.all(np.isfinite(rhat[[0, 2]])), impl
            assert_close(rhat, in_core("nan_col", kind="tail").rhat,
                         **IN_CORE)

    @pytest.mark.parametrize("kind", ["rank", "tail"])
    def test_ring_degenerate_slice(self, port, kind):
        got = port((8, 1), f"degen-{kind}")
        assert_close(got[1], mdt.ess_rhat(X["degen"], kind=kind).rhat)
        assert_pair(got, in_core("degen", kind=kind), **IN_CORE)

    @pytest.mark.parametrize("kind", RANK_KINDS)
    def test_nested_ring(self, port, kind):
        got = port((8, 1), f"nested_ring-{kind}")
        x, ids = X["nested_ring"], IDS["nested_ring"]
        assert_close(got, mdt.rhat_nested(x, ids, kind=kind))
        assert_close(got, mtt.rhat_nested(t(x), ids, kind=kind), **IN_CORE)

    def test_auto_threshold_selects_ring(self):
        assert _resolve_rank_impl("auto", (100, 8, 4), 8, "rank") == "gather"
        big = (100_000, 64, 4)  # > 128 MB in float64
        assert _resolve_rank_impl("auto", big, 8, "rank") == "ring"
        assert _resolve_rank_impl("auto", big, 8, "basic") == "gather"
        assert _resolve_rank_impl("hist", big, 8, "rank") == "hist"
        with pytest.raises(ValueError):
            _resolve_rank_impl("bogus", (100, 8, 4), 8, "rank")


@needs8
@pytest.mark.slow
class TestShardedStressShape:
    """10k draws x 64 chains x 16 params over 8 ranks."""

    @pytest.mark.parametrize("impl", ["gather", "ring"])
    def test_stress_rank(self, tmp_path, impl):
        x = np.random.default_rng(SEED + 1).standard_normal((10_000, 64, 16))
        got = run_world(tmp_path, 8, (8, 1), [
            ("r", "parallel.ess_rhat_sharded", [x, MESH],
             dict(kind="rank", rank_impl=impl))])[0]["r"]
        assert_pair(got, mdt.ess_rhat(x, kind="rank"))
        assert_pair(got, mtt.ess_rhat(t(x), kind="rank"), rtol=1e-8)


@needs8
class TestHistRankImpl:
    """``rank_impl="hist"``: K3 on each rank, one all-reduce of the bin
    moments, K4 against the global CDF: the distributed ``rank_mode=
    "fast"``."""

    @pytest.mark.parametrize("kind", RANK_KINDS)
    def test_matches_single_device_fast(self, port, kind):
        got = port((4, 2), f"hist-{kind}")
        assert_pair(got, jax_ess((4, 2), "hist", kind=kind,
                                 rank_impl="hist"), **HIST)
        assert_pair(got, in_core("hist", kind=kind, rank_mode="fast"), **HIST)

    def test_tracks_exact_kind(self, port):
        ess, rhat = port((4, 2), "hist_exact")
        for want in (mdt.ess_rhat(X["hist_exact"], kind="rank"),
                     in_core("hist_exact", kind="rank")):
            assert_close(ess, want.ess, rtol=1e-3)
            assert_close(rhat, want.rhat, rtol=0, atol=1e-4)

    def test_nan_poisoning(self, port):
        ess, rhat = port((4, 2), "hist_nan")
        assert np.isnan(ess[2]) and np.isnan(rhat[2])
        assert np.all(np.isfinite(ess[[0, 1, 3]]))

    def test_discrete_ties_match_exact(self, port):
        # point masses are exact in the histogram transform
        ess, _ = port((4, 2), "hist_int")
        for want in (mdt.ess_rhat(X["hist_int"], kind="rank"),
                     in_core("hist_int", kind="rank")):
            assert_close(ess, want.ess, rtol=1e-9)

    def test_infinity_in_one_shard(self, port):
        """The column with an infinity takes the [0, 1] range on every rank,
        not only on the rank that holds it (kernel K2's per-call fallback
        is not used per shard)."""
        got = port((4, 2), "hist_inf")
        assert_pair(got, jax_ess((4, 2), "hist_inf", kind="rank",
                                 rank_impl="hist"), **HIST)
        assert_pair(got, in_core("hist_inf", kind="rank", rank_mode="fast"),
                    **HIST)

    @pytest.mark.parametrize("kind", RANK_KINDS)
    def test_nested_hist(self, port, kind):
        hist = port((4, 2), f"nested-hist-{kind}-hist")
        gather = port((4, 2), f"nested-hist-{kind}-gather")
        assert_close(hist, gather, rtol=0, atol=1e-5)
        assert_close(gather, mtt.rhat_nested(t(X["hist"]), IDS["nested"],
                                             kind=kind), **IN_CORE)
