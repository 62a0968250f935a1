"""The port's profiling hooks (``utils/profiling.py``) on the CPU: ``trace``
writes a TensorBoard trace of its block into the directory it is given, an
``annotate`` region shows up by name among the profiler's events and costs
a shared no-op while no profiler runs, the diagnostics open their layer
regions (``mdt.*``) in order and unnested, a collective closes the layer
regions open around it, and ``host_sync`` counts each pass through a
host-sync site."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import mcmcdiagnostictools_jl_tpu_torch as mtt
from mcmcdiagnostictools_jl_tpu_torch.utils import profiling

CALLS = ("mdt.ess_rhat", "mdt.ess", "mdt.rhat", "mdt.rhat_nested")
LAYERS = ("mdt.rank.exact", "mdt.rank.fast", "mdt.moments", "mdt.geyer",
          "mdt.nested", "mdt.rank.ring", "mdt.comm")


def _sample(draws=400, chains=4, params=3):
    return torch.randn((draws, chains, params), dtype=torch.float64,
                       generator=torch.Generator().manual_seed(0))


IDS = np.repeat(np.arange(2), 2)  # two superchains of two chains

CASES = {
    # 400 draws: split chains of 200, maxlag 196, so the 64-lag probe runs
    "exact": lambda x: mtt.ess_rhat(x, kind="rank"),
    "fast": lambda x: mtt.ess_rhat(x, kind="rank", rank_mode="fast"),
    "nested": lambda x: mtt.rhat_nested(x, IDS),
    "ess_bulk": lambda x: mtt.ess(x, kind="bulk"),
    "rhat_tail": lambda x: mtt.rhat(x, kind="tail"),
}

# (region, its innermost enclosing mdt. region), in the order they open
TREES = {
    "exact": [("mdt.ess_rhat", None),
              ("mdt.rank.exact", "mdt.ess_rhat"),
              ("mdt.sync.quantile_offset", "mdt.rank.exact"),
              ("mdt.moments", "mdt.ess_rhat"),
              ("mdt.sync.geyer_probe", "mdt.moments"),
              ("mdt.geyer", "mdt.ess_rhat")],
    "fast": [("mdt.ess_rhat", None),
             ("mdt.rank.fast", "mdt.ess_rhat"),
             ("mdt.sync.hist_rank", "mdt.rank.fast"),
             ("mdt.moments", "mdt.ess_rhat"),
             ("mdt.sync.geyer_probe", "mdt.moments"),
             ("mdt.geyer", "mdt.ess_rhat")],
    "nested": [("mdt.rhat_nested", None),
               ("mdt.sync.superchain_ids", "mdt.rhat_nested"),
               ("mdt.rank.exact", "mdt.rhat_nested"),
               ("mdt.nested", "mdt.rhat_nested"),
               ("mdt.rank.exact", "mdt.rhat_nested"),
               ("mdt.sync.quantile_offset", "mdt.rank.exact"),
               ("mdt.nested", "mdt.rhat_nested")],
    "ess_bulk": [("mdt.ess", None),
                 ("mdt.rank.exact", "mdt.ess"),
                 ("mdt.moments", "mdt.ess"),
                 ("mdt.sync.geyer_probe", "mdt.moments"),
                 ("mdt.geyer", "mdt.ess")],
    "rhat_tail": [("mdt.rhat", None),
                  ("mdt.rank.exact", "mdt.rhat"),
                  ("mdt.sync.quantile_offset", "mdt.rank.exact")],
}


def _regions(fn):
    """Each ``mdt.`` region the call opened, in order: ``(name, the names
    of its enclosing mdt. regions, innermost first)``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = []
    events = [e for e in prof.events() if e.name.startswith("mdt.")]
    for e in sorted(events, key=lambda e: e.time_range.start):
        above, p = [], e.cpu_parent
        while p is not None:
            if p.name.startswith("mdt."):
                above.append(p.name)
            p = p.cpu_parent
        out.append((e.name, above))
    return out


def test_trace_writes_a_file_and_annotate_names_a_region(tmp_path):
    x = torch.randn((200, 4, 3), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("mdt.test_region"):
            mtt.ess_rhat(x)
    names = {e.name for e in prof.events()}
    assert "mdt.test_region" in names
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "mdt.test_region" for e in events)


def test_hooks_are_the_utils_names():
    assert mtt.utils.trace is profiling.trace
    assert mtt.utils.annotate is profiling.annotate
    assert mtt.utils.host_sync is profiling.host_sync
    assert mtt.utils.sync_counts is profiling.sync_counts
    assert mtt.utils.reset_sync_counts is profiling.reset_sync_counts
    assert mtt.utils.comm_counts is profiling.comm_counts
    assert mtt.utils.reset_comm_counts is profiling.reset_comm_counts


@pytest.mark.parametrize("case", sorted(TREES))
def test_region_tree(case):
    got = _regions(lambda: CASES[case](_sample()))
    assert [(name, above[0] if above else None) for name, above in got] \
        == TREES[case]


@pytest.mark.parametrize("case", sorted(TREES))
def test_layer_regions_sit_in_the_call_and_not_in_each_other(case):
    for name, above in _regions(lambda: CASES[case](_sample())):
        if name in CALLS:
            assert above == []
            continue
        assert above and above[-1] in CALLS, name
        if name in LAYERS:
            assert not set(above) & set(LAYERS), (name, above)


def _sharded_regions(tmp_path):
    """Rank 0's regions of ``parallel.rhat_nested_local`` on a gloo world of
    two chain shards, by route."""
    from torch_dist import MESH, run_world

    x = _sample(200, 8, 3).float().numpy()
    ids = np.repeat(np.arange(4), 2)
    calls = [(impl, "regions_of", ["parallel.rhat_nested_local", x, ids, MESH],
              dict(rank_impl=impl)) for impl in ("ring", "gather")]
    return run_world(tmp_path, 2, (2, 1), calls)[0]


def test_sharded_layer_regions_sit_in_the_call_and_not_in_each_other(
        tmp_path):
    """On a mesh the layer regions close before each collective, which
    opens ``mdt.comm``, and open again after it: every region of the call
    sits in ``mdt.rhat_nested`` and in no layer region. The ring route
    opens ``mdt.rank.ring`` (sorts, merge-counts, Blom, fold), ``mdt.comm``
    (three exchanges a ring pass in a world of two: one) and ``mdt.nested``;
    the gather route ``mdt.rank.exact`` in place of the ring."""
    got = _sharded_regions(tmp_path)
    for impl, regions in got.items():
        names = {name for name, _ in regions
                 if not name.startswith("mdt.sync.")}
        assert regions[0] == ("mdt.rhat_nested", ()), impl
        for name, above in regions[1:]:
            assert above and above[-1] == "mdt.rhat_nested", (impl, name)
            if name.startswith("mdt.sync."):  # a host wait, in a layer or not
                continue
            assert name in LAYERS, (impl, name)
            assert not set(above) & set(LAYERS), (impl, name, above)
        rank = "mdt.rank.ring" if impl == "ring" else "mdt.rank.exact"
        assert names == {"mdt.rhat_nested", rank, "mdt.comm", "mdt.nested"}


@pytest.mark.parametrize("case, draws, counts", [
    ("exact", 400, {"geyer_probe": 1, "quantile_offset": 1}),
    ("fast", 400, {"geyer_probe": 1, "hist_rank": 1}),
    ("nested", 400, {"superchain_ids": 1, "quantile_offset": 1}),
    # 100 draws: maxlag 46 < 128, no probe
    ("exact", 100, {"quantile_offset": 1}),
    ("fast", 100, {"hist_rank": 1}),
])
def test_sync_counts_a_call(case, draws, counts):
    x = _sample(draws)
    profiling.reset_sync_counts()
    assert profiling.sync_counts() == {}
    CASES[case](x)
    assert profiling.sync_counts() == counts
    CASES[case](x)  # counted with no profiler running, and summed
    assert profiling.sync_counts() == {k: 2 * v for k, v in counts.items()}
    profiling.reset_sync_counts()
    assert profiling.sync_counts() == {}


def test_annotate_is_a_shared_no_op_without_a_profiler():
    a, b = profiling.annotate("mdt.a"), profiling.annotate("mdt.b")
    assert a is b
    with a:
        with b:  # reentrant
            pass
    with profile(activities=[ProfilerActivity.CPU]):
        inside = profiling.annotate("mdt.a")
    assert inside is not a
    assert isinstance(inside, torch.profiler.record_function)
    assert profiling.annotate("mdt.a") is a


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo process group of this process alone."""
    import torch.distributed as dist

    dist.init_process_group("gloo", world_size=1, rank=0,
                            store=dist.FileStore(str(tmp_path / "store"), 1))
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_comm_closes_the_layer_regions_around_a_collective(world_of_one):
    """A layer region open across ``comm.all_reduce`` shows as two
    instances, ``mdt.comm`` between them and in neither, all three in the
    call's region; after the block no region is left open."""
    from mcmcdiagnostictools_jl_tpu_torch.parallel import comm

    def call():
        with profiling.annotate("mdt.rhat_nested"):
            with profiling.annotate("mdt.nested"):
                t = torch.ones(3) * 2
                comm.all_reduce(t, world_of_one)
                return t + 1

    assert call().tolist() == [3.0, 3.0, 3.0]  # no profiler running
    got = _regions(call)
    assert [(name, above) for name, above in got] == [
        ("mdt.rhat_nested", []),
        ("mdt.nested", ["mdt.rhat_nested"]),
        ("mdt.comm", ["mdt.rhat_nested"]),
        ("mdt.nested", ["mdt.rhat_nested"])]
    assert profiling._OPEN == []
    a, b = profiling.annotate("mdt.nested"), profiling.comm_region()
    assert a is b  # the shared no-op, with no profiler


def test_host_sync_counts_without_a_profiler():
    profiling.reset_sync_counts()
    for _ in range(3):
        with profiling.host_sync("site"):
            pass
    assert profiling.sync_counts() == {"site": 3}
    counts = profiling.sync_counts()
    counts["site"] = 0  # a copy
    assert profiling.sync_counts() == {"site": 3}
    profiling.reset_sync_counts()
