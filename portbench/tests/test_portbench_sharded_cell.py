"""The four-card cell ``many_chains_c5x4.sharded``: its parts found by name,
and the cell itself at a test's size through the port's rank-local entry
(``parallel.rhat_nested_local``), as a world of ranks (``world.py``).

On the host, gloo worlds: the cell reads ``correct`` with the same answers
on every rank and ``comm.gb_a_pass`` the bytes counted by hand; its limit
sits between the port's float32 and the control (the reference in
bfloat16); a fault planted in one rank's call reads not correct. At a
test's size ``"auto"`` takes the gather route and the cell's size the ring,
so the mix asks for the ring here. On four cards (``cuda`` marker): the
same over NCCL, with the launch rules and the metrics of the port's
regions and counter read, and every NCCL kernel the port launches given to
its ``mdt.comm`` region by correlation id.
"""

from __future__ import annotations

import copy
import time

import pytest

from portbench import spec, traffic, world

from .conftest import small_config
from .test_portbench_world import PORT, mesh_bench

BENCH = spec.load_benchmark()
SHARDED = "many_chains_c5x4.sharded"
REAL_PORT = "mcmcdiagnostictools_jl_tpu_torch"


def ring_mix() -> dict:
    """The sharded cell's mix with the ring route asked for."""
    mix = copy.deepcopy(spec.mix(spec.cell(BENCH, SHARDED)["traffic"]))
    mix["calls"][0]["kwargs"]["rank_impl"] = "ring"
    return mix


def test_parts_found_by_name():
    w = spec.cell(BENCH, SHARDED)
    assert w["chips"] == 4 and len(w["why"]) <= 200
    cfg = spec.config(BENCH, w["config"])
    mix = spec.mix(w["traffic"])
    assert traffic.names_mesh(mix)
    assert {c["name"] for c in mix["checks"]} == set(spec.limits(SHARDED))
    assert callable(spec.reference(mix["control"]))
    assert cfg["draws"] * cfg["chains"] * cfg["params"] * 4 == cfg["bytes"]
    # 25 whole superchains on each card
    assert cfg["chains"] % (4 * (cfg["chains"] // cfg["superchains"])) == 0
    # a quarter of the cells, rounded down, or one, may take four cards
    four = [c["name"] for c in BENCH["workloads"] if c["chips"] == 4]
    assert four == [SHARDED]
    for name in ("span.ring.device_ms", "span.comm.device_ms",
                 "comm.gb_a_pass", "k13_rank_roofline"):
        assert callable(spec.metric_reader(name).read)


def test_k13_rank_roofline_counts_one_ranks_rows(monkeypatch):
    """K13's bytes on one rank's block: a world of four sorts a quarter of
    the global entries a rank, so the share reads a quarter of what the
    global count (``k13_roofline``) gives; outside a world, nothing."""
    from .test_portbench_metrics import _trace, ctx

    reader = spec.metric_reader("k13_rank_roofline")
    cfg = {"draws": 10_000, "chains": 128, "params": 1000}
    c = ctx(trace=_trace(), passes=2, config=cfg, calls_a_pass=8)
    assert reader.read(c) is None

    class World:
        @staticmethod
        def is_available():
            return True

        @staticmethod
        def is_initialized():
            return True

        @staticmethod
        def get_world_size():
            return 4

    monkeypatch.setattr(reader, "dist", World)
    # one sort with positions of 1.28e9 / 8 / 4 entries in 30 us of K13
    assert reader.read(c) == pytest.approx(
        100 * 16 * 1.28e9 / 32 / 3.35e12 / 30e-6)
    assert reader.read(c) == pytest.approx(
        spec.metric_reader("k13_roofline").read(c) / 4)
    assert reader.read(ctx(trace=_trace(), passes=2, config=cfg,
                           device_kind="cpu")) is None


def test_the_cell_runs_the_ports_rank_local_entry():
    """The cell at a small size on a gloo world of four: correct, the same
    answers on every rank, and ``comm.gb_a_pass`` the bytes counted by
    hand. A pass is one call of 4 parameters (``param_slice`` 50) over
    blocks of 100 draws x 100 chains a rank: six exchanges of the float32
    block ``(4, 10,000)`` sent and received (three a ring pass, the bulk's
    and the fold's), and eight all-reduces of 4 or 8 values, each moving
    2 (k - 1) / k of its bytes each way; the parameter group's all-gather
    holds one rank and moves nothing. ``api.host_syncs`` reads one a call,
    the median's interpolation weight to the device (the chains are in
    superchain order, so no permutation goes there)."""
    cfg = small_config(BENCH, SHARDED)
    assert (cfg["draws"], cfg["chains"], cfg["params"]) == (100, 400, 4)
    code, payload = world.run_world(
        BENCH, SHARDED, seed=2**31 + 11, seconds=0.3, traced=True,
        device="cpu", port=REAL_PORT, t0=time.perf_counter(), config=cfg,
        mix=ring_mix(), limits=spec.limits(SHARDED))
    assert code == 0
    out = payload["result"]
    assert out["correct"], out["checks"]
    assert out["checks"]["ranks_agree"] == {"value": 0, "limit": 0}
    assert out["device"]["count"] == 4
    exchanges = 6 * 2 * 4 * 100 * 100 * 4
    reduces = 2 * 3 * 4 * (4 + 8 + 8 + 8 + 4 + 8 + 8 + 4) // 4
    # on the host no device operation is traced: the counters alone read
    assert out["metrics"] == {
        "comm.gb_a_pass": {
            "value": pytest.approx((exchanges + 2 * reduces) / 1e9,
                                   rel=1e-12),
            "unit": "GB"},
        "api.host_syncs": {"value": 1.0, "unit": "syncs"}}


def test_the_control_reads_wider_than_the_program():
    """The cell's limit at a test's size, read through a world of four as
    its calibration reads it: the port's float32 within it on two seeds,
    the control past it."""
    code, lines = world.calibrate(
        BENCH, SHARDED, seeds=[23, 2**31 + 29], control_seeds=[23, 2**31 + 29],
        passes=1, device="cpu", port=REAL_PORT,
        config=small_config(BENCH, SHARDED), mix=ring_mix(), limits={})
    assert code == 0
    limit = spec.limits(SHARDED)["rhat_abs"]["limit"]
    program = [ln for ln in lines if ln["kind"] == "program"]
    control = [ln for ln in lines if ln["kind"] == "control"]
    assert len(program) == len(control) == 2
    for ln in program:
        assert ln["ranks_agree"] == 0 and ln["gaps"]["rhat_abs"] < limit, ln
    for ln in control:
        assert ln["gaps"]["rhat_abs"] > limit, ln


@pytest.mark.parametrize("fn, reason", [
    ("rhat_nested_local_altered", "ranks_agree"),
    ("rhat_nested_local_missing_block", "rhat_abs"),
])
def test_a_fault_of_one_rank_is_not_correct(fn, reason):
    """The cell's mix, configuration and limits with a fault planted in one
    rank's call (``mesh_port.py``), on a world of two."""
    mix = ring_mix()
    mix["calls"][0]["fn"] = fn
    code, payload = world.run_world(
        mesh_bench(2), "mesh.test", seed=2**31 + 17, seconds=0.3,
        traced=False, device="cpu", port=PORT, t0=time.perf_counter(),
        config=small_config(BENCH, SHARDED), mix=mix,
        limits=spec.limits(SHARDED))
    assert code == 0
    out = payload["result"]
    assert not out["correct"] and out["failed"] == out["attempted"]
    c = out["checks"][reason]
    assert c["value"] > c["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("traced", [False, True])
def test_the_cell_on_four_cards(card, traced):
    """The cell at a test's size over NCCL: correct, with its launch rules;
    traced, the metrics of the port's regions and counter read."""
    import torch

    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    code, payload = world.run_world(
        BENCH, SHARDED, seed=2**31 + 13, seconds=0.5, traced=traced,
        device=card, port=REAL_PORT, t0=time.perf_counter(),
        config=small_config(BENCH, SHARDED), mix=ring_mix(),
        limits=spec.limits(SHARDED))
    assert code == 0
    out = payload["result"]
    assert out["correct"], out["checks"]
    assert out["checks"]["ranks_agree"]["value"] == 0
    assert out["checks"]["K11_least_a_pass"]["value"] >= 2
    if traced:
        for name in ("span.ring.device_ms", "span.comm.device_ms",
                     "comm.gb_a_pass", "span.nested.device_ms",
                     "k13_rank_roofline", "api.host_syncs"):
            assert out["metrics"][name]["value"] > 0, name


def comm_region_task(job, w):
    """A world's task: each rank traces passes of the cell's mix; rank 0
    gets, rank by rank, its NCCL kernels and those given to another region
    than the port's ``mdt.comm``."""
    from portbench import spans, trace
    from portbench.sample import make_block

    cfg = job["config"]
    x = make_block(cfg, job["seed"], w.rank, w.world, w.device)
    one_pass = traffic.build_pass(job["mix"], cfg, x, w.port, mesh=w.mesh)
    one_pass()
    tr, _ = trace.run_traced(one_pass)
    ops = spans.attributed(tr) or []
    nccl = [o[0] for o, (name, _, _) in zip(ops, tr.device)
            if "nccl" in name.lower()]
    return world.gather({"nccl": len(nccl),
                         "astray": sum(r != "mdt.comm" for r in nccl),
                         "paired": spans.launch_times(tr) is not None}, w)


@pytest.mark.cuda
def test_the_ports_nccl_kernels_fall_in_its_comm_region(card):
    import torch

    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    job = world.job_for(BENCH, SHARDED, device=card, port=REAL_PORT,
                        config=small_config(BENCH, SHARDED), mix=ring_mix(),
                        limits={}, seed=2**31 + 19)
    code, ranks = world.spawn(
        job, "portbench.tests.test_portbench_sharded_cell:comm_region_task")
    assert code == 0 and len(ranks) == 4
    for r in ranks:
        assert r["nccl"] > 0 and r["paired"] and r["astray"] == 0, ranks
