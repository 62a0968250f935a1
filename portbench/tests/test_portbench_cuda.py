"""On the card: each cell at a test's size through the port's kernels, read
``correct``, with the launch rules of its mix met; and a run at a small size
of the traced path. A world of one rank over NCCL through the mesh path
(``portbench/world.py``, the stand-in ``mesh_port.py``), and of four where
four cards are present; and, in worlds of two and four cards, NCCL's
kernels, on NCCL's own stream, paired by correlation id with the calls that
launched them on every rank. Skips where there is no card, or too few."""

from __future__ import annotations

import time

import pytest

from portbench import run, spec

from .conftest import small_config

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_cell_on_the_card(card, cell, traced):
    import mcmcdiagnostictools_jl_tpu_torch as mtt

    cfg = small_config(BENCH, cell)
    out = run.run_cell(BENCH, cell, seed=2**31 + 3, seconds=0.5, traced=traced,
                       device=card, port=mtt, t0=time.perf_counter(), config=cfg)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    launch_checks = [k for k in out["checks"] if k.startswith("K")]
    assert launch_checks
    if traced:
        assert out["device"]["busy_s"] > 0
        assert out["metrics"]


def _world(card, chips, traced):
    from .test_portbench_world import NESTED, PORT, mesh_bench, mesh_mix

    import torch

    if torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA devices")
    from portbench import world

    mix = mesh_mix()
    mix["launches"] = {"each_call": ["K13", "K12"], "never": ["K1", "K3", "K4"]}
    return world.run_world(
        mesh_bench(chips), "mesh.test", seed=2**31 + 5, seconds=0.5,
        traced=traced, device=card, port=PORT, t0=time.perf_counter(),
        config=small_config(BENCH, NESTED), mix=mix, limits=spec.limits(NESTED))


@pytest.mark.cuda
@pytest.mark.parametrize("chips", [1, 4])
@pytest.mark.parametrize("traced", [False, True])
def test_a_world_over_nccl(card, chips, traced):
    code, payload = _world(card, chips, traced)
    assert code == 0
    out = payload["result"]
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == chips and out["device"]["platform"] == "gpu"
    assert out["checks"]["ranks_agree"]["value"] == 0
    assert out["checks"]["K13_least_a_pass"]["value"] >= 2
    if traced:
        assert out["device"]["busy_s"] > 0 and out["metrics"]["api.launches"]["value"] > 0


def nccl_pairing_task(job, w):
    """A world's task: each rank traces passes of the stand-in inside an
    ``mdt.`` region; rank 0 gets, rank by rank, its NCCL kernels, whether
    every device operation found its launch by id, and the NCCL kernels
    given to no region or another."""
    import torch

    from portbench import spans, trace, traffic, world
    from portbench.sample import make_block

    cfg = job["config"]
    x = make_block(cfg, job["seed"], w.rank, w.world, w.device)
    one_pass = traffic.build_pass(job["mix"], cfg, x, w.port, mesh=w.mesh)
    one_pass()

    def region():
        with torch.profiler.record_function("mdt.rhat_nested"):
            return one_pass()

    tr, _ = trace.run_traced(region)
    nccl = [name for name, _, _ in tr.device if "nccl" in name.lower()]
    ops = spans.attributed(tr) or []
    astray = sum(o[0] != "mdt.rhat_nested"
                 for o, (name, _, _) in zip(ops, tr.device)
                 if "nccl" in name.lower())
    return world.gather({"nccl": len(nccl), "astray": astray,
                         "paired": spans.launch_times(tr) is not None}, w)


@pytest.mark.cuda
@pytest.mark.parametrize("chips", [2, 4])
def test_nccl_kernels_pair_by_correlation_id(card, chips):
    """A traced world of ``chips`` cards: on every rank, NCCL launches
    kernels on its own stream, every device operation finds its launch by
    correlation id, and each NCCL kernel falls in the region it was
    launched in."""
    import torch

    from portbench import world

    from .test_portbench_world import NESTED, PORT, mesh_bench, mesh_mix

    if torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA devices")
    job = world.job_for(mesh_bench(chips), "mesh.test", device=card, port=PORT,
                        config=small_config(BENCH, NESTED), mix=mesh_mix(),
                        limits={}, seed=2**31 + 9)
    code, ranks = world.spawn(
        job, "portbench.tests.test_portbench_cuda:nccl_pairing_task")
    assert code == 0
    assert len(ranks) == chips
    for r in ranks:
        assert r["nccl"] > 0 and r["paired"] and r["astray"] == 0, ranks
