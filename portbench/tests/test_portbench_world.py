"""A cell as a world of ranks on the host: gloo worlds of 2 and 4 processes,
started by the harness's own code (``portbench/world.py``) at a small size,
through a stand-in for the port's rank-local call (``mesh_port.py``).

Sound, a world reads ``correct`` with one result line and the same passes on
every rank; one rank's answer altered, or one rank's block left out, reads
not correct; a rank that raises ends the run with no result, soon, and so
does a module of the JAX side that any rank loads after the window. The
blocks the ranks make carry the configuration's profile over global chains,
and the references computed on rank 0 from the gathered blocks equal those
of the whole sample. A mix that does not name ``"mesh"`` never starts a
world.
"""

from __future__ import annotations

import copy
import json
import sys
import time

import numpy as np
import pytest
import torch

from portbench import forbidden, run, spec, traffic, world
from portbench.reference.nested import rhat_nested_rank
from portbench.sample import make_block, make_sample

from .conftest import small_config

BENCH = spec.load_benchmark()
PORT = "portbench.tests.mesh_port"
NESTED = "many_chains_c5.nested"


def mesh_mix(fn: str = "rhat_nested_local") -> dict:
    """The nested mix, each call through the stand-in with the mesh."""
    mix = copy.deepcopy(spec.mix(spec.cell(BENCH, NESTED)["traffic"]))
    call = mix["calls"][0]
    call.update(fn=fn, args=["sample", "superchain_ids", "mesh"], param_slice=2)
    return mix


def mesh_bench(chips: int) -> dict:
    """BENCHMARK.json with a world cell of the nested configuration."""
    bench = copy.deepcopy(BENCH)
    bench["workloads"].append({"name": "mesh.test", "config": "many_chains_c5",
                               "traffic": "mesh_test", "chips": chips,
                               "why": "a world at a test's size"})
    for m in bench["per_layer"]:
        if m["name"] in ("api.launches", "device.idle_pct"):
            m["workloads"].append("mesh.test")
    return bench


def _run(chips=2, fn="rhat_nested_local", traced=False, seed=2**31 + 7):
    bench = mesh_bench(chips)
    return world.run_world(
        bench, "mesh.test", seed=seed, seconds=0.3, traced=traced,
        device="cpu", port=PORT, t0=time.perf_counter(),
        config=small_config(BENCH, NESTED), mix=mesh_mix(fn),
        limits=spec.limits(NESTED))


@pytest.mark.parametrize("chips", [2, 4])
def test_sound_world_is_correct_with_one_result_line(chips, capfd):
    bench = mesh_bench(chips)
    code = world.main(bench, "mesh.test", seed=2**33 + 1, seconds=0.3,
                      traced=False, device="cpu", port=PORT,
                      t0=time.perf_counter(),
                      config=small_config(BENCH, NESTED), mix=mesh_mix(),
                      limits=spec.limits(NESTED))
    stdout, stderr = capfd.readouterr()
    assert code == 0, stderr[-3000:]
    lines = stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert list(out)[-1] == "checks"
    assert out["checks"]["ranks_agree"] == {"value": 0, "limit": 0}
    assert out["device"]["count"] == chips
    assert set(out["metrics"]) == {"diag_rate", "pass_p95_ms", "setup_s"}
    assert stderr.strip().splitlines()[-1].startswith("check ranks_agree: 0")


def test_traced_world_reads_rank_0s_trace():
    code, payload = _run(traced=True)
    assert code == 0
    out = payload["result"]
    assert out["correct"] and out["attempted"] == 10
    assert "busy_s" in out["device"] and "breakdown" in out
    assert payload["forbidden"] == []


@pytest.mark.parametrize("fn, reason", [
    ("rhat_nested_local_altered", "ranks_agree"),
    ("rhat_nested_local_missing_block", "rhat_abs"),
])
def test_a_fault_of_one_rank_is_not_correct(fn, reason):
    code, payload = _run(fn=fn)
    assert code == 0
    out = payload["result"]
    assert not out["correct"]
    assert out["failed"] == out["attempted"]
    c = out["checks"][reason]
    assert c["value"] > c["limit"]


def test_a_rank_that_raises_ends_the_world_soon(capfd):
    t = time.perf_counter()
    code = world.main(mesh_bench(2), "mesh.test", seed=5, seconds=0.3,
                      traced=False, device="cpu", port=PORT, t0=t,
                      config=small_config(BENCH, NESTED),
                      mix=mesh_mix("rhat_nested_local_raises"),
                      limits=spec.limits(NESTED))
    stdout, stderr = capfd.readouterr()
    assert code != 0
    assert stdout.strip() == ""
    assert "a rank of the world fails" in stderr
    assert time.perf_counter() - t < 60


def test_a_jax_module_loaded_after_the_window_on_any_rank_ends_the_run(capfd):
    code = world.main(mesh_bench(2), "mesh.test", seed=2**32 + 9, seconds=0.3,
                      traced=False, device="cpu", port=PORT,
                      t0=time.perf_counter(),
                      config=small_config(BENCH, NESTED),
                      mix=mesh_mix("rhat_nested_local_loads_jax"),
                      limits=spec.limits(NESTED))
    stdout, stderr = capfd.readouterr()
    assert code == 3, stderr[-3000:]
    assert stdout.strip() == ""
    assert "forbidden modules loaded in the world: ['jax']" in stderr


def reference_task(job, w):
    """A world's task: rank 0's references from the gathered blocks, and
    each rank's block, for the test below."""
    x = make_block(job["config"], job["seed"], w.rank, w.world, w.device)
    d, c, _ = x.shape  # blocks of one parameter: the gathering goes block by block
    refs = world.joined(x, w, world.reference_fns(job["mix"], job["config"]),
                        entries=d * c * w.world)
    blocks = world.gather(x.numpy().tolist(), w)
    if w.rank == 0:
        return {"refs": {n: {f: v.tolist() for f, v in r.items()}
                         for n, r in refs.items()}, "blocks": blocks}
    return None


def test_the_reference_of_gathered_blocks_is_the_whole_samples():
    cfg = small_config(BENCH, NESTED)
    job = world.job_for(mesh_bench(4), "mesh.test", device="cpu", port=PORT,
                        config=cfg, mix=mesh_mix(), limits={}, seed=11)
    code, payload = world.spawn(
        job, "portbench.tests.test_portbench_world:reference_task")
    assert code == 0
    whole = torch.cat([torch.tensor(b) for b in payload["blocks"]], dim=1)
    assert whole.shape == (cfg["draws"], cfg["chains"], cfg["params"])
    got = payload["refs"]["nested.rhat_nested_rank"]["rhat"]
    assert got == rhat_nested_rank(whole, cfg)["rhat"].tolist()


def test_blocks_carry_the_profile_over_global_chains():
    cfg = copy.deepcopy(spec.config(BENCH, "many_chains_c5"))
    cfg.update(draws=400, chains=2500, params=3)  # four chips' share
    blocks = [make_block(cfg, 2**40 + 3, r, 4, "cpu") for r in range(4)]
    x = torch.cat(blocks, dim=1).double()
    assert x.shape == (400, 2500, 3)
    mean = x.mean(0)  # (chains, params)
    # the offset of parameter 0 on global chains 0-24 only
    assert (mean[:25, 0] > 3).all() and (mean[25:, 0].abs() < 1).all()
    assert (mean[:, 1:].abs() < 1).all()
    # phi by parameter, over every rank's chains
    phi = np.linspace(*cfg["profile"]["phi"], 3)
    for r in range(4):
        b = blocks[r].double()
        b = b - b.mean(0)
        lag1 = (b[1:] * b[:-1]).sum((0, 1)) / (b * b).sum((0, 1))
        assert np.allclose(lag1[1:].numpy(), phi[1:], atol=0.03), r
    # the ranks' noise differs; a world of one makes make_sample's sample
    assert not torch.equal(blocks[0][:, :10], blocks[1][:, :10])
    small = small_config(BENCH, NESTED)
    assert torch.equal(make_block(small, 9, 0, 1, "cpu"),
                       make_sample(small, 9, "cpu"))


def test_a_mix_without_mesh_takes_the_one_process_path(monkeypatch):
    for w in BENCH["workloads"]:
        assert not traffic.names_mesh(spec.mix(w["traffic"]))
    assert traffic.names_mesh(mesh_mix())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(forbidden, "loaded", lambda: [])
    import portbench

    monkeypatch.delitem(sys.modules, "portbench.world")
    monkeypatch.delattr(portbench, "world")
    taken = []
    monkeypatch.setattr(run, "run_cell", lambda *a, **kw: taken.append("one") or
                        {"checks": {}})
    assert run.main(["--workload", "batched_c4.exact", "--seed", "1",
                     "--seconds", "1"]) == 0
    assert taken == ["one"] and "portbench.world" not in sys.modules
    # a cell whose mix names the mesh goes to the world
    mix = mesh_mix()
    monkeypatch.setattr(spec, "mix", lambda name: mix)
    monkeypatch.setitem(sys.modules, "portbench.world", world)
    monkeypatch.setattr(world, "main", lambda *a, **kw: taken.append("world") or 0)
    assert run.main(["--workload", "batched_c4.exact", "--seed", "1",
                     "--seconds", "1"]) == 0
    assert taken == ["one", "world"]


def test_calibration_reads_the_program_and_the_control_through_the_world():
    code, lines = world.calibrate(
        mesh_bench(2), "mesh.test", seeds=[21], control_seeds=[21], passes=1,
        device="cpu", port=PORT, config=small_config(BENCH, NESTED),
        mix=mesh_mix(), limits={})
    assert code == 0
    program, control = lines
    limit = spec.limits(NESTED)["rhat_abs"]["limit"]
    assert program["kind"] == "program" and program["ranks_agree"] == 0
    assert program["gaps"]["rhat_abs"] < limit < control["gaps"]["rhat_abs"]
    assert len(program["launches_a_pass"]) == 2
