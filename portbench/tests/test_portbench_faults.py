"""A whole run of each cell at a test's size on the host, past the harness's
look for a card: sound, it reads ``correct``; with the timed path broken
underneath it does not. The faults a cell can have: half the chains left out
(the statistics taken over the rest), one answer altered where it is
produced, and the control (the reference in bfloat16) in the program's
place."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

import mcmcdiagnostictools_jl_tpu_torch as mtt
from portbench import run, spec

from .conftest import small_config

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _run(cell, monkeypatch=None, fault=None, traced=False, seed=2**31 + 99):
    fn_name = spec.mix(spec.cell(BENCH, cell)["traffic"])["calls"][0]["fn"]
    if fault is not None:
        monkeypatch.setattr(mtt, fn_name, fault(getattr(mtt, fn_name), cell))
    return run.run_cell(BENCH, cell, seed=seed, seconds=0.2, traced=traced,
                        device="cpu", port=mtt, t0=time.perf_counter(),
                        config=small_config(BENCH, cell))


def half_the_chains(fn, cell):
    def broken(x, *args, **kw):
        args = [np.asarray(a)[::2] for a in args]  # the superchain ids too
        return fn(x[:, ::2], *args, **kw)
    return broken


def one_answer_altered(fn, cell):
    def broken(*args, **kw):
        res = fn(*args, **kw)
        if isinstance(res, torch.Tensor):
            res = res.clone()
            res[1] += 1e-2
            return res
        ess, rhat = res.ess.clone(), res.rhat
        ess[1] *= 1.01
        return type(res)(ess, rhat)
    return broken


def control_in_place(fn, cell):
    mix = spec.mix(spec.cell(BENCH, cell)["traffic"])
    ref = spec.reference(mix["control"])
    cfg = small_config(BENCH, cell)

    def broken(x, *args, **kw):
        out = ref(x, cfg, lowp=torch.bfloat16)
        vals = [torch.from_numpy(out[k]) for k in mix["calls"][0]["outputs"]]
        return vals[0] if len(vals) == 1 else tuple(vals)
    return broken


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_sound_run_is_correct(cell, traced):
    out = _run(cell, traced=traced)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    assert set(out) >= {"correct", "attempted", "failed", "metrics", "device"}
    if traced:
        assert "breakdown" in out and "busy_s" in out["device"]
    else:
        assert set(out["metrics"]) == {"diag_rate", "pass_p95_ms", "setup_s"}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [half_the_chains, one_answer_altered,
                                   control_in_place])
def test_broken_path_is_not_correct(cell, fault, monkeypatch):
    out = _run(cell, monkeypatch, fault)
    assert not out["correct"]
    assert out["failed"] == out["attempted"]


MIX = {"checks": [], "launches": {"each_call": ["K13"], "never": ["K3"]}}


@pytest.mark.parametrize("per_pass, calls, correct", [
    ([{"K13": 1}, {"K13": 1}], 1, True),
    # one pass of three skipped the sort: its average would still be 2 / 3
    # of a launch, and 3 passes' total 2, which no average of >= 1 catches
    ([{"K13": 1}, {"K13": 0}, {"K13": 1}], 1, False),
    # a pass of 8 calls (parameter slices) with fewer launches than calls
    ([{"K13": 24}, {"K13": 7}], 8, False),
    ([{"K13": 24}, {"K13": 24}], 8, True),
    ([{"K13": 1, "K3": 1}, {"K13": 1}], 1, False),
])
def test_launch_rules_hold_in_every_pass(per_pass, calls, correct):
    from portbench import check

    results = [{} for _ in per_pass]
    ok, failed, checks = check.judge(MIX, {}, results, {}, per_pass, calls)
    assert ok is correct and failed == 0
    assert checks["K13_least_a_pass"]["limit"] == calls
