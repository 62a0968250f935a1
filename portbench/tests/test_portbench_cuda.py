"""On the card: each cell at a test's size through the port's kernels, read
``correct``, with the launch rules of its mix met; and a run at a small size
of the traced path. Skips where there is no card."""

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
