"""The plain references against the frozen float64 oracle, one parameter at a
time, at small sizes on the host; the fast-mode reference against the port's
own fast mode in float64; and the control (bfloat16) reads wider than the
port does in float32."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import check, spec
from portbench.reference import common, exact, fast, nested, oracle
from portbench.sample import make_sample

from .conftest import small_config

BENCH = spec.load_benchmark()


def _sample(seed, shape=(300, 8, 5), phi=0.6, ties=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    for t in range(1, shape[0]):
        x[t] += phi * x[t - 1]
    x[:, :2, 0] += 3.0
    if ties and shape[2] > 3:
        x[:, :, 3] = np.round(x[:, :, 3] * 4) / 4
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", [(300, 8, 5), (101, 3, 4), (40, 6, 2)])
def test_exact_against_the_oracle(seed, shape):
    x = _sample(seed, shape)
    got = exact.ess_rhat_rank(torch.from_numpy(x), {})
    e, r = oracle.ess_rhat(x, "rank")
    np.testing.assert_allclose(got["ess"], e, rtol=1e-10)
    np.testing.assert_allclose(got["rhat"], r, rtol=0, atol=1e-12)


@pytest.mark.parametrize("maxlag", [1, 2, 3, 7, 250])
def test_geyer_at_every_lag_cap(maxlag):
    x = _sample(5, (60, 4, 3), ties=False)
    e, r = common.ess_rhat_basic(torch.from_numpy(x), maxlag)
    ee, rr = oracle.ess_rhat_basic(x, maxlag=maxlag)
    np.testing.assert_allclose(e.numpy(), ee, rtol=1e-10)
    np.testing.assert_allclose(r.numpy(), rr, atol=1e-12)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("nsuper, chains", [(4, 8), (2, 6), (3, 3)])
def test_nested_against_the_oracle(seed, nsuper, chains):
    x = _sample(seed, (50, chains, 4))
    ids = np.arange(chains) // (chains // nsuper)
    got = nested.rhat_nested_rank(torch.from_numpy(x), {"superchains": nsuper})
    np.testing.assert_allclose(got["rhat"], oracle.rhat_nested(x, ids),
                               atol=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fast_against_the_ports_fast_mode_in_float64(seed):
    import mcmcdiagnostictools_jl_tpu_torch as mtt

    x = torch.from_numpy(_sample(seed))
    got = fast.ess_rhat_rank(x, {})
    port = mtt.ess_rhat(x, kind="rank", rank_mode="fast")
    np.testing.assert_allclose(got["ess"], port.ess.numpy(), rtol=1e-7)
    np.testing.assert_allclose(got["rhat"], port.rhat.numpy(), atol=1e-8)


def test_blocks_do_not_change_the_answer(monkeypatch):
    x = torch.from_numpy(_sample(3, (200, 6, 7)))
    whole = exact.ess_rhat_rank(x, {})
    monkeypatch.setattr(common, "BLOCK_ENTRIES", 2 * 200 * 6)
    assert len(common.param_blocks(7, 1200)) == 4
    blocked = exact.ess_rhat_rank(x, {})
    np.testing.assert_allclose(blocked["ess"], whole["ess"], rtol=1e-12)
    np.testing.assert_allclose(blocked["rhat"], whole["rhat"], atol=1e-14)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("seed", [11, 2**31 + 7, 3 * 2**31 + 5])
def test_control_reads_wider_than_the_program(cell, seed):
    """The control, the mix's reference with every stored intermediate in
    bfloat16, fails the cell's limits at a test's size on the host, where
    the port's float32 passes them."""
    import mcmcdiagnostictools_jl_tpu_torch as mtt
    from portbench import traffic

    w = spec.cell(BENCH, cell)
    cfg, mix, limits = small_config(BENCH, cell), spec.mix(w["traffic"]), spec.limits(cell)
    x = make_sample(cfg, seed, "cpu")
    refs = check.references(mix, x, cfg)
    prog = check.gaps_of_pass(mix, traffic.build_pass(mix, cfg, x, mtt)(), refs)
    ctl = check.gaps_of_pass(
        mix, spec.reference(mix["control"])(x, cfg, lowp=torch.bfloat16), refs)
    assert all(v <= limits[k]["limit"] for k, v in prog.items()), prog
    assert any(v > limits[k]["limit"] for k, v in ctl.items()), ctl
