"""The metric arithmetic on synthetic readings: the rate over the whole
window, the tail over every pass, the idle union, the breakdown, and the
roofline counts of K13 and K1 against counts made by hand."""

from __future__ import annotations

import pytest

from portbench import spec, trace
from portbench.run import RunContext

CONFIG = {"draws": 10, "chains": 4, "params": 3}


def ctx(**kw):
    base = dict(config=CONFIG, device_kind="NVIDIA H100 80GB HBM3",
                setup_s=7.5, passes=0, pass_s=[], window_s=0.0, launches={},
                peak_above_sample_bytes=0, trace=None)
    base.update(kw)
    return RunContext(**base)


def read(name, c):
    return spec.metric_reader(name).read(c)


def test_diag_rate_takes_the_whole_window():
    # 4 passes of 120 values in a window of 2 s (the passes' own seconds sum
    # to less: the rate counts the whole window)
    c = ctx(passes=4, pass_s=[0.1, 0.2, 0.3, 0.4], window_s=2.0)
    assert read("diag_rate", c) == pytest.approx(4 * 120 / 2.0 / 1e9)


def test_p95_over_every_pass():
    times = [i / 1000 for i in range(1, 201)]  # 1..200 ms, shuffled order
    c = ctx(pass_s=times[::-1])
    assert read("pass_p95_ms", c) == pytest.approx(190.0)
    assert read("pass_p95_ms", ctx(pass_s=[0.005])) == pytest.approx(5.0)
    assert read("pass_p95_ms", ctx()) is None


def test_setup_is_read_as_measured():
    assert read("setup_s", ctx()) == 7.5


def test_union_and_gaps():
    spans = [(0, 10), (5, 12), (20, 25), (24, 30), (40, 41)]
    assert trace.union_us(spans) == 12 + 10 + 1
    assert trace.gaps(spans, 0, 50) == [(12, 20), (30, 40), (41, 50)]
    assert trace.gaps([(-5, 3)], 0, 10) == [(3, 10)]
    assert trace.union_us([]) == 0


def _trace():
    tr = trace.Trace(passes=2, window=(0.0, 100.0))
    tr.device = [("void radix_histogram(unsigned int*)", 0.0, 10.0),
                 ("void radix_digit_pass<true, true>(unsigned int*)", 10.0, 30.0),
                 ("moments_autocov_kernel<1, 8, 4>(float*)", 50.0, 90.0)]
    tr.host = [("portbench.pass", 0.0, 100.0), ("cudaStreamSynchronize", 30.0, 50.0)]
    return tr


def test_idle_share_and_breakdown():
    tr = _trace()
    c = ctx(trace=tr, passes=2)
    assert read("device.idle_pct", c) == pytest.approx(100.0 * (1 - 70 / 100))
    assert read("api.launches", c) == pytest.approx(1.5)
    b = trace.breakdown(tr)
    assert b["device_ops"][0] == ["moments_autocov_kernel<1, 8, 4>", pytest.approx(20e-6)]
    assert dict(map(tuple, b["idle_gaps"])) == {
        "cudaStreamSynchronize": pytest.approx(10e-6),
        "portbench.pass": pytest.approx(5e-6)}


def test_layer_readers_sum_named_kernels_a_pass():
    c = ctx(trace=_trace(), passes=2)
    assert read("rank_exact.device_ms", c) == pytest.approx(30e-3 / 2)
    assert read("autocov.device_ms", c) == pytest.approx(40e-3 / 2)
    assert read("rank_fast.device_ms", c) is None
    for name in ("device.idle_pct", "api.launches", "k13_roofline", "k1_roofline",
                 "rank_exact.device_ms"):
        assert read(name, ctx()) is None


K13 = spec.metric_reader("k13_roofline")
K1 = spec.metric_reader("k1_roofline")


@pytest.mark.parametrize("entries, sorts, with_pos, expect", [
    # the flagship exact call: 1000 rows of 1.28M entries, one sort with
    # positions: 1.28e9 x 16 B
    (1000 * 1_280_000, 1, 1, 20_480_000_000),
    # nested R-hat: two sorts with positions and the median's keys-only
    # sort of 1000 rows of 1M: 1e9 x (16 + 16 + 8) B
    (1000 * 1_000_000, 3, 2, 40_000_000_000),
])
def test_k13_bytes_by_hand(entries, sorts, with_pos, expect):
    assert K13.sort_bytes(entries, sorts, with_pos) == expect


@pytest.mark.parametrize("n, series, lag, ops, nbytes", [
    # n = 5 draws, 2 series, lags 0..2: products 5 + 4 + 3 = 12, so 2 x (24
    # + 20) ops; 2 x 4 x (5 + 4 + 3) bytes
    (5, 2, 2, 88, 96),
    # config 4's probe: 5000 draws, 256,000 series, lags 0..64: products
    # 65 x 5000 - 64 x 65 / 2 = 322,920
    (5000, 256_000, 64, 256_000 * (2 * 322_920 + 20_000),
     256_000 * 4 * (5000 + 4 + 65)),
])
def test_k1_counts_by_hand(n, series, lag, ops, nbytes):
    assert K1.ops_bytes(n, series, lag) == (ops, nbytes)


def test_k1_lags_follow_the_adaptive_probe():
    assert K1.lags_of_pass(5000, 2) == [64, 250]
    assert K1.lags_of_pass(5000, 1) == [64]
    assert K1.lags_of_pass(50, 1) == [46]
    assert K1.lags_of_pass(100, 1) == [96]
    # a pass of 8 calls (parameter slices), one of which went the full depth
    assert K1.lags_of_pass(5000, 9, 8) == [64] * 8 + [250]


def test_rooflines_from_a_trace():
    cfg = {"draws": 10_000, "chains": 128, "params": 1000}
    tr = _trace()
    c = ctx(trace=tr, passes=2, config=cfg, launches={"K1": 4})
    # one sort with positions of 1.28e9 entries in 30 us of K13
    k13 = read("k13_roofline", c)
    assert k13 == pytest.approx(100 * 20.48e9 / 3.35e12 / 30e-6)
    ops64, b64 = K1.ops_bytes(5000, 256_000, 64)
    ops250, b250 = K1.ops_bytes(5000, 256_000, 250)
    least = max(ops64 / 6.69e13, b64 / 3.35e12) + max(ops250 / 6.69e13, b250 / 3.35e12)
    assert read("k1_roofline", c) == pytest.approx(100 * least * 2 / 40e-6)
    assert read("k13_roofline", ctx(trace=tr, passes=2, config=cfg,
                                    device_kind="cpu")) is None
    # the same launches in a pass of 8 calls each sort an eighth of the rows
    sliced = ctx(trace=tr, passes=2, config=cfg, launches={"K1": 4}, calls_a_pass=8)
    assert read("k13_roofline", sliced) == pytest.approx(k13 / 8)


def test_short_names():
    assert trace.short_name("void (anonymous namespace)::radix_digit_pass<true, false>(int)") \
        == "void radix_digit_pass<true, false>"
    assert trace.short_name("Memset (Device)") == "Memset"
    assert trace.short_name("(anonymous namespace)::tied_ranks_kernel(float*)") == "tied_ranks_kernel"


def test_values_per_pass():
    assert ctx().values_per_pass == 120


def _host_op_at(tr, t):
    """The definition: the latest-started host operation covering ``t``."""
    best, best_start = "python", float("-inf")
    for name, a, b in tr.host:
        if a <= t <= b and a > best_start and name != "portbench.window":
            best, best_start = name, a
    return best


@pytest.mark.parametrize("seed", range(5))
def test_the_breakdown_names_each_gap_by_its_definition(seed):
    import random

    rng = random.Random(seed)
    host = [("portbench.window", 0.0, 1000.0)]
    for i in range(300):
        a = rng.choice([rng.uniform(0, 990), float(rng.randrange(0, 990, 10))])
        host.append((f"op{i % 17}", a, a + rng.choice([0.0, 1.0, rng.uniform(0, 80)])))
    device = []
    for _ in range(200):
        a = rng.uniform(0, 995)
        device.append(("k", a, a + rng.uniform(0, 5)))
    tr = trace.Trace(device=device, host=host, window=(0.0, 1000.0), passes=2)
    mids = sorted(rng.uniform(-5, 1005) for _ in range(400))
    assert trace.host_ops_at(tr, mids) == [_host_op_at(tr, t) for t in mids]
    idle = {}
    for a, b in trace.gaps([(a, b) for _, a, b in device], 0.0, 1000.0):
        name = _host_op_at(tr, (a + b) / 2)
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e6 / 2
    want = [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:10]]
    assert trace.breakdown(tr)["idle_gaps"] == want
