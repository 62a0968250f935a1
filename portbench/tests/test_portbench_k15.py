"""``k15_roofline``, the share of its roofline that K15, the ring route's
Blom scores from its counts, reaches on rank 0 of a world: its bytes
counted by hand on a synthetic trace."""

from __future__ import annotations

import pytest

from portbench import spec, trace

from .test_portbench_k14 import CONFIG, _WorldOfFour
from .test_portbench_metrics import _trace, ctx


def _ring_scores() -> trace.Trace:
    """One ring pass's scores on a rank of four: the bulk's and the fold's
    K15 launches (1.2 us each) beside a K14 count and a K13 launch."""
    tr = trace.Trace(passes=1, window=(0.0, 1000.0))
    tr.device += [
        ("void (anonymous namespace)::blom_counts_kernel(int*, long long, "
         "int, float)", 100.0, 101.2),
        ("void (anonymous namespace)::merge_count_kernel<false, false>("
         "float const*, int)", 200.0, 250.0),
        ("void (anonymous namespace)::blom_counts_kernel(int*, long long, "
         "int, float)", 300.0, 301.2),
        ("void radix_histogram(unsigned int*)", 900.0, 950.0)]
    return tr


def test_k15_roofline_counts_a_ranks_bytes(monkeypatch):
    """8 B an entry of a rank's block of 1e10 / 4 / 20 entries a launch, two
    launches, over the device time of the two K15 launches alone (K14's
    and K13's left out); outside a world, nothing."""
    reader = spec.metric_reader("k15_roofline")
    c = ctx(trace=_ring_scores(), passes=1, config=CONFIG, calls_a_pass=20)
    assert reader.read(c) is None
    monkeypatch.setattr(reader, "dist", _WorldOfFour)
    entries = 10_000 * 2_500 * 1000 / (4 * 20)
    assert reader.ENTRY_B == 8
    assert reader.read(c) == pytest.approx(
        100 * entries * 8 * 2 / 3.35e12 / (2 * 1.2e-6))


def test_k15_roofline_reads_nothing_without_a_k15_launch(monkeypatch):
    """The one-card cells' traces and the parent's sharded trace hold no
    K15 launch, and a card the peaks table lacks has no rate: None,
    whatever the world."""
    reader = spec.metric_reader("k15_roofline")
    monkeypatch.setattr(reader, "dist", _WorldOfFour)
    assert reader.read(ctx(trace=_trace(), passes=2, config=CONFIG,
                           calls_a_pass=20)) is None
    assert reader.read(ctx(config=CONFIG, calls_a_pass=20)) is None
    assert reader.read(ctx(trace=_ring_scores(), passes=1, config=CONFIG,
                           calls_a_pass=20, device_kind="cpu")) is None
    bench = spec.load_benchmark()
    metric = next(m for m in bench["per_layer"] if m["name"] == "k15_roofline")
    assert metric == {"name": "k15_roofline", "unit": "%", "better": "higher",
                      "source": "device_trace", "layer": "kernels",
                      "moves": "diag_rate",
                      "workloads": ["many_chains_c5x4.sharded"]}
