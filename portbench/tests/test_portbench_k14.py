"""``k14_roofline``, the share of its roofline that K14, the ring route's
merge-count, reaches on rank 0 of a world: its bytes counted by hand on a
synthetic trace."""

from __future__ import annotations

import pytest

from portbench import spec, trace

from .test_portbench_metrics import _trace, ctx

CONFIG = {"draws": 10_000, "chains": 2_500, "params": 1000}


class _WorldOfFour:
    @staticmethod
    def is_available():
        return True

    @staticmethod
    def is_initialized():
        return True

    @staticmethod
    def get_world_size():
        return 4


def _ring_pass() -> trace.Trace:
    """One ring pass of a rank of four: the bulk's own block, three visits
    with positions, the fold's own block and three visits of ``t`` alone,
    each a partition (2 us) and a count (48 us), and a K13 launch."""
    tr = trace.Trace(passes=1, window=(0.0, 1000.0))
    modes = (["<true, true>"] + ["<false, true>"] * 3 + ["<true, false>"]
             + ["<false, false>"] * 3)
    for i, mode in enumerate(modes):
        at = 100.0 * i
        tr.device += [
            ("void (anonymous namespace)::merge_count_partition(float const*,"
             " int)", at, at + 2.0),
            (f"void (anonymous namespace)::merge_count_kernel{mode}(float "
             "const*, int)", at + 2.0, at + 50.0)]
    tr.device.append(("void radix_histogram(unsigned int*)", 900.0, 950.0))
    return tr


def test_k14_roofline_counts_a_ranks_bytes(monkeypatch):
    """12 B an entry for the own block with positions (read once), 24 B a
    visit with them, 8 B for the fold's own block and 16 B a visit of ``t``
    alone, on a rank's block of 1e10 / 4 / 20 entries, over the device time
    of the eight counts and their partitions (K13's launch left out);
    outside a world, nothing."""
    reader = spec.metric_reader("k14_roofline")
    c = ctx(trace=_ring_pass(), passes=1, config=CONFIG, calls_a_pass=20)
    assert reader.read(c) is None
    monkeypatch.setattr(reader, "dist", _WorldOfFour)
    entries = 10_000 * 2_500 * 1000 / (4 * 20)
    nbytes = entries * (12 + 3 * 24 + 8 + 3 * 16)
    assert reader.read(c) == pytest.approx(
        100 * nbytes / 3.35e12 / (8 * 50e-6))
    assert [reader.count_bytes(f"merge_count_kernel{m}") for m in (
        "<true, true>", "<true, false>", "<false, true>", "<false, false>")
    ] == [12, 8, 24, 16]


def test_k14_roofline_reads_nothing_without_a_k14_launch(monkeypatch):
    """The other cells' traces (K13, K1) hold no K14 launch, and a card the
    peaks table lacks has no rate: None, whatever the world."""
    reader = spec.metric_reader("k14_roofline")
    monkeypatch.setattr(reader, "dist", _WorldOfFour)
    assert reader.read(ctx(trace=_trace(), passes=2, config=CONFIG,
                           calls_a_pass=20)) is None
    assert reader.read(ctx(config=CONFIG, calls_a_pass=20)) is None
    assert reader.read(ctx(trace=_ring_pass(), passes=1, config=CONFIG,
                           calls_a_pass=20, device_kind="cpu")) is None
    bench = spec.load_benchmark()
    metric = next(m for m in bench["per_layer"] if m["name"] == "k14_roofline")
    assert metric["workloads"] == ["many_chains_c5x4.sharded"]
