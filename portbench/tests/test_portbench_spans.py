"""The readers by the port's own regions (``portbench/spans.py``) on a
synthetic trace counted by hand: launches paired with device operations by
correlation id, the innermost ``mdt.`` region open at a launch takes the
operation, idle time inside the call regions, the synchronizing calls by
region, the coverage, and the new metrics' readers; the readers by kernel
name read the same with or without the runtime calls and regions."""

from __future__ import annotations

import pytest

from portbench import spans, spec, trace
from portbench.run import WARMUP_PASSES, RunContext

CONFIG = {"draws": 10_000, "chains": 128, "params": 1000}

# device operations: (name, start, end), two passes of 100 us
DEVICE = [
    ("void radix_histogram(unsigned int*)", 14.0, 19.0),            # k1
    ("Memcpy HtoD (Pageable -> Device)", 21.5, 22.0),              # c1
    ("void radix_digit_pass<true, true>(unsigned int*)", 41.0, 60.0),  # k2
    ("moments_autocov_kernel<1, 8, 4>(float*)", 60.0, 70.0),        # k3
    ("void at::native::elementwise_kernel<128, 2>()", 82.0, 84.0),  # k4
    ("Memcpy DtoH (Device -> Pageable)", 92.0, 93.0),              # c2
    ("void at::native::vectorized_elementwise_kernel<4>()", 152.0, 160.0),  # k5
]
REGIONS = [
    ("portbench.window", 0.0, 200.0),
    ("portbench.pass", 0.0, 100.0),
    ("portbench.pass", 100.0, 200.0),
    ("portbench.call.ess_rhat", 4.0, 90.0),
    ("mdt.ess_rhat", 5.0, 90.0),
    ("mdt.rank.exact", 10.0, 40.0),
    ("mdt.sync.quantile_offset", 20.0, 30.0),
    ("mdt.moments", 45.0, 55.0),
    ("portbench.to_host", 90.0, 99.0),
]
RUNTIME = [
    ("cudaLaunchKernel", 12.0, 13.0),       # k1, inside mdt.rank.exact
    ("cudaMemcpyAsync", 21.0, 21.2),        # c1, inside the sync region
    ("cudaStreamSynchronize", 22.0, 29.0),
    ("cudaLaunchKernel", 38.0, 39.0),       # k2: runs after its region closed
    ("cudaLaunchKernel", 46.0, 47.0),       # k3, inside mdt.moments
    ("cudaLaunchKernel", 80.0, 81.0),       # k4, in the call region alone
    ("cudaMemcpyAsync", 91.0, 91.5),        # c2, the harness's copy
    ("cudaStreamSynchronize", 92.0, 98.0),
    ("cudaLaunchKernel", 150.0, 151.0),     # k5, outside every mdt. region
]


# correlation ids: each runtime call's, and each device operation's (that of
# the call that launched it)
RUNTIME_IDS = [11, 12, 13, 14, 15, 16, 17, 18, 19]
DEVICE_IDS = [11, 12, 14, 15, 16, 17, 19]


def _trace(host=REGIONS + RUNTIME, device=DEVICE):
    """The trace as ``trace.run_traced`` keeps it: the ids of the device
    operations, and the start of each runtime call by its id."""
    corr = [DEVICE_IDS[DEVICE.index(op)] for op in device]
    launched = {RUNTIME_IDS[RUNTIME.index(h)]: h[1] for h in host
                if h in RUNTIME and RUNTIME_IDS[RUNTIME.index(h)] in corr}
    return trace.Trace(device=list(device), host=list(host),
                       window=(0.0, 200.0), passes=2, corr=corr,
                       launched=launched)


def ctx(tr, **kw):
    base = dict(config=CONFIG, device_kind="NVIDIA H100 80GB HBM3",
                setup_s=7.5, passes=2, pass_s=[], window_s=0.0,
                launches={"K1": 4}, peak_above_sample_bytes=0, trace=tr)
    base.update(kw)
    return RunContext(**base)


def read(name, c):
    return spec.metric_reader(name).read(c)


def test_launches_pair_with_operations_by_kind_and_order():
    # on one stream the ids pair the k-th launch of a kind with the k-th
    # operation of that kind, as the pairing by order did
    tr = _trace()
    assert spans.launch_times(tr) == [12.0, 21.0, 38.0, 46.0, 80.0, 91.0, 150.0]
    # the device's list in another order pairs the same
    shuffled = _trace(device=DEVICE[::-1])
    assert spans.launch_times(shuffled) == [150.0, 91.0, 80.0, 46.0, 38.0, 21.0, 12.0]
    # a launch with no operation changes nothing
    extra = _trace(host=REGIONS + RUNTIME + [("cudaLaunchKernel", 170.0, 171.0)])
    assert spans.launch_times(extra) == spans.launch_times(tr)
    assert spans.by_span(extra) == spans.by_span(tr)


def test_launches_pair_with_operations_by_correlation_id():
    # a collective's kernel on its own stream: launched at 32, inside the
    # rank region, it runs at 100-105, after k3 and k4 ran on the other
    # stream; paired by order, each kernel from k2 on would take an earlier launch
    nccl = ("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
            100.0, 105.0)
    host = REGIONS + RUNTIME + [("cudaLaunchKernelExC", 32.0, 33.0)]
    tr = _trace(host=host, device=DEVICE)
    tr.device.append(nccl)
    tr.corr.append(20)
    tr.launched[20] = 32.0
    times = spans.launch_times(tr)
    assert times == [12.0, 21.0, 38.0, 46.0, 80.0, 91.0, 150.0, 32.0]
    assert spans.attributed(tr)[-1][0] == "mdt.rank.exact"
    # an operation with no runtime call of its id leaves the pairing unknown
    del tr.launched[20]
    assert spans.launch_times(tr) is None
    assert spans.by_span(tr) is None


def test_innermost_region_at_launch_takes_the_operation():
    got = [r for r, _, _, _ in spans.attributed(_trace())]
    assert got == ["mdt.rank.exact",            # inside the call and the rank region
                   "mdt.sync.quantile_offset",  # the innermost of three
                   "mdt.rank.exact",            # ran after the region closed
                   "mdt.moments",
                   "mdt.ess_rhat",
                   None,                        # the harness's copy
                   None]                        # outside every mdt. region


def test_device_time_by_region_a_pass():
    assert spans.by_span(_trace()) == {
        "mdt.rank.exact": pytest.approx((5 + 19) / 2 / 1e6),
        "mdt.sync.quantile_offset": pytest.approx(0.5 / 2 / 1e6),
        "mdt.moments": pytest.approx(10 / 2 / 1e6),
        "mdt.ess_rhat": pytest.approx(2 / 2 / 1e6),
    }


def test_idle_inside_the_call_regions_by_hand():
    # gaps of the device in [0, 200] within the call region [5, 90]:
    # 5-14, 19-21.5, 22-41, 70-82, 84-90
    assert spans.idle_in_calls(_trace()) == pytest.approx((9 + 2.5 + 19 + 12 + 6) / 2 / 1e3)
    # a second call region [80, 95] adds 90-92 and 93-95, and counts 84-90,
    # where the two overlap, once
    twice = _trace(host=REGIONS + RUNTIME + [("mdt.ess", 80.0, 95.0)])
    assert spans.idle_in_calls(twice) == pytest.approx(
        (9 + 2.5 + 19 + 12 + 8 + 2) / 2 / 1e3)


def test_syncs_by_region_and_coverage():
    assert spans.syncs_by_region(_trace()) == {"mdt.sync.quantile_offset": 0.5,
                                               "portbench.to_host": 0.5}
    cov = spans.coverage(_trace())
    mdt = (5 + 0.5 + 19 + 10 + 2) / 2 / 1e6
    assert cov["mdt_s"] == pytest.approx(mdt)
    assert cov["outside_s"] == pytest.approx(8 / 2 / 1e6)  # k5; c2 is the harness's
    assert cov["mdt_share"] == pytest.approx(36.5 / 44.5)
    assert cov["layer_share"] == pytest.approx(34.5 / 36.5)


@pytest.mark.parametrize("name, value", [
    ("span.rank.device_ms", (5 + 19) / 2 / 1e3),
    ("span.moments.device_ms", 10 / 2 / 1e3),
    ("span.geyer.device_ms", None),
    ("span.nested.device_ms", None),
    ("api.idle_in_call_ms", (9 + 2.5 + 19 + 12 + 6) / 2 / 1e3),
])
def test_new_readers(name, value):
    got = read(name, ctx(_trace()))
    assert got == (None if value is None else pytest.approx(value))


SPAN_READERS = ("span.rank.device_ms", "span.moments.device_ms",
                "span.geyer.device_ms", "span.nested.device_ms",
                "api.idle_in_call_ms")


@pytest.mark.parametrize("name", SPAN_READERS)
def test_new_readers_find_nothing_without_regions(name):
    # the parent program: runtime calls but no mdt. region
    bare = [h for h in REGIONS + RUNTIME if not h[0].startswith("mdt.")]
    assert read(name, ctx(_trace(host=bare))) is None
    assert read(name, ctx(None)) is None
    assert read(name, ctx(trace.Trace(passes=2, window=(0.0, 1.0)))) is None


def test_host_syncs_read_the_program_counter_over_every_pass():
    from mcmcdiagnostictools_jl_tpu_torch.utils import profiling

    profiling.reset_sync_counts()
    passes = 10
    for _ in range(passes + WARMUP_PASSES):
        with profiling.host_sync("geyer_probe"):
            pass
        with profiling.host_sync("quantile_offset"):
            pass
    assert read("api.host_syncs", ctx(_trace(), passes=passes)) == 2.0
    assert read("api.host_syncs", ctx(None, passes=passes)) is None
    profiling.reset_sync_counts()


@pytest.mark.parametrize("name", ["rank_exact.device_ms", "autocov.device_ms",
                                  "rank_fast.device_ms", "api.launches",
                                  "device.idle_pct", "k13_roofline", "k1_roofline"])
def test_readers_by_name_ignore_the_regions_and_runtime_calls(name):
    bare = _trace(host=[("portbench.window", 0.0, 200.0)])
    assert read(name, ctx(_trace())) == read(name, ctx(bare))
    assert trace.breakdown(_trace())["device_ops"] == trace.breakdown(bare)["device_ops"]
