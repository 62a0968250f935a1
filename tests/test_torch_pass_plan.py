"""The plan of K7 and K8, the sort study's pass kernel (``pass_plan`` in
``kernels/sort_study.py``), in plain Python: what ``csrc/sort_study.cu``
copies for a task is spelled out by ``pass_task_rows`` and
``pass_stage_copies``, and checked here without the card.

- every row of every geometry of the study (1,048,576 x 128; the JAX-era
  study's settings, which chip_smoke's phase 10 runs) and of the small
  geometries of the CPU tests lies in exactly one segment of one task;
- a TPU pod's rows are the rows of its tasks, in the TPU kernel's tile
  order, and the tasks are numbered in the old grid's launch order (the
  order the kernel's counter hands them out); the grid fills the card;
- the ring fits a block's 227 KB, and every bulk copy is a whole number of
  16-byte pieces at a 16-byte offset;
- what does not tile, a segment that does not divide the tile, and a ring
  of fewer than two stages raise.
"""

import re

import numpy as np
import pytest
import torch

from mcmcdiagnostictools_jl_tpu_torch.benchmarks import pass_study
from mcmcdiagnostictools_jl_tpu_torch.kernels import _build, sort_study

N_STUDY, LANES = 512 * sort_study.TILE, 128

# (nrows, ncols, pods, stride, tile_rows, contiguous): phase 10 / the JAX
# study (stride None: K8), then the CPU tests' small tiles
GEOMETRIES = [(N_STUDY, LANES, pods, stride or 1, sort_study.TILE,
               stride is None) for _, pods, stride in pass_study.GEOMETRIES]
GEOMETRIES += [(64, LANES, pods, stride, 8, False)
               for pods, stride in ((2, 1), (2, 2), (2, 4), (4, 2), (8, 1),
                                    (1, 8))]
GEOMETRIES += [(64, LANES, pods, 1, 8, True) for pods in (1, 2, 4, 8)]
GEOMETRIES += [(96, 12, 3, 2, 8, False), (96, 132, 2, 3, 8, False),
               (4096, 4, 2, 1, 8, False), (4096, 20, 4, 1, 16, True)]


def _ids(g):
    n, c, pods, stride, tile, contig = g
    return f"{'K8' if contig else 'K7'}-{n}x{c}-pods{pods}-s{stride}-t{tile}"


def _plan(g, **kw):
    n, c, pods, stride, tile, contig = g
    return sort_study.pass_plan(n, c, pods, stride, tile, contiguous=contig,
                                **kw)


def _segments(plan):
    """First rows of every task's segments, ``(tasks, nseg)``."""
    return np.array([sort_study.pass_task_rows(plan, t)
                     for t in range(plan["tasks"])], dtype=np.int64)


@pytest.mark.parametrize("g", GEOMETRIES, ids=_ids)
def test_every_row_is_in_exactly_one_task(g):
    plan = _plan(g)
    starts = _segments(plan).reshape(-1)
    assert starts.size * plan["seg_rows"] == g[0]
    rows = (starts[:, None] + np.arange(plan["seg_rows"])).reshape(-1)
    assert np.array_equal(np.sort(rows), np.arange(g[0]))


@pytest.mark.parametrize("g", GEOMETRIES, ids=_ids)
def test_tasks_are_the_tpu_pods_in_the_old_grid_order(g):
    """Task ``t`` is block ``(t % nslots, t // nslots)`` of the old grid
    (``blockIdx.x`` fastest): the tasks of TPU pod ``g`` cover its tiles
    ``(hi * pods + j) * stride + lo`` (``_pass_kernel`` in the JAX-era
    ``benchmarks/sort_microbench.py``), segment ``j`` in tile ``j``, slot
    ``x`` at row ``x * seg_rows`` of its tile; K8's tasks are consecutive
    runs."""
    n, _, pods, stride, tile, contig = g
    plan = _plan(g)
    seg, segs = plan["seg_rows"], _segments(plan)
    if contig:
        run = pods * seg
        assert np.array_equal(segs[:, 0], np.arange(plan["tasks"]) * run)
        assert np.array_equal(np.diff(segs, axis=1), np.full(
            (plan["tasks"], pods - 1), seg))
        return
    nslots = tile // seg
    assert plan["nslots"] == nslots
    assert plan["tasks"] == nslots * (n // tile // pods)
    for pod in range(n // tile // pods):
        lo, hi = (pod % stride, pod // stride) if stride > 1 else (0, pod)
        tiles = [(hi * pods + j) * stride + lo for j in range(pods)]
        got = segs[pod * nslots:(pod + 1) * nslots]
        want = np.array([[t * tile + x * seg for t in tiles]
                         for x in range(nslots)])
        assert np.array_equal(got, want)


@pytest.mark.parametrize("g", GEOMETRIES, ids=_ids)
@pytest.mark.parametrize("sms,per_sm", [(132, None), (3, 1), (1, 2)])
def test_grid_is_the_multiprocessors_times_the_blocks_each_holds(g, sms,
                                                                 per_sm):
    """The persistent grid: every multiprocessor full (``occupancy`` of the
    block's shared memory: the card's answer on the card, the model here),
    never more blocks than tasks; the counter then hands each block its
    tasks in order."""
    kw = {} if per_sm is None else {"occupancy": lambda smem: per_sm}
    plan = _plan(g, sms=sms, **kw)
    per_sm = per_sm or sort_study.pass_blocks_per_sm(plan["smem"])
    assert plan["blocks_per_sm"] == per_sm >= 1
    assert plan["grid"] == min(plan["tasks"], sms * per_sm)
    assert plan["parts"] * plan["stage_segs"] == g[2]


@pytest.mark.parametrize("g", GEOMETRIES, ids=_ids)
@pytest.mark.parametrize("blocks_per_sm,stage_bytes", [
    (1, sort_study.STAGE_BYTES), (2, sort_study.STAGE_BYTES), (1, 8192),
    (1, 64 * 1024), (3, 16 * 1024)])
def test_stages_fit_and_copies_are_whole_16_byte_pieces(g, blocks_per_sm,
                                                        stage_bytes):
    n, ncols, pods = g[0], g[1], g[2]
    plan = _plan(g, blocks_per_sm=blocks_per_sm, stage_bytes=stage_bytes)
    seg_bytes = plan["seg_rows"] * ncols * 8
    assert pods % plan["stage_segs"] == 0
    assert plan["parts"] * plan["stage_segs"] == pods
    assert plan["stage_bytes"] == plan["stage_segs"] * seg_bytes
    assert plan["stage_bytes"] <= max(stage_bytes, seg_bytes)
    assert 2 <= plan["stages"] <= sort_study.PASS_MAX_STAGES
    assert plan["smem"] == 512 + plan["stages"] * plan["stage_bytes"]
    assert plan["smem"] <= 227 * 1024
    assert blocks_per_sm * (plan["smem"] + 1024) <= 228 * 1024
    # the ring is as deep as the block's share allows (at most 16)
    share = min(227 * 1024, 228 * 1024 // blocks_per_sm - 1024) - 512
    assert (plan["stages"] == sort_study.PASS_MAX_STAGES
            or (plan["stages"] + 1) * plan["stage_bytes"] > share)
    assert plan["blocks_per_sm"] == sort_study.pass_blocks_per_sm(plan["smem"])
    for task in {0, plan["tasks"] // 2, plan["tasks"] - 1}:
        covered = 0
        for part in range(plan["parts"]):
            copies = sort_study.pass_stage_copies(plan, task, part)
            assert sum(r for _, r in copies) * ncols * 8 == plan["stage_bytes"]
            for first, rows in copies:
                assert (first * ncols * 4) % 16 == 0
                assert (rows * ncols * 4) % 16 == 0 and rows >= 1
                assert first + rows <= n
            covered += sum(r for _, r in copies)
        assert covered == pods * plan["seg_rows"]


def test_k8_stage_is_one_run_k7_stage_one_copy_a_segment():
    k8 = sort_study.pass_plan(N_STUDY, LANES, 16, contiguous=True)
    k7 = sort_study.pass_plan(N_STUDY, LANES, 16, 1)
    assert k8["seg_rows"] == k7["seg_rows"] == 4
    assert k7["stage_segs"] == k8["stage_segs"] == 8  # 8 x 4 KB = 32 KB
    assert sort_study.pass_stage_copies(k8, 3, 1) == [(3 * 64 + 32, 32)]
    assert sort_study.pass_stage_copies(k7, 0, 1) == [
        (j * sort_study.TILE, 4) for j in range(8, 16)]
    assert k7["stages"] == 7 and k7["grid"] == 132


def test_explicit_settings_are_kept():
    plan = sort_study.pass_plan(4096, 4, 2, 1, 8, seg_rows=1, stages=2,
                                sms=1, occupancy=lambda smem: 1)
    assert (plan["stages"], plan["grid"], plan["seg_rows"]) == (2, 1, 1)
    assert plan["tasks"] == 8 * 256 and plan["stage_bytes"] == 64


@pytest.mark.parametrize("call,match", [
    (lambda: sort_study.pass_plan(64, 8, 3, 1, 8), "multiple"),
    (lambda: sort_study.pass_plan(60, 8, 2, 1, 8), "whole tiles"),
    (lambda: sort_study.pass_plan(64, 8, 2, 0, 8), ">= 1"),
    (lambda: sort_study.pass_plan(64, 8, 2, 2, 8, contiguous=True),
     "contiguous"),
    (lambda: sort_study.pass_plan(64, 8, 2, 1, 8, seg_rows=3), "seg_rows"),
    (lambda: sort_study.pass_plan(64, 8, 2, 1, 8, seg_rows=0), "seg_rows"),
    (lambda: sort_study.pass_plan(64, 6, 2, 1, 8), "multiple of 4"),
    (lambda: sort_study.pass_plan(2048, 128, 1, seg_rows=512,
                                  contiguous=True), "shared memory"),
    (lambda: sort_study.pass_plan(4096, 128, 1, seg_rows=128,
                                  blocks_per_sm=2), "shared memory"),
    (lambda: sort_study.pass_plan(64, 8, 2, 1, 8, stages=1), "stages"),
    (lambda: sort_study.pass_plan(64, 8, 2, 1, 8, stages=17), "stages"),
    (lambda: sort_study.pass_plan(N_STUDY, LANES, 1, seg_rows=64,
                                  stages=4), "stages"),
    (lambda: sort_study.pass_plan(64, 8, 2, 1, 8, occupancy=lambda s: 0),
     "fits"),
])
def test_pass_plan_rejects(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_pass_constants_agree_with_the_cuda_source():
    src = (_build.CSRC_DIR / "sort_study.cu").read_text()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)

    assert const("kPassConsumers") == "256"
    assert const("kPassThreads") == "kPassConsumers + 64"
    assert sort_study.PASS_THREADS == 256 + 64
    assert int(const("kPassMaxStages")) == sort_study.PASS_MAX_STAGES
    assert const("kPassBarrierBytes") == "4 * kPassMaxStages * 8"
    assert sort_study._PASS_BARRIER_BYTES == 4 * sort_study.PASS_MAX_STAGES * 8


def test_pass_study_variants_name_real_macros_and_settings():
    """Every macro of ``pass_study.VARIANTS`` is tested by the source, and
    every setting is a keyword of ``pass_plan`` that plans at the study's
    geometries."""
    src = (_build.CSRC_DIR / "sort_study.cu").read_text()
    for name, defines, settings in pass_study.VARIANTS:
        for macro in defines:
            assert re.search(rf"#ifn?def {macro.split('=')[0]}\b", src)
        for _, pods, stride in pass_study.GEOMETRIES:
            sort_study.pass_plan(N_STUDY, LANES, pods, stride or 1,
                                 contiguous=stride is None, **settings)


def test_the_pass_study_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        pass_study.interleaved_ms({"noop": lambda: None})


def test_pass_calls_run_the_plain_route_on_the_cpu():
    """The timed calls of phase 10 on small CPU arrays: every geometry adds
    one in place, as ``add_`` does."""
    k = torch.zeros((N_STUDY, 4))
    p = torch.zeros((N_STUDY, 4), dtype=torch.int32)
    calls = pass_study.pass_calls(k, p)
    assert list(calls) == [pass_study.label(*g) for g in pass_study.GEOMETRIES
                           ] + ["add_", "plain"]
    for name, fn in calls.items():
        fn()
    assert torch.equal(k, torch.full_like(k, 6.0))
    assert torch.equal(p, torch.full_like(p, 6))
