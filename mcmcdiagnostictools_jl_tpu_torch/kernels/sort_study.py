"""Kernels K7, K8 and K9: the cost of a hand-written column sort.

They replace the Pallas kernels of ``benchmarks/sort_microbench.py``:
``_pass_kernel`` (``bench_dma_pass``, K7), ``_pass_kernel_contig``
(``bench_dma_contig``, K8) and ``_phase_a_kernel`` (``bench_phase_a``, K9).
The CUDA source is ``csrc/sort_study.cu``; it says what bounds each kernel on
an H100 and how the TPU's 32 MB pods were re-sized for a block's shared
memory.

K7 and K8 run one persistent kernel that moves segments by the TMA through
a ring of shared-memory stages. ``pass_plan`` decides, in plain Python, the
tasks (the blocks of the TPU-shaped grid, handed out in its order), the
stages a task is cut into, the ring's depth and the grid;
``pass_task_rows`` and ``pass_stage_copies`` spell out what the kernel
copies for a task, for the tests.

K9 runs as a sequence of launches, chunk launches (a block sorts up to 1024
rows x 8 columns, a thread holding 16 rows in registers) and wide passes (up
to 5 strides at once through device memory). ``sort_plan`` decides, in plain
Python, which launch and which register window takes which step of the
network; the wrapper hands each launch its steps.

All three work IN PLACE on ``keys`` ``(N, C)`` float32 and ``payload``
``(N, C)`` int32 and return the two tensors they were given:

- ``pass_strided`` (K7) / ``pass_contig`` (K8): ``keys + 1``, ``payload + 1``
  whatever the pod geometry, which decides only the order memory is walked;
- ``bitonic_pod_sort`` (K9): every pod of ``pod_rows`` rows sorted along dim
  0, each column on its own, payload carried with its key, even pods
  ascending and odd pods descending.

Each wrapper launches its kernel for CUDA tensors and runs its plain version
(which returns new tensors) for CPU tensors, copying the result back in
place; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import backend
from . import _build

TILE = 2048                  # rows of a tile, the unit of the pod geometry
_BLOCK_BYTES = 64 * 1024     # keys + payload of a task, for default_seg_rows
# K7/K8 as csrc/sort_study.cu builds them: threads a block (8 consumer
# warps, a loader warp and a storer warp), most stages of the ring, the
# bytes before the ring (three mbarriers and a stage id a slot)
PASS_THREADS = 320
PASS_MAX_STAGES = 16
_PASS_BARRIER_BYTES = 4 * PASS_MAX_STAGES * 8
STAGE_BYTES = 32 * 1024      # keys + payload a stage aims for
PASS_BLOCKS_PER_SM = 1       # blocks whose rings share a multiprocessor
# an H100: multiprocessors; shared memory of one, of it what the runtime
# keeps for each block, and the most one block may take
H100_SMS = 132
_SM_SHARED = 228 * 1024
_BLOCK_RESERVED = 1024
_MAX_BLOCK_BYTES = 227 * 1024
CHUNK_ROWS = 1024            # most rows a K9 chunk block holds (x 8 columns)
CELL_BITS = 4                # a K9 chunk thread holds 2**4 rows of one column
WIDE_BITS = 5                # most strides a K9 wide pass takes at once


def _check_arrays(keys, payload):
    if keys.ndim != 2 or keys.shape != payload.shape:
        raise ValueError("keys and payload must be 2-d and of one shape")
    if keys.device != payload.device:
        raise ValueError("keys and payload must be on one device")
    if payload.dtype != torch.int32:
        raise ValueError(f"payload must be int32, got {payload.dtype}")
    if not backend.use_kernels(keys):
        if keys.dtype != torch.float32:
            raise ValueError(f"keys must be float32, got {keys.dtype}")
        return False
    if not (keys.is_contiguous() and payload.is_contiguous()):
        raise ValueError("keys and payload must be contiguous")
    if keys.shape[1] % 4:
        raise ValueError("the column count must be a multiple of 4 "
                         f"(16-byte copies), got {keys.shape[1]}")
    return True


def _pod_geometry(nrows, pod_tiles, stride_tiles, tile_rows):
    """The tile count, after the checks the TPU file left to its caller:
    whole tiles, and pods that tile them evenly."""
    if min(pod_tiles, stride_tiles, tile_rows) < 1:
        raise ValueError("pod_tiles, stride_tiles and tile_rows must be >= 1")
    if nrows % tile_rows:
        raise ValueError(f"{nrows} rows are not whole tiles of {tile_rows}")
    ntiles = nrows // tile_rows
    if ntiles == 0 or ntiles % (pod_tiles * stride_tiles):
        raise ValueError(
            f"ntiles = {ntiles} is not a multiple of pod_tiles x stride_tiles "
            f"= {pod_tiles} x {stride_tiles}")
    return ntiles


def default_seg_rows(pod_tiles: int, ncols: int, tile_rows: int = TILE) -> int:
    """Rows of one segment: the largest power of two that divides
    ``tile_rows`` and keeps a task's ``pod_tiles`` segments (keys and
    payload) within 64 KB; at least 1."""
    seg = 1
    while (tile_rows % (2 * seg) == 0
           and pod_tiles * 2 * seg * ncols * 8 <= _BLOCK_BYTES):
        seg *= 2
    return seg


def pass_plain(keys, payload, pod_tiles: int, stride_tiles: int = 1,
               tile_rows: int = TILE):
    """Plain PyTorch version of K7 and K8: ``(keys + 1, payload + 1)`` as
    new tensors. The pods ``(hi * pod_tiles + j) * stride_tiles + lo``
    partition the tiles, so every element is touched exactly once whatever
    the geometry; it is checked, and changes nothing else."""
    _pod_geometry(keys.shape[0], pod_tiles, stride_tiles, tile_rows)
    return keys + 1.0, payload + 1


def pass_blocks_per_sm(smem: int) -> int:
    """Blocks of the pass kernel an H100 multiprocessor holds with ``smem``
    bytes of dynamic shared memory each: as many as its 2048 threads and
    its shared memory allow (the card's own answer, from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, is what the wrapper
    uses)."""
    return min(2048 // PASS_THREADS, _SM_SHARED // (smem + _BLOCK_RESERVED))


def pass_plan(nrows: int, ncols: int, pod_tiles: int, stride_tiles: int = 1,
              tile_rows: int = TILE, seg_rows: int | None = None, *,
              contiguous: bool = False, stage_bytes: int = STAGE_BYTES,
              stages: int | None = None,
              blocks_per_sm: int = PASS_BLOCKS_PER_SM, sms: int = H100_SMS,
              occupancy=pass_blocks_per_sm) -> dict:
    """The walk and the ring of K7 (K8 with ``contiguous``) over keys and
    payload of ``(nrows, ncols)``, as a dict:

    - ``tasks``: the blocks of the TPU-shaped grid, in its order. K7's task
      ``t`` is slot ``t % nslots`` (``nslots = tile_rows / seg_rows``) of pod
      ``t // nslots``; K8's the run of ``pod_tiles * seg_rows`` rows from
      ``t * pod_tiles * seg_rows`` on. Each is ``nseg = pod_tiles`` segments
      of ``seg_rows`` rows (default ``default_seg_rows``; see
      ``pass_task_rows``);
    - ``stage_segs``: segments of one task a stage holds, the largest divisor
      of ``pod_tiles`` whose keys + payload stay within ``stage_bytes`` (at
      least one); ``stage_bytes`` their size, ``parts`` the stages a task;
    - ``stages``: the ring's slots, as many as fit (at most 16) a block's
      share of the multiprocessor when ``blocks_per_sm`` blocks share it, or
      as given;
    - ``smem``: a block's dynamic shared memory, the mbarriers and the ring;
    - ``grid``: ``sms`` times the blocks a multiprocessor holds with
      ``smem`` (``occupancy(smem)``), at most ``tasks``. The blocks take
      the tasks in order from a counter on the card.

    Raises ``ValueError`` if the pods do not tile the rows, ``seg_rows`` does
    not divide ``tile_rows``, or the ring would have fewer than two stages
    or more than 16."""
    _pod_geometry(nrows, pod_tiles, stride_tiles, tile_rows)
    if contiguous and stride_tiles != 1:
        raise ValueError("K8's runs are contiguous: stride_tiles must be 1")
    if seg_rows is None:
        seg_rows = default_seg_rows(pod_tiles, ncols, tile_rows)
    if seg_rows < 1 or tile_rows % seg_rows:
        raise ValueError(f"seg_rows = {seg_rows} must divide tile_rows = "
                         f"{tile_rows}")
    if ncols < 4 or ncols % 4:
        raise ValueError("the column count must be a multiple of 4 "
                         f"(16-byte copies), got {ncols}")
    seg_bytes = seg_rows * ncols * 8
    budget = min(_MAX_BLOCK_BYTES, _SM_SHARED // blocks_per_sm
                 - _BLOCK_RESERVED) - _PASS_BARRIER_BYTES
    if 2 * seg_bytes > budget:
        raise ValueError(
            f"two stages of a segment of {seg_rows} x {ncols} keys and "
            "payload do not fit a block's shared memory")
    stage_segs = max(d for d in range(1, pod_tiles + 1)
                     if pod_tiles % d == 0
                     and (d == 1 or d * seg_bytes <= stage_bytes))
    nstages = (min(PASS_MAX_STAGES, budget // (stage_segs * seg_bytes))
               if stages is None else stages)
    if not 2 <= nstages <= PASS_MAX_STAGES or (
            nstages * stage_segs * seg_bytes > budget):
        raise ValueError(f"a ring of {nstages} stages of "
                         f"{stage_segs * seg_bytes} bytes does not fit a "
                         "block's shared memory (2 to 16 stages)")
    nslots = tile_rows // seg_rows
    tasks = (nrows // (pod_tiles * seg_rows) if contiguous
             else nslots * (nrows // tile_rows // pod_tiles))
    smem = _PASS_BARRIER_BYTES + nstages * stage_segs * seg_bytes
    per_sm = occupancy(smem)
    if per_sm < 1:
        raise ValueError(f"no block with {smem} bytes of shared memory fits "
                         "a multiprocessor")
    return {"contiguous": contiguous, "tasks": tasks, "nseg": pod_tiles,
            "seg_rows": seg_rows, "tile_rows": tile_rows,
            "stride_tiles": stride_tiles, "nslots": nslots,
            "stage_segs": stage_segs, "parts": pod_tiles // stage_segs,
            "stage_bytes": stage_segs * seg_bytes, "stages": nstages,
            "smem": smem, "blocks_per_sm": per_sm,
            "grid": min(tasks, sms * per_sm)}


def pass_task_rows(plan: dict, task: int) -> list[int]:
    """First rows of the segments of ``task``, in order; a segment is
    ``plan["seg_rows"]`` rows. K7: the TPU pod ``g = task // nslots`` holds
    the tiles ``(hi * nseg + j) * stride_tiles + lo`` (``lo, hi`` = ``g``
    modulo and over ``stride_tiles``), the task takes slot ``task % nslots``
    of each."""
    nseg, seg = plan["nseg"], plan["seg_rows"]
    if plan["contiguous"]:
        return [(task * nseg + j) * seg for j in range(nseg)]
    g, x = divmod(task, plan["nslots"])
    hi, lo = divmod(g, plan["stride_tiles"])
    return [((hi * nseg + j) * plan["stride_tiles"] + lo) * plan["tile_rows"]
            + x * seg for j in range(nseg)]


def pass_stage_copies(plan: dict, task: int, part: int) -> list[tuple]:
    """The bulk copies of one stage, the same for keys and for payload, as
    ``(first row, rows)``: K7 one a segment, K8 one for the stage's run."""
    k = plan["stage_segs"]
    rows = pass_task_rows(plan, task)[part * k:(part + 1) * k]
    if plan["contiguous"]:
        return [(rows[0], k * plan["seg_rows"])]
    return [(r, plan["seg_rows"]) for r in rows]


_TASK_COUNTERS = {}


def _task_counters(device, stream: int):
    """The pass kernel's two task counters for launches on ``stream`` of
    ``device``: zeroed once; every launch leaves them zero, and launches on
    one stream never overlap."""
    key = (device, stream)
    if key not in _TASK_COUNTERS:
        _TASK_COUNTERS[key] = torch.zeros(2, dtype=torch.int64, device=device)
    return _TASK_COUNTERS[key]


def run_pass(lib, plan: dict, keys, payload) -> None:
    """One launch of the pass kernel of ``lib`` with ``plan`` on card
    tensors ``keys``, ``payload``, on the current stream."""
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        code = lib.mdt_sort_pass(
            keys.data_ptr(), payload.data_ptr(),
            _task_counters(keys.device, stream).data_ptr(),
            int(not plan["contiguous"]), plan["tasks"], keys.shape[1],
            plan["nseg"], plan["seg_rows"], plan["tile_rows"],
            plan["stride_tiles"], plan["nslots"], plan["stage_segs"],
            plan["stages"], plan["grid"], stream)
    _build.check(code, "mdt_sort_pass")


@functools.cache
def card_blocks_per_sm(lib, strided: bool, smem: int, device: int) -> int:
    """Blocks of the K7 (``strided``) or K8 kernel of ``lib`` a
    multiprocessor of card ``device`` holds with ``smem`` bytes of dynamic
    shared memory."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.check(lib.mdt_sort_pass_occupancy(int(strided), smem,
                                                 ctypes.addressof(out)),
                     "mdt_sort_pass_occupancy")
    return out.value


def card_pass_plan(lib, keys, pod_tiles, stride_tiles=1, tile_rows=TILE,
                   seg_rows=None, **kw) -> dict:
    """``pass_plan`` for card tensors: the card's multiprocessors and its
    own occupancy of ``lib``'s kernel."""
    device = keys.device.index
    if device is None:
        device = torch.cuda.current_device()
    strided = not kw.get("contiguous", False)
    return pass_plan(
        *keys.shape, pod_tiles, stride_tiles, tile_rows, seg_rows,
        sms=torch.cuda.get_device_properties(device).multi_processor_count,
        occupancy=lambda smem: card_blocks_per_sm(lib, strided, smem, device),
        **kw)


def _pass(keys, payload, pod_tiles, stride_tiles, tile_rows, seg_rows,
          wrapper):
    """The body of both pass wrappers; ``wrapper`` is the one that counts."""
    on_card = _check_arrays(keys, payload)
    nrows, ncols = keys.shape
    _pod_geometry(nrows, pod_tiles, stride_tiles, tile_rows)
    if not on_card:
        k, p = pass_plain(keys, payload, pod_tiles, stride_tiles, tile_rows)
        keys.copy_(k)
        payload.copy_(p)
        return keys, payload
    if keys.data_ptr() % 16 or payload.data_ptr() % 16:
        raise ValueError("keys and payload must start on 16-byte boundaries "
                         "(bulk copies)")
    lib = _build.library()
    plan = card_pass_plan(lib, keys, pod_tiles, stride_tiles, tile_rows,
                          seg_rows, contiguous=wrapper is pass_contig)
    run_pass(lib, plan, keys, payload)
    wrapper.launches += 1
    return keys, payload


def pass_strided(keys, payload, pod_tiles: int, stride_tiles: int, *,
                 tile_rows: int = TILE, seg_rows: int | None = None):
    """K7, in place: each task takes ``pod_tiles`` segments of ``seg_rows``
    rows (default: ``default_seg_rows``) that lie ``stride_tiles`` tiles
    apart through shared memory, adds 1 to keys and payload there, and
    writes them back (``pass_plan``). Raises unless the row count is whole
    tiles and the tile count a multiple of ``pod_tiles * stride_tiles``, and
    on the card unless both tensors start on 16-byte boundaries."""
    return _pass(keys, payload, pod_tiles, stride_tiles, tile_rows, seg_rows,
                 pass_strided)


def pass_contig(keys, payload, pod_tiles: int, *, tile_rows: int = TILE,
                seg_rows: int | None = None):
    """K8, in place: the same pass with one contiguous run of ``pod_tiles *
    seg_rows`` rows a task. Raises unless the row count is whole tiles and
    the tile count a multiple of ``pod_tiles``, and on the card unless both
    tensors start on 16-byte boundaries."""
    return _pass(keys, payload, pod_tiles, 1, tile_rows, seg_rows, pass_contig)


def _check_pods(nrows: int, pod_rows: int):
    if pod_rows < 2 or pod_rows & (pod_rows - 1):
        raise ValueError(f"pod_rows must be a power of two >= 2, got {pod_rows}")
    if nrows == 0 or nrows % pod_rows:
        raise ValueError(f"{nrows} rows are not whole pods of {pod_rows}")


def compare_exchange_plain(keys, payload, stage: int, stride: int):
    """One step of the network as new tensors: rows ``r`` and ``r + stride``
    (bit ``stride`` of ``r`` clear) are swapped when ``(key_lo > key_hi) !=
    descending``, with ``descending`` bit ``stage`` of ``r``."""
    nrows, ncols = keys.shape
    rows = torch.arange(nrows, device=keys.device)
    k4 = keys.reshape(-1, 2, stride, ncols)
    p4 = payload.reshape(-1, 2, stride, ncols)
    desc = (rows.reshape(-1, 2, stride)[:, 0] & stage) != 0
    swap = (k4[:, 0] > k4[:, 1]) != desc[:, :, None]
    keys = torch.stack(
        [torch.where(swap, k4[:, 1], k4[:, 0]),
         torch.where(swap, k4[:, 0], k4[:, 1])], 1).reshape(nrows, ncols)
    payload = torch.stack(
        [torch.where(swap, p4[:, 1], p4[:, 0]),
         torch.where(swap, p4[:, 0], p4[:, 1])], 1).reshape(nrows, ncols)
    return keys, payload


def bitonic_pod_sort_plain(keys, payload, pod_rows: int):
    """Plain PyTorch version of K9: the same bitonic network (stages 2,
    4, ..., ``pod_rows``; within a stage the strides ``stage / 2``, ..., 1,
    each a ``compare_exchange_plain``), as new tensors."""
    _check_pods(keys.shape[0], pod_rows)
    stage = 2
    while stage <= pod_rows:
        stride = stage // 2
        while stride >= 1:
            keys, payload = compare_exchange_plain(keys, payload, stage, stride)
            stride //= 2
        stage *= 2
    return keys, payload


def sort_chunk_rows(pod_rows: int) -> int:
    """Rows of a K9 chunk: the pod, at least the 16 rows of one thread, at
    most ``CHUNK_ROWS``."""
    return min(max(pod_rows, 1 << CELL_BITS), CHUNK_ROWS)


def sort_plan(pod_rows: int) -> list[dict]:
    """K9's launches for pods of ``pod_rows`` rows, in order. Each is a dict
    with ``kind`` and ``steps``, the steps ``(stage, stride)`` of the bitonic
    network it runs, in the network's order:

    - ``"chunk"``: every step has a stride below the chunk; ``windows`` gives
      for each step the first bit ``lo`` of the register window ``[lo, lo +
      4)`` it runs in (a thread holds the 16 rows that differ in those bits of
      the row index). A window is kept while the next stride's bit lies in
      it; else the block re-deals to the window that starts 3 bits below that
      stride (clamped to the chunk), which covers the strides that follow in
      the stage. The first launch takes the stages 2..chunk; a later one the
      strides below the chunk of one stage.
    - ``"wide"``: up to 5 neighbouring strides at or above the chunk of one
      stage, from the top down (a thread holds the 2, 4, ..., 32 rows they
      pair): ``stage``, ``bit_lo``, ``nbits``.
    """
    if pod_rows < 2 or pod_rows & (pod_rows - 1):
        raise ValueError(f"pod_rows must be a power of two >= 2, got {pod_rows}")
    chunk_bits = sort_chunk_rows(pod_rows).bit_length() - 1
    launches = []
    chunk = None
    lo = None
    stage_bits = 1
    while (1 << stage_bits) <= pod_rows:
        stage = 1 << stage_bits
        hi = stage_bits  # strides 2**(hi - 1), ... are still to run
        if hi > chunk_bits:
            chunk = None
            while hi > chunk_bits:
                nbits = min(WIDE_BITS, hi - chunk_bits)
                hi -= nbits
                launches.append({
                    "kind": "wide", "stage": stage, "bit_lo": hi,
                    "nbits": nbits,
                    "steps": [(stage, 1 << b)
                              for b in range(hi + nbits - 1, hi - 1, -1)]})
        if chunk is None:
            chunk = {"kind": "chunk", "steps": [], "windows": []}
            launches.append(chunk)
            lo = None
        for bit in range(hi - 1, -1, -1):
            if lo is None or not lo <= bit < lo + CELL_BITS:
                lo = min(max(bit - CELL_BITS + 1, 0), chunk_bits - CELL_BITS)
            chunk["steps"].append((stage, 1 << bit))
            chunk["windows"].append(lo)
        stage_bits += 1
    return launches


def run_launch(lib, launch: dict, keys, payload, chunk_rows: int, stream):
    """One launch of ``sort_plan`` on card tensors, with the kernels of
    ``lib`` on ``stream``."""
    nrows, ncols = keys.shape
    if launch["kind"] == "chunk":
        triples = [v for (stage, stride), lo in
                   zip(launch["steps"], launch["windows"])
                   for v in (stage.bit_length() - 1, stride.bit_length() - 1,
                             lo)]
        code = lib.mdt_sort_chunk(
            keys.data_ptr(), payload.data_ptr(), nrows, ncols, chunk_rows,
            len(launch["steps"]), (ctypes.c_int * len(triples))(*triples),
            stream)
        _build.check(code, "mdt_sort_chunk")
    else:
        code = lib.mdt_sort_wide(
            keys.data_ptr(), payload.data_ptr(), nrows, ncols,
            launch["stage"], launch["bit_lo"], launch["nbits"], stream)
        _build.check(code, "mdt_sort_wide")


def bitonic_pod_sort(keys, payload, pod_rows: int):
    """K9, in place: every pod of ``pod_rows`` rows (a power of two that
    divides the row count) sorted along dim 0, each column on its own, the
    payload carried with its key; even pods ascending, odd pods descending.
    A bitonic network is not stable: equal keys may exchange payloads. NaN
    keys are outside the contract (the network compares with ``>``), as
    they are for the TPU kernel. On the card the launches of ``sort_plan``
    run one after the other on the current stream; the call counts as one
    launch of K9."""
    on_card = _check_arrays(keys, payload)
    nrows, ncols = keys.shape
    _check_pods(nrows, pod_rows)
    if not on_card:
        k, p = bitonic_pod_sort_plain(keys, payload, pod_rows)
        keys.copy_(k)
        payload.copy_(p)
        return keys, payload
    lib = _build.library()
    chunk_rows = sort_chunk_rows(pod_rows)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        for launch in sort_plan(pod_rows):
            run_launch(lib, launch, keys, payload, chunk_rows, stream)
    bitonic_pod_sort.launches += 1
    return keys, payload


pass_strided.launches = 0
pass_contig.launches = 0
bitonic_pod_sort.launches = 0
