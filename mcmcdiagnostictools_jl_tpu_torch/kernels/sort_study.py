"""Kernels K7, K8 and K9: the cost of a hand-written column sort.

They replace the Pallas kernels of ``benchmarks/sort_microbench.py``:
``_pass_kernel`` (``bench_dma_pass``, K7), ``_pass_kernel_contig``
(``bench_dma_contig``, K8) and ``_phase_a_kernel`` (``bench_phase_a``, K9).
The CUDA source is ``csrc/sort_study.cu``; it says what bounds each kernel on
an H100 and how the TPU's 32 MB pods were re-sized for a block's shared
memory.

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

import torch

from .. import backend
from . import _build

TILE = 2048                  # rows of a tile, the unit of the pod geometry
_BLOCK_BYTES = 64 * 1024     # shared memory a pass block aims for
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
    ``tile_rows`` and keeps a block's ``pod_tiles`` segments (keys and
    payload) within 64 KB, so that three blocks share an SM; at least 1."""
    seg = 1
    while (tile_rows % (2 * seg) == 0
           and pod_tiles * 2 * seg * ncols * 8 <= _BLOCK_BYTES):
        seg *= 2
    return seg


def _check_seg_rows(seg_rows, pod_tiles, ncols, tile_rows):
    if seg_rows < 1 or tile_rows % seg_rows:
        raise ValueError(f"seg_rows = {seg_rows} must divide tile_rows = "
                         f"{tile_rows}")
    if pod_tiles * seg_rows * ncols * 8 > _MAX_BLOCK_BYTES:
        raise ValueError(
            f"{pod_tiles} segments of {seg_rows} x {ncols} keys and payload "
            "do not fit a block's shared memory")


def pass_plain(keys, payload, pod_tiles: int, stride_tiles: int = 1,
               tile_rows: int = TILE):
    """Plain PyTorch version of K7 and K8: ``(keys + 1, payload + 1)`` as
    new tensors. The pods ``(hi * pod_tiles + j) * stride_tiles + lo``
    partition the tiles, so every element is touched exactly once whatever
    the geometry; it is checked, and changes nothing else."""
    _pod_geometry(keys.shape[0], pod_tiles, stride_tiles, tile_rows)
    return keys + 1.0, payload + 1


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
    if seg_rows is None:
        seg_rows = default_seg_rows(pod_tiles, ncols, tile_rows)
    _check_seg_rows(seg_rows, pod_tiles, ncols, tile_rows)
    lib = _build.library()
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    with torch.cuda.device(keys.device):
        if wrapper is pass_strided:
            name = "mdt_sort_pass_strided"
            code = lib.mdt_sort_pass_strided(
                keys.data_ptr(), payload.data_ptr(), nrows, ncols, tile_rows,
                pod_tiles, stride_tiles, seg_rows, stream)
        else:
            name = "mdt_sort_pass_contig"
            code = lib.mdt_sort_pass_contig(
                keys.data_ptr(), payload.data_ptr(), nrows, ncols, pod_tiles,
                seg_rows, stream)
    _build.check(code, name)
    wrapper.launches += 1
    return keys, payload


def pass_strided(keys, payload, pod_tiles: int, stride_tiles: int, *,
                 tile_rows: int = TILE, seg_rows: int | None = None):
    """K7, in place: a block gathers ``pod_tiles`` segments of ``seg_rows``
    rows (default: ``default_seg_rows``) that lie ``stride_tiles`` tiles
    apart into shared memory, adds 1 to keys and payload there, and writes
    them back. Raises unless the row count is whole tiles and the tile
    count a multiple of ``pod_tiles * stride_tiles``."""
    return _pass(keys, payload, pod_tiles, stride_tiles, tile_rows, seg_rows,
                 pass_strided)


def pass_contig(keys, payload, pod_tiles: int, *, tile_rows: int = TILE,
                seg_rows: int | None = None):
    """K8, in place: the same pass with one contiguous run of ``pod_tiles *
    seg_rows`` rows a block. Raises unless the row count is whole tiles and
    the tile count a multiple of ``pod_tiles``."""
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
