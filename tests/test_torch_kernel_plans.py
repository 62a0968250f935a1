"""The launch plans of the redesigned kernels, checked on the CPU.

What a CUDA kernel does with its registers cannot run here, but which work
each launch of K9 and each of its register windows is given is decided in
plain Python (``kernels/sort_study.sort_plan``) and can: every step of the
bitonic network must be taken exactly once and in order, and the constants
the Python side shares with the CUDA sources must agree. (The lag loop's
instance is chosen by lag count in ``csrc/lagloop.cuh``; the card tests
cross every span.)
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mcmcdiagnostictools_jl_tpu_torch.kernels import _build, sort_study, tiedrank

POD_ROWS = [2 ** b for b in range(1, 17)]  # 2 .. 65,536


def _network(pod_rows):
    """The bitonic network's steps (stage, stride) in order."""
    steps, stage = [], 2
    while stage <= pod_rows:
        stride = stage // 2
        while stride >= 1:
            steps.append((stage, stride))
            stride //= 2
        stage *= 2
    return steps


# ---- K9 ---------------------------------------------------------------------

@pytest.mark.parametrize("pod_rows", POD_ROWS)
def test_sort_plan_takes_every_step_once_and_in_order(pod_rows):
    plan = sort_study.sort_plan(pod_rows)
    assert [s for launch in plan for s in launch["steps"]] == _network(pod_rows)
    chunk_rows = sort_study.sort_chunk_rows(pod_rows)
    chunk_bits = chunk_rows.bit_length() - 1
    assert 16 <= chunk_rows <= sort_study.CHUNK_ROWS
    assert plan[0]["kind"] == "chunk" and plan[-1]["kind"] == "chunk"
    for launch in plan:
        assert launch["steps"]
        if launch["kind"] == "chunk":
            assert len(launch["windows"]) == len(launch["steps"])
            for (stage, stride), lo in zip(launch["steps"], launch["windows"]):
                bit = stride.bit_length() - 1
                assert stride < chunk_rows
                # the stride pairs two registers of one thread
                assert 0 <= lo <= bit < lo + sort_study.CELL_BITS
                assert lo + sort_study.CELL_BITS <= chunk_bits
        else:
            lo, n = launch["bit_lo"], launch["nbits"]
            assert 1 <= n <= sort_study.WIDE_BITS and lo >= chunk_bits
            assert launch["steps"] == [
                (launch["stage"], 1 << b) for b in range(lo + n - 1, lo - 1, -1)]
            assert (1 << (lo + n)) <= launch["stage"] <= pod_rows


@pytest.mark.parametrize("pod_rows,chunks,wide,redeals", [
    (1024, 1, 0, 15), (16384, 5, 4, 27), (32768, 6, 5, 30), (65536, 7, 7, 33)])
def test_sort_plan_passes_and_redeals(pod_rows, chunks, wide, redeals):
    """Passes through device memory, and windows over all chunk launches
    (each change of window is one re-deal through shared memory; the first
    window of a launch reads what the load left there)."""
    plan = sort_study.sort_plan(pod_rows)
    assert sum(l["kind"] == "chunk" for l in plan) == chunks
    assert sum(l["kind"] == "wide" for l in plan) == wide
    windows = sum(1 + sum(a != b for a, b in zip(l["windows"], l["windows"][1:]))
                  for l in plan if l["kind"] == "chunk")
    assert windows == redeals


def _cell_rows(nrows, lo, nbits):
    """Rows held by each thread: ``(threads, 2**nbits)``, the rows that
    differ in the bits ``[lo, lo + nbits)``; the mapping of the CUDA kernels
    (``sort_chunk_kernel``: ``base | c << lo``; ``sort_wide_kernel``)."""
    rest = np.arange(nrows >> nbits)
    base = ((rest >> lo) << (lo + nbits)) | (rest & ((1 << lo) - 1))
    return base[:, None] | (np.arange(1 << nbits)[None, :] << lo)


def _step_in_registers(keys, payload, rows, bit, stage):
    """One step as the kernels run it: between the cells ``c`` and ``c |
    2**bit`` of every thread, in place."""
    cells = np.arange(rows.shape[1])
    c_lo = cells[(cells >> bit) & 1 == 0]
    r_lo, r_hi = rows[:, c_lo].reshape(-1), rows[:, c_lo | (1 << bit)].reshape(-1)
    desc = torch.from_numpy((r_lo & stage) != 0)[:, None]
    k_lo, k_hi, p_lo, p_hi = keys[r_lo], keys[r_hi], payload[r_lo], payload[r_hi]
    swap = (k_lo > k_hi) != desc
    keys[r_lo], keys[r_hi] = torch.where(swap, k_hi, k_lo), torch.where(swap, k_lo, k_hi)
    payload[r_lo], payload[r_hi] = (torch.where(swap, p_hi, p_lo),
                                    torch.where(swap, p_lo, p_hi))


@pytest.mark.parametrize("pod_rows", POD_ROWS)
def test_executing_the_sort_plan_equals_the_plain_network(pod_rows):
    """Each launch run the way its kernel runs it (a thread's rows from the
    window, steps between its cells) gives the plain network's keys and
    payload; two pods, so both directions."""
    nrows, ncols = 2 * pod_rows, 3
    rng = np.random.default_rng(pod_rows)
    keys = torch.from_numpy(
        rng.permutation(nrows * ncols).reshape(nrows, ncols).astype(np.float32))
    payload = torch.arange(nrows * ncols, dtype=torch.int32).reshape(nrows, ncols)
    want_k, want_p = sort_study.bitonic_pod_sort_plain(keys, payload, pod_rows)
    k, p = keys.clone(), payload.clone()
    # a chunk may pass the end of a small array: rows that do not exist
    chunk_rows = sort_study.sort_chunk_rows(pod_rows)
    padded = -(-nrows // chunk_rows) * chunk_rows
    k = torch.cat([k, torch.zeros((padded - nrows, ncols))])
    p = torch.cat([p, torch.zeros((padded - nrows, ncols), dtype=torch.int32)])
    for launch in sort_study.sort_plan(pod_rows):
        if launch["kind"] == "wide":
            rows = _cell_rows(padded, launch["bit_lo"], launch["nbits"])
            for stage, stride in launch["steps"]:
                _step_in_registers(k, p, rows, stride.bit_length() - 1
                                   - launch["bit_lo"], stage)
            continue
        for (stage, stride), lo in zip(launch["steps"], launch["windows"]):
            in_chunk = _cell_rows(chunk_rows, lo, sort_study.CELL_BITS)
            rows = (np.arange(0, padded, chunk_rows)[:, None, None]
                    + in_chunk[None]).reshape(-1, in_chunk.shape[1])
            _step_in_registers(k, p, rows, stride.bit_length() - 1 - lo, stage)
    assert torch.equal(k[:nrows], want_k) and torch.equal(p[:nrows], want_p)


def test_compare_exchange_plain_is_one_step_of_the_network():
    keys = torch.tensor([[3.0], [1.0], [2.0], [4.0]])
    payload = torch.arange(4, dtype=torch.int32).reshape(4, 1)
    k, p = sort_study.compare_exchange_plain(keys, payload, 2, 1)
    # rows 0, 1 ascending (bit 2 of row 0 clear), rows 2, 3 descending
    assert k.reshape(-1).tolist() == [1.0, 3.0, 4.0, 2.0]
    assert p.reshape(-1).tolist() == [1, 0, 3, 2]
    k, p = sort_study.compare_exchange_plain(k, p, 4, 2)
    assert k.reshape(-1).tolist() == [1.0, 2.0, 4.0, 3.0]


@pytest.mark.parametrize("lo", range(7))
def test_chunk_image_is_a_permutation_without_bank_conflicts(lo):
    """The swizzled place of a row in the chunk's shared-memory image
    (``row ^ row_fold(row)`` in ``csrc/sort_study.cu``): a permutation of the
    rows, linear over XOR (the kernel adds a cell's offset to its thread's
    with one XOR), and for every window the 32 threads of a warp, reading the
    same cell, hit 32 different banks."""
    def place(r):
        return r ^ ((r >> 4) & 3)

    rows = np.arange(sort_study.CHUNK_ROWS)
    assert sorted(place(rows)) == list(rows)
    a, b = rows[:, None], rows[None, ::37]
    assert np.array_equal(place(a ^ b), place(a) ^ place(b))
    held = _cell_rows(sort_study.CHUNK_ROWS, lo, sort_study.CELL_BITS)
    tid = np.arange(sort_study.CHUNK_ROWS // 2)
    col, rest = tid & 7, tid >> 3
    for c in range(held.shape[1]):
        word = place(held[rest, c]) * 8 + col  # 4-byte words of the image
        banks = (word % 32).reshape(-1, 32)    # one row a warp
        assert all(len(set(w)) == 32 for w in banks)


def test_sort_constants_agree_with_the_cuda_source():
    src = (_build.CSRC_DIR / "sort_study.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kMaxChunkRows") == sort_study.CHUNK_ROWS
    assert const("kCellBits") == sort_study.CELL_BITS
    assert const("kMaxWindows") == (sort_study.CHUNK_ROWS.bit_length() - 1
                                    - sort_study.CELL_BITS + 1)
    longest = max(len(l["steps"]) for pod in POD_ROWS
                  for l in sort_study.sort_plan(pod) if l["kind"] == "chunk")
    assert longest == 55 <= const("kMaxChunkSteps")


def test_tied_ranks_constants_agree_with_the_cuda_source():
    """K12's wrapper sizes the tiles, the scatter's buckets and cursors,
    the table's limit and the modes as ``csrc/tied_ranks.cu`` does."""
    src = (_build.CSRC_DIR / "tied_ranks.cu").read_text()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)

    assert int(const("kThreads")) * int(const("kItems")) == tiedrank._TILE
    assert 1 << int(const("kLogBucket")) == tiedrank._BUCKET
    assert const("kTableMaxN") == "1 << 22" and tiedrank._TABLE_MAX_N == 2**22
    modes = re.search(r"enum Mode \{([^}]*)\}", src).group(1)
    assert modes.replace(" ", "") == (
        f"kRanks={tiedrank._RANKS},kBlomTable={tiedrank._BLOM_TABLE},"
        f"kBlomNdtri={tiedrank._BLOM_NDTRI}")


def test_merge_count_tile_agrees_with_the_cuda_source():
    """K14's wrapper sizes its partition by the tile that
    ``csrc/merge_count.cu`` merges a block: threads x entries a thread."""
    from mcmcdiagnostictools_jl_tpu_torch.kernels import mergecount

    src = (_build.CSRC_DIR / "merge_count.cu").read_text()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)

    assert const("kTile") == "kThreads * kPer"
    assert int(const("kThreads")) * int(const("kPer")) == mergecount._TILE


def test_ablation_macros_are_in_the_cuda_source():
    """Every macro ``sort_microbench.ablate_chunk_launch`` defines is tested
    by ``csrc/sort_study.cu``."""
    from mcmcdiagnostictools_jl_tpu_torch.benchmarks import sort_microbench

    src = (_build.CSRC_DIR / "sort_study.cu").read_text()
    assert sort_microbench.ABLATIONS["whole"] == ()
    for defines in sort_microbench.ABLATIONS.values():
        for macro in defines:
            assert f"#ifdef {macro}" in src


@pytest.mark.parametrize("pod_rows", [0, 1, 3, 12, -4])
def test_sort_plan_rejects_pod_rows(pod_rows):
    with pytest.raises(ValueError):
        sort_study.sort_plan(pod_rows)


def test_sass_mix_counts_opcodes_and_one_bank_ffmas():
    """``benchmarks/sass_mix.kernel_mix`` on a hand-made listing: opcodes by
    kernel, and the FFMAs whose three sources share a register bank (parity)
    unless the reuse cache serves one."""
    from mcmcdiagnostictools_jl_tpu_torch.benchmarks import sass_mix

    sass = """
\tFunction : _Z5otherv
        /*0000*/                   FFMA R0, R2, R4, R0 ;
\tFunction : _Z21direct_autocov_kernelv
        /*0000*/                   LDS R5, [R20+0x80] ;
        /*0010*/                   FADD R2, R5, -R9 ;
        /*0020*/                   FFMA R0, R2.reuse, R4, R0 ;
        /*0030*/                   FFMA R6, R2, R8, R6 ;
        /*0040*/                   FFMA R1, R3, R4, R6 ;
        /*0050*/                   FFMA R10, R12, R14, R10 ;
        /*0060*/              @P0  BRA 0x10 ;
        /*0070*/                   EXIT ;
"""
    mix = sass_mix.kernel_mix(sass, "autocov_kernel")
    assert list(mix) == ["_Z21direct_autocov_kernelv"]
    m = mix["_Z21direct_autocov_kernelv"]
    assert m["instructions"] == 8 and m["ffma"] == 4
    assert m["opcodes"]["LDS"] == 1 and m["opcodes"]["BRA"] == 1
    # 0x20 and 0x50 read three even registers; 0x30 has R2 from the cache
    assert m["ffma_one_bank"] == 2
    # the loop from 0x10 to the branch at 0x60: all but the LDS and the EXIT
    hot = m["hot_loop"]
    assert hot["instructions"] == 6 and hot["ffma"] == 4
    assert hot["opcodes"]["LDS"] == 0 and hot["ffma_one_bank"] == 2


# ---- every source ----------------------------------------------------------

@pytest.mark.parametrize("source", sorted(
    p.name for p in Path(_build.CSRC_DIR).glob("*.cu")))
def test_every_entry_point_of_a_source_has_a_signature(source):
    """Each ``extern "C"`` function of the CUDA sources is declared to
    ctypes with as many arguments as it takes."""
    src = (_build.CSRC_DIR / source).read_text()
    found = re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src)
    assert found
    for name, args in found:
        assert len(_build._SIGNATURES[name]) == len(args.split(","))
