// Kernels K7, K8 and K9: what a hand-written column sort costs on Hopper: one
// pass of traffic through shared memory (K7 strided, K8 contiguous) and the
// bitonic sort of pods along dim 0 (K9).
//
// They replace the Pallas kernels of benchmarks/sort_microbench.py:
// `_pass_kernel` (`bench_dma_pass`), `_pass_kernel_contig` (`bench_dma_contig`)
// and `_phase_a_kernel` (`bench_phase_a`).
//
// Arrays: keys (N, C) float32 and payload (N, C) int32, row-major, C a
// multiple of 4 (rows are copied in 16-byte pieces), all worked on in place.
//
// K7 / K8, the pass: every element goes to shared memory, is touched there
// (keys + 1, payload + 1) and is written back. Bytes bound it: each array read
// once and written once, 2.15 GB at N = 1,048,576, C = 128. The TPU kernel
// moved a pod of K tiles of 2048 rows (32 MB) into VMEM with one DMA a tile
// and a semaphore; a block here has 227 KB, so the pod is re-sized, not
// copied: a task of the TPU-shaped grid takes K segments of `seg_rows` rows
// that lie `stride_tiles` tiles apart (K7), or one run of K * seg_rows rows
// (K8). The geometry (K, stride) decides only the order memory is walked:
// task t = g * nslots + x is slot x of the TPU's pod g, whose tiles are
// (hi * K + j) * stride + lo. The DMA's counterpart on Hopper is the TMA: one
// thread asks for a whole segment (`cp.async.bulk`, 1-D, since a segment is
// contiguous), the copy reports its bytes to an mbarrier, and no other
// thread spends a register or an instruction on it. The design:
// - a persistent grid (the SMs times the blocks an SM holds) walks the tasks
//   in the TPU grid's order: a counter hands them out, so a block that
//   finds memory faster takes more of them (block b taking the tasks b, b +
//   grid, ... was measured 2-3 % slower: the slowest block sets the pace);
// - a block holds a ring of S >= 2 stages, each `stage_segs` segments of one
//   task (keys, then payload). A loader thread keeps the loads of the next
//   stages in flight while 8 consumer warps touch a stage in 16-byte pieces;
// - a touched stage goes back by bulk stores (shared to global, one bulk
//   group a stage), issued by a storer thread once every consumer has
//   fenced its writes for the async proxy and arrived on the stage's second
//   mbarrier; the storer frees a slot on a third mbarrier when its store has
//   read it (`cp.async.bulk.wait_group.read`), so that waiting for a store
//   never holds up a load;
// - the copies carry no L2 hint: though the stream is 43 times the 50 MB L2,
//   evict-first on loads and stores was measured 1.5-2 % slower.
// Stage size, stage count and grid are planned in Python (`pass_plan` in
// kernels/sort_study.py) and tested there. Timing studies only:
// MDT_PASS_EVICT_FIRST adds the hint, MDT_PASS_STG replaces the bulk store by
// 16-byte stores from the consumers' registers, MDT_PASS_STORE_DEPTH sets
// how many stores may still be reading before the oldest slot is freed,
// MDT_PASS_STATIC_WALK gives block b the tasks b, b + grid, ...
//
// K9, the pod sort: the bitonic network over the rows of every pod of
// `pod_rows` rows, each column on its own, payload carried with its key; a
// pod's direction is its index's parity (the network over the global row
// index, cut off at stage pod_rows). The TPU held a whole pod x 128 columns in
// VMEM. Here one column of 16,384 rows with its payload is 128 KB, and a lone
// column is a 512-byte-strided read, so the pod is split: a block owns a
// chunk of up to 1024 rows x 8 columns (64 KB with the payload), which
// covers every compare-exchange with a stride below the chunk, and the wider
// strides run through device memory. What bounds it on an H100 is the number
// of passes through device memory (2.15 GB each at 1,048,576 x 128) and,
// inside a chunk, the instructions of the steps and of the exchanges between
// threads (55 of the 105 or 120 steps belong to the first chunk launch). The
// design:
// - a thread of a chunk block keeps 16 rows of one column, keys and payload,
//   in registers: the rows that differ in 4 neighbouring bits [lo, lo + 4) of
//   the row index. Every step whose stride is one of those bits is a
//   compare-exchange between two registers of one thread: no shared memory,
//   no barrier;
// - when the next step's stride is outside the window, the block re-deals:
//   every thread writes its cells to their places in the chunk's
//   shared-memory image, ONE barrier, and reads the cells of the new window
//   (a cell is read and later written only by the thread that holds it, so
//   nothing else needs ordering). The stages 2..1024 take 15 windows for 55
//   steps, a later stage 3 for 10;
// - rows are swizzled in the image (row_fold below), so that the 32 threads
//   of a warp hit 32 banks whichever window is in work, and a cell's place is
//   its thread's place XOR a constant of the cell, read from a table;
// - a chunk is loaded with 16-byte cp.async copies, all in flight at once,
//   and stored in 16-byte pieces, the column group running fastest over the
//   grid so that blocks in flight together touch neighbouring 32-byte pieces.
//   Two blocks share an SM (64 KB, 512 threads, 64 registers each), so one's
//   loads and stores run under the other's steps: a chunk of 2048 rows saves
//   a pass through device memory at 16,384-row pods but leaves one block an
//   SM, whose loads, steps and stores then add up (measured slower);
// - a wide pass takes up to 5 strides at once: a thread loads the 32 rows
//   that those strides pair (one column, a warp 32 neighbouring columns: 128
//   bytes a row), runs the steps in registers and writes them back. Pods of
//   16,384 rows take 5 chunk launches and 4 wide passes, 32,768 rows 6 and 5.
// Which launch and which window takes which (stage, stride) is decided in
// Python (`kernels/sort_study.py`, `sort_plan`), tested there, and handed to
// the chunk kernel as a list of steps. NaN keys are outside the contract, as
// on the TPU (`lo > hi`).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mbarrier.cuh"

namespace {

// ---- K7 / K8 ---------------------------------------------------------------

constexpr int kPassConsumers = 256;  // threads that touch a stage
constexpr int kPassThreads = kPassConsumers + 64;  // a loader and a storer warp
constexpr int kPassMaxStages = 16;
// full[], touched[], empty[] (one mbarrier of each a slot) and the stage
// each slot holds (task * parts + part; -1: the walk is over)
constexpr int kPassBarrierBytes = 4 * kPassMaxStages * 8;
// bulk stores the storer leaves reading shared memory before it frees the
// oldest one's slot
#ifndef MDT_PASS_STORE_DEPTH
#define MDT_PASS_STORE_DEPTH 1
#endif
constexpr int kPassStoreDepth = MDT_PASS_STORE_DEPTH;

// The walk, as `pass_plan` lays it out: `tasks` tasks of nseg segments of
// seg_rows rows, each taken in `parts` stages of stage_segs segments; K7's
// task t is slot t % nslots of pod t / nslots.
struct PassWalk {
  long long tasks;
  int ncols, nseg, seg_rows, tile_rows, stride_tiles, nslots;
  int stage_segs, parts, stages;
};

using mdt::mbar_arrive;
using mdt::mbar_arrive_expect_tx;
using mdt::mbar_init;
using mdt::mbar_wait;
using mdt::smem_u32;

// The copies' L2 policy: evict-first in the timing study, else unused.
__device__ __forceinline__ uint64_t l2_policy() {
  uint64_t policy = 0;
#ifdef MDT_PASS_EVICT_FIRST
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
#endif
  return policy;
}

// Global to shared, completing `bytes` on the mbarrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar,
                                          uint64_t policy) {
#ifdef MDT_PASS_EVICT_FIRST
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
#else
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
#endif
}

// Shared to global, in the current bulk group.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes, uint64_t policy) {
#ifdef MDT_PASS_EVICT_FIRST
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint "
      "[%0], [%1], %2, %3;\n" ::"l"(dst),
      "r"(src), "r"(bytes), "l"(policy)
      : "memory");
#else
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
#endif
}

// First row of segment j of task t.
template <bool kStrided>
__device__ __forceinline__ size_t pass_row(const PassWalk& w, long long t,
                                           int j) {
  if (!kStrided) return ((size_t)t * w.nseg + j) * w.seg_rows;
  const long long g = t / w.nslots;
  const long long x = t - g * w.nslots;
  const long long lo = g % w.stride_tiles, hi = g / w.stride_tiles;
  const size_t tile = ((size_t)hi * w.nseg + j) * w.stride_tiles + lo;
  return tile * w.tile_rows + (size_t)x * w.seg_rows;
}

// The bulk copies of part `part` of task t in the ring slot at `slot`: keys
// at the slot's start, payload half a stage on. K7 copies each segment on
// its own, K8 the stage's run of segments at once.
template <bool kStrided, bool kStore>
__device__ __forceinline__ void stage_copies(const PassWalk& w, float* keys,
                                             int* payload, long long t,
                                             int part, uint32_t slot,
                                             uint32_t bar, uint64_t policy) {
  const int j0 = part * w.stage_segs;
  const uint32_t seg_bytes = (uint32_t)w.seg_rows * w.ncols * 4;
  const uint32_t half = seg_bytes * w.stage_segs;
  const int copies = kStrided ? w.stage_segs : 1;
  const uint32_t bytes = kStrided ? seg_bytes : half;
  if (!kStore) mbar_arrive_expect_tx(bar, 2 * half);
  for (int c = 0; c < copies; ++c) {
    const size_t at = pass_row<kStrided>(w, t, j0 + c) * w.ncols;
    const uint32_t k_at = slot + c * bytes;
    if (kStore) {
      bulk_store(keys + at, k_at, bytes, policy);
      bulk_store(payload + at, k_at + half, bytes, policy);
    } else {
      bulk_load(k_at, keys + at, bytes, bar, policy);
      bulk_load(k_at + half, payload + at, bytes, bar, policy);
    }
  }
}

#ifdef MDT_PASS_STG
// Float index of 16-byte piece v of part `part` of task t (timing study).
template <bool kStrided>
__device__ __forceinline__ size_t piece_at(const PassWalk& w, long long t,
                                           int part, int v) {
  const int j0 = part * w.stage_segs;
  const int seg_vecs = w.seg_rows * w.ncols / 4;
  const int c = kStrided ? v / seg_vecs : 0;
  return pass_row<kStrided>(w, t, j0 + c) * w.ncols +
         (size_t)(v - c * seg_vecs) * 4;
}
#endif

// Shared memory: the 3 * kPassMaxStages mbarriers and the slots' stages,
// then `stages` slots of stage_segs * seg_rows * ncols * 8 bytes. The i-th
// stage of this block lives in slot i % stages; its use k = i / stages of
// the slot is phase k of the slot's mbarriers: full (the loads' bytes have
// landed), touched (every consumer warp is done), empty (its store has read
// the slot). The loader ends the walk with a stage marked -1.
// next_task[0] (zero at launch) hands out the tasks in order; next_task[1]
// counts the blocks done, and the last one sets both back to zero.
template <bool kStrided>
__global__ void __launch_bounds__(kPassThreads)
pass_kernel(float* __restrict__ keys, int* __restrict__ payload,
            unsigned long long* __restrict__ next_task, const PassWalk w) {
  extern __shared__ __align__(128) unsigned char pass_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(pass_smem);
  uint64_t* touched = full + kPassMaxStages;
  uint64_t* empty = touched + kPassMaxStages;
  long long* stage_of = reinterpret_cast<long long*>(empty + kPassMaxStages);
  unsigned char* ring = pass_smem + kPassBarrierBytes;
  const uint32_t stage_bytes =
      (uint32_t)w.stage_segs * w.seg_rows * w.ncols * 8;

  if (threadIdx.x == 0) {
    for (int s = 0; s < w.stages; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(touched + s), kPassConsumers / 32);
      mbar_init(smem_u32(empty + s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kPassConsumers) {
    if (threadIdx.x % 32) return;
    const uint64_t policy = l2_policy();
    if (threadIdx.x == kPassConsumers) {  // the loader
      long long i = 0;
#ifdef MDT_PASS_STATIC_WALK  // timing study: block b takes b, b + grid, ...
      for (long long t = blockIdx.x; t < w.tasks; t += gridDim.x) {
#else
      for (long long t;
           (t = (long long)atomicAdd(next_task, 1ULL)) < w.tasks;) {
#endif
        for (int part = 0; part < w.parts; ++part, ++i) {
          const int s = (int)(i % w.stages);
          if (i >= w.stages)
            mbar_wait(smem_u32(empty + s), (uint32_t)(i / w.stages - 1) & 1);
          stage_of[s] = t * w.parts + part;
          stage_copies<kStrided, false>(
              w, keys, payload, t, part,
              smem_u32(ring + (size_t)s * stage_bytes), smem_u32(full + s),
              policy);
        }
      }
      const int s = (int)(i % w.stages);
      if (i >= w.stages)
        mbar_wait(smem_u32(empty + s), (uint32_t)(i / w.stages - 1) & 1);
      stage_of[s] = -1;
      mbar_arrive(smem_u32(full + s));
      // every block has taken its last task once all have come here
      if (atomicAdd(next_task + 1, 1ULL) == gridDim.x - 1) {
        atomicExch(next_task, 0ULL);
        atomicExch(next_task + 1, 0ULL);
      }
      return;
    }
    // the storer
    for (long long i = 0;; ++i) {
      const int s = (int)(i % w.stages);
      mbar_wait(smem_u32(touched + s), (uint32_t)(i / w.stages) & 1);
      const long long id = stage_of[s];
      if (id < 0) break;
#ifdef MDT_PASS_STG
      mbar_arrive(smem_u32(empty + s));
#else
      stage_copies<kStrided, true>(
          w, keys, payload, id / w.parts, (int)(id % w.parts),
          smem_u32(ring + (size_t)s * stage_bytes), 0, policy);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      if (i >= kPassStoreDepth) {
        asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(
                         kPassStoreDepth)
                     : "memory");
        mbar_arrive(smem_u32(empty + (i - kPassStoreDepth) % w.stages));
      }
#endif
    }
    // the last stages' slots are loaded no more; their stores must land
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    return;
  }

  // the consumers: touch each stage in 16-byte pieces
  const int vecs = (int)(stage_bytes / 32);  // pieces of one array a stage
  for (long long i = 0;; ++i) {
    const int s = (int)(i % w.stages);
    mbar_wait(smem_u32(full + s), (uint32_t)(i / w.stages) & 1);
    const long long id = stage_of[s];
    if (id >= 0) {
      float4* ks = reinterpret_cast<float4*>(ring + (size_t)s * stage_bytes);
      int4* ps = reinterpret_cast<int4*>(ring + (size_t)s * stage_bytes +
                                         stage_bytes / 2);
      for (int v = threadIdx.x; v < vecs; v += kPassConsumers) {
        float4 k = ks[v];
        int4 p = ps[v];
        k.x += 1.f; k.y += 1.f; k.z += 1.f; k.w += 1.f;
        p.x += 1; p.y += 1; p.z += 1; p.w += 1;
#ifdef MDT_PASS_STG
        const size_t at =
            piece_at<kStrided>(w, id / w.parts, (int)(id % w.parts), v);
        *reinterpret_cast<float4*>(keys + at) = k;
        *reinterpret_cast<int4*>(payload + at) = p;
#else
        ks[v] = k;
        ps[v] = p;
#endif
      }
#ifndef MDT_PASS_STG
      // this thread's writes, visible to the bulk store (the async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#endif
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(smem_u32(touched + s));
    if (id < 0) return;
  }
}

template <bool kStrided>
int pass_occupancy(int smem, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      pass_kernel<kStrided>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, pass_kernel<kStrided>, kPassThreads, (size_t)smem);
}

template <bool kStrided>
int launch_pass(float* keys, int* payload, unsigned long long* next_task,
                const PassWalk& w, int grid, cudaStream_t stream) {
  const int smem =
      kPassBarrierBytes + w.stages * w.stage_segs * w.seg_rows * w.ncols * 8;
  cudaError_t err = cudaFuncSetAttribute(
      pass_kernel<kStrided>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  pass_kernel<kStrided><<<grid, kPassThreads, smem, stream>>>(
      keys, payload, next_task, w);
  return (int)cudaGetLastError();
}

// ---- K9's copies -------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---- K9 --------------------------------------------------------------------

constexpr int kSortCols = 8;     // columns a chunk block sorts
constexpr int kCellBits = 4;     // a thread holds 2^4 rows of one column
constexpr int kCells = 1 << kCellBits;
constexpr int kMaxChunkRows = 1024;
constexpr int kMaxWindows = 7;      // window starts 0..6 (10 row bits)
constexpr int kMaxChunkSteps = 64;  // 55 for the stages 2..1024
// the image: keys at byte 0, payload at this byte, whatever the chunk's size,
// so that a cell's payload is its key's address plus a constant
constexpr int kPayloadAt = kMaxChunkRows * kSortCols * 4;

// The steps of one chunk launch, in order: step i is the compare-exchange of
// stage 2^stage_log[i] with stride 2^bit[i], run with the register window
// [lo[i], lo[i] + 4). cell_at[lo][c]: byte offset in the image of chunk row
// c << lo, column 0 (the launcher fills it in).
struct ChunkSteps {
  int n;
  int cell_at[kMaxWindows][kCells];
  unsigned char stage_log[kMaxChunkSteps];
  unsigned char bit[kMaxChunkSteps];
  unsigned char lo[kMaxChunkSteps];
};

// Compare-exchange of rows lo < hi of one column: the TPU kernel's rule,
// swap = (key_lo > key_hi) != descending.
__device__ __forceinline__ void cmpx(float& k_lo, float& k_hi, int& p_lo,
                                     int& p_hi, bool desc) {
  const bool swap = (k_lo > k_hi) != desc;
  const float nk_lo = swap ? k_hi : k_lo, nk_hi = swap ? k_lo : k_hi;
  const int np_lo = swap ? p_hi : p_lo, np_hi = swap ? p_lo : p_hi;
  k_lo = nk_lo; k_hi = nk_hi;
  p_lo = np_lo; p_hi = np_hi;
}

// A row's place in the shared-memory image of a chunk is row ^
// row_fold(row): its two low bits XOR its bits 4 and 5. A warp's threads
// differ in the column (8 banks) and in the two lowest row bits outside the
// window [lo, lo + 4): bits 4 and 5 when lo is 0, bits 0 and 5 when lo is 1,
// bits 0 and 1 from lo = 2 on; either way their places differ in the two low
// bits, so they hit 32 banks. The fold is linear over XOR, so the place of
// base | (c << lo) is the place of base XOR the place of c << lo.
__host__ __device__ __forceinline__ unsigned row_fold(unsigned row) {
  return (row >> 4) & 3u;
}

// One step on the cells of a thread: cells c and c | 2^kBit are rows
// 2^(lo + kBit) apart. The direction is bit `dir_bit` of the cell index where
// the stage lies inside the window (dir_bit >= 0; only the stages 2, 4 and 8
// in the window [0, 4) do), else `desc` for every cell.
template <int kBit>
__device__ __forceinline__ void step_in_registers(float (&k)[kCells],
                                                  int (&p)[kCells], bool desc,
                                                  int dir_bit) {
  if (dir_bit < 0) {
#pragma unroll
    for (int c = 0; c < kCells; ++c) {
      if (c & (1 << kBit)) continue;
      cmpx(k[c], k[c | (1 << kBit)], p[c], p[c | (1 << kBit)], desc);
    }
  } else {
#pragma unroll
    for (int c = 0; c < kCells; ++c) {
      if (c & (1 << kBit)) continue;
      cmpx(k[c], k[c | (1 << kBit)], p[c], p[c | (1 << kBit)],
           ((c >> dir_bit) & 1) != 0);
    }
  }
}

// One block: rows [chunk * chunk_rows, +chunk_rows) x columns [group *
// kSortCols, +kSortCols), the column group running fastest over blockIdx.x;
// chunk_rows / 2 threads (16 to 1024 rows, 8 to 512 threads; 64 KB of shared
// memory and at most 64 registers a thread, so two blocks share an SM and
// one's loads and stores run under the other's steps). Rows at or past
// nrows and columns at or past ncols are neither loaded nor stored; the
// cells that stand for them hold whatever shared memory held and meet only
// each other (pods are whole).
__global__ void __launch_bounds__(kMaxChunkRows / 2, 2)
sort_chunk_kernel(float* __restrict__ keys, int* __restrict__ payload,
                  long long nrows, int ncols, int chunk_rows,
                  const ChunkSteps steps) {
  extern __shared__ float4 sort_smem[];
  char* image = reinterpret_cast<char*>(sort_smem);
  constexpr int kPieces = kSortCols / 4;  // 16-byte pieces a row
  const int groups = (ncols + kSortCols - 1) / kSortCols;
  const long long row0 = (long long)(blockIdx.x / groups) * chunk_rows;
  const int col0 = (blockIdx.x % groups) * kSortCols;
  const int tid = threadIdx.x, nthreads = blockDim.x;

  // the chunk's image, in 16-byte pieces
  for (int v = tid; v < chunk_rows * kPieces; v += nthreads) {
    const unsigned r = v / kPieces;
    const int h = (v % kPieces) * 4;
    if (row0 + r < nrows && col0 + h < ncols) {
      const size_t at = (size_t)(row0 + r) * ncols + col0 + h;
      char* to = image + ((r ^ row_fold(r)) * kSortCols + h) * 4;
      cp_async16(to, keys + at);
      cp_async16(to + kPayloadAt, payload + at);
    }
  }
  cp_async_wait_all();

  const int col = tid % kSortCols;
  const unsigned rest = tid / kSortCols;  // the row bits outside the window
  float k[kCells];
  int p[kCells];
  int lo = -1;
  unsigned base = 0;  // chunk row of cell 0
  char* cell0 = image;  // its key in the image
  for (int i = 0; i < steps.n; ++i) {
    const int new_lo = steps.lo[i];
#ifdef MDT_SORT_NO_REDEALS  // timing study: one deal, wrong results
    if (lo < 0) {
#else
    if (new_lo != lo) {
#endif
      if (lo >= 0) {
#pragma unroll
        for (int c = 0; c < kCells; ++c) {
          char* at = image + ((unsigned)(cell0 - image) ^ steps.cell_at[lo][c]);
          *reinterpret_cast<float*>(at) = k[c];
          *reinterpret_cast<int*>(at + kPayloadAt) = p[c];
        }
      }
      __syncthreads();  // every cell is in the image
      lo = new_lo;
      base = ((rest >> lo) << (lo + kCellBits)) | (rest & ((1u << lo) - 1u));
      cell0 = image + ((base ^ row_fold(base)) * kSortCols + col) * 4;
#pragma unroll
      for (int c = 0; c < kCells; ++c) {
        const char* at =
            image + ((unsigned)(cell0 - image) ^ steps.cell_at[lo][c]);
        k[c] = *reinterpret_cast<const float*>(at);
        p[c] = *reinterpret_cast<const int*>(at + kPayloadAt);
      }
    }
    const int stage_log = steps.stage_log[i];
    const bool desc = ((((unsigned)row0 | base) >> stage_log) & 1u) != 0;
    const int dir_bit = stage_log < lo + kCellBits ? stage_log - lo : -1;
#ifdef MDT_SORT_NO_STEPS  // timing study: no compare-exchange, wrong results
    if (desc && dir_bit == 77) k[0] = 0.f;  // never true; keeps both computed
#else
    switch (steps.bit[i] - lo) {
      case 0: step_in_registers<0>(k, p, desc, dir_bit); break;
      case 1: step_in_registers<1>(k, p, desc, dir_bit); break;
      case 2: step_in_registers<2>(k, p, desc, dir_bit); break;
      default: step_in_registers<3>(k, p, desc, dir_bit); break;
    }
#endif
  }
#pragma unroll
  for (int c = 0; c < kCells; ++c) {
    char* at = image + ((unsigned)(cell0 - image) ^ steps.cell_at[lo][c]);
    *reinterpret_cast<float*>(at) = k[c];
    *reinterpret_cast<int*>(at + kPayloadAt) = p[c];
  }
  __syncthreads();
  for (int v = tid; v < chunk_rows * kPieces; v += nthreads) {
    const unsigned r = v / kPieces;
    const int h = (v % kPieces) * 4;
    if (row0 + r < nrows && col0 + h < ncols) {
      const size_t at = (size_t)(row0 + r) * ncols + col0 + h;
      const char* from = image + ((r ^ row_fold(r)) * kSortCols + h) * 4;
      *reinterpret_cast<float4*>(keys + at) =
          *reinterpret_cast<const float4*>(from);
      *reinterpret_cast<int4*>(payload + at) =
          *reinterpret_cast<const int4*>(from + kPayloadAt);
    }
  }
}

// One pass through device memory for the kBits strides 2^(bit_lo + kBits -
// 1), ..., 2^bit_lo of stage `stage` (all below the stage): a thread takes the
// 2^kBits rows of one column that those strides pair, neighbouring threads
// neighbouring columns. The direction is one bit above the window: the same
// for all of a thread's rows.
template <int kBits>
__global__ void __launch_bounds__(256)
sort_wide_kernel(float* __restrict__ keys, int* __restrict__ payload,
                 size_t ngroups, int ncols, int bit_lo, size_t stage) {
  constexpr int kRows = 1 << kBits;
  const size_t v = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= ngroups * ncols) return;
  const size_t q = v / ncols;
  const int col = (int)(v - q * ncols);
  const size_t row = ((q >> bit_lo) << (bit_lo + kBits)) |
                     (q & (((size_t)1 << bit_lo) - 1));
  const bool desc = (row & stage) != 0;
  const size_t step = ((size_t)ncols) << bit_lo;  // elements between cells
  float* kp = keys + row * ncols + col;
  int* pp = payload + row * ncols + col;
  float k[kRows];
  int p[kRows];
#pragma unroll
  for (int c = 0; c < kRows; ++c) {
    k[c] = kp[c * step];
    p[c] = pp[c * step];
  }
#pragma unroll
  for (int b = kBits - 1; b >= 0; --b) {
#pragma unroll
    for (int c = 0; c < kRows; ++c) {
      if (c & (1 << b)) continue;
      cmpx(k[c], k[c | (1 << b)], p[c], p[c | (1 << b)], desc);
    }
  }
#pragma unroll
  for (int c = 0; c < kRows; ++c) {
    kp[c * step] = k[c];
    pp[c * step] = p[c];
  }
}

}  // namespace

// K7 (strided != 0) / K8: in place, keys (.., ncols) + 1 and payload + 1 over
// `tasks` tasks of nseg segments of seg_rows rows, in stages of stage_segs
// segments, a ring of `stages` slots, `grid` persistent blocks (the walk of
// `pass_plan`: K7's task t is slot t % nslots of pod t / nslots, its
// segments stride_tiles tiles of tile_rows rows apart; K8's task t the rows
// from t * nseg * seg_rows on). `next_task`: two unsigned 64-bit counters
// on the card, zero, which the launch leaves zero: the blocks take the tasks
// from the first in order. Launches that share them must not overlap (one
// stream). Returns
// cudaErrorInvalidValue for a walk the kernel does not take (both arrays on
// 16-byte boundaries, ncols % 4 == 0, 2 <= stages <= 16, stage_segs dividing
// nseg, the ring within a block's shared memory), else cudaGetLastError().
extern "C" int mdt_sort_pass(float* keys, int* payload, void* next_task,
                             int strided, long long tasks, int ncols,
                             int nseg, int seg_rows, int tile_rows,
                             int stride_tiles, int nslots, int stage_segs,
                             int stages, int grid, void* stream) {
  const long long stage_bytes = (long long)stage_segs * seg_rows * ncols * 8;
  if (((uintptr_t)keys | (uintptr_t)payload) % 16 || !next_task ||
      ncols < 4 || ncols % 4 ||
      tasks < 1 || grid < 1 || seg_rows < 1 || stage_segs < 1 ||
      nseg % stage_segs || stages < 2 || stages > kPassMaxStages ||
      stages <= kPassStoreDepth ||
      kPassBarrierBytes + stages * stage_bytes > 227 * 1024 ||
      (strided && (stride_tiles < 1 || nslots < 1 ||
                   (long long)nslots * seg_rows != tile_rows)))
    return (int)cudaErrorInvalidValue;
  PassWalk w;
  w.tasks = tasks;
  w.ncols = ncols;
  w.nseg = nseg;
  w.seg_rows = seg_rows;
  w.tile_rows = tile_rows;
  w.stride_tiles = stride_tiles;
  w.nslots = nslots;
  w.stage_segs = stage_segs;
  w.parts = nseg / stage_segs;
  w.stages = stages;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* next = (unsigned long long*)next_task;
  return strided ? launch_pass<true>(keys, payload, next, w, grid, st)
                 : launch_pass<false>(keys, payload, next, w, grid, st);
}

// The blocks of the K7 (strided != 0) or K8 kernel an SM holds with `smem`
// bytes of dynamic shared memory, into *blocks (an int).
extern "C" int mdt_sort_pass_occupancy(int strided, int smem, void* blocks) {
  int* out = (int*)blocks;
  return strided ? pass_occupancy<true>(smem, out)
                 : pass_occupancy<false>(smem, out);
}

// K9, a chunk launch: in place, the `nsteps` compare-exchange steps given
// as triples (log2 stage, log2 stride, window start) in `steps`, a host array
// of 3 * nsteps ints, on every chunk of chunk_rows rows (a power of two, 16
// to 1024; every stride below it) x 8 columns. ncols % 4 == 0. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a list that is too long
// or a window outside the chunk.
extern "C" int mdt_sort_chunk(float* keys, int* payload, long long nrows,
                              int ncols, int chunk_rows, int nsteps,
                              const int* steps, void* stream) {
  if (nsteps < 1 || nsteps > kMaxChunkSteps || chunk_rows < kCells ||
      chunk_rows > kMaxChunkRows || (chunk_rows & (chunk_rows - 1)))
    return (int)cudaErrorInvalidValue;
  ChunkSteps plan;
  plan.n = nsteps;
  for (int i = 0; i < nsteps; ++i) {
    const int lo = steps[3 * i + 2], bit = steps[3 * i + 1];
    if (lo < 0 || bit < lo || bit >= lo + kCellBits ||
        (1 << (lo + kCellBits)) > chunk_rows || steps[3 * i] <= bit ||
        steps[3 * i] > 30)
      return (int)cudaErrorInvalidValue;
    plan.stage_log[i] = (unsigned char)steps[3 * i];
    plan.bit[i] = (unsigned char)bit;
    plan.lo[i] = (unsigned char)lo;
  }
  for (int lo = 0; lo < kMaxWindows; ++lo)
    for (int c = 0; c < kCells; ++c) {
      const unsigned r = (unsigned)c << lo;
      plan.cell_at[lo][c] = (int)((r ^ row_fold(r)) * kSortCols * 4);
    }
  const size_t smem = 2 * (size_t)kPayloadAt;
  cudaError_t err = cudaFuncSetAttribute(
      sort_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long chunks = (nrows + chunk_rows - 1) / chunk_rows;
  const unsigned grid =
      (unsigned)(chunks * ((ncols + kSortCols - 1) / kSortCols));
  sort_chunk_kernel<<<grid, chunk_rows / 2, smem, (cudaStream_t)stream>>>(
      keys, payload, nrows, ncols, chunk_rows, plan);
  return (int)cudaGetLastError();
}

// K9, a wide pass: in place, the `nbits` (1 to 5) steps of stage `stage` with
// the strides 2^(bit_lo + nbits - 1), ..., 2^bit_lo through device memory.
// 2^(bit_lo + nbits) divides nrows. Returns cudaGetLastError().
extern "C" int mdt_sort_wide(float* keys, int* payload, long long nrows,
                             int ncols, long long stage, int bit_lo, int nbits,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t ngroups = (size_t)nrows >> nbits;
  const unsigned blocks = (unsigned)((ngroups * ncols + 255) / 256);
  switch (nbits) {
    case 1:
      sort_wide_kernel<1><<<blocks, 256, 0, st>>>(keys, payload, ngroups, ncols,
                                                  bit_lo, (size_t)stage);
      break;
    case 2:
      sort_wide_kernel<2><<<blocks, 256, 0, st>>>(keys, payload, ngroups, ncols,
                                                  bit_lo, (size_t)stage);
      break;
    case 3:
      sort_wide_kernel<3><<<blocks, 256, 0, st>>>(keys, payload, ngroups, ncols,
                                                  bit_lo, (size_t)stage);
      break;
    case 4:
      sort_wide_kernel<4><<<blocks, 256, 0, st>>>(keys, payload, ngroups, ncols,
                                                  bit_lo, (size_t)stage);
      break;
    case 5:
      sort_wide_kernel<5><<<blocks, 256, 0, st>>>(keys, payload, ngroups, ncols,
                                                  bit_lo, (size_t)stage);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
