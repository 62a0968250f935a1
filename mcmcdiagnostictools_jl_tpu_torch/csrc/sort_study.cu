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
// moved a pod of K tiles of 2048 rows (32 MB) into VMEM with one DMA a tile; a
// block here has 227 KB, so the pod is re-sized, not copied: a block gathers
// K segments of `seg_rows` rows that lie `stride_tiles` tiles apart (K7), or
// one run of K * seg_rows rows (K8), with 16-byte `cp.async` copies, all in
// flight at once, then one wait. With 64 KB a block three blocks share an SM,
// so one block's copies overlap another's write-back. The geometry (K, stride)
// decides only the order memory is walked: blockIdx.y is the TPU's pod index
// (tiles (hi * K + j) * stride + lo), blockIdx.x the segment slot in the tile.
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

namespace {

constexpr int kPassThreads = 256;

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

// First row of segment j of this block. Strided (K7): the TPU pod g =
// blockIdx.y holds the tiles (hi * K + j) * stride + lo with lo = g % stride,
// hi = g / stride; the block takes slot blockIdx.x of each. Contiguous (K8):
// the block's run of K * seg_rows rows.
__device__ __forceinline__ size_t segment_row(int j, int nseg, int seg_rows,
                                              int tile_rows, int stride_tiles,
                                              bool strided) {
  if (!strided)
    return ((size_t)blockIdx.x * nseg + j) * seg_rows;
  const int g = blockIdx.y;
  const int lo = g % stride_tiles, hi = g / stride_tiles;
  const size_t tile = ((size_t)hi * nseg + j) * stride_tiles + lo;
  return tile * tile_rows + (size_t)blockIdx.x * seg_rows;
}

// One block: nseg segments of seg_rows rows of both arrays into shared
// memory, touched, written back. Shared memory: nseg * seg_rows * ncols
// floats, then as many ints.
template <bool kStrided>
__global__ void __launch_bounds__(kPassThreads)
pass_kernel(float* __restrict__ keys, int* __restrict__ payload, int ncols,
            int nseg, int seg_rows, int tile_rows, int stride_tiles) {
  extern __shared__ float4 pass_smem[];
  const int row_vecs = ncols / 4;            // 16-byte pieces a row
  const int seg_vecs = seg_rows * row_vecs;  // a segment is contiguous
  const int total = nseg * seg_vecs;
  float4* ks = pass_smem;
  int4* ps = reinterpret_cast<int4*>(pass_smem + total);

  for (int v = threadIdx.x; v < total; v += kPassThreads) {
    const int j = v / seg_vecs, w = v - j * seg_vecs;
    const size_t at = segment_row(j, nseg, seg_rows, tile_rows, stride_tiles,
                                  kStrided) * row_vecs + w;
    cp_async16(ks + v, reinterpret_cast<const float4*>(keys) + at);
    cp_async16(ps + v, reinterpret_cast<const int4*>(payload) + at);
  }
  cp_async_wait_all();
  __syncthreads();  // the whole pod is in shared memory
  for (int v = threadIdx.x; v < total; v += kPassThreads) {
    float4 k = ks[v];
    int4 p = ps[v];
    k.x += 1.f; k.y += 1.f; k.z += 1.f; k.w += 1.f;
    p.x += 1; p.y += 1; p.z += 1; p.w += 1;
    ks[v] = k;
    ps[v] = p;
  }
  __syncthreads();  // touched in place; any thread may write any piece back
  for (int v = threadIdx.x; v < total; v += kPassThreads) {
    const int j = v / seg_vecs, w = v - j * seg_vecs;
    const size_t at = segment_row(j, nseg, seg_rows, tile_rows, stride_tiles,
                                  kStrided) * row_vecs + w;
    reinterpret_cast<float4*>(keys)[at] = ks[v];
    reinterpret_cast<int4*>(payload)[at] = ps[v];
  }
}

template <bool kStrided>
int launch_pass(float* keys, int* payload, int ncols, int nseg, int seg_rows,
                int tile_rows, int stride_tiles, dim3 grid,
                cudaStream_t stream) {
  const size_t smem = (size_t)nseg * seg_rows * ncols * 8;
  cudaError_t err = cudaFuncSetAttribute(
      pass_kernel<kStrided>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  pass_kernel<kStrided><<<grid, kPassThreads, smem, stream>>>(
      keys, payload, ncols, nseg, seg_rows, tile_rows, stride_tiles);
  return (int)cudaGetLastError();
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

// K7: in place, keys (nrows, ncols) + 1 and payload + 1, walked in blocks of
// `pod_tiles` segments of `seg_rows` rows lying `stride_tiles` tiles of
// `tile_rows` rows apart. The caller has checked: ncols % 4 == 0, tile_rows %
// seg_rows == 0, nrows % (tile_rows * pod_tiles * stride_tiles) == 0, and that
// pod_tiles * seg_rows * ncols * 8 bytes fit a block's shared memory. Returns
// cudaGetLastError().
extern "C" int mdt_sort_pass_strided(float* keys, int* payload, long long nrows,
                                     int ncols, int tile_rows, int pod_tiles,
                                     int stride_tiles, int seg_rows,
                                     void* stream) {
  const long long ntiles = nrows / tile_rows;
  const dim3 grid((unsigned)(tile_rows / seg_rows),
                  (unsigned)(ntiles / pod_tiles));
  return launch_pass<true>(keys, payload, ncols, pod_tiles, seg_rows, tile_rows,
                           stride_tiles, grid, (cudaStream_t)stream);
}

// K8: the same pass in contiguous runs of pod_tiles * seg_rows rows; nrows is
// a multiple of that.
extern "C" int mdt_sort_pass_contig(float* keys, int* payload, long long nrows,
                                    int ncols, int pod_tiles, int seg_rows,
                                    void* stream) {
  const dim3 grid((unsigned)(nrows / ((long long)pod_tiles * seg_rows)));
  return launch_pass<false>(keys, payload, ncols, pod_tiles, seg_rows, 0, 1,
                            grid, (cudaStream_t)stream);
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
