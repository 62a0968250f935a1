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
// column is a 512-byte-strided read, so the pod is split: a block sorts a
// chunk of up to 2048 rows x 8 columns (32-byte row pieces, 128 KB) in shared
// memory, which covers every compare-exchange with a stride below the chunk,
// and the wider strides run one launch each through device memory, coalesced
// along the columns. At pod_rows 16,384 that is 4 chunk launches and 6 wide
// steps, at 32,768 5 and 10: 10 or 15 passes of 2.15 GB. What bounds it on an
// H100 (PERF.md has the times) is first the compare-exchange steps in shared
// memory, four loads and up to four stores a pair and a block-wide barrier a
// step, 105 or 120 of them; then the chunk launches' 32-byte row pieces,
// which reach half the rate of a full-row pass; the wide steps come last (a
// piece that swaps nothing is not written back). Keeping the last strides of
// every stage in registers and more columns a block are the next steps. NaN
// keys are outside the contract, as on the TPU (`lo > hi`).

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

constexpr int kSortCols = 8;        // columns a chunk block sorts
constexpr int kSortThreads = 1024;

// Compare-exchange of rows lo < hi of one column: the TPU kernel's rule,
// swap = (key_lo > key_hi) != descending.
__device__ __forceinline__ bool must_swap(float k_lo, float k_hi, bool desc) {
  return (k_lo > k_hi) != desc;
}

// One block: rows [chunk * chunk_rows, +chunk_rows) x columns [group *
// kSortCols, +kSortCols) in shared memory, the column group running fastest
// over blockIdx.x, so that blocks in flight together read neighbouring
// 32-byte pieces of the same rows; every compare-exchange of the
// stages stage_lo..stage_hi whose stride is below chunk_rows (for a stage
// beyond the chunk the wider strides have run through device memory before).
// The direction of a pair is bit `stage` of its global row.
__global__ void __launch_bounds__(kSortThreads)
sort_chunk_kernel(float* __restrict__ keys, int* __restrict__ payload,
                  int ncols, int chunk_rows, int stage_lo, int stage_hi) {
  extern __shared__ float sort_smem[];
  float* ks = sort_smem;                                     // (chunk, 8)
  int* ps = reinterpret_cast<int*>(sort_smem + chunk_rows * kSortCols);
  const int groups = (ncols + kSortCols - 1) / kSortCols;
  const size_t row0 = (size_t)(blockIdx.x / groups) * chunk_rows;
  const int col0 = (blockIdx.x % groups) * kSortCols;
  const int cells = chunk_rows * kSortCols;

  for (int v = threadIdx.x; v < cells; v += kSortThreads) {
    const int r = v / kSortCols, c = col0 + v % kSortCols;
    if (c < ncols) {
      ks[v] = keys[(row0 + r) * ncols + c];
      ps[v] = payload[(row0 + r) * ncols + c];
    }
  }
  __syncthreads();
  const int pairs = cells / 2;
  for (int stage = stage_lo; stage <= stage_hi; stage *= 2) {
    // strides are powers of two: shifts, not divisions, find a pair's rows
    for (int ls = 31 - __clz(min(stage, chunk_rows)) - 1; ls >= 0; --ls) {
      const int stride = 1 << ls;
      for (int v = threadIdx.x; v < pairs; v += kSortThreads) {
        const int c = v % kSortCols, q = v / kSortCols;  // pair q of column c
        const int r = ((q >> ls) << (ls + 1)) | (q & (stride - 1));
        const int lo = r * kSortCols + c, hi = lo + stride * kSortCols;
        const bool desc = ((row0 + r) & (size_t)stage) != 0;
        const float k_lo = ks[lo], k_hi = ks[hi];
        if (col0 + c < ncols && must_swap(k_lo, k_hi, desc)) {
          ks[lo] = k_hi;
          ks[hi] = k_lo;
          const int p_lo = ps[lo];
          ps[lo] = ps[hi];
          ps[hi] = p_lo;
        }
      }
      __syncthreads();
    }
  }
  for (int v = threadIdx.x; v < cells; v += kSortThreads) {
    const int r = v / kSortCols, c = col0 + v % kSortCols;
    if (c < ncols) {
      keys[(row0 + r) * ncols + c] = ks[v];
      payload[(row0 + r) * ncols + c] = ps[v];
    }
  }
}

// One compare-exchange step of stride 2^log_stride (in rows) of stage `stage`
// through device memory: a thread takes one 16-byte piece of a row pair.
__global__ void __launch_bounds__(256)
sort_wide_step_kernel(float* __restrict__ keys, int* __restrict__ payload,
                      size_t npairs, int row_vecs, int log_stride, int stage) {
  const size_t v = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= npairs * row_vecs) return;
  const size_t q = v / row_vecs;
  const int w = (int)(v - q * row_vecs);
  const size_t stride = (size_t)1 << log_stride;
  const size_t r = ((q >> log_stride) << (log_stride + 1)) | (q & (stride - 1));
  const bool desc = (r & (size_t)stage) != 0;
  float4* k_lo = reinterpret_cast<float4*>(keys) + r * row_vecs + w;
  float4* k_hi = k_lo + stride * row_vecs;
  int4* p_lo = reinterpret_cast<int4*>(payload) + r * row_vecs + w;
  int4* p_hi = p_lo + stride * row_vecs;
  float4 a = *k_lo, b = *k_hi;
  int4 pa = *p_lo, pb = *p_hi;
  bool any = false;
#define MDT_CMPX(f)                      \
  if (must_swap(a.f, b.f, desc)) {       \
    const float tk = a.f; a.f = b.f; b.f = tk; \
    const int tp = pa.f; pa.f = pb.f; pb.f = tp; \
    any = true;                          \
  }
  MDT_CMPX(x) MDT_CMPX(y) MDT_CMPX(z) MDT_CMPX(w)
#undef MDT_CMPX
  if (any) {
    *k_lo = a; *k_hi = b;
    *p_lo = pa; *p_hi = pb;
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

// K9: in place, the bitonic sort of every pod of pod_rows rows along dim 0,
// even pods ascending, odd pods descending. pod_rows is a power of two >= 2
// that divides nrows; ncols % 4 == 0. Returns the first CUDA error.
extern "C" int mdt_bitonic_pod_sort(float* keys, int* payload, long long nrows,
                                    int ncols, int pod_rows, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int chunk_rows = pod_rows < 2048 ? pod_rows : 2048;
  const size_t smem = (size_t)chunk_rows * kSortCols * 8;
  cudaError_t err = cudaFuncSetAttribute(
      sort_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 chunk_grid((unsigned)(nrows / chunk_rows *
                                   ((ncols + kSortCols - 1) / kSortCols)));
  const int row_vecs = ncols / 4;
  const size_t npairs = (size_t)nrows / 2;
  const unsigned wide_blocks =
      (unsigned)((npairs * row_vecs + 255) / 256);

  // every stage that fits a chunk in one launch
  sort_chunk_kernel<<<chunk_grid, kSortThreads, smem, st>>>(
      keys, payload, ncols, chunk_rows, 2, chunk_rows);
  for (int stage = 2 * chunk_rows; stage <= pod_rows; stage *= 2) {
    for (int stride = stage / 2; stride >= chunk_rows; stride /= 2)
      sort_wide_step_kernel<<<wide_blocks, 256, 0, st>>>(
          keys, payload, npairs, row_vecs, 31 - __builtin_clz(stride), stage);
    sort_chunk_kernel<<<chunk_grid, kSortThreads, smem, st>>>(
        keys, payload, ncols, chunk_rows, stage, stage);
  }
  return (int)cudaGetLastError();
}
