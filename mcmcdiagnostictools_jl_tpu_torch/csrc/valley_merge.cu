// Kernel K10: the fold sort of the exact rank mode as a merge, for Hopper.
//
// Stands for the JAX package's `valley_sort_2d`
// (mcmcdiagnostictools_jl_tpu/ops/ranknorm.py:122), which is XLA, not a
// Pallas kernel: the two-axis bitonic-merge decomposition that sorts the
// folded sample |xs - med| in two short sorts.
//
// Input: xs (n, p) float32, each column ascending in torch.sort's order (NaN
// last); order (n, p) int64, the payload riding with xs (the original flat
// row of each value); med (p,) float32. Output: fs (n, p), |xs - med| of each
// column ascending in the same order (NaN last), and forder (n, p), the
// payload carried with it: the keys of valley_sort_2d(|xs - med|, order),
// bit for bit, with the payload of tied keys in another order.
//
// In xs order the folded keys fall, then rise: with k = #{xs < med}, rows
// k-1, k-2, ..., 0 give the run A of keys med - xs, ascending, and rows
// k, ..., n-1 the run B of keys xs - med, ascending, the NaN rows of xs at
// its end. So the sort is one merge of A and B: O(n) work, one read of xs and
// order and one write of fs and forder. A column whose med is NaN has every
// key NaN and k = 0, and keeps its xs order (B alone). Ties go to A first.
//
// Three launches, merge path style:
// 1. valley_split_kernel: k of each column, by binary search on xs;
// 2. valley_partition_kernel: for every tile boundary t = b * kTile and
//    column, how many of the first t outputs come from A (a binary search on
//    the two runs in device memory); tile b then reads A[i_b, i_{b+1}) and
//    B[t_b - i_b, t_{b+1} - i_{b+1}): kTile rows of the column in all;
// 3. valley_merge_kernel: a block (grid x: tiles, y: column groups) owns
//    kCols = 32 columns and one tile of kTile output rows, stages its keys
//    and payloads in shared memory, and each thread merges kPer outputs of
//    one column sequentially after a short search within the tile.
//
// What bounds it on an H100: the bytes, 12 read and 12 written an element
// (2.35 ms at (1.28M, 256)). The layout is the sample's row-major (n, p):
// a column is strided by p floats. Writes go out along rows (the 32 lanes of
// a warp are 32 neighbouring columns of one output row: 128 bytes of fs, 256
// of forder). Reads follow each column's own runs, so the lanes of a warp
// read rows that differ by the columns' offsets; columns of similar
// distributions sit at similar rows, and the L1 keeps the sectors that the
// neighbouring lanes fetch for one another.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;               // columns a block: a warp's lanes
constexpr int kWarps = 8;
// output rows a block, per column (kernels/valley.py's _TILE): 98.7 KB of
// staging, two blocks an SM
constexpr int kTile = 256;
constexpr int kPer = kTile / kWarps;    // outputs a thread merges
constexpr int kStride = kTile + 1;      // padded row of the staging arrays
constexpr size_t kSmemBytes =
    (size_t)kCols * kStride * (sizeof(float) + sizeof(long long));

// torch.sort's ascending order with NaN last: `a` goes no later than `b`
__device__ __forceinline__ bool key_le(float a, float b) {
  return isnan(b) || (!isnan(a) && a <= b);
}

__device__ __forceinline__ float fold(const float* xs, long long row, int p,
                                      int c, float m) {
  return fabsf(xs[(size_t)row * p + c] - m);
}

__global__ void valley_split_kernel(const float* __restrict__ xs, int n,
                                    int p, const float* __restrict__ med,
                                    int* __restrict__ ksplit) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= p) return;
  const float m = med[c];
  int lo = 0, hi = n;  // first row with !(xs < med): NaN rows never count
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (xs[(size_t)mid * p + c] < m) lo = mid + 1; else hi = mid;
  }
  ksplit[c] = lo;
}

// The number of A elements among the first t outputs of column c, A before
// B on equal keys.
__device__ int merge_path(const float* xs, int n, int p, int c, float m,
                          int k, int t) {
  int lo = max(0, t - (n - k)), hi = min(t, k);
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);  // A[mid] against B[t - mid - 1]
    if (key_le(fold(xs, (long long)k - 1 - mid, p, c, m),
               fold(xs, (long long)k + t - mid - 1, p, c, m)))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void valley_partition_kernel(const float* __restrict__ xs, int n,
                                        int p, const float* __restrict__ med,
                                        const int* __restrict__ ksplit,
                                        int nbounds, int* __restrict__ splits) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)nbounds * p) return;
  const int b = (int)(idx / p), c = (int)(idx - (long long)b * p);
  const int t = (int)min((long long)b * kTile, (long long)n);
  splits[idx] = merge_path(xs, n, p, c, med[c], ksplit[c], t);
}

__global__ void __launch_bounds__(kCols * kWarps)
valley_merge_kernel(const float* __restrict__ xs,
                    const long long* __restrict__ order, int n, int p,
                    const float* __restrict__ med,
                    const int* __restrict__ ksplit,
                    const int* __restrict__ splits, float* __restrict__ fs,
                    long long* __restrict__ forder) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* s_pos = reinterpret_cast<long long*>(smem);
  float* s_key = reinterpret_cast<float*>(s_pos + kCols * kStride);
  const int lane = threadIdx.x, w = threadIdx.y;
  const int c = blockIdx.y * kCols + lane;
  const bool live = c < p;  // lanes past the last column stage nothing
  const int b = blockIdx.x;
  const int t0 = b * kTile;
  const int tlen = min(kTile, n - t0);
  const int k = live ? ksplit[c] : 0;
  const float m = live ? med[c] : 0.f;
  const int i0 = live ? splits[(size_t)b * p + c] : 0;
  const int na = live ? splits[(size_t)(b + 1) * p + c] - i0 : 0;
  const int nb = tlen - na;
  const int j0 = t0 - i0;
  float* key = s_key + lane * kStride;
  long long* pos = s_pos + lane * kStride;
  // stage the tile: A ascending (rows k-1-i0 down), then B (rows k+j0 up)
  for (int e = w; live && e < tlen; e += kWarps) {
    const long long row = e < na ? (long long)k - 1 - i0 - e
                                 : (long long)k + j0 + (e - na);
    const size_t at = (size_t)row * p + c;
    key[e] = fabsf(xs[at] - m);
    pos[e] = order[at];
  }
  __syncthreads();  // a column's rows were staged by all 8 warps
  const int s = w * kPer;
  if (!live || s >= tlen) return;
  int lo = max(0, s - nb), hi = min(s, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key_le(key[mid], key[na + s - mid - 1])) lo = mid + 1; else hi = mid;
  }
  int ia = lo, ib = s - lo;
  const int e_end = min(s + kPer, tlen);
  for (int e = s; e < e_end; ++e) {
    const bool take_a =
        ib >= nb || (ia < na && key_le(key[ia], key[na + ib]));
    const int src = take_a ? ia++ : na + ib++;
    const size_t at = (size_t)(t0 + e) * p + c;
    fs[at] = key[src];
    forder[at] = pos[src];
  }
}

}  // namespace

// xs: (n, p) float32, columns ascending (NaN last); order: (n, p) int64;
// med: (p,) float32. Scratch: ksplit (p,) int32, splits (ceil(n / kTile) +
// 1, p) int32. Output: fs (n, p) float32, forder (n, p) int64. 1 <= n <
// 2^31 - 2 kTile. Returns cudaGetLastError().
extern "C" int mdt_valley_merge(const float* xs, const long long* order,
                                int n, int p, const float* med, int* ksplit,
                                int* splits, float* fs, long long* forder,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  valley_split_kernel<<<(p + 127) / 128, 128, 0, st>>>(xs, n, p, med, ksplit);
  const int ntiles = (n + kTile - 1) / kTile;
  const long long nsplits = (long long)(ntiles + 1) * p;
  valley_partition_kernel<<<(unsigned)((nsplits + 255) / 256), 256, 0, st>>>(
      xs, n, p, med, ksplit, ntiles + 1, splits);
  cudaError_t err = cudaFuncSetAttribute(
      valley_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(ntiles, (p + kCols - 1) / kCols);
  valley_merge_kernel<<<grid, dim3(kCols, kWarps), kSmemBytes, st>>>(
      xs, order, n, p, med, ksplit, splits, fs, forder);
  return (int)cudaGetLastError();
}
