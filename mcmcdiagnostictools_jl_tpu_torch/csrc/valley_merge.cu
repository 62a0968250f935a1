// Kernel K10: the fold sort of the exact rank mode as a merge, for Hopper.
//
// Stands for the JAX package's `valley_sort_2d`
// (mcmcdiagnostictools_jl_tpu/ops/ranknorm.py:122), which is XLA, not a
// Pallas kernel: the two-axis bitonic-merge decomposition that sorts the
// folded sample |xs - med| in two short sorts.
//
// Input: rows. xs (p, n) float32, each row ascending in torch.sort's order
// (NaN last); order (p, n) int64, the payload riding with xs (the original
// flat position of each value); med (p,) float32. Output: fs (p, n), |xs -
// med| of each row ascending in the same order (NaN last), and forder (p, n),
// the payload carried with it: the keys of valley_sort_2d(|xs - med|, order)
// on rows, bit for bit, with the payload of tied keys in another order.
//
// Along an ascending row the folded keys fall, then rise: with k = #{xs <
// med}, entries k-1, k-2, ..., 0 give the run A of keys med - xs, ascending,
// and entries k, ..., n-1 the run B of keys xs - med, ascending, the NaN
// entries of xs at its end. So the sort is one merge of A and B: O(n) work,
// one read of xs and order and one write of fs and forder. A row whose med is
// NaN has every key NaN and k = 0, and keeps its xs order (B alone). Ties go
// to A first.
//
// Three launches, merge path style:
// 1. valley_split_kernel: k of each row, by binary search on xs;
// 2. valley_partition_kernel: for every tile boundary t = b * kTile of every
//    row, how many of the first t outputs come from A (a binary search on
//    the two runs in device memory);
// 3. valley_merge_kernel: a block owns kTile outputs of one row. Its share
//    of the runs is two contiguous stretches of the row, A[i_b, i_{b+1})
//    (read backwards) and B[t_b - i_b, t_{b+1} - i_{b+1}): kTile entries in
//    all. The block copies the 16-byte chunks that cover them, keys and
//    payloads, into shared memory by cp.async (whole sectors, every copy in
//    flight at once, no registers held), each thread finds its diagonal of
//    the tile by a binary search there and merges kPer outputs into
//    registers, and the block writes the tile back through shared memory as
//    16-byte stores of consecutive entries.
//
// What bounds it on an H100: the bytes, 12 read and 12 written an entry
// (2.35 ms at (256, 1.28M)). Every read and write is a whole 16-byte chunk
// of one row except at the two ends of each stretch; the chunks at the ends
// are read by the two neighbouring blocks (16 bytes more a stretch).

#include <cuda_runtime.h>
#include <math.h>

#include "staging.cuh"

namespace {

using mdt::Chunks;
using mdt::cover;
using mdt::cp_async16;

constexpr int kThreads = 256;
constexpr int kPer = 8;                  // outputs a thread merges
// outputs of one row a block (kernels/valley.py's _TILE): 24.6 KB of
// shared memory
constexpr int kTile = 2048;
static_assert(kTile == kThreads * kPer, "a thread merges kPer outputs");
// the chunks that cover a stretch of m entries hold at most m + 6 (floats,
// 4 a chunk) or m + 2 (int64, 2 a chunk): two stretches a tile
constexpr int kKeySlots = kTile + 16;
constexpr int kPosSlots = kTile + 8;

// torch.sort's ascending order with NaN last: `a` goes no later than `b`
__device__ __forceinline__ bool key_le(float a, float b) {
  return isnan(b) || (!isnan(a) && a <= b);
}

__global__ void valley_split_kernel(const float* __restrict__ xs, int n,
                                    int p, const float* __restrict__ med,
                                    int* __restrict__ ksplit) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= p) return;
  const float* row = xs + (size_t)c * n;
  const float m = med[c];
  int lo = 0, hi = n;  // first entry with !(xs < med): NaN entries never count
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (row[mid] < m) lo = mid + 1; else hi = mid;
  }
  ksplit[c] = lo;
}

// The number of A entries among the first t outputs of a row, A before B
// on equal keys.
__device__ int merge_path(const float* row, int n, float m, int k, int t) {
  int lo = max(0, t - (n - k)), hi = min(t, k);
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);  // A[mid] against B[t - mid - 1]
    if (key_le(fabsf(row[k - 1 - mid] - m), fabsf(row[k + t - mid - 1] - m)))
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
  const int c = (int)(idx / nbounds), b = (int)(idx - (long long)c * nbounds);
  const int t = (int)min((long long)b * kTile, (long long)n);
  splits[idx] = merge_path(xs + (size_t)c * n, n, med[c], ksplit[c], t);
}

__global__ void __launch_bounds__(kThreads, 4)
valley_merge_kernel(const float* __restrict__ xs,
                    const long long* __restrict__ order, int n, int ntiles,
                    const float* __restrict__ med,
                    const int* __restrict__ ksplit,
                    const int* __restrict__ splits, float* __restrict__ fs,
                    long long* __restrict__ forder) {
  __shared__ __align__(16) float s_key[kKeySlots];
  __shared__ __align__(16) long long s_pos[kPosSlots];
  const int tid = threadIdx.x;
  const int c = blockIdx.x / ntiles;
  const int b = blockIdx.x - c * ntiles;
  const long long base = (long long)c * n;  // the row's first entry
  const int t0 = b * kTile;
  const int tlen = min(kTile, n - t0);
  const int k = ksplit[c];
  const float m = med[c];
  const int* sp = splits + (size_t)c * (ntiles + 1);
  const int i0 = sp[b], na = sp[b + 1] - i0, nb = tlen - na;
  const int j0 = t0 - i0;
  // absolute entries: A[i] = base + k - 1 - i0 - i, B[j] = base + k + j0 + j
  const long long a_hi = base + k - i0, a_lo = a_hi - na;
  const long long b_lo = base + k + j0, b_hi = b_lo + nb;

  // stage: chunk u of A's cover, then of B's, lands at slot u of the buffer
  const Chunks ka = cover(a_lo, a_hi, 4), kb = cover(b_lo, b_hi, 4);
  const Chunks pa = cover(a_lo, a_hi, 2), pb = cover(b_lo, b_hi, 2);
  const float4* xs4 = reinterpret_cast<const float4*>(xs);
  const longlong2* ord2 = reinterpret_cast<const longlong2*>(order);
  for (int u = tid; u < ka.count + kb.count; u += kThreads) {
    const long long q = u < ka.count ? ka.first + u : kb.first + (u - ka.count);
    cp_async16(s_key + 4 * u, xs4 + q);
  }
  for (int u = tid; u < pa.count + pb.count; u += kThreads) {
    const long long q = u < pa.count ? pa.first + u : pb.first + (u - pa.count);
    cp_async16(s_pos + 2 * u, ord2 + q);
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  // slot of A[i] = a_key - i, of B[j] = b_key + j (keys; a_pos, b_pos: payload)
  const int a_key = na ? (int)(a_hi - 1 - 4 * ka.first) : 0;
  const int b_key = nb ? 4 * ka.count + (int)(b_lo - 4 * kb.first) : 0;
  const int a_pos = na ? (int)(a_hi - 1 - 2 * pa.first) : 0;
  const int b_pos = nb ? 2 * pa.count + (int)(b_lo - 2 * pb.first) : 0;

  // merge: thread tid owns outputs [s, s + kPer) of the tile
  const int s = tid * kPer;
  float out_key[kPer] = {};
  long long out_pos[kPer] = {};
  if (s < tlen) {
    int lo = max(0, s - nb), hi = min(s, na);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (key_le(fabsf(s_key[a_key - mid] - m),
                 fabsf(s_key[b_key + s - mid - 1] - m)))
        lo = mid + 1;
      else
        hi = mid;
    }
    int ia = lo, ib = s - lo;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      if (s + e < tlen) {
        const float x = ia < na ? fabsf(s_key[a_key - ia] - m) : 0.f;
        const float y = ib < nb ? fabsf(s_key[b_key + ib] - m) : 0.f;
        const bool take_a = ib >= nb || (ia < na && key_le(x, y));
        out_key[e] = take_a ? x : y;
        out_pos[e] = s_pos[take_a ? a_pos - ia : b_pos + ib];
        ia += take_a;
        ib += !take_a;
      }
    }
  }
  __syncthreads();  // every thread has read its runs: reuse the buffers
  if (s < tlen) {
    float4* k4 = reinterpret_cast<float4*>(s_key + s);
    k4[0] = make_float4(out_key[0], out_key[1], out_key[2], out_key[3]);
    k4[1] = make_float4(out_key[4], out_key[5], out_key[6], out_key[7]);
    longlong2* p2 = reinterpret_cast<longlong2*>(s_pos + s);
#pragma unroll
    for (int e = 0; e < kPer / 2; ++e)
      p2[e] = make_longlong2(out_pos[2 * e], out_pos[2 * e + 1]);
  }
  __syncthreads();

  // write the tile's outputs [g0, g1) as 16-byte stores, scalars at the ends
  const long long g0 = base + t0, g1 = g0 + tlen;
  const Chunks ok = cover(g0, g1, 4), op = cover(g0, g1, 2);
  for (int u = tid; u < ok.count; u += kThreads) {
    const long long e0 = 4 * (ok.first + u);
    const int at = (int)(e0 - g0);
    if (e0 >= g0 && e0 + 4 <= g1) {
      reinterpret_cast<float4*>(fs)[ok.first + u] =
          make_float4(s_key[at], s_key[at + 1], s_key[at + 2], s_key[at + 3]);
    } else {
      for (int e = 0; e < 4; ++e)
        if (e0 + e >= g0 && e0 + e < g1) fs[e0 + e] = s_key[at + e];
    }
  }
  for (int u = tid; u < op.count; u += kThreads) {
    const long long e0 = 2 * (op.first + u);
    const int at = (int)(e0 - g0);
    if (e0 >= g0 && e0 + 2 <= g1) {
      reinterpret_cast<longlong2*>(forder)[op.first + u] =
          make_longlong2(s_pos[at], s_pos[at + 1]);
    } else {
      for (int e = 0; e < 2; ++e)
        if (e0 + e >= g0 && e0 + e < g1) forder[e0 + e] = s_pos[at + e];
    }
  }
}

}  // namespace

// xs: (p, n) float32, rows ascending (NaN last); order: (p, n) int64; both
// 16-byte aligned; med: (p,) float32. Scratch: ksplit (p,) int32, splits (p,
// ceil(n / kTile) + 1) int32. Output: fs (p, n) float32, forder (p, n) int64,
// 16-byte aligned. 1 <= n < 2^31 - kTile, p (ceil(n / kTile) + 1) < 2^31.
// Returns cudaGetLastError().
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
  valley_merge_kernel<<<(unsigned)((long long)ntiles * p), kThreads, 0, st>>>(
      xs, order, n, ntiles, med, ksplit, splits, fs, forder);
  return (int)cudaGetLastError();
}
