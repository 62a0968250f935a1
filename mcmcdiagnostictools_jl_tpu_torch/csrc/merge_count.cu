// Kernel K14: the ring route's merge-count, for Hopper.
//
// Stands for the JAX package's `_count_block`
// (mcmcdiagnostictools_jl_tpu/parallel/ring_rank.py:63), which is XLA, not a
// Pallas kernel: two sorts of the concatenation of a local and a visiting
// block, then run-boundary scans.
//
// Input: rows. a (p, n) and b (p, m) float32, each row ascending in float
// order (K13's order: -0.0 equal to +0.0). For every entry x = a[c, i] the
// counts against row c of b are
//   less = #{b < x},   leq = #{b <= x},
// with float `<` and `<=`, as torch.searchsorted's left and right sides
// make them. They go into int32 accumulators (p, n) that the caller owns, in
// place, in one pass:
//   first (b is a, the rank's own block):  t  = less + leq,  gpos = i;
//   else:  t += less + leq,  gpos += earlier ? leq : less,
// gpos optional (the fold pass needs t alone). Summed over the blocks of a
// ring, t is 2 cl + ce, the twice-rank minus one, and gpos the entry's
// global sorted position, ties held by ring-earlier blocks first.
//
// Both rows are sorted, so the counts come from one merge of a and b with
// b first on equal keys: when x is merged, every b <= x is behind it, so
// leq = the b entries taken so far. less is leq minus the run of b entries
// equal to x; the walk keeps the start of the run of the last b it took, so
// less is leq where that b is smaller than x, else the run's start. Only a
// run that began before the tile's stretch of b is not seen by the walk: for
// it the partition launch searches the row once a tile (lower_bound of the
// b entry just before the stretch, where the tile's first a equals it), so
// the counts stay exact on tie runs of any length, whole rows of one value
// included, and the work stays balanced.
//
// Two launches, merge path style, as K10 (csrc/valley_merge.cu):
// 1. merge_count_partition: for every tile boundary d = k * kTile of every
//    row, how many of the first d merged entries come from a (a binary
//    search on the two rows in device memory), and the run start above;
// 2. merge_count_kernel<kFirst, kPos>: a block owns kTile merged entries of
//    one row: the stretches a[i0, i1) and b[j0 - 1, j1), and the stretches of
//    the accumulators that a[i0, i1) updates, copied into shared memory by
//    cp.async as whole 16-byte chunks, all in flight at once; each thread
//    finds its diagonal by a binary search there, merges kPer entries and
//    adds the counts of the a entries among them into the staged
//    accumulators; the block writes them back as 16-byte stores.
//
// What bounds it on an H100: the bytes. 4 B of every a and b entry read
// (with first, b is a: one read), 8 B of every accumulator entry updated,
// 4 B of one only written: 24 B an entry of a when adding with positions
// (at (50, 6.25M) against as many, 7.5 GB, 2.24 ms at 3.35 TB/s), 12 B when
// writing them (the first block), 16 and 8 B for t alone. A NaN row (the caller poisons it, and its counts
// are not read) may give a merge path that is not monotone: each tile's
// share is clamped into its row, so every read and write stays in the row.

#include <cuda_runtime.h>

#include "staging.cuh"

namespace {

using mdt::Chunks;
using mdt::cover;
using mdt::cp_async16;

// 512 threads walking 8 merged entries each, 4 blocks a multiprocessor (32
// registers a thread, 49.3 KB of shared memory a block): faster than 256 x 8
// at 4 or 8 blocks, 256 x 16, 512 x 16 and 1024 x 8 (PERF.md, K14's design)
constexpr int kThreads = 512;
constexpr int kPer = 8;  // merged entries a thread walks
constexpr int kMinBlocks = 4;
// merged entries of one row a block (kernels/mergecount.py's _TILE)
constexpr int kTile = kThreads * kPer;
// the chunks that cover a stretch of s entries hold at most s + 6: the
// tile's a and b stretches and the b entry before them, kTile + 1 in all
constexpr int kKeySlots = kTile + 16;
constexpr int kCountSlots = kTile + 8;

// dynamic shared memory of a block: the keys, t's stretch and gpos's
constexpr int smem_bytes(bool stage_g) {
  return 4 * (kKeySlots + kCountSlots * (stage_g ? 2 : 1));
}

__global__ void merge_count_partition(const float* __restrict__ a, int n,
                                      const float* __restrict__ b, int m,
                                      int p, int nbounds,
                                      int2* __restrict__ parts) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)nbounds * p) return;
  const int c = (int)(idx / nbounds), k = (int)(idx - (long long)c * nbounds);
  const float* ar = a + (size_t)c * n;
  const float* br = b + (size_t)c * m;
  const int d = (int)min((long long)k * kTile, (long long)n + m);
  // a entries among the first d merged: a[i] goes first only if < b[d-i-1]
  int lo = max(0, d - m), hi = min(d, n);
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (ar[mid] < br[d - mid - 1]) lo = mid + 1; else hi = mid;
  }
  const int i0 = lo, j0 = d - lo;
  // #{b < b[j0 - 1]}, wanted only where the tile's first a equals b[j0 - 1]
  int run = j0;
  if (j0 > 0 && i0 < n && !(br[j0 - 1] < ar[i0])) {
    const float e = br[j0 - 1];
    lo = 0;
    hi = j0 - 1;
    while (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);
      if (br[mid] < e) lo = mid + 1; else hi = mid;
    }
    run = lo;
  }
  parts[idx] = make_int2(i0, run);
}

template <bool kFirst, bool kPos>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
merge_count_kernel(const float* __restrict__ a, int n,
                   const float* __restrict__ b, int m, int ntiles,
                   const int2* __restrict__ parts, int earlier,
                   int* __restrict__ t, int* __restrict__ gpos) {
  constexpr bool kStageG = kPos && !kFirst;
  extern __shared__ __align__(16) float smem[];
  float* s_key = smem;
  int* s_t = reinterpret_cast<int*>(smem + kKeySlots);
  int* s_g = s_t + kCountSlots;  // staged only with kStageG
  const int tid = threadIdx.x;
  const int c = blockIdx.x / ntiles;
  const int k = blockIdx.x - c * ntiles;
  const int d0 = k * kTile;
  const int tlen = min(kTile, n + m - d0);
  const int2* pr = parts + (size_t)c * (ntiles + 1);
  const int2 here = pr[k];
  const int i0 = here.x, j0 = d0 - i0;
  // a's share of the tile, kept inside the row (a NaN row's merge path need
  // not be monotone)
  const int na = min(max(pr[k + 1].x - i0, max(0, tlen - (m - j0))),
                     min(tlen, n - i0));
  const int nb = tlen - na;
  const long long row_a = (long long)c * n;
  const long long a_lo = row_a + i0;             // flat entry of a[c, i0]
  const long long b_lo = (long long)c * m + j0;  // of b[c, j0]
  const int edge = j0 > 0;  // b[c, j0 - 1] is staged just before b's stretch

  // stage: chunk u of a's cover, then of b's, at slot 4u of the keys; the
  // accumulators' chunks of a's stretch at the same slots of theirs
  const Chunks ka = cover(a_lo, a_lo + na, 4),
               kb = cover(b_lo - edge, b_lo + nb, 4);
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  for (int u = tid; u < ka.count + kb.count; u += kThreads)
    cp_async16(s_key + 4 * u, u < ka.count ? a4 + ka.first + u
                                           : b4 + kb.first + (u - ka.count));
  if constexpr (!kFirst) {
    for (int u = tid; u < ka.count; u += kThreads) {
      cp_async16(s_t + 4 * u, reinterpret_cast<const int4*>(t) + ka.first + u);
      if constexpr (kStageG)
        cp_async16(s_g + 4 * u,
                   reinterpret_cast<const int4*>(gpos) + ka.first + u);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  // slot of a[c, i0 + i] = sa + i (keys and counts), of b[c, j0 + j] = sb + j
  const int sa = na ? (int)(a_lo - 4 * ka.first) : 0;
  const int sb = kb.count ? 4 * ka.count + (int)(b_lo - 4 * kb.first) : 0;

  const int s = tid * kPer;
  if (s < tlen) {
    int lo = max(0, s - nb), hi = min(s, na);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_key[sa + mid] < s_key[sb + s - mid - 1]) lo = mid + 1; else hi = mid;
    }
    int ia = lo, ib = s - lo;
    // the last b taken (b[c, j0 + ib - 1]) and #{b < it}, once known
    bool have = j0 + ib > 0;
    float prev = have ? s_key[sb + ib - 1] : 0.f;
    bool known = false;
    int run = 0;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      if (s + e < tlen) {
        const float x = ia < na ? s_key[sa + ia] : 0.f;
        const float y = ib < nb ? s_key[sb + ib] : 0.f;
        if (ib >= nb || (ia < na && x < y)) {
          const int leq = j0 + ib;
          int less = leq;
          if (have && !(prev < x)) {  // x equals the last b taken
            if (!known) {
              // the start of prev's run: in the stretch, else before it
              int rlo = 0, rhi = ib;
              while (rlo < rhi) {
                const int mid = (rlo + rhi) >> 1;
                if (s_key[sb + mid] < prev) rlo = mid + 1; else rhi = mid;
              }
              run = (rlo > 0 || !edge || s_key[sb - 1] < prev) ? j0 + rlo
                                                               : here.y;
              known = true;
            }
            less = run;
          }
          if constexpr (kFirst) {
            s_t[sa + ia] = less + leq;
          } else {
            s_t[sa + ia] += less + leq;
            if constexpr (kStageG) s_g[sa + ia] += earlier ? leq : less;
          }
          ++ia;
        } else {
          if (!have || prev < y) {
            run = j0 + ib;
            known = true;
          }
          prev = y;
          have = true;
          ++ib;
        }
      }
    }
  }
  __syncthreads();

  // write a's stretch [a_lo, a_hi) back: 16-byte stores, scalars at the ends
  const long long a_hi = a_lo + na;
  int4* t4 = reinterpret_cast<int4*>(t);
  int4* g4 = reinterpret_cast<int4*>(gpos);
  for (int u = tid; u < ka.count; u += kThreads) {
    const long long e0 = 4 * (ka.first + u);
    const int i = (int)(e0 - row_a);  // the row index of the chunk's first
    const int* st = s_t + 4 * u;
    if (e0 >= a_lo && e0 + 4 <= a_hi) {
      t4[ka.first + u] = make_int4(st[0], st[1], st[2], st[3]);
      if constexpr (kFirst && kPos) {
        g4[ka.first + u] = make_int4(i, i + 1, i + 2, i + 3);
      } else if constexpr (kStageG) {
        const int* sg = s_g + 4 * u;
        g4[ka.first + u] = make_int4(sg[0], sg[1], sg[2], sg[3]);
      }
    } else {
      for (int e = 0; e < 4; ++e) {
        if (e0 + e >= a_lo && e0 + e < a_hi) {
          t[e0 + e] = st[e];
          if constexpr (kFirst && kPos) gpos[e0 + e] = i + e;
          else if constexpr (kStageG) gpos[e0 + e] = s_g[4 * u + e];
        }
      }
    }
  }
}

template <bool kFirst, bool kPos>
void launch_count(const float* a, int n, const float* b, int m, int p,
                  int ntiles, const int2* parts, int earlier, int* t,
                  int* gpos, cudaStream_t st) {
  constexpr int bytes = smem_bytes(kPos && !kFirst);
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(merge_count_kernel<kFirst, kPos>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  merge_count_kernel<kFirst, kPos>
      <<<(unsigned)((long long)ntiles * p), kThreads, bytes, st>>>(
          a, n, b, m, ntiles, parts, earlier, t, gpos);
}

}  // namespace

// a: (p, n), b: (p, m) float32, rows ascending; t, gpos: (p, n) int32 (gpos
// may be null); all four 16-byte aligned. Scratch: parts (p, ceil((n + m) /
// kTile) + 1) int2. first: write t and gpos (b is a), else add to them;
// earlier: b's block is ring-earlier than a's (gpos adds leq, else less).
// 1 <= n, 1 <= m, n + m < 2^31 - kTile, p (ceil((n + m) / kTile) + 1) <
// 2^31. Returns cudaGetLastError().
extern "C" int mdt_merge_count(const float* a, int n, const float* b, int m,
                               int p, int first, int earlier, int* t,
                               int* gpos, void* parts, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int ntiles = (int)(((long long)n + m + kTile - 1) / kTile);
  const long long nparts = (long long)(ntiles + 1) * p;
  int2* pt = (int2*)parts;
  merge_count_partition<<<(unsigned)((nparts + 255) / 256), 256, 0, st>>>(
      a, n, b, m, p, ntiles + 1, pt);
  if (first && gpos)
    launch_count<true, true>(a, n, b, m, p, ntiles, pt, earlier, t, gpos, st);
  else if (first)
    launch_count<true, false>(a, n, b, m, p, ntiles, pt, earlier, t, gpos, st);
  else if (gpos)
    launch_count<false, true>(a, n, b, m, p, ntiles, pt, earlier, t, gpos, st);
  else
    launch_count<false, false>(a, n, b, m, p, ntiles, pt, earlier, t, gpos,
                               st);
  return (int)cudaGetLastError();
}
