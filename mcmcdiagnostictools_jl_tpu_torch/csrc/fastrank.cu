// Kernels K2-K4 of the histogram/CDF fast rank mode, for Hopper.
//
// All three read a sample in its native (N, P) layout, P contiguous, float32.
//
// K2 column minmax (replaces `pallas_column_minmax`,
//    mcmcdiagnostictools_jl_tpu/ops/pallas/fastrank_kernel.py, `_minmax_kernel`).
//    Bound by one read of the sample. The TPU kernel carried its partial
//    results across the sequential row grid in a revisited output; blocks
//    here run in no order, so pass 1 writes one partial (lo, hi, bad) per row
//    chunk and column, and pass 2 reduces the chunks in a fixed order
//    (deterministic, no float atomics). NaNs are ignored for the range and
//    set `bad`; a column whose lo or hi is not finite gets [0, 1].
//
// K3 and K4 share one decomposition, the slab: a block of 1024 threads owns
//    a few columns and a chunk of rows, because what it looks up per element
//    (K3's histogram, K4's table) has to sit in its shared memory: 8 bytes a
//    bin and column in K3 (4 columns of 4096 bins: 128 KB), 7 in K4 (8
//    columns: 229 KB). A block's share of a row is then 16 or 32 bytes of
//    the 1024 at P = 256, and device memory is sensitive to that grain
//    (`slab_copy_kernel` below measures it): reading 16 bytes a row runs at
//    1.9 TB/s and 32 at 2.6, but writing 16 bytes a row (half a sector at a
//    time) runs at 0.5-0.6 TB/s and 32 at 2.5. So K4 writes whole sectors
//    with one instruction (`lookup_wide_kernel`); K3 only reads, and stays
//    at 4 columns.
//
// K3 histogram moments (replaces `pallas_hist_moments`, `_hist_kernel`).
//    Per column and bin: count and sum of within-bin frac, with
//    b = clip(int((x - lo) * scale), 0, nbins - 1), of x or, with `shift`,
//    of the fold |x - shift[c]|. The TPU built digit one-hots and contracted
//    them on the MXU as a stand-in for a scatter. Here the first pass adds
//    each element into one 64-bit word of shared memory per bin and column
//    (in two native 32-bit steps, see `hist_add`):
//    the count in the top 20 bits, the frac sum below as fixed point with 24
//    fractional bits (frac <= 1, at most 2^20 - 1 rows a block, so neither
//    field overflows; 2^-24 is float32's own step just below 1). Integer
//    sums do not depend on their order, so the kernel is deterministic.
//    Each block writes its words to a (chunks, groups, cb, nbins) scratch;
//    no global atomics. The second pass (one block a column group) adds the
//    chunks in order and emits, per column: cnt, s1, fm = s1 / cnt (1/2 for
//    an empty bin), the exclusive prefix cum (nbins + 1 entries; a block
//    scan of whole numbers, exact) and K4's table (cum[b], fm[b]), column by
//    column. Bound by the read of the sample.
//    Bin-index safety: NaN maps to 0 first (as `_bin_coords` does), and the
//    integer bin is clamped to [0, nbins - 1] after conversion, so no input
//    can index outside shared memory.
//
// K4 rank lookup (replaces `pallas_rank_lookup`, `_lookup_kernel`, both
//    modes). Per element, in original order, with cnt[b] = cum[b+1] - cum[b]
//    and off[b] = cnt[b] (1/2 - fm[b]):
//        rank = cum[b] + clip(frac * cnt[b] + off[b], 0, cnt[b]) + 1/2,
//    and with blom_scale > 0 (the z mode, `blom_n`) the rank-normal value
//        z = ppnd7((rank - 3/8) * blom_scale),  blom_scale = 1 / (n + 1/4),
//    AS241's single-precision inverse normal CDF (`ppnd7`, same coefficients
//    and branches as fastrank_kernel.py:70-105). `shift` folds the input as
//    in K3; a column with `bad` set is written as NaN and one whose `fill`
//    is not NaN as that constant (the tied rank of a constant column, or its
//    z), so the callers need no pass over the output. The TPU contracted a
//    coarse one-hot against the tables on the MXU, because per-element
//    gathers were slow there. Here the slab's (cum, fm) tables are copied
//    into shared memory once a block and every element costs a few
//    shared-memory loads. For a shape that kernel does not take (P no
//    multiple of 8, more bins than fit its shared memory, or a caller's own
//    [C, cnt, off] tables) the first design remains: one thread an element,
//    the three tables packed as float4 per column and bin and gathered
//    through the L2 (measured: the gather alone took 1.6 of that kernel's
//    2.8 ms at 4096 bins x 256 columns). Bound by the sample's read and the
//    output's write.
//    Elementwise arithmetic uses explicit round-to-nearest intrinsics (no
//    FMA contraction) and the accurate logf (no fast-math intrinsic), so the
//    kernel rounds like its plain PyTorch version.
//
// Macros of this file, for timing studies only (benchmarks/fastrank_ablate.py;
// the package defines none): MDT_FR_INFLIGHT, MDT_WIDE_INFLIGHT (rows in
// flight a thread) and MDT_WIDE_THREADS set the constants below;
// MDT_STREAM_LDG reads the sample through the L1; MDT_HIST_CAS64 adds into
// the 64-bit word with one atomicAdd; MDT_HIST_PLAIN_STORES,
// MDT_HIST_ROW_BINS, MDT_HIST_LOADS_ONLY, MDT_LOOKUP_BIN0,
// MDT_LOOKUP_NO_GATHER and MDT_LOOKUP_COPY (the wide kernel writes what it
// read) take parts out (the results are then wrong).

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stddef.h>

#ifndef MDT_FR_INFLIGHT
#define MDT_FR_INFLIGHT 2
#endif

namespace {

__device__ __forceinline__ void bin_coords(float v, float lo, float scale,
                                           int nbins, int* b, float* frac) {
  v = (v != v) ? 0.f : fminf(fmaxf(v, -FLT_MAX), FLT_MAX);  // nan_to_num
  float s = __fmul_rn(__fsub_rn(v, lo), scale);
  const float fn = (float)nbins;
  s = (s > 0.f) ? s : 0.f;  // also maps a NaN coordinate to 0
  s = (s < fn) ? s : fn;
  int bi = (int)s;
  bi = bi < 0 ? 0 : (bi > nbins - 1 ? nbins - 1 : bi);
  *b = bi;
  *frac = __fsub_rn(s, (float)bi);
}

// A load of the sample in the slab kernels: each element is read once, so
// the load goes past the L1 (which K4's tables leave 27 KB of).
template <typename T>
__device__ __forceinline__ T stream_load(const T* src) {
#if defined(MDT_STREAM_LDG)
  return __ldg(src);
#else
  return __ldcg(src);
#endif
}
// ---- K2 -------------------------------------------------------------------

constexpr int kMmCols = 32;
constexpr int kMmRows = 8;

__global__ void __launch_bounds__(kMmCols * kMmRows)
minmax_partial_kernel(const float* __restrict__ x, long long n, int p,
                      long long rows_per_chunk, float* __restrict__ plo,
                      float* __restrict__ phi, int* __restrict__ pbad) {
  __shared__ float s_lo[kMmRows][kMmCols];
  __shared__ float s_hi[kMmRows][kMmCols];
  __shared__ int s_bad[kMmRows][kMmCols];
  const int c = blockIdx.x * kMmCols + threadIdx.x;
  const long long r0 = (long long)blockIdx.y * rows_per_chunk;
  const long long r1 = min(n, r0 + rows_per_chunk);
  float lo = INFINITY, hi = -INFINITY;
  int bad = 0;
  if (c < p) {
#pragma unroll 4
    for (long long r = r0 + threadIdx.y; r < r1; r += kMmRows) {
      const float v = x[r * p + c];
      if (v != v) {
        bad = 1;
      } else {
        lo = fminf(lo, v);
        hi = fmaxf(hi, v);
      }
    }
  }
  s_lo[threadIdx.y][threadIdx.x] = lo;
  s_hi[threadIdx.y][threadIdx.x] = hi;
  s_bad[threadIdx.y][threadIdx.x] = bad;
  __syncthreads();
  if (threadIdx.y == 0 && c < p) {
    for (int q = 1; q < kMmRows; ++q) {
      lo = fminf(lo, s_lo[q][threadIdx.x]);
      hi = fmaxf(hi, s_hi[q][threadIdx.x]);
      bad |= s_bad[q][threadIdx.x];
    }
    const size_t o = (size_t)blockIdx.y * p + c;
    plo[o] = lo;
    phi[o] = hi;
    pbad[o] = bad;
  }
}

__global__ void minmax_final_kernel(const float* __restrict__ plo,
                                    const float* __restrict__ phi,
                                    const int* __restrict__ pbad, int nchunks,
                                    int p, float* __restrict__ lo,
                                    float* __restrict__ hi,
                                    bool* __restrict__ bad) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= p) return;
  float l = INFINITY, h = -INFINITY;
  int b = 0;
  for (int q = 0; q < nchunks; ++q) {
    l = fminf(l, plo[(size_t)q * p + c]);
    h = fmaxf(h, phi[(size_t)q * p + c]);
    b |= pbad[(size_t)q * p + c];
  }
  const bool ok = isfinite(l) && isfinite(h);
  lo[c] = ok ? l : 0.f;
  hi[c] = ok ? h : 1.f;
  bad[c] = b != 0;
}

// ---- the slab of K3 and K4 --------------------------------------------------

constexpr int kSlabThreads = 1024;
constexpr int kInFlight = MDT_FR_INFLIGHT;  // rows in flight a thread (direct)
constexpr int kTileRows = kSlabThreads * kInFlight;

// CB columns of row r from column c0 on: one vector load where VEC (p a
// multiple of CB and the base aligned), else scalars with the edge masked.
template <int CB, bool VEC>
__device__ __forceinline__ void load_cols(const float* __restrict__ src,
                                          int ncols, float (&v)[CB]) {
  if constexpr (VEC && CB == 4) {
    const float4 q = stream_load(reinterpret_cast<const float4*>(src));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else if constexpr (VEC && CB == 2) {
    const float2 q = stream_load(reinterpret_cast<const float2*>(src));
    v[0] = q.x, v[1] = q.y;
  } else {
#pragma unroll
    for (int j = 0; j < CB; ++j) v[j] = j < ncols ? stream_load(src + j) : 0.f;
  }
}

template <int CB, bool VEC>
__device__ __forceinline__ void store_cols(float* __restrict__ dst, int ncols,
                                           const float (&v)[CB]) {
  if constexpr (VEC && CB == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC && CB == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int j = 0; j < CB; ++j)
      if (j < ncols) dst[j] = v[j];
  }
}

// ---- K3 -------------------------------------------------------------------

constexpr int kFracBits = 24;  // fixed-point fractional bits of the frac sum
constexpr int kCountShift = 44;  // the count sits above 20 + 24 bits of sum
constexpr unsigned long long kSumMask = (1ull << kCountShift) - 1;

// Shared memory has no native 64-bit add (the compiler builds one from a
// compare-and-swap loop, measured at twice the whole kernel's time), so the
// word is added to in two native 32-bit steps: the low word, then the high
// word with the count and the low word's carry (bit 44 is its bit 12). The
// sum of the two is the 64-bit sum whatever the interleaving.
__device__ __forceinline__ void hist_add(unsigned long long* word, float frac) {
  const unsigned fx = __float2uint_rn(__fmul_rn(frac, (float)(1 << kFracBits)));
#if defined(MDT_HIST_PLAIN_STORES)
  *word = (1ull << kCountShift) | fx;
#elif defined(MDT_HIST_CAS64)
  atomicAdd(word, (1ull << kCountShift) | fx);
#else
  unsigned* w = reinterpret_cast<unsigned*>(word);
  const unsigned old = atomicAdd(&w[0], fx);
  atomicAdd(&w[1], (1u << (kCountShift - 32)) + (old + fx < old ? 1u : 0u));
#endif
}

// One element of column j's histogram (`hist`: that column's words).
__device__ __forceinline__ void hist_element(unsigned long long* hist,
                                             float val, bool folded, float sh,
                                             float l, float sc, int nbins,
                                             long long r) {
  if (folded) val = fabsf(__fsub_rn(val, sh));
  int b;
  float frac;
  bin_coords(val, l, sc, nbins, &b, &frac);
#if defined(MDT_HIST_ROW_BINS)
  b = (int)(r % nbins);
#endif
#if defined(MDT_HIST_LOADS_ONLY)
  if (frac == 12345.f) hist[b] = 1ull;
#else
  hist_add(&hist[b], frac);
#endif
}

template <int CB, bool VEC>
__global__ void __launch_bounds__(kSlabThreads)
hist_partial_kernel(const float* __restrict__ x, long long n, int p,
                    const float* __restrict__ lo,
                    const float* __restrict__ scale,
                    const float* __restrict__ shift, int nbins,
                    long long rows_per_chunk, int groups,
                    unsigned long long* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* hist =
      reinterpret_cast<unsigned long long*>(smem_raw);  // [CB][nbins]
  const int c0 = blockIdx.x * CB;
  const int ncols = min(CB, p - c0);
  const int tid = threadIdx.x;
  for (int i = tid; i < nbins * CB; i += kSlabThreads) hist[i] = 0ull;
  float l[CB], sc[CB], sh[CB];
#pragma unroll
  for (int j = 0; j < CB; ++j) {
    const int c = min(c0 + j, p - 1);
    l[j] = lo[c], sc[j] = scale[c], sh[j] = shift ? shift[c] : 0.f;
  }
  __syncthreads();
  const long long r0 = (long long)blockIdx.y * rows_per_chunk;
  const long long r1 = min(n, r0 + rows_per_chunk);
  for (long long base = r0; base < r1; base += kTileRows) {
    float v[kInFlight][CB];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const long long r = base + u * kSlabThreads + tid;
      if (r < r1) load_cols<CB, VEC>(x + r * p + c0, ncols, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const long long r = base + u * kSlabThreads + tid;
      if (r >= r1) continue;
#pragma unroll
      for (int j = 0; j < CB; ++j)
        if (VEC || j < ncols)
          hist_element(hist + j * nbins, v[u][j], shift != nullptr, sh[j],
                       l[j], sc[j], nbins, r);
    }
  }
  __syncthreads();
  unsigned long long* dst =
      partial + ((size_t)blockIdx.y * groups + blockIdx.x) * CB * nbins;
  for (int i = tid; i < nbins * CB; i += kSlabThreads) dst[i] = hist[i];
}

// One block a column group: thread t takes bin b0 + t of all CB columns,
// adds the chunks' words in order, and the block scans the counts.
template <int CB, bool VEC>
__global__ void __launch_bounds__(kSlabThreads)
hist_finish_kernel(const unsigned long long* __restrict__ partial, int nchunks,
                   int groups, int p, int nbins, float* __restrict__ cnt,
                   float* __restrict__ s1, float* __restrict__ fm,
                   float* __restrict__ cum, float2* __restrict__ tab) {
  __shared__ unsigned warp_sum[CB][32];
  __shared__ unsigned tile_sum[CB];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * CB;
  const int ncols = min(CB, p - c0);
  const size_t chunk_stride = (size_t)groups * CB * nbins;
  const unsigned long long* src = partial + (size_t)blockIdx.x * CB * nbins;
  unsigned carry[CB];
#pragma unroll
  for (int j = 0; j < CB; ++j) carry[j] = 0u;
  for (int b0 = 0; b0 < nbins; b0 += kSlabThreads) {
    const int b = b0 + tid;
    const bool live = b < nbins;
    unsigned c[CB], incl[CB];
    unsigned long long s[CB];
#pragma unroll
    for (int j = 0; j < CB; ++j) {
      c[j] = 0u, s[j] = 0ull;
      if (live)
#pragma unroll 4
        for (int q = 0; q < nchunks; ++q) {
          const unsigned long long w = src[q * chunk_stride + j * nbins + b];
          c[j] += (unsigned)(w >> kCountShift);
          s[j] += w & kSumMask;
        }
      incl[j] = c[j];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned up = __shfl_up_sync(0xffffffffu, incl[j], d);
        if (lane >= d) incl[j] += up;
      }
      if (lane == 31) warp_sum[j][warp] = incl[j];
    }
    __syncthreads();
    if (warp < CB) {  // warp j scans column j's 32 warp sums
      const unsigned own = warp_sum[warp][lane];
      unsigned acc = own;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned up = __shfl_up_sync(0xffffffffu, acc, d);
        if (lane >= d) acc += up;
      }
      warp_sum[warp][lane] = acc - own;  // exclusive
      if (lane == 31) tile_sum[warp] = acc;
    }
    __syncthreads();
    float cntf[CB], s1f[CB], fmf[CB], cumf[CB];
#pragma unroll
    for (int j = 0; j < CB; ++j) {
      cntf[j] = (float)c[j];
      s1f[j] = __double2float_rn((double)s[j] * (1.0 / (1 << kFracBits)));
      fmf[j] = c[j] > 0u ? __fdiv_rn(s1f[j], cntf[j]) : 0.5f;
      cumf[j] = (float)(carry[j] + warp_sum[j][warp] + incl[j] - c[j]);
      carry[j] += tile_sum[j];
    }
    if (live) {
      const size_t o = (size_t)b * p + c0;
      if (cnt) store_cols<CB, VEC>(cnt + o, ncols, cntf);
      if (s1) store_cols<CB, VEC>(s1 + o, ncols, s1f);
      if (fm) store_cols<CB, VEC>(fm + o, ncols, fmf);
      if (cum) store_cols<CB, VEC>(cum + o, ncols, cumf);
      if (tab) {
#pragma unroll
        for (int j = 0; j < CB; ++j)
          if (j < ncols)
            tab[(size_t)(c0 + j) * (nbins + 1) + b] =
                make_float2(cumf[j], fmf[j]);
      }
    }
    __syncthreads();  // warp_sum and tile_sum are rewritten by the next tile
  }
  if (tid == 0) {
#pragma unroll
    for (int j = 0; j < CB; ++j) {
      if (j >= ncols) continue;
      if (cum) cum[(size_t)nbins * p + c0 + j] = (float)carry[j];
      if (tab)
        tab[(size_t)(c0 + j) * (nbins + 1) + nbins] =
            make_float2((float)carry[j], 0.f);
    }
  }
}

// ---- K4 -------------------------------------------------------------------

// Horner's rule, highest coefficient first: ((c[N-1] r + c[N-2]) r + ...) + c[0].
template <int N>
__device__ __forceinline__ float horner(float r, const float (&c)[N]) {
  float acc = c[N - 1];
#pragma unroll
  for (int i = N - 2; i >= 0; --i) acc = __fadd_rn(__fmul_rn(acc, r), c[i]);
  return acc;
}

// AS241 PPND7 (Wichura 1988): the inverse standard normal CDF in single
// precision, ~1.5e-7 relative; branch for branch the JAX `ppnd7`.
__device__ __forceinline__ float ppnd7(float p) {
  constexpr float A[4] = {3.3871327179e0f, 5.0434271938e1f, 1.5929113202e2f,
                          5.9109374720e1f};
  constexpr float B[4] = {1.0f, 1.7895169469e1f, 7.8757757664e1f,
                          6.7187563600e1f};
  constexpr float C[4] = {1.4234372777e0f, 2.7568153900e0f, 1.3067284816e0f,
                          1.7023821103e-1f};
  constexpr float D[3] = {1.0f, 7.3700164250e-1f, 1.2021132975e-1f};
  constexpr float E[4] = {6.6579051150e0f, 3.0812263860e0f, 4.2868294337e-1f,
                          1.7337203997e-2f};
  constexpr float F[3] = {1.0f, 2.4197894225e-1f, 1.2258202635e-2f};
  if (p != p) return p;  // fminf/fmaxf below would drop a NaN
  const float q = __fsub_rn(p, 0.5f);
  if (fabsf(q) <= 0.425f) {
    const float r = __fsub_rn(0.180625f, __fmul_rn(q, q));
    return __fdiv_rn(__fmul_rn(q, horner(r, A)), horner(r, B));
  }
  const float pt = fminf(p, __fsub_rn(1.0f, p));
  const float r = __fsqrt_rn(-logf(fmaxf(pt, 1e-38f)));
  float x;
  if (r <= 5.0f) {
    const float rr = __fsub_rn(r, 1.6f);
    x = __fdiv_rn(horner(rr, C), horner(rr, D));
  } else {
    const float rr = __fsub_rn(r, 5.0f);
    x = __fdiv_rn(horner(rr, E), horner(rr, F));
  }
  return q < 0.f ? -x : x;  // q != 0 in the tails
}

// rank (or z) from the bin's C, cnt, off and the within-bin position
__device__ __forceinline__ float rank_or_z(float c_lo, float cntb, float off,
                                           float frac, float blom_scale) {
  float g = __fadd_rn(__fmul_rn(frac, cntb), off);
  g = fminf(fmaxf(g, 0.f), cntb);
  const float rank = __fadd_rn(__fadd_rn(c_lo, g), 0.5f);
  return blom_scale > 0.f
             ? ppnd7(__fmul_rn(__fsub_rn(rank, 0.375f), blom_scale))
             : rank;
}

// What a column's output is: computed, or a constant (`bad`: NaN; else a
// `fill` that is not NaN).
__device__ __forceinline__ bool column_constant(const float* fill,
                                                const bool* bad, int c,
                                                float* value) {
  if (bad && bad[c]) {
    *value = NAN;
    return true;
  }
  if (fill) {
    const float f = fill[c];
    if (f == f) {
      *value = f;
      return true;
    }
  }
  return false;
}

// PIECES groups of 4 columns a block (2, 4 or 8: 32, 64 or 128 bytes of every
// row), and neighbouring threads on neighbouring 16-byte pieces of a row, so
// one load or store instruction of a warp covers whole 32-byte sectors. At
// that grain device memory runs near its rate: a plain copy of the sample in
// slabs of 32 bytes a row takes 1.1-1.2 ms, of 16 bytes a row 2.8-3.7 ms
// (two 16-byte stores of one thread into a sector do not help: they are two
// partial writes). For 8 tables of 4096 bins to fit, they are squeezed to 7
// bytes a bin as the block copies them in (229 KB): fm as it is, cum as a
// 24-bit whole number (exact: a CDF of fewer than 2^24 rows), the entries
// packed 3 bytes apart, so cum[b] and cum[b+1] are the 6 bytes from 3 b on,
// inside three neighbouring 32-bit words.
#ifndef MDT_WIDE_INFLIGHT
#define MDT_WIDE_INFLIGHT 2
#endif
#ifndef MDT_WIDE_THREADS
#define MDT_WIDE_THREADS 1024
#endif
constexpr int kWideInFlight = MDT_WIDE_INFLIGHT;  // rows in flight a thread
constexpr int kWideThreads = MDT_WIDE_THREADS;

__host__ __device__ inline int wide_cum_bytes(int nbins) {
  return (3 * (nbins + 1) + 8 + 7) / 8 * 8;  // two words past the last entry
}

// Shared memory of one column's squeezed table.
__host__ __device__ inline size_t wide_column_bytes(int nbins) {
  return sizeof(float) * nbins + wide_cum_bytes(nbins);
}

template <int PIECES>
__global__ void __launch_bounds__(kWideThreads)
lookup_wide_kernel(const float* __restrict__ x, long long n, int p,
                   const float* __restrict__ lo,
                   const float* __restrict__ scale,
                   const float* __restrict__ shift,
                   const float* __restrict__ fill,
                   const bool* __restrict__ bad,
                   const float2* __restrict__ tab, int nbins,
                   float blom_scale, long long rows_per_chunk,
                   float* __restrict__ out) {
  constexpr int kCols = 4 * PIECES;
  constexpr int kRows = kWideThreads / PIECES;  // rows one pass covers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* fm = reinterpret_cast<float*>(smem_raw);  // [kCols][nbins]
  unsigned char* cum =
      reinterpret_cast<unsigned char*>(fm + (size_t)kCols * nbins);
  const int cum_bytes = wide_cum_bytes(nbins);
  const int tid = threadIdx.x;
  const int stride = nbins + 1;
  for (int j = 0; j < kCols; ++j) {
    const float2* src = tab + (size_t)(blockIdx.x * kCols + j) * stride;
    unsigned char* cj = cum + (size_t)j * cum_bytes;
    for (int b = tid; b < stride; b += kWideThreads) {
      const float2 e = src[b];
      const unsigned c = __float2uint_rn(e.x);
      cj[3 * b] = (unsigned char)c;
      cj[3 * b + 1] = (unsigned char)(c >> 8);
      cj[3 * b + 2] = (unsigned char)(c >> 16);
      if (b < nbins) fm[(size_t)j * nbins + b] = e.y;
    }
  }
  // this thread's piece: 4 columns from c0 on, of row tid / PIECES of a pass
  const int piece = tid % PIECES;
  const int c0 = blockIdx.x * kCols + piece * 4;
  float l[4], sc[4], sh[4], kval[4];
  bool konst[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    l[j] = lo[c0 + j], sc[j] = scale[c0 + j];
    sh[j] = shift ? shift[c0 + j] : 0.f;
    kval[j] = 0.f;
    konst[j] = column_constant(fill, bad, c0 + j, &kval[j]);
  }
  __syncthreads();
  const bool folded = shift != nullptr;
  const float* fm0 = fm + (size_t)piece * 4 * nbins;
  const unsigned char* cum0 = cum + (size_t)piece * 4 * cum_bytes;
  const long long r0 = (long long)blockIdx.y * rows_per_chunk;
  const long long r1 = min(n, r0 + rows_per_chunk);
  for (long long base = r0 + tid / PIECES; base < r1;
       base += (long long)kWideInFlight * kRows) {
    float4 v[kWideInFlight];
#pragma unroll
    for (int u = 0; u < kWideInFlight; ++u) {
      const long long r = base + u * kRows;
      if (r < r1)
        v[u] = stream_load(reinterpret_cast<const float4*>(x + r * p + c0));
    }
#pragma unroll
    for (int u = 0; u < kWideInFlight; ++u) {
      const long long r = base + u * kRows;
      if (r >= r1) continue;
      float w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#if defined(MDT_LOOKUP_COPY)
        if (nbins > 0) continue;
#endif
        if (konst[j]) {
          w[j] = kval[j];
          continue;
        }
        float val = w[j];
        if (folded) val = fabsf(__fsub_rn(val, sh[j]));
        int b;
        float frac;
        bin_coords(val, l[j], sc[j], nbins, &b, &frac);
#if defined(MDT_LOOKUP_BIN0)
        b = b >> 20;
#endif
#if defined(MDT_LOOKUP_NO_GATHER)
        const float c_lo = (float)b, c_hi = c_lo + 3.f, fmb = 0.25f;
#else
        const unsigned* words =
            reinterpret_cast<const unsigned*>(cum0 + (size_t)j * cum_bytes);
        const int at = 3 * b, i = at >> 2, s8 = (at & 3) * 8;
        const unsigned w0 = words[i], w1 = words[i + 1], w2 = words[i + 2];
        const unsigned lo24 = __funnelshift_r(w0, w1, s8) & 0xffffffu;
        const unsigned hi24 = (s8 == 0 ? __funnelshift_r(w0, w1, 24)
                                       : __funnelshift_r(w1, w2, s8 - 8)) &
                              0xffffffu;
        const float c_lo = (float)lo24, c_hi = (float)hi24;
        const float fmb = fm0[(size_t)j * nbins + b];
#endif
        const float cntb = __fsub_rn(c_hi, c_lo);
        const float off = __fmul_rn(cntb, __fsub_rn(0.5f, fmb));
        w[j] = rank_or_z(c_lo, cntb, off, frac, blom_scale);
      }
      *reinterpret_cast<float4*>(out + r * p + c0) =
          make_float4(w[0], w[1], w[2], w[3]);
    }
  }
}

// The first design, for the shapes the wide kernel does not take: one element
// a thread, [C, cnt, off] as one float4 gathered through the L2.
__global__ void lookup_gather_kernel(const float* __restrict__ x, long long n,
                                     int p, const float* __restrict__ lo,
                                     const float* __restrict__ scale,
                                     const float* __restrict__ shift,
                                     const float* __restrict__ fill,
                                     const bool* __restrict__ bad,
                                     const float4* __restrict__ tab, int nbins,
                                     float blom_scale, float* __restrict__ out) {
  const long long total = n * p;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(idx % p);
    float value;
    if (column_constant(fill, bad, c, &value)) {
      out[idx] = value;
      continue;
    }
    float val = x[idx];
    if (shift) val = fabsf(__fsub_rn(val, __ldg(&shift[c])));
    int b;
    float frac;
    bin_coords(val, __ldg(&lo[c]), __ldg(&scale[c]), nbins, &b, &frac);
    const float4 t = __ldg(&tab[(size_t)c * nbins + b]);
    out[idx] = rank_or_z(t.x, t.y, t.z, frac, blom_scale);
  }
}

// ---- a study of the slab's grain (benchmarks/fastrank_ablate.py `grain`) ---

// What blocks of 1024 threads that own `w4` 16-byte pieces of every row (and
// hold `smem` bytes of shared memory, so one block a multiprocessor) get out
// of device memory: MODE 0 reads the sample, 1 writes it, 2 copies it.
// Neighbouring threads take neighbouring pieces of a row, 4 rows in flight.
template <int MODE>
__global__ void __launch_bounds__(kSlabThreads)
slab_copy_kernel(const float4* __restrict__ x, float4* __restrict__ out,
                 long long n, int p4, int w4, long long rows_per_chunk,
                 float* __restrict__ sink) {
  const int rows_pass = kSlabThreads / w4;
  const long long r0 = (long long)blockIdx.y * rows_per_chunk;
  const long long r1 = min(n, r0 + rows_per_chunk);
  const int c4 = blockIdx.x * w4 + threadIdx.x % w4;
  float acc = 0.f;
  for (long long base = r0 + threadIdx.x / w4; base < r1;
       base += 4ll * rows_pass) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long r = base + (long long)u * rows_pass;
      v[u] = make_float4((float)r, 1.f, 2.f, 3.f);
      if (MODE != 1 && r < r1) v[u] = __ldg(x + r * p4 + c4);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long r = base + (long long)u * rows_pass;
      if (MODE == 0)
        acc += v[u].x + v[u].y + v[u].z + v[u].w;
      else if (r < r1)
        out[r * p4 + c4] = v[u];
    }
  }
  if (MODE == 0 && acc == 12345.678f) *sink = acc;  // keeps the loads
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}


struct HistArgs {
  const float *x, *lo, *scale, *shift;
  long long n;
  int p, nbins, nchunks;
  unsigned long long* partial;
  float *cnt, *s1, *fm, *cum;
  float2* tab;
  cudaStream_t st;
};

template <int CB, bool VEC>
int finish_hist(const HistArgs& a, int groups) {
  hist_finish_kernel<CB, VEC><<<(a.p + CB - 1) / CB, kSlabThreads, 0, a.st>>>(
      a.partial, a.nchunks, groups, a.p, a.nbins, a.cnt, a.s1, a.fm, a.cum,
      a.tab);
  return (int)cudaGetLastError();
}

template <int CB, bool VEC>
int launch_hist(const HistArgs& a) {
  const long long rows = (a.n + a.nchunks - 1) / a.nchunks;
  const int groups = (a.p + CB - 1) / CB;
  const size_t smem = (size_t)a.nbins * CB * sizeof(unsigned long long);
  cudaError_t err = allow_smem(hist_partial_kernel<CB, VEC>, smem);
  if (err != cudaSuccess) return (int)err;
  hist_partial_kernel<CB, VEC><<<dim3((a.p + CB - 1) / CB, a.nchunks),
                                 kSlabThreads, smem, a.st>>>(
      a.x, a.n, a.p, a.lo, a.scale, a.shift, a.nbins, rows, groups, a.partial);
  err = cudaGetLastError();
  return err != cudaSuccess ? (int)err : finish_hist<CB, VEC>(a, groups);
}

struct LookupArgs {
  const float *x, *lo, *scale, *shift, *fill;
  const bool* bad;
  const float2* tab;
  long long n;
  int p, nbins, nchunks;
  float blom_scale;
  float* out;
  cudaStream_t st;
};

template <int PIECES>
int launch_lookup_wide(const LookupArgs& a) {
  const long long rows = (a.n + a.nchunks - 1) / a.nchunks;
  const size_t smem = 4 * PIECES * wide_column_bytes(a.nbins);
  cudaError_t err = allow_smem(lookup_wide_kernel<PIECES>, smem);
  if (err != cudaSuccess) return (int)err;
  lookup_wide_kernel<PIECES><<<dim3(a.p / (4 * PIECES), a.nchunks),
                               kWideThreads, smem, a.st>>>(
      a.x, a.n, a.p, a.lo, a.scale, a.shift, a.fill, a.bad, a.tab, a.nbins,
      a.blom_scale, rows, a.out);
  return (int)cudaGetLastError();
}



}  // namespace

// x: (n, p). Scratch plo/phi/pbad: (nchunks, p). Outputs lo, hi: (p,) float,
// bad: (p,) bool. Returns cudaGetLastError().
extern "C" int mdt_column_minmax(const float* x, long long n, int p,
                                 int nchunks, float* plo, float* phi,
                                 int* pbad, float* lo, float* hi, bool* bad,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long rows = (n + nchunks - 1) / nchunks;
  const dim3 block(kMmCols, kMmRows);
  const dim3 grid((p + kMmCols - 1) / kMmCols, nchunks);
  minmax_partial_kernel<<<grid, block, 0, st>>>(x, n, p, rows, plo, phi, pbad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  minmax_final_kernel<<<(p + 255) / 256, 256, 0, st>>>(plo, phi, pbad, nchunks,
                                                       p, lo, hi, bad);
  return (int)cudaGetLastError();
}

// K3, both passes. x: (n, p); lo, scale: (p,); shift: (p,) or null. cb
// columns a block (4, 2 or 1), read as one vector where vec (p a multiple of
// cb and x aligned to 4 cb bytes); nchunks row chunks of fewer than 2^20
// rows. partial: (nchunks, ceil(p / cb), cb, nbins) 64-bit words of scratch.
// Outputs, each may be null: cnt, s1, fm: (nbins, p); cum: (nbins + 1, p);
// tab: (p, nbins + 1) float2 (cum, fm).
extern "C" int mdt_hist_tables(const float* x, long long n, int p,
                               const float* lo, const float* scale,
                               const float* shift, int nbins, int cb, int vec,
                               int nchunks, unsigned long long* partial,
                               float* cnt, float* s1, float* fm, float* cum,
                               void* tab, void* stream) {
  if ((n + nchunks - 1) / nchunks >= (1ll << (kCountShift - kFracBits)))
    return (int)cudaErrorInvalidValue;
  const HistArgs a{x, lo, scale, shift, n, p, nbins, nchunks, partial, cnt, s1,
                   fm, cum, reinterpret_cast<float2*>(tab),
                   (cudaStream_t)stream};
  switch (cb) {
    case 4: return vec ? launch_hist<4, true>(a) : launch_hist<4, false>(a);
    case 2: return vec ? launch_hist<2, true>(a) : launch_hist<2, false>(a);
    case 1: return launch_hist<1, true>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K4 from shared-memory tables (the wide kernel). x, out: (n, p), aligned to
// 16 bytes; lo, scale: (p,); shift, fill: (p,) float or null; bad: (p,) bool
// or null; tab: (p, nbins + 1) float2 (cum, fm), cum whole numbers below
// 2^24. cb = 8, 16 or 32 columns a block, p a multiple of it; nchunks row
// chunks. out: ranks, or z values when blom_scale > 0 (0 means ranks).
extern "C" int mdt_rank_lookup_wide(const float* x, long long n, int p,
                                    const float* lo, const float* scale,
                                    const float* shift, const float* fill,
                                    const bool* bad, const void* tab,
                                    int nbins, float blom_scale, int cb,
                                    int nchunks, float* out, void* stream) {
  const LookupArgs a{x, lo, scale, shift, fill, bad,
                     reinterpret_cast<const float2*>(tab), n, p, nbins,
                     nchunks, blom_scale, out, (cudaStream_t)stream};
  if (p % cb != 0) return (int)cudaErrorInvalidValue;
  switch (cb) {
    case 32: return launch_lookup_wide<8>(a);
    case 16: return launch_lookup_wide<4>(a);
    case 8: return launch_lookup_wide<2>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K4 gathering through the L2. As above, but tab: (p, nbins) float4
// (c_lo, cnt, off, 0).
extern "C" int mdt_rank_lookup_gather(const float* x, long long n, int p,
                                      const float* lo, const float* scale,
                                      const float* shift, const float* fill,
                                      const bool* bad, const void* tab,
                                      int nbins, float blom_scale, float* out,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long total = n * p;
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  lookup_gather_kernel<<<(unsigned)blocks, 256, 0, st>>>(
      x, n, p, lo, scale, shift, fill, bad,
      reinterpret_cast<const float4*>(tab), nbins, blom_scale, out);
  return (int)cudaGetLastError();
}

// The study of the slab's grain: blocks of `cols` columns (a multiple of 4
// that divides p and 4096) and nchunks row chunks read (mode 0), write (1) or
// copy (2) x: (n, p) into out, holding smem bytes of shared memory a block.
extern "C" int mdt_slab_copy(const float* x, float* out, long long n, int p,
                             int cols, int mode, int smem, int nchunks,
                             float* sink, void* stream) {
  if (cols % 4 != 0 || p % cols != 0 || kSlabThreads % (cols / 4) != 0)
    return (int)cudaErrorInvalidValue;
  const long long rows = (n + nchunks - 1) / nchunks;
  const dim3 grid(p / cols, nchunks);
  auto launch = [&](auto kernel) {
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kSlabThreads, smem, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out), n,
        p / 4, cols / 4, rows, sink);
    return (int)cudaGetLastError();
  };
  return mode == 0   ? launch(slab_copy_kernel<0>)
         : mode == 1 ? launch(slab_copy_kernel<1>)
                     : launch(slab_copy_kernel<2>);
}
