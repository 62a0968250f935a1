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
// K3 histogram moments (replaces `pallas_hist_moments`, `_hist_kernel`).
//    Per column and bin: count and sum of within-bin frac, with
//    b = clip(int((x - lo) * scale), 0, nbins - 1). The TPU built digit
//    one-hots and contracted them on the MXU as a stand-in for a scatter;
//    here each block builds the histograms of `cb` columns (<= 4) over one
//    row chunk in shared memory (count + frac sum, 8 bytes a bin, 128 KB at
//    4096 bins x 4 columns) with shared-memory atomics, then merges its
//    nonzero bins into the (nbins, P) outputs with global atomics. Bound by
//    the read of the sample (a block reads 16 bytes of each 1 KB row at
//    P = 256: half of each 32-byte sector, chosen over a transpose for
//    simplicity) and by atomic contention on crowded bins. Counts are float
//    sums of whole numbers, exact below 2^24 in any order; frac sums are
//    order-dependent (nondeterministic at float32 rounding).
//    Bin-index safety: NaN maps to 0 first (as `_bin_coords` does), and the
//    integer bin is clamped to [0, nbins - 1] after conversion, so no input
//    can index outside shared memory. The ragged last row chunk is bounded
//    by the loop itself.
//
// K4 rank lookup (replaces `pallas_rank_lookup`, `_lookup_kernel`, both
//    modes). Per element, in original order:
//        rank = C[b] + clip(frac * cnt[b] + off[b], 0, cnt[b]) + 1/2,
//    and with blom_scale > 0 (the z mode, `blom_n`) the rank-normal value
//        z = ppnd7((rank - 3/8) * blom_scale),  blom_scale = 1 / (n + 1/4),
//    AS241's single-precision inverse normal CDF (`ppnd7`, same coefficients
//    and branches as fastrank_kernel.py:70-105). The TPU contracted a coarse
//    one-hot against the tables on the MXU and selected the fine digit on the
//    VPU, because per-element gathers were slow there. Here the three tables
//    are packed per column as float4 (c_lo, cnt, off, 0): 64 KB a column,
//    16.8 MB for 256 columns, resident in the 50 MB L2, so each element
//    costs one 16-byte gather. Bound by the sample's read and the output's
//    write plus those gathers; the z mode adds ~30 flops, a logf and a
//    sqrtf an element in the tails, and saves the separate Blom + ndtri pass
//    (one more read and write of the sample). Elementwise arithmetic uses
//    explicit round-to-nearest intrinsics (no FMA contraction) and the
//    accurate logf (no fast-math intrinsic), so the kernel rounds like its
//    plain PyTorch version.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stddef.h>

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

// ---- K3 -------------------------------------------------------------------

constexpr int kHistThreads = 512;
constexpr int kBatch = 8;

__global__ void __launch_bounds__(kHistThreads)
hist_kernel(const float* __restrict__ x, long long n, int p,
            const float* __restrict__ lo, const float* __restrict__ scale,
            int nbins, int cb, long long rows_per_chunk,
            float* __restrict__ cnt_out, float* __restrict__ s1_out) {
  extern __shared__ unsigned char smem_raw[];
  int* hc = reinterpret_cast<int*>(smem_raw);     // [bin][cb]
  float* hs = reinterpret_cast<float*>(hc + (size_t)nbins * cb);
  for (int i = threadIdx.x; i < nbins * cb; i += blockDim.x) {
    hc[i] = 0;
    hs[i] = 0.f;
  }
  __syncthreads();
  const int c0 = blockIdx.x * cb;
  const int ncols = min(cb, p - c0);
  const long long r0 = (long long)blockIdx.y * rows_per_chunk;
  const long long r1 = min(n, r0 + rows_per_chunk);
  const int cc = threadIdx.x % cb;
  const int rstep = blockDim.x / cb;
  if (cc < ncols) {
    const int c = c0 + cc;
    const float l = lo[c], sc = scale[c];
    long long r = r0 + threadIdx.x / cb;
    // kBatch loads in flight per thread before the shared-memory atomics
    for (; r + (kBatch - 1) * rstep < r1; r += kBatch * rstep) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) v[u] = x[(r + u * rstep) * p + c];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        int b;
        float frac;
        bin_coords(v[u], l, sc, nbins, &b, &frac);
        atomicAdd(&hc[b * cb + cc], 1);
        atomicAdd(&hs[b * cb + cc], frac);
      }
    }
    for (; r < r1; r += rstep) {
      int b;
      float frac;
      bin_coords(x[r * p + c], l, sc, nbins, &b, &frac);
      atomicAdd(&hc[b * cb + cc], 1);
      atomicAdd(&hs[b * cb + cc], frac);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nbins * cb; i += blockDim.x) {
    const int k = hc[i];
    const int col = i % cb;
    if (k != 0 && col < ncols) {
      const size_t o = (size_t)(i / cb) * p + c0 + col;
      atomicAdd(&cnt_out[o], (float)k);
      atomicAdd(&s1_out[o], hs[i]);
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

__global__ void rank_lookup_kernel(const float* __restrict__ x, long long n,
                                   int p, const float* __restrict__ lo,
                                   const float* __restrict__ scale,
                                   const float4* __restrict__ tab, int nbins,
                                   float blom_scale, float* __restrict__ out) {
  const long long total = n * p;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(idx % p);
    int b;
    float frac;
    bin_coords(x[idx], __ldg(&lo[c]), __ldg(&scale[c]), nbins, &b, &frac);
    const float4 t = __ldg(&tab[(size_t)c * nbins + b]);
    float g = __fadd_rn(__fmul_rn(frac, t.y), t.z);
    g = fminf(fmaxf(g, 0.f), t.y);
    const float rank = __fadd_rn(__fadd_rn(t.x, g), 0.5f);
    out[idx] = blom_scale > 0.f
                   ? ppnd7(__fmul_rn(__fsub_rn(rank, 0.375f), blom_scale))
                   : rank;
  }
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

// x: (n, p); lo, scale: (p,). cnt, s1: (nbins, p), zeroed by the caller.
// cb columns per block (1, 2 or 4), nchunks row chunks.
extern "C" int mdt_hist_moments(const float* x, long long n, int p,
                                const float* lo, const float* scale, int nbins,
                                int cb, int nchunks, float* cnt, float* s1,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)nbins * cb * (sizeof(int) + sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (n + nchunks - 1) / nchunks;
  const dim3 grid((p + cb - 1) / cb, nchunks);
  hist_kernel<<<grid, kHistThreads, smem, st>>>(x, n, p, lo, scale, nbins, cb,
                                                rows, cnt, s1);
  return (int)cudaGetLastError();
}

// x: (n, p); lo, scale: (p,); tab: (p, nbins) float4 (c_lo, cnt, off, 0).
// out: (n, p) ranks, or z values when blom_scale > 0 (0 means ranks).
extern "C" int mdt_rank_lookup(const float* x, long long n, int p,
                               const float* lo, const float* scale,
                               const void* tab, int nbins, float blom_scale,
                               float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long total = n * p;
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  rank_lookup_kernel<<<(unsigned)blocks, 256, 0, st>>>(
      x, n, p, lo, scale, reinterpret_cast<const float4*>(tab), nbins,
      blom_scale, out);
  return (int)cudaGetLastError();
}
