// Kernel K11: per split-chain sums and sums of squares straight off a sorted
// sample, for Hopper.
//
// Stands for the JAX package's `weighted_segment_moments`
// (mcmcdiagnostictools_jl_tpu/ops/seghist.py:55), which is XLA, not a Pallas
// kernel (a one-hot contraction over row tiles), together with the
// split-chain ids of `split_chain_ids_from_flat` (:30) and the min / max of
// `split_chain_stats_from_sorted` (:87).
//
// Input: values float32 in any order along each parameter (the fold-sorted
// rank-normal values of the tail R-hat) and pos int64, the original flat
// position draw * nchains + chain of each value, both (p, n) by the strides
// the caller gives: entry j of parameter c at c * stride_p + j * stride_n.
// One of the strides is 1: the exact rank mode's rows (p, n) have stride_n =
// 1, the ring route's sample-major (n, p) blocks stride_p = 1. Each element's
// split chain follows from its position by the remainder rule (niter = ndraws
// / split, d = ndraws % split: splits k < d own draws [k (niter+1), k
// (niter+1) + niter), the draw after each is discarded; splits k >= d own [k
// niter + d, (k+1) niter + d)); segment chain * split + k; no id array
// exists. Output: sum and sumsq (nseg, p) float32 over the valid elements of
// each segment, and vmin, vmax (p,) over the valid elements of each column
// (+inf / -inf if none).
//
// Deterministic: every value is added as a fixed-point 64-bit integer
// (value * 2^s1, value^2 * 2^s2, rounded to nearest), and integer addition
// does not depend on order, so two runs are bit-equal whatever the atomics'
// order. The scales leave the sum of n terms of magnitude below kBound = 8
// inside 2^62 (a Blom rank-normal value is below 6.5 for n < 2^31); a column
// holding a value outside (-8, 8), or NaN, comes out NaN in every output.
// The sums are exact to 2^-s1 a term (2^-38 at n = 1.28M), so the result is
// the float32 rounding of the exact sum.
//
// Three launches: init (the min/max words), the accumulation, and finish
// (integers to float32). A block of the accumulation owns `cb` parameters and
// a chunk of their entries, rstep = 256 / cb threads a parameter, and its
// lanes run along the contiguous axis: with stride_n = 1 thread t reads
// entries t % rstep, t % rstep + rstep, ... of parameter t / rstep (a warp
// reads 32 / rstep parameters' stretches of rstep consecutive entries), with
// stride_p = 1 entries t / cb, ... of parameter t % cb (a warp reads whole
// sectors of 32 neighbouring parameters); kUnroll entries' loads are in
// flight before their adds (one at a time, the loads waited on the atomics
// and the kernel ran at half the rate). It adds into the block's (nseg, cb)
// 64-bit accumulators in shared memory, each add in two native 32-bit atomics
// (the low word's carry goes into the high word, as K3 does: a 64-bit atomic
// add on shared memory is a CAS loop), the four words of an accumulator pair
// in four planes, a parameter's segments together where the lanes of a warp
// share few parameters (stride_n = 1: their banks follow the segments) and a
// segment's parameters together where they are 32 parameters (stride_p = 1:
// their banks follow the parameters); at its end the block adds each nonzero
// accumulator into the global (nseg, p) ones by one native 64-bit atomic.
// `cb` is the widest of 32, 16, ..., 1 whose accumulators fit in kSmemBudget;
// past nseg = kSmemBudget / 16 the elements add into the global accumulators
// directly.
//
// What bounds it on an H100: the bytes, 12 read an element (1.17 ms at
// (1.28M, 256)); the division of each position by nchains and of its draw by
// the split length are 32-bit integer divisions, well inside the instruction
// rate. On rows the shared atomics of a warp's lanes fall on banks by their
// segments, which the fold order makes random, where on (n, p) they fall by
// parameter; the two layouts ran alike (chip_smoke.py phase 3, two runs:
// 2.080 and 2.048 ms on rows, 1.992 and 2.080 on (n, p)). Lanes by parameter
// on rows, each reading its own row, ran slower.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // rows a thread loads before it adds them
constexpr float kBound = 8.f;
constexpr int kSmemBudget = 96 * 1024;  // two blocks an SM

struct SplitRule {
  unsigned nchains, split, niter, d, boundary;
};

// the segment of flat position q, or -1 for a discarded draw
__device__ __forceinline__ int segment_of(unsigned q, SplitRule r) {
  const unsigned draw = q / r.nchains;
  const unsigned chain = q - draw * r.nchains;
  unsigned k;
  if (draw < r.boundary) {
    const unsigned span = r.niter + 1;
    k = draw / span;
    if (draw - k * span >= r.niter) return -1;
  } else {
    k = (draw - r.boundary) / r.niter + r.d;  // niter > 0 here
  }
  return (int)(chain * r.split + k);
}

// v into the 64-bit integer of low word *lo_w and high word *hi_w: two
// native 32-bit atomics, exact modulo 2^64 whatever the order of the adds
__device__ __forceinline__ void add64(unsigned* lo_w, unsigned* hi_w,
                                      long long v) {
  const unsigned lo = (unsigned)v, hi = (unsigned)((unsigned long long)v >> 32);
  const unsigned old = atomicAdd(lo_w, lo);
  atomicAdd(hi_w, hi + (old + lo < old ? 1u : 0u));
}

// float -> unsigned, monotone (for atomicMin / atomicMax on floats)
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned e) {
  return __uint_as_float((e & 0x80000000u) ? (e & 0x7fffffffu) : ~e);
}

__global__ void seg_init_kernel(int p, unsigned* __restrict__ lohi) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= p) return;
  lohi[c] = ordered(INFINITY);       // running min
  lohi[p + c] = ordered(-INFINITY);  // running max
  lohi[2 * p + c] = 0u;              // out-of-range flag
}

template <bool kShared, bool kRows>
__global__ void __launch_bounds__(kThreads)
seg_accumulate_kernel(const float* __restrict__ values,
                      const long long* __restrict__ pos, int n, int p,
                      long long stride_p, long long stride_n, SplitRule rule,
                      int nseg, int cb, int rows_per_chunk,
                      float scale1, double scale2,
                      unsigned long long* __restrict__ acc,
                      unsigned* __restrict__ lohi) {
  // planes of nseg * cb words: sum low, sum high, sumsq low, sumsq high
  extern __shared__ __align__(16) unsigned s_acc[];
  __shared__ unsigned s_lohi[3][32];
  const int t = threadIdx.x;
  const int rstep = kThreads / cb;
  const int cl = kRows ? t / rstep : t % cb;
  const int r0 = kRows ? t % rstep : t / cb;
  const int c0 = blockIdx.x * cb;
  const int c = c0 + cl;
  const int row_lo = blockIdx.y * rows_per_chunk;
  const int row_hi = min(n, row_lo + rows_per_chunk);
  if (t < cb) {
    s_lohi[0][t] = ordered(INFINITY);
    s_lohi[1][t] = ordered(-INFINITY);
    s_lohi[2][t] = 0u;
  }
  if (kShared) {
    for (int i = t; i < 4 * nseg * cb; i += kThreads) s_acc[i] = 0u;
  }
  __syncthreads();
  float vmin = INFINITY, vmax = -INFINITY;
  bool out_of_range = false;
  if (c < p) {
    for (long long row0 = row_lo + r0; row0 < row_hi;
         row0 += kUnroll * rstep) {
      // the loads of kUnroll rows go out before their atomics
      float vals[kUnroll];
      long long qs[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long row = row0 + (long long)u * rstep;
        const long long at = c * stride_p + row * stride_n;
        qs[u] = row < row_hi ? pos[at] : -1;
        vals[u] = row < row_hi ? values[at] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int seg = qs[u] < 0 ? -1 : segment_of((unsigned)qs[u], rule);
        if (seg < 0) continue;
        const float v = vals[u];
        vmin = fminf(vmin, v);
        vmax = fmaxf(vmax, v);
        out_of_range |= !(fabsf(v) < kBound);
        const long long a = __float2ll_rn(v * scale1);
        const long long b = __double2ll_rn((double)v * (double)v * scale2);
        if (kShared) {
          const int plane = nseg * cb;
          unsigned* w = s_acc + (kRows ? cl * nseg + seg : seg * cb + cl);
          add64(w, w + plane, a);
          add64(w + 2 * plane, w + 3 * plane, b);
        } else {
          unsigned long long* dst = acc + 2 * ((size_t)seg * p + c);
          atomicAdd(dst, (unsigned long long)a);
          atomicAdd(dst + 1, (unsigned long long)b);
        }
      }
    }
    atomicMin(&s_lohi[0][cl], ordered(vmin));
    atomicMax(&s_lohi[1][cl], ordered(vmax));
    if (out_of_range) atomicOr(&s_lohi[2][cl], 1u);
  }
  __syncthreads();
  if (kShared) {
    for (int i = t; i < nseg * cb; i += kThreads) {
      const int seg = kRows ? i % nseg : i / cb;
      const int col = c0 + (kRows ? i / nseg : i % cb);
      if (col >= p) continue;
      const int plane = nseg * cb;
      const unsigned long long a =
          s_acc[i] | (unsigned long long)s_acc[i + plane] << 32;
      const unsigned long long b =
          s_acc[i + 2 * plane] | (unsigned long long)s_acc[i + 3 * plane] << 32;
      unsigned long long* dst = acc + 2 * ((size_t)seg * p + col);
      if (a) atomicAdd(dst, a);
      if (b) atomicAdd(dst + 1, b);
    }
  }
  if (t < cb && c0 + t < p) {
    atomicMin(&lohi[c0 + t], s_lohi[0][t]);
    atomicMax(&lohi[p + c0 + t], s_lohi[1][t]);
    if (s_lohi[2][t]) atomicOr(&lohi[2 * p + c0 + t], 1u);
  }
}

__global__ void seg_finish_kernel(const unsigned long long* __restrict__ acc,
                                  const unsigned* __restrict__ lohi, int nseg,
                                  int p, double inv1, double inv2,
                                  float* __restrict__ sum,
                                  float* __restrict__ sumsq,
                                  float* __restrict__ vmin,
                                  float* __restrict__ vmax) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)nseg * p) return;
  const int c = (int)(i % p);
  const bool bad = lohi[2 * p + c] != 0u;
  sum[i] = bad ? NAN : (float)((double)(long long)acc[2 * i] * inv1);
  sumsq[i] = bad ? NAN : (float)((double)(long long)acc[2 * i + 1] * inv2);
  if (i < p) {
    vmin[c] = bad ? NAN : unordered(lohi[c]);
    vmax[c] = bad ? NAN : unordered(lohi[p + c]);
  }
}

// 62 - ceil(log2(n * bound)): the fractional bits that keep n terms below
// `bound` inside 2^62
int frac_bits(int n, double bound) {
  return 62 - (int)ceil(log2((double)(n > 0 ? n : 1) * bound));
}

}  // namespace

// values: float32, pos: int64 flat positions, both (p, n) by the strides
// stride_p, stride_n (one of them 1), n = ndraws * nchains < 2^31. Scratch:
// acc (nseg, p, 2) int64, lohi (3, p) uint32. Output: sum, sumsq (nseg, p)
// float32, vmin, vmax (p,) float32, nseg = nchains * split. Returns
// cudaGetLastError().
extern "C" int mdt_segment_moments(const float* values, const long long* pos,
                                   int ndraws, int nchains, int split, int p,
                                   long long stride_p, long long stride_n,
                                   unsigned long long* acc, unsigned* lohi,
                                   float* sum, float* sumsq, float* vmin,
                                   float* vmax, int num_sms, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int n = ndraws * nchains;
  const int nseg = nchains * split;
  SplitRule rule;
  rule.nchains = (unsigned)nchains;
  rule.split = (unsigned)split;
  rule.niter = (unsigned)(ndraws / split);
  rule.d = (unsigned)(ndraws % split);
  rule.boundary = rule.d * (rule.niter + 1);
  const int s1 = frac_bits(n, kBound), s2 = frac_bits(n, kBound * kBound);
  cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(long long) * 2 * nseg * (size_t)p, st);
  if (err != cudaSuccess) return (int)err;
  seg_init_kernel<<<(p + 255) / 256, 256, 0, st>>>(p, lohi);
  int cb = 32;
  while (cb > 1 && (size_t)nseg * cb * 16 > (size_t)kSmemBudget) cb >>= 1;
  const bool shared = (size_t)nseg * cb * 16 <= (size_t)kSmemBudget;
  if (!shared) cb = 32;
  const int groups = (p + cb - 1) / cb;
  // about eight blocks an SM in all, each at least a block's rows
  const int step = kThreads / cb;
  int chunks = (8 * num_sms + groups - 1) / groups;
  chunks = max(1, min(chunks, (n + step - 1) / step));
  const int rows = (n + chunks - 1) / chunks;
  chunks = (n + rows - 1) / rows;
  const dim3 grid(groups, chunks);
  const float scale1 = ldexpf(1.f, s1);
  const double scale2 = ldexp(1.0, s2);
  const size_t smem = shared ? (size_t)nseg * cb * 16 : 0;
  auto kernel = shared ? (stride_n == 1 ? seg_accumulate_kernel<true, true>
                                        : seg_accumulate_kernel<true, false>)
                       : (stride_n == 1 ? seg_accumulate_kernel<false, true>
                                        : seg_accumulate_kernel<false, false>);
  if (shared) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kThreads, smem, st>>>(values, pos, n, p, stride_p, stride_n,
                                       rule, nseg, cb, rows, scale1, scale2,
                                       acc, lohi);
  const long long total = (long long)nseg * p;
  seg_finish_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      acc, lohi, nseg, p, ldexp(1.0, -s1), ldexp(1.0, -s2), sum, sumsq, vmin,
      vmax);
  return (int)cudaGetLastError();
}
