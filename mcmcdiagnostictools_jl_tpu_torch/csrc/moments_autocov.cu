// Kernel K1: fused per-series moments + direct autocovariance, for Hopper.
//
// Replaces the Pallas kernel `pallas_moments_autocov`
// (mcmcdiagnostictools_jl_tpu/ops/pallas/fused_basic_kernel.py, `_fused_kernel`).
//
// Input: a split sample (niter, S) with one series per column (S = chains x
// params, columns contiguous). Output per series: mean, unbiased variance,
// min and max (NaN-propagating, as jnp.min/jnp.max), and the biased direct
// autocovariance of the centered series,
//     c_k = sum_{i < niter - k} xc_i * xc_{i+k} / niter,   k = 0..maxlag,
// the reference's default estimator (src/ess_rhat.jl:161-179).
//
// What bounds it on an H100: the lag products, niter * (maxlag + 1) FMAs per
// series (41 G at 5000 x 32768 series x 251 lags), each fed by one
// shared-memory load. The TPU kernel held a whole 128-series block in VMEM
// (2.5 MB at niter 5000); a block here has at most 227 KB of shared memory, so
// the draw axis is tiled instead:
// - a block owns 32 neighbouring series (threadIdx.x), so every global load of
//   a warp is one coalesced 128-byte row segment;
// - the 8 warps of the block (threadIdx.y) first split the draws for the
//   moments (pass 1: sum/min/max, pass 2: centered sum of squares, both
//   reduced across warps in a fixed order), then split the lags: warp g keeps
//   the lags g, g + 8, g + 16, ... in registers;
// - each tile stages kTile centered draws (the left factor) and kTile + span
//   centered draws starting at the block's first lag (the shifted factor) in
//   shared memory, zero past niter, so every lag product is full length;
// - each tile's products are summed in registers and then added to the
//   running sum, which keeps float32 rounding near sqrt(kTile) + niter/kTile
//   terms instead of niter.
// Centering uses the mean from pass 1 (not raw-moment shortcuts), as the TPU
// kernel does, so c_k rounds like the plain version at small variance.
// Lags beyond one block's span (8 * kJ) go to further blocks in gridDim.y.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kLanes = 32;   // series per block
constexpr int kGroups = 8;   // warps per block
constexpr int kTile = 128;   // draws staged per tile

__device__ __forceinline__ float nan_min(float m, float v) {
  return (v != v || v < m) ? v : m;  // once m is NaN it stays NaN
}

__device__ __forceinline__ float nan_max(float m, float v) {
  return (v != v || v > m) ? v : m;
}

template <int kJ>
__global__ void __launch_bounds__(kLanes * kGroups)
moments_autocov_kernel(const float* __restrict__ x, int niter, int nseries,
                       int maxlag, float* __restrict__ mean_out,
                       float* __restrict__ var_out, float* __restrict__ min_out,
                       float* __restrict__ max_out,
                       float* __restrict__ acov_out) {
  constexpr int kSpan = kGroups * kJ;  // lags handled by one block
  extern __shared__ float smem[];
  float* a = smem;                     // (kTile, kLanes)
  float* b = smem + kTile * kLanes;    // (kTile + kSpan, kLanes)
  __shared__ float red_sum[kGroups][kLanes];
  __shared__ float red_min[kGroups][kLanes];
  __shared__ float red_max[kGroups][kLanes];
  __shared__ float s_mean[kLanes];

  const int lane = threadIdx.x;
  const int g = threadIdx.y;
  const int s = blockIdx.x * kLanes + lane;
  const bool live = s < nseries;
  const int lag0 = blockIdx.y * kSpan;
  const bool writer = blockIdx.y == 0 && g == 0 && live;

  // pass 1: sum, min, max
  float sum = 0.f, mn = INFINITY, mx = -INFINITY;
  if (live) {
    for (int i = g; i < niter; i += kGroups) {
      const float v = x[(size_t)i * nseries + s];
      sum += v;
      mn = nan_min(mn, v);
      mx = nan_max(mx, v);
    }
  }
  red_sum[g][lane] = sum;
  red_min[g][lane] = mn;
  red_max[g][lane] = mx;
  __syncthreads();
  if (g == 0) {
    float t = red_sum[0][lane], m0 = red_min[0][lane], m1 = red_max[0][lane];
    for (int q = 1; q < kGroups; ++q) {
      t += red_sum[q][lane];
      m0 = nan_min(m0, red_min[q][lane]);
      m1 = nan_max(m1, red_max[q][lane]);
    }
    const float mean = t / (float)niter;
    s_mean[lane] = mean;
    if (writer) {
      mean_out[s] = mean;
      min_out[s] = m0;
      max_out[s] = m1;
    }
  }
  __syncthreads();
  const float mean = s_mean[lane];

  // pass 2: centered sum of squares
  float ss = 0.f;
  if (live) {
    for (int i = g; i < niter; i += kGroups) {
      const float d = x[(size_t)i * nseries + s] - mean;
      ss += d * d;
    }
  }
  red_sum[g][lane] = ss;
  __syncthreads();
  if (writer) {
    float t = red_sum[0][lane];
    for (int q = 1; q < kGroups; ++q) t += red_sum[q][lane];
    var_out[s] = t / (float)(niter - 1);
  }

  // pass 3: lags lag0 + g + kGroups * j, j < kJ
  float acc[kJ];
#pragma unroll
  for (int j = 0; j < kJ; ++j) acc[j] = 0.f;
  for (int i0 = 0; i0 < niter; i0 += kTile) {
    __syncthreads();  // the previous tile has been consumed
    for (int r = g; r < kTile; r += kGroups) {
      const int i = i0 + r;
      a[r * kLanes + lane] =
          (live && i < niter) ? x[(size_t)i * nseries + s] - mean : 0.f;
    }
    for (int r = g; r < kTile + kSpan; r += kGroups) {
      const int i = i0 + lag0 + r;
      b[r * kLanes + lane] =
          (live && i < niter) ? x[(size_t)i * nseries + s] - mean : 0.f;
    }
    __syncthreads();
    const int rows = min(kTile, niter - i0);
    float part[kJ];
#pragma unroll
    for (int j = 0; j < kJ; ++j) part[j] = 0.f;
    for (int r = 0; r < rows; ++r) {
      const float av = a[r * kLanes + lane];
      const float* brow = b + (r + g) * kLanes + lane;
#pragma unroll
      for (int j = 0; j < kJ; ++j) part[j] += av * brow[j * kGroups * kLanes];
    }
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[j] += part[j];
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int k = lag0 + g + kGroups * j;
      if (k <= maxlag) acov_out[(size_t)k * nseries + s] = acc[j] / (float)niter;
    }
  }
}

template <int kJ>
int launch(const float* x, int niter, int nseries, int maxlag, float* mean,
           float* var, float* mn, float* mx, float* acov, cudaStream_t stream) {
  constexpr int kSpan = kGroups * kJ;
  const size_t smem = (size_t)(kTile * kLanes + (kTile + kSpan) * kLanes) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      moments_autocov_kernel<kJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kLanes, kGroups);
  const dim3 grid((nseries + kLanes - 1) / kLanes,
                  (maxlag + 1 + kSpan - 1) / kSpan);
  moments_autocov_kernel<kJ><<<grid, block, smem, stream>>>(
      x, niter, nseries, maxlag, mean, var, mn, mx, acov);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (niter, nseries) float32, contiguous. Outputs: mean, var, mn, mx of
// (nseries,) and acov of (maxlag + 1, nseries). Returns cudaGetLastError().
extern "C" int mdt_moments_autocov(const float* x, int niter, int nseries,
                                   int maxlag, float* mean, float* var,
                                   float* mn, float* mx, float* acov,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (maxlag + 1 <= kGroups * 9)
    return launch<9>(x, niter, nseries, maxlag, mean, var, mn, mx, acov, st);
  if (maxlag + 1 <= kGroups * 16)
    return launch<16>(x, niter, nseries, maxlag, mean, var, mn, mx, acov, st);
  return launch<32>(x, niter, nseries, maxlag, mean, var, mn, mx, acov, st);
}
