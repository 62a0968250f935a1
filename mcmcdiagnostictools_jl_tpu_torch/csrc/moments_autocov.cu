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
// The moments take two coalesced passes over the block's 32 series (pass 1:
// sum/min/max, pass 2: centered sum of squares, both split over the 8 warps
// and reduced across warps in a fixed order); the lag products, which bound
// the kernel, are the tiled loop of lagloop.cuh (its header says what bounds
// it and how it tiles the draw axis). Centering uses the mean from pass 1
// (not raw-moment shortcuts), as the TPU kernel does, so c_k rounds like the
// plain version at small variance.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "lagloop.cuh"

namespace {

using mdt::kGroups;
using mdt::kLanes;

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
  extern __shared__ float smem[];     // the lag loop's tiles
  __shared__ float red_sum[kGroups][kLanes];
  __shared__ float red_min[kGroups][kLanes];
  __shared__ float red_max[kGroups][kLanes];
  __shared__ float s_mean[kLanes];

  const int lane = threadIdx.x;
  const int g = threadIdx.y;
  const int s = blockIdx.x * kLanes + lane;
  const bool live = s < nseries;
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

  // pass 3: the lags of this block
  mdt::lag_products<kJ>(x, niter, nseries, maxlag, mean, smem, acov_out);
}

template <int kJ>
int launch(const float* x, int niter, int nseries, int maxlag, float* mean,
           float* var, float* mn, float* mx, float* acov, cudaStream_t stream) {
  const size_t smem = mdt::lag_smem_bytes<kJ>();
  cudaError_t err = cudaFuncSetAttribute(
      moments_autocov_kernel<kJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kLanes, kGroups);
  moments_autocov_kernel<kJ><<<mdt::lag_grid<kJ>(nseries, maxlag), block, smem,
                               stream>>>(
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
