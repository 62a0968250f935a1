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
// What bounds it on an H100: the lag products (lagloop.cuh says how, and what
// the production loop lag_products_ring does about it). Around them:
// - one coalesced pass over the block's 32 series for sum, min and max (they
//   must be known before anything is centered), split over the block's warps
//   with eight loads a thread in flight and reduced across warps in a fixed
//   order;
// - the centered sum of squares is NOT a pass of its own: it is the lag-0 sum
//   of the lag loop, which warp 0 of the first lag span holds in a register,
//   so var = c_0 * niter / (niter - 1) from the same additions;
// - centering uses the mean from the pass (not raw-moment shortcuts), as the
//   TPU kernel does, so c_k rounds like the plain version at small variance.
// A launch with more than one lag span (maxlag + 1 > warps x window)
// recomputes the sums in every span's block (each needs the mean); only the
// first span writes the moments.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "lagloop.cuh"

namespace {

using mdt::kLanes;

__device__ __forceinline__ float nan_min(float m, float v) {
  return (v != v || v < m) ? v : m;  // once m is NaN it stays NaN
}

__device__ __forceinline__ float nan_max(float m, float v) {
  return (v != v || v > m) ? v : m;
}

template <int kR, int kWarps, int kT>
__global__ void MDT_RING_BOUNDS(kWarps)
moments_autocov_kernel(const float* __restrict__ x, int niter, int nseries,
                       int maxlag, int vec, float* __restrict__ mean_out,
                       float* __restrict__ var_out, float* __restrict__ min_out,
                       float* __restrict__ max_out,
                       float* __restrict__ acov_out) {
  extern __shared__ __align__(16) float smem[];  // the lag loop's rings
  __shared__ float red_sum[kWarps][kLanes];
  __shared__ float red_min[kWarps][kLanes];
  __shared__ float red_max[kWarps][kLanes];
  __shared__ __align__(16) float s_mean[kLanes];

  const int lane = threadIdx.x;
  const int g = threadIdx.y;
  const int s = blockIdx.x * kLanes + lane;
  const bool live = s < nseries;
  const bool writer = blockIdx.y == 0 && g == 0 && live;

  // sum, min, max: rows g, g + kWarps, ...
  float sum = 0.f, mn = INFINITY, mx = -INFINITY;
  if (live) {
#pragma unroll 8
    for (int i = g; i < niter; i += kWarps) {
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
    for (int q = 1; q < kWarps; ++q) {
      t += red_sum[q][lane];
      m0 = nan_min(m0, red_min[q][lane]);
      m1 = nan_max(m1, red_max[q][lane]);
    }
    const float mean = t / (float)niter;
    s_mean[lane] = live ? mean : 0.f;
    if (writer) {
      mean_out[s] = mean;
      min_out[s] = m0;
      max_out[s] = m1;
    }
  }

  // the lags of this block (the loop begins with a barrier: s_mean)
  const float ss = mdt::lag_products_ring<kR, kWarps, kT, true>(
      x, niter, nseries, maxlag, s_mean, vec != 0, smem, acov_out);
  if (writer) var_out[s] = ss / (float)(niter - 1);
}

template <int kR, int kWarps, int kT>
int launch(const float* x, int niter, int nseries, int maxlag, float* mean,
           float* var, float* mn, float* mx, float* acov, cudaStream_t stream) {
  const dim3 grid = mdt::ring_grid<kR, kWarps>(nseries, maxlag);
  const size_t smem = mdt::ring_smem_bytes<kR, kWarps, kT>(grid.y > 1);
  cudaError_t err = cudaFuncSetAttribute(
      moments_autocov_kernel<kR, kWarps, kT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kLanes, kWarps);
  moments_autocov_kernel<kR, kWarps, kT><<<grid, block, smem, stream>>>(
      x, niter, nseries, maxlag, mdt::rows_aligned16(x, nseries), mean, var,
      mn, mx, acov);
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
#define MDT_RING_CASE(kR, kWarps, kT)                                     \
  return launch<kR, kWarps, kT>(x, niter, nseries, maxlag, mean, var, mn, \
                                mx, acov, st);
  MDT_RING_DISPATCH(maxlag, MDT_RING_CASE)
#undef MDT_RING_CASE
}
