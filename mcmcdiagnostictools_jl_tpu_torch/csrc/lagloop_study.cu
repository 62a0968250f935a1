// Kernel K6: two formulations of the lag loop, measured side by side, for
// Hopper.
//
// Replaces the Pallas kernels `_kernel_a` and `_kernel_b` of
// benchmarks/micro_lagloop.py (`_run`), which compared a dynamic slice per lag
// with "one aligned load, eight static shifts" on the TPU.
//
// Input: series (niter, S), one per column, NOT centered. Output:
// (maxlag + 1, S),
//     c_k = sum_{t < niter - k} x_t * x_{t+k} / niter,   k = 0..maxlag,
// with 0 for lags at or beyond niter. Both variants compute this function and
// must agree.
//
// What bounds it on an H100: niter * (maxlag + 1) FMAs a series (20.6 G at
// 5000 draws x 16,384 series x 251 lags), against 0.33 GB read. How the
// operands reach the FMA decides how close to the float32 peak it gets:
// - variant A (mdt::lag_products) is the first form of the port's lag loop: a
//   warp owns lags 8 apart and reads the shifted factor from shared memory
//   for every FMA, between two block-wide barriers a tile. An SM starts one
//   warp-wide shared-memory load a cycle against four warp-wide FMAs, so A
//   cannot pass a quarter of the peak. Nothing else launches it;
// - variant B (mdt::lag_products_ring) is the loop K1 and K5 run, the
//   counterpart of the TPU's static shifts thought through for this card: a
//   warp owns consecutive lags and keeps the sliding window of the shifted
//   factor in registers, two shared-memory loads for a window's worth of
//   FMAs, and every draw is staged once, ahead of use, with cp.async. The
//   FMA dispatch rate bounds it.
// lagloop.cuh says how both tile the draw axis and sum tile by tile.

#include <cuda_runtime.h>

#include "lagloop.cuh"

namespace {

using mdt::kGroups;
using mdt::kLanes;

template <int kJ>
__global__ void __launch_bounds__(kLanes * kGroups)
lagloop_a_kernel(const float* __restrict__ x, int niter, int nseries,
                 int maxlag, float* __restrict__ out) {
  extern __shared__ float smem[];
  mdt::lag_products<kJ>(x, niter, nseries, maxlag, 0.f, smem, out);
}

template <int kR, int kWarps, int kT>
__global__ void MDT_RING_BOUNDS(kWarps)
lagloop_b_kernel(const float* __restrict__ x, int niter, int nseries,
                 int maxlag, int vec, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem_b[];
  __shared__ __align__(16) float s_zero[kLanes];  // the centering means: 0
  if (threadIdx.y == 0) s_zero[threadIdx.x] = 0.f;
  mdt::lag_products_ring<kR, kWarps, kT, false>(x, niter, nseries, maxlag,
                                                s_zero, vec != 0, smem_b, out);
}

template <int kJ>
int launch_a(const float* x, int niter, int nseries, int maxlag, float* out,
             cudaStream_t stream) {
  const size_t smem = mdt::lag_smem_bytes<kJ>();
  cudaError_t err = cudaFuncSetAttribute(
      lagloop_a_kernel<kJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  lagloop_a_kernel<kJ><<<mdt::lag_grid<kJ>(nseries, maxlag),
                         dim3(kLanes, kGroups), smem, stream>>>(
      x, niter, nseries, maxlag, out);
  return (int)cudaGetLastError();
}

template <int kR, int kWarps, int kT>
int launch_b(const float* x, int niter, int nseries, int maxlag, float* out,
             cudaStream_t stream) {
  const dim3 grid = mdt::ring_grid<kR, kWarps>(nseries, maxlag);
  const size_t smem = mdt::ring_smem_bytes<kR, kWarps, kT>(grid.y > 1);
  cudaError_t err = cudaFuncSetAttribute(
      lagloop_b_kernel<kR, kWarps, kT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  lagloop_b_kernel<kR, kWarps, kT><<<grid, dim3(kLanes, kWarps), smem, stream>>>(
      x, niter, nseries, maxlag, mdt::rows_aligned16(x, nseries), out);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (niter, nseries) float32, contiguous. Output: (maxlag + 1, nseries).
// Variant A, with 9, 16 or 32 lags a warp by lag count. Returns cudaGetLastError().
extern "C" int mdt_lagloop_a(const float* x, int niter, int nseries, int maxlag,
                             float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (maxlag + 1 <= kGroups * 9)
    return launch_a<9>(x, niter, nseries, maxlag, out, st);
  if (maxlag + 1 <= kGroups * 16)
    return launch_a<16>(x, niter, nseries, maxlag, out, st);
  return launch_a<32>(x, niter, nseries, maxlag, out, st);
}

// Variant B, the production loop, in the instance K1 and K5 take for this lag
// count. Returns cudaGetLastError().
extern "C" int mdt_lagloop_b(const float* x, int niter, int nseries, int maxlag,
                             float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define MDT_RING_CASE(kR, kWarps, kT) \
  return launch_b<kR, kWarps, kT>(x, niter, nseries, maxlag, out, st);
  MDT_RING_DISPATCH(maxlag, MDT_RING_CASE)
#undef MDT_RING_CASE
}
