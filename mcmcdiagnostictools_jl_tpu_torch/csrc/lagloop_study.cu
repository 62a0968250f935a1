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
// - variant A is the loop K1 and K5 run (mdt::lag_products, mean 0): a warp
//   owns lags 8 apart and reads the shifted factor from shared memory for
//   every FMA. An SM starts one warp-wide shared-memory load a cycle against
//   four warp-wide FMAs, so A cannot pass a quarter of the peak;
// - variant B (mdt::lag_products_blocked) is the counterpart of the TPU's
//   static shifts, thought through for this card: a warp owns 32 consecutive
//   lags and keeps the sliding window of the shifted factor in registers, two
//   shared-memory loads for 32 FMAs. The FMA pipe bounds it.
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

template <int kR>
__global__ void __launch_bounds__(kLanes * kGroups)
lagloop_b_kernel(const float* __restrict__ x, int niter, int nseries,
                 int maxlag, float* __restrict__ out) {
  extern __shared__ float smem[];
  mdt::lag_products_blocked<kR>(x, niter, nseries, maxlag, 0.f, smem, out);
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, dim3 grid, const float* x, int niter,
           int nseries, int maxlag, float* out, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, dim3(kLanes, kGroups), smem, stream>>>(x, niter, nseries,
                                                        maxlag, out);
  return (int)cudaGetLastError();
}

template <int kJ>
int launch_a(const float* x, int niter, int nseries, int maxlag, float* out,
             cudaStream_t st) {
  return launch(lagloop_a_kernel<kJ>, mdt::lag_smem_bytes<kJ>(),
                mdt::lag_grid<kJ>(nseries, maxlag), x, niter, nseries, maxlag,
                out, st);
}

template <int kR>
int launch_b(const float* x, int niter, int nseries, int maxlag, float* out,
             cudaStream_t st) {
  return launch(lagloop_b_kernel<kR>, mdt::lag_smem_bytes<kR>(),
                mdt::lag_grid<kR>(nseries, maxlag), x, niter, nseries, maxlag,
                out, st);
}

}  // namespace

// x: (niter, nseries) float32, contiguous. Output: (maxlag + 1, nseries).
// Variant A, with K5's choice of lags a warp. Returns cudaGetLastError().
extern "C" int mdt_lagloop_a(const float* x, int niter, int nseries, int maxlag,
                             float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (maxlag + 1 <= kGroups * 9)
    return launch_a<9>(x, niter, nseries, maxlag, out, st);
  if (maxlag + 1 <= kGroups * 16)
    return launch_a<16>(x, niter, nseries, maxlag, out, st);
  return launch_a<32>(x, niter, nseries, maxlag, out, st);
}

// Variant B: windows of 8, 16 or 32 consecutive lags a warp (64, 128 or 256
// lags a block; more lags go to further blocks).
extern "C" int mdt_lagloop_b(const float* x, int niter, int nseries, int maxlag,
                             float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (maxlag + 1 <= kGroups * 8)
    return launch_b<8>(x, niter, nseries, maxlag, out, st);
  if (maxlag + 1 <= kGroups * 16)
    return launch_b<16>(x, niter, nseries, maxlag, out, st);
  return launch_b<32>(x, niter, nseries, maxlag, out, st);
}
