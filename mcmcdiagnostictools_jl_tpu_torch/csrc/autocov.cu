// Kernel K5: direct autocovariance of series that are centered already, for
// Hopper.
//
// Replaces the Pallas kernel `pallas_autocov`
// (mcmcdiagnostictools_jl_tpu/ops/pallas/autocov_kernel.py, `_autocov_kernel`).
//
// Input: centered series (niter, S), one series per column (S = chains x
// params, columns contiguous). Output: (maxlag + 1, S),
//     c_k = sum_{i < niter - k} x_i * x_{i+k} / niter,   k = 0..maxlag,
// the reference's AutocovMethod estimator (src/ess_rhat.jl:161-179) before
// the mean over chains, with 0 for lags at or beyond niter (what the TPU
// kernel's zero padding gives).
//
// It is K1's lag loop without K1's moment pass and without centering:
// lagloop.cuh says what bounds it on an H100 (the FMA dispatch rate, once the
// operands come from registers and the staging runs ahead of use) and how the
// production loop lag_products_ring tiles the draw axis, which the TPU kernel
// held in VMEM whole.

#include <cuda_runtime.h>

#include "lagloop.cuh"

namespace {

using mdt::kLanes;

template <int kR, int kWarps, int kT>
__global__ void MDT_RING_BOUNDS(kWarps)
direct_autocov_kernel(const float* __restrict__ x, int niter, int nseries,
                      int maxlag, int vec, float* __restrict__ acov_out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(16) float s_zero[kLanes];  // the centering means: 0
  if (threadIdx.y == 0) s_zero[threadIdx.x] = 0.f;
  mdt::lag_products_ring<kR, kWarps, kT, false>(x, niter, nseries, maxlag,
                                                s_zero, vec != 0, smem,
                                                acov_out);
}

template <int kR, int kWarps, int kT>
int launch(const float* x, int niter, int nseries, int maxlag, float* acov,
           cudaStream_t stream) {
  const dim3 grid = mdt::ring_grid<kR, kWarps>(nseries, maxlag);
  const size_t smem = mdt::ring_smem_bytes<kR, kWarps, kT>(grid.y > 1);
  cudaError_t err = cudaFuncSetAttribute(
      direct_autocov_kernel<kR, kWarps, kT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  direct_autocov_kernel<kR, kWarps, kT>
      <<<grid, dim3(kLanes, kWarps), smem, stream>>>(
          x, niter, nseries, maxlag, mdt::rows_aligned16(x, nseries), acov);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (niter, nseries) float32 centered series, contiguous. Output: acov of
// (maxlag + 1, nseries). Returns cudaGetLastError().
extern "C" int mdt_direct_autocov(const float* x, int niter, int nseries,
                                  int maxlag, float* acov, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define MDT_RING_CASE(kR, kWarps, kT) \
  return launch<kR, kWarps, kT>(x, niter, nseries, maxlag, acov, st);
  MDT_RING_DISPATCH(maxlag, MDT_RING_CASE)
#undef MDT_RING_CASE
}
