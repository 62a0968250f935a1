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
// It is K1's lag loop without K1's two moment passes: lagloop.cuh, with a
// centering mean of 0, says what bounds it on an H100 (one shared-memory load
// per lag FMA) and how it tiles the draw axis, which the TPU kernel held in
// VMEM whole.

#include <cuda_runtime.h>

#include "lagloop.cuh"

namespace {

using mdt::kGroups;
using mdt::kLanes;

template <int kJ>
__global__ void __launch_bounds__(kLanes * kGroups)
direct_autocov_kernel(const float* __restrict__ x, int niter, int nseries,
                      int maxlag, float* __restrict__ acov_out) {
  extern __shared__ float smem[];
  mdt::lag_products<kJ>(x, niter, nseries, maxlag, 0.f, smem, acov_out);
}

template <int kJ>
int launch(const float* x, int niter, int nseries, int maxlag, float* acov,
           cudaStream_t stream) {
  const size_t smem = mdt::lag_smem_bytes<kJ>();
  cudaError_t err = cudaFuncSetAttribute(
      direct_autocov_kernel<kJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kLanes, kGroups);
  direct_autocov_kernel<kJ><<<mdt::lag_grid<kJ>(nseries, maxlag), block, smem,
                              stream>>>(x, niter, nseries, maxlag, acov);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (niter, nseries) float32 centered series, contiguous. Output: acov of
// (maxlag + 1, nseries). Returns cudaGetLastError().
extern "C" int mdt_direct_autocov(const float* x, int niter, int nseries,
                                  int maxlag, float* acov, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (maxlag + 1 <= kGroups * 9)
    return launch<9>(x, niter, nseries, maxlag, acov, st);
  if (maxlag + 1 <= kGroups * 16)
    return launch<16>(x, niter, nseries, maxlag, acov, st);
  return launch<32>(x, niter, nseries, maxlag, acov, st);
}
