// The tiled lag loop shared by kernels K1 (moments_autocov.cu) and K5
// (autocov.cu): the biased direct autocovariance of centered series,
//     c_k = sum_{i < niter - k} xc_i * xc_{i+k} / niter,   k = 0..maxlag,
// with xc = x - mean for one block of kLanes series.
//
// What bounds it on an H100: the lag products, niter * (maxlag + 1) FMAs per
// series (82 G at 5000 draws x 65,536 series x 251 lags), each fed by one
// shared-memory load. A TPU kernel held a whole 128-series block in VMEM
// (2.5 MB at niter 5000); a block here has at most 227 KB of shared memory, so
// the draw axis is tiled:
// - a block owns 32 neighbouring series (threadIdx.x), so every global load of
//   a warp is one coalesced 128-byte row segment;
// - the 8 warps of the block (threadIdx.y) split the lags: warp g keeps the
//   lags lag0 + g, lag0 + g + 8, ... in registers;
// - each tile stages kTile centered draws (the left factor) and kTile + span
//   centered draws starting at the block's first lag (the shifted factor) in
//   shared memory, zero past niter, so every lag product is full length;
// - each tile's products are summed in registers and then added to the
//   running sum, which keeps float32 rounding near sqrt(kTile) + niter/kTile
//   terms instead of niter.
// Lags beyond one block's span (8 * kJ) go to further blocks in gridDim.y.
// Lags at or beyond niter are written as 0 (the plain versions' value).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace mdt {

constexpr int kLanes = 32;   // series per block
constexpr int kGroups = 8;   // warps per block
constexpr int kTile = 128;   // draws staged per tile

// Dynamic shared memory of one block of the lag loop with kJ lags a warp.
template <int kJ>
constexpr size_t lag_smem_bytes() {
  return (size_t)(kTile * kLanes + (kTile + kGroups * kJ) * kLanes) *
         sizeof(float);
}

// Lags of this block (blockIdx.y) for the series of this block (blockIdx.x),
// centered with `mean` (the series' mean for this thread's lane; 0 for
// series that are centered already). `smem` holds lag_smem_bytes<kJ>().
// Every thread of the block must call it (it synchronises the block).
template <int kJ>
__device__ __forceinline__ void lag_products(const float* __restrict__ x,
                                             int niter, int nseries,
                                             int maxlag, float mean,
                                             float* smem,
                                             float* __restrict__ acov_out) {
  constexpr int kSpan = kGroups * kJ;  // lags handled by one block
  float* a = smem;                     // (kTile, kLanes)
  float* b = smem + kTile * kLanes;    // (kTile + kSpan, kLanes)
  const int lane = threadIdx.x;
  const int g = threadIdx.y;
  const int s = blockIdx.x * kLanes + lane;
  const bool live = s < nseries;
  const int lag0 = blockIdx.y * kSpan;

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
      if (k <= maxlag)
        acov_out[(size_t)k * nseries + s] = k < niter ? acc[j] / (float)niter
                                                      : 0.f;
    }
  }
}

// Grid of the lag loop: series blocks in x, lag spans in y.
template <int kJ>
inline dim3 lag_grid(int nseries, int maxlag) {
  constexpr int kSpan = kGroups * kJ;
  return dim3((nseries + kLanes - 1) / kLanes,
              (maxlag + 1 + kSpan - 1) / kSpan);
}

}  // namespace mdt
