// The tiled lag loop shared by kernels K1 (moments_autocov.cu), K5
// (autocov.cu) and K6's variant A (lagloop_study.cu), and its register-blocked
// form, K6's variant B: the biased direct autocovariance of centered series,
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

// The register-blocked form of the same loop (kernel K6's variant B,
// lagloop_study.cu; K1 and K5 call lag_products above). Same tiles, same
// block of 32 series x 8 warps, same result. What differs is which lags a
// warp owns and where the shifted factor lives:
// - warp g owns the kR CONSECUTIVE lags lag0 + g * kR + j, j < kR, so at draw
//   r it needs b[r + g * kR + j] for all j: a window of kR neighbouring rows
//   that slides by one row a draw;
// - the window stays in registers. A draw costs two shared-memory loads (its
//   left factor and the one row that enters the window) for kR FMAs, against
//   one load an FMA above;
// - the draw loop is unrolled by kR, so that the slot the new row replaces,
//   (r mod kR), and every slot an FMA reads, ((r + j) mod kR), are constants:
//   a window indexed by a runtime value would live in local memory;
// - sums go tile by tile as above (part[] in registers, then acc[]), so
//   float32 rounding is the same scheme as lag_products'.
// Rows past the tile's live rows are zero in `a`, so the loop runs whole
// groups of kR draws. kTile must be a multiple of kR.
template <int kR>
__device__ __forceinline__ void lag_products_blocked(
    const float* __restrict__ x, int niter, int nseries, int maxlag,
    float mean, float* smem, float* __restrict__ acov_out) {
  static_assert(kTile % kR == 0, "the draw loop unrolls by the window length");
  constexpr int kSpan = kGroups * kR;  // lags handled by one block
  float* a = smem;                     // (kTile, kLanes)
  float* b = smem + kTile * kLanes;    // (kTile + kSpan, kLanes)
  const int lane = threadIdx.x;
  const int g = threadIdx.y;
  const int s = blockIdx.x * kLanes + lane;
  const bool live = s < nseries;
  const int lag0 = blockIdx.y * kSpan;

  float acc[kR];
#pragma unroll
  for (int j = 0; j < kR; ++j) acc[j] = 0.f;
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
    // this warp's window starts at row g * kR of b
    const float* bw = b + (g * kR) * kLanes + lane;
    float part[kR], w[kR];
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      part[j] = 0.f;
      w[j] = bw[j * kLanes];
    }
    for (int r0 = 0; r0 < rows; r0 += kR) {
#pragma unroll
      for (int u = 0; u < kR; ++u) {
        const float av = a[(r0 + u) * kLanes + lane];
        // slot (u + j) % kR holds row r0 + u + j of the window
#pragma unroll
        for (int j = 0; j < kR; ++j) part[j] += av * w[(u + j) % kR];
        // row r0 + u leaves the window, row r0 + u + kR enters its slot
        // (at most row kTile + kR - 1 of the window: inside b)
        w[u] = bw[(r0 + u + kR) * kLanes];
      }
    }
#pragma unroll
    for (int j = 0; j < kR; ++j) acc[j] += part[j];
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int k = lag0 + g * kR + j;
      if (k <= maxlag)
        acov_out[(size_t)k * nseries + s] = k < niter ? acc[j] / (float)niter
                                                      : 0.f;
    }
  }
}

}  // namespace mdt
