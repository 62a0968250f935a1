// The lag loops of the port: the biased direct autocovariance of centered
// series,
//     c_k = sum_{i < niter - k} xc_i * xc_{i+k} / niter,   k = 0..maxlag,
// with xc = x - mean, for one block of kLanes = 32 neighbouring series
// (threadIdx.x), so that every row of a block is one coalesced 128-byte
// segment. Lags at or beyond niter are written as 0 (the plain versions'
// value).
//
// What bounds them on an H100: the lag products, niter * (maxlag + 1) FMAs a
// series (82 G at 5000 draws x 65,536 series x 251 lags) against 1.3 GB read.
// An SM sub-partition dispatches one warp instruction a cycle and one warp-wide
// FMA a cycle, so every instruction that is not an FMA costs an FMA, and an
// SM starts one warp-wide shared-memory load a cycle against four FMAs.
//
// lag_products_ring is the production loop: kernels K1 (moments_autocov.cu)
// and K5 (autocov.cu) call it and nothing else, and so does K6's variant B
// (lagloop_study.cu).
// - Warp g owns the kR CONSECUTIVE lags lag0 + g * kR + j, j < kR, and keeps
//   the window of the shifted factor, rows i + g * kR + j, in registers. A
//   draw costs two shared-memory loads (its left factor and the one row that
//   enters the window) and two subtractions (centering, where a value enters
//   a register) for kR FMAs: at kR = 32 the FMAs are 32 of 36 instructions.
// - The draw loop is unrolled by kR, so the slot a new row replaces, (r mod
//   kR), and every slot an FMA reads, ((r + j) mod kR), are constants: a
//   window indexed at run time would live in local memory. The window carries
//   over from tile to tile, because the tile is a multiple of kR.
// - Every draw is staged ONCE, raw, into a ring of rows in shared memory that
//   holds the tile in work, the block's lag span behind it and kAhead further
//   tiles, filled with cp.async (16 bytes a thread where the series count
//   allows, else 4) ahead of use: the one barrier of a tile waits for copies
//   that were started kAhead tiles earlier, not for device memory. All ring
//   positions a group of kR draws touches are multiples of kR rows, and so is
//   the ring's length, so a group never wraps and its offsets are constants.
// - Rows at or past niter are staged as the series' mean, so that they read
//   as exact zeros after centering and every lag product is full length.
// - A block whose first lag is not 0 (blockIdx.y > 0: more lags than one
//   span of kWarps * kR) needs the left factor from other rows than the
//   window; it stages them into a second ring of kAhead + 1 tiles. Launches
//   with one span allocate no second ring.
// - Sums: a tile's kTile products are added in draw order in registers
//   (part[]), then the tile sums are added in tile order (acc[]): float32
//   rounding near sqrt(kTile) + niter / kTile terms instead of niter. With
//   kTile = 128 the result equals lag_products' bit for bit (the same values
//   in the same order); a 65-lag call runs kR = 17 with kTile = 136, which
//   rounds differently by ~1e-7 of c_0.
//
// lag_products is the first form of the loop (one shared-memory load per
// FMA, at most a quarter of the FMA rate). It stays as the body of K6's
// variant A only, the counterpart of the TPU study's `_kernel_a`.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace mdt {

constexpr int kLanes = 32;   // series per block
constexpr int kGroups = 8;   // warps per block of lag_products (variant A)
constexpr int kTile = 128;   // draws staged per tile of lag_products
constexpr int kAhead = 2;    // tiles in flight beyond the one in work

// ---- the production loop ---------------------------------------------------

__device__ __forceinline__ void lag_cp_async16(void* smem_dst,
                                               const void* gmem_src) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void lag_cp_async4(void* smem_dst,
                                              const void* gmem_src) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void lag_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void lag_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The loop's instances, (window kR, warps, tile), chosen by lag count so that
// one span covers the call's lags with little waste: 4 warps x 17 = 68 lags
// for the adaptive probe's 65 (3 computed and not written), 8 x 16 = 128, and
// 8 x 32 = 256 for the full 251 (5). More lags than 256 go to further spans
// of 256 in gridDim.y. CALL(kR, kWarps, kT) is a statement that returns.
#define MDT_RING_DISPATCH(maxlag, CALL)   \
  if ((maxlag) + 1 <= 4 * 17) {           \
    CALL(17, 4, 136)                      \
  } else if ((maxlag) + 1 <= 8 * 16) {    \
    CALL(16, 8, 128)                      \
  } else {                                \
    CALL(32, 8, 128)                      \
  }

// Threads of a block, and the blocks an SM should hold (512 threads: at most
// 128 registers a thread).
#define MDT_RING_BOUNDS(kWarps) \
  __launch_bounds__(mdt::kLanes * (kWarps), 16 / (kWarps))

// Whether every row of every block starts on a 16-byte boundary.
inline int rows_aligned16(const float* x, int nseries) {
  return ((uintptr_t)x % 16 == 0 && nseries % 4 == 0) ? 1 : 0;
}

// Rows of the ring of the shifted factor: the tile in work, the span, and
// kAhead tiles in flight. A multiple of kR.
template <int kR, int kWarps, int kT>
__host__ __device__ constexpr int ring_rows() {
  return kWarps * kR + (kAhead + 1) * kT;
}

// Dynamic shared memory of one block: the ring, and for a launch with more
// than one lag span the second ring of the left factor.
template <int kR, int kWarps, int kT>
constexpr size_t ring_smem_bytes(bool two_rings) {
  return (size_t)(ring_rows<kR, kWarps, kT>() +
                  (two_rings ? (kAhead + 1) * kT : 0)) *
         kLanes * sizeof(float);
}

// Grid: series blocks in x, lag spans of kWarps * kR in y.
template <int kR, int kWarps>
inline dim3 ring_grid(int nseries, int maxlag) {
  constexpr int kSpan = kWarps * kR;
  return dim3((nseries + kLanes - 1) / kLanes, (maxlag + kSpan) / kSpan);
}

// Rows [grow, grow + count) of the block's 32 series into `ring` (`rows`
// long), the first at ring position `pos`; a row at or past niter, and a
// series at or past nseries, is staged as the series' mean (`s_mean`, 0 for
// a series that does not exist). `vec`: rows are 16-byte aligned.
template <int kThreads>
__device__ __forceinline__ void stage_rows(const float* __restrict__ x,
                                           int niter, int nseries, int s0,
                                           int grow, int count, float* ring,
                                           int rows, int pos,
                                           const float* s_mean, bool vec) {
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  if (vec) {
    for (int v = tid; v < count * (kLanes / 4); v += kThreads) {
      const int r = v >> 3, q = (v & 7) * 4;
      int p = pos + r;
      if (p >= rows) p -= rows;
      float* dst = ring + p * kLanes + q;
      const int i = grow + r, s = s0 + q;
      if (i < niter && s < nseries)
        lag_cp_async16(dst, x + (size_t)i * nseries + s);
      else
        *reinterpret_cast<float4*>(dst) =
            *reinterpret_cast<const float4*>(s_mean + q);
    }
  } else {
    for (int v = tid; v < count * kLanes; v += kThreads) {
      const int r = v >> 5, q = v & 31;
      int p = pos + r;
      if (p >= rows) p -= rows;
      float* dst = ring + p * kLanes + q;
      const int i = grow + r, s = s0 + q;
      if (i < niter && s < nseries)
        lag_cp_async4(dst, x + (size_t)i * nseries + s);
      else
        *dst = s_mean[q];
    }
  }
}

// The lags of this block (blockIdx.y) for the series of this block
// (blockIdx.x). `s_mean`: shared memory, the 32 series' centering means (0
// for a series at or past nseries, and for series that are centered
// already), written before the call; the function begins with a barrier.
// `smem`: ring_smem_bytes(gridDim.y > 1). kCenter false skips the
// subtraction (means of 0). Every thread of the block (kLanes x kWarps) must
// call it. Returns the thread's first lag's sum of products (for warp 0 of
// blockIdx.y 0: the centered sum of squares).
template <int kR, int kWarps, int kT, bool kCenter>
__device__ __forceinline__ float lag_products_ring(
    const float* __restrict__ x, int niter, int nseries, int maxlag,
    const float* s_mean, bool vec, float* smem,
    float* __restrict__ acov_out) {
  static_assert(kT % kR == 0, "the draw loop unrolls by the window length");
  constexpr int kSpan = kWarps * kR;
  constexpr int kThreads = kWarps * kLanes;
  constexpr int kRows = ring_rows<kR, kWarps, kT>();
  constexpr int kRowsA = (kAhead + 1) * kT;
  const int lane = threadIdx.x;
  const int g = threadIdx.y;
  const int s0 = blockIdx.x * kLanes;
  const int s = s0 + lane;
  const int lag0 = blockIdx.y * kSpan;
  const bool own_a = lag0 != 0;  // block-uniform
  float* ring = smem;
  float* ring_a = own_a ? smem + kRows * kLanes : smem;
  const int rows_a = own_a ? kRowsA : kRows;

  float acc[kR];
#pragma unroll
  for (int j = 0; j < kR; ++j) acc[j] = 0.f;

  if (lag0 < niter) {
    __syncthreads();  // s_mean is written
    const float mean = kCenter ? s_mean[lane] : 0.f;
    // the ring is filled whole: rows lag0 + [0, kRows), the first tile with
    // its span in the first group, one tile in each further group
    stage_rows<kThreads>(x, niter, nseries, s0, lag0, kSpan + kT, ring, kRows,
                         0, s_mean, vec);
    if (own_a)
      stage_rows<kThreads>(x, niter, nseries, s0, 0, kT, ring_a, kRowsA, 0,
                           s_mean, vec);
    lag_cp_async_commit();
#pragma unroll
    for (int p = 1; p <= kAhead; ++p) {
      stage_rows<kThreads>(x, niter, nseries, s0, lag0 + kSpan + p * kT, kT,
                           ring, kRows, kSpan + p * kT, s_mean, vec);
      if (own_a)
        stage_rows<kThreads>(x, niter, nseries, s0, p * kT, kT, ring_a,
                             kRowsA, p * kT, s_mean, vec);
      lag_cp_async_commit();
    }

    float w[kR];
    // ring positions of the group in work: the left factor's row i0 + r0,
    // and the row that enters this warp's window, i0 + r0 + (g + 1) * kR
    int pos_a = 0, pos_b = (g + 1) * kR, pos_new = 0, pos_new_a = 0;
    for (int i0 = 0; i0 < niter; i0 += kT) {
      // tile t's rows are group t; kAhead + t groups are committed (one more
      // before the first tile, which then waits for a group too many)
      lag_cp_async_wait<kAhead - 1>();
      __syncthreads();  // landed for every thread; the last tile is consumed
      if (i0 > 0) {
        // rows kAhead tiles ahead replace the tile consumed last
        const int ahead = i0 + kAhead * kT;
        stage_rows<kThreads>(x, niter, nseries, s0, lag0 + kSpan + ahead, kT,
                             ring, kRows, pos_new, s_mean, vec);
        if (own_a)
          stage_rows<kThreads>(x, niter, nseries, s0, ahead, kT, ring_a,
                               kRowsA, pos_new_a, s_mean, vec);
        lag_cp_async_commit();
        pos_new += kT;
        if (pos_new >= kRows) pos_new -= kRows;
        pos_new_a += kT;
        if (pos_new_a == kRowsA) pos_new_a = 0;
      } else {
        const float* bw = ring + (g * kR) * kLanes + lane;
#pragma unroll
        for (int j = 0; j < kR; ++j)
          w[j] = kCenter ? bw[j * kLanes] - mean : bw[j * kLanes];
      }

      float part[kR];
#pragma unroll
      for (int j = 0; j < kR; ++j) part[j] = 0.f;
      // rows past niter are zero after centering: whole groups of kR draws
      const int groups = (min(kT, niter - i0) + kR - 1) / kR;
      for (int q = 0; q < groups; ++q) {
        const float* ap = ring_a + pos_a * kLanes + lane;
        const float* bp = ring + pos_b * kLanes + lane;
#pragma unroll
        for (int u = 0; u < kR; ++u) {
          const float av = kCenter ? ap[u * kLanes] - mean : ap[u * kLanes];
          // slot (u + j) % kR holds row r0 + u + j of the window
#pragma unroll
          for (int j = 0; j < kR; ++j) part[j] += av * w[(u + j) % kR];
          // row r0 + u leaves the window, row r0 + u + kR enters its slot
          w[u] = kCenter ? bp[u * kLanes] - mean : bp[u * kLanes];
        }
        pos_a += kR;
        if (pos_a == rows_a) pos_a = 0;
        pos_b += kR;
        if (pos_b == kRows) pos_b = 0;
      }
      // a cut last tile leaves the positions off the tile grid; no tile
      // follows it
#pragma unroll
      for (int j = 0; j < kR; ++j) acc[j] += part[j];
    }
    lag_cp_async_wait<0>();  // nothing in flight when the block ends
  }
  if (s < nseries) {
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int k = lag0 + g * kR + j;
      if (k <= maxlag)
        acov_out[(size_t)k * nseries + s] = k < niter ? acc[j] / (float)niter
                                                      : 0.f;
    }
  }
  return acc[0];
}

// ---- variant A of the study --------------------------------------------------

// Dynamic shared memory of one block of lag_products with kJ lags a warp.
template <int kJ>
constexpr size_t lag_smem_bytes() {
  return (size_t)(kTile * kLanes + (kTile + kGroups * kJ) * kLanes) *
         sizeof(float);
}

// The first form of the loop: warp g keeps the lags lag0 + g, lag0 + g + 8,
// ... in registers; each tile stages kTile centered draws (the left factor)
// and kTile + span centered draws starting at the block's first lag (the
// shifted factor) in shared memory between two barriers, zero past niter;
// every FMA reads its shifted factor from shared memory. Sums tile by tile,
// as above. `smem` holds lag_smem_bytes<kJ>(). Every thread of the block
// (kLanes x kGroups) must call it.
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

// Grid of lag_products: series blocks in x, lag spans in y.
template <int kJ>
inline dim3 lag_grid(int nseries, int maxlag) {
  constexpr int kSpan = kGroups * kJ;
  return dim3((nseries + kLanes - 1) / kLanes,
              (maxlag + 1 + kSpan - 1) / kSpan);
}

}  // namespace mdt
