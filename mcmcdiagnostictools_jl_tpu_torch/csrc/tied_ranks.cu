// Kernel K12: tied ("average") ranks of sorted rows and their Blom normal
// scores, in one pass over each row, for Hopper.
//
// Stands for three XLA pieces of the JAX package's exact rank mode
// (mcmcdiagnostictools_jl_tpu/ops/ranknorm.py), none of them a Pallas
// kernel: `_avg_ranks_sorted` (:65-82, a cummax and a reverse cummin over the
// run boundaries), the Blom transform with `ndtri` (`ndtri((r - 0.375) / (n +
// 0.25))`, :186, :197, :269) and the inverse permutation back to the original
// order (:198).
//
// Input: xs (p, n) float32, each row ascending (NaN last); optionally order
// (p, n) int64, the original position of each sorted value in its row, and
// bad (p,) bool. Output: out (p, n) float32. Sorted position j of row r gets
// the tied rank (first + last) / 2 of the run of equal values holding j
// (1-based positions; `==` decides equality, so each NaN is a run of one and
// -0.0 joins +0.0; first + last is an integer, rounded once to float32), or,
// with `blom`, its Blom normal score ndtri((rank - 0.375) * inv_b). inv_b is
// 1 / (n + 0.25) rounded to float32, as PyTorch's division by a Python
// scalar on the card computes it (a product with the scalar's reciprocal).
// The value goes to out[r, j], or to out[r, order[r, j]] when order is given
// (the bulk transform's scatter back along the row). A row with bad[r] set
// comes out NaN throughout, and nothing of it is read.
//
// One launch. A block owns kTile = 4096 entries of one row, and the blocks
// go row after row, so the ~1000 in flight scatter into a few rows (~20 MB)
// that stay in the 50 MB L2 while their sectors fill. The block stages its
// stretch of the row in shared memory by coalesced loads. Each thread takes
// kItems consecutive entries and marks in two bit masks where runs start and
// end; the block finds each entry's run start by a max-scan of start
// positions and its run end by a min-scan from the right (warp shuffles, one
// exchange of warp totals through shared memory), writes the values back to
// shared memory and stores them coalesced (or scatters them, reading order
// coalesced). Only the first and the last run of a tile can cross its edges.
// Their true ends come from a 32-way search over the row in device memory,
// one warp each (32 probes a round, a ballot keeps the stretch between the
// last false and the first true probe): ~5 dependent loads at n = 1.28M,
// and none where no run crosses the edge, as in almost every tile of
// continuous data. A search stays inside [0, n) and ends after at most
// log32(n) + 1 rounds whatever the row holds, so a row that is not NaN-last
// (the card's radix sort puts a sign-bit NaN first) is read in bounds; its
// values are then meaningless, and every caller masks such a row.
//
// ndtri is Cephes' algorithm in float32 with the operations in the order of
// PyTorch's CUDA build (ATen/native/cuda/Math.cuh, `ndtri_string`, as
// `calc_ndtri` in ATen/native/Math.h), so the kernel's z follows
// `torch.special.ndtri` on the card.
//
// What bounds it on an H100: the bytes, 4 read and 4 written an entry (0.78
// ms at (256, 1.28M)), 16 with order (its int64 position read: 1.56 ms).
// The arithmetic (a scan step and ndtri's ~30-90 operations an entry) stays
// below that.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                 // consecutive entries a thread
constexpr int kTile = kThreads * kItems;   // entries of one row a block
constexpr int kNone = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kItems <= 31, "a thread's flags fit one 32-bit mask");

// shared-memory slot of tile entry e: one pad word every 32 entries, so
// that the threads of a warp reading kItems consecutive entries each fall
// on 32 different banks
__device__ __forceinline__ int slot(int e) { return e + (e >> 5); }

// Cephes ndtri's coefficients (PyTorch's order, float32 from these decimals)
__constant__ float kP0[5] = {
    -5.99633501014107895267E1, 9.80010754185999661536E1,
    -5.66762857469070293439E1, 1.39312609387279679503E1,
    -1.23916583867381258016E0};
__constant__ float kQ0[9] = {
    1.00000000000000000000E0,  1.95448858338141759834E0,
    4.67627912898881538453E0,  8.63602421390890590575E1,
    -2.25462687854119370527E2, 2.00260212380060660359E2,
    -8.20372256168333339912E1, 1.59056225126211695515E1,
    -1.18331621121330003142E0};
__constant__ float kP1[9] = {
    4.05544892305962419923E0,  3.15251094599893866154E1,
    5.71628192246421288162E1,  4.40805073893200834700E1,
    1.46849561928858024014E1,  2.18663306850790267539E0,
    -1.40256079171354495875E-1, -3.50424626827848203418E-2,
    -8.57456785154685413611E-4};
__constant__ float kQ1[9] = {
    1.00000000000000000000E0,  1.57799883256466749731E1,
    4.53907635128879210584E1,  4.13172038254672030440E1,
    1.50425385692907503408E1,  2.50464946208309415979E0,
    -1.42182922854787788574E-1, -3.80806407691578277194E-2,
    -9.33259480895457427372E-4};
__constant__ float kP2[9] = {
    3.23774891776946035970E0,  6.91522889068984211695E0,
    3.93881025292474443415E0,  1.33303460815807542389E0,
    2.01485389549179081538E-1, 1.23716634817820021358E-2,
    3.01581553508235416007E-4, 2.65806974686737550832E-6,
    6.23974539184983293730E-9};
__constant__ float kQ2[9] = {
    1.00000000000000000000E0,  6.02427039364742014255E0,
    3.67983563856160859403E0,  1.37702099489081330271E0,
    2.16236993594496635890E-1, 1.34204006088543189037E-2,
    3.28014464682127739104E-4, 2.89247864745380683936E-6,
    6.79019408009981274425E-9};

template <int kLen>
__device__ __forceinline__ float polevl(float x, const float* a) {
  float r = 0.f;
#pragma unroll
  for (int i = 0; i < kLen; ++i) r = r * x + a[i];
  return r;
}

__device__ __forceinline__ float ndtri_f32(float y0) {
  const float zero = 0.f, one = 1.f;
  const float exp_m2 = 0.13533528323661269189;  // exp(-2)
  if (y0 == zero) return -INFINITY;
  if (y0 == one) return INFINITY;
  if (y0 < zero || y0 > one) return NAN;
  bool code = true;
  float y = y0;
  if (y > one - exp_m2) {
    y = one - y;
    code = false;
  }
  if (y > exp_m2) {  // 0 <= |y - 0.5| <= 3/8
    const float s2pi = 2.50662827463100050242;  // sqrt(2 pi)
    y = y - 0.5f;
    const float y2 = y * y;
    const float x = y + y * (y2 * polevl<5>(y2, kP0) / polevl<9>(y2, kQ0));
    return x * s2pi;
  }
  float x = sqrtf(-2.f * logf(y));
  const float x0 = x - (logf(x) / x);
  const float z = one / x;
  float x1;
  if (x < 8.f) {  // y > exp(-32)
    x1 = z * polevl<9>(z, kP1) / polevl<9>(z, kQ1);
  } else {
    x1 = z * polevl<9>(z, kP2) / polevl<9>(z, kQ2);
  }
  x = x0 - x1;
  return (!code) ? x : -x;
}

// The first k in [lo, hi) whose value v = row[k] satisfies the predicate
// (kAbove: !(v <= x), the entries past x's run; else !(v < x), the entries
// from x's run on), or hi: for a row ascending with NaN last the predicate
// is false, then true. Whatever the row holds, the result lies in [lo, hi],
// only entries in [lo, hi) are read, and every round shrinks the stretch.
// Called by all lanes of one warp with the same arguments.
template <bool kAbove>
__device__ int warp_search(const float* row, int lo, int hi, float x) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {
    const int step = (int)(((long long)hi - lo + 31) >> 5);
    const long long k = (long long)lo + (long long)lane * step;
    bool hit = false;
    if (k < hi) {
      const float v = row[k];
      hit = kAbove ? !(v <= x) : !(v < x);
    }
    // a lane past hi stands for the end: true
    const unsigned stop = __ballot_sync(kFull, hit) | ~__ballot_sync(kFull, k < hi);
    if (stop == 0u) {
      lo += 31 * step + 1;
      continue;
    }
    const int f = __ffs(stop) - 1;
    const int kf = (int)min((long long)lo + (long long)f * step, (long long)hi);
    if (f > 0) lo += (f - 1) * step + 1;
    hi = kf;
  }
  return lo;
}

template <bool kBlom>
__global__ void __launch_bounds__(kThreads)
tied_ranks_kernel(const float* __restrict__ xs,
                  const long long* __restrict__ order,
                  const unsigned char* __restrict__ bad, int n, int ntiles,
                  float inv_b, float* __restrict__ out) {
  __shared__ float s_val[kTile + kTile / 32];
  __shared__ int s_first[kWarps], s_last[kWarps];
  // run start of the tile's first entry, run end of its last (0-based)
  __shared__ int s_carry[2];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long row = blockIdx.x / ntiles;
  const int tile0 = (int)(blockIdx.x - row * ntiles) * kTile;
  const int count = min(kTile, n - tile0);
  const float* xr = xs + row * n;
  float* outr = out + row * n;
  if (bad != nullptr && bad[row]) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int e = t + i * kThreads;
      if (e < count) outr[tile0 + e] = NAN;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int e = t + i * kThreads;
    if (e < count) s_val[slot(e)] = xr[tile0 + e];
  }
  const int last = tile0 + count - 1;
  if (warp == 0) {
    int first = tile0;
    if (tile0 > 0) {
      const float x = xr[tile0];
      if (x == xr[tile0 - 1]) first = warp_search<false>(xr, 0, tile0, x);
    }
    if (lane == 0) s_carry[0] = first;
  } else if (warp == 1) {
    int end = last;
    if (last + 1 < n) {
      const float x = xr[last];
      if (x == xr[last + 1]) end = warp_search<true>(xr, last + 1, n, x) - 1;
    }
    if (lane == 0) s_carry[1] = end;
  }
  __syncthreads();

  // bit i of starts / ends: entry e0 + i starts / ends a run (an entry past
  // the row does both)
  const int e0 = t * kItems;
  unsigned starts = 0u, ends = 0u;
  {
    float v[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) v[i] = s_val[slot(e0 + i)];
    const float before = e0 > 0 ? s_val[slot(e0 - 1)] : 0.f;
    const float after = e0 + kItems < kTile ? s_val[slot(e0 + kItems)] : 0.f;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int e = e0 + i;
      bool st, en;
      if (e >= count) {
        st = en = true;
      } else {
        st = e == 0 ? s_carry[0] == tile0 : v[i] != (i == 0 ? before : v[i - 1]);
        en = e == count - 1 ? s_carry[1] == last
                            : v[i] != (i == kItems - 1 ? after : v[i + 1]);
      }
      starts |= (unsigned)st << i;
      ends |= (unsigned)en << i;
    }
  }
  const int g0 = tile0 + e0;  // row position of the thread's first entry
  // the last start and the first end among this thread's entries
  int inc_first = starts ? g0 + 31 - __clz(starts) : -1;
  int inc_last = ends ? g0 + __ffs(ends) - 1 : kNone;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int a = __shfl_up_sync(kFull, inc_first, d);
    const int b = __shfl_down_sync(kFull, inc_last, d);
    if (lane >= d) inc_first = max(inc_first, a);
    if (lane + d < 32) inc_last = min(inc_last, b);
  }
  if (lane == 31) s_first[warp] = inc_first;
  if (lane == 0) s_last[warp] = inc_last;
  // the threads before (after) this one, within the warp
  int carry_first = __shfl_up_sync(kFull, inc_first, 1);
  int carry_last = __shfl_down_sync(kFull, inc_last, 1);
  if (lane == 0) carry_first = -1;
  if (lane == 31) carry_last = kNone;
  __syncthreads();  // also: every neighbour value has been read
  carry_first = max(carry_first, s_carry[0]);
  carry_last = min(carry_last, s_carry[1]);
  for (int w = 0; w < warp; ++w) carry_first = max(carry_first, s_first[w]);
  for (int w = warp + 1; w < kWarps; ++w) carry_last = min(carry_last, s_last[w]);

#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const unsigned below = starts & ((2u << i) - 1u);  // starts at or before i
    const unsigned above = ends >> i;                  // ends at or after i
    const int first = below ? g0 + 31 - __clz(below) : carry_first;
    const int end = above ? g0 + i + __ffs(above) - 1 : carry_last;
    const float rank = __ll2float_rn((long long)first + end + 2) * 0.5f;
    s_val[slot(e0 + i)] = kBlom ? ndtri_f32((rank - 0.375f) * inv_b) : rank;
  }
  __syncthreads();

  if (order != nullptr) {
    const long long* ordr = order + row * n + tile0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int e = t + i * kThreads;
      if (e < count) {
        const long long k = ordr[e];
        if ((unsigned long long)k < (unsigned long long)n) outr[k] = s_val[slot(e)];
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int e = t + i * kThreads;
      if (e < count) outr[tile0 + e] = s_val[slot(e)];
    }
  }
}

}  // namespace

extern "C" int mdt_tied_ranks(const float* xs, const long long* order,
                              const unsigned char* bad, int n, int p, int blom,
                              float inv_b, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int ntiles = (n + kTile - 1) / kTile;
  const unsigned blocks = (unsigned)((long long)ntiles * p);
  if (blom) {
    tied_ranks_kernel<true><<<blocks, kThreads, 0, st>>>(xs, order, bad, n,
                                                         ntiles, inv_b, out);
  } else {
    tied_ranks_kernel<false><<<blocks, kThreads, 0, st>>>(xs, order, bad, n,
                                                          ntiles, inv_b, out);
  }
  return (int)cudaGetLastError();
}
