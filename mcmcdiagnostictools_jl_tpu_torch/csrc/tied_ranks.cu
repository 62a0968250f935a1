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
// with `blom`, its Blom normal score ndtri((rank - 3/8) / (n + 1/4)), formed
// as `blom_score` says: the numerator exact in integers and, on the upper
// half of the row, taken from the far end, so that the top score stays
// finite however long the row. inv_b is 1 / (n + 0.25) rounded to float32,
// as PyTorch's division by a Python scalar on the card computes it (a
// product with the scalar's reciprocal).
// The value goes to out[r, j], or to out[r, order[r, j]] when order is given
// (the bulk transform's scatter back along the row). A row with bad[r] set
// comes out NaN throughout, and nothing of it is read.
//
// The runs. A block owns kTile = 4096 entries of one row, and the blocks go
// row after row. The block stages its stretch of the row in shared memory by
// coalesced loads. Each thread takes kItems consecutive entries and marks in
// two bit masks where runs start and end; the block finds each entry's run
// start by a max-scan of start positions and its run end by a min-scan from
// the right (warp shuffles, one exchange of warp totals through shared
// memory). Only the first and the last run of a tile can cross its edges.
// Their true ends come from a 32-way search over the row in device memory,
// one warp each (32 probes a round, a ballot keeps the stretch between the
// last false and the first true probe): ~5 dependent loads at n = 1.28M,
// and none where no run crosses the edge, as in almost every tile of
// continuous data. A search stays inside [0, n) and ends after at most
// log32(n) + 1 rounds whatever the row holds, so a row that is not NaN-last
// (the card's radix sort puts a sign-bit NaN first) is read in bounds; its
// values are then meaningless, and every caller masks such a row. Every
// run's first and last position lie in [0, n) whatever the row holds, so
// k = first + last + 2 (0-based positions) lies in [2, 2n].
//
// The Blom scores, from a table. A score depends only on k, and n is the
// same for every row of a launch, so for n <= kTableMaxN = 2^22 a small
// kernel first fills T[k] = blom_score(k) for k in
// [0, 2n] (`blom_table_kernel`, 2n + 1 evaluations: 2.56 M at n = 1.28M, tens
// of microseconds), and the main kernel reads T[k] in place of running ndtri
// once an entry (327 M times at (256, 1.28M)). The table's entries are
// computed by the same function (`blom_score`) on the same k, so they are
// bit-equal to the scores computed an entry at a time. The table holds 8n +
// 4 bytes (10.2 MB at n = 1.28M; at most 32 MB), which stay in the 50 MB L2
// while every row of the launch reads them: in sorted order a row's k goes
// up by 2 from one entry to the next where there are no ties (stride 2, a
// sector serves four entries) and stands still along a run of ties. Longer
// rows compute ndtri an entry (`kBlomNdtri`); the mode is a template
// parameter chosen by the wrapper from n.
//
// The scatter back, in two passes that write whole sectors (order given).
// A row's columns fall into buckets of kBucket = 32768 consecutive columns
// (128 KB of float32), and since order is a permutation of each row, bucket
// b of a row receives exactly min(kBucket, n - b kBucket) values. Pass A
// (`tied_ranks_kernel<.., true>`) copies the tile's columns from order into
// shared memory by cp.async while it computes the tile's values as above,
// then partitions its (column, value) pairs by bucket in shared memory (a
// counter a bucket, kSweep buckets at a time), reserves room in each bucket
// of its row with one atomicAdd on a per-(row, bucket) cursor, and writes
// each bucket's pairs as one contiguous run into the pair buffer, laid out
// like the rows: bucket b of row r at pairs[r n + b kBucket ...], so the
// buffer needs no counting pre-pass and cannot overflow. Pass B
// (`place_kernel`) is one block a (row, bucket): it reads the bucket's pairs
// contiguously, puts each value at its column in a shared-memory copy of the
// bucket and writes the bucket's columns of out with 16-byte stores. The
// order of the pairs inside a bucket depends on the atomics, but every
// column is written once with a value that does not, so the output is
// bit-equal to a scatter of the sorted values, and two runs are bit-equal.
// Pass B fills a bad row with NaN; pass A reads nothing of it. The wrapper
// runs the rows in groups (pass A, then pass B, for each group) so that the
// pair buffer, 8 bytes an entry of a group, costs at most one float32 (p, n)
// array.
//
// ndtri is Cephes' algorithm in float32 with the operations in the order of
// PyTorch's CUDA build (ATen/native/cuda/Math.cuh, `ndtri_string`, as
// `calc_ndtri` in ATen/native/Math.h), so the kernel's z follows
// `torch.special.ndtri` on the card.
//
// What bounds it on an H100: the bytes the function needs, 4 read and 4
// written an entry (0.78 ms at (256, 1.28M)), 16 with order (its int64
// position read: 1.56 ms). The two passes move 32 bytes an entry (read 4 +
// 8, pairs written 8 and read 8, out written 4) in whole sectors, in place
// of 16 bytes with a 4-byte write to a random column of a 5.1 MB row, which
// the L2 takes as a partial-sector write.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// what a block's entries become: the tied rank, or its Blom score read from
// the launch's table, or computed an entry
enum Mode { kRanks = 0, kBlomTable = 1, kBlomNdtri = 2 };
constexpr int kTableMaxN = 1 << 22;  // longest row with a table (32 MB)
constexpr int kTableThreads = 256;
constexpr int kLogBucket = 15;
constexpr int kBucket = 1 << kLogBucket;  // columns of one scatter bucket
constexpr int kSweep = 512;               // buckets pass A counts at a time
constexpr int kPlaceThreads = 1024;
constexpr int kOrderBytes = kTile * 8;    // pass A's dynamic shared memory

// an 8-byte copy from device to shared memory that the thread waits for
// with cp_async_wait
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the value of an entry whose run's 1-based first and last positions add up
// to k: k rounded once to float32, then halved (exact)
__device__ __forceinline__ float tied_rank(long long k) {
  return __ll2float_rn(k) * 0.5f;
}

// the Blom score ndtri((r - 3/8) / (n + 1/4)) of the tied rank r = k / 2 in
// a row of n. In float32 the argument of the top rank rounds to 1 from n =
// 2^24 on (ndtri: +inf), and r itself stops being exact, so the numerator is
// formed exactly in 64-bit integers, eight times over, and on the upper half
// (k > n) from the far end, n - r + 5/8, with the score's sign flipped
// (ndtri(1 - y) = -ndtri(y)): a8 = 8 min(r - 3/8, n - r + 5/8), the distance
// of 8 (r - 3/8) from the middle c8 = 8 (n / 2 + 1 / 8) taken off c8 (= 4
// min(k, 2n + 2 - k) - 3). a8 is rounded once to float32 (exact up to 2^24),
// then multiplied by 1/8 (exact) and by inv_b; the plain version
// (kernels/tiedrank.py, `blom_scores`) forms the same a8 and rounds it alike.
// (A 32-bit form with a 64-bit fallback for n >= 2^28 read 9 % slower in the
// scatter's pass A at 125 x 6.25M, against 0.9 % for this one.)
__device__ __forceinline__ float blom_score(long long k, int n, float inv_b) {
  const long long c8 = 4LL * n + 1;
  const long long d8 = 4LL * k - 3 - c8;
  const long long a8 = c8 - (d8 < 0 ? -d8 : d8);
  const float z = ndtri_f32(__ll2float_rn(a8) * 0.125f * inv_b);
  return k > n ? -z : z;
}

__global__ void __launch_bounds__(kTableThreads)
blom_table_kernel(int n, float inv_b, float* __restrict__ table) {
  const int k = blockIdx.x * kTableThreads + threadIdx.x;
  if (k <= 2 * n) table[k] = blom_score(k, n, inv_b);
}

// Pass A's second half: the values v of this thread's entries e = t + i
// kThreads of the tile, with their columns col (-1: none), go to the pair
// buffer row pr (the row's n slots), each bucket's as one contiguous run at
// a place reserved on the row's cursors.
__device__ __forceinline__ void emit_pairs(const float (&v)[kItems],
                                           const int (&col)[kItems], int n,
                                           float* s_pv, int* s_pd,
                                           int* __restrict__ cursor,
                                           int2* __restrict__ pr) {
  __shared__ int s_cnt[kSweep], s_start[kSweep], s_base[kSweep];
  __shared__ int s_total;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nb = (n + kBucket - 1) >> kLogBucket;
  for (int s0 = 0; s0 < nb; s0 += kSweep) {
    const int ns = min(kSweep, nb - s0);
    for (int b = t; b < ns; b += kThreads) s_cnt[b] = 0;
    __syncthreads();  // also: the staging area is free
    int rk[kItems];   // place of the entry among its bucket's, or -1
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const unsigned b = (unsigned)((col[i] >> kLogBucket) - s0);
      rk[i] = col[i] >= 0 && b < (unsigned)ns ? atomicAdd(&s_cnt[b], 1) : -1;
    }
    __syncthreads();
    if (warp == 0) {  // the buckets' starts in the staging area
      int carry = 0;
      for (int c0 = 0; c0 < ns; c0 += 32) {
        const int b = c0 + lane;
        const int c = b < ns ? s_cnt[b] : 0;
        int inc = c;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(kFull, inc, d);
          if (lane >= d) inc += y;
        }
        if (b < ns) s_start[b] = carry + inc - c;
        carry += __shfl_sync(kFull, inc, 31);
      }
      if (lane == 0) s_total = carry;
    } else {  // meanwhile the other warps reserve room in the buckets
      for (int b = t - 32; b < ns; b += kThreads - 32) {
        const int c = s_cnt[b];
        s_base[b] = c ? atomicAdd(&cursor[s0 + b], c) : 0;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (rk[i] >= 0) {
        const int j = s_start[(col[i] >> kLogBucket) - s0] + rk[i];
        s_pv[j] = v[i];
        s_pd[j] = col[i];
      }
    }
    __syncthreads();
    // consecutive threads on consecutive pairs of a bucket's run
    const int total = s_total;
    for (int j = t; j < total; j += kThreads) {
      const int c = s_pd[j];
      const int b = c >> kLogBucket;
      const int pos = s_base[b - s0] + (j - s_start[b - s0]);
      // at most the bucket's size (order a permutation: always)
      if (pos < min(kBucket, n - (b << kLogBucket))) {
        pr[(b << kLogBucket) + pos] = make_int2(__float_as_int(s_pv[j]), c);
      }
    }
  }
}

// kScatter false: out (p, n) in sorted order. kScatter true (pass A): the
// pairs (value, column) of rows xs[0, p) into pairs (p, n), their counts
// into cursor (p, nb), zeroed before.
// Blocks a multiprocessor: pass A 3 (80 registers; at 64 it spills and is
// slower), sorted order 5 (at most 51 registers; faster than 4 blocks at 62).
template <int kMode, bool kScatter>
__global__ void __launch_bounds__(kThreads, kScatter ? 3 : 5)
tied_ranks_kernel(const float* __restrict__ xs,
                  const long long* __restrict__ order,
                  const unsigned char* __restrict__ bad, int n, int ntiles,
                  const float* __restrict__ table, float inv_b,
                  float* __restrict__ out, int* __restrict__ cursor,
                  int2* __restrict__ pairs) {
  // the tile's values (slot(e))
  __shared__ __align__(16) float s_val[kTile + kTile / 32];
  // kScatter: the tile's columns (kOrderBytes), copied in while its values
  // are found; afterwards the staging area of its pairs (values in the
  // first kTile words, columns in the next)
  extern __shared__ __align__(16) long long s_ord[];
  __shared__ int s_first[kWarps], s_last[kWarps];
  // run start of the tile's first entry, run end of its last (0-based)
  __shared__ int s_carry[2];
  int* s_key = reinterpret_cast<int*>(s_val);  // kBlomTable: each entry's k
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long row = blockIdx.x / ntiles;
  const int tile0 = (int)(blockIdx.x - row * ntiles) * kTile;
  const int count = min(kTile, n - tile0);
  const float* xr = xs + row * n;
  if (bad != nullptr && bad[row]) {
    if constexpr (!kScatter) {  // (pass B fills a bad row)
      float* outr = out + row * n;
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int e = t + i * kThreads;
        if (e < count) outr[tile0 + e] = NAN;
      }
    }
    return;
  }
  if constexpr (kScatter) {
    const long long* ordr = order + row * n + tile0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int e = t + i * kThreads;
      if (e < count) cp_async8(s_ord + e, ordr + e);
    }
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
    const long long k = (long long)first + end + 2;
    if constexpr (kMode == kRanks) {
      s_val[slot(e0 + i)] = tied_rank(k);
    } else if constexpr (kMode == kBlomTable) {
      s_key[slot(e0 + i)] = (int)k;  // looked up below, a warp's together
    } else {
      s_val[slot(e0 + i)] = blom_score(k, n, inv_b);
    }
  }
  __syncthreads();
  // the value of tile entry e
  auto value = [&](int e) {
    if constexpr (kMode == kBlomTable) return __ldg(table + s_key[slot(e)]);
    else return s_val[slot(e)];
  };

  if constexpr (kScatter) {
    cp_async_wait();  // a thread reads only the columns it copied
    float v[kItems];
    int col[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int e = t + i * kThreads;
      col[i] = -1;
      v[i] = 0.f;
      if (e < count) {
        const long long c = s_ord[e];
        v[i] = value(e);
        if ((unsigned long long)c < (unsigned long long)n) col[i] = (int)c;
      }
    }
    const int nb = (n + kBucket - 1) >> kLogBucket;
    float* s_pv = reinterpret_cast<float*>(s_ord);
    emit_pairs(v, col, n, s_pv, reinterpret_cast<int*>(s_pv + kTile),
               cursor + row * nb, pairs + row * n);
  } else {
    float* outr = out + row * n;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int e = t + i * kThreads;
      if (e < count) outr[tile0 + e] = value(e);
    }
  }
}

// Pass B: block (r, b) puts bucket b of row r together from its pairs and
// writes columns [b kBucket, b kBucket + size) of out's row r whole; a bad
// row gets NaN.
__global__ void __launch_bounds__(kPlaceThreads, 1)
place_kernel(const int2* __restrict__ pairs, const int* __restrict__ cursor,
             const unsigned char* __restrict__ bad, int n, int nb,
             float* __restrict__ out) {
  // the bucket, shifted by sh words so that out's 16-byte words fall on
  // s_bkt's
  extern __shared__ __align__(16) float s_bkt[];
  const int t = threadIdx.x;
  const long long row = blockIdx.x / nb;
  const int b = (int)(blockIdx.x - row * nb);
  const int c0 = b << kLogBucket;
  const int size = min(kBucket, n - c0);
  float* dst = out + row * n + c0;
  const int sh = (int)((reinterpret_cast<uintptr_t>(dst) >> 2) & 3);
  if (bad != nullptr && bad[row]) {
    for (int i = t; i < size; i += kPlaceThreads) s_bkt[sh + i] = NAN;
  } else {
    const int m = min(cursor[blockIdx.x], size);
    const int2* pr = pairs + row * n + c0;
#pragma unroll 8
    for (int i = t; i < m; i += kPlaceThreads) {
      const int2 q = __ldcs(pr + i);  // read once: do not keep in the L2
      const unsigned off = (unsigned)(q.y - c0);
      if (off < (unsigned)size) s_bkt[sh + off] = __int_as_float(q.x);
    }
  }
  __syncthreads();
  float4* dv = reinterpret_cast<float4*>(dst - sh);
  const int nv = (sh + size + 3) >> 2;
  for (int i = t; i < nv; i += kPlaceThreads) {
    const int w = 4 * i;
    if (w >= sh && w + 4 <= sh + size) {
      dv[i] = *reinterpret_cast<const float4*>(s_bkt + w);
    } else {  // the bucket's ragged ends
      for (int c = max(w, sh); c < min(w + 4, sh + size); ++c)
        dst[c - sh] = s_bkt[c];
    }
  }
}

template <int kMode>
cudaError_t launch_rows(const float* xs, const long long* order,
                 const unsigned char* bad, int n, int p, const float* table,
                 float inv_b, float* out, int* cursor, int2* pairs,
                 cudaStream_t st) {
  const int ntiles = (n + kTile - 1) / kTile;
  const unsigned blocks = (unsigned)((long long)ntiles * p);
  if (order == nullptr) {
    tied_ranks_kernel<kMode, false><<<blocks, kThreads, 0, st>>>(
        xs, nullptr, bad, n, ntiles, table, inv_b, out, nullptr, nullptr);
  } else {
    const cudaError_t e = cudaFuncSetAttribute(
        tied_ranks_kernel<kMode, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kOrderBytes);
    if (e != cudaSuccess) return e;
    tied_ranks_kernel<kMode, true><<<blocks, kThreads, kOrderBytes, st>>>(
        xs, order, bad, n, ntiles, table, inv_b, nullptr, cursor, pairs);
  }
  return cudaGetLastError();
}

}  // namespace

// T[k] = the Blom score of k for k in [0, 2n]: table (2n + 1,) float32
extern "C" int mdt_blom_table(int n, float inv_b, float* table, void* stream) {
  const int count = 2 * n + 1;
  blom_table_kernel<<<(count + kTableThreads - 1) / kTableThreads,
                      kTableThreads, 0, (cudaStream_t)stream>>>(n, inv_b,
                                                               table);
  return (int)cudaGetLastError();
}

// order null: the values of rows xs (p, n) in sorted order into out (p, n).
// order given (pass A): their pairs into pairs (p, n) of (value bits,
// column) and their counts into cursor (p, ceil(n / kBucket)), which this
// zeroes first; out unused. mode: 0 ranks, 1 Blom scores from table (made
// by mdt_blom_table for this n), 2 Blom scores computed an entry.
extern "C" int mdt_tied_ranks(const float* xs, const long long* order,
                              const unsigned char* bad, int n, int p, int mode,
                              const float* table, float inv_b, float* out,
                              int* cursor, void* pairs, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (order != nullptr) {
    const size_t nb = (size_t)((n + kBucket - 1) >> kLogBucket);
    const cudaError_t e = cudaMemsetAsync(cursor, 0, nb * p * sizeof(int), st);
    if (e != cudaSuccess) return (int)e;
  }
  int2* pr = static_cast<int2*>(pairs);
  if (mode == kRanks) {
    return (int)launch_rows<kRanks>(xs, order, bad, n, p, table, inv_b, out,
                                    cursor, pr, st);
  }
  if (mode == kBlomTable) {
    if (n > kTableMaxN || table == nullptr) return (int)cudaErrorInvalidValue;
    return (int)launch_rows<kBlomTable>(xs, order, bad, n, p, table, inv_b,
                                        out, cursor, pr, st);
  }
  return (int)launch_rows<kBlomNdtri>(xs, order, bad, n, p, table, inv_b, out,
                                      cursor, pr, st);
}

// Pass B: rows (p, n) of out from the pairs and counts of pass A, bad rows
// NaN.
extern "C" int mdt_tied_ranks_place(const void* pairs, const int* cursor,
                                    const unsigned char* bad, int n, int p,
                                    float* out, void* stream) {
  const int nb = (n + kBucket - 1) >> kLogBucket;
  const int smem = (kBucket + 4) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      place_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  place_kernel<<<(unsigned)((long long)nb * p), kPlaceThreads, smem,
                 (cudaStream_t)stream>>>(static_cast<const int2*>(pairs),
                                         cursor, bad, n, nb, out);
  return (int)cudaGetLastError();
}

// Kernel K15: the ring route's Blom scores from its counts, in one pass.
//
// Stands for the elementwise XLA of the JAX package's
// `parallel/ring_rank.py::rank_normal_from_counts` (no Pallas kernel), which
// the port ran as eleven PyTorch passes over the counts (`blom_scores`: the
// int32 add, compare, subtract, minimum, product and difference, the cast,
// the float product, `ndtri`, the negation and the `where`), ~94 B an entry.
//
// Input: t, `count` int32 entries of a rank's rows, each the twice-rank minus
// one, 2 cl + ce, of its entry among the n entries of a row of the chain
// group (kernels/mergecount.py). Output, over t's own storage: the float32
// blom_score(t + 1, n, inv_b), bit for bit what the plain `blom_scores(t +
// 1, n)` gives (the same integer numerator and the same ndtri as K12).
//
// What bounds it on an H100: 8 bytes an entry, the count read and the score
// written (2.5 GB at the sharded cell's (50, 6.25M): 0.75 ms at 3.35 TB/s),
// with ndtri an entry beside it (~50 instructions, a branch that follows the
// rank: a row's counts ascend, so a warp's entries take one branch but where
// a row crosses exp(-2) of either end). A score table (K12's, 2n + 1
// entries) is no help here: at n = 25M it holds 200 MB, and each of a
// rank's rows reads nearly all of it, one 32-byte sector every entry or two.
// So: 16-byte loads and stores (a thread's four entries in one int4, out as
// one float4, streaming: nothing is read again), a grid of
// kCountBlocksPerSm blocks a multiprocessor walking the flat array with
// kCountUnroll such loads in flight a thread, and the last count % 4 entries
// one a thread. t must lie on a 16-byte boundary. At (50, 6.25M), n = 25M,
// 1.00 ms (74 % of the bound; an int32 add_ in place, 0.83 ms): the shape
// won an ablation of 4-byte, 8-byte and 16-byte accesses, 1, 2 and 4 loads
// in flight, 4, 8 and 16 blocks an SM or one vector a thread, and the table
// (3.9 ms); 31 registers, so 8 blocks of 256 fit an SM and the grid runs in
// two waves (PERF.md, the kernel tables).

namespace {

constexpr int kCountThreads = 256;
constexpr int kCountUnroll = 2;       // int4 loads in flight a thread
constexpr int kCountBlocksPerSm = 16;  // the grid: blocks a multiprocessor

__device__ __forceinline__ float4 blom_scores4(int4 t, int n, float inv_b) {
  return make_float4(blom_score(t.x + 1LL, n, inv_b),
                     blom_score(t.y + 1LL, n, inv_b),
                     blom_score(t.z + 1LL, n, inv_b),
                     blom_score(t.w + 1LL, n, inv_b));
}

__global__ void __launch_bounds__(kCountThreads)
blom_counts_kernel(int* t, long long count, int n, float inv_b) {
  const long long nvec = count >> 2;
  const int4* tv = reinterpret_cast<const int4*>(t);
  float4* zv = reinterpret_cast<float4*>(t);
  const long long span = (long long)kCountThreads * kCountUnroll;
  for (long long v0 = blockIdx.x * span + threadIdx.x; v0 < nvec;
       v0 += gridDim.x * span) {
    int4 k[kCountUnroll];
#pragma unroll
    for (int u = 0; u < kCountUnroll; ++u) {
      const long long v = v0 + u * kCountThreads;
      k[u] = v < nvec ? __ldcs(tv + v) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kCountUnroll; ++u) {
      const long long v = v0 + u * kCountThreads;
      if (v < nvec) __stcs(zv + v, blom_scores4(k[u], n, inv_b));
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < (int)(count & 3)) {
    const long long i = 4 * nvec + threadIdx.x;
    reinterpret_cast<float*>(t)[i] = blom_score(t[i] + 1LL, n, inv_b);
  }
}

}  // namespace

// t (count,) int32 on a 16-byte boundary, in place: the float32 Blom score
// of each t + 1 in a row of n (K15)
extern "C" int mdt_blom_counts(int* t, long long count, int n, float inv_b,
                               void* stream) {
  if (count <= 0) return 0;
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const long long span = (long long)kCountThreads * kCountUnroll;
  const long long need = ((count >> 2) + span - 1) / span;
  const long long most = (long long)kCountBlocksPerSm * sms;
  const int grid = (int)(need < 1 ? 1 : need < most ? need : most);
  blom_counts_kernel<<<grid, kCountThreads, 0, (cudaStream_t)stream>>>(
      t, count, n, inv_b);
  return (int)cudaGetLastError();
}
