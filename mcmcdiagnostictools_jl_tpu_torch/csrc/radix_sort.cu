// Kernel K13: a stable ascending sort of every row of a float32 array (p, n),
// carrying each value's position in its row, for Hopper.
//
// Stands for the JAX package's `_sort_pair` (mcmcdiagnostictools_jl_tpu/ops/
// ranknorm.py:26-35), XLA's `lax.sort` of the exact rank mode: no Pallas
// kernel (a VMEM-staged Pallas sort was built for the TPU and deleted; K9 is
// the port of that study). It replaces PyTorch's `torch.sort(x, dim=1,
// stable=True)`, which at rows of 1.28 M entries runs one cub radix sort a row
// (four passes and a histogram each: 1024 + 256 launches and ~1500 memsets at
// (256, 1.28M)).
//
// The order. Keys are ordered as cub's radix sort orders floats, so the
// result is bit for bit the card's `torch.sort` (checked at rows of 10 to
// 1.28M entries): a key whose sign bit is set has all its bits
// flipped, any other only its sign bit, and the result is compared as an
// unsigned integer. So a NaN with the sign bit set sorts before -inf and any
// other NaN after +inf, NaNs apart by their payload bits. -0.0 is read as
// +0.0 when a digit is taken (cub's rule for floats), so the two zeros tie
// and keep their order in the row. The sort is stable: tied keys keep their
// order. The keys come out with their own bits (a -0.0 stays -0.0).
//
// The algorithm: a least-significant-digit radix sort of all rows at once,
// 8-bit digits in four passes, one launch a step:
//  1. a memset of the call's workspace head (histograms, tickets, the first
//     look-back buffer): the call's one memset;
//  2. `radix_histogram`: every row's histograms of all its digits in one
//     read of the keys, counted in shared memory (atomics), then one global
//     atomicAdd a bin a block; a row is cut into `hist_chunks` blocks so that
//     the grid fills the card at any row count;
//  3. a launch a digit (`radix_digit_pass`, onesweep style). A block takes
//     the next tile of kTile = kThreads * kItems keys of one row from a ticket
//     counter on the card (tickets go row after row, tile after tile, so
//     every tile a block waits on below belongs to a block that is already
//     running). Each warp holds kItems keys a lane, lane-fastest
//     (`warp * 32 kItems + i * 32 + lane`), so that (warp, item, lane) is the
//     keys' order in the row. It ranks each key among the warp's keys of its
//     digit: one ballot a digit bit gives the lanes that hold the key's
//     digit, and the lowest of them adds their count to the warp's counter of the
//     digit in shared memory, item after item, so the rank is stable.
//     Per-warp counts scanned over the warps and the digits give each key
//     its place in the tile sorted by digit. The digit's start in the
//     output row is the row's exclusive histogram sum
//     (scanned by the block from the histograms) plus the counts of the
//     row's earlier tiles, found by decoupled look-back over per-(tile,
//     digit) status words: a tile first publishes its count (flag
//     `kAggregate`), then walks back over earlier tiles adding counts until
//     it meets an inclusive prefix (`kPrefix`) and publishes its own. The
//     block stages its keys (and positions) sorted by digit in shared memory
//     and writes them out in that order, so each digit's run goes to
//     consecutive addresses.
// Positions are int32 (n < 2^30: a status word holds a count in 30 bits) and
// are not read in pass 1, which writes them from the tile's index; the last
// pass writes them widened to int64. Ping-pong: the keys go between keys_out
// and keys_tmp so that the last pass lands in keys_out; the positions
// between pos_tmp and the int64 output's own storage (free until the last
// pass, which reads pos_tmp). Look-back buffers alternate between two
// passes; a pass zeroes, for its own tile, the buffer of the next pass.
//
// What bounds it on an H100: bytes. A call reads the keys once for the
// histograms and, a pass, reads and writes the keys and (but in pass 1) the
// positions: 4 + 12 + 16 + 16 + 20 = 68 bytes an entry with positions at 8
// bits (6.65 ms at 3.35 TB/s for (256, 1.28M)), 36 keys alone. The floor of
// any sort: read the keys and write keys and int64 positions once, 16 bytes
// an entry. As built, a digit pass takes about twice its bytes' time
// (measured, PERF.md): a block's phases (load, rank, look-back, scatter)
// follow one another, and 3 blocks of 8 warps a multiprocessor (80
// registers a thread) likely keep too few loads in flight (the stalls
// were not measured). The design (8-bit digits, 15 keys a thread, 3 blocks
// a multiprocessor, ballots, the positions loaded with the keys) was the
// fastest of an ablation on the H100 (PERF.md, PR 17): 11-bit digits in
// three passes, `__match_any_sync`, positions loaded after the ranking,
// 2 or 4 blocks and 8 to 20 keys a thread were slower.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 15;  // keys a thread in a digit pass
constexpr int kTile = kThreads * kItems;  // keys a block in a digit pass
// digit-pass blocks a multiprocessor must hold (caps the registers)
constexpr int kMinBlocks = 3;
constexpr int kBits = 8;  // digit width
constexpr int kRadix = 1 << kBits;
constexpr int kPasses = 32 / kBits;
constexpr int kHistUnroll = 8;  // loads a thread keeps in flight (histograms)
constexpr int kTicketWords = 8;  // ticket counters, one a pass
constexpr int kMaxLog2N = 30;  // n < 2^30: a count in a status word's 30 bits
constexpr uint32_t kAggregate = 1u << 30;  // status: this tile's count
constexpr uint32_t kPrefix = 2u << 30;  // status: count of tiles 0..this
constexpr uint32_t kValueMask = (1u << 30) - 1u;
// reads of a status word that has not been published before the block
// traps (~10 s): a fault, never a hang
constexpr uint32_t kMaxSpins = 1u << 24;

// cub's order for float keys, with -0.0 read as +0.0
__device__ __forceinline__ uint32_t ordered(uint32_t b) {
  b = b == 0x80000000u ? 0u : b;
  return b ^ ((b & 0x80000000u) ? 0xffffffffu : 0x80000000u);
}

__device__ __forceinline__ uint32_t digit_of(uint32_t b, int shift) {
  return (ordered(b) >> shift) & (kRadix - 1u);
}

// the lanes of the warp whose digit is d: one ballot a digit bit
__device__ __forceinline__ uint32_t peers_of(uint32_t d) {
  uint32_t peers = 0xffffffffu;
#pragma unroll
  for (int b = 0; b < kBits; ++b) {
    const bool bit = (d >> b) & 1u;
    const uint32_t v = __ballot_sync(0xffffffffu, bit);
    peers &= bit ? v : ~v;
  }
  return peers;
}

__device__ __forceinline__ uint32_t load_relaxed(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// Exclusive sum over the block of each thread's `v`; `warp_sums` holds
// kWarps words of shared memory, free again after the next __syncthreads.
__device__ __forceinline__ unsigned long long block_exclusive_sum(
    unsigned long long v, unsigned long long* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  unsigned long long before = 0;
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
  return before + x - v;
}

__device__ __forceinline__ void count_key(uint32_t* sh, uint32_t b) {
  const uint32_t o = ordered(b);
#pragma unroll
  for (int q = 0; q < kPasses; ++q) {
    atomicAdd(sh + q * kRadix + ((o >> (q * kBits)) & (kRadix - 1)), 1u);
  }
}

// hist (p, passes, radix): the digit counts of every row. Block b counts
// chunk b % chunks of row b / chunks.
__global__ void __launch_bounds__(kThreads)
radix_histogram(const uint32_t* __restrict__ keys, int n, int chunks,
                 int chunk_len, uint32_t* __restrict__ hist) {
  constexpr int kWords = kPasses * kRadix;
  __shared__ uint32_t sh[kWords];
  for (int j = threadIdx.x; j < kWords; j += kThreads) sh[j] = 0;
  __syncthreads();
  const int row = blockIdx.x / chunks, chunk = blockIdx.x - row * chunks;
  const int begin = chunk * chunk_len;
  const int end = min(n, begin + chunk_len);
  const uint32_t* r = keys + (long long)row * n;
  int i = begin + threadIdx.x;
  for (; i + (kHistUnroll - 1) * kThreads < end; i += kHistUnroll * kThreads) {
    uint32_t v[kHistUnroll];
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) v[u] = __ldg(r + i + u * kThreads);
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) count_key(sh, v[u]);
  }
  for (; i < end; i += kThreads) count_key(sh, __ldg(r + i));
  __syncthreads();
  uint32_t* h = hist + (long long)row * kWords;
  for (int j = threadIdx.x; j < kWords; j += kThreads) {
    const uint32_t c = sh[j];
    if (c) atomicAdd(h + j, c);
  }
}

// dynamic shared memory of a pass block: the warp sums and the ticket, the
// digit bases, then the per-warp counters, later reused as the staging area
template <bool kPos>
__host__ __device__ constexpr int digit_pass_smem_bytes() {
  return kWarps * 8 + 16 + 4 * kRadix +
         (kWarps * kRadix > kTile * (kPos ? 2 : 1)
              ? 4 * kWarps * kRadix
              : 4 * kTile * (kPos ? 2 : 1));
}

// One digit pass over every tile of every row (see the header). keys_in /
// keys_out (p, n) as bits; pos_in null in the first pass (positions from the
// tile's index), pos_out (int32) or, in the last pass (kLast), order_out
// (int64); status this pass's look-back words (tiles, radix), status_next
// the next pass's, zeroed here for this block's tile (null in the last).
template <bool kPos, bool kLast>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
radix_digit_pass(const uint32_t* __restrict__ keys_in,
            const int* __restrict__ pos_in, uint32_t* __restrict__ keys_out,
            int* __restrict__ pos_out, long long* __restrict__ order_out,
            const uint32_t* __restrict__ hist, uint32_t* status,
            uint32_t* __restrict__ status_next, uint32_t* ticket, int n,
            int tiles, int pass) {
  constexpr int kDpt = kRadix / kThreads;  // digits a thread owns
  static_assert(kDpt * kThreads == kRadix, "radix must be a multiple of 256");
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* warp_sums = reinterpret_cast<unsigned long long*>(smem);
  uint32_t* bcast = reinterpret_cast<uint32_t*>(smem + kWarps * 8);
  uint32_t* g_base = reinterpret_cast<uint32_t*>(smem + kWarps * 8 + 16);
  uint32_t* warp_cnt = g_base + kRadix;  // (kWarps, kRadix)
  uint32_t* stage_k = warp_cnt;  // kTile keys, then kTile positions
  int* stage_p = reinterpret_cast<int*>(stage_k + kTile);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) bcast[0] = atomicAdd(ticket, 1u);
  uint32_t* my_cnt = warp_cnt + warp * kRadix;
  for (int j = lane; j < kRadix; j += 32) my_cnt[j] = 0;
  __syncthreads();
  const int t = (int)bcast[0];
  const int row = t / tiles, tile = t - row * tiles;
  const long long row_off = (long long)row * n;
  const int tile_start = tile * kTile;
  const int count = min(kTile, n - tile_start);
  const int shift = pass * kBits;
  const long long in_off = row_off + tile_start;

  // the tile's keys, lane-fastest in each warp; past the row's end, the
  // last digit (ranked after every key of the tile, and never written)
  uint32_t key[kItems];
  uint32_t rank[kItems];
  int pos[kItems];
  const int first = warp * (32 * kItems) + lane;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int idx = first + i * 32;
    key[i] = idx < count ? __ldg(keys_in + in_off + idx) : 0u;
  }
  // the positions: read from the last pass, or the tile's index in the first
  if (kPos) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int idx = first + i * 32;
      pos[i] = pos_in == nullptr ? tile_start + idx
                                 : (idx < count ? __ldg(pos_in + in_off + idx)
                                                : 0);
    }
  }

  // rank among the warp's keys of the same digit, in the keys' order
  const uint32_t lanes_below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const uint32_t d = first + i * 32 < count ? digit_of(key[i], shift)
                                              : kRadix - 1u;
    const uint32_t peers = peers_of(d);
    const int leader = __ffs(peers) - 1;
    uint32_t c = 0;
    if (lane == leader) {
      c = my_cnt[d];
      my_cnt[d] = c + __popc(peers);
    }
    c = __shfl_sync(0xffffffffu, c, leader);
    rank[i] = c + __popc(peers & lanes_below);
    __syncwarp();
  }
  __syncthreads();

  // per digit: the warps' counts turned into exclusive sums over the warps,
  // the tile's count published, the row's histogram read
  uint32_t cnt[kDpt], hcnt[kDpt];
  unsigned long long both = 0;  // (row histogram sum << 32) | tile count sum
  const uint32_t* h =
      hist + ((long long)row * kPasses + pass) * kRadix;
  uint32_t* st = status + (long long)t * kRadix;
  const uint32_t pad = (uint32_t)(kTile - count);
#pragma unroll
  for (int k = 0; k < kDpt; ++k) {
    const int d = tid * kDpt + k;
    uint32_t run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t c = warp_cnt[w * kRadix + d];
      warp_cnt[w * kRadix + d] = run;
      run += c;
    }
    cnt[k] = run;
    const uint32_t valid = run - (d == kRadix - 1 ? pad : 0u);
    store_relaxed(st + d, (tile == 0 ? kPrefix : kAggregate) | valid);
    hcnt[k] = __ldg(h + d);
    both += ((unsigned long long)hcnt[k] << 32) | run;
  }
  unsigned long long excl = block_exclusive_sum(both, warp_sums);

  // each digit's base: the row's exclusive histogram sum plus the counts of
  // the row's earlier tiles (look-back), less the digit's start in the tile
#pragma unroll
  for (int k = 0; k < kDpt; ++k) {
    const int d = tid * kDpt + k;
    const uint32_t row_excl = (uint32_t)(excl >> 32);
    const uint32_t tile_excl = (uint32_t)excl;
    excl += ((unsigned long long)hcnt[k] << 32) | cnt[k];
    for (int w = 0; w < kWarps; ++w) warp_cnt[w * kRadix + d] += tile_excl;
    uint32_t prefix = 0;
    if (tile > 0) {
      const uint32_t* s = status + (long long)(t - 1) * kRadix + d;
      uint32_t spins = 0;
      for (;;) {
        const uint32_t v = load_relaxed(s);
        if (v == 0u) {  // that tile has not published yet
          if (++spins == kMaxSpins) __trap();
          continue;
        }
        prefix += v & kValueMask;
        if ((v & ~kValueMask) == kPrefix) break;
        s -= kRadix;  // an aggregate: go on to the tile before it
      }
      const uint32_t valid = cnt[k] - (d == kRadix - 1 ? pad : 0u);
      store_relaxed(st + d, kPrefix | (prefix + valid));
    }
    g_base[d] = row_excl + prefix - tile_excl;
    if (status_next != nullptr) status_next[(long long)t * kRadix + d] = 0u;
  }
  __syncthreads();

  // each key's place in the tile sorted by digit
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const uint32_t d = first + i * 32 < count ? digit_of(key[i], shift)
                                              : kRadix - 1u;
    rank[i] += warp_cnt[warp * kRadix + d];
  }
  __syncthreads();  // the counters' memory becomes the staging area
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    stage_k[rank[i]] = key[i];
    if (kPos) stage_p[rank[i]] = pos[i];
  }
  __syncthreads();

  // out in tile order sorted by digit: each digit's run to consecutive
  // addresses of the row
  for (int j = tid; j < count; j += kThreads) {
    const uint32_t b = stage_k[j];
    const uint32_t d = digit_of(b, shift);
    const long long dst = row_off + (uint32_t)(g_base[d] + (uint32_t)j);
    keys_out[dst] = b;
    if (kPos) {
      if (kLast) {
        order_out[dst] = stage_p[j];
      } else {
        pos_out[dst] = stage_p[j];
      }
    }
  }
}

template <bool kPos, bool kLast>
cudaError_t launch_pass(const uint32_t* keys_in, const int* pos_in,
                        uint32_t* keys_out, int* pos_out, long long* order_out,
                        const uint32_t* hist, uint32_t* status,
                        uint32_t* status_next, uint32_t* ticket, int n,
                        int tiles, long long blocks, int pass,
                        cudaStream_t st) {
  constexpr int smem = digit_pass_smem_bytes<kPos>();
  auto kernel = radix_digit_pass<kPos, kLast>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<(unsigned)blocks, kThreads, smem, st>>>(
      keys_in, pos_in, keys_out, pos_out, order_out, hist, status, status_next,
      ticket, n, tiles, pass);
  return cudaGetLastError();
}

cudaError_t sort_rows(const uint32_t* keys, uint32_t* keys_out,
                      long long* order, uint32_t* keys_tmp, int* pos_tmp,
                      uint32_t* ws, int n, int p, int hist_chunks,
                      cudaStream_t st) {
  const int tiles = (n + kTile - 1) / kTile;
  const long long blocks = (long long)p * tiles;
  const long long hist_words = (long long)p * kPasses * kRadix;
  uint32_t* hist = ws;
  uint32_t* tickets = ws + hist_words;
  uint32_t* status[2] = {tickets + kTicketWords,
                         tickets + kTicketWords + blocks * kRadix};
  cudaError_t e = cudaMemsetAsync(
      ws, 0, (size_t)(hist_words + kTicketWords + blocks * kRadix) * 4, st);
  if (e != cudaSuccess) return e;
  const int chunk_len = (n + hist_chunks - 1) / hist_chunks;
  radix_histogram<<<(unsigned)((long long)p * hist_chunks), kThreads, 0,
                    st>>>(keys, n, hist_chunks, chunk_len, hist);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // the int64 output's storage holds int32 positions until the last pass
  int* pos_out64 = reinterpret_cast<int*>(order);
  const uint32_t* src = keys;
  const int* psrc = nullptr;
  for (int k = 0; k < kPasses; ++k) {
    const bool last = k == kPasses - 1;
    uint32_t* dst = (kPasses - 1 - k) % 2 == 0 ? keys_out : keys_tmp;
    int* pdst = last ? nullptr
                     : ((kPasses - 2 - k) % 2 == 0 ? pos_tmp : pos_out64);
    uint32_t* next = last ? nullptr : status[(k + 1) % 2];
    if (order == nullptr) {
      e = launch_pass<false, false>(src, nullptr, dst, nullptr, nullptr, hist,
                                    status[k % 2], next, tickets + k, n, tiles,
                                    blocks, k, st);
    } else if (last) {
      e = launch_pass<true, true>(src, psrc, dst, nullptr, order, hist,
                                  status[k % 2], next, tickets + k, n, tiles,
                                  blocks, k, st);
    } else {
      e = launch_pass<true, false>(src, psrc, dst, pdst, nullptr, hist,
                                   status[k % 2], next, tickets + k, n, tiles,
                                   blocks, k, st);
    }
    if (e != cudaSuccess) return e;
    src = dst;
    psrc = pdst;
  }
  return cudaSuccess;
}

}  // namespace

// Sort each row of keys (p, n) float32 (as bits) ascending and stable into
// keys_out; order (p, n) int64, the position of each sorted key in its row,
// or null for the keys alone. keys_tmp (p, n) 4-byte scratch, pos_tmp (p, n)
// int32 scratch (unused without order), ws the workspace of
// `sort_plan(p, n)["ws_words"]` 4-byte words (kernels/radix_sort.py);
// hist_chunks the histogram blocks a row. 1 <= n < 2^30.
extern "C" int mdt_radix_sort(const void* keys, void* keys_out, void* order,
                              void* keys_tmp, void* pos_tmp, void* ws, int n,
                              int p, int hist_chunks, void* stream) {
  if (n < 1 || n >= (1 << kMaxLog2N) || p < 0 || hist_chunks < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (p == 0) return 0;
  const auto* k = static_cast<const uint32_t*>(keys);
  auto* ko = static_cast<uint32_t*>(keys_out);
  auto* o = static_cast<long long*>(order);
  auto* kt = static_cast<uint32_t*>(keys_tmp);
  auto* pt = static_cast<int*>(pos_tmp);
  auto* w = static_cast<uint32_t*>(ws);
  return (int)sort_rows(k, ko, o, kt, pt, w, n, p, hist_chunks,
                        (cudaStream_t)stream);
}
