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
// result is bit for bit the card's `torch.sort` (checked at rows of 1 to
// 30.7M entries): a key whose sign bit is set has all its bits
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
//  3. a launch a digit (`radix_digit_pass`, onesweep style), on a persistent
//     grid: as many blocks as the card holds at once (the occupancy API: 3 a
//     multiprocessor), never more than the pass's tiles. A tile is kTile =
//     kParts * kPart keys of one row; tickets from a counter on the card hand
//     the tiles out in order (row after row, tile after tile). A block holds
//     one ticket; its tile's parts arrive by the TMA (`cp.async.bulk`, whole
//     16-byte pieces, so a row that starts off a 16-byte boundary lands a few
//     words into its slot) in a ring of kParts slots in shared memory, each
//     completing on its own mbarrier. On arrival the block counts the tile's
//     digits (shared-memory atomics) and publishes the counts (flag
//     `kAggregate`; the row's first tile `kPrefix`). It then ranks each part
//     in turn: each warp holds kItems keys a lane, lane-fastest
//     (`warp * 32 kItems + i * 32 + lane`), so that (part, warp, item, lane)
//     is the keys' order in the row; one ballot a digit bit gives the lanes
//     that hold a key's digit, and the lowest of them adds their count to the
//     warp's counter of the digit, item after item, so the rank is stable.
//     Per-warp counts scanned over the warps and the digits give each key its
//     place in the part sorted by digit, where the block stages it (with its
//     position) in the slot it came in. A digit's start in the output row is
//     the row's exclusive histogram sum (scanned from the histograms) plus
//     the counts of the row's earlier tiles, found by decoupled look-back over
//     per-(tile, digit) status words (a thread a digit walks back, adding
//     counts, until it meets an inclusive prefix, then publishes its own),
//     plus the digit's keys in the tile's earlier parts. Its look-back done,
//     the block takes its next ticket; it writes the tile out part by part,
//     each digit's run to consecutive addresses, and as each slot is read
//     the next tile's part is loaded into it, so the next tile's keys are in
//     flight while this one is written.
// Why the persistent grid cannot deadlock: a tile's look-back waits only on
// tiles with lower tickets, and only until they have published their
// counts, which a tile does on arrival with no wait of its own. A block
// takes tickets in increasing order and works on them in that order, and
// takes its next only once its look-back is done, so it never holds an
// unpublished tile while it waits. Tickets are taken only by running blocks.
// So the lowest unpublished ticket belongs to a running block that is not
// waiting (its tile's keys are coming by the TMA, which waits on nothing),
// and every look-back ends.
// Positions are int32 (n < 2^30: a status word holds a count in 30 bits);
// the first pass takes each key's place in its row as its position, and
// between passes keys and positions travel as 8-byte (key, position) pairs,
// one scattered stream (two scattered 4-byte streams to the same places were
// measured 30 % slower a pass); the last pass writes keys and int64
// positions. Ping-pong: keys alone between keys_out and tmp, so that the last
// pass lands in keys_out; pairs between tmp and the int64 output's own
// storage (free until the last pass, which reads tmp). Look-back buffers
// alternate between two passes; a pass zeroes, for each of its tiles, the
// buffer of the next pass.
//
// What bounds it on an H100: not bytes. A call reads the keys once for the
// histograms and, a pass, reads and writes the keys and (but in pass 1) the
// positions: 4 + 12 + 16 + 16 + 20 = 68 bytes an entry with positions (6.65
// ms at 3.35 TB/s for (256, 1.28M)), 36 keys alone; any sort moves at least
// 16 (keys in and out, int64 positions out), 8 keys alone. A pass is bound
// by each tile's chain of latencies, at ~2.8 tiles in flight a
// multiprocessor (80 registers a thread, 71 KB of shared memory a block),
// and by its scattered writes (measured with clock64 stamps, PERF.md, PR
// 20: at (1000, 1.28M) a tile of 7680 keys with positions lives ~28 us:
// ballots ~9, counting ~3.8, scans and staging ~5.7, look-back ~4.8 (~8
// dependent L2 reads a digit, no wait on an unpublished tile), scatter ~5;
// waits for the TMA ~0.1). The sort takes 48.8 ms there: 53 % of its
// design's bytes, 13 % of any sort's. Reading several status words at once, tickets interleaved
// across rows, the ticket taken before the look-back, tiles of one part,
// and writing each digit's run across both parts at once were measured
// slower; the ranking (8-bit digits, 15 keys a thread, 3 blocks a
// multiprocessor, ballots) won PR 17's ablation over 11-bit digits,
// `__match_any_sync`, and 2 or 4 blocks with 8 to 20 keys a thread.

#include <cuda_runtime.h>

#include <cstdint>

#include "mbarrier.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 15;  // keys a thread ranks at once in a digit pass
constexpr int kPart = kThreads * kItems;  // keys a block ranks at once
constexpr int kParts = 2;  // parts of a tile, each in a slot of the ring
constexpr int kTile = kParts * kPart;  // keys a ticket and a status word
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

// Dynamic shared memory of a pass block: the ring's mbarriers, the ticket
// held, the warp sums, the digit bases of each part, the tile's digit
// counts, the per-warp digit counters, then the ring: kParts slots, each a
// part of keys or (kPos) of key-position pairs.
constexpr int kOffHeld = 8 * kParts;
constexpr int kOffSums = kOffHeld + 16;
constexpr int kOffBase = kOffSums + 8 * kWarps;
constexpr int kOffTileCnt = kOffBase + 4 * kParts * kRadix;
constexpr int kOffCnt = kOffTileCnt + 4 * kRadix;
constexpr int kOffRing = (kOffCnt + 4 * kWarps * kRadix + 127) / 128 * 128;

// bytes of a ring slot: a part of 4-byte keys or 8-byte pairs, and the
// words of a 16-byte piece before an unaligned part
template <bool kPos>
__host__ __device__ constexpr int slot_bytes() {
  return (kPos ? 8 : 4) * kPart + 16;
}

template <bool kPos>
__host__ __device__ constexpr int digit_pass_smem_bytes() {
  return kOffRing + kParts * slot_bytes<kPos>();
}

using mdt::mbar_arrive_expect_tx;
using mdt::mbar_init;
using mdt::mbar_wait;
using mdt::smem_u32;

// The 16-byte pieces that hold `count` elements of `size` bytes from `p`
// on: where they start, how many bytes, and the elements before `p` in the
// first piece.
struct Pieces {
  const void* from;
  uint32_t bytes;
  int lead;
};

__device__ __forceinline__ Pieces pieces(const void* p, int count, int size) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uintptr_t a0 = a & ~uintptr_t(15);
  const uintptr_t end = a + (uintptr_t)count * size;
  return {reinterpret_cast<const void*>(a0),
          (uint32_t)((end - a0 + 15u) & ~uintptr_t(15)),
          (int)((a - a0) / size)};
}

// Key i of a ring slot that holds keys, or pairs (`paired`)
__device__ __forceinline__ uint32_t key_at(const unsigned char* slot,
                                           bool paired, int i) {
  return paired ? reinterpret_cast<const uint2*>(slot)[i].x
                : reinterpret_cast<const uint32_t*>(slot)[i];
}

// Part q of tile t into the ring slot `slot` by the TMA, completing on the
// mbarrier `bar`: the keys, or with positions past the first pass the
// pairs, in whole 16-byte pieces, so a row that starts off a 16-byte
// boundary lands `lead` elements in. A part past the row's end moves
// nothing, and its phase of the mbarrier completes all the same.
__device__ __forceinline__ void load_part(const uint32_t* keys_in,
                                          const uint2* pairs_in, int n,
                                          int tiles, uint32_t t, int q,
                                          unsigned char* slot, uint32_t bar) {
  const int row = (int)(t / (uint32_t)tiles);
  const int start = (int)(t - (uint32_t)row * tiles) * kTile + q * kPart;
  const int count = min(kPart, n - start);
  const long long off = (long long)row * n + start;
  Pieces src{};
  if (count > 0) {
    src = pairs_in != nullptr ? pieces(pairs_in + off, count, 8)
                              : pieces(keys_in + off, count, 4);
  }
  mbar_arrive_expect_tx(bar, src.bytes);
  if (src.bytes) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_u32(slot)),
        "l"(src.from), "r"(src.bytes), "r"(bar)
        : "memory");
  }
}

// One digit pass over every tile of every row (see the header): a persistent
// grid whose blocks take tiles from `ticket` until `total` (p * tiles) are
// out. Input: keys_in (p, n) as bits, or with positions past the first pass
// pairs_in (p, n) of (key bits, int32 position); the first pass takes each
// key's place in its row as its position. Output: keys_out, pairs_out
// (kPos, not kLast), or keys_out and order_out (int64, kLast). status: this
// pass's look-back words (total, radix); status_next the next pass's, zeroed
// here a tile (null in the last).
template <bool kPos, bool kLast>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
radix_digit_pass(const uint32_t* __restrict__ keys_in,
                 const uint2* __restrict__ pairs_in,
                 uint32_t* __restrict__ keys_out, uint2* __restrict__ pairs_out,
                 long long* __restrict__ order_out,
                 const uint32_t* __restrict__ hist, uint32_t* status,
                 uint32_t* __restrict__ status_next, uint32_t* ticket, int n,
                 int tiles, int total, int pass) {
  static_assert(kRadix == kThreads, "a thread owns one digit");
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint32_t* held = reinterpret_cast<uint32_t*>(smem + kOffHeld);
  unsigned long long* warp_sums =
      reinterpret_cast<unsigned long long*>(smem + kOffSums);
  uint32_t* g_base = reinterpret_cast<uint32_t*>(smem + kOffBase);
  uint32_t* tile_cnt = reinterpret_cast<uint32_t*>(smem + kOffTileCnt);
  uint32_t* warp_cnt = reinterpret_cast<uint32_t*>(smem + kOffCnt);
  constexpr int kSlot = slot_bytes<kPos>();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = tid;  // this thread's digit in the scans and the look-back
  const int shift = pass * kBits;
  const bool paired = kPos && pairs_in != nullptr;  // pairs in, not keys
  const int first = warp * (32 * kItems) + lane;  // this thread's first key
  uint32_t* my_cnt = warp_cnt + warp * kRadix;
  if (tid == 0) {
    for (int q = 0; q < kParts; ++q) mbar_init(smem_u32(full + q), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    *held = atomicAdd(ticket, 1u);
    if (*held < (uint32_t)total) {
      for (int q = 0; q < kParts; ++q) {
        load_part(keys_in, pairs_in, n, tiles, *held, q,
                  smem + kOffRing + q * kSlot, smem_u32(full + q));
      }
    }
  }
  __syncthreads();

  for (uint32_t phase = 0;; phase ^= 1u) {
    const uint32_t t = *held;
    if (t >= (uint32_t)total) break;
    const int row = (int)(t / (uint32_t)tiles);
    const int tile = (int)(t - (uint32_t)row * tiles);
    const long long row_off = (long long)row * n;
    const int count = min(kTile, n - tile * kTile);
    // the row's count of this thread's digit, read while the tile ranks
    const uint32_t hcnt =
        __ldg(hist + ((long long)row * kPasses + pass) * kRadix + d);
    uint32_t* st = status + (long long)t * kRadix + d;

    // the tile's count of each digit, published as soon as its keys are in,
    // so that the tiles after it seldom find it unpublished
    int lead[kParts];  // elements before each part's first in its slot
    tile_cnt[d] = 0;
    __syncthreads();
    for (int q = 0; q < kParts; ++q) {
      const int part = min(kPart, count - q * kPart);  // keys; <= 0: none
      const long long off = row_off + tile * kTile + q * kPart;
      lead[q] = part <= 0 ? 0
                : paired  ? pieces(pairs_in + off, part, 8).lead
                          : pieces(keys_in + off, part, 4).lead;
      const unsigned char* slot = smem + kOffRing + q * kSlot;
      mbar_wait(smem_u32(full + q), phase);
      for (int j = tid; j < part; j += kThreads) {
        atomicAdd(tile_cnt + digit_of(key_at(slot, paired, lead[q] + j), shift),
                  1u);
      }
    }
    __syncthreads();
    const uint32_t valid = tile_cnt[d];
    store_relaxed(st, (tile == 0 ? kPrefix : kAggregate) | valid);
    uint32_t row_excl = 0;
    uint32_t before = 0;  // keys of digit d in the tile's parts so far

    for (int q = 0; q < kParts; ++q) {
      const int start = tile * kTile + q * kPart;
      const int part = min(kPart, count - q * kPart);
      unsigned char* slot = smem + kOffRing + q * kSlot;
      uint32_t* ring_k = reinterpret_cast<uint32_t*>(slot);
      uint2* ring_kp = reinterpret_cast<uint2*>(slot);
      for (int j = lane; j < kRadix; j += 32) my_cnt[j] = 0;
      __syncwarp();

      // the part's keys, lane-fastest in each warp; past the row's end, the
      // last digit (ranked after every key of the part, and never written)
      uint32_t key[kItems];
      uint32_t rank[kItems];  // (digit << 16) | place
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int idx = first + i * 32;
        key[i] = idx < part ? key_at(slot, paired, lead[q] + idx) : 0u;
      }

      // rank among the warp's keys of the same digit, in the keys' order
      const uint32_t lanes_below = (1u << lane) - 1u;
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const uint32_t dg =
            first + i * 32 < part ? digit_of(key[i], shift) : kRadix - 1u;
        const uint32_t peers = peers_of(dg);
        const int leader = __ffs(peers) - 1;
        uint32_t c = 0;
        if (lane == leader) {
          c = my_cnt[dg];
          my_cnt[dg] = c + __popc(peers);
        }
        c = __shfl_sync(0xffffffffu, c, leader);
        rank[i] = (dg << 16) | (c + __popc(peers & lanes_below));
        __syncwarp();
      }
      __syncthreads();

      // the digit's count over the warps turned into exclusive sums over the
      // warps, then over the digits (and, with the first part, the row's
      // histogram's); the digit's base for this part, less the prefix of
      // the row's earlier tiles, which the look-back adds
      uint32_t run = 0;
      for (int w = 0; w < kWarps; ++w) {
        const uint32_t c = warp_cnt[w * kRadix + d];
        warp_cnt[w * kRadix + d] = run;
        run += c;
      }
      const unsigned long long excl = block_exclusive_sum(
          ((unsigned long long)(q == 0 ? hcnt : 0u) << 32) | run, warp_sums);
      if (q == 0) row_excl = (uint32_t)(excl >> 32);
      const uint32_t part_excl = (uint32_t)excl;
      for (int w = 0; w < kWarps; ++w) warp_cnt[w * kRadix + d] += part_excl;
      g_base[q * kRadix + d] = row_excl + before - part_excl;
      before += run;
      // the positions: from the pairs, or the keys' places in the first pass
      int pos[kPos ? kItems : 1];
      if (kPos) {
#pragma unroll
        for (int i = 0; i < kItems; ++i) {
          const int idx = first + i * 32;
          pos[i] = !paired     ? start + idx
                   : idx < part ? (int)ring_kp[lead[q] + idx].y
                                : 0;
        }
      }
      __syncthreads();  // every key and position read before any is staged

      // each key's place in the part sorted by digit; keys (or pairs)
      // staged in that order in the slot they came in
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        rank[i] =
            (rank[i] & 0xffffu) + warp_cnt[warp * kRadix + (rank[i] >> 16)];
        if (kPos) {
          ring_kp[rank[i]] = make_uint2(key[i], (uint32_t)pos[i]);
        } else {
          ring_k[rank[i]] = key[i];
        }
      }
    }

    // the counts of the row's earlier tiles: decoupled look-back over this
    // digit's status words, nearest first, until a prefix
    if (tile > 0) {
      const uint32_t* word = st - kRadix;
      uint32_t prefix = 0, spins = 0;
      for (;;) {
        const uint32_t v = load_relaxed(word);
        if (v == 0u) {  // that tile has not published yet
          if (++spins == kMaxSpins) __trap();
          continue;
        }
        prefix += v & kValueMask;
        if ((v & ~kValueMask) == kPrefix) break;
        word -= kRadix;  // an aggregate: go on to the tile before it
      }
      store_relaxed(st, kPrefix | (prefix + valid));
      for (int q = 0; q < kParts; ++q) g_base[q * kRadix + d] += prefix;
    }
    if (status_next != nullptr) status_next[(long long)t * kRadix + d] = 0u;
    // this tile waits on no other tile any more: the next ticket, whose
    // parts land in the slots as this tile's parts leave them
    if (tid == 0) *held = atomicAdd(ticket, 1u);
    __syncthreads();
    const uint32_t next = *held;

    // out part by part in the order sorted by digit: each digit's run to
    // consecutive addresses of the row
    for (int q = 0; q < kParts; ++q) {
      const int part = min(kPart, count - q * kPart);
      const unsigned char* slot = smem + kOffRing + q * kSlot;
      const uint32_t* base = g_base + q * kRadix;
      for (int j = tid; j < part; j += kThreads) {
        if (kPos) {
          const uint2 kp = reinterpret_cast<const uint2*>(slot)[j];
          const long long dst =
              row_off + (uint32_t)(base[digit_of(kp.x, shift)] + (uint32_t)j);
          if (kLast) {
            keys_out[dst] = kp.x;
            order_out[dst] = (int)kp.y;
          } else {
            pairs_out[dst] = kp;
          }
        } else {
          const uint32_t b = reinterpret_cast<const uint32_t*>(slot)[j];
          keys_out[row_off + (uint32_t)(base[digit_of(b, shift)] +
                                        (uint32_t)j)] = b;
        }
      }
      // the slot's reads and writes ordered before the TMA's next write
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
      if (tid == 0 && next < (uint32_t)total) {
        load_part(keys_in, pairs_in, n, tiles, next, q,
                  smem + kOffRing + q * kSlot, smem_u32(full + q));
      }
    }
  }
}

template <bool kPos, bool kLast>
cudaError_t launch_pass(const uint32_t* keys_in, const uint2* pairs_in,
                        uint32_t* keys_out, uint2* pairs_out,
                        long long* order_out, const uint32_t* hist,
                        uint32_t* status, uint32_t* status_next,
                        uint32_t* ticket, int n, int tiles, int total,
                        int pass, cudaStream_t st) {
  constexpr int smem = digit_pass_smem_bytes<kPos>();
  auto kernel = radix_digit_pass<kPos, kLast>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  // the persistent grid: as many blocks as the card holds at once (the
  // occupancy asked once a kernel), never more than the pass's tiles
  static int per_sm = 0;
  if (per_sm == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
    if (e != cudaSuccess) return e;
  }
  int device = 0, sms = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const int grid = min(max(per_sm, 1) * sms, total);
  kernel<<<grid, kThreads, smem, st>>>(keys_in, pairs_in, keys_out, pairs_out,
                                       order_out, hist, status, status_next,
                                       ticket, n, tiles, total, pass);
  return cudaGetLastError();
}

cudaError_t sort_rows(const uint32_t* keys, uint32_t* keys_out,
                      long long* order, void* tmp, uint32_t* ws, int n, int p,
                      int hist_chunks, cudaStream_t st) {
  const int tiles = (n + kTile - 1) / kTile;
  const long long blocks = (long long)p * tiles;
  const int total = (int)blocks;
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
  for (int k = 0; k < kPasses && e == cudaSuccess; ++k) {
    uint32_t* next = k == kPasses - 1 ? nullptr : status[(k + 1) % 2];
    uint32_t* stat = status[k % 2];
    if (order == nullptr) {
      // keys alone: keys_out and tmp in turns, the last pass to keys_out
      const uint32_t* src = k == 0 ? keys
                            : (kPasses - k) % 2 == 0
                                ? keys_out
                                : static_cast<uint32_t*>(tmp);
      uint32_t* dst = (kPasses - 1 - k) % 2 == 0 ? keys_out
                                                 : static_cast<uint32_t*>(tmp);
      e = launch_pass<false, false>(src, nullptr, dst, nullptr, nullptr, hist,
                                    stat, next, tickets + k, n, tiles, total,
                                    k, st);
    } else {
      // pairs between tmp and the int64 output's storage (free until the
      // last pass, which reads tmp): keys -> tmp -> order -> tmp -> out
      uint2* a = static_cast<uint2*>(tmp);
      uint2* b = reinterpret_cast<uint2*>(order);
      if (k == 0) {
        e = launch_pass<true, false>(keys, nullptr, nullptr, a, nullptr, hist,
                                     stat, next, tickets + k, n, tiles, total,
                                     k, st);
      } else if (k < kPasses - 1) {
        e = launch_pass<true, false>(nullptr, k % 2 ? a : b, nullptr,
                                     k % 2 ? b : a, nullptr, hist, stat, next,
                                     tickets + k, n, tiles, total, k, st);
      } else {
        e = launch_pass<true, true>(nullptr, a, keys_out, nullptr, order, hist,
                                    stat, next, tickets + k, n, tiles, total,
                                    k, st);
      }
    }
  }
  return e;
}

}  // namespace

// Sort each row of keys (p, n) float32 (as bits) ascending and stable into
// keys_out; order (p, n) int64, the position of each sorted key in its row,
// or null for the keys alone. tmp: (p, n) scratch of 8 bytes an entry with
// order (key-position pairs), 4 without; ws the workspace of
// `sort_plan(p, n)["ws_words"]` 4-byte words (kernels/radix_sort.py);
// hist_chunks the histogram blocks a row. 1 <= n < 2^30, p * tiles < 2^31.
extern "C" int mdt_radix_sort(const void* keys, void* keys_out, void* order,
                              void* tmp, void* ws, int n, int p,
                              int hist_chunks, void* stream) {
  if (n < 1 || n >= (1 << kMaxLog2N) || p < 0 || hist_chunks < 1 ||
      (long long)p * ((n + kTile - 1) / kTile) >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  if (p == 0) return 0;
  return (int)sort_rows(static_cast<const uint32_t*>(keys),
                        static_cast<uint32_t*>(keys_out),
                        static_cast<long long*>(order), tmp,
                        static_cast<uint32_t*>(ws), n, p, hist_chunks,
                        (cudaStream_t)stream);
}
