// Staging stretches of device memory in shared memory by cp.async, as the
// merge-path kernels K10 (valley_merge.cu) and K14 (merge_count.cu) do: a
// block copies the 16-byte chunks that cover its stretches, every copy in
// flight at once and no registers held, then waits on them all.

#pragma once

namespace mdt {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// The 16-byte chunks (of `per` entries) that cover the entries [lo, hi) of a
// flat array: the first chunk and the count, none if the stretch is empty.
struct Chunks {
  long long first;
  int count;
};

__device__ __forceinline__ Chunks cover(long long lo, long long hi, int per) {
  if (hi <= lo) return {0, 0};
  const long long first = lo / per;
  return {first, (int)((hi - 1) / per - first + 1)};
}

}  // namespace mdt
