// Bitonic sorting network over packed 64-bit top-k keys.
//
// Replaces: src/repro/kernels/bitonic.py (bitonic_sort_desc / _compare_exchange),
// the network inside repro's fused_topk_scatter and topk_compress's bitonic
// body.  In the port the packed key serves both kernels' radix selects
// (radix_select.cuh); the network sorts only topk_compress's selected keys.
//
// The JAX network sorts (magnitude, index) pairs by magnitude descending, ties
// by index ascending, with -1 marking invalid lanes (past the vector's end) and
// -inf the pad lanes up to a power of two.  One packed key gives exactly that
// order as an unsigned integer:
//
//   key = ((valid ? float_bits(|x|) + 1 : 0) << 32) | (0xFFFFFFFF - local_pos)
//
// |x| >= +0.0 has no sign bit, so its bits order like the float; +1 lifts every
// valid magnitude above the invalid lanes' 0.  Invalid lanes sit at local_pos
// < block_eff and pad lanes at local_pos >= block_eff, so within the shared
// high half 0 the invalid lanes outrank the pads, as -1 outranks -inf.  The
// low half breaks ties toward the lower position.  Keys are unique, so the
// order is strict and the network's result deterministic.  NaN is outside the
// contract, as in the JAX package.
//
// Bound: O(L log^2 L) compare-exchanges over L keys, one __syncthreads per
// stage.  The keys lie in shared memory while they fit a CTA's 227 KB, else in
// a device scratch buffer: a stage's barrier orders global memory within the
// block as it orders shared memory, so the network takes either pointer.
#pragma once

#include <cstdint>

// The high half of a valid lane's packed key.
__device__ __forceinline__ unsigned key_hi(float x) { return __float_as_uint(fabsf(x)) + 1u; }

__device__ __forceinline__ unsigned long long topk_key(float x, bool valid,
                                                       unsigned local_pos) {
  unsigned long long hi = valid ? static_cast<unsigned long long>(key_hi(x)) : 0ull;
  return (hi << 32) | static_cast<unsigned long long>(0xFFFFFFFFu - local_pos);
}

__device__ __forceinline__ unsigned key_pos(unsigned long long key) {
  return 0xFFFFFFFFu - static_cast<unsigned>(key & 0xFFFFFFFFull);
}

__device__ __forceinline__ bool key_valid(unsigned long long key) {
  return (key >> 32) != 0ull;
}

// Sort s[0, L) descending; L a power of two, s in shared or global memory.
// Every thread of the block calls it after the keys are written and a
// __syncthreads; it ends synchronised.
__device__ void bitonic_sort_desc(unsigned long long* s, int L) {
  for (int k = 2; k <= L; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < L; i += blockDim.x) {
        int p = i ^ j;
        if (p > i) {
          unsigned long long a = s[i], b = s[p];
          bool desc = (i & k) == 0;  // runs alternate; the last merge is all descending
          if (desc ? (a < b) : (a > b)) {
            s[i] = b;
            s[p] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}
