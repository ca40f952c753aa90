// Radix select of a CTA's k-th largest 32-bit key, and the CTA-wide scan
// that compacts what it selects in position order.
//
// Used by: topk_compress.cu's bitonic body (the counterpart of repro's
// _topk_bitonic_kernel, src/repro/kernels/topk_compress/kernel.py:52), in
// place of the sort of the whole block.
//
// Every thread of the CTA owns some lanes of the block and holds each lane's
// `hi`, the high half of the packed top-k key (bitonic.cuh: bits(|x|) + 1 for
// a valid lane, 0 for a lane past the vector).  select() finds the k-th
// largest hi digit by digit, 8 bits at a time, most significant first: a
// pass counts the lanes that still match the digits fixed so far into a
// 256-bin histogram in shared memory, and one warp finds the bin that holds
// the k-th.  A pass ends early once that bin's lanes are exactly the ones
// still needed.  The result, a Cut, says which lanes are taken:
//     (hi & mask) >  prefix   every one of them,
//     (hi & mask) == prefix   the `need` lowest positions of those `eq`;
// together exactly k.  When the passes run to the last digit, prefix is the
// k-th largest hi itself, and the ties at it go to the lower positions, as
// the key's low half orders them.
//
// Sparse rows put most lanes in one bin (at density 0.3, 70% of a block's
// lanes are exact zeros, hi 1): the lanes of a warp that fall in one bin are
// counted by one shared atomic (__match_any_sync), not one each.
//
// Cost: at most 4 passes of 2 barriers each.  The histograms are
// double-buffered, so a pass clears the next pass's while it counts.
#pragma once

#include <cstdint>

namespace radix {

constexpr int kDigitBits = 8;
constexpr int kBins = 1 << kDigitBits;
constexpr unsigned kFull = 0xFFFFFFFFu;

// One CTA's shared state (static shared memory, ~2.3 KB).
struct Smem {
  unsigned hist[2][kBins];
  unsigned found[3];                 // the bin, the lanes above it, the lanes in it
  unsigned long long warp_sum[32];   // exclusive_scan's per-warp totals
};

struct Cut {
  unsigned prefix, mask;
  unsigned need, eq;
};

// hist[bin] += 1 for each active lane of the warp, one atomic per distinct
// bin.  Every lane of the warp calls it.
__device__ __forceinline__ void hist_add(unsigned* hist, unsigned bin, bool active) {
  const unsigned act = __ballot_sync(kFull, active);
  if (!active) return;
  const unsigned peers = __match_any_sync(act, bin);
  if ((threadIdx.x & 31) == static_cast<unsigned>(__ffs(peers) - 1))
    atomicAdd(hist + bin, static_cast<unsigned>(__popc(peers)));
}

// Warp 0: the bin b holding the need-th largest counted lane (bins taken
// from the top): above(b) < need <= above(b) + hist[b], where above(b) is
// the count of the bins past b.  Writes (b, above(b), hist[b]) to found.
__device__ __forceinline__ void find_bin(const unsigned* hist, unsigned need,
                                         unsigned* found) {
  constexpr int kPer = kBins / 32;
  const int lane = threadIdx.x & 31;
  unsigned c[kPer], mine = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) mine += (c[i] = hist[lane * kPer + i]);
  unsigned s = mine;  // inclusive suffix sum over the lanes
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned t = __shfl_down_sync(kFull, s, off);
    if (lane + off < 32) s += t;
  }
  unsigned above = s - mine;
#pragma unroll
  for (int i = kPer - 1; i >= 0; --i) {
    if (above < need && need <= above + c[i]) {
      found[0] = lane * kPer + i;
      found[1] = above;
      found[2] = c[i];
    }
    above += c[i];
  }
}

// The Cut of the k largest hi of the CTA's lanes (1 <= k <= lanes).  Every
// thread calls it; blockDim.x is a multiple of 32.  lanes.each(f) calls
// f(pos, hi, active) for each of the thread's lanes, the same number of times
// in every thread of a warp (lanes past the block inactive).
template <class Lanes>
__device__ Cut select(const Lanes& lanes, unsigned k, Smem& sm) {
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) sm.hist[0][i] = 0;
  __syncthreads();
  Cut cut{0u, 0u, k, 0u};
#pragma unroll 1
  for (int shift = 32 - kDigitBits, p = 0; shift >= 0; shift -= kDigitBits, ++p) {
    unsigned* hist = sm.hist[p & 1];
    unsigned* next = sm.hist[(p + 1) & 1];
    for (int i = threadIdx.x; i < kBins; i += blockDim.x) next[i] = 0;
    lanes.each([&](int, unsigned hi, bool active) {
      hist_add(hist, (hi >> shift) & (kBins - 1), active && (hi & cut.mask) == cut.prefix);
    });
    __syncthreads();
    if (threadIdx.x < 32) find_bin(hist, cut.need, sm.found);
    __syncthreads();
    cut.prefix |= sm.found[0] << shift;
    cut.mask |= static_cast<unsigned>(kBins - 1) << shift;
    cut.need -= sm.found[1];
    cut.eq = sm.found[2];
    if (cut.eq == cut.need) break;  // the bin is taken whole: no ties to break
  }
  return cut;
}

// Exclusive prefix sum of v over the CTA's threads in thread order.  Every
// thread calls it once.
__device__ __forceinline__ unsigned long long exclusive_scan(unsigned long long v, Smem& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long s = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned long long t = __shfl_up_sync(kFull, s, off);
    if (lane >= off) s += t;
  }
  if (lane == 31) sm.warp_sum[warp] = s;
  __syncthreads();
  unsigned long long before = 0;
  for (int w = 0; w < warp; ++w) before += sm.warp_sum[w];
  return before + s - v;
}

}  // namespace radix
