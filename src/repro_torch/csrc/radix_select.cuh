// Radix select of the k-th largest 32-bit key of each of a group of a CTA's
// rows, and the CTA-wide scan that compacts what it selects in position
// order.
//
// Used by: topk_compress.cu's bitonic body (the counterpart of repro's
// _topk_bitonic_kernel, src/repro/kernels/topk_compress/kernel.py:52), one
// row, in place of the sort of the whole block; and fused_scatter.cu
// (repro's _fused_scatter_kernel, src/repro/kernels/accumulate/
// fused_scatter.py:37), groups of a block's rows, in place of a sort of the
// block per row.
//
// Every thread of the CTA owns some lanes of the block and holds each lane's
// `hi`, the high half of the packed top-k key (bitonic.cuh: bits(|x|) + 1 for
// a valid lane, 0 for a lane past the vector).  select_rows() finds each
// row's k-th largest hi digit by digit, 8 bits at a time, most significant
// first: a pass counts the lanes that still match the digits fixed so far
// into the row's 256-bin histogram in shared memory, and one warp finds the
// bin that holds the k-th.  A row's passes end early once that bin's lanes
// are exactly the ones still needed.  The result, a Cut, says which lanes
// are taken:
//     (hi & mask) >  prefix   every one of them,
//     (hi & mask) == prefix   the `need` lowest positions of those `eq`;
// together exactly k.  When the passes run to the last digit, prefix is the
// k-th largest hi itself, and the ties at it go to the lower positions, as
// the key's low half orders them.  A pass counts every unfinished row of the
// group, so the group pays the barriers of one row.
//
// A pass counts each lane by its own shared atomic.  Grouping a warp's
// lanes by bin first (__match_any_sync) cost more than it saved, for
// topk_compress and fused_scatter alike (scripts/torch_topk_radix_phases.py,
// scripts/torch_fused_scatter_phases.py): without it a lane's count needs no
// warp-wide step, and where lanes are read from x a thread's loads of them
// overlap.  Sparse rows put
// most lanes in one bin (at density 0.3, 70% of a block's lanes are exact
// zeros, hi 1), so where a thread has many lanes (Lanes::kZerosApart) it
// counts those in the exact zeros' bin in a register and adds them once:
// else the zeros of a sparse row would queue on one address in every pass
// whose cut they match.
//
// Cost: at most 4 passes of 2 barriers each.  The histograms are
// double-buffered, so a pass clears the next pass's while it counts.
#pragma once

#include <cstdint>

namespace radix {

constexpr int kDigitBits = 8;
constexpr int kBins = 1 << kDigitBits;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Cut {
  unsigned prefix, mask;
  unsigned need, eq;
};

// One warp: the bin b holding the need-th largest counted lane (bins taken
// from the top): above(b) < need <= above(b) + hist[b], where above(b) is
// the count of the bins past b.  The one lane that holds b calls
// found(b, above(b), hist[b]).
template <class Found>
__device__ __forceinline__ void find_bin(const unsigned* hist, unsigned need, Found&& found) {
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
    if (above < need && need <= above + c[i]) found(lane * kPer + i, above, c[i]);
    above += c[i];
  }
}

// A group of up to G rows' shared state for select_rows (2 KB a row).
template <int G>
struct Rows {
  unsigned hist[G][2][kBins];
  Cut cut[G];
  unsigned long long warp_sum[32];   // exclusive_scan's per-warp totals
};

// The Cut of the k largest hi of each of rows 0..g-1 of a group (1 <= g <=
// G <= 32), written to sm.cut.  The rows' passes run together: a pass counts
// the lanes of every row still open into that row's histogram, then warp w
// finds the bins of rows w, w + nwarps, ... and updates their Cuts in place;
// two barriers a pass for the whole group.  A row is open until its bin is
// taken whole or its last digit is fixed.  lanes.each_row(r, f) calls f(pos,
// hi, active) for each of the thread's lanes of row r (lanes past the block
// inactive, or not called at all); r comes from an unrolled loop, so the
// rows' values may sit in registers.  Every thread calls it; it ends
// synchronised.
template <int G, class Lanes>
__device__ void select_rows(const Lanes& lanes, int g, unsigned k, Rows<G>& sm) {
  static_assert(G >= 1 && G <= 32, "one thread initialises each row's Cut");
  for (int i = threadIdx.x; i < g * kBins; i += blockDim.x) sm.hist[i / kBins][0][i % kBins] = 0;
  if (threadIdx.x < g) sm.cut[threadIdx.x] = Cut{0u, 0u, k, 0u};
  __syncthreads();
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
#pragma unroll 1
  for (int shift = 32 - kDigitBits, p = 0; shift >= 0; shift -= kDigitBits, ++p) {
    for (int i = threadIdx.x; i < g * kBins; i += blockDim.x)
      sm.hist[i / kBins][(p + 1) & 1][i % kBins] = 0;
#pragma unroll
    for (int r = 0; r < G; ++r) {
      if (r >= g) break;
      const Cut c = sm.cut[r];
      if (c.eq == c.need) continue;  // taken whole in an earlier pass
      unsigned* hist = sm.hist[r][p & 1];
      if constexpr (Lanes::kZerosApart) {
        const unsigned zero_bin = (1u >> shift) & (kBins - 1);  // the bin of hi 1
        unsigned zeros = 0;
        lanes.each_row(r, [&](int, unsigned hi, bool active) {
          const unsigned b = (hi >> shift) & (kBins - 1);
          const bool counted = active && (hi & c.mask) == c.prefix;
          zeros += counted && b == zero_bin;
          if (counted && b != zero_bin) atomicAdd(hist + b, 1u);
        });
        if (zeros) atomicAdd(hist + zero_bin, zeros);
      } else {
        lanes.each_row(r, [&](int, unsigned hi, bool active) {
          if (active && (hi & c.mask) == c.prefix)
            atomicAdd(hist + ((hi >> shift) & (kBins - 1)), 1u);
        });
      }
    }
    __syncthreads();
    for (int r = warp; r < g; r += nwarps) {
      const Cut c = sm.cut[r];
      __syncwarp();  // every lane has read the Cut before one lane rewrites it
      if (c.eq != c.need)
        find_bin(sm.hist[r][p & 1], c.need, [&](unsigned b, unsigned above, unsigned count) {
          sm.cut[r] = Cut{c.prefix | b << shift, c.mask | static_cast<unsigned>(kBins - 1) << shift,
                          c.need - above, count};
        });
    }
    __syncthreads();
    bool open = false;
    for (int r = 0; r < g; ++r) open |= sm.cut[r].eq != sm.cut[r].need;
    if (!open) break;
  }
}

// Exclusive prefix sum of v over the CTA's threads in thread order, through
// the per-warp totals of sm.  Every thread calls it once.
template <int G>
__device__ __forceinline__ unsigned long long exclusive_scan(unsigned long long v, Rows<G>& sm) {
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
