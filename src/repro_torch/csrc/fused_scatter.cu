// Fused sparsify -> scatter-add: the accumulator's SPARSE reduce in one launch.
//
// Replaces: src/repro/kernels/accumulate/fused_scatter.py
//   (_fused_scatter_kernel, fused_topk_scatter_blocked, fused_topk_scatter).
//
// x (N, V) float32 or bfloat16 -> out (V,) in x's dtype: for every V-block of
// block_eff columns, each row keeps its per_block largest |x| (|x| descending,
// then index ascending; lanes past V never selected; per_block >= block_eff
// keeps every valid entry), everything else in the row is zero, and the kept
// rows are summed as the left fold acc = c_0; acc = acc + c_t in fp32, cast
// once to x's dtype — the association order of scatter-adding the threads'
// pairs in thread order, so the result is bit-exact with compress -> densify
// -> add and with the JAX package.
//
// Design: one CTA per V-block.  Each thread owns consecutive lanes of the
// block, so its lanes are in position order (as in topk_compress.cu's radix
// body): C = 1, 2, 4 or 8 lanes in at most 256 threads (256 of 4 at block
// 1,024), and past 2,048 lanes 512 threads of lpt lanes each (a multiple of
// 8).  A row's threshold is the packed key (bitonic.cuh) of its
// per_block-th largest lane, found without a sort: radix_select.cuh's
// select_rows takes the high halves of a group of kRowGroup = 4 rows' keys
// and finds every row's Cut in at most 4 digit passes, which the group's
// rows share (groups of 1 and of 16 were slower at 4 rows and at 16:
// scripts/torch_fused_scatter_phases.py).  A Cut taken whole (eq ==
// need) gives the threshold (prefix, 0); else the ties at hi == prefix go to
// the need lowest positions: one CTA scan of each thread's tie count, and
// the thread that holds the need-th tie writes its key as the threshold.
// Then each thread folds its own lanes over the group's rows, in row order,
// into fp32 accumulators in registers: a lane is kept iff its key reaches
// its row's threshold.  No per-lane state sits in shared memory or device
// memory, whatever the block:
//   - to 2,048 lanes the group's values stay in registers, 4 * C a thread
//     (the select, the tie count and the fold read them there);
//   - past that each pass reads them again from x (L1 and L2 hold it), 8
//     lanes by 16-byte loads where the row is aligned, and the fold takes
//     16-lane tiles of a thread's lanes, one tile's accumulators in
//     registers at a time: the tiles reuse the cuts while the rows make one
//     group, and with more groups each tile selects again;
//   - the accumulators go out 4 lanes by one store where aligned.
// Shared memory is the group's histograms and Cuts, 8.5 KB, so several CTAs
// share an SM.
//
// Bound: device memory — N*V elements read once and V written once; on an
// H100 at 3.35 TB/s that is (N+1)*V*sizeof(T) / 3.35e12 s (28.9 us at
// pagerank's x (4, 4,847,571) f32).  What bounds this kernel instead is the
// select's latency, CTA by CTA: at most 4 digit passes of shared atomics,
// two barriers a pass for the whole group, one warp's bin search per row,
// and a scan (two barriers) only for a row whose cut has ties; the phases'
// cycles are in scripts/torch_fused_scatter_phases.py.

#include <cstdint>

#include "common.cuh"
#include "bitonic.cuh"
#include "dtype.cuh"
#include "radix_select.cuh"

using u64 = unsigned long long;

constexpr int kRowGroup = 4;  // rows whose selects run together
constexpr int kTile = 16;     // lanes a thread folds at a time past 8 a thread

// The thread's C lanes [first, first + C) of a group's rows, their values
// in registers.  Lanes past the vector (pos >= nvalid) hold hi 0, lanes past
// the block (j >= own) are inactive.
template <typename T, int C>
struct RegRows {
  static constexpr bool kZerosApart = false;  // a few lanes a thread
  float val[kRowGroup][C];
  int first, own, nvalid;

  __device__ __forceinline__ RegRows(const T* xg, long long v, int g, int first_, int own_,
                                     int nvalid_)
      : first(first_), own(own_), nvalid(nvalid_) {
#pragma unroll
    for (int r = 0; r < kRowGroup; ++r) {
      if (r >= g) break;
      const T* xr = xg + r * v;
      // first is a multiple of C, so each 4-lane group is aligned iff the row is
      const bool vec = C % 4 == 0 && (reinterpret_cast<uintptr_t>(xr) & (4 * sizeof(T) - 1)) == 0;
#pragma unroll
      for (int j0 = 0; j0 < C; j0 += 4) {
        float f[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        const int p = first + j0;
        if (C % 4 == 0 && vec && p + 4 <= nvalid) {
          load4(xr + p, f);
        } else {
#pragma unroll
          for (int j = 0; j < 4 && j0 + j < C; ++j)
            if (p + j < nvalid) f[j] = to_f(xr[p + j]);
        }
#pragma unroll
        for (int j = 0; j < 4 && j0 + j < C; ++j) val[r][j0 + j] = f[j];
      }
    }
  }

  template <class F>
  __device__ __forceinline__ void each_row(int r, F&& f) const {
#pragma unroll
    for (int j = 0; j < C; ++j)
      f(first + j, first + j < nvalid ? key_hi(val[r][j]) : 0u, j < own);
  }

  // row r's values of the thread's lanes lane0 .. lane0 + L - 1 (lane0 0: C == L)
  template <int L>
  __device__ __forceinline__ void tile(int r, int, float (&xv)[L]) const {
#pragma unroll
    for (int j = 0; j < L; ++j) xv[j] = val[r][j];
  }
};

// The same for lanes whose values do not stay in registers: n lanes a
// thread (a multiple of 8), read from x on each pass and in the fold, 8 at a
// time: two 16-byte loads (f32) or one (bf16) where the row is aligned to
// them (first is a multiple of 8), else one load a lane.
template <typename T>
struct GlobalRows {
  static constexpr int kBatch = 8;
  static constexpr bool kZerosApart = true;  // 8 lanes a thread or more
  const T* xg;
  long long v;
  int first, own, nvalid, n;

  // lanes j0 .. j0 + 7 of the thread's (0 past the vector or the block)
  __device__ __forceinline__ void load8(const T* xr, int j0, float (&xv)[kBatch]) const {
    const int p = first + j0;
    if (j0 + kBatch <= own && p + kBatch <= nvalid &&
        (reinterpret_cast<uintptr_t>(xr + p) & 15) == 0) {
      float f[4];
#pragma unroll
      for (int h = 0; h < kBatch; h += 4) {
        load4(xr + p + h, f);
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[h + j] = f[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        xv[j] = j0 + j < own && p + j < nvalid ? to_f(xr[p + j]) : 0.0f;
    }
  }

  template <class F>
  __device__ __forceinline__ void each_row(int r, F&& f) const {
    const T* xr = xg + r * v;
    for (int j0 = 0; j0 < n; j0 += kBatch) {
      float xv[kBatch];
      load8(xr, j0, xv);
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int p = first + j0 + j;
        f(p, j0 + j < own && p < nvalid ? key_hi(xv[j]) : 0u, j0 + j < own);
      }
    }
  }

  template <int L>
  __device__ __forceinline__ void tile(int r, int lane0, float (&xv)[L]) const {
    static_assert(L % kBatch == 0, "a fold tile is whole batches");
#pragma unroll
    for (int h = 0; h < L; h += kBatch) {
      float b[kBatch];
      load8(xg + r * v, lane0 + h, b);
#pragma unroll
      for (int j = 0; j < kBatch; ++j) xv[h + j] = b[j];
    }
  }
};

// Every row's threshold key in the group: sm.cut[r], and for a row whose cut
// has ties, tie_thr[r] (the need-th tied lane's key).  Ends synchronised.
template <class Rows>
__device__ __forceinline__ void thresholds(const Rows& rows, int g, int k,
                                           radix::Rows<kRowGroup>& sm, u64* tie_thr) {
  radix::select_rows(rows, g, static_cast<unsigned>(k), sm);
#pragma unroll
  for (int r = 0; r < kRowGroup; ++r) {
    if (r >= g) break;
    const radix::Cut c = sm.cut[r];
    if (c.eq == c.need) continue;
    // every digit fixed: the ties are the lanes with hi == prefix, and the
    // need lowest positions of them are taken
    unsigned tied = 0;
    rows.each_row(r, [&](int, unsigned hi, bool active) { tied += active && hi == c.prefix; });
    unsigned e = static_cast<unsigned>(radix::exclusive_scan(tied, sm));
    if (e < c.need && c.need <= e + tied)
      rows.each_row(r, [&](int pos, unsigned hi, bool active) {
        if (active && hi == c.prefix && ++e == c.need)
          tie_thr[r] = static_cast<u64>(c.prefix) << 32 |
                       (0xFFFFFFFFu - static_cast<unsigned>(pos));
      });
    __syncthreads();  // tie_thr[r] written; warp_sum free for the next row's scan
  }
}

// Fold the group's rows into the thread's lanes lane0 .. lane0 + L - 1 (of
// its own lanes) in row order; `lead`: the group holds row 0; `known`: the
// cuts in sm and tie_thr are this group's already.
template <int L, class Rows>
__device__ __forceinline__ void fold_group(const Rows& rows, int g, int k, bool select_all,
                                           bool known, bool lead, int lane0,
                                           radix::Rows<kRowGroup>& sm, u64* tie_thr,
                                           float (&acc)[L]) {
  if (!select_all && !known) thresholds(rows, g, k, sm, tie_thr);
#pragma unroll
  for (int r = 0; r < kRowGroup; ++r) {
    if (r >= g) break;
    u64 thr = 0ull;  // select_all: every valid lane
    if (!select_all) {
      const radix::Cut c = sm.cut[r];
      thr = c.eq == c.need ? static_cast<u64>(c.prefix) << 32 : tie_thr[r];
    }
    float xv[L];
    rows.tile(r, lane0, xv);
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int jj = lane0 + j, pos = rows.first + jj;
      if (jj < rows.own && pos < rows.nvalid) {
        const float c = topk_key(xv[j], true, static_cast<unsigned>(pos)) >= thr ? xv[j] : 0.0f;
        acc[j] = lead && r == 0 ? c : acc[j] + c;
      }
    }
  }
  if (!select_all) __syncthreads();  // the cuts read before the next group resets them
}

// C lanes a thread (1, 2, 4, 8) in registers, or C = 0: lpt lanes a thread,
// read from x.
template <typename T, int C>
__global__ void __launch_bounds__(C == 0 ? 512 : 256)
fused_radix_kernel(const T* __restrict__ x, T* __restrict__ out, int n_rows, long long v,
                   int block_eff, int per_block, int lpt) {
  __shared__ radix::Rows<kRowGroup> sm;
  __shared__ u64 tie_thr[kRowGroup];
  constexpr int L = C > 0 ? C : kTile;  // lanes a thread folds at a time
  const long long base = static_cast<long long>(blockIdx.x) * block_eff;
  const int nvalid = static_cast<int>(v - base < block_eff ? v - base : block_eff);
  const int per = C > 0 ? C : lpt;
  const int first = static_cast<int>(threadIdx.x) * per;
  const int own = max(0, min(per, block_eff - first));
  const bool select_all = per_block >= block_eff;
  const int ntiles = C > 0 ? 1 : (per + kTile - 1) / kTile;
  const bool one_group = n_rows <= kRowGroup;
  for (int tile = 0; tile < ntiles; ++tile) {
    const bool known = one_group && tile > 0;
    const int lane0 = C > 0 ? 0 : tile * kTile;
    float acc[L];
#pragma unroll
    for (int j = 0; j < L; ++j) acc[j] = 0.0f;
    for (int r0 = 0; r0 < n_rows; r0 += kRowGroup) {
      const int g = min(kRowGroup, n_rows - r0);
      const T* xg = x + static_cast<long long>(r0) * v + base;
      if constexpr (C > 0) {
        const RegRows<T, C> rows(xg, v, g, first, own, nvalid);
        fold_group(rows, g, per_block, select_all, known, r0 == 0, lane0, sm, tie_thr, acc);
      } else {
        const GlobalRows<T> rows{xg, v, first, own, nvalid, per};
        fold_group(rows, g, per_block, select_all, known, r0 == 0, lane0, sm, tie_thr, acc);
      }
    }
    // the tile's lanes, 4 at a time by one store where they are whole and aligned
    T* o = out + base + first + lane0;
#pragma unroll
    for (int j0 = 0; j0 < L; j0 += 4) {
      bool whole = false;
      if constexpr (L % 4 == 0) {
        whole = lane0 + j0 + 4 <= own && first + lane0 + j0 + 4 <= nvalid &&
                (reinterpret_cast<uintptr_t>(o + j0) & (4 * sizeof(T) - 1)) == 0;
        if (whole) {
          const float f[4] = {acc[j0], acc[j0 + 1], acc[j0 + 2], acc[j0 + 3]};
          store4(o + j0, f);
        }
      }
      if (!whole) {
#pragma unroll
        for (int j = j0; j < j0 + 4 && j < L; ++j)
          if (lane0 + j < own && first + lane0 + j < nvalid) o[j] = from_f<T>(acc[j]);
      }
    }
  }
}

// Lanes a thread for a block of block_eff (0: read from x) and the CTA's
// threads: 256 threads or fewer while 8 lanes a thread cover the block (to
// 2,048 lanes), past that 512 threads of ceil(block_eff / 512) lanes,
// rounded up to a multiple of 8 (whole 16-byte loads).  (A
// 1,024-thread CTA would cap a thread at 64 registers, which a fold tile and
// its values overflow.)
static int lanes_per_thread(int block_eff, int* threads) {
  for (int c = 1; c <= 8; c <<= 1) {
    const int t = (block_eff + c - 1) / c;
    if (t <= 256) {
      *threads = (t + 31) / 32 * 32;
      return c;
    }
  }
  *threads = 512;
  return 0;
}

template <typename T>
struct Launch {
  const T* x;
  T* out;
  int n_rows;
  long long v;
  int block_eff, per_block, lpt, threads;
  unsigned nblocks;
  cudaStream_t s;
};

template <typename T, int C>
static int launch_kernel(const Launch<T>& a) {
  fused_radix_kernel<T, C><<<a.nblocks, a.threads, 0, a.s>>>(
      a.x, a.out, a.n_rows, a.v, a.block_eff, a.per_block, a.lpt);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch(const void* x, void* out, int n_rows, long long v, int block_eff,
                  int per_block, cudaStream_t s) {
  int threads = 0;
  const int c = lanes_per_thread(block_eff, &threads);
  const int lpt = ((block_eff + threads - 1) / threads + 7) / 8 * 8;
  const Launch<T> a{static_cast<const T*>(x), static_cast<T*>(out), n_rows, v, block_eff,
                    per_block, lpt, threads,
                    static_cast<unsigned>((v + block_eff - 1) / block_eff), s};
  switch (c) {
    case 1: return launch_kernel<T, 1>(a);
    case 2: return launch_kernel<T, 2>(a);
    case 4: return launch_kernel<T, 4>(a);
    case 8: return launch_kernel<T, 8>(a);
    default: return launch_kernel<T, 0>(a);
  }
}

// dtype: kF32 or kBF16.  No scratch: a block's working set is registers and
// a row group's histograms in static shared memory.
extern "C" int fused_topk_scatter(int dtype, const void* x, void* out, int n_rows,
                                  long long v, int block_eff, int per_block, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch<float>(x, out, n_rows, v, block_eff, per_block, s);
  return launch<__nv_bfloat16>(x, out, n_rows, v, block_eff, per_block, s);
}
