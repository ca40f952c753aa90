// Blocked top-k magnitude compression: the unfused accumulator's sparsifier.
//
// Replaces: src/repro/kernels/topk_compress/kernel.py — topk_compress_blocked
//   with its two bodies, _topk_kernel (argmax loop) and _topk_bitonic_kernel.
//
// x (V,) float32 or bfloat16 -> idx int32 (nblocks*k,), vals (nblocks*k,) in
// x's dtype: per block of block_v, the k largest |x| (compared in fp32) in
// (|x| desc, index asc) order, each value x's own element.  Lanes past V, and
// slots left once a block's entries are exhausted, give (0, 0); a valid zero
// keeps its real index.  The two bodies are element-wise identical.
//
// Design: one CTA per block.
//   argmax (named after repro's body; no longer k argmax rounds): the
//     block read once, as packed keys (bitonic.cuh), in groups of 4 lanes
//     a thread.  Each warp keeps a list of its top kp = next_pow2(k) keys
//     in shared memory: its first group's top kp by a bitonic network over
//     shuffles (warp_top: runs of kp sorted, pairs of runs folded to their
//     top kp); a later group's keys pass a threshold, the list's k-th key,
//     and only those that pass enter — at most 32 are compacted one a lane
//     and sorted as 32, more go through the network — and merge into the
//     list.  The warps' lists then merge pairwise, a barrier a level: 3
//     barriers at logreg's 512-lane block (4 warps of one group) where the
//     old body paid 2k = 64.  Keys are compared as doubles of their bits
//     (key_gt).  Up to 132 CTAs the CTA is shaped for latency (4 lanes a
//     thread to 4,096 lanes), past that for work: 32 lanes a thread, so
//     that a 1,024-lane block is one warp whose later seven groups the
//     threshold mostly filters.  A k past kListCap (256) runs in segments
//     of 256 slots, each bounded by the last key of the one before.  No
//     scratch at any block or k.
//   bitonic (the name of repro's body it replaces; no longer a sort of the
//     block): each thread owns C consecutive lanes — 256 threads of 4 lanes
//     at block 1,024, at most 16 lanes a thread held in registers, past
//     16,384 lanes 1,024 threads re-reading x on each pass — and holds each
//     lane's key high half hi (bitonic.cuh's packed key).  radix_select.cuh
//     finds the k-th largest hi in at most 4 digit passes, ties at it to the
//     lower positions; one CTA-wide scan compacts the k selected keys into
//     shared memory in position order; a bitonic network over next_pow2(k)
//     keys puts them in order: one key a thread in registers while they
//     are no more than the threads (exchanges by warp shuffles, and through
//     shared memory past a warp), else bitonic_sort_desc in shared memory
//     (device scratch past 16,384 keys).  At block 1,024, k 256: some 13
//     barriers where the old body paid 55, and the CTA is a quarter the
//     size, so several share an SM.
//
// Bound: device memory — V elements read, nblocks*k index and value words
// written; at 3.35 TB/s on an H100 that is microseconds for any vector the
// accumulator sees (8.7 us at pagerank's V).  What bounds both bodies
// instead is instructions and their latency: the argmax body's compare-
// exchanges and shuffles (a one-CTA launch like logreg's is the chain of
// load, network, merges and writes), the bitonic body's digit passes and the
// network over the k keys.

#include <cstdint>

#include "common.cuh"
#include "bitonic.cuh"
#include "dtype.cuh"
#include "radix_select.cuh"

// --- the bitonic body: radix select of the block's k-th key -----------------

using u64 = unsigned long long;

static_assert(sizeof(radix::Rows<1>) <= 4096, "SELECT_STATIC_SMEM in ops.py bounds it");

// A thread's C lanes of the block, [first, first + C), their hi in registers.
// Lanes past the vector (>= nvalid) hold hi 0; lanes past the block (j >= own)
// are inactive.  vec: xb is aligned for load4 (then so is every lane group).
template <typename T, int C>
struct RegLanes {
  static constexpr bool kZerosApart = false;  // radix::select_rows counts a lane an atomic
  unsigned hi[C];
  int first, own;

  __device__ __forceinline__ RegLanes(const T* xb, int nvalid, int first_, int own_, bool vec)
      : first(first_), own(own_) {
    if constexpr (C >= 4) {
#pragma unroll
      for (int g = 0; g < C; g += 4) {
        const int p = first + g;
        float f[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (vec && p + 4 <= nvalid) {
          load4(xb + p, f);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (p + j < nvalid) f[j] = to_f(xb[p + j]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) hi[g + j] = p + j < nvalid ? key_hi(f[j]) : 0u;
      }
    } else {
#pragma unroll
      for (int j = 0; j < C; ++j) hi[j] = first + j < nvalid ? key_hi(to_f(xb[first + j])) : 0u;
    }
  }

  template <class F>
  __device__ __forceinline__ void each_row(int, F&& f) const {
#pragma unroll
    for (int j = 0; j < C; ++j) f(first + j, hi[j], j < own);
  }
};

// The same for blocks whose lanes exceed the registers: n lanes a thread,
// each pass reading them again from x (L2 holds the block).
template <typename T>
struct GlobalLanes {
  static constexpr bool kZerosApart = false;  // radix::select_rows counts a lane an atomic
  const T* xb;
  int nvalid, first, own, n;

  template <class F>
  __device__ __forceinline__ void each_row(int, F&& f) const {
    for (int j = 0; j < n; ++j) {
      const int p = first + j;
      f(p, j < own && p < nvalid ? key_hi(to_f(xb[p])) : 0u, j < own);
    }
  }
};

// Sort kp (a power of two, at most the CTA's threads) unique keys
// descending: thread t holds key t.  The bitonic network of bitonic.cuh, its
// compare-exchanges between registers: across lanes of a warp by shuffles,
// across warps (partner 32 or more lanes away) through shared memory, buf[2
// * kp] written and read alternately, one barrier a stage.  Every thread
// calls it; thread t < kp ends holding the t-th largest key.
__device__ __forceinline__ u64 sort_in_registers(u64 key, int kp, u64* buf) {
  const int t = threadIdx.x;
  int half = 0;
  for (int run = 2; run <= kp; run <<= 1) {
    for (int j = run >> 1; j > 0; j >>= 1) {
      u64 other;
      if (j >= 32) {
        u64* b = buf + half * kp;
        if (t < kp) b[t] = key;
        __syncthreads();
        other = t < kp ? b[t ^ j] : key;
        half ^= 1;
      } else {
        other = __shfl_xor_sync(radix::kFull, key, j);
      }
      // runs alternate direction, the last merge all descending; the lower
      // lane of a descending pair keeps the larger key
      const bool keep_max = ((t & run) == 0) == ((t & j) == 0);
      key = (other > key) == keep_max ? other : key;
    }
  }
  return key;
}

// The block's top k: select, compact the k selected keys in position order
// (a lane's slot is the taken lanes before it: those above the cut, and of
// the ties at it the first `need`), put them in order, write the pairs.
template <typename T, class Lanes>
__device__ __forceinline__ void topk_select(const Lanes& lanes, const T* xb, long long base,
                                            int* idx_out, T* val_out, int k, int kp,
                                            u64* keys, radix::Rows<1>& sm) {
  radix::select_rows(lanes, 1, static_cast<unsigned>(k), sm);
  const radix::Cut cut = sm.cut[0];
  unsigned gt = 0, eq = 0;
  lanes.each_row(0, [&](int, unsigned hi, bool active) {
    gt += active && (hi & cut.mask) > cut.prefix;
    eq += active && (hi & cut.mask) == cut.prefix;
  });
  const u64 before = radix::exclusive_scan(gt | static_cast<u64>(eq) << 32, sm);
  unsigned g = static_cast<unsigned>(before), e = static_cast<unsigned>(before >> 32);
  lanes.each_row(0, [&](int pos, unsigned hi, bool active) {
    const unsigned h = hi & cut.mask;
    const u64 key = static_cast<u64>(hi) << 32 | (0xFFFFFFFFu - static_cast<unsigned>(pos));
    if (active && h > cut.prefix) {
      keys[g + min(e, cut.need)] = key;
      ++g;
    } else if (active && h == cut.prefix) {
      if (e < cut.need) keys[g + e] = key;
      ++e;
    }
  });
  const bool in_registers = kp <= static_cast<int>(blockDim.x);
  if (!in_registers)
    for (int i = k + threadIdx.x; i < kp; i += blockDim.x) keys[i] = 0ull;  // pads sort last
  __syncthreads();
  auto write = [&](int r, u64 key) {
    const bool ok = key_valid(key);
    const unsigned pos = key_pos(key);
    const long long slot = static_cast<long long>(blockIdx.x) * k + r;
    idx_out[slot] = ok ? static_cast<int>(base + pos) : 0;
    val_out[slot] = ok ? xb[pos] : from_f<T>(0.0f);
  };
  if (in_registers) {
    const int t = threadIdx.x;
    const u64 key = sort_in_registers(t < k ? keys[t] : 0ull, kp, keys);
    if (t < k) write(t, key);
  } else {
    bitonic_sort_desc(keys, kp);
    for (int r = threadIdx.x; r < k; r += blockDim.x) write(r, keys[r]);
  }
}

// C lanes a thread in registers (1, 2, 4, 8, 16), or C = 0: lpt lanes a
// thread read from x on each pass.  SCRATCH (C = 0 only): the kp selected
// keys in the device scratch buffer, else in shared memory.
template <typename T, int C, bool SCRATCH>
__global__ void __launch_bounds__(C == 0 || C == 16 ? 1024 : 256)
topk_radix_kernel(const T* __restrict__ x, int* __restrict__ idx_out, T* __restrict__ val_out,
                  long long v, int block_v, int k, int kp, int lpt, u64* scratch) {
  __shared__ radix::Rows<1> sm;
  extern __shared__ u64 key_smem[];
  u64* keys = SCRATCH ? scratch + static_cast<long long>(blockIdx.x) * kp : key_smem;
  const long long base = static_cast<long long>(blockIdx.x) * block_v;
  const T* xb = x + base;
  const int nvalid = static_cast<int>(v - base < block_v ? v - base : block_v);
  const int per = C > 0 ? C : lpt;
  const int first = static_cast<int>(threadIdx.x) * per;
  const int own = max(0, min(per, block_v - first));
  if constexpr (C > 0) {
    const bool vec = (reinterpret_cast<uintptr_t>(xb) & (4 * sizeof(T) - 1)) == 0;
    const RegLanes<T, C> lanes(xb, nvalid, first, own, vec);
    topk_select(lanes, xb, base, idx_out, val_out, k, kp, keys, sm);
  } else {
    const GlobalLanes<T> lanes{xb, nvalid, first, own, per};
    topk_select(lanes, xb, base, idx_out, val_out, k, kp, keys, sm);
  }
}

// Lanes a thread for a block of block_v (0: read from x each pass) and the
// CTA's threads: 256 threads or fewer while 16 lanes a thread cover the
// block, up to 1,024 for 16,384 lanes, past that 1,024 re-reading x.
static int lanes_per_thread(int block_v, int* threads) {
  for (int c = 1; c <= 16; c <<= 1) {
    const int t = (block_v + c - 1) / c;
    if (t <= 256 || (c == 16 && t <= 1024)) {
      *threads = (t + 31) / 32 * 32;
      return c;
    }
  }
  *threads = 1024;
  return 0;
}

// One launch of the radix body: its arguments, and the CTA shape picked.
template <typename T>
struct RadixLaunch {
  const T* x;
  int* idx_out;
  T* val_out;
  long long v;
  int block_v, k, kp, lpt, threads;
  u64* scratch;
  unsigned nblocks;
  cudaStream_t s;
};

template <typename T, int C, bool SCRATCH>
static int launch_radix(const RadixLaunch<T>& a) {
  // the kp keys; twice that while they are sorted in registers (the
  // exchange's two halves)
  const size_t smem = SCRATCH ? 0 : static_cast<size_t>(a.kp) * (a.kp <= a.threads ? 16 : 8);
  const auto kernel = topk_radix_kernel<T, C, SCRATCH>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<a.nblocks, a.threads, smem, a.s>>>(a.x, a.idx_out, a.val_out, a.v, a.block_v, a.k,
                                              a.kp, a.lpt, a.scratch);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_bitonic(const T* x, int* idx_out, T* val_out, long long v, int block_v,
                          int k, void* scratch, cudaStream_t s) {
  int threads = 0;
  const int c = lanes_per_thread(block_v, &threads);
  const RadixLaunch<T> a{x, idx_out, val_out, v, block_v, k, next_pow2(k),
                         (block_v + threads - 1) / threads, threads,
                         static_cast<u64*>(scratch),
                         static_cast<unsigned>((v + block_v - 1) / block_v), s};
  if (scratch != nullptr && c != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (c) {
    case 1: return launch_radix<T, 1, false>(a);
    case 2: return launch_radix<T, 2, false>(a);
    case 4: return launch_radix<T, 4, false>(a);
    case 8: return launch_radix<T, 8, false>(a);
    case 16: return launch_radix<T, 16, false>(a);
    default: return scratch ? launch_radix<T, 0, true>(a) : launch_radix<T, 0, false>(a);
  }
}

// --- the argmax body: warp lists merged over the CTA ------------------------

// Keys a warp's list holds at most, 8 a lane: a k past it is taken in
// segments of kListCap keys (ops.py's LIST_CAP mirrors it).
constexpr int kListCap = 256;
// Lanes a thread loads and sorts at a time, and so a warp's keys a group.
constexpr int kGroup = 4;
constexpr int kGroupKeys = 32 * kGroup;
constexpr unsigned kWarpAll = 0xFFFFFFFFu;

// a > b for two packed keys, compared as the doubles of their bits: a
// key's high half is below 0x7F800002 for any float (bits(|x|) + 1, NaN
// included), so the double has sign 0 and an exponent field below 0x7FF — a
// non-negative finite or subnormal value — and such doubles order as their
// bits do as unsigned integers (fp64 never flushes subnormals).  One DSETP
// on the FP64 pipe where a 64-bit integer comparison takes two ISETP on
// the integer pipe that the selects already load.
__device__ __forceinline__ bool key_gt(u64 a, u64 b) {
  return __longlong_as_double(static_cast<long long>(a)) >
         __longlong_as_double(static_cast<long long>(b));
}

// One compare-exchange stage of a bitonic network over a warp's 32 * M
// keys, key e = lane * M + r in register r of its lane: e against e ^ j,
// the pair left descending where (e & dir) == 0, ascending elsewhere (dir
// 0: descending everywhere).  j < M: two registers of a lane; else a
// shuffle.  j is a constant wherever it is called (unrolled loops).
template <int M>
__device__ __forceinline__ void stage(u64 (&key)[M], int lane, int j, int dir) {
  if (j < M) {
#pragma unroll
    for (int r = 0; r < M; ++r) {
      if (r & j) continue;
      const bool desc = ((lane * M + r) & dir) == 0;
      const u64 a = key[r], b = key[r | j];
      const bool swap = key_gt(b, a) == desc;  // equal keys (0s past the block) either way
      key[r] = swap ? b : a;
      key[r | j] = swap ? a : b;
    }
  } else {
#pragma unroll
    for (int r = 0; r < M; ++r) {
      const int e = lane * M + r;
      const u64 other = __shfl_xor_sync(kWarpAll, key[r], j / M);
      const bool keep_max = ((e & dir) == 0) == ((e & j) == 0);
      key[r] = key_gt(other, key[r]) == keep_max ? other : key[r];
    }
  }
}

// Every e keeps the larger of its key and e ^ half's (half a constant).
template <int M>
__device__ __forceinline__ void fold(u64 (&key)[M], int half) {
  if (half < M) {
#pragma unroll
    for (int r = 0; r < M; ++r)
      if ((r & half) == 0 && key_gt(key[r | half], key[r])) key[r] = key[r | half];
  } else {
#pragma unroll
    for (int r = 0; r < M; ++r) {
      const u64 other = __shfl_xor_sync(kWarpAll, key[r], half / M);
      if (key_gt(other, key[r])) key[r] = other;
    }
  }
}

template <int M>
struct LogOf {  // log2(32 * M)
  static constexpr int value = M == 1 ? 5 : M == 2 ? 6 : M == 4 ? 7 : 8;
};

// The warp's top R = min(kp, 32C) keys, descending at e < R (layout C).
// Runs of R sorted in alternating directions (run b descending for b
// even); then, a level at a time, each pair of runs folded (e keeps the
// larger of e and e ^ half: the pair's top R, a bitonic sequence) and
// cleaned, descending where (e & 2 half) == 0, so that the next level's
// pairs alternate again, until one run is left.
template <int C>
__device__ __forceinline__ void warp_top(u64 (&key)[C], int lane, int kp) {
  constexpr int kLog = LogOf<C>::value;
  const int R = kp < (32 * C) ? kp : 32 * C;
#pragma unroll
  for (int lr = 1; lr <= kLog; ++lr) {
    if ((1 << lr) <= R) {
#pragma unroll
      for (int lj = lr - 1; lj >= 0; --lj) stage<C>(key, lane, 1 << lj, 1 << lr);
    }
  }
#pragma unroll
  for (int lh = 0; lh < kLog; ++lh) {
    if ((1 << lh) >= R) {
      fold<C>(key, 1 << lh);
#pragma unroll
      for (int lj = kLog - 1; lj >= 0; --lj)
        if ((1 << lj) < R) stage<C>(key, lane, 1 << lj, 2 << lh);
    }
  }
}

// Merge into the warp's list `mine` (kp keys, descending) the n_other keys
// `other` holds descending (the rest counted as key 0), M = max(1, kp / 32)
// keys a lane: e keeps the larger of mine[e] and other[kp - 1 - e] (the top
// kp of both, a bitonic sequence), then a clean leaves them descending.
// Each lane reads and writes its own e of `mine` only.
template <int M>
__device__ __forceinline__ void merge_lists(u64* mine, const u64* other, int n_other, int lane,
                                            int kp) {
  u64 key[M];
#pragma unroll
  for (int r = 0; r < M; ++r) {
    const int e = lane * M + r;
    key[r] = e < kp ? mine[e] : 0ull;
    const u64 o = e < kp && kp - 1 - e < n_other ? other[kp - 1 - e] : 0ull;
    if (key_gt(o, key[r])) key[r] = o;
  }
#pragma unroll
  for (int lj = LogOf<M>::value - 1; lj >= 0; --lj)
    if ((1 << lj) < kp) stage<M>(key, lane, 1 << lj, 0);
#pragma unroll
  for (int r = 0; r < M; ++r)
    if (lane * M + r < kp) mine[lane * M + r] = key[r];
}

__device__ __forceinline__ void merge_into(u64* mine, const u64* other, int n_other, int lane,
                                           int kp) {
  if (kp <= 32) merge_lists<1>(mine, other, n_other, lane, kp);
  else if (kp <= 64) merge_lists<2>(mine, other, n_other, lane, kp);
  else if (kp <= 128) merge_lists<4>(mine, other, n_other, lane, kp);
  else merge_lists<8>(mine, other, n_other, lane, kp);
}

static_assert(kGroup == 4, "load_keys reads a thread's group as one load4");

// Thread `first`'s kGroup lanes of the block as packed keys (bitonic.cuh):
// hi 0 past the vector, key 0 (below every lane's) past the block.  vec: xb
// is aligned for load4 (then so is xb + first, a multiple of 4).
template <typename T>
__device__ __forceinline__ void load_keys(u64 (&key)[kGroup], const T* xb, int nvalid,
                                          int block_v, int first, bool vec) {
  float f[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (vec && first + 4 <= nvalid) {
    load4(xb + first, f);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (first + j < nvalid) f[j] = to_f(xb[first + j]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = first + j;
    const u64 hi = q < nvalid ? key_hi(f[j]) : 0u;
    key[j] = q < block_v ? hi << 32 | (0xFFFFFFFFu - static_cast<unsigned>(q)) : 0ull;
  }
}

__device__ __forceinline__ int next_pow2_dev(int n) { return n > 1 ? 1 << (32 - __clz(n - 1)) : 1; }

// The argmax body: the block in `groups` groups of blockDim.x * kGroup
// lanes, thread t loading lanes [t * kGroup, t * kGroup + kGroup) of each.
// For each segment of n <= kListCap output slots (one, unless k > kListCap):
// each warp keeps a list of kp = next_pow2(n) keys in shared memory, the
// top kp of its lanes below `bound` (the last key of the segment before).
// The first group's top kp, by warp_top over the warp's 128 keys, starts
// it; a later group's keys pass a threshold, the list's n-th key, before
// they enter: none, and the group is done; at most 32, and they are
// compacted to one a lane, sorted as 32 and merged in; more, and the
// group's top kp by warp_top is merged in.  Then the warps' lists merge
// pairwise, a barrier a level; the first n keys of warp 0's list are the
// segment's pairs.  Shared
// memory: each warp's list, then its staging area of kGroupKeys keys.
template <typename T>
__global__ void __launch_bounds__(1024)
topk_list_kernel(const T* __restrict__ x, int* __restrict__ idx_out, T* __restrict__ val_out,
                 long long v, int block_v, int k, int groups) {
  extern __shared__ u64 lists[];  // warp w's list at w * kp, its staging area past them all
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * block_v;
  const T* xb = x + base;
  const int nvalid = static_cast<int>(v - base < block_v ? v - base : block_v);
  const bool vec = (reinterpret_cast<uintptr_t>(xb) & (4 * sizeof(T) - 1)) == 0;
  const int span = blockDim.x * kGroup;
  u64* stage_keys = lists + nwarps * next_pow2_dev(k < kListCap ? k : kListCap) +
                    warp * kGroupKeys;
  u64 bound = ~0ull;  // every key of the segments before is at or above it
  for (int done = 0; done < k; done += kListCap) {
    const int n = k - done < kListCap ? k - done : kListCap;
    const int kp = next_pow2_dev(n);
    u64* mine = lists + warp * kp;
    u64 theta = 0ull;  // the list's n-th key: a key at or below it cannot enter
    for (int g = 0; g < groups; ++g) {
      u64 key[kGroup];
      load_keys<T>(key, xb, nvalid, block_v, g * span + threadIdx.x * kGroup, vec);
      unsigned enter[kGroup];
      int count = 0;
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        key[r] = key[r] < bound && key[r] > theta ? key[r] : 0ull;
        enter[r] = __ballot_sync(kWarpAll, key[r] != 0ull);
        count += __popc(enter[r]);
      }
      if (g > 0 && count == 0) continue;  // the first group starts the list, whatever enters
      if (g > 0 && count <= 32) {  // few enter: one a lane, sorted as 32, merged in
        int at = 0;
#pragma unroll
        for (int r = 0; r < kGroup; ++r) {
          if (key[r] != 0ull) stage_keys[at + __popc(enter[r] & ((1u << lane) - 1u))] = key[r];
          at += __popc(enter[r]);
        }
        __syncwarp();
        u64 one[1] = {lane < count ? stage_keys[lane] : 0ull};
        warp_top<1>(one, lane, 32);
        __syncwarp();
        stage_keys[lane] = one[0];
        __syncwarp();
        merge_into(mine, stage_keys, 32, lane, kp);
      } else {
        warp_top<kGroup>(key, lane, kp);
        const int R = kp < kGroupKeys ? kp : kGroupKeys;
        u64* dst = g == 0 ? mine : stage_keys;
#pragma unroll
        for (int r = 0; r < kGroup; ++r)
          if (lane * kGroup + r < R) dst[lane * kGroup + r] = key[r];
        if (g == 0) {
          for (int i = R + lane; i < kp; i += 32) mine[i] = 0ull;  // fewer keys than kp
        } else {
          __syncwarp();
          merge_into(mine, stage_keys, R, lane, kp);
        }
      }
      __syncwarp();
      theta = mine[n - 1];
    }
    __syncthreads();
    for (int step = 1; step < nwarps; step <<= 1) {
      if ((warp & (2 * step - 1)) == 0 && warp + step < nwarps)
        merge_into(mine, mine + step * kp, kp, lane, kp);
      __syncthreads();
    }
    for (int r = threadIdx.x; r < n; r += blockDim.x) {
      const u64 key = lists[r];
      const bool ok = key_valid(key);
      const unsigned pos = key_pos(key);
      const long long slot = static_cast<long long>(blockIdx.x) * k + done + r;
      idx_out[slot] = ok ? static_cast<int>(base + pos) : 0;
      val_out[slot] = ok ? xb[pos] : from_f<T>(0.0f);
    }
    if (done + n < k) {
      bound = lists[n - 1];
      __syncthreads();  // every thread has read the lists before they are rewritten
    }
  }
}

// More CTAs than an H100 has SMs: past them the CTAs queue for the SMs and
// a CTA's work counts, not its latency.
constexpr long long kFillCtas = 132;
// Lanes a thread past kFillCtas CTAs: a warp then takes 1,024 lanes of
// the block in eight groups, most of them past the first going the
// few-keys way, and a 1,024-lane block is one warp, with no merge of lists.
constexpr int kWideLanes = 32;

// The CTA's threads for nblocks blocks of block_v, and the groups of 4
// lanes a thread.  Up to kFillCtas CTAs, for the latency of one: 4, 8 or 16
// lanes a thread in at most 1,024 threads (4 to 4,096 lanes: one group of
// 128 lanes a warp, 4 warps at logreg's 512; 8 to 8,192; 16 to 16,384),
// past that 1,024 threads of as many groups as the block needs.  Past
// kFillCtas, for the work: kWideLanes a thread (pagerank's 1,024-lane
// blocks: one warp), at most 1,024 threads.
static int argmax_layout(int block_v, long long nblocks, int* groups) {
  int threads = 1024;
  if (nblocks > kFillCtas) {
    const int t = (block_v + kWideLanes - 1) / kWideLanes;
    threads = t < 1024 ? (t + 31) / 32 * 32 : 1024;
  } else {
    for (int c = 4; c <= 16; c <<= 1) {
      const int t = (block_v + c - 1) / c;
      if (t <= 1024) {
        threads = (t + 31) / 32 * 32;
        break;
      }
    }
  }
  *groups = (block_v + threads * kGroup - 1) / (threads * kGroup);
  return threads;
}

template <typename T>
static int launch_argmax(const T* x, int* idx_out, T* val_out, long long v, int block_v,
                         int k, cudaStream_t s) {
  const long long nblocks = (v + block_v - 1) / block_v;
  int groups = 0;
  const int threads = argmax_layout(block_v, nblocks, &groups);
  const size_t smem = static_cast<size_t>(threads / 32) *
                      (next_pow2(k < kListCap ? k : kListCap) + kGroupKeys) * sizeof(u64);
  const auto kernel = topk_list_kernel<T>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(nblocks), threads, smem, s>>>(x, idx_out, val_out, v, block_v,
                                                                k, groups);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int dispatch(const void* x, int* idx_out, void* val_out, long long v, int block_v,
                    int k, int bitonic, void* scratch, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* vt = static_cast<T*>(val_out);
  if (bitonic) return launch_bitonic<T>(xt, idx_out, vt, v, block_v, k, scratch, s);
  if (scratch) return static_cast<int>(cudaErrorInvalidValue);  // the argmax body takes none
  return launch_argmax<T>(xt, idx_out, vt, v, block_v, k, s);
}

// dtype: kF32 or kBF16.  scratch: the bitonic body's only, null while its k
// selected keys, 8 * next_pow2(k) bytes (plus sizeof(radix::Rows<1>)
// static), fit a CTA's shared memory, else nblocks times that; the argmax
// body takes none at any block or k.
extern "C" int topk_compress(int dtype, const void* x, int* idx_out, void* val_out,
                             long long v, int block_v, int k, int bitonic, void* scratch,
                             void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch<float>(x, idx_out, val_out, v, block_v, k, bitonic, scratch, s);
  return dispatch<__nv_bfloat16>(x, idx_out, val_out, v, block_v, k, bitonic, scratch, s);
}
