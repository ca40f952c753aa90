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
//   argmax: min(next_pow2(max(block_v, 32)), 1024) threads, each owning the
//     lanes i, i + blockDim, ...; magnitudes (-1 for lanes past V, -2 once
//     taken) of the block_v lanes; k block-wide argmax rounds — each thread
//     reduces its own lanes, then warp shuffles, then one warp over the
//     per-warp winners — with ties to the lower lane throughout.  The
//     magnitudes (4 block_v bytes) lie in shared memory while they fit a CTA,
//     else in a device scratch buffer the wrapper allocates (nblocks times
//     that size): the same code on a pointer.
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
// accumulator sees (8.7 us at pagerank's V).  What bounds the argmax body
// instead is synchronisation, 2 barriers per round; the bitonic body, the
// instructions of its digit passes and of the network over the k keys.

#include <math_constants.h>

#include <cstdint>

#include "common.cuh"
#include "bitonic.cuh"
#include "dtype.cuh"
#include "radix_select.cuh"

__device__ __forceinline__ bool argmax_better(float m, int a, float om, int oa) {
  return om > m || (om == m && oa < a);
}

// SCRATCH (both bodies): the working set in the device scratch buffer, else
// in shared memory (a template argument, so that the shared instantiation's
// loads and stores are shared-memory ones, not generic)
template <typename T, bool SCRATCH>
__global__ void topk_argmax_kernel(const T* __restrict__ x, int* __restrict__ idx_out,
                                   T* __restrict__ val_out, long long v, int block_v,
                                   int k, float* scratch) {
  extern __shared__ float mag_smem[];  // block_v magnitudes
  __shared__ float win_m[32];
  __shared__ int win_a[32];
  float* mag = SCRATCH ? scratch + static_cast<long long>(blockIdx.x) * block_v : mag_smem;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * block_v;
  for (int i = tid; i < block_v; i += blockDim.x)
    mag[i] = base + i < v ? fabsf(to_f(x[base + i])) : -1.0f;
  __syncthreads();
  for (int r = 0; r < k; ++r) {
    // a thread past the block holds (-inf, its own lane), which no lane of
    // the block (magnitude >= -2) loses to
    float m = tid < block_v ? mag[tid] : -CUDART_INF_F;
    int a = tid;
    for (int i = tid + blockDim.x; i < block_v; i += blockDim.x) {
      const float mi = mag[i];
      if (mi > m) {  // lanes in increasing order: ties stay with the lower
        m = mi;
        a = i;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float om = __shfl_down_sync(0xFFFFFFFFu, m, off);
      const int oa = __shfl_down_sync(0xFFFFFFFFu, a, off);
      if (argmax_better(m, a, om, oa)) {
        m = om;
        a = oa;
      }
    }
    if (lane == 0) {
      win_m[warp] = m;
      win_a[warp] = a;
    }
    __syncthreads();
    if (warp == 0) {
      m = lane < nwarps ? win_m[lane] : -CUDART_INF_F;
      a = lane < nwarps ? win_a[lane] : 0x7FFFFFFF;
      for (int off = 16; off > 0; off >>= 1) {
        const float om = __shfl_down_sync(0xFFFFFFFFu, m, off);
        const int oa = __shfl_down_sync(0xFFFFFFFFu, a, off);
        if (argmax_better(m, a, om, oa)) {
          m = om;
          a = oa;
        }
      }
      if (lane == 0) {
        const bool ok = m >= 0.0f;  // past V / exhausted -> (0, 0) pair
        const long long slot = static_cast<long long>(blockIdx.x) * k + r;
        idx_out[slot] = ok ? static_cast<int>(base + a) : 0;
        val_out[slot] = ok ? x[base + a] : from_f<T>(0.0f);
        mag[a] = -2.0f;
      }
    }
    __syncthreads();
  }
}

// --- the bitonic body: radix select of the block's k-th key -----------------

using u64 = unsigned long long;

static_assert(sizeof(radix::Smem) <= 4096, "SELECT_STATIC_SMEM in ops.py bounds it");

// The high half of a lane's packed key (bitonic.cuh's topk_key).
__device__ __forceinline__ unsigned key_hi(float f) { return __float_as_uint(fabsf(f)) + 1u; }

__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  f[0] = q.x, f[1] = q.y, f[2] = q.z, f[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  alignas(8) __nv_bfloat16 b[4];
  *reinterpret_cast<uint2*>(b) = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int j = 0; j < 4; ++j) f[j] = __bfloat162float(b[j]);
}

// A thread's C lanes of the block, [first, first + C), their hi in registers.
// Lanes past the vector (>= nvalid) hold hi 0; lanes past the block (j >= own)
// are inactive.  vec: xb is aligned for load4 (then so is every lane group).
template <typename T, int C>
struct RegLanes {
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
  __device__ __forceinline__ void each(F&& f) const {
#pragma unroll
    for (int j = 0; j < C; ++j) f(first + j, hi[j], j < own);
  }
};

// The same for blocks whose lanes exceed the registers: n lanes a thread,
// each pass reading them again from x (L2 holds the block).
template <typename T>
struct GlobalLanes {
  const T* xb;
  int nvalid, first, own, n;

  template <class F>
  __device__ __forceinline__ void each(F&& f) const {
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
                                            u64* keys, radix::Smem& sm) {
  const radix::Cut cut = radix::select(lanes, static_cast<unsigned>(k), sm);
  unsigned gt = 0, eq = 0;
  lanes.each([&](int, unsigned hi, bool active) {
    gt += active && (hi & cut.mask) > cut.prefix;
    eq += active && (hi & cut.mask) == cut.prefix;
  });
  const u64 before = radix::exclusive_scan(gt | static_cast<u64>(eq) << 32, sm);
  unsigned g = static_cast<unsigned>(before), e = static_cast<unsigned>(before >> 32);
  lanes.each([&](int pos, unsigned hi, bool active) {
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
  __shared__ radix::Smem sm;
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

template <typename T, bool SCRATCH>
static int launch_argmax(const T* x, int* idx_out, T* val_out, long long v, int block_v,
                         int k, void* scratch, cudaStream_t s) {
  const int L = next_pow2(block_v < 32 ? 32 : block_v);
  const int threads = L < 1024 ? L : 1024;
  const unsigned nblocks = static_cast<unsigned>((v + block_v - 1) / block_v);
  const size_t smem = SCRATCH ? 0 : static_cast<size_t>(block_v) * 4;
  const cudaError_t e = allow_smem(topk_argmax_kernel<T, SCRATCH>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  topk_argmax_kernel<T, SCRATCH><<<nblocks, threads, smem, s>>>(
      x, idx_out, val_out, v, block_v, k, static_cast<float*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int dispatch(const void* x, int* idx_out, void* val_out, long long v, int block_v,
                    int k, int bitonic, void* scratch, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* vt = static_cast<T*>(val_out);
  if (bitonic) return launch_bitonic<T>(xt, idx_out, vt, v, block_v, k, scratch, s);
  if (scratch) return launch_argmax<T, true>(xt, idx_out, vt, v, block_v, k, scratch, s);
  return launch_argmax<T, false>(xt, idx_out, vt, v, block_v, k, scratch, s);
}

// dtype: kF32 or kBF16.  scratch: null while the working set fits a CTA's
// shared memory — argmax: the block's magnitudes, 4 * block_v bytes (plus 256
// static); bitonic: the k selected keys, 8 * next_pow2(k) bytes (plus
// sizeof(radix::Smem) static) — else nblocks times that.
extern "C" int topk_compress(int dtype, const void* x, int* idx_out, void* val_out,
                             long long v, int block_v, int k, int bitonic, void* scratch,
                             void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch<float>(x, idx_out, val_out, v, block_v, k, bitonic, scratch, s);
  return dispatch<__nv_bfloat16>(x, idx_out, val_out, v, block_v, k, bitonic, scratch, s);
}
