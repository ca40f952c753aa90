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
// Design: one CTA per block, min(next_pow2(max(block_v, 32)), 1024) threads,
// each owning the lanes i, i + blockDim, ...
//   argmax: magnitudes (-1 for lanes past V, -2 once taken) of the block_v
//     lanes; k block-wide argmax rounds — each thread reduces its own lanes,
//     then warp shuffles, then one warp over the per-warp winners — with ties
//     to the lower lane throughout.
//   bitonic: packed keys (bitonic.cuh) of L = next_pow2(max(block_v, 32))
//     lanes sorted once; the first k keys are the pairs.  O(log^2 L) stages
//     whatever k is, where the argmax loop pays k reductions — hence
//     BITONIC_MIN_K.
// The magnitudes (4 block_v bytes) or keys (8 L bytes) lie in shared memory
// while they fit a CTA, else in a device scratch buffer the wrapper allocates
// (nblocks times that size): the same code on a pointer.
//
// Bound: device memory — V elements read, nblocks*k index and value words
// written; at 3.35 TB/s on an H100 that is microseconds for any vector the
// accumulator sees.  What bounds these simple versions instead is
// synchronisation: 2 barriers per argmax round, one per bitonic stage.

#include <math_constants.h>

#include "common.cuh"
#include "bitonic.cuh"
#include "dtype.cuh"

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

template <typename T, bool SCRATCH>
__global__ void topk_bitonic_kernel(const T* __restrict__ x, int* __restrict__ idx_out,
                                    T* __restrict__ val_out, long long v, int block_v,
                                    int k, int L, unsigned long long* scratch) {
  extern __shared__ unsigned long long key_smem[];  // L keys
  unsigned long long* keys =
      SCRATCH ? scratch + static_cast<long long>(blockIdx.x) * L : key_smem;
  const long long base = static_cast<long long>(blockIdx.x) * block_v;
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const bool valid = i < block_v && base + i < v;
    keys[i] = topk_key(valid ? to_f(x[base + i]) : 0.0f, valid, static_cast<unsigned>(i));
  }
  __syncthreads();
  bitonic_sort_desc(keys, L);
  for (int r = threadIdx.x; r < k; r += blockDim.x) {
    const unsigned long long key = keys[r];
    const bool ok = key_valid(key);
    const long long pos = base + key_pos(key);
    const long long slot = static_cast<long long>(blockIdx.x) * k + r;
    idx_out[slot] = ok ? static_cast<int>(pos) : 0;
    val_out[slot] = ok ? x[pos] : from_f<T>(0.0f);
  }
}

template <typename T, bool SCRATCH>
static int launch(const void* x, int* idx_out, void* val_out, long long v, int block_v,
                  int k, int bitonic, void* scratch, cudaStream_t s) {
  const int L = next_pow2(block_v < 32 ? 32 : block_v);
  const int threads = L < 1024 ? L : 1024;
  const unsigned nblocks = static_cast<unsigned>((v + block_v - 1) / block_v);
  const T* xt = static_cast<const T*>(x);
  T* vt = static_cast<T*>(val_out);
  cudaError_t e;
  if (bitonic) {
    const size_t smem = SCRATCH ? 0 : static_cast<size_t>(L) * 8;
    if ((e = allow_smem(topk_bitonic_kernel<T, SCRATCH>, smem)) != cudaSuccess)
      return static_cast<int>(e);
    topk_bitonic_kernel<T, SCRATCH><<<nblocks, threads, smem, s>>>(
        xt, idx_out, vt, v, block_v, k, L, static_cast<unsigned long long*>(scratch));
  } else {
    const size_t smem = SCRATCH ? 0 : static_cast<size_t>(block_v) * 4;
    if ((e = allow_smem(topk_argmax_kernel<T, SCRATCH>, smem)) != cudaSuccess)
      return static_cast<int>(e);
    topk_argmax_kernel<T, SCRATCH><<<nblocks, threads, smem, s>>>(
        xt, idx_out, vt, v, block_v, k, static_cast<float*>(scratch));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int dispatch(const void* x, int* idx_out, void* val_out, long long v, int block_v,
                  int k, int bitonic, void* scratch, cudaStream_t s) {
  if (scratch) return launch<T, true>(x, idx_out, val_out, v, block_v, k, bitonic, scratch, s);
  return launch<T, false>(x, idx_out, val_out, v, block_v, k, bitonic, scratch, s);
}

// dtype: kF32 or kBF16.  scratch: null while the block's magnitudes (argmax:
// 4 * block_v bytes, plus 256 static) or keys (bitonic: 8 * next_pow2(max(
// block_v, 32)) bytes) fit a CTA's shared memory, else nblocks times that.
extern "C" int topk_compress(int dtype, const void* x, int* idx_out, void* val_out,
                             long long v, int block_v, int k, int bitonic, void* scratch,
                             void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch<float>(x, idx_out, val_out, v, block_v, k, bitonic, scratch, s);
  return dispatch<__nv_bfloat16>(x, idx_out, val_out, v, block_v, k, bitonic, scratch, s);
}
