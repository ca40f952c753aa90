// Blocked top-k magnitude compression: the unfused accumulator's sparsifier.
//
// Replaces: src/repro/kernels/topk_compress/kernel.py — topk_compress_blocked
//   with its two bodies, _topk_kernel (argmax loop) and _topk_bitonic_kernel.
//
// x (V,) float32 -> idx int32 (nblocks*k,), vals float32 (nblocks*k,): per
// block of block_v, the k largest |x| in (|x| desc, index asc) order.  Lanes
// past V, and slots left once a block's entries are exhausted, give (0, 0); a
// valid zero keeps its real index.  The two bodies are element-wise identical.
//
// Design: one CTA per block, one thread per lane (blockDim = block_v padded to
// a power of two, at least a warp, <= 1024).
//   argmax: magnitudes in shared memory (-1 for lanes past V, -2 once taken,
//     -inf for pad lanes); k block-wide argmax reductions — warp shuffles,
//     then one warp over the per-warp winners — with ties to the lower lane.
//   bitonic: packed keys (bitonic.cuh) sorted once in shared memory; the
//     first k keys are the pairs.  O(log^2 block_v) stages whatever k is,
//     where the argmax loop pays k reductions — hence BITONIC_MIN_K.
//
// Bound: device memory — V floats read, 2*nblocks*k words written; at 3.35
// TB/s on an H100 that is microseconds for any vector the accumulator sees.
// What bounds these simple versions instead is synchronisation: 2 barriers per
// argmax round, one per bitonic stage.

#include <math_constants.h>

#include "common.cuh"
#include "bitonic.cuh"

__device__ __forceinline__ bool argmax_better(float m, int a, float om, int oa) {
  return om > m || (om == m && oa < a);
}

__global__ void topk_argmax_kernel(const float* __restrict__ x,
                                   int* __restrict__ idx_out,
                                   float* __restrict__ val_out, long long v,
                                   int block_v, int k) {
  __shared__ float mag[1024];
  __shared__ float win_m[32];
  __shared__ int win_a[32];
  const int i = threadIdx.x;
  const int lane = i & 31, warp = i >> 5, nwarps = blockDim.x >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * block_v;
  const bool in_block = i < block_v;
  const bool valid = in_block && base + i < v;
  mag[i] = in_block ? (valid ? fabsf(x[base + i]) : -1.0f) : -CUDART_INF_F;
  __syncthreads();
  for (int r = 0; r < k; ++r) {
    float m = mag[i];
    int a = i;
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
        const bool ok = m >= 0.0f;  // padded / exhausted -> (0, 0) pair
        const long long slot = static_cast<long long>(blockIdx.x) * k + r;
        idx_out[slot] = ok ? static_cast<int>(base + a) : 0;
        val_out[slot] = ok ? x[base + a] : 0.0f;
        mag[a] = -2.0f;
      }
    }
    __syncthreads();
  }
}

__global__ void topk_bitonic_kernel(const float* __restrict__ x,
                                    int* __restrict__ idx_out,
                                    float* __restrict__ val_out, long long v,
                                    int block_v, int k) {
  __shared__ unsigned long long keys[1024];
  const int i = threadIdx.x;
  const int L = blockDim.x;
  const long long base = static_cast<long long>(blockIdx.x) * block_v;
  const bool valid = i < block_v && base + i < v;
  keys[i] = topk_key(valid ? x[base + i] : 0.0f, valid, static_cast<unsigned>(i));
  __syncthreads();
  bitonic_sort_desc(keys, L);
  for (int r = i; r < k; r += blockDim.x) {
    const unsigned long long key = keys[r];
    const bool ok = key_valid(key);
    const long long pos = base + key_pos(key);
    const long long slot = static_cast<long long>(blockIdx.x) * k + r;
    idx_out[slot] = ok ? static_cast<int>(pos) : 0;
    val_out[slot] = ok ? x[pos] : 0.0f;
  }
}

extern "C" int topk_compress_f32(const float* x, int* idx_out, float* val_out,
                                 long long v, int block_v, int k, int bitonic,
                                 void* stream) {
  const int threads = next_pow2(block_v < 32 ? 32 : block_v);
  const long long nblocks = (v + block_v - 1) / block_v;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bitonic) {
    topk_bitonic_kernel<<<static_cast<unsigned>(nblocks), threads, 0, s>>>(
        x, idx_out, val_out, v, block_v, k);
  } else {
    topk_argmax_kernel<<<static_cast<unsigned>(nblocks), threads, 0, s>>>(
        x, idx_out, val_out, v, block_v, k);
  }
  return static_cast<int>(cudaGetLastError());
}
