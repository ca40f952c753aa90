// Sparse scatter-add: densify (index, value) pairs — the receive side of the
// accumulator's sparse mode.
//
// Replaces: src/repro/kernels/sparse_update/kernel.py — _scatter_kernel,
//   sparse_scatter_add (and its wrapper ops.scatter_add).
//
// Pairs idx/vals of `rows` rows of m pairs each (float32 or bfloat16 values,
// int32 or int64 indices) -> out (out_len,) in the values' type: every pair
// whose index lies in [0, out_len) is added into an fp32 sum, rows in row
// order; indices outside that range are dropped, as the TPU kernel's `inside`
// mask drops them.  bfloat16 results are cast once at the end.
//
// Design: the TPU kernel's one-hot GEMM per output block is not carried over
// (O(m * out_len / block) work).  Here one grid-stride launch per row adds the
// row's pairs into the fp32 sum with atomicAdd; the launches follow each other
// on one stream, so row t's adds all land after row t-1's.  Within a row the
// order of the atomics is free.  Where a row's indices are unique apart from
// (0, +0.0) padding — the contract of the accumulator's pairs — every element
// receives at most one nonzero add per row, and adding +0.0 to a sum that
// started at +0.0 never changes it, so the result is bit-exact with the
// sequential scatter (rows in order, pairs in order).  With arbitrary
// duplicates inside one row the order of the atomic adds varies from run to
// run, and the result holds only to the rounding of a reordered fp32 sum.
// The fp32 atomic flushes subnormal inputs and results to zero, as the card's
// own index_add_ does.
//
// Bound: device memory — the pairs read once (rows * m * (index + value
// bytes)) and out_len elements written once; 17.4 us at 3.35 TB/s for the
// pagerank unfused round (4 x 1,211,904 int32/float32 pairs into 4,847,571).
// What bounds this simple version instead is the atomics where indices
// collide, and one launch per row.

#include <cuda_bf16.h>

#include "common.cuh"

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__global__ void zero_kernel(float* __restrict__ acc, long long n) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step)
    acc[i] = 0.0f;
}

template <typename I, typename T>
__global__ void __launch_bounds__(kThreads)
scatter_row_kernel(const I* __restrict__ idx, const T* __restrict__ vals, long long m,
                   long long out_len, float* __restrict__ acc) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; j < m;
       j += step) {
    const long long i = static_cast<long long>(idx[j]);
    if (i >= 0 && i < out_len) atomicAdd(acc + i, to_f(vals[j]));
  }
}

__global__ void cast_kernel(const float* __restrict__ acc, __nv_bfloat16* __restrict__ out,
                            long long n) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step)
    out[i] = __float2bfloat16(acc[i]);
}

static unsigned grid_for(long long work, int sms) {
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 8LL * sms) blocks = 8LL * sms;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

template <typename I, typename T>
static int scatter_rows(const void* idx, const void* vals, int rows, long long m,
                        long long out_len, float* acc, cudaStream_t s, int sms) {
  const unsigned grid = grid_for(m, sms);
  for (int t = 0; t < rows; ++t) {
    scatter_row_kernel<I, T><<<grid, kThreads, 0, s>>>(
        static_cast<const I*>(idx) + t * m, static_cast<const T*>(vals) + t * m, m, out_len,
        acc);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// index_kind: 0 int32, 1 int64; dtype: 0 float32, 1 bfloat16.  acc is the
// fp32 sum (out_len); out receives the bfloat16 cast (null for float32, where
// acc is the output itself).  Returns the first launch error.
extern "C" int sparse_scatter_add_rows(int index_kind, int dtype, const void* idx,
                                       const void* vals, int rows, long long m,
                                       long long out_len, float* acc, void* out,
                                       void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  zero_kernel<<<grid_for(out_len, sms), kThreads, 0, s>>>(acc, out_len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int code;
  if (index_kind == 0)
    code = dtype == 0 ? scatter_rows<int, float>(idx, vals, rows, m, out_len, acc, s, sms)
                      : scatter_rows<int, __nv_bfloat16>(idx, vals, rows, m, out_len, acc, s, sms);
  else
    code = dtype == 0
               ? scatter_rows<long long, float>(idx, vals, rows, m, out_len, acc, s, sms)
               : scatter_rows<long long, __nv_bfloat16>(idx, vals, rows, m, out_len, acc, s, sms);
  if (code != 0 || dtype == 0) return code;
  cast_kernel<<<grid_for(out_len, sms), kThreads, 0, s>>>(acc,
                                                          static_cast<__nv_bfloat16*>(out),
                                                          out_len);
  return static_cast<int>(cudaGetLastError());
}
