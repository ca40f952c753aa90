// Logistic regression's margins and residuals over a CSR design matrix.
//
// Replaces no TPU kernel.  The JAX package's logreg takes a dense x, whose
// margins are a matrix-vector product; a sparse x on the card has no
// kernel there.  One thread's rows of x (CSR: int64 row pointers rebased
// to 0, int32 column ids, fp32 values) give each row i its margin
// z_i = sum over its nonzeros of x[i, j] * theta[j] and its residual
// r_i = y_i - sigmoid(z_i), which the gradient X^T r then scatters
// (kernels/pagerank_credits, with a value an edge).
//
// margin_kernel: a warp a row, in the data's own row order.  The lanes
// stream the row's column ids and values (coalesced, evict-first: a row of
// 29 or 30 nonzeros is one 128-byte run of each), gather theta[j] (fp32,
// random over the features: the popular ones stay in L2), and multiply in
// fp64, where the product of two fp32 values is exact.  A butterfly of
// shuffles sums the lanes in fp64, the sum rounds once to fp32, and lane 0
// writes r_i = y_i - 1 / (1 + exp(-z_i)) in fp32.  The order of the adds is
// fixed by the row's layout, so every run gives the same bits.  A row
// longer than a warp takes as many sweeps as it needs.
//
// Bound: device memory.  A call streams 8 B a nonzero and reads y and
// writes r (8 B a row); the gathers of theta are random 4-byte reads, one
// DRAM sector each where L2 misses, which bound it in practice.

#include <cstdint>

#include "common.cuh"

constexpr int kThreads = 256;          // 8 warps a CTA
constexpr int kWarp = 32;
constexpr int kCtasPerSm = 8;          // 2,048 threads an SM in flight

__global__ void __launch_bounds__(kThreads)
margin_kernel(const long long* __restrict__ indptr, const int* __restrict__ indices,
              const float* __restrict__ values, const float* __restrict__ theta,
              const float* __restrict__ y, long long n_rows, float* __restrict__ r) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / kWarp);
  for (long long row = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / kWarp;
       row < n_rows; row += warps) {
    const long long begin = __ldg(indptr + row), end = __ldg(indptr + row + 1);
    double acc = 0.0;
    for (long long e = begin + lane; e < end; e += kWarp)
      acc += static_cast<double>(__ldg(theta + __ldcs(indices + e))) *
             static_cast<double>(__ldcs(values + e));
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      const float z = __double2float_rn(acc);
      r[row] = __ldg(y + row) - 1.0f / (1.0f + expf(-z));
    }
  }
}

static int sm_count() {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms;
}

// r (n_rows,) float32 of the rows' margins; no launch for n_rows == 0.
extern "C" int logreg_margin(const long long* indptr, const int* indices, const float* values,
                             const float* theta, const float* y, long long n_rows, float* r,
                             void* stream) {
  if (n_rows == 0) return 0;
  const long long per_cta = kThreads / kWarp;
  long long blocks = (n_rows + per_cta - 1) / per_cta;
  const long long cap = static_cast<long long>(kCtasPerSm) * sm_count();
  if (blocks > cap) blocks = cap;
  margin_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      indptr, indices, values, theta, y, n_rows, r);
  return static_cast<int>(cudaGetLastError());
}
