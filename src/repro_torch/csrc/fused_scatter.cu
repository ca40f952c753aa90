// Fused sparsify -> scatter-add: the accumulator's SPARSE reduce in one launch.
//
// Replaces: src/repro/kernels/accumulate/fused_scatter.py
//   (_fused_scatter_kernel, fused_topk_scatter_blocked, fused_topk_scatter).
//
// x (N, V) float32 -> out (V,): for every V-block of block_eff columns, each
// row keeps its per_block largest |x| (|x| descending, then index ascending;
// lanes past V never selected; per_block >= block_eff keeps every valid
// entry), everything else in the row is zero, and the kept rows are summed as
// the left fold acc = c_0; acc = acc + c_t in fp32 — the association order of
// scatter-adding the threads' pairs in thread order, so the result is bit-exact
// with compress -> densify -> add and with the JAX package.
//
// Design: one CTA per V-block, one thread per column (blockDim = the block
// padded to a power of two, <= 1024).  Rows are walked in order t = 0..N-1:
// each thread loads its element of row t, writes its packed key (bitonic.cuh)
// to shared memory, the block sorts the keys and reads the per_block-th one as
// the row's threshold, and each thread adds its element iff its key reaches
// the threshold.  The fold lives in one fp32 register per column: no atomics,
// so the order is fixed.
//
// Bound: device memory — N*V floats read once and V written once; on an H100
// at 3.35 TB/s that is (N+1)*V*4 bytes / 3.35e12 s.  What bounds this simple
// version instead is the sort: N full bitonic sorts of <= 1024 keys per block,
// log2(L)*(log2(L)+1)/2 synchronised stages each.  A radix select of the
// threshold would cut that; it is later work.

#include "common.cuh"
#include "bitonic.cuh"

__global__ void fused_topk_scatter_kernel(const float* __restrict__ x,
                                          float* __restrict__ out, int n_rows,
                                          long long v, int block_eff,
                                          int per_block, int L) {
  extern __shared__ unsigned long long keys[];  // L keys
  const int i = threadIdx.x;
  const long long col = static_cast<long long>(blockIdx.x) * block_eff + i;
  const bool valid = i < block_eff && col < v;
  const bool select_all = per_block >= block_eff;
  float acc = 0.0f;
  for (int t = 0; t < n_rows; ++t) {
    const float xv = valid ? x[static_cast<long long>(t) * v + col] : 0.0f;
    bool sel = valid;
    if (!select_all) {
      const unsigned long long key = topk_key(xv, valid, static_cast<unsigned>(i));
      keys[i] = key;
      __syncthreads();
      bitonic_sort_desc(keys, L);
      const unsigned long long thr = keys[per_block - 1];
      __syncthreads();  // all threads hold thr before row t+1 overwrites keys
      sel = valid && key >= thr;
    }
    const float c = sel ? xv : 0.0f;
    acc = (t == 0) ? c : acc + c;
  }
  if (valid) out[col] = acc;
}

extern "C" int fused_topk_scatter_f32(const float* x, float* out, int n_rows,
                                      long long v, int block_eff, int per_block,
                                      void* stream) {
  const int L = next_pow2(block_eff);
  const long long nblocks = (v + block_eff - 1) / block_eff;
  fused_topk_scatter_kernel<<<static_cast<unsigned>(nblocks), L,
                              L * sizeof(unsigned long long),
                              static_cast<cudaStream_t>(stream)>>>(
      x, out, n_rows, v, block_eff, per_block, L);
  return static_cast<int>(cudaGetLastError());
}
