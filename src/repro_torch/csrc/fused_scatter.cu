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
// Design: one CTA per V-block of L = next_pow2(block_eff) lanes, min(L, 1024)
// threads, each owning the lanes i, i + blockDim, ...  Rows are walked in
// order t = 0..N-1: each thread loads its elements of row t (converted to
// fp32), writes their packed keys (bitonic.cuh), the block sorts the L keys
// and reads the per_block-th as the row's threshold, and each thread adds each
// of its elements iff its key reaches the threshold.  The fold keeps one fp32
// accumulator per column beside the keys; each is only ever touched by the
// thread that owns its column, so no atomics and the order is fixed.  Keys
// and accumulators take 12 L bytes: in shared memory while that fits a CTA
// (L <= 16,384), else in a device scratch buffer of nblocks * 12 L bytes that
// the wrapper allocates — the same code on a pointer (the sort's barriers
// order global memory within the block as they order shared memory).
//
// Bound: device memory — N*V elements read once and V written once; on an
// H100 at 3.35 TB/s that is (N+1)*V*sizeof(T) / 3.35e12 s.  What bounds this
// simple version instead is the sort: N full bitonic sorts of L keys per
// block, log2(L)*(log2(L)+1)/2 synchronised stages each (and above 16,384
// lanes each stage goes through L2).  A radix select of the threshold would
// cut that; it is later work.

#include "common.cuh"
#include "bitonic.cuh"
#include "dtype.cuh"

// SCRATCH: keys and accumulators in the device scratch buffer, else in
// shared memory (a template argument, so that the shared instantiation's
// loads and stores are shared-memory ones, not generic)
template <typename T, bool SCRATCH>
__global__ void fused_topk_scatter_kernel(const T* __restrict__ x, T* __restrict__ out,
                                          int n_rows, long long v, int block_eff,
                                          int per_block, int L,
                                          unsigned long long* scratch) {
  extern __shared__ unsigned long long smem[];  // L keys, then L fp32 accumulators
  unsigned long long* keys = smem;
  float* acc = reinterpret_cast<float*>(smem + L);
  if (SCRATCH) {  // keys of every block, then their accumulators
    keys = scratch + static_cast<long long>(blockIdx.x) * L;
    acc = reinterpret_cast<float*>(scratch + static_cast<long long>(gridDim.x) * L) +
          static_cast<long long>(blockIdx.x) * L;
  }
  const long long base = static_cast<long long>(blockIdx.x) * block_eff;
  const int cols = static_cast<int>(v - base < block_eff ? v - base : block_eff);
  const bool select_all = per_block >= block_eff;
  for (int t = 0; t < n_rows; ++t) {
    const T* row = x + static_cast<long long>(t) * v + base;
    unsigned long long thr = 0ull;
    if (!select_all) {
      for (int i = threadIdx.x; i < L; i += blockDim.x) {
        const bool valid = i < cols;
        keys[i] = topk_key(valid ? to_f(row[i]) : 0.0f, valid, static_cast<unsigned>(i));
      }
      __syncthreads();
      bitonic_sort_desc(keys, L);
      thr = keys[per_block - 1];
    }
    for (int i = threadIdx.x; i < cols; i += blockDim.x) {
      const float xv = to_f(row[i]);
      const bool sel = select_all || topk_key(xv, true, static_cast<unsigned>(i)) >= thr;
      const float c = sel ? xv : 0.0f;
      acc[i] = (t == 0) ? c : acc[i] + c;
    }
    if (!select_all) __syncthreads();  // all threads hold thr before row t+1 overwrites keys
  }
  for (int i = threadIdx.x; i < cols; i += blockDim.x) out[base + i] = from_f<T>(acc[i]);
}

template <typename T, bool SCRATCH>
static int launch(const void* x, void* out, int n_rows, long long v, int block_eff,
                  int per_block, void* scratch, cudaStream_t stream) {
  const int L = next_pow2(block_eff);
  const long long nblocks = (v + block_eff - 1) / block_eff;
  const size_t smem = SCRATCH ? 0 : static_cast<size_t>(L) * 12;
  cudaError_t e = allow_smem(fused_topk_scatter_kernel<T, SCRATCH>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  fused_topk_scatter_kernel<T, SCRATCH><<<static_cast<unsigned>(nblocks),
                                          L < 1024 ? L : 1024, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n_rows, v, block_eff, per_block, L,
      static_cast<unsigned long long*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int dispatch(const void* x, void* out, int n_rows, long long v, int block_eff,
                  int per_block, void* scratch, cudaStream_t stream) {
  if (scratch) return launch<T, true>(x, out, n_rows, v, block_eff, per_block, scratch, stream);
  return launch<T, false>(x, out, n_rows, v, block_eff, per_block, scratch, stream);
}

// dtype: kF32 or kBF16.  scratch: null while 12 * next_pow2(block_eff) bytes
// fit a CTA's shared memory, else nblocks * 12 * next_pow2(block_eff) bytes.
extern "C" int fused_topk_scatter(int dtype, const void* x, void* out, int n_rows,
                                  long long v, int block_eff, int per_block, void* scratch,
                                  void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch<float>(x, out, n_rows, v, block_eff, per_block, scratch, s);
  return dispatch<__nv_bfloat16>(x, out, n_rows, v, block_eff, per_block, scratch, s);
}
