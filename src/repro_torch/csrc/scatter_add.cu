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
// (O(m * out_len / block) work).  One persistent launch per call, whatever
// the number of rows, walks the phases
//     zero the fp32 sum | row 0's pairs | row 1's pairs | ... | bf16 cast
// with a grid barrier (cooperative_groups' grid.sync(), under a cooperative
// launch) between each phase and the next.  Each phase is a grid-stride loop;
// a row's pairs are added with fp32 atomics, one pair a thread per step
// (coalesced 4-byte loads: with four pairs a thread per step, as 16-byte
// loads, a row's 1.2 M pairs at pagerank's shape fell unevenly on the
// resident threads, and the barrier waits for the slowest).
// The barriers keep the order of the former launch per row: every add of row
// t lands after every add of row t-1.  Within a row the order of the atomics
// is free.  Where a row's indices are unique apart from (0, +0.0) padding —
// the contract of the accumulator's pairs — every element receives at most
// one nonzero add per row, and adding +0.0 to a sum that started at +0.0
// never changes it, so the result is bit-exact with the sequential scatter
// (rows in order, pairs in order).  With arbitrary duplicates inside one row
// the order of the atomic adds varies from run to run, and the result holds
// only to the rounding of a reordered fp32 sum.  The fp32 atomic flushes
// subnormal inputs and results to zero, as the card's own index_add_ does.
//
// The grid is sized from the work (a pair or four outputs a thread) and
// capped at the number of CTAs that can be resident at once, which a grid
// barrier needs and a cooperative launch checks; that limit is asked of the
// runtime once per process and kept, with each device's SM count.  CTAs of
// 1,024 threads, so that a barrier counts 2 arrivals an SM, not 8.
//
// Bound: device memory — the pairs read once (rows * m * (index + value
// bytes)) and out_len elements written once; 17.4 us at 3.35 TB/s for the
// pagerank unfused round (4 x 1,211,904 int32/float32 pairs into 4,847,571).
// What bounds it instead is the fp32 atomics in L2 (one per pair), and on
// small calls the launch itself.

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <atomic>
#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// One call: zero | row 0 | ... | row rows-1 | (bfloat16) cast, a grid barrier
// between phases.  acc and out are fresh allocations, 16-byte aligned: the
// zeroing and the cast go four elements a thread per step.
template <typename I, typename T, bool CAST>
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(const I* __restrict__ idx, const T* __restrict__ vals, int rows,
                    long long m, long long out_len, float* __restrict__ acc,
                    __nv_bfloat16* __restrict__ out) {
  cg::grid_group grid = cg::this_grid();
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long quads = out_len / 4;

  for (long long q = first; q < quads; q += step)
    reinterpret_cast<float4*>(acc)[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (long long i = quads * 4 + first; i < out_len; i += step) acc[i] = 0.0f;

  for (int t = 0; t < rows; ++t) {
    grid.sync();  // the previous phase's stores and adds all land first
    const I* ri = idx + t * m;
    const T* rv = vals + t * m;
    for (long long j = first; j < m; j += step) {
      const long long i = static_cast<long long>(ri[j]);
      if (i >= 0 && i < out_len) atomicAdd(acc + i, to_f(rv[j]));
    }
  }

  if (CAST) {
    grid.sync();
    for (long long q = first; q < quads; q += step) {
      const float4 a = reinterpret_cast<const float4*>(acc)[q];
      alignas(8) __nv_bfloat16 b[4] = {__float2bfloat16(a.x), __float2bfloat16(a.y),
                                       __float2bfloat16(a.z), __float2bfloat16(a.w)};
      reinterpret_cast<uint2*>(out)[q] = *reinterpret_cast<const uint2*>(b);
    }
    for (long long i = quads * 4 + first; i < out_len; i += step)
      out[i] = __float2bfloat16(acc[i]);
  }
}

// SMs of a device, asked of the runtime once per device.
static int sm_count(int device) {
  static std::atomic<int> cached[64];
  const bool cache = device >= 0 && device < 64;
  int sms = cache ? cached[device].load(std::memory_order_relaxed) : 0;
  if (sms == 0) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (cache) cached[device].store(sms, std::memory_order_relaxed);
  }
  return sms;
}

// CTAs of one instantiation that fit an SM at once, asked once per process.
template <typename I, typename T, bool CAST>
static int resident_per_sm() {
  static const int n = [] {
    int blocks = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, scatter_rows_kernel<I, T, CAST>,
                                                  kThreads, 0);
    return blocks;
  }();
  return n;
}

static bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <typename I, typename T, bool CAST>
static int launch(const void* idx, const void* vals, int rows, long long m, long long out_len,
                  float* acc, void* out, cudaStream_t s) {
  int device = 0;
  cudaGetDevice(&device);
  const long long work = m > (out_len + 3) / 4 ? m : (out_len + 3) / 4;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long resident = static_cast<long long>(resident_per_sm<I, T, CAST>()) *
                             sm_count(device);
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  const I* ip = static_cast<const I*>(idx);
  const T* vp = static_cast<const T*>(vals);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out);
  void* args[] = {&ip, &vp, &rows, &m, &out_len, &acc, &op};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(scatter_rows_kernel<I, T, CAST>),
      dim3(static_cast<unsigned>(blocks)), dim3(kThreads), args, 0, s));
}

template <typename I>
static int dispatch(int dtype, const void* idx, const void* vals, int rows, long long m,
                    long long out_len, float* acc, void* out, cudaStream_t s) {
  if (dtype == 0) return launch<I, float, false>(idx, vals, rows, m, out_len, acc, out, s);
  return launch<I, __nv_bfloat16, true>(idx, vals, rows, m, out_len, acc, out, s);
}

// index_kind: 0 int32, 1 int64; dtype: 0 float32, 1 bfloat16.  acc is the
// fp32 sum (out_len, 16-byte aligned); out receives the bfloat16 cast (null
// for float32, where acc is the output itself).  One cooperative launch;
// returns its error.
extern "C" int sparse_scatter_add_rows(int index_kind, int dtype, const void* idx,
                                       const void* vals, int rows, long long m,
                                       long long out_len, float* acc, void* out,
                                       void* stream) {
  if (!aligned(acc, 16) || (dtype != 0 && !aligned(out, 16)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const auto s = static_cast<cudaStream_t>(stream);
  if (index_kind == 0) return dispatch<int>(dtype, idx, vals, rows, m, out_len, acc, out, s);
  return dispatch<long long>(dtype, idx, vals, rows, m, out_len, acc, out, s);
}
