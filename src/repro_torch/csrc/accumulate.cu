// Blocked N-vector accumulation: the DAddAccumulator's local combine.
//
// Replaces: src/repro/kernels/accumulate/kernel.py — _accum_kernel,
//   accumulate_blocked (and its wrapper ops.accumulate).
//
// Rows x_0..x_{N-1} of V elements, float32 or bfloat16 -> out (V,) in the
// rows' type: acc = x_0; acc = acc + x_t for t = 1..N-1 in fp32, cast once.
// For float32 rows that is, bit for bit, the left fold flats[0] + flats[1] +
// ... that the host accumulator's dense branch computes in arrival order.
//
// Design: the rows arrive either as up to kMaxRows device pointers passed by
// value in the launch parameters (a round's contributions are separate
// tensors, so no stacked copy is made) or as a base pointer and a row stride.
// Each thread owns 16 bytes of columns (4 float32 or 8 bfloat16) and folds
// rows 0..N-1 into registers in row order: no shared memory and no atomics,
// so the order of the adds is fixed.  Where every row and the output are
// 16-byte aligned the loads and stores are 16 bytes a thread; the columns past
// the last whole vector (V not a multiple of it), and misaligned rows, go
// element by element.  Grid-stride over the column groups, at most 8 blocks
// of 256 threads per SM.
//
// Bound: device memory — N*V elements read once and V written once; on an
// H100 at 3.35 TB/s that is (N+1)*V*sizeof(T) / 3.35e12 s (28.9 us for the
// pagerank round of 4 x 4,847,571 float32).  The row loop is unrolled by 4 so
// that four independent 16-byte loads are in flight before their adds.

#include <cuda_bf16.h>

#include "common.cuh"

constexpr int kMaxRows = 64;
constexpr int kThreads = 256;

struct RowPtrs {
  const void* p[kMaxRows];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

template <typename T>
__device__ __forceinline__ const T* row_ptr(const RowPtrs& rows, const char* base,
                                            long long stride_bytes, int t) {
  return base ? reinterpret_cast<const T*>(base + t * stride_bytes)
              : static_cast<const T*>(rows.p[t]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
accumulate_kernel(RowPtrs rows, const char* base, long long stride_bytes, int n,
                  long long v, T* __restrict__ out, bool vector) {
  constexpr int kVec = 16 / sizeof(T);
  const long long groups = vector ? v / kVec : 0;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;

  for (long long g = first; g < groups; g += step) {
    float acc[kVec];
    {
      alignas(16) T x[kVec];
      *reinterpret_cast<uint4*>(x) =
          reinterpret_cast<const uint4*>(row_ptr<T>(rows, base, stride_bytes, 0))[g];
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[j] = to_f(x[j]);
    }
#pragma unroll 4
    for (int t = 1; t < n; ++t) {
      alignas(16) T x[kVec];
      *reinterpret_cast<uint4*>(x) =
          reinterpret_cast<const uint4*>(row_ptr<T>(rows, base, stride_bytes, t))[g];
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[j] = __fadd_rn(acc[j], to_f(x[j]));
    }
    alignas(16) T o[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) o[j] = from_f<T>(acc[j]);
    reinterpret_cast<uint4*>(out)[g] = *reinterpret_cast<const uint4*>(o);
  }

  for (long long c = groups * kVec + first; c < v; c += step) {
    float acc = to_f(row_ptr<T>(rows, base, stride_bytes, 0)[c]);
#pragma unroll 4
    for (int t = 1; t < n; ++t)
      acc = __fadd_rn(acc, to_f(row_ptr<T>(rows, base, stride_bytes, t)[c]));
    out[c] = from_f<T>(acc);
  }
}

// SMs of a device, asked of the runtime once per device: a call's host cost
// is what decides this kernel against one torch.sum.
static int sm_count(int device) {
  static int cached[64] = {};
  const bool cache = device >= 0 && device < 64;
  int sms = cache ? cached[device] : 0;
  if (sms == 0) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (cache) cached[device] = sms;
  }
  return sms;
}

// dtype: 0 float32, 1 bfloat16.  The rows are row_ptrs[0..n) (a host array of
// device pointers, n <= kMaxRows) when base is null, else base + t*stride_bytes.
// vector: every row and out are 16-byte aligned (checked by the caller).
extern "C" int accumulate_rows(int dtype, const void* const* row_ptrs, const void* base,
                               long long stride_bytes, int n, long long v, void* out,
                               int vector, void* stream) {
  if (n < 1 || (base == nullptr && n > kMaxRows)) return static_cast<int>(cudaErrorInvalidValue);
  RowPtrs rows{};
  if (base == nullptr)
    for (int t = 0; t < n; ++t) rows.p[t] = row_ptrs[t];
  int device = 0;
  cudaGetDevice(&device);
  const int sms = sm_count(device);
  const long long per_thread = vector ? 16 / (dtype == 0 ? 4 : 2) : 1;
  const long long work = (v + per_thread - 1) / per_thread;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 8LL * sms) blocks = 8LL * sms;
  if (blocks < 1) blocks = 1;
  const auto s = static_cast<cudaStream_t>(stream);
  const char* b = static_cast<const char*>(base);
  if (dtype == 0)
    accumulate_kernel<float><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        rows, b, stride_bytes, n, v, static_cast<float*>(out), vector != 0);
  else
    accumulate_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        rows, b, stride_bytes, n, v, static_cast<__nv_bfloat16*>(out), vector != 0);
  return static_cast<int>(cudaGetLastError());
}
