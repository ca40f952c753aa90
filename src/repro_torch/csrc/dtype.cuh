// The element types the analytics and SSD kernels take: float32 and bfloat16.
//
// The JAX package's kernels cast their input to fp32 on load, compute in fp32
// and write in the input's dtype; these helpers are that load and that store.
// The store rounds to nearest even, as torch's Tensor.to(torch.bfloat16) does.
// Each C entry point takes an int dtype code (kF32 / kBF16) and instantiates
// its kernel for the matching type.
#pragma once

#include <cuda_bf16.h>

constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Four consecutive elements as fp32, from an address aligned to four of them
// (one 16- or 8-byte load).
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

// Four fp32 values to four consecutive elements at an address aligned to
// four of them, rounded to the element type (one 16- or 8-byte store).
__device__ __forceinline__ void store4(float* p, const float (&f)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&f)[4]) {
  alignas(8) __nv_bfloat16 b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) b[j] = __float2bfloat16_rn(f[j]);
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(b);
}

// One CTA's dynamic shared memory on Hopper (227 KB): past it a kernel keeps
// its working set in a device scratch buffer the wrapper allocates.
constexpr int kMaxSharedBytes = 232448;

// Raise a kernel's dynamic shared memory limit past the 48 KB default.
template <typename K>
static inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
