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
