// Shared by every kernel library of the port: the C entry point the Python
// wrappers use to turn a launch's cudaError_t into a message.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Smallest power of two >= n (n >= 1).
static inline int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}
