// K-means assignment: nearest center and its squared distance, per point.
//
// Replaces: src/repro/kernels/kmeans_assign/kernel.py
//   (_assign_kernel, kmeans_assign_blocked).
//
// points (N, D), centers (K, D) float32 -> assign int32 (N,), dist float32
// (N,): d2 = |p|^2 - 2 p.c + |c|^2 in fp32 — the expanded formula, as the JAX
// kernel computes it — its argmin (the first minimum wins) and its min.
//
// Design: one thread per point; the K*D centers and their K squared norms sit
// in shared memory, loaded once per CTA.  Every sum is a sequential IEEE fp32
// FMA chain — no tensor cores, so no TF32 rounding.  Sums run in another
// order than XLA's dot, so an assignment can differ only where the two best
// d2 are within float rounding of each other.
//
// Bound: device memory — N*D floats read once, 2*N words written; 2*N*K*D
// FMA flops are far below the fp32 rate.  Each thread walks its own row, so a
// warp's loads are strided by D floats; the rows stay in L1 across the K
// passes.  Staging point tiles through shared memory would coalesce them; it
// is later work.

#include <math_constants.h>

#include "common.cuh"

__global__ void kmeans_assign_kernel(const float* __restrict__ pts,
                                     const float* __restrict__ ctr,
                                     int* __restrict__ assign,
                                     float* __restrict__ dist, long long n,
                                     int d, int k) {
  extern __shared__ float smem[];
  float* sc = smem;          // k*d centers
  float* c2 = smem + k * d;  // k squared norms
  for (int e = threadIdx.x; e < k * d; e += blockDim.x) sc[e] = ctr[e];
  __syncthreads();
  for (int c = threadIdx.x; c < k; c += blockDim.x) {
    float s = 0.0f;
    for (int j = 0; j < d; ++j) s = fmaf(sc[c * d + j], sc[c * d + j], s);
    c2[c] = s;
  }
  __syncthreads();
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const float* row = pts + p * d;
  float p2 = 0.0f;
  for (int j = 0; j < d; ++j) p2 = fmaf(row[j], row[j], p2);
  int best = 0;
  float best_d2 = CUDART_INF_F;
  for (int c = 0; c < k; ++c) {
    float dot = 0.0f;
    for (int j = 0; j < d; ++j) dot = fmaf(row[j], sc[c * d + j], dot);
    const float d2 = (p2 - 2.0f * dot) + c2[c];
    if (c == 0 || d2 < best_d2) {
      best = c;
      best_d2 = d2;
    }
  }
  assign[p] = best;
  dist[p] = best_d2;
}

extern "C" int kmeans_assign_f32(const float* pts, const float* ctr, int* assign,
                                 float* dist, long long n, int d, int k,
                                 void* stream) {
  const int threads = 256;
  const size_t smem = static_cast<size_t>(k) * (d + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kmeans_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks = (n + threads - 1) / threads;
  kmeans_assign_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(pts, ctr, assign,
                                                              dist, n, d, k);
  return static_cast<int>(cudaGetLastError());
}
