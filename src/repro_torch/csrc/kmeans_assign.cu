// K-means assignment: nearest center and its squared distance, per point.
//
// Replaces: src/repro/kernels/kmeans_assign/kernel.py
//   (_assign_kernel, kmeans_assign_blocked).
//
// points (N, D), centers (K, D), both float32 or both bfloat16 -> assign int32
// (N,), dist float32 (N,): every element converted to fp32 on load, then
// d2 = |p|^2 - 2 p.c + |c|^2 in fp32 — the expanded formula, as the JAX kernel
// computes it — its argmin (the first minimum wins) and its min.
//
// Design: one thread per point.  The centers are walked in tiles of as many
// whole centers, with their squared norms, as fit a CTA's shared memory, in
// center order; each thread carries its point's running (min, argmin) across
// the tiles with a strict <, so the first minimum still wins.  Where a single
// center row does not fit (D above ~58,000) the tile keeps only the norms and
// the rows are read from device memory, in the same order.  Every sum is a
// sequential IEEE fp32 FMA chain — no tensor cores, so no TF32 rounding — and
// every d2 the same chain whatever the tiling.  Sums run in another order
// than XLA's dot, so an assignment can differ only where the two best d2 are
// within float rounding of each other.
//
// Bound: device memory — N*D elements read once, 2*N words written; 2*N*K*D
// FMA flops are far below the fp32 rate.  Each thread walks its own row, so a
// warp's loads are strided by D elements; the rows stay in L1 across the K
// passes.  Staging point tiles through shared memory would coalesce them; it
// is later work.

#include <math_constants.h>

#include "common.cuh"
#include "dtype.cuh"

// ROWS: the tile's center rows sit in shared memory (else in device memory)
template <typename T, bool ROWS>
__global__ void kmeans_assign_kernel(const T* __restrict__ pts, const T* __restrict__ ctr,
                                     int* __restrict__ assign, float* __restrict__ dist,
                                     long long n, int d, int k, int tile) {
  extern __shared__ float smem[];
  float* c2 = smem;          // tile squared norms
  float* sc = smem + tile;   // tile * d centers (ROWS)
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = p < n;
  const T* row = pts + (live ? p : 0) * d;
  float p2 = 0.0f;
  if (live)
    for (int j = 0; j < d; ++j) p2 = fmaf(to_f(row[j]), to_f(row[j]), p2);
  int best = 0;
  float best_d2 = CUDART_INF_F;
  for (int c0 = 0; c0 < k; c0 += tile) {
    const int nc = min(tile, k - c0);
    const T* gc = ctr + static_cast<long long>(c0) * d;
    __syncthreads();  // every thread is done with the previous tile
    if (ROWS)
      for (int e = threadIdx.x; e < nc * d; e += blockDim.x) sc[e] = to_f(gc[e]);
    __syncthreads();
    for (int c = threadIdx.x; c < nc; c += blockDim.x) {
      float s = 0.0f;
      for (int j = 0; j < d; ++j) {
        const float cv = ROWS ? sc[c * d + j] : to_f(gc[static_cast<long long>(c) * d + j]);
        s = fmaf(cv, cv, s);
      }
      c2[c] = s;
    }
    __syncthreads();
    if (!live) continue;
    for (int c = 0; c < nc; ++c) {
      float dot = 0.0f;
      for (int j = 0; j < d; ++j) {
        const float cv = ROWS ? sc[c * d + j] : to_f(gc[static_cast<long long>(c) * d + j]);
        dot = fmaf(to_f(row[j]), cv, dot);
      }
      const float d2 = (p2 - 2.0f * dot) + c2[c];
      if (c0 + c == 0 || d2 < best_d2) {
        best = c0 + c;
        best_d2 = d2;
      }
    }
  }
  if (live) {
    assign[p] = best;
    dist[p] = best_d2;
  }
}

template <typename T, bool ROWS>
static int launch(const void* pts, const void* ctr, int* assign, float* dist, long long n,
                  int d, int k, int tile, cudaStream_t s) {
  const int threads = 256;
  const size_t smem = static_cast<size_t>(tile) * (ROWS ? d + 1 : 1) * sizeof(float);
  cudaError_t e = allow_smem(kmeans_assign_kernel<T, ROWS>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (n + threads - 1) / threads;
  kmeans_assign_kernel<T, ROWS><<<static_cast<unsigned>(blocks), threads, smem, s>>>(
      static_cast<const T*>(pts), static_cast<const T*>(ctr), assign, dist, n, d, k, tile);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int dispatch(const void* pts, const void* ctr, int* assign, float* dist, long long n,
                    int d, int k, cudaStream_t s) {
  const long long row_bytes = (static_cast<long long>(d) + 1) * sizeof(float);
  if (row_bytes <= kMaxSharedBytes) {
    const long long fit = kMaxSharedBytes / row_bytes;
    return launch<T, true>(pts, ctr, assign, dist, n, d, k,
                           static_cast<int>(k < fit ? k : fit), s);
  }
  const int fit = kMaxSharedBytes / sizeof(float);
  return launch<T, false>(pts, ctr, assign, dist, n, d, k, k < fit ? k : fit, s);
}

// dtype: kF32 or kBF16, the same for points and centers.
extern "C" int kmeans_assign(int dtype, const void* pts, const void* ctr, int* assign,
                             float* dist, long long n, int d, int k, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch<float>(pts, ctr, assign, dist, n, d, k, s);
  return dispatch<__nv_bfloat16>(pts, ctr, assign, dist, n, d, k, s);
}
