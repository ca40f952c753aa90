// Mamba2 SSD scan: chunks in order, the (N, P) state resident in shared memory.
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py (_ssd_kernel, ssd_scan_bh)
//   and the layout of src/repro/kernels/ssd_scan/ops.py (ssd).
//
// xbar (b, T, H, P), B and C (b, T, G, N), float32 or bfloat16 (one dtype),
// a (b, T, H) float32, all row-major -> y (b, T, H, P) in xbar's dtype; every
// element is converted to fp32 on load and the state stays fp32.  Head h
// reads B/C of group h / (H / G) directly, where the JAX wrapper repeats them
// over the heads of a group.
// Per (batch, head), chunks of Q tokens in order, with cum = the running sum
// of a within the chunk (<= 0) and S the fp32 state, zero at the start:
//   y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) xbar_j + exp(cum_i) C_i S
//   S  <- S exp(cum_{Q-1}) + sum_j B_j^T exp(cum_{Q-1} - cum_j) xbar_j
// The mask j <= i is applied before the exp, as the TPU kernel does (the
// upper triangle has cum_i - cum_j > 0 and would overflow).
//
// Design: one CTA of 256 threads (8 warps) per (batch, head) walks the T / Q
// chunks.  Where a chunk's working set (smem_floats) exceeds a CTA's 227 KB,
// the wrapper passes as Q the largest divisor of the chunk that fits: the
// chunk then runs as consecutive sub-chunks with the state carried between
// them, the same recurrence.  A chunk's xbar, B (transposed) and C and the state stay in shared
// memory (at Q 128, N 128, P 64: 32 + 64 + 64 + 32 KB of fp32), which
// leaves no room for the Q x Q score matrix: the decay-weighted scores are
// made one strip of 32 rows at a time (16 KB), each strip followed by its
// rows of y; all strips read the state before the update at the chunk's
// end.  Each product is register-tiled: a thread owns 4 rows x 4 keys of a
// score strip, 4 rows x 2 columns of y, and 16 rows x 2 columns of the state,
// so one shared-memory load feeds two to four FMAs; groups of 32 keys that
// lie wholly after a strip's last row are skipped.  The rows a warp shares
// are broadcasts; its 32 lanes run along the contiguous dimension (keys for
// the scores, P for y and the state), and B^T's rows are padded by one float
// so the transposing stores spread over the banks.  Every sum is a
// sequential fp32 FMA chain; no tensor cores.
//
// Bound: fp32 operations, Q (Q + 1) (N + P) + 4 Q N P flops per chunk per
// head (the scores and their product with xbar over the Q (Q + 1) / 2 causal
// pairs, the carried-state term and the state update) at 67 TFLOP/s,
// against the inputs read and y written once.  One CTA per head leaves 320 CTAs at the
// mamba2-2.7b prefill shape for 132 SMs, one CTA per SM (215 KB of shared
// memory): parallelising over chunks (a separate state pass) or wgmma on the
// chunk products is later work.

#include "common.cuh"
#include "dtype.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int STRIP = 32;          // score rows per strip: 8 warps x 4
constexpr int RT = STRIP / WARPS;  // rows per thread (4)
constexpr int KT = 4;              // keys per thread per 128-key block
constexpr int PT = 2;              // columns of P per thread per 64-column block
constexpr int NT = 16;             // state rows per thread per 128-row block

size_t smem_floats(int Q, int P, int N) {
  return static_cast<size_t>(Q) * P + static_cast<size_t>(N) * (Q + 1) +
         static_cast<size_t>(Q) * N + static_cast<size_t>(N) * P +
         static_cast<size_t>(STRIP) * Q + 3 * static_cast<size_t>(Q);
}

// acc[r][k] += C_{rows[r]} . B_{keys[k]} for the first KA of a thread's KT
// keys (the others are masked for every row of the strip)
template <int KA>
__device__ __forceinline__ void score_dots(const float* cs, const float* bt, const int* rows,
                                           const int* keys, int N, int bst,
                                           float (&acc)[RT][KT]) {
  for (int n = 0; n < N; ++n) {
    float cv[RT], bv[KA];
#pragma unroll
    for (int r = 0; r < RT; ++r) cv[r] = cs[rows[r] * N + n];
#pragma unroll
    for (int k = 0; k < KA; ++k) bv[k] = bt[n * bst + keys[k]];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int k = 0; k < KA; ++k) acc[r][k] = fmaf(cv[r], bv[k], acc[r][k]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    ssd_kernel(const T* __restrict__ x, const float* __restrict__ a,
               const T* __restrict__ bm, const T* __restrict__ cm,
               T* __restrict__ y, int seq, int heads, int groups, int P,
               int N, int Q) {
  extern __shared__ float smem[];
  const int bst = Q + 1;                 // padded row stride of B^T
  float* xs = smem;                      // Q x P
  float* bt = xs + Q * P;                // N x (Q+1), B transposed
  float* cs = bt + N * bst;              // Q x N
  float* st = cs + Q * N;                // N x P, the carried state
  float* sc = st + N * P;                // STRIP x Q decay-weighted scores
  float* cum = sc + STRIP * Q;           // Q: running sum of a
  float* ecum = cum + Q;                 // Q: exp(cum_i)
  float* sdec = ecum + Q;                // Q: exp(cum_{Q-1} - cum_j)

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int g = h / (heads / groups);
  const long long x_row = static_cast<long long>(heads) * P;
  const long long bc_row = static_cast<long long>(groups) * N;
  const T* xb = x + static_cast<long long>(b) * seq * x_row + static_cast<long long>(h) * P;
  const float* ab = a + static_cast<long long>(b) * seq * heads + h;
  const T* bb = bm + static_cast<long long>(b) * seq * bc_row + static_cast<long long>(g) * N;
  const T* cb = cm + static_cast<long long>(b) * seq * bc_row + static_cast<long long>(g) * N;
  T* yb = y + static_cast<long long>(b) * seq * x_row + static_cast<long long>(h) * P;

  for (int e = tid; e < N * P; e += THREADS) st[e] = 0.0f;

  for (int t0 = 0; t0 < seq; t0 += Q) {
    // the previous chunk's state update has read xs / bt / sdec
    __syncthreads();
    for (int e = tid; e < Q * P; e += THREADS) {
      const int j = e / P, p = e % P;
      xs[e] = to_f(xb[(t0 + j) * x_row + p]);
    }
    for (int e = tid; e < Q * N; e += THREADS) {
      const int j = e / N, n = e % N;
      bt[n * bst + j] = to_f(bb[(t0 + j) * bc_row + n]);
      cs[e] = to_f(cb[(t0 + j) * bc_row + n]);
    }
    for (int j = tid; j < Q; j += THREADS) cum[j] = ab[static_cast<long long>(t0 + j) * heads];
    __syncthreads();
    if (tid == 0) {
      for (int j = 1; j < Q; ++j) cum[j] += cum[j - 1];
    }
    __syncthreads();
    for (int j = tid; j < Q; j += THREADS) {
      ecum[j] = expf(cum[j]);
      sdec[j] = expf(cum[Q - 1] - cum[j]);
    }

    // y, one strip of rows at a time; this thread's rows are i0 + r0 + (0..3)
    const int r0 = warp * RT;
    for (int i0 = 0; i0 < Q; i0 += STRIP) {
      int rows[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) rows[r] = min(i0 + r0 + r, Q - 1);
      // scores of keys kb + lane + 32k, up to the strip's last row (y reads
      // no further)
      for (int kb = 0; kb < Q && kb < i0 + STRIP; kb += 32 * KT) {
        float acc[RT][KT];
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int k = 0; k < KT; ++k) acc[r][k] = 0.0f;
        int keys[KT];
#pragma unroll
        for (int k = 0; k < KT; ++k) keys[k] = min(kb + lane + 32 * k, Q - 1);
        // 32-key groups that hold a key at or before the strip's last row
        switch (min(KT, (i0 + STRIP - kb + 31) / 32)) {
          case 1: score_dots<1>(cs, bt, rows, keys, N, bst, acc); break;
          case 2: score_dots<2>(cs, bt, rows, keys, N, bst, acc); break;
          case 3: score_dots<3>(cs, bt, rows, keys, N, bst, acc); break;
          default: score_dots<KT>(cs, bt, rows, keys, N, bst, acc);
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const int i = i0 + r0 + r;
#pragma unroll
          for (int k = 0; k < KT; ++k) {
            const int j = kb + lane + 32 * k;
            if (j < Q)
              sc[(r0 + r) * Q + j] =
                  (i < Q && j <= i) ? acc[r][k] * expf(cum[i] - cum[j]) : 0.0f;
          }
        }
      }
      __syncthreads();

      // y of columns pb + lane + 32c
      const int last = min(i0 + r0 + RT - 1, Q - 1);
      for (int pb = 0; pb < P; pb += 32 * PT) {
        float diag[RT][PT], off[RT][PT];
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int c = 0; c < PT; ++c) diag[r][c] = off[r][c] = 0.0f;
        int cols[PT];
#pragma unroll
        for (int c = 0; c < PT; ++c) cols[c] = min(pb + lane + 32 * c, P - 1);
        // scores past a row's diagonal are 0: summing them adds nothing
        for (int j = 0; j <= last; ++j) {
          float gv[RT], xv[PT];
#pragma unroll
          for (int r = 0; r < RT; ++r) gv[r] = sc[(r0 + r) * Q + j];
#pragma unroll
          for (int c = 0; c < PT; ++c) xv[c] = xs[j * P + cols[c]];
#pragma unroll
          for (int r = 0; r < RT; ++r)
#pragma unroll
            for (int c = 0; c < PT; ++c) diag[r][c] = fmaf(gv[r], xv[c], diag[r][c]);
        }
        for (int n = 0; n < N; ++n) {
          float cv[RT], sv[PT];
#pragma unroll
          for (int r = 0; r < RT; ++r) cv[r] = cs[rows[r] * N + n];
#pragma unroll
          for (int c = 0; c < PT; ++c) sv[c] = st[n * P + cols[c]];
#pragma unroll
          for (int r = 0; r < RT; ++r)
#pragma unroll
            for (int c = 0; c < PT; ++c) off[r][c] = fmaf(cv[r], sv[c], off[r][c]);
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const int i = i0 + r0 + r;
#pragma unroll
          for (int c = 0; c < PT; ++c) {
            const int p = pb + lane + 32 * c;
            if (i < Q && p < P)
              yb[(t0 + i) * x_row + p] = from_f<T>(diag[r][c] + ecum[i] * off[r][c]);
          }
        }
      }
      __syncthreads();  // sc is rewritten by the next strip
    }

    // S <- S exp(sum a) + sum_j B_j^T (sdec_j xbar_j); rows nb + warp*16 + r
    const float total = expf(cum[Q - 1]);
    for (int nb = 0; nb < N; nb += WARPS * NT) {
      for (int pb = 0; pb < P; pb += 32 * PT) {
        float acc[NT][PT];
#pragma unroll
        for (int r = 0; r < NT; ++r)
#pragma unroll
          for (int c = 0; c < PT; ++c) acc[r][c] = 0.0f;
        int cols[PT];
#pragma unroll
        for (int c = 0; c < PT; ++c) cols[c] = min(pb + lane + 32 * c, P - 1);
        const int n0 = nb + warp * NT;
        for (int j = 0; j < Q; ++j) {
          float xv[PT];
#pragma unroll
          for (int c = 0; c < PT; ++c) xv[c] = sdec[j] * xs[j * P + cols[c]];
#pragma unroll
          for (int r = 0; r < NT; ++r) {
            const float bv = bt[min(n0 + r, N - 1) * bst + j];
#pragma unroll
            for (int c = 0; c < PT; ++c) acc[r][c] = fmaf(bv, xv[c], acc[r][c]);
          }
        }
#pragma unroll
        for (int r = 0; r < NT; ++r) {
          const int n = n0 + r;
#pragma unroll
          for (int c = 0; c < PT; ++c) {
            const int p = pb + lane + 32 * c;
            if (n < N && p < P) st[n * P + p] = st[n * P + p] * total + acc[r][c];
          }
        }
      }
    }
  }
}

}  // namespace

template <typename T>
static int launch(const void* x, const float* a, const void* bm, const void* cm, void* y,
                  int batch, int seq, int heads, int groups, int P, int N, int Q,
                  cudaStream_t s) {
  const size_t smem = smem_floats(Q, P, N) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(ssd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_kernel<T><<<static_cast<unsigned>(batch) * heads, THREADS, smem, s>>>(
      static_cast<const T*>(x), a, static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<T*>(y), seq, heads, groups, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

// dtype: kF32 or kBF16, of xbar, B, C and y (a is float32).  Q: the chunk, or
// the sub-chunk the wrapper picked so that smem_floats(Q, P, N) fits.
extern "C" int ssd_scan(int dtype, const void* x, const float* a, const void* bm,
                        const void* cm, void* y, int batch, int seq, int heads, int groups,
                        int P, int N, int Q, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch<float>(x, a, bm, cm, y, batch, seq, heads, groups, P, N, Q, s);
  return launch<__nv_bfloat16>(x, a, bm, cm, y, batch, seq, heads, groups, P, N, Q, s);
}
