// Flash attention: online softmax over KV tiles, GQA layout read in place.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py
//   (_flash_kernel, flash_attention_bhsd) and the GQA fold of
//   src/repro/kernels/flash_attention/ops.py (flash_attention).
//
// q (B, T, KH, G, dk), k (B, S, KH, dk), v (B, S, KH, dv), all row-major,
// float32 or bfloat16 -> o (B, T, KH, G, dv) in q's type.  Query head
// (kh, g) reads KV head kh directly: the same work as the JAX wrapper's
// broadcast of K/V over G, without the copy.  The function is the TPU
// kernel's, step for step: scores q.k * (1/sqrt(dk)) in fp32; a masked
// score (key past S, or key after the query under `causal`, query position
// q_offset + t) is -1e30, not -inf; per KV tile m' = max(m, rowmax(s)),
// p = exp(s - m'), l = l*exp(m - m') + sum(p), acc = acc*exp(m - m') + p.v;
// V rows past S are zero (no 0 * garbage); o = acc / max(l, 1e-30).  m
// starts at -1e30.
//
// Design: one CTA of 256 threads (16 x 16) per (64-query tile, head).  The
// CTA walks the KV tiles of 64 keys in order; Q (fp32) stays in shared
// memory, the K and V tiles are staged there row by row, and the 64 x 64
// probability tile goes through shared memory between the two products.
// Each thread owns a 4 x 4 block of scores (rows ty*4.., keys tx + 16j) and
// a 4 x 4*ceil(dv/64) block of the output accumulator in registers (dv
// columns (tx + 16g)*4 .. +3); the row max and sum reduce over the 16 lanes
// of a row with shuffles.  Shared memory is read four floats at a time
// (float4), so one load feeds four to sixteen FMAs; the Q/K row stride is an
// odd number of 16-byte units, so the lanes reading different K rows hit
// different banks.  The next K/V tile is loaded into registers while the
// current one is computed, so its global-memory latency is hidden at one
// CTA per SM.  dk and dv must be multiples of 4.  Under `causal` the
// CTA stops at the last KV tile any of its queries can see: a tile that is
// masked for every row changes nothing (m stays, p = exp(-1e30 - m) = 0, the
// correction is 1), so stopping there is exact.  Key 0 is visible to every
// query when q_offset >= 0 (the wrapper requires it), so m leaves -1e30 on
// the first tile and the TPU kernel's p = 1 on fully masked rows never
// arises.  Every sum runs over d (or the keys) in order, in fp32 FMAs.
//
// Bound: fp32 operations.  4 * T * S_visible * d flops per head (two
// products; about half of T*S under `causal`) at 67 TFLOP/s, against
// (q + k + v + o) bytes read or written once.  This version runs on the fp32
// pipes, no tensor cores, one CTA per SM (119 KB of shared memory at d 128);
// wgmma on bf16 tiles and TMA staging are later work.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;           // query rows per CTA
constexpr int BK = 64;           // keys per KV tile
constexpr int TX = 16;           // lanes across keys / output columns
constexpr int TY = 16;           // lanes across query rows
constexpr int RQ = BQ / TY;      // query rows per thread (4)
constexpr int RK = BK / TX;      // keys per thread (4)
constexpr int THREADS = TX * TY;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// max / sum over the 16 lanes of one query row (lanes ty*16 .. ty*16+15)
__device__ __forceinline__ float row_max(float v) {
  for (int off = TX / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int off = TX / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Row stride of the Q and K tiles: a multiple of 4 floats (16-byte rows for
// float4 reads) that is an odd number of 16-byte units, so the 8 lanes of a
// quarter-warp reading 8 different K rows at one column hit 8 different
// bank groups.
__host__ __device__ inline int qk_stride(int dk) { return dk + ((dk / 4) % 2 == 0 ? 4 : 8); }

size_t smem_floats(int dk, int dv) {
  return static_cast<size_t>(BQ + BK) * qk_stride(dk) + static_cast<size_t>(BK) * (dv + 4) +
         static_cast<size_t>(BQ) * (BK + 4);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int seq_q, int seq_k,
                 int kv_heads, int group, int dk, int dv, int causal, int q_offset,
                 float scale) {
  constexpr int CG = DMAX / (4 * TX);  // float4 column groups per thread
  constexpr int WARPS = THREADS / 32;
  constexpr int LR = BK / WARPS;       // tile rows each warp loads (8)
  constexpr int LC = DMAX / 32;        // columns each lane loads per row
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int kst = qk_stride(dk);
  const int vst = dv + 4;
  const int pst = BK + 4;
  float* qs = smem;                      // BQ x kst
  float* ks = qs + BQ * kst;             // BK x kst
  float* vs = ks + BK * kst;             // BK x (dv+4)
  float* ps = vs + BK * vst;             // BQ x (BK+4), probabilities

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int heads = kv_heads * group;
  const int head = blockIdx.x % heads;   // kh * group + g
  const int b = blockIdx.x / heads;
  const int kh = head / group;
  const int q0 = blockIdx.y * BQ;

  const long long q_row = static_cast<long long>(heads) * dk;
  const long long o_row = static_cast<long long>(heads) * dv;
  const long long k_row = static_cast<long long>(kv_heads) * dk;
  const long long v_row = static_cast<long long>(kv_heads) * dv;
  const T* qb = q + static_cast<long long>(b) * seq_q * q_row + static_cast<long long>(head) * dk;
  const T* kb = k + static_cast<long long>(b) * seq_k * k_row + static_cast<long long>(kh) * dk;
  const T* vb = v + static_cast<long long>(b) * seq_k * v_row + static_cast<long long>(kh) * dv;
  T* ob = o + static_cast<long long>(b) * seq_q * o_row + static_cast<long long>(head) * dv;

  // Tiles are loaded row by row: warp w takes rows w, w + 8, ..., its lanes
  // the columns lane + 32u (coalesced, no division).  Every load of a tile
  // is issued before the first of them is stored.
  for (int r0 = 0; r0 < BQ; r0 += BK) {
    float qreg[LR][LC];
#pragma unroll
    for (int r = 0; r < LR; ++r) {
      const int t = q0 + r0 + warp + WARPS * r;
#pragma unroll
      for (int u = 0; u < LC; ++u) {
        const int c = lane + 32 * u;
        qreg[r][u] = (t < seq_q && c < dk) ? load_f(qb + t * q_row + c) : 0.0f;
      }
    }
#pragma unroll
    for (int r = 0; r < LR; ++r)
#pragma unroll
      for (int u = 0; u < LC; ++u) {
        const int c = lane + 32 * u;
        if (c < dk) qs[(r0 + warp + WARPS * r) * kst + c] = qreg[r][u];
      }
  }

  // the next K/V tile, in registers while the current one is computed;
  // V rows past S are 0 (no 0 * garbage)
  float kreg[LR][LC], vreg[LR][LC];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int r = 0; r < LR; ++r) {
      const int key = k0 + warp + WARPS * r;
#pragma unroll
      for (int u = 0; u < LC; ++u) {
        const int c = lane + 32 * u;
        kreg[r][u] = (key < seq_k && c < dk) ? load_f(kb + key * k_row + c) : 0.0f;
        vreg[r][u] = (key < seq_k && c < dv) ? load_f(vb + key * v_row + c) : 0.0f;
      }
    }
  };

  float m[RQ], l[RQ];
  float4 acc[RQ][CG];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int g = 0; g < CG; ++g) acc[i][g] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  // keys any query of this tile can see (causal: position <= the last
  // query's q_offset + t)
  int kv_end = seq_k;
  if (causal) kv_end = min(seq_k, q_offset + min(q0 + BQ, seq_q));
  const int n_tiles = (kv_end + BK - 1) / BK;

  fetch(0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // the previous tile's ks / vs / ps are consumed
#pragma unroll
    for (int r = 0; r < LR; ++r)
#pragma unroll
      for (int u = 0; u < LC; ++u) {
        const int j = warp + WARPS * r, c = lane + 32 * u;
        if (c < dk) ks[j * kst + c] = kreg[r][u];
        if (c < dv) vs[j * vst + c] = vreg[r][u];
      }
    __syncthreads();
    if (tile + 1 < n_tiles) fetch(k0 + BK);

    // scores of rows ty*4 + i against keys tx + 16j, four columns of d per step
    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.0f;
    for (int c = 0; c < dk; c += 4) {
      float4 qv[RQ], kv[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = ld4(qs + (ty * RQ + i) * kst + c);
#pragma unroll
      for (int j = 0; j < RK; ++j) kv[j] = ld4(ks + (tx + j * TX) * kst + c);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          float t = fmaf(qv[i].x, kv[j].x, s[i][j]);
          t = fmaf(qv[i].y, kv[j].y, t);
          t = fmaf(qv[i].z, kv[j].z, t);
          s[i][j] = fmaf(qv[i].w, kv[j].w, t);
        }
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = ty * RQ + i;
      const int qpos = q_offset + q0 + row;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int kpos = k0 + tx + j * TX;
        const bool valid = kpos < seq_k && (!causal || qpos >= kpos);
        s[i][j] = valid ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[row * pst + tx + j * TX] = p;
        sum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        acc[i][g].x *= corr;
        acc[i][g].y *= corr;
        acc[i][g].z *= corr;
        acc[i][g].w *= corr;
      }
    }
    __syncthreads();

    // acc += p . v over the tile's keys, four keys per step; this thread's
    // columns are (tx + 16g) * 4 .. + 3
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = ld4(ps + (ty * RQ + i) * pst + kk);
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        const int c = (tx + g * TX) * 4;
        if (c >= dv) continue;
        const float4 v0 = ld4(vs + kk * vst + c), v1 = ld4(vs + (kk + 1) * vst + c),
                     v2 = ld4(vs + (kk + 2) * vst + c), v3 = ld4(vs + (kk + 3) * vst + c);
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          float4& a = acc[i][g];
          a.x = fmaf(pv[i].w, v3.x, fmaf(pv[i].z, v2.x, fmaf(pv[i].y, v1.x, fmaf(pv[i].x, v0.x, a.x))));
          a.y = fmaf(pv[i].w, v3.y, fmaf(pv[i].z, v2.y, fmaf(pv[i].y, v1.y, fmaf(pv[i].x, v0.y, a.y))));
          a.z = fmaf(pv[i].w, v3.z, fmaf(pv[i].z, v2.z, fmaf(pv[i].y, v1.z, fmaf(pv[i].x, v0.z, a.z))));
          a.w = fmaf(pv[i].w, v3.w, fmaf(pv[i].z, v2.w, fmaf(pv[i].y, v1.w, fmaf(pv[i].x, v0.w, a.w))));
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int t = q0 + ty * RQ + i;
    if (t >= seq_q) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      const int c = (tx + g * TX) * 4;
      if (c >= dv) continue;
      T* out = ob + t * o_row + c;
      store_f(out, acc[i][g].x / denom);
      store_f(out + 1, acc[i][g].y / denom);
      store_f(out + 2, acc[i][g].z / denom);
      store_f(out + 3, acc[i][g].w / denom);
    }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int seq_q, int seq_k, int kv_heads, int group, int dk, int dv,
           int causal, int q_offset, float scale, void* stream) {
  const size_t smem = smem_floats(dk, dv) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_kernel<T, DMAX>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(batch) * kv_heads * group,
                  (seq_q + BQ - 1) / BQ);
  flash_kernel<T, DMAX><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), seq_q, seq_k, kv_heads, group, dk, dv, causal, q_offset,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int batch,
             int seq_q, int seq_k, int kv_heads, int group, int dk, int dv,
             int causal, int q_offset, float scale, void* stream) {
  const int d = dk > dv ? dk : dv;
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, batch, seq_q, seq_k, kv_heads, group, dk, dv,
                         causal, q_offset, scale, stream);
  if (d <= 128)
    return launch<T, 128>(q, k, v, o, batch, seq_q, seq_k, kv_heads, group, dk, dv,
                          causal, q_offset, scale, stream);
  return launch<T, 256>(q, k, v, o, batch, seq_q, seq_k, kv_heads, group, dk, dv,
                        causal, q_offset, scale, stream);
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* o, int batch, int seq_q, int seq_k,
                                   int kv_heads, int group, int dk, int dv,
                                   int causal, int q_offset, float scale,
                                   void* stream) {
  return dispatch<float>(q, k, v, o, batch, seq_q, seq_k, kv_heads, group, dk, dv,
                         causal, q_offset, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* o, int batch, int seq_q, int seq_k,
                                    int kv_heads, int group, int dk, int dv,
                                    int causal, int q_offset, float scale,
                                   void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, batch, seq_q, seq_k, kv_heads, group,
                                 dk, dv, causal, q_offset, scale, stream);
}
