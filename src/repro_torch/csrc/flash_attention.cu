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
// starts at -1e30.  Under `causal` a CTA stops at the last KV tile any of
// its queries can see: a tile that is masked for every row changes nothing
// (m stays, p = exp(-1e30 - m) = 0, the correction is 1), so stopping there
// is exact.  Key 0 is visible to every query when q_offset >= 0 (the
// wrapper requires it), so m leaves -1e30 on the first tile and the TPU
// kernel's p = 1 on fully masked rows never arises.  dk and dv must be
// multiples of 4, at most 256.
//
// Two bodies, chosen by dtype (never as a fallback):
//
// float32 (namespace tc): both products on the tensor cores, in 3xTF32.
//   Bound: 4 * T * S_visible * d flops per head (two products; about half
//   of T*S under `causal`).  On the fp32 pipes that is 67 TFLOP/s; here each
//   fp32 product is three TF32 products (x = big + small, big = tf32(x),
//   small = tf32(x - big); a.b = small.big + big.small + big.big, the
//   small.small term dropped, fp32 accumulate), so the tensor-core bound is
//   3x the flops at 495 TFLOP/s dense TF32.  Both lie far above the bytes
//   ((q + k + v + o) once) at 3.35 TB/s.
//   Design.  A warp owns 16 query rows; a CTA of BQ/16 warps owns BQ
//   queries of one head (128 and 8 warps up to d 128, 64 and 4 warps at
//   d 256) and walks KV tiles of BK keys (64; 32 at d 256).  Every product
//   is mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32, each fragment split as it
//   is loaded from shared memory (three MMAs per fragment: small.big,
//   big.small, big.big).  The split rounds as cvt.rna.tf32.f32 does (to
//   nearest, ties away from zero) but in two integer operations, where the
//   instruction compiles to four: the splits, redone by every warp for every
//   K and V element, are most of the kernel's non-MMA work.  Q, K and V sit
//   in shared memory row-major: Q once per CTA, K and V in a 2-stage ring
//   filled by cp.async.cg (16 bytes a thread, rows past T or S zero-filled
//   by the copy itself).  One barrier per tile: after it, the copy of tile
//   i+1 goes into tile i-1's stage and lands behind tile i's products.  The
//   sum over d (and over keys) does not care about order, so each product's
//   k index is permuted to suit the layout:
//   - S = Q.K^T: k-steps come in pairs over 16 columns of d; lane (g, t)
//     (g = lane/4, t = lane%4) reads columns 4t..4t+3 of its rows with one
//     16-byte load, the first k-step taking 4t, 4t+1 as fragment k = t,
//     t+4 and the second 4t+2, 4t+3.  Rows are padded to a stride of
//     16 (mod 32) floats, so each quarter-warp's 16-byte loads hit 32
//     distinct banks.
//   - O += P.V with P in registers: the C fragment of S holds keys 2t,
//     2t+1 of each 8-key n-tile, which become fragment k = t, t+4 of the
//     A operand, so P never goes through shared memory; V's B fragment is
//     then rows 2t and 2t+1.  Output columns are permuted in groups of
//     four n-tiles: n-tile 4p+r, n = g is column 32p + 4g + r, so one
//     16-byte load of a V row feeds four n-tiles, and a thread's
//     accumulators are columns 32p + 8t .. +7, stored as two float4.  V
//     rows are padded to a stride of 4 (mod 32) floats: conflict-free.
//   dk is padded with zeros to a multiple of 32 and dv to the
//   instantiation's width (64, 128 or 256) in shared memory (zeros change no
//   dot product; padded outputs are not stored).  The row max and sum reduce
//   over the 4 lanes of a quad.  The mask arithmetic runs only on tiles that
//   cross the diagonal or S; a warp skips the tiles its own rows cannot see,
//   and the CTAs with the most tiles are launched first (query tiles in
//   reverse order).  At d 128: 215 KB of shared memory and 8 warps per SM.
//
// bfloat16 (the anonymous namespace): the SIMT body on the fp32 pipes.  One
//   CTA of 256 threads (16 x 16) per (64-query tile, head) walks KV tiles of
//   64 keys; Q (fp32) stays in shared memory, the K and V tiles are staged
//   there row by row, and the 64 x 64 probability tile goes through shared
//   memory between the two products.  Each thread owns a 4 x 4 block of
//   scores (rows ty*4.., keys tx + 16j) and a 4 x 4*ceil(dv/64) block of the
//   output accumulator in registers (dv columns (tx + 16g)*4 .. +3); the row
//   max and sum reduce over the 16 lanes of a row with shuffles.  Shared
//   memory is read four floats at a time (float4); the Q/K row stride is an
//   odd number of 16-byte units, so the lanes reading different K rows hit
//   different banks.  The next K/V tile is loaded into registers while the
//   current one is computed.  Every sum runs over d (or the keys) in order,
//   in fp32 FMAs.  wgmma on bf16 tiles and TMA staging are later work.

#include <cuda_bf16.h>

#include <cstdint>

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

__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
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

// ---------------------------------------------------------------------------
// float32: 3xTF32 on the tensor cores (mma.sync), cp.async staging
// ---------------------------------------------------------------------------

namespace tc {

constexpr float NEG_INF = -1e30f;

// query rows per CTA (16 per warp) and keys per KV tile, per head-dim class
template <int DMAX> struct Tile { static constexpr int BQ = 128, BK = 64; };
template <> struct Tile<256> { static constexpr int BQ = 64, BK = 32; };

// Row strides in floats: Q/K rows 16 (mod 32) floats apart, V rows 4 (mod
// 32) apart (the bank-conflict-free strides of the 16-byte fragment loads;
// see the header).  Q/K columns [dk, round32(dk)) and V columns [dv, DMAX)
// are zeros.
__host__ __device__ inline int k_stride(int dk) { return (dk + 31) / 32 * 32 + 16; }
__host__ __device__ constexpr int v_stride(int dmax) { return dmax + 4; }

template <int DMAX>
size_t smem_bytes(int dk, int dv) {
  constexpr int BQ = Tile<DMAX>::BQ, BK = Tile<DMAX>::BK;
  return sizeof(float) * (static_cast<size_t>(BQ + 2 * BK) * k_stride(dk) +
                          static_cast<size_t>(2 * BK) * v_stride(DMAX));
}

// cvt.rna.tf32.f32 (round to nearest, ties away from zero, 10 mantissa
// bits) as two integer operations: add half a TF32 ulp to the magnitude and
// truncate.  The same bits as the instruction for every finite or infinite
// x (a NaN may come out as an infinity); the instruction itself compiles to
// four, with a check for Inf/NaN, and the splits are most of this kernel's
// non-MMA work.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, both TF32 (small carries the next 11 bits of x)
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment (16 x 8) as big and small halves.
struct FragA {
  uint32_t big[4], small[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2, float a3) {
    split(a0, big[0], small[0]);
    split(a1, big[1], small[1]);
    split(a2, big[2], small[2]);
    split(a3, big[3], small[3]);
  }
};

// d += a.b in 3xTF32 for the B fragment (b0, b1): the two small terms
// first, then big.big
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, float b0, float b1) {
  uint32_t b0b, b0s, b1b, b1s;
  split(b0, b0b, b0s);
  split(b1, b1b, b1s);
  mma(d, a.small, b0b, b1b);
  mma(d, a.big, b0s, b1s);
  mma(d, a.big, b0b, b1b);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int DMAX>
__global__ void __launch_bounds__(Tile<DMAX>::BQ * 2, 1)
    flash_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, int seq_q,
                      int seq_k, int kv_heads, int group, int dk, int dv, int causal,
                      int q_offset, float scale) {
  constexpr int BQ = Tile<DMAX>::BQ, BK = Tile<DMAX>::BK;
  constexpr int THREADS = BQ * 2;  // one warp per 16 query rows
  constexpr int NT = BK / 8;       // 8-key n-tiles of S
  constexpr int NG = DMAX / 32;    // groups of four 8-column n-tiles of O
  constexpr int CH = DMAX / 4;     // 16-byte chunks a row can have
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int kst = k_stride(dk);
  constexpr int vst = v_stride(DMAX);
  float* qs = smem;                // BQ x kst
  float* ks = qs + BQ * kst;       // 2 stages of BK x kst
  float* vs = ks + 2 * BK * kst;   // 2 stages of BK x vst

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int heads = kv_heads * group;
  const int head = blockIdx.x % heads;  // kh * group + g
  const int b = blockIdx.x / heads;
  const int kh = head / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the longest causal rows first
  const int qw = q0 + warp * 16;                      // this warp's first row

  const long long q_row = static_cast<long long>(heads) * dk;
  const long long o_row = static_cast<long long>(heads) * dv;
  const long long k_row = static_cast<long long>(kv_heads) * dk;
  const long long v_row = static_cast<long long>(kv_heads) * dv;
  const float* qb = q + static_cast<long long>(b) * seq_q * q_row + static_cast<long long>(head) * dk;
  const float* kb = k + static_cast<long long>(b) * seq_k * k_row + static_cast<long long>(kh) * dk;
  const float* vb = v + static_cast<long long>(b) * seq_k * v_row + static_cast<long long>(kh) * dv;
  float* ob = o + static_cast<long long>(b) * seq_q * o_row + static_cast<long long>(head) * dv;

  // rows [row0, row0 + n) of a (limit, width) matrix into dst: one 16-byte
  // cp.async a chunk; rows past `limit` are zero-filled by the copy
  auto load_rows = [&](float* dst, int dst_stride, const float* src, long long src_stride,
                       int row0, int n, int limit, int width) {
    for (int i = tid; i < n * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 4;
      if (c < width) {
        const bool ok = row0 + r < limit;
        cp_async16(dst + r * dst_stride + c, ok ? src + (row0 + r) * src_stride + c : src, ok);
      }
    }
  };

  // the zero columns of every Q, K and V row; the copies never write them
  const int kpad = (dk + 31) / 32 * 32 - dk;
  const int vpad = DMAX - dv;
  for (int i = tid; i < (BQ + 2 * BK) * kpad; i += THREADS)
    qs[(i / kpad) * kst + dk + i % kpad] = 0.0f;
  for (int i = tid; i < 2 * BK * vpad; i += THREADS)
    vs[(i / vpad) * vst + dv + i % vpad] = 0.0f;

  // keys any query of this tile can see (causal: position <= the last
  // query's q_offset + t)
  int kv_end = seq_k;
  if (causal) kv_end = min(seq_k, q_offset + min(q0 + BQ, seq_q));
  const int n_tiles = (kv_end + BK - 1) / BK;

  load_rows(qs, kst, qb, q_row, q0, BQ, seq_q, dk);
  load_rows(ks, kst, kb, k_row, 0, BK, seq_k, dk);
  load_rows(vs, vst, vb, v_row, 0, BK, seq_k, dv);
  cp_async_commit();

  // lane (g, t) holds rows g and g + 8 of the warp's 16: m, l index 0 / 1
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  float acc[NG][4][4];
#pragma unroll
  for (int p = 0; p < NG; ++p)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][r][e] = 0.0f;

  const int qpos = q_offset + qw + g;  // position of row g (row g + 8: +8)
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    const float* kt = ks + (tile & 1) * BK * kst;
    const float* vt = vs + (tile & 1) * BK * vst;
    cp_async_wait_all();  // this tile's copies (the only ones in flight) have landed
    __syncthreads();      // ... for every thread, and every warp is done with tile - 1
    if (tile + 1 < n_tiles) {  // tile + 1 into tile - 1's stage, behind this tile's products
      load_rows(ks + ((tile + 1) & 1) * BK * kst, kst, kb, k_row, k0 + BK, BK, seq_k, dk);
      load_rows(vs + ((tile + 1) & 1) * BK * vst, vst, vb, v_row, k0 + BK, BK, seq_k, dv);
      cp_async_commit();
    }

    // a warp whose rows are all past T, or (causal) all before this tile's
    // first key, has nothing to add here
    if (qw < seq_q && (!causal || k0 <= q_offset + qw + 15)) {
      // S = Q.K^T over d, two k-steps per 16 columns
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      const float* qa = qs + (warp * 16 + g) * kst + 4 * t;
      const float* kr = kt + g * kst + 4 * t;
#pragma unroll 2
      for (int c = 0; c < dk; c += 16) {
        const float4 lo = ld4(qa + c), hi = ld4(qa + 8 * kst + c);
        FragA a0, a1;
        a0.set(lo.x, hi.x, lo.y, hi.y);  // d columns c + 4t, c + 4t + 1
        a1.set(lo.z, hi.z, lo.w, hi.w);  // d columns c + 4t + 2, c + 4t + 3
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float4 kv = ld4(kr + j * 8 * kst + c);
          mma3(s[j], a0, kv.x, kv.y);
          mma3(s[j], a1, kv.z, kv.w);
        }
      }

      // scale, mask (only on a tile that crosses the diagonal or S), online
      // softmax; s[j][e] is row g + 8*(e/2), key k0 + 8j + 2t + e%2
      float mx[2] = {NEG_INF, NEG_INF};
      const bool edge = k0 + BK > seq_k || (causal && k0 + BK - 1 > q_offset + qw);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale;
          if (edge) {
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            if (key >= seq_k || (causal && key > qpos + 8 * (e >> 1))) x = NEG_INF;
          }
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], quad_max(mx[i]));
        corr[i] = expf(m[i] - m_new);
        m[i] = m_new;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - m[e >> 1]);
          sum[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + quad_sum(sum[i]);
#pragma unroll
      for (int p = 0; p < NG; ++p)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[p][r][0] *= corr[0];
          acc[p][r][1] *= corr[0];
          acc[p][r][2] *= corr[1];
          acc[p][r][3] *= corr[1];
        }

      // O += P.V, one k-step per n-tile of S: keys 8j + 2t, 8j + 2t + 1 are
      // fragment k = t, t + 4, so P's C fragment is the A fragment
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        FragA pa;
        pa.set(s[j][0], s[j][2], s[j][1], s[j][3]);
        const float* v0 = vt + (8 * j + 2 * t) * vst + 4 * g;
#pragma unroll
        for (int p = 0; p < NG; ++p) {
          const float4 x0 = ld4(v0 + 32 * p), x1 = ld4(v0 + vst + 32 * p);
          mma3(acc[p][0], pa, x0.x, x1.x);
          mma3(acc[p][1], pa, x0.y, x1.y);
          mma3(acc[p][2], pa, x0.z, x1.z);
          mma3(acc[p][3], pa, x0.w, x1.w);
        }
      }
    }
  }

  // acc[p][r][e]: row g + 8*(e/2), column 32p + 8t + 4*(e%2) + r
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qw + g + 8 * i;
    if (row >= seq_q) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* out = ob + row * o_row + 8 * t;
#pragma unroll
    for (int p = 0; p < NG; ++p)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 32 * p + 4 * h;
        if (c + 8 * t >= dv) continue;
        const int e = 2 * i + h;
        *reinterpret_cast<float4*>(out + c) =
            make_float4(acc[p][0][e] / denom, acc[p][1][e] / denom, acc[p][2][e] / denom,
                        acc[p][3][e] / denom);
      }
  }
}

template <int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int seq_q,
           int seq_k, int kv_heads, int group, int dk, int dv, int causal, int q_offset,
           float scale, void* stream) {
  const size_t smem = smem_bytes<DMAX>(dk, dv);
  cudaError_t e = cudaFuncSetAttribute(flash_tf32_kernel<DMAX>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int BQ = Tile<DMAX>::BQ;
  const dim3 grid(static_cast<unsigned>(batch) * kv_heads * group, (seq_q + BQ - 1) / BQ);
  flash_tf32_kernel<DMAX><<<grid, BQ * 2, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), seq_q, seq_k, kv_heads, group,
      dk, dv, causal, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* o, int batch, int seq_q,
             int seq_k, int kv_heads, int group, int dk, int dv, int causal, int q_offset,
             float scale, void* stream) {
  const int d = dk > dv ? dk : dv;
  if (d <= 64)
    return launch<64>(q, k, v, o, batch, seq_q, seq_k, kv_heads, group, dk, dv, causal,
                      q_offset, scale, stream);
  if (d <= 128)
    return launch<128>(q, k, v, o, batch, seq_q, seq_k, kv_heads, group, dk, dv, causal,
                       q_offset, scale, stream);
  return launch<256>(q, k, v, o, batch, seq_q, seq_k, kv_heads, group, dk, dv, causal,
                     q_offset, scale, stream);
}

}  // namespace tc

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* o, int batch, int seq_q, int seq_k,
                                   int kv_heads, int group, int dk, int dv,
                                   int causal, int q_offset, float scale,
                                   void* stream) {
  return tc::dispatch(q, k, v, o, batch, seq_q, seq_k, kv_heads, group, dk, dv, causal,
                      q_offset, scale, stream);
}

// Shared memory of one CTA of the body that takes (dk, dv): the float32
// (f32 != 0) or the bfloat16 one.  The wrapper's smem_bytes reads it here,
// so the layout is written once.
extern "C" int flash_attention_smem_bytes(int dk, int dv, int f32) {
  if (!f32) return static_cast<int>(smem_floats(dk, dv) * sizeof(float));
  const int d = dk > dv ? dk : dv;
  return static_cast<int>(d <= 64    ? tc::smem_bytes<64>(dk, dv)
                          : d <= 128 ? tc::smem_bytes<128>(dk, dv)
                                     : tc::smem_bytes<256>(dk, dv));
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* o, int batch, int seq_q, int seq_k,
                                    int kv_heads, int group, int dk, int dv,
                                    int causal, int q_offset, float scale,
                                   void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, batch, seq_q, seq_k, kv_heads, group,
                                 dk, dv, causal, q_offset, scale, stream);
}
