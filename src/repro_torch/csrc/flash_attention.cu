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
// bfloat16 (namespace wg): both products on the tensor cores with wgmma.
//   Bound: the same 4 * T * S_visible * d flops per head, at 989 TFLOP/s of
//   dense bf16 (68.7 GFLOP and 0.0695 ms at qwen3-1.7b's prefill shape, q
//   (4, 2048, 8, 2, 128), causal); the bytes lie far below.  On Hopper only
//   wgmma reaches that rate.
//   Design.  A CTA of two warpgroups (256 threads) owns BQ = 128 queries of
//   one head, 64 per warpgroup, and walks KV tiles of BK keys (128; 64 at d
//   256).  Q (once per CTA) and K, V (a 2-stage ring) sit in shared memory
//   in bf16, in the 128-byte-swizzled layout that wgmma's descriptors read
//   (layout type B128): 64-column slabs of rows x 128 bytes, one after
//   another, the 16-byte chunk c of row r stored at chunk c ^ (r % 8).
//   cp.async fills them, 16 bytes a copy (8, with .ca, where dk or dv % 8 ==
//   4); rows past T or S and the padding columns are zero-filled by the copy
//   itself.  One barrier per tile: after it, the copy of tile i+1 goes into
//   tile i-1's stage and lands behind tile i's products.  dk is padded with
//   zeros to a multiple of 16 (the k-steps run over round16(dk)), dv to the
//   instantiation's width (64, 128 or 256); padded outputs are not stored.
//   - S = Q.K^T: wgmma m64n{BK}k16, both operands from shared memory and
//     K-major (as stored); one k-step per 16 columns of dk, the descriptor's
//     start moved 32 bytes along a slab's rows, then on to the next slab.
//   - Online softmax on S's accumulator layout: thread (warp w of the
//     warpgroup, g = lane/4, t = lane%4) holds rows 16w + g and 16w + g + 8
//     at keys 8j + 2t, 8j + 2t + 1 of each 8-key block j (mma.sync's C
//     layout); the row max and sum reduce over the 4 lanes of a quad.  The
//     scores are scaled by log2(e)/sqrt(dk) and exponentiated by exp2: the
//     same p = exp(s - m).  l sums the fp32 p, before P is rounded.
//   - O += P.V with P from registers: k16 slice s of P (keys 16s..16s+15) is
//     blocks 2s and 2s+1 of S's accumulator, packed in bf16 pairs
//     (cvt.rn.bf16x2.f32), which is wgmma's A-fragment layout, so P never
//     touches shared memory.  V is the B operand, MN-major (dv contiguous,
//     as stored), with the transpose bit set: m64n64k16 at d 64, else
//     m64n128k16 per 128 columns of dv.
//   Precision: products of bf16 operands are exact in fp32 and every sum is
//   fp32; the one rounding the fp32 reference has not is P to bf16 (2^-9
//   relative per p).  At d 128: 161 KB of shared memory, one CTA of 8 warps
//   per SM.  Query tiles launch in reverse order (the longest causal rows
//   first), a warpgroup skips the KV tiles that none of its rows can see,
//   and the mask arithmetic runs only on tiles that cross the diagonal or S.
//   What holds it back (scripts/torch_flash_bf16_phases.py times each phase
//   on the card): a tile's phases run in series, both warpgroups in step --
//   issuing the next tile's copies, S, the softmax (bound by the exp2 rate
//   of the special-function units), O -- so the tensor cores sit idle for
//   most of a tile.  TMA with a producer warp, ping-pong between the
//   warpgroups and the softmax of tile i under tile i+1's S are later work.

#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

// ---------------------------------------------------------------------------
// bfloat16: wgmma on the tensor cores, swizzled cp.async staging
// ---------------------------------------------------------------------------

namespace wg {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BQ = 128;       // query rows per CTA, 64 per warpgroup
constexpr int THREADS = 256;  // two warpgroups

// keys per KV tile, per head-dim class
template <int DMAX> struct Tile { static constexpr int BK = 128; };
template <> struct Tile<256> { static constexpr int BK = 64; };

// Q and two stages of K and of V, DMAX bf16 columns each, plus the slack
// that aligns the tiles to the 1024 bytes of a swizzle atom.
template <int DMAX>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(BQ + 4 * Tile<DMAX>::BK) * DMAX * sizeof(bf16) + 1024;
}

// Byte offset of element (r, c) in a swizzled tile of `rows` rows: slab c /
// 64 (rows x 128 bytes), row r, its 16-byte chunk (c % 64) / 8 at chunk
// ((c % 64) / 8) ^ (r % 8).
__device__ __forceinline__ uint32_t swz(int r, int c, int rows) {
  return (c >> 6) * rows * 128 + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2;
}

template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool valid) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 8 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// this thread's shared-memory writes, made visible to wgmma's (async proxy) reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [row0, row0 + ROWS) of a bf16 matrix (`limit` rows, `width`
// columns, row stride `stride`) into the swizzled tile at `dst`, columns [0,
// pw): VEC elements a cp.async.  A thread keeps one piece of the row and
// steps down the rows THREADS / (DMAX / VEC) at a time; rows past `limit`
// and columns past `width` are zero-filled by the copy.
template <int DMAX, int VEC, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, long long stride,
                                          int row0, int limit, int width, int pw) {
  constexpr int CH = DMAX / VEC;      // pieces of a row
  constexpr int STEP = THREADS / CH;  // rows a pass
  static_assert(THREADS % CH == 0 && ROWS % STEP == 0, "whole passes over the tile");
  const int c = (threadIdx.x % CH) * VEC;
  if (c >= pw) return;
  const int r0 = threadIdx.x / CH;
  const bool col_ok = c < width;
  const bf16* from = src + (row0 + r0) * stride + c;
#pragma unroll
  for (int i = 0; i < ROWS / STEP; ++i) {
    const int r = r0 + i * STEP;
    const bool ok = col_ok && row0 + r < limit;
    cp_async<VEC * 2>(dst + swz(r, c, ROWS), ok ? from : src, ok);
    from += STEP * stride;
  }
}

// A wgmma shared-memory descriptor with 128-byte swizzle: start address,
// leading and stride byte offsets (each in 16-byte units), layout type 1.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator registers across the wgmmas
// that are in flight on them
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define WG_D8(i)                                                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_R32                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_R64                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "  \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "  \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (+)= A.B^T, A (64 x 16) and B (N x 16) both K-major in shared memory;
// scale_d == 0 overwrites d
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                                         int scale_d) {
  static_assert(N == 64 || N == 128, "S tiles are 64 or 128 keys wide");
  if constexpr (N == 64)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
        : "l"(a), "l"(b), "r"(scale_d));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_R64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40), WG_D8(48),
          WG_D8(56)
        : "l"(a), "l"(b), "r"(scale_d));
}

// d += A.B, A (64 x 16) from registers (the A-fragment layout), B (16 x N)
// MN-major in shared memory (the transpose bit set)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t b) {
  static_assert(N == 64 || N == 128, "O is done 64 or 128 columns at a time");
  if constexpr (N == 64)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_R64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40), WG_D8(48),
          WG_D8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef WG_D8
#undef WG_R32
#undef WG_R64

// S = Q.K^T over NK k-steps of 16 columns: the descriptors' start moves 32
// bytes along a slab's 128-byte rows, then on to the next slab.  Each NK is
// one straight run of wgmmas from fence to wait, so no register copy lands
// between them (ptxas would serialise the wgmmas); qk_steps picks the run
// for the k-steps round16(dk) / 16.
template <int BK, int NK>
__device__ __forceinline__ void qk(float (&s)[BK / 2], uint64_t q_desc, uint64_t k_desc,
                                   uint32_t q_slab, uint32_t k_slab) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const uint32_t step = (kk & 3) * 32;
    wgmma_ss<BK>(s, q_desc + (((kk >> 2) * q_slab + step) >> 4),
                 k_desc + (((kk >> 2) * k_slab + step) >> 4), kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
}
template <int BK, int NK, int MAXK>
__device__ __forceinline__ void qk_steps(int nk, float (&s)[BK / 2], uint64_t q_desc,
                                         uint64_t k_desc, uint32_t q_slab, uint32_t k_slab) {
  if constexpr (NK < MAXK) {
    if (nk > NK) return qk_steps<BK, NK + 1, MAXK>(nk, s, q_desc, k_desc, q_slab, k_slab);
  }
  qk<BK, NK>(s, q_desc, k_desc, q_slab, k_slab);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // cvt.rn.bf16x2.f32
  return *reinterpret_cast<const uint32_t*>(&h);
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
__global__ void __launch_bounds__(THREADS, 1)
    flash_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o, int seq_q, int seq_k,
                       int kv_heads, int group, int dk, int dv, int causal, int q_offset,
                       float scale) {
  constexpr int BK = Tile<DMAX>::BK;
  constexpr int NT = BK / 8;                     // 8-key blocks of S
  constexpr int NP = BK / 16;                    // k16 slices of P
  constexpr int ON = DMAX == 64 ? 64 : 128;      // columns of O per wgmma
  constexpr int NH = DMAX / ON;                  // wgmmas per k-step of O
  constexpr uint32_t Q_BYTES = BQ * DMAX * sizeof(bf16);
  constexpr uint32_t KV_BYTES = BK * DMAX * sizeof(bf16);
  constexpr uint32_t Q_SLAB = BQ * 128, KV_SLAB = BK * 128;  // bytes of one 64-column slab
  extern __shared__ uint8_t smem[];
  const uint32_t qs = (static_cast<uint32_t>(__cvta_generic_to_shared(smem)) + 1023) & ~1023u;
  const uint32_t ks = qs + Q_BYTES;       // 2 stages of KV_BYTES
  const uint32_t vs = ks + 2 * KV_BYTES;  // 2 stages of KV_BYTES

  const int tid = threadIdx.x;
  const int wg = tid >> 7;           // warpgroup: rows 64 wg .. 64 wg + 63 of the tile
  const int warp = (tid >> 5) & 3;   // warp of the warpgroup: 16 of its rows
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int heads = kv_heads * group;
  const int head = blockIdx.x % heads;  // kh * group + g
  const int b = blockIdx.x / heads;
  const int kh = head / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the longest causal rows first
  const int qg = q0 + 64 * wg;                        // this warpgroup's first row
  const int qw = qg + 16 * warp;                      // this warp's first row

  const long long q_row = static_cast<long long>(heads) * dk;
  const long long o_row = static_cast<long long>(heads) * dv;
  const long long k_row = static_cast<long long>(kv_heads) * dk;
  const long long v_row = static_cast<long long>(kv_heads) * dv;
  const bf16* qb = q + static_cast<long long>(b) * seq_q * q_row + static_cast<long long>(head) * dk;
  const bf16* kb = k + static_cast<long long>(b) * seq_k * k_row + static_cast<long long>(kh) * dk;
  const bf16* vb = v + static_cast<long long>(b) * seq_k * v_row + static_cast<long long>(kh) * dv;
  bf16* ob = o + static_cast<long long>(b) * seq_q * o_row + static_cast<long long>(head) * dv;

  const int pk = (dk + 15) & ~15;  // dk padded to the k-steps
  auto load_q = [&]() {
    if (dk % 8 == 0)
      load_tile<DMAX, 8, BQ>(qs, qb, q_row, q0, seq_q, dk, pk);
    else
      load_tile<DMAX, 4, BQ>(qs, qb, q_row, q0, seq_q, dk, pk);
  };
  auto load_kv = [&](uint32_t stage, int row0) {
    if (dk % 8 == 0)
      load_tile<DMAX, 8, BK>(ks + stage, kb, k_row, row0, seq_k, dk, pk);
    else
      load_tile<DMAX, 4, BK>(ks + stage, kb, k_row, row0, seq_k, dk, pk);
    if (dv % 8 == 0)
      load_tile<DMAX, 8, BK>(vs + stage, vb, v_row, row0, seq_k, dv, DMAX);
    else
      load_tile<DMAX, 4, BK>(vs + stage, vb, v_row, row0, seq_k, dv, DMAX);
  };

  // keys any query of this tile can see (causal: position <= the last
  // query's q_offset + t)
  int kv_end = seq_k;
  if (causal) kv_end = min(seq_k, q_offset + min(q0 + BQ, seq_q));
  const int n_tiles = (kv_end + BK - 1) / BK;

  load_q();
  load_kv(0, 0);
  cp_async_commit();

  // Descriptors of stage 0 (rows 128 bytes apart, 8-row atoms 1024 bytes
  // apart); a k-step, a slab and a stage move only the start address.  Q and
  // K are K-major (the leading offset unused under the swizzle); V is
  // MN-major: its leading offset steps from one 64-column slab to the next.
  const uint64_t q_desc = make_desc(qs + 64 * wg * 128, 16, 1024);
  const uint64_t k_desc = make_desc(ks, 16, 1024);
  const uint64_t v_desc = make_desc(vs, KV_SLAB, 1024);

  // s[4j + e]: row g + 8(e/2) of the warp's 16, key k0 + 8j + 2t + e%2;
  // acc[h][4j + e]: the same row, column ON h + 8j + 2t + e%2
  float s[BK / 2], acc[NH][ON / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.0f;
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < ON / 2; ++i) acc[h][i] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  const float scale2 = scale * LOG2E;
  const int qpos = q_offset + qw + g;  // position of row g (row g + 8: +8)

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    const uint32_t stage = (tile & 1) * KV_BYTES;
    cp_async_wait_all();   // this tile's copies (the only ones in flight) have landed
    fence_async_shared();  // ... visible to wgmma
    __syncthreads();       // ... for every thread, and both warpgroups are done with tile - 1
    if (tile + 1 < n_tiles) {  // tile + 1 into tile - 1's stage, behind this tile's products
      load_kv(((tile + 1) & 1) * KV_BYTES, k0 + BK);
      cp_async_commit();
    }
    // a warpgroup whose rows are all past T, or (causal) all before this
    // tile's first key, has nothing to add here
    if (qg >= seq_q || (causal && k0 > q_offset + qg + 63)) continue;

    // S = Q.K^T, one k-step per 16 columns of dk
    pin(s);
    qk_steps<BK, 1, DMAX / 16>(pk / 16, s, q_desc, k_desc + (stage >> 4), Q_SLAB, KV_SLAB);
    pin(s);

    // mask (only on a tile that crosses the diagonal or S): a masked score
    // is -1e30
    if (k0 + BK > seq_k || (causal && k0 + BK - 1 > q_offset + qw)) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          if (key >= seq_k || (causal && key > qpos + 8 * (e >> 1))) s[4 * j + e] = NEG_INF;
        }
    }
    // online softmax in log2 units: the row max of the raw scores (the scale
    // is positive) times scale * log2(e), p = exp2(s * scale * log2(e) - m)
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    float corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]) * scale2);
      corr[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * j + e] = exp2f(fmaf(s[4 * j + e], scale2, -m[e >> 1]));
        sum[e >> 1] += s[4 * j + e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + quad_sum(sum[i]);
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int j = 0; j < ON / 8; ++j) {
        acc[h][4 * j] *= corr[0];
        acc[h][4 * j + 1] *= corr[0];
        acc[h][4 * j + 2] *= corr[1];
        acc[h][4 * j + 3] *= corr[1];
      }

    // P in bf16 as wgmma's A fragments: slice p is blocks 2p, 2p + 1 of S
    uint32_t pa[NP][4];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      pa[p][0] = pack_bf16(s[8 * p], s[8 * p + 1]);          // row g, keys 2t, 2t+1
      pa[p][1] = pack_bf16(s[8 * p + 2], s[8 * p + 3]);      // row g + 8
      pa[p][2] = pack_bf16(s[8 * p + 4], s[8 * p + 5]);      // row g, keys 8 + 2t, +1
      pa[p][3] = pack_bf16(s[8 * p + 6], s[8 * p + 7]);      // row g + 8
      pin(pa[p]);
    }

    // O += P.V, one k-step per 16 keys (16 rows of 128 bytes of each slab)
#pragma unroll
    for (int h = 0; h < NH; ++h) pin(acc[h]);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int h = 0; h < NH; ++h)
        wgmma_rs<ON>(acc[h], pa[p], v_desc + ((stage + p * 16 * 128 + h * (ON / 64) * KV_SLAB) >> 4));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int h = 0; h < NH; ++h) pin(acc[h]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qw + g + 8 * i;
    if (row >= seq_q) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    bf16* out = ob + row * o_row + 2 * t;
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int j = 0; j < ON / 8; ++j) {
        const int c = ON * h + 8 * j;
        if (c + 2 * t >= dv) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + c) =
            __floats2bfloat162_rn(acc[h][4 * j + 2 * i] / denom, acc[h][4 * j + 2 * i + 1] / denom);
      }
  }
}

template <int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int seq_q,
           int seq_k, int kv_heads, int group, int dk, int dv, int causal, int q_offset,
           float scale, void* stream) {
  constexpr size_t smem = smem_bytes<DMAX>();
  cudaError_t e = cudaFuncSetAttribute(flash_wgmma_kernel<DMAX>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(batch) * kv_heads * group, (seq_q + BQ - 1) / BQ);
  flash_wgmma_kernel<DMAX><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), seq_q, seq_k, kv_heads, group, dk, dv, causal, q_offset, scale);
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

}  // namespace wg

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
  const int d = dk > dv ? dk : dv;
  if (!f32)
    return static_cast<int>(d <= 64    ? wg::smem_bytes<64>()
                            : d <= 128 ? wg::smem_bytes<128>()
                                       : wg::smem_bytes<256>());
  return static_cast<int>(d <= 64    ? tc::smem_bytes<64>(dk, dv)
                          : d <= 128 ? tc::smem_bytes<128>(dk, dv)
                                     : tc::smem_bytes<256>(dk, dv));
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* o, int batch, int seq_q, int seq_k,
                                    int kv_heads, int group, int dk, int dv,
                                    int causal, int q_offset, float scale,
                                    void* stream) {
  return wg::dispatch(q, k, v, o, batch, seq_q, seq_k, kv_heads, group, dk, dv, causal,
                      q_offset, scale, stream);
}
