// Mamba2 SSD scan on Hopper: one work item per (batch, head, chunk), the
// chunk's products on the tensor cores in 3xTF32, the state passed from chunk
// to chunk through device scratch (L2).
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py (_ssd_kernel, ssd_scan_bh)
//   and the layout of src/repro/kernels/ssd_scan/ops.py (ssd).
//
// xbar (b, T, H, P), B and C (b, T, G, N), float32 or bfloat16 (one dtype),
// a (b, T, H) float32, all row-major -> y (b, T, H, P) in xbar's dtype; every
// element is widened to fp32 on load and the state stays fp32.  Head h reads
// B/C of group h / (H / G) in place, where the JAX wrapper repeats them over
// the heads of a group.  Per (batch, head), chunks of Q tokens, with cum = the
// running sum of a within the chunk and h_c the fp32 state after chunk c
// (h_{-1} = 0), the plain version's four steps (kernels/ssd_scan/ref.py):
//   S_c   = sum_j B_j^T exp(cum_{Q-1} - cum_j) xbar_j          (N x P)
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) xbar_j
//           + exp(cum_i) C_i h_{c-1}
//   h_c   = h_{c-1} exp(cum_{Q-1}) + S_c
// The mask j <= i is applied before the exp, as the TPU kernel does (the
// upper triangle has cum_i - cum_j > 0 and would overflow).
//
// Design.  The TPU kernel walks a head's chunks in order because a TPU runs
// a grid's minor axis in order; here every (batch, head, chunk) is a work
// item (5,120 at the mamba2-2.7b prefill shape), taken from a ticket counter
// by persistent CTAs of 8 warps (one a SM: at Q 128, N 128, P 64 the tiles
// take 210 KB of shared memory).  Tickets are chunk-major (ticket k is chunk
// k / (b H) of head k mod (b H)), so an item's predecessor always holds an
// earlier ticket: it is resident or done, and the chain needs no cooperative
// launch.  An item:
//   1. stages its chunk's xbar (Q x P) and B (Q x N), then C, into shared
//      memory (cp.async for float32, C landing behind step 2; bfloat16
//      widened through registers), rows and columns past Q, N, P zero up to
//      the tiles (Q to 16, N and P to 32); cum is a warp scan of a in fp64,
//      kept as two floats so that cum_i - cum_j keeps fp32's precision
//      (diff), with exp(cum) and exp(cum_{Q-1} - cum).  Thread 0 meanwhile reads the
//      predecessor's count (an acquire load): if h_{c-1} is published
//      already, its copy into shared memory is issued now too;
//   2. computes S_c in registers before any wait: a warp per 32 x 32 tile
//      of (N, P);
//   3. otherwise waits (thread 0 spins on the acquire load, with a time
//      bound that ends in __trap()) and copies h_{c-1}; then forms h_c =
//      h_{c-1} exp(cum_{Q-1}) + S_c and publishes it (stores past L1, a
//      barrier, one release store of the head's count, c + 1, which is
//      cumulative over the CTA's stores), unless c is the last chunk: one
//      N x P pass and a count a hop;
//   4. only then the outputs: a warp per 16 rows of y, the scores C.B^T on
//      the key tiles up to the rows' diagonal, masked and decayed in
//      registers, whose accumulators are the A fragments of scores . xbar;
//      then exp(cum) C . h_{c-1} into the same accumulators; y stored in
//      xbar's dtype.  The triangle's key blocks are split evenly between
//      warps w and w + 4, w handing a partial sum of w + 4's rows through
//      shared memory (y_tiles).
// The published states live in two slots per (batch, head) in device scratch
// (b H 2 N P fp32: 21 MB at mamba2, L2-resident); two are enough, since chunk
// c + 1 copies h_c before it publishes h_{c+1}.  The wrapper zeroes the
// ticket and the counts on every call (a memset, which a CUDA graph captures).
//
// Every product is mma.sync.m16n8k8 TF32 in 3xTF32 with fp32 accumulate
// (mma_tf32.cuh).  Shared-memory tiles are unpadded with rows a multiple of
// 32 floats, their 16-byte chunks XOR-swizzled by the row (swz): the
// fragment loads of every product, whether a lane's rows vary with g (C, B
// as the scores' operands) or with t (B as S_c's A, xbar, h), hit 32 banks,
// and since the XOR depends on the row mod 8 only, each loop keeps it per lane.
//
// Bound: Q (Q + 1) (N + P) + 4 Q N P flops per chunk per head (the scores
// and their product with xbar over the causal pairs, the carried-state term
// and the state update), each done as three TF32 products: 3 x 37.7 GFLOP at
// 495 TFLOP/s = 0.228 ms at the mamba2-2.7b prefill shape, against 0.104 ms
// for the ~347 MB of inputs read and y written once (and 0.563 ms for the
// flops on the fp32 pipes).  B and C are read once per head of their group
// (from L2) and the state hop adds 2 N P floats of L2 traffic an item.
// mma.sync does not reach the 495 TFLOP/s of wgmma; scripts/torch_ssd_phases.py
// measures its rate on the card and where an item's cycles go.

#include <stdint.h>

#include "common.cuh"
#include "dtype.cuh"
#include "mma_tf32.cuh"

namespace {

using namespace tf32x3;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SCALARS = 32;             // floats of shared memory for the scan and ticket
constexpr int PART = 16 * 64;           // floats of one warp's partial y (16 rows x 64)
constexpr long long SPIN_LIMIT_NS = 10000000000LL;  // 10 s: a broken chain traps
constexpr float kLog2e = 1.4426950408889634f;      // exp(x) = exp2(x log2 e)

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// xbar, B, C (Qp rows), the previous state (Np x Pp), four warps' partial
// y, cum as two floats and its two exponentials, the scan's warp sums
// (fp64) and the ticket
__host__ __device__ inline size_t smem_floats(int Q, int P, int N) {
  const size_t Qp = round_up(Q, 16), Np = round_up(N, 32), Pp = round_up(P, 32);
  return Qp * Pp + 2 * Qp * Np + Np * Pp + 4 * PART + 4 * Qp + SCALARS;
}

// The XOR a row r puts on its columns' offsets: 3 bits of r flip the 16-byte
// chunk index (bit 0 of r its bit 2, bits 1-2 its bits 1-2), within each 32
// floats.  It depends on r % 8 only, so the hot loops keep it per lane.
__device__ __forceinline__ int swz_mask(int r) {
  return 4 * (((r & 1) << 2) ^ (((r >> 1) & 3) << 1));
}
// (row, col) of a tile whose rows are `stride` floats, stride % 32 == 0
__device__ __forceinline__ int swz(int row, int col, int stride) {
  return row * stride + (col ^ swz_mask(row));
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}
// cum_i - cum_j from two (cum, rest) pairs: the floats' difference is exact
// wherever the decay it feeds is above fp32's underflow and |cum| > 88
// (Sterbenz), and within half an ulp of the difference below that, so the
// decays keep fp32's precision whatever |cum| is (hundreds at mamba2)
__device__ __forceinline__ float diff(float ci, float ri, float cj, float rj) {
  return (ci - cj) + (ri - rj);
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// rows x width of a row-major source (rows src_row elements apart) into a
// swizzled tile; vec: width % 4 == 0 and every row 16-byte (f32) or 8-byte
// (bf16) aligned.  Columns past width keep the zeros the CTA wrote at start.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int stride, const T* src, long long src_row,
                                      int rows, int width, bool vec, int tid) {
  if (vec) {
    const int w4 = width / 4;
    for (int e = tid; e < rows * w4; e += THREADS) {
      const int r = e / w4, c = (e - r * w4) * 4;
      const T* s = src + r * src_row + c;
      if constexpr (sizeof(T) == 4) {
        cp_async16(dst + swz(r, c, stride), s, true);
      } else {
        const uint2 u = *reinterpret_cast<const uint2*>(s);
        const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
        const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
        *reinterpret_cast<float4*>(dst + swz(r, c, stride)) =
            make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
      }
    }
  } else {
    for (int e = tid; e < rows * width; e += THREADS) {
      const int r = e / width, c = e - r * width;
      const T* s = src + r * src_row + c;
      if constexpr (sizeof(T) == 4)
        cp_async4(dst + swz(r, c, stride), s);
      else
        dst[swz(r, c, stride)] = to_f(*s);
    }
  }
}

// h_{c-1} (Np x Pp, row-major in its slot) into the swizzled hs, one
// cp.async group (past L1: the slot was written by another SM)
__device__ __forceinline__ void copy_state(float* hs, const float* slot, int Np, int Pp,
                                           int tid) {
  const int p4 = Pp / 4;
  for (int e = tid; e < Np * p4; e += THREADS) {
    const int r = e / p4, col = (e - r * p4) * 4;
    cp_async16(hs + swz(r, col, Pp), slot + 4 * e, true);
  }
  cp_async_commit();
}

// S_c of one 32 x 32 tile of (N, P) into sacc[mt][r][e]: state row n0 + 4g
// + 2mt + e/2, column p0 + 8t + 4(e%2) + r.  k = t, t + 4 are chunk rows j0 +
// 2t, j0 + 2t + 1; a lane's four A rows (g, g + 8 of two m-tiles) are the
// state rows n0 + 4g .. + 3, one 16-byte load of B a chunk row.
__device__ __forceinline__ void state_tile(float (&sacc)[2][4][4], const float* bs,
                                           const float* xs, const float* sdec, int Qp, int Np,
                                           int Pp, int tile, int pblocks, int g, int t) {
  const int n0 = (tile / pblocks) * 32, p0 = (tile % pblocks) * 32;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[m][r][e] = 0.0f;
  // rows 2t, 2t + 1 (mod 8): columns n0 + 4g and p0 + 4g, swizzled
  const int c0 = (4 * g) ^ swz_mask(2 * t), c1 = (4 * g) ^ swz_mask(2 * t + 1);
  const float* bt = bs + 2 * t * Np + n0;
  const float* xt = xs + 2 * t * Pp + p0;
  for (int j0 = 0; j0 < Qp; j0 += 8) {
    const int r0 = j0 + 2 * t;
    const float d0 = sdec[r0], d1 = sdec[r0 + 1];
    const float4 b0 = ld4(bt + j0 * Np + c0);
    const float4 b1 = ld4(bt + (j0 + 1) * Np + c1);
    const float4 x0 = ld4(xt + j0 * Pp + c0);
    const float4 x1 = ld4(xt + (j0 + 1) * Pp + c1);
    FragA a0, a1;
    a0.set(b0.x * d0, b0.y * d0, b1.x * d1, b1.y * d1);
    a1.set(b0.z * d0, b0.w * d0, b1.z * d1, b1.w * d1);
    FragB f[4];
    f[0].set(x0.x, x1.x);
    f[1].set(x0.y, x1.y);
    f[2].set(x0.z, x1.z);
    f[3].set(x0.w, x1.w);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      mma3(sacc[0][r], a0, f[r]);
      mma3(sacc[1][r], a1, f[r]);
    }
  }
}

// h_c = h_{c-1} exp(cum_{Q-1}) + S_c of one tile (carry: c > 0, h_{c-1} in
// hs), stored to the item's slot past L1; a lane stores 8 consecutive
// columns of 4 rows
__device__ __forceinline__ void publish_tile(const float (&sacc)[2][4][4], const float* hs,
                                             float* out_slot, bool carry, float total, int Pp,
                                             int tile, int pblocks, int g, int t) {
  const int n0 = (tile / pblocks) * 32, p0 = (tile % pblocks) * 32;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int m = q >> 1, e = 2 * (q & 1);
    const int row = n0 + 4 * g + q, col = p0 + 8 * t;
    float v[8];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      v[r] = sacc[m][r][e];
      v[4 + r] = sacc[m][r][e + 1];
    }
    if (carry) {
      const float4 h0 = ld4(hs + swz(row, col, Pp)), h1 = ld4(hs + swz(row, col + 4, Pp));
      v[0] += h0.x * total;
      v[1] += h0.y * total;
      v[2] += h0.z * total;
      v[3] += h0.w * total;
      v[4] += h1.x * total;
      v[5] += h1.y * total;
      v[6] += h1.z * total;
      v[7] += h1.w * total;
    }
    float* dst = out_slot + static_cast<long long>(row) * Pp + col;
    __stcg(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
    __stcg(reinterpret_cast<float4*>(dst + 4), make_float4(v[4], v[5], v[6], v[7]));
  }
}

// Scores of rows ra, rb = ra + 8 against keys kb .. kb + 8 KT - 1 over N,
// masked before the exp and decayed, then their product with those keys'
// rows of xbar into acc (NG groups of 32 columns from p0).  Scores: k = t,
// t + 4 are columns n + 4t, n + 4t + 1 (a0) and n + 4t + 2, n + 4t + 3 (a1);
// s[j][e] is row g + 8(e/2), key kb + 8j + 2t + e%2, so the accumulator is
// the A fragment of scores . xbar with k = t, t + 4 the keys 2t, 2t + 1.
template <int KT, int NG>
__device__ __forceinline__ void diag_block(float (&acc)[NG][4][4], const float* cs,
                                           const float* bs, const float* xs, const float* cum,
                                           const float* rest, int Np, int Pp, int ra,
                                           const float (&ci)[2][2],
                                           int kb, int p0, int g, int t) {
  const int rb = ra + 8;
  // every row here is g (mod 8): column n + 4t lies at n ^ ct
  const int ct = (4 * t) ^ swz_mask(g);
  const float* ca = cs + ra * Np;
  const float* kr = bs + (kb + g) * Np;
  float s[KT][4];
#pragma unroll
  for (int j = 0; j < KT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
  for (int n = 0; n < Np; n += 16) {
    const int col = n ^ ct;
    const float4 lo = ld4(ca + col);
    const float4 hi = ld4(ca + 8 * Np + col);
    FragA a0, a1;
    a0.set(lo.x, hi.x, lo.y, hi.y);
    a1.set(lo.z, hi.z, lo.w, hi.w);
    FragB f0[KT], f1[KT];
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const float4 kv = ld4(kr + 8 * j * Np + col);
      f0[j].set(kv.x, kv.y);
      f1[j].set(kv.z, kv.w);
    }
#pragma unroll
    for (int j = 0; j < KT; ++j) mma3(s[j], a0, f0[j]);
#pragma unroll
    for (int j = 0; j < KT; ++j) mma3(s[j], a1, f1[j]);
  }
  // keys 2t, 2t + 1 (mod 8): columns p0 + 32pg + 4g, swizzled
  const int c0 = (4 * g) ^ swz_mask(2 * t), c1 = (4 * g) ^ swz_mask(2 * t + 1);
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    const int key = kb + 8 * j + 2 * t;
    const float2 ck = ld2(cum + key), rk = ld2(rest + key);
    const float d0 = diff(ci[0][0], ci[0][1], ck.x, rk.x);
    const float d1 = diff(ci[0][0], ci[0][1], ck.y, rk.y);
    const float d2 = diff(ci[1][0], ci[1][1], ck.x, rk.x);
    const float d3 = diff(ci[1][0], ci[1][1], ck.y, rk.y);
    const float s0 = key <= ra ? s[j][0] * exp2f(d0 * kLog2e) : 0.0f;
    const float s1 = key + 1 <= ra ? s[j][1] * exp2f(d1 * kLog2e) : 0.0f;
    const float s2 = key <= rb ? s[j][2] * exp2f(d2 * kLog2e) : 0.0f;
    const float s3 = key + 1 <= rb ? s[j][3] * exp2f(d3 * kLog2e) : 0.0f;
    FragA pa;
    pa.set(s0, s2, s1, s3);
    const float* xk = xs + key * Pp + p0;
#pragma unroll
    for (int pg = 0; pg < NG; ++pg) {
      const float4 x0 = ld4(xk + 32 * pg + c0);
      const float4 x1 = ld4(xk + Pp + 32 * pg + c1);
      mma3(acc[pg][0], pa, x0.x, x1.x);
      mma3(acc[pg][1], pa, x0.y, x1.y);
      mma3(acc[pg][2], pa, x0.z, x1.z);
      mma3(acc[pg][3], pa, x0.w, x1.w);
    }
  }
}

// What y_rows does with its sum: store y (kWhole), hand it to the warp that
// owns the rows (kGive: into part, then bar.arrive), or add the other warp's
// before storing (kTake: bar.sync, then part).
enum { kWhole, kGive, kTake };

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 64;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}

// y of the 16 rows from i0, columns p0 .. p0 + 32 NG - 1, from keys [k0,
// k1) (multiples of 16; k1 <= i0 + 16): the scores on those key tiles, then,
// but for kGive, (carry: c > 0) exp(cum_i) C_i . h_{c-1}; mode says what
// becomes of the sum (named barrier `bar` pairs the two warps).
// acc[pg][r][e]: row i0 + g + 8(e/2), column p0 + 32pg + 8t + 4(e%2) + r; a
// partial lies in part in that order, lane-minor.
template <int NG, typename T>
__device__ __forceinline__ void y_rows(T* yb, long long x_row, const float* cs,
                                       const float* bs, const float* xs, const float* hs,
                                       const float* cum, const float* rest, const float* ecum,
                                       int Q, int P,
                                       int Np, int Pp, int i0, int k0, int k1, int p0,
                                       int mode, float* part, int bar, bool carry, int vec,
                                       int g, int t) {
  const int ra = i0 + g, rb = ra + 8;
  const int lane = 4 * g + t;
  const float ci[2][2] = {{cum[ra], rest[ra]}, {cum[rb], rest[rb]}};
  float acc[NG][4][4];
#pragma unroll
  for (int pg = 0; pg < NG; ++pg)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[pg][r][e] = 0.0f;
  // blocks of 32 keys, then one of 16
  int kb = k0;
  for (; kb + 32 <= k1; kb += 32)
    diag_block<4, NG>(acc, cs, bs, xs, cum, rest, Np, Pp, ra, ci, kb, p0, g, t);
  if (kb < k1) diag_block<2, NG>(acc, cs, bs, xs, cum, rest, Np, Pp, ra, ci, kb, p0, g, t);

  if (mode == kGive) {
#pragma unroll
    for (int pg = 0; pg < NG; ++pg)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[((pg * 4 + r) * 4 + e) * 32 + lane] = acc[pg][r][e];
    bar_arrive(bar);
    return;
  }

  // exp(cum_i) C_i . h_{c-1}: k = t, t + 4 are state rows n + 2t, n + 2t + 1
  if (carry) {
    const float ea = ecum[ra], eb = ecum[rb];
    // C's rows are g (mod 8): column n + 2t lies at n ^ c2; the state rows
    // n + 2t, n + 2t + 1 are 2t, 2t + 1 (mod 8)
    const int c2 = (2 * t) ^ swz_mask(g);
    const int c0 = (4 * g) ^ swz_mask(2 * t), c1 = (4 * g) ^ swz_mask(2 * t + 1);
    const float* ca = cs + ra * Np;
    const float* ht = hs + 2 * t * Pp + p0;
    for (int n = 0; n < Np; n += 8) {
      const float2 lo = ld2(ca + (n ^ c2));
      const float2 hi = ld2(ca + 8 * Np + (n ^ c2));
      FragA cf;
      cf.set(lo.x * ea, hi.x * eb, lo.y * ea, hi.y * eb);
#pragma unroll
      for (int pg = 0; pg < NG; ++pg) {
        const float4 h0 = ld4(ht + n * Pp + 32 * pg + c0);
        const float4 h1 = ld4(ht + (n + 1) * Pp + 32 * pg + c1);
        mma3(acc[pg][0], cf, h0.x, h1.x);
        mma3(acc[pg][1], cf, h0.y, h1.y);
        mma3(acc[pg][2], cf, h0.z, h1.z);
        mma3(acc[pg][3], cf, h0.w, h1.w);
      }
    }
  }

  if (mode == kTake) {
    bar_sync(bar);
#pragma unroll
    for (int pg = 0; pg < NG; ++pg)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[pg][r][e] += part[((pg * 4 + r) * 4 + e) * 32 + lane];
  }

  // y in xbar's dtype
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i == 0 ? ra : rb;
    if (row >= Q) continue;
    T* out = yb + static_cast<long long>(row) * x_row;
#pragma unroll
    for (int pg = 0; pg < NG; ++pg)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int col = p0 + 32 * pg + 8 * t + 4 * hh;
        if (col >= P) continue;
        const int e = 2 * i + hh;
        const float v0 = acc[pg][0][e], v1 = acc[pg][1][e], v2 = acc[pg][2][e],
                    v3 = acc[pg][3][e];
        if (vec) {
          if constexpr (sizeof(T) == 4) {
            *reinterpret_cast<float4*>(out + col) = make_float4(v0, v1, v2, v3);
          } else {
            __nv_bfloat162 lo = __floats2bfloat162_rn(v0, v1);
            __nv_bfloat162 hi = __floats2bfloat162_rn(v2, v3);
            uint2 u;
            u.x = *reinterpret_cast<uint32_t*>(&lo);
            u.y = *reinterpret_cast<uint32_t*>(&hi);
            *reinterpret_cast<uint2*>(out + col) = u;
          }
        } else {
          const float vs[4] = {v0, v1, v2, v3};
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (col + r < P) out[col + r] = from_f<T>(vs[r]);
        }
      }
  }
}

// The y work of warp position pos (P <= 64: one pass of columns).  Where
// the chunk has 8 to 15 m-tiles, the first 8 split their causal keys evenly:
// warp w < 4 owns m-tile w (16 (w + 1) keys), warp w + 4 the heavy m-tile
// 7 - w (16 (8 - w)), and warp w also takes the heavy one's first 16 (4 - w)
// keys as a partial sum that warp w + 4 adds before it stores: 80 and 64
// keys a warp (against 16 to 128), with one y_off each.  (A split at 72
// each needs a block of 8 keys, which costs more than it evens out.)  Other
// m-tiles go one a warp.
template <int NG, typename T>
__device__ __forceinline__ void y_tiles(T* yb, long long x_row, const float* cs,
                                        const float* bs, const float* xs, const float* hs,
                                        float* part, const float* cum, const float* rest,
                                        const float* ecum, int Q,
                                        int P, int Np, int Pp, int mtiles, int pos, bool carry,
                                        int vec, int g, int t) {
  const int k8 = pos & 7, w = k8 & 3;
  if (pos >= 8 || mtiles < 8 || mtiles >= 16) {
    y_rows<NG>(yb, x_row, cs, bs, xs, hs, cum, rest, ecum, Q, P, Np, Pp, 16 * pos, 0, 16 * pos + 16,
               0, kWhole, nullptr, 0, carry, vec, g, t);
    return;
  }
  const int heavy = 7 - w, split = 16 * (4 - w);
  float* mine = part + w * PART;
  if (k8 < 4) {
    y_rows<NG>(yb, x_row, cs, bs, xs, hs, cum, rest, ecum, Q, P, Np, Pp, 16 * heavy, 0, split, 0,
               kGive, mine, 1 + w, carry, vec, g, t);
    y_rows<NG>(yb, x_row, cs, bs, xs, hs, cum, rest, ecum, Q, P, Np, Pp, 16 * pos, 0, 16 * pos + 16,
               0, kWhole, nullptr, 0, carry, vec, g, t);
  } else {
    y_rows<NG>(yb, x_row, cs, bs, xs, hs, cum, rest, ecum, Q, P, Np, Pp, 16 * heavy, split,
               16 * heavy + 16, 0, kTake, mine, 1 + w, carry, vec, g, t);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ a,
                     const T* __restrict__ bm, const T* __restrict__ cm, T* __restrict__ y,
                     float* __restrict__ states, int* __restrict__ sync, int batch, int seq,
                     int heads, int groups, int P, int N, int Q, int vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Qp = round_up(Q, 16), Np = round_up(N, 32), Pp = round_up(P, 32);
  float* xs = smem;             // Qp x Pp, swizzled
  float* bs = xs + Qp * Pp;     // Qp x Np, swizzled
  float* cs = bs + Qp * Np;     // Qp x Np, swizzled
  float* hs = cs + Qp * Np;     // Np x Pp, swizzled: h_{c-1}
  float* part = hs + Np * Pp;   // 4 x PART: partial y handed from warp w to w + 4
  // Qp each: the running sum of a, summed in fp64 and kept as float cum
  // plus float rest (cum + rest is the fp64 sum to 2^-48); rows past Q hold
  // cum_{Q-1}
  float* cum = part + 4 * PART;
  float* rest = cum + Qp;
  float* ecum = rest + Qp;      // Qp: exp(cum_i)
  float* sdec = ecum + Qp;      // Qp: exp(cum_{Q-1} - cum_j)
  double* wsum = reinterpret_cast<double*>(sdec + Qp);  // WARPS: the scan's warp sums
  int* ticket_s = reinterpret_cast<int*>(wsum + WARPS);
  int* ready_s = ticket_s + 1;  // the predecessor had published when the item began

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bhs = batch * heads;
  const int chunks = seq / Q;
  const int items = bhs * chunks;
  const int rep = heads / groups;
  const long long x_row = static_cast<long long>(heads) * P;
  const long long bc_row = static_cast<long long>(groups) * N;
  const long long slot = static_cast<long long>(Np) * Pp;
  const int pblocks = Pp / 32;
  const int stiles = (Np / 32) * pblocks;  // 32 x 32 tiles of S_c
  const int mtiles = Qp / 16;

  // the tiles' pads are never written by the copies: zero them once
  const int total_floats = static_cast<int>(smem_floats(Q, P, N));
  for (int i = tid; i < total_floats; i += THREADS) smem[i] = 0.0f;
  __syncthreads();

  for (;;) {
    if (tid == 0) *ticket_s = atomicAdd(sync, 1);
    __syncthreads();  // the ticket; every warp is done with the previous item's tiles
    const int ticket = *ticket_s;
    if (ticket >= items) break;
    const int c = ticket / bhs, bh = ticket - c * bhs;
    const int b = bh / heads, h = bh - b * heads, grp = h / rep;
    const long long row0 = static_cast<long long>(b) * seq + static_cast<long long>(c) * Q;
    const T* xb = x + row0 * x_row + static_cast<long long>(h) * P;
    const T* bb = bm + row0 * bc_row + static_cast<long long>(grp) * N;
    const T* cb = cm + row0 * bc_row + static_cast<long long>(grp) * N;
    const float* ab = a + row0 * heads + h;
    T* yb = y + row0 * x_row + static_cast<long long>(h) * P;
    // thread 0, while the copies below fly: has the predecessor published
    // already?  (then h_{c-1}'s copy flies behind S_c too)
    if (tid == 0) *ready_s = c == 0 || ld_acquire(sync + 1 + bh) >= c;

    // 1. staging (xbar and B, which S_c reads, then C, which lands behind
    // S_c), and cum by a warp scan while the copies fly
    stage(xs, Pp, xb, x_row, Q, P, vec, tid);
    stage(bs, Np, bb, bc_row, Q, N, vec, tid);
    cp_async_commit();
    stage(cs, Np, cb, bc_row, Q, N, vec, tid);
    cp_async_commit();
    // in fp64: the decays are exponentials of differences cum_i - cum_j,
    // which from fp32 sums would carry the rounding of |cum| (hundreds at
    // mamba2); kept as cum + rest (diff)
    double carry = 0.0;
    for (int base = 0; base < Qp; base += THREADS) {
      const int j = base + tid;
      double v = j < Q ? ab[static_cast<long long>(j) * heads] : 0.0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      if (lane == 31) wsum[warp] = v;
      __syncthreads();
      double pre = carry, tot = carry;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        if (w < warp) pre += wsum[w];
        tot += wsum[w];
      }
      if (j < Qp) {
        const double sum = pre + v;
        cum[j] = static_cast<float>(sum);
        rest[j] = static_cast<float>(sum - static_cast<double>(cum[j]));
      }
      carry = tot;
      __syncthreads();  // cum complete; wsum free for the next block
    }
    const float last = cum[Q - 1], last_rest = rest[Q - 1];
    for (int j = tid; j < Qp; j += THREADS) {
      ecum[j] = expf(cum[j] + rest[j]);
      sdec[j] = expf(diff(last, last_rest, cum[j], rest[j]));
    }
    cp_async_wait_group<1>();  // xbar and B
    __syncthreads();
    const bool ready = *ready_s;
    const float* in_slot = states + (static_cast<long long>(bh) * 2 + ((c - 1) & 1)) * slot;
    if (c > 0 && ready) copy_state(hs, in_slot, Np, Pp, tid);

    // 2. S_c of this warp's first tile, in registers, before the wait
    const bool publish = c + 1 < chunks;
    const float total = expf(last + last_rest);
    float* out_slot = states + (static_cast<long long>(bh) * 2 + (c & 1)) * slot;
    float sacc[2][4][4];
    if (publish && warp < stiles)
      state_tile(sacc, bs, xs, sdec, Qp, Np, Pp, warp, pblocks, g, t);

    // 3. the chain: wait for h_{c-1} (unless it was there when the item
    // began) and copy it, then publish h_c
    if (c > 0 && !ready) {
      if (tid == 0) {
        const int* flag = sync + 1 + bh;
        if (ld_acquire(flag) < c) {
          const unsigned long long start = global_ns();
          while (ld_acquire(flag) < c) {
            __nanosleep(100);
            if (global_ns() - start > SPIN_LIMIT_NS) __trap();
          }
        }
      }
      __syncthreads();
      copy_state(hs, in_slot, Np, Pp, tid);
    }
    cp_async_wait_all();  // C, h_{c-1}
    __syncthreads();
    if (publish) {
      for (int tile = warp; tile < stiles; tile += WARPS) {
        if (tile != warp) state_tile(sacc, bs, xs, sdec, Qp, Np, Pp, tile, pblocks, g, t);
        publish_tile(sacc, hs, out_slot, c > 0, total, Pp, tile, pblocks, g, t);
      }
      __syncthreads();  // every thread's part of h_c is stored
      // cumulative over the CTA's stores; it stalls warp 4, which has the
      // least y work, until they are performed
      if (tid == 128) st_release(sync + 1 + bh, c + 1);
    }

    // 4. y, 16 rows a warp
    for (int pos = warp; pos < mtiles; pos += WARPS) {
      if (Pp <= 32)
        y_tiles<1>(yb, x_row, cs, bs, xs, hs, part, cum, rest, ecum, Q, P, Np, Pp, mtiles, pos,
                   c > 0, vec, g, t);
      else if (Pp <= 64)
        y_tiles<2>(yb, x_row, cs, bs, xs, hs, part, cum, rest, ecum, Q, P, Np, Pp, mtiles, pos,
                   c > 0, vec, g, t);
      else
        for (int p0 = 0; p0 < Pp; p0 += 64) {
          if (p0 + 32 < Pp)
            y_rows<2>(yb, x_row, cs, bs, xs, hs, cum, rest, ecum, Q, P, Np, Pp, 16 * pos, 0,
                      16 * pos + 16, p0, kWhole, nullptr, 0, c > 0, vec, g, t);
          else
            y_rows<1>(yb, x_row, cs, bs, xs, hs, cum, rest, ecum, Q, P, Np, Pp, 16 * pos, 0,
                      16 * pos + 16, p0, kWhole, nullptr, 0, c > 0, vec, g, t);
        }
    }
  }
}

// CTAs of ssd_chunk_kernel<T> resident at once on the current device for
// `smem` bytes of shared memory: the kernel's limit raised to a CTA's 227 KB
// once per device and the count asked once per device and size, so that a
// call spends no host time on either (0 and the error where a call fails)
template <typename T>
int resident_ctas(size_t smem, cudaError_t& e) {
  constexpr int kDevices = 64;
  static int sms[kDevices] = {0}, per_sm[kDevices] = {0};
  static size_t asked[kDevices] = {0};
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return 0;
  const bool cache = dev >= 0 && dev < kDevices;
  if (cache && sms[dev] > 0 && asked[dev] == smem) return sms[dev] * per_sm[dev];
  e = cudaFuncSetAttribute(ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSharedBytes);
  if (e != cudaSuccess) return 0;
  int n = 0, k = 0;
  e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&k, ssd_chunk_kernel<T>, THREADS, smem);
  if (e != cudaSuccess) return 0;
  k = k > 0 ? k : 1;
  if (cache) {
    per_sm[dev] = k;
    asked[dev] = smem;
    sms[dev] = n;
  }
  return n * k;
}

template <typename T>
int launch(const void* x, const float* a, const void* bm, const void* cm, void* y,
           int batch, int seq, int heads, int groups, int P, int N, int Q, float* states,
           int* sync, cudaStream_t s) {
  const size_t smem = smem_floats(Q, P, N) * sizeof(float);
  cudaError_t e = cudaSuccess;
  const long long resident = resident_ctas<T>(smem, e);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long items = static_cast<long long>(batch) * heads * (seq / Q);
  const unsigned grid = static_cast<unsigned>(items < resident ? items : resident);
  // 16-byte (f32) or 8-byte (bf16) rows: every row start is a multiple of 4
  // elements from an aligned base
  const size_t align = 4 * sizeof(T);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(bm) |
                          reinterpret_cast<uintptr_t>(cm) | reinterpret_cast<uintptr_t>(y);
  const int vec = P % 4 == 0 && N % 4 == 0 && bases % align == 0;
  ssd_chunk_kernel<T><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(x), a, static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<T*>(y), states, sync, batch, seq, heads, groups, P, N, Q, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: kF32 or kBF16, of xbar, B, C and y (a is float32).  Q: the chunk, or
// the sub-chunk the wrapper picked so that smem_floats(Q, P, N) fits.
// states: b H 2 round32(N) round32(P) floats (unread when T == Q); sync: 1 +
// b H ints, zero (the ticket, then each head's count of published states).
extern "C" int ssd_scan(int dtype, const void* x, const float* a, const void* bm,
                        const void* cm, void* y, int batch, int seq, int heads, int groups,
                        int P, int N, int Q, void* states, void* sync, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  auto* st = static_cast<float*>(states);
  auto* sy = static_cast<int*>(sync);
  if (dtype == kF32)
    return launch<float>(x, a, bm, cm, y, batch, seq, heads, groups, P, N, Q, st, sy, s);
  return launch<__nv_bfloat16>(x, a, bm, cm, y, batch, seq, heads, groups, P, N, Q, st, sy, s);
}

// Shared memory of one CTA at (Q, P, N); the wrapper's smem_bytes is held to it.
extern "C" int ssd_scan_smem_bytes(int Q, int P, int N) {
  return static_cast<int>(smem_floats(Q, P, N) * sizeof(float));
}
