// K-means assignment: nearest center and its squared distance, per point.
//
// Replaces: src/repro/kernels/kmeans_assign/kernel.py
//   (_assign_kernel, kmeans_assign_blocked).
//
// points (N, D), centers (K, D), both float32 or both bfloat16 -> assign int32
// (N,), dist float32 (N,): every element converted to fp32 on load, then
// d2 = |p|^2 - 2 p.c + |c|^2 in fp32 — the expanded formula, as the JAX kernel
// computes it — its argmin (the first minimum wins) and its min.  Every
// product is an IEEE fp32 FMA on the SIMT pipes: no tensor cores, so no TF32
// rounding.
//
// Three bodies, chosen by shape in the C entry (regime(); the bounds are the
// constants below, which kernels/kmeans_assign/ops.py mirrors):
//
// rows  K <= kRowsMaxK and D <= kRowsMaxD (kmeans' own shapes: Covertype's K 7
//       at D 54).  Bound by device memory: N*D elements read once, 8 bytes a
//       point written; the 2*N*K*D flops take a sixth of that time at the
//       fp32 rate.  A CTA takes kRowsPoints consecutive points, which are
//       kRowsPoints*D consecutive elements whatever D is, and loads them
//       warp-wide into shared memory as fp32: 16-byte loads from the tile's
//       first 16-byte boundary on, the head before it and the tail element
//       by element.  The alignment is read from the pointer, not assumed: a
//       Session thread's share of Covertype's rows starts 8-byte (f32) or
//       4-byte (bf16) aligned in half the threads.  Each point's row sits at
//       an odd stride, so that the threads reading their own rows touch 32
//       banks.  Each thread then walks its point's row once, updating |p|^2
//       and K dots (zero centers pad K to 8 or 16) from registers: K
//       independent FMA chains, the centers read as broadcasts.  A CTA loads
//       once and computes once; ~30 KB of shared memory lets 7 share an SM,
//       so one's loads overlap another's work.
// tiles any K past the rows' bounds at D < kWideMinD, and K past kWideMaxK
//       at any D (K 1,024 at D 64; K 9,000 at D 8).  Bound by the fp32 pipes
//       (2*N*K*D flops), and by shared memory before them: a warp's 16-byte
//       read of a slab column takes four wavefronts of the SM's one a cycle,
//       so a thread's TM + TN operands a column must feed TM*TN FMAs, of
//       which the SM issues four warps' a cycle; 4 x 4 dots a thread leave
//       the FMA pipes half idle, 8 x 8 balance them.  A register-tiled SIMT
//       product: a CTA of 256 threads takes BP points against all the
//       centers, in tiles of BC, streaming D through shared memory in slabs
//       of kSlab columns (k-major, two buffers; the (tile, slab) steps run as
//       one sequence, the next step's loads in flight during the products).
//       Each thread holds TM points x TN centers of dots and a running (d2,
//       index) per point; the threads that share a point merge by the
//       lexicographic min of (d2, index), which is order-free, so the first
//       minimum wins whatever the split.  BP 64 (8 x 8 dots a thread, held
//       to 128 registers so that two CTAs share an SM) where that still gives
//       kTilesFill CTAs, else 16 (4 x 4): N 3,000 gets 188 CTAs.
// wide  D >= kWideMinD and K <= kWideMaxK (D 60,000 at N 300).  Bound by
//       device memory, but a thread a point would leave most SMs idle and
//       walk D dependent FMAs: one CTA a point, its threads striding D with
//       coalesced loads (16-byte where the rows allow) of the point and of up
//       to kWideGroup centers at a time, which come from L2; a fixed-order
//       tree (warp butterfly, then across warps) sums |p|^2, the dots and
//       the centers' norms.
//
// In rows and tiles each sum is one fp32 FMA chain in j order, as in the
// one-thread-a-point kernel these replace, so d2 is bit-equal to it.  In wide
// the sums run in the tree's order, which the tolerance covers (integer points
// stay exact).  Sums run in another order than XLA's dot, so an assignment can
// differ only where the two best d2 lie within float rounding of each other.

#include <math_constants.h>
#include <stdint.h>

#include "common.cuh"
#include "dtype.cuh"

// The regimes' bounds (kernels/kmeans_assign/ops.py mirrors them).
constexpr int kRowsMaxK = 16;    // rows: a thread's K dots in registers
constexpr int kRowsMaxD = 64;    // rows: the point tile within 48 KB of shared memory
constexpr int kWideMinD = 2048;  // wide: a CTA a point from this D on...
constexpr int kWideMaxK = 32;    // ...while the point's row is read at most 4 times
constexpr int kTilesFill = 264;  // tiles: CTAs wanted, two an SM

constexpr int kRowsPoints = 128;  // rows: points, and threads, a CTA
static_assert(kRowsMaxD * kRowsMaxK % kRowsPoints == 0, "rows: the centers' elements a thread");
static_assert((kRowsPoints * (kRowsMaxD + 1) + kRowsMaxD * kRowsMaxK + kRowsMaxK) * 4 <=
                  48 * 1024, "rows: no shared memory attribute to set at launch");
constexpr int kTileThreads = 256;
constexpr int kSlab = 8;          // tiles: columns a slab
constexpr int kWideThreads = 256;
constexpr int kWideGroup = 8;     // wide: centers a pass over the point's row

enum Regime { kRows = 0, kTiles = 1, kWide = 2 };

static int regime(int d, int k) {
  if (k <= kRowsMaxK && d <= kRowsMaxD) return kRows;
  if (d >= kWideMinD && k <= kWideMaxK) return kWide;
  return kTiles;
}

// tiles: a CTA's points, 64 (8 x 8 dots a thread) where that still gives
// kTilesFill CTAs, else 16 (4 x 4)
static int tile_points(long long n) { return (n + 63) / 64 >= kTilesFill ? 64 : 16; }

// Sixteen bytes of elements at p (16-byte aligned) as fp32.
__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = q.x, f[1] = q.y, f[2] = q.z, f[3] = q.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the top half of its fp32
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

template <typename T>
__device__ __forceinline__ bool aligned16(const T* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---------------------------------------------------------------------------
// rows
// ---------------------------------------------------------------------------

// Elements [0, total) from g into tile rows of `stride` floats: element e is
// row e / d, column e % d.  16-byte loads from g's first 16-byte boundary on,
// kBatch of them in flight a thread; the head before it and the tail element
// by element.
template <typename T>
__device__ void load_tile(const T* __restrict__ g, int total, int d, int stride,
                          float* tile) {
  constexpr int V = 16 / sizeof(T);
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(g) & 15) / sizeof(T));
  const int head = mis ? min(total, V - mis) : 0;
  const int nvec = (total - head) / V;
  const float inv_d = 1.0f / static_cast<float>(d);
  auto row_of = [&](int e) {  // e / d, from a float estimate off by at most one
    int r = __float2int_rz(static_cast<float>(e) * inv_d);
    if (r * d > e) --r;
    else if ((r + 1) * d <= e) ++r;
    return r;
  };
  auto put = [&](int e, const float* f, int cnt) {
    int r = row_of(e), c = e - r * d;
    for (int i = 0; i < cnt; ++i) {
      tile[r * stride + c] = f[i];
      if (++c == d) c = 0, ++r;
    }
  };
  for (int e = threadIdx.x; e < head; e += kRowsPoints) {
    const float f = to_f(g[e]);
    put(e, &f, 1);
  }
  for (int e = head + nvec * V + threadIdx.x; e < total; e += kRowsPoints) {
    const float f = to_f(g[e]);
    put(e, &f, 1);
  }
  constexpr int kBatch = 4;  // 16-byte loads in flight a thread
  for (int v0 = threadIdx.x; v0 < nvec; v0 += kBatch * kRowsPoints) {
    float f[kBatch][V];
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (v0 + b * kRowsPoints < nvec) load16(g + head + (v0 + b * kRowsPoints) * V, f[b]);
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (v0 + b * kRowsPoints < nvec) put(head + (v0 + b * kRowsPoints) * V, f[b], V);
  }
}

// KM: K padded to 8 or 16.  Dynamic shared memory: the point tile
// (kRowsPoints rows of d | 1 floats), the centers j-major (d x KM) and their
// norms (KM).
template <typename T, int KM>
__global__ void __launch_bounds__(kRowsPoints)
    rows_kernel(const T* __restrict__ pts, const T* __restrict__ ctr, int* __restrict__ assign,
                float* __restrict__ dist, long long n, int d, int k) {
  extern __shared__ __align__(16) float smem[];
  const int stride = d | 1;
  float* tile = smem;
  float* sc = smem + kRowsPoints * stride;  // 16-byte aligned: kRowsPoints is a multiple of 4
  float* c2 = sc + d * KM;
  const long long p0 = static_cast<long long>(blockIdx.x) * kRowsPoints;
  const int np = static_cast<int>(n - p0 < kRowsPoints ? n - p0 : kRowsPoints);

  // the centers' elements this thread puts, loaded before the tile's and
  // stored after them, so that their latency hides behind the tile's
  constexpr int kCtrPer = kRowsMaxD * kRowsMaxK / kRowsPoints;
  float cv[kCtrPer];
#pragma unroll
  for (int i = 0; i < kCtrPer; ++i) {
    const int e = threadIdx.x + i * kRowsPoints, j = e / KM, c = e % KM;
    cv[i] = e < d * KM && c < k ? to_f(ctr[static_cast<long long>(c) * d + j]) : 0.0f;
  }
  load_tile(pts + p0 * d, np * d, d, stride, tile);
#pragma unroll
  for (int i = 0; i < kCtrPer; ++i)
    if (threadIdx.x + i * kRowsPoints < d * KM) sc[threadIdx.x + i * kRowsPoints] = cv[i];
  __syncthreads();
  if (threadIdx.x < KM) {
    float s = 0.0f;
#pragma unroll 8
    for (int j = 0; j < d; ++j) s = fmaf(sc[j * KM + threadIdx.x], sc[j * KM + threadIdx.x], s);
    c2[threadIdx.x] = s;
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= np) return;

  const float* row = tile + threadIdx.x * stride;
  float p2 = 0.0f, dot[KM];
#pragma unroll
  for (int c = 0; c < KM; ++c) dot[c] = 0.0f;
  for (int j = 0; j < d; ++j) {
    const float x = row[j];
    p2 = fmaf(x, x, p2);
    const float4* cj = reinterpret_cast<const float4*>(sc + j * KM);
#pragma unroll
    for (int q = 0; q < KM / 4; ++q) {
      const float4 c4 = cj[q];
      dot[4 * q] = fmaf(x, c4.x, dot[4 * q]);
      dot[4 * q + 1] = fmaf(x, c4.y, dot[4 * q + 1]);
      dot[4 * q + 2] = fmaf(x, c4.z, dot[4 * q + 2]);
      dot[4 * q + 3] = fmaf(x, c4.w, dot[4 * q + 3]);
    }
  }
  int best = 0;
  float best_d2 = CUDART_INF_F;
#pragma unroll
  for (int c = 0; c < KM; ++c) {
    if (c < k) {
      const float d2 = (p2 - 2.0f * dot[c]) + c2[c];
      if (c == 0 || d2 < best_d2) {
        best = c;
        best_d2 = d2;
      }
    }
  }
  assign[p0 + threadIdx.x] = best;
  dist[p0 + threadIdx.x] = best_d2;
}

// ---------------------------------------------------------------------------
// tiles
// ---------------------------------------------------------------------------

// kSlab elements of one row from src (valid of them, zero past) as fp32:
// 16-byte loads where the slab is whole and src 16-byte aligned.
template <typename T>
__device__ __forceinline__ void load_slab(const T* src, int valid, float (&f)[kSlab]) {
  if (valid == kSlab && aligned16(src)) {
#pragma unroll
    for (int i = 0; i < kSlab; i += 16 / sizeof(T)) load16(src + i, f + i);
  } else {
#pragma unroll
    for (int i = 0; i < kSlab; ++i) f[i] = i < valid ? to_f(src[i]) : 0.0f;
  }
}

// Lexicographic (d2, index): the first minimum wins whatever order the
// candidates come in.
__device__ __forceinline__ void take_min(float d2, int idx, float& bd, int& bi) {
  if (d2 < bd || (d2 == bd && idx < bi)) bd = d2, bi = idx;
}

// TY thread rows x TX thread columns, each thread TM points x TN centers of
// dots: BP points against tiles of BC centers.  A thread's points are TM / 4
// runs of 4, one in each quarter (TM 8: half) of the tile's points, and its
// centers likewise, so that the lanes of a warp (4 rows x 8 columns) read a
// slab column as runs of consecutive float4s.  Thread t < BP loads point
// p0 + t's slab and carries its norm; thread t < BC likewise a center.  The
// (center tile, slab) steps run as one sequence, the next step's loads
// issued before the products, across tile boundaries too.
template <typename T, int TY, int TM, int TN>
__global__ void __launch_bounds__(kTileThreads, 2)  // 8 x 8: 128 registers, two CTAs an SM
    tiles_kernel(const T* __restrict__ pts, const T* __restrict__ ctr, int* __restrict__ assign,
                 float* __restrict__ dist, long long n, int d, int k) {
  constexpr int TX = kTileThreads / TY;
  constexpr int BP = TM * TY, BC = TN * TX;
  static_assert(BP <= kTileThreads && BC <= kTileThreads, "a loader thread a row");
  constexpr int LP = BP + 4, LC = BC + 4;  // 4 banks apart a column, rows 16-byte aligned
  constexpr int WX = TX / 8;               // warps along the centers
  __shared__ __align__(16) float ps[2][kSlab][LP];
  __shared__ __align__(16) float cs[2][kSlab][LC];
  __shared__ float p2s[BP];
  __shared__ float c2s[2][BC];  // by tile parity; +inf past K
  __shared__ float md[TX][BP];
  __shared__ int mi[TX][BP];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int tx = (warp % WX) * 8 + (lane & 7);
  const int ty = (warp / WX) * 4 + (lane >> 3);
  const long long p0 = static_cast<long long>(blockIdx.x) * BP;
  const bool p_live = t < BP && p0 + t < n;
  const T* prow = pts + (p_live ? (p0 + t) * d : 0);
  const int nslabs = max(1, (d + kSlab - 1) / kSlab);  // D 0: one slab of zeros
  const int nsteps = (k + BC - 1) / BC * nslabs;

  float p2 = 0.0f, c2 = 0.0f;  // the loaded rows' norms, in j order
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[i][c] = 0.0f;
  float best_d[TM];  // each thread walks its centers in index order: a strict <
  int best_i[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) best_d[i] = CUDART_INF_F, best_i[i] = 0x7FFFFFFF;
  float pf[kSlab], cf[kSlab];
  auto fetch = [&](int tile, int slab) {
    const int valid = min(kSlab, d - slab * kSlab);
    const bool c_live = t < BC && tile * BC + t < k;
    load_slab(prow + slab * kSlab, p_live ? valid : 0, pf);
    load_slab(ctr + (c_live ? static_cast<long long>(tile * BC + t) * d + slab * kSlab : 0),
              c_live ? valid : 0, cf);
  };
  if (nsteps > 0) fetch(0, 0);
  for (int s = 0, tile = 0, slab = 0; s < nsteps; ++s) {
    const int buf = s & 1;
    const bool last = slab == nslabs - 1;
    if (t < BP) {
#pragma unroll
      for (int i = 0; i < kSlab; ++i) {
        ps[buf][i][t] = pf[i];
        if (tile == 0) p2 = fmaf(pf[i], pf[i], p2);
      }
      if (last && tile == 0) p2s[t] = p2;
    }
    if (t < BC) {
#pragma unroll
      for (int i = 0; i < kSlab; ++i) {
        cs[buf][i][t] = cf[i];
        c2 = fmaf(cf[i], cf[i], c2);
      }
      if (last) {
        c2s[tile & 1][t] = tile * BC + t < k ? c2 : CUDART_INF_F;
        c2 = 0.0f;
      }
    }
    __syncthreads();  // step s stored; every thread is done with step s - 2's buffers
    const int next_tile = last ? tile + 1 : tile, next_slab = last ? 0 : slab + 1;
    if (s + 1 < nsteps) fetch(next_tile, next_slab);
#pragma unroll
    for (int j = 0; j < kSlab; ++j) {
      float av[TM], bv[TN];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 a = *reinterpret_cast<const float4*>(&ps[buf][j][g * 4 * TY + ty * 4]);
        av[4 * g] = a.x, av[4 * g + 1] = a.y, av[4 * g + 2] = a.z, av[4 * g + 3] = a.w;
      }
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const float4 b = *reinterpret_cast<const float4*>(&cs[buf][j][g * 4 * TX + tx * 4]);
        bv[4 * g] = b.x, bv[4 * g + 1] = b.y, bv[4 * g + 2] = b.z, bv[4 * g + 3] = b.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
    }
    if (last) {  // the tile's d2 into each point's running (min, argmin)
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float pp = p2s[(i / 4) * 4 * TY + ty * 4 + i % 4];
#pragma unroll
        for (int c = 0; c < TN; ++c) {
          const int col = (c / 4) * 4 * TX + tx * 4 + c % 4;
          const float d2 = (pp - 2.0f * acc[i][c]) + c2s[tile & 1][col];
          if (d2 < best_d[i]) best_d[i] = d2, best_i[i] = tile * BC + col;
          acc[i][c] = 0.0f;
        }
      }
    }
    tile = next_tile, slab = next_slab;
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = (i / 4) * 4 * TY + ty * 4 + i % 4;
    md[tx][row] = best_d[i];
    mi[tx][row] = best_i[i];
  }
  __syncthreads();
  if (t < BP && p0 + t < n) {
    float bd = md[0][t];
    int bi = mi[0][t];
    for (int x = 1; x < TX; ++x) take_min(md[x][t], mi[x][t], bd, bi);
    assign[p0 + t] = bi < k ? bi : 0;  // none taken: every d2 +inf or NaN
    dist[p0 + t] = bd;
  }
}

// ---------------------------------------------------------------------------
// wide
// ---------------------------------------------------------------------------

// The CTA's sums of v[0..m), each by a fixed tree (a warp butterfly, then the
// warps' totals by warp 0), into out (shared).  Every thread calls it.
template <int M>
__device__ void cta_sums(float (&v)[M], float (*part)[M], float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[i] += __shfl_xor_sync(0xFFFFFFFFu, v[i], off);
    if (lane == 0) part[warp][i] = v[i];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float s = lane < kWideThreads / 32 ? part[lane][i] : 0.0f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xFFFFFFFFu, s, off);
      if (lane == 0) out[i] = s;
    }
  }
  __syncthreads();
}

// One CTA a point.  Per group of up to kWideGroup centers, each thread walks
// its share of D (16-byte vectors where the point's row, the centers and D
// allow it, else elements, both strided by the CTA's threads) updating |p|^2,
// the dots and the centers' norms; then the sums.  Thread 0 keeps the running
// (min, argmin) across the groups in center order.
template <typename T>
__global__ void __launch_bounds__(kWideThreads)
    wide_kernel(const T* __restrict__ pts, const T* __restrict__ ctr, int* __restrict__ assign,
                float* __restrict__ dist, int d, int k) {
  constexpr int V = 16 / sizeof(T);
  constexpr int M = 1 + 2 * kWideGroup;  // |p|^2, the dots, the centers' norms
  __shared__ float part[kWideThreads / 32][M];
  __shared__ float sums[M];
  const long long p = blockIdx.x;
  const T* row = pts + p * d;
  const bool vec = aligned16(row) && aligned16(ctr) && d % V == 0;
  float p2 = 0.0f, best_d2 = CUDART_INF_F;
  int best = 0;
  for (int g0 = 0; g0 < k; g0 += kWideGroup) {
    const int kg = min(kWideGroup, k - g0);
    const T* cg = ctr + static_cast<long long>(g0) * d;
    float v[M];
#pragma unroll
    for (int i = 0; i < M; ++i) v[i] = 0.0f;
    if (vec) {
      for (int q = threadIdx.x; q < d / V; q += kWideThreads) {
        float x[V];
        load16(row + q * V, x);
        if (g0 == 0) {
#pragma unroll
          for (int e = 0; e < V; ++e) v[0] = fmaf(x[e], x[e], v[0]);
        }
#pragma unroll
        for (int c = 0; c < kWideGroup; ++c) {
          if (c < kg) {
            float y[V];
            load16(cg + static_cast<long long>(c) * d + q * V, y);
#pragma unroll
            for (int e = 0; e < V; ++e) {
              v[1 + c] = fmaf(x[e], y[e], v[1 + c]);
              v[1 + kWideGroup + c] = fmaf(y[e], y[e], v[1 + kWideGroup + c]);
            }
          }
        }
      }
    } else {
      for (int j = threadIdx.x; j < d; j += kWideThreads) {
        const float x = to_f(row[j]);
        if (g0 == 0) v[0] = fmaf(x, x, v[0]);
#pragma unroll
        for (int c = 0; c < kWideGroup; ++c) {
          if (c < kg) {
            const float y = to_f(cg[static_cast<long long>(c) * d + j]);
            v[1 + c] = fmaf(x, y, v[1 + c]);
            v[1 + kWideGroup + c] = fmaf(y, y, v[1 + kWideGroup + c]);
          }
        }
      }
    }
    cta_sums(v, part, sums);
    if (threadIdx.x == 0) {
      if (g0 == 0) p2 = sums[0];
      for (int c = 0; c < kg; ++c) {
        const float d2 = (p2 - 2.0f * sums[1 + c]) + sums[1 + kWideGroup + c];
        if (g0 + c == 0 || d2 < best_d2) {
          best = g0 + c;
          best_d2 = d2;
        }
      }
    }
  }
  if (threadIdx.x == 0) {
    assign[p] = best;
    dist[p] = best_d2;
  }
}

// ---------------------------------------------------------------------------
// entry
// ---------------------------------------------------------------------------

template <typename T>
static int dispatch(const void* pts_, const void* ctr_, int* assign, float* dist, long long n,
                    int d, int k, cudaStream_t s) {
  const T* pts = static_cast<const T*>(pts_);
  const T* ctr = static_cast<const T*>(ctr_);
  switch (regime(d, k)) {
    case kRows: {
      const unsigned blocks = static_cast<unsigned>((n + kRowsPoints - 1) / kRowsPoints);
      const int km = k <= 8 ? 8 : 16;
      const size_t smem =
          (static_cast<size_t>(kRowsPoints) * (d | 1) + static_cast<size_t>(d) * km + km) *
          sizeof(float);
      if (km == 8)
        rows_kernel<T, 8><<<blocks, kRowsPoints, smem, s>>>(pts, ctr, assign, dist, n, d, k);
      else
        rows_kernel<T, 16><<<blocks, kRowsPoints, smem, s>>>(pts, ctr, assign, dist, n, d, k);
      break;
    }
    case kWide:
      wide_kernel<T><<<static_cast<unsigned>(n), kWideThreads, 0, s>>>(pts, ctr, assign, dist,
                                                                         d, k);
      break;
    default: {
      const int bp = tile_points(n);
      const unsigned blocks = static_cast<unsigned>((n + bp - 1) / bp);
      if (bp == 64)
        tiles_kernel<T, 8, 8, 8><<<blocks, kTileThreads, 0, s>>>(pts, ctr, assign, dist, n, d,
                                                                   k);
      else
        tiles_kernel<T, 4, 4, 4><<<blocks, kTileThreads, 0, s>>>(pts, ctr, assign, dist, n, d,
                                                                   k);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// dtype: kF32 or kBF16, the same for points and centers.
extern "C" int kmeans_assign(int dtype, const void* pts, const void* ctr, int* assign,
                             float* dist, long long n, int d, int k, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch<float>(pts, ctr, assign, dist, n, d, k, s);
  return dispatch<__nv_bfloat16>(pts, ctr, assign, dist, n, d, k, s);
}

// The body kmeans_assign takes at (n, d, k): 0 rows, 1 tiles, 2 wide; and for
// tiles the points a CTA (the tests hold ops.py's mirror to it).
extern "C" int kmeans_assign_regime(long long n, int d, int k) {
  const int r = regime(d, k);
  return r == kTiles ? r + 100 * tile_points(n) : r;
}
