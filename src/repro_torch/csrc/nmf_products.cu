// nmf's two products over R, R.Q^T and P^T.R, on the tensor cores in 3xTF32.
//
// Replaces no TPU kernel.  The JAX package leaves these products to XLA
// (src/repro/analytics/nmf.py: `r @ q.T` in _update_p, `p.T @ r` in
// _q_partials); the port's plain path is torch.matmul, which in float32 with
// TF32 off runs cuBLAS's SGEMM on the FFMA pipes and never reaches the
// tensor cores.  Here each operand x = big + small (csrc/mma_tf32.cuh:
// split), and a.b = small.big + big.small + big.big on wgmma TF32, summed in
// fp32: small.small is dropped, ~2^-21 of a product, so the result is
// float32-accurate.
//
// Bound: the read of R.  One thread's slice of the nmf cell is R 120,047 x
// 17,770 fp32 (8.53 GB) against P 120,047 x 64 and Q 64 x 17,770; each
// product reads R once, 2.55 ms at 3.35 TB/s, and is 2.73e11 flops, 1.65 ms
// at 3xTF32's 165 TFLOP/s (495 / 3).  So the design streams R once a
// product and splits it in registers: R is never copied, converted or
// pre-split in device memory.
//
// Both products are one scheme, D (M x 64) = A (M x K) . B (K x 64), with A
// from R and B the small factor:
// * rqt_kernel, R.Q^T (n, k): A = R's rows (K = m, along the rows), B = Q^T.
//   Each CTA owns a contiguous range of R's rows (split evenly over the
//   CTAs, in multiples of 16), walked in chunks of 128 rows against 64 rows
//   of Q (all of nmf's rank) at a time.
// * ptr_kernel, P^T.R (k, m), computed as its transpose R^T.P: A = R's
//   columns (K = n, down the columns), B = P.  Only k x m = 64 x 17,770
//   outputs a thread, so the rows are split: a work item is a tile of 128
//   columns of R over one of S ranges of rows, S chosen so that the items
//   fill the CTAs in whole waves.  A tile's partial sums are added in split
//   order into the output (split s waits for split s - 1's flag), so the
//   sum's order is fixed and two calls give the same bits, with no float
//   atomics.
//
// One launch a product, one CTA an SM, the whole grid resident.  First every
// CTA splits its share of the small factor into device memory (2 x 4 B a
// value: 9.1 MB for Q, 61.5 MB for a thread's P at the cell), already in the
// layout wgmma's descriptors read: tiles of 64 rows (N) x 64 K-floats, big
// then small, K-major and 128-byte swizzled; then a grid barrier.  Then the
// CTA's warpgroups part (warp specialisation, setmaxnreg):
// * warpgroup 0, the producers, only issues copies on the copy engine
//   (cp.async.bulk, completing on each stage's mbarrier): a stage is 64
//   values of K, each of R's tile rows one copy from the 16-byte boundary at
//   or below its first element (R's row pitch at the cell is 71,080 B, 8 mod
//   16, and a slice starts at any row, so TMA's tensor maps cannot address
//   it), and the stage's B tile, one 32 KB copy; three stages deep.
// * warpgroups 1 and 2, the consumers, 64 rows of D each: for each stage
//   they load their A fragments from R's tile (skipping each row's 0-3
//   leading floats; past K's end they read zeros), split them in registers,
//   and issue wgmma.m64n64k8 with A from registers and B from the stage's
//   tile.  In R.Q^T a lane loads its two k values of a row as one float2:
//   A's k slots t and t + 4 hold columns 2t and 2t + 1, and Q's split tiles
//   hold its columns at B's k positions in the same order.
// Copying R with 8-byte cp.async from every thread instead spent most of a
// stage issuing copies, and splitting B in the loop most of the rest.
//
// Sums.  The tensor core's fp32 accumulation truncates (a chain over all of
// K drifts ~2e-4 low over the cell's 17,770 non-negative terms a sum), so a
// chain runs 4 k-steps (12 wgmma) from zero and is added into the running
// sums by rounded adds once it is done; those are added into a second level
// every 8 stages, so no rounded chain is long either.

#include <cstdint>

#include "common.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kProducers = 128;         // warpgroup 0: the copies
constexpr int kConsumers = 256;         // warpgroups 1 and 2: 64 rows of D each
constexpr int kThreads = kProducers + kConsumers;
constexpr int kBK = 64;                 // K a stage
constexpr int kStages = 3;
constexpr int kChain = 4;               // k-steps a tensor-core chain
constexpr int kChains = kBK / 8 / kChain;   // chains a stage
constexpr int kLevel = 8;               // stages summed before the second level
constexpr int kM = 128;                 // D rows a CTA
constexpr int kN = 64;                  // D columns: the small factor's rank, per tile
constexpr int kRowsPerItem = 256;       // an item's fixed cost, in rows, for the split count
constexpr int kMaxSplits = 64;
constexpr int kConsumerBarrier = 1;     // named barrier of the consumers alone
// registers a thread once the roles part (setmaxnreg): the producers only
// issue copies; 128 x 40 + 256 x 232 fit the SM's 65,536
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// R's tile a stage: rows of pitch 72 (R.Q^T: 128 rows of 64 columns) or 136
// (R^T.P: 64 rows of 128 columns) floats, each row copied from the 16-byte
// boundary at or below its first element, so its data start 0 to 3 floats in
constexpr int kRqtLd = kBK + 8;
constexpr int kRqtStage = kM * kRqtLd;                        // floats
constexpr int kPtrLd = kM + 8;
constexpr int kPtrStage = kBK * kPtrLd;                       // floats

// B's tile a stage, split: big then small, each 64 rows (N) x 64 K-floats as
// two 128-byte slabs of 64 rows, 128-byte swizzled; prepared in device
// memory once a call in exactly this layout, a tile after another
constexpr int kSlab = kN * 128;                               // bytes
constexpr int kHalf = 2 * kSlab;
constexpr int kSplitBytes = 2 * kHalf;

constexpr int smem_bytes(int stage_floats) {
  return 1024 + kStages * (kSplitBytes + stage_floats * 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers: a stage's `full` (its copies landed: an arrival a producer
// warp, and their bytes) and `empty` (the consumers done: one a warp) -------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// an arrival that also expects `bytes` more from copies completing on bar
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// `bytes` (a multiple of 16, both addresses 16-byte aligned) global ->
// shared by the copy engine, completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <int N>
__device__ __forceinline__ void regs_down() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_up() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kConsumerBarrier), "n"(kConsumers) : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Byte offset of B's element (n, k) in a half: slab k / 32, row n, its
// 16-byte chunk (k % 32) / 4 at chunk ((k % 32) / 4) ^ (n % 8)
__device__ __forceinline__ int swz(int n, int k) {
  return (k >> 5) * kSlab + n * 128 + ((((k >> 2) & 7) ^ (n & 7)) << 4) + (k & 3) * 4;
}

// Four floats split into big and small, stored as one 16-byte chunk of each
// half of the tile at `tile`
__device__ __forceinline__ void put_split(unsigned char* tile, int off, float x0, float x1,
                                          float x2, float x3) {
  uint4 big, small;
  tf32x3::split(x0, big.x, small.x);
  tf32x3::split(x1, big.y, small.y);
  tf32x3::split(x2, big.z, small.z);
  tf32x3::split(x3, big.w, small.w);
  *reinterpret_cast<uint4*>(tile + off) = big;
  *reinterpret_cast<uint4*>(tile + kHalf + off) = small;
}

// x[r][c] of a row-major matrix (pitch ld), or 0 outside [0, rows) x [0, cols)
__device__ __forceinline__ float at(const float* x, long long ld, long long r, long long c,
                                    long long rows, long long cols) {
  return r < rows && c < cols ? __ldg(x + r * ld + c) : 0.0f;
}

// Every CTA at this point, once each (the grid is resident: no more CTAs
// than the SMs hold): the split tiles written before it are visible to the
// copy engine after it.  count: an int, zero at the launch.
__device__ __forceinline__ void grid_sync(int* count) {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(count, 1);
    while (ld_acquire(count) < static_cast<int>(gridDim.x)) __nanosleep(64);
  }
  __syncthreads();
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// -- the consumers' arithmetic ------------------------------------------------

// A wgmma shared-memory descriptor with 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units), layout type 1
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  constexpr uint32_t lbo = 16, sbo = 1024;
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
// in flight on them
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D8(i)                                                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A.B, A (64 x 8) tf32 from registers (the A-fragment layout), B (8 x
// 64) K-major in shared memory; scale_d == 0 overwrites d
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

#undef WG_D8

using Frags = uint32_t[kChain][2][4];   // a chain's A fragments: [k-step][big, small]

__device__ __forceinline__ void set_a(uint32_t (&a)[2][4], float a0, float a1, float a2,
                                      float a3) {
  tf32x3::split(a0, a[0][0], a[1][0]);
  tf32x3::split(a1, a[0][1], a[1][1]);
  tf32x3::split(a2, a[0][2], a[1][2]);
  tf32x3::split(a3, a[0][3], a[1][3]);
}

// A consumer warpgroup's sums: a chain of kChain k-steps runs on the tensor
// cores into d from zero and is added into lo by rounded adds once it is
// done (ptxas serialises every wgmma of a kernel that reads d while one is
// in flight); lo is added into hi every kLevel stages.
struct Sums {
  float d[32], lo[32], hi[32];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 32; ++i) d[i] = lo[i] = hi[i] = 0.0f;
  }

  // one chain on a stage's B tile (descriptor of its big half) from k-step
  // kk0, then added into lo
  __device__ __forceinline__ void chain(const Frags& a, uint64_t b_big, int kk0) {
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kChain; ++c) {
      const int kk = kk0 + c;
      // k-step kk: slab kk / 4, 32 bytes a k-step along its 128-byte rows
      const uint64_t big = b_big + (((kk >> 2) * kSlab + (kk & 3) * 32) >> 4);
      const uint64_t small = big + (kHalf >> 4);
      wgmma_tf32(d, a[c][1], big, c > 0);
      wgmma_tf32(d, a[c][0], small, 1);
      wgmma_tf32(d, a[c][0], big, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(d);
#pragma unroll
    for (int i = 0; i < 32; ++i) lo[i] += d[i];
  }

  __device__ __forceinline__ void fold() {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      hi[i] += lo[i];
      lo[i] = 0.0f;
    }
  }
};

// The shared memory: the stages' 1024-byte-aligned B tiles, then R's tiles,
// and the stages' mbarriers, initialised before the roles part.
struct Shared {
  unsigned char* tiles;
  float* stages;
  uint64_t* full;
  uint64_t* empty;

  __device__ __forceinline__ Shared(unsigned char* raw, uint64_t* bars) {
    tiles = raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
    stages = reinterpret_cast<float*>(tiles + kStages * kSplitBytes);
    full = bars;
    empty = bars + kStages;
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(full + s, kProducers / 32);
        mbar_init(empty + s, kConsumers / 32);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
};

// The producers' stage g of a CTA's sequence (slot g % kStages): wait for the
// slot's last consumers, then each producer arrives expecting the bytes it
// copies: rows of R's tile (`row(i, src, count)` gives row i's first wanted
// element and how many floats of it, 0 for none), producer p rows p,
// p + kProducers, ...; and producer 0 the stage's B tile (kSplitBytes from
// `tile`).  A row is copied from the 16-byte boundary at or below its start.
template <int ROWS, int LD, typename Row>
__device__ __forceinline__ void produce(const Shared& sh, int g, Row row,
                                        const unsigned char* tile) {
  constexpr int kMine = (ROWS + kProducers - 1) / kProducers;
  const int slot = g % kStages;
  if (g >= kStages) mbar_wait(sh.empty + slot, (g / kStages - 1) & 1);
  const float* src[kMine];
  uint32_t bytes[kMine], total = threadIdx.x == 0 ? kSplitBytes : 0;
#pragma unroll
  for (int j = 0; j < kMine; ++j) {
    const int i = threadIdx.x + j * kProducers;
    int count = 0;
    src[j] = nullptr;
    if (i < ROWS) row(i, src[j], count);
    const uint32_t lead = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(src[j]) & 15);
    bytes[j] = count > 0 ? (lead + 4 * count + 15) & ~15u : 0;
    total += bytes[j];
  }
  total = __reduce_add_sync(0xffffffffu, total);   // one arrival a warp
  if ((threadIdx.x & 31) == 0) mbar_arrive_expect(sh.full + slot, total);
  float* stage = sh.stages + slot * (ROWS * LD);
#pragma unroll
  for (int j = 0; j < kMine; ++j)
    if (bytes[j])
      bulk_copy(stage + (threadIdx.x + j * kProducers) * LD,
                reinterpret_cast<const void*>(reinterpret_cast<uintptr_t>(src[j]) & ~15ull),
                bytes[j], sh.full + slot);
  if (threadIdx.x == 0)
    bulk_copy(sh.tiles + slot * kSplitBytes, tile, kSplitBytes, sh.full + slot);
}

// the data of R's row starting at src begin this many floats into its copy
__device__ __forceinline__ int lead_floats(const float* src) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(src) & 15) >> 2);
}

// A value of R's tile on a last stage: element c of a copied row (`lead`
// floats in), 0 past `valid` (the copy brings whatever lies there)
__device__ __forceinline__ float tile_at(const float* row, int lead, int c, int valid) {
  return c < valid ? row[lead + c] : 0.0f;
}

// ---------------------------------------------------------------------------
// R.Q^T
// ---------------------------------------------------------------------------

// Q (k, m) split into tiles (64 rows of Q, 64 columns), tile (jt, kt) at
// (jt * ktiles + kt) * kSplitBytes: B's k positions kk 8 + 4h + i hold column
// kk 8 + 2i + h, so a lane's A slots t and t + 4 take columns 2t and 2t + 1
__device__ __forceinline__ void prepare_q(unsigned char* tiles, const float* q, long long ldq,
                                          int k, int m, int jtiles, int ktiles) {
  const long long chunks = static_cast<long long>(jtiles) * ktiles * kN * 16;
  for (long long u = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; u < chunks;
       u += static_cast<long long>(gridDim.x) * kThreads) {
    const long long tile = u >> 10;
    const int j = static_cast<int>(u >> 4) & (kN - 1), chunk = static_cast<int>(u) & 15;
    const int jt = static_cast<int>(tile / ktiles), kt = static_cast<int>(tile % ktiles);
    const int kk = chunk >> 1, h = chunk & 1;
    const long long row = static_cast<long long>(jt) * kN + j;
    const long long col = static_cast<long long>(kt) * kBK + kk * 8 + h;
    put_split(tiles + tile * kSplitBytes, swz(j, chunk * 4), at(q, ldq, row, col, k, m),
              at(q, ldq, row, col + 2, k, m), at(q, ldq, row, col + 4, k, m),
              at(q, ldq, row, col + 6, k, m));
  }
}

// r (n, m) with row pitch ldr, q (k, m) with pitch ldq, out (n, k) dense.
// Block x owns rows [x * per, min(n, (x + 1) * per)), for each tile of 64 of
// Q's rows in turn.  tiles: Q split (prepare_q); sync: an int, zero.
__global__ void __launch_bounds__(kThreads, 1)
rqt_kernel(const float* __restrict__ r, long long ldr, const float* __restrict__ q,
           long long ldq, int n, int m, int k, int per, unsigned char* __restrict__ tiles,
           int* __restrict__ sync, float* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bars[2 * kStages];
  const Shared sh(smem_raw, bars);
  const int ktiles = (m + kBK - 1) / kBK, jtiles = (k + kN - 1) / kN;
  prepare_q(tiles, q, ldq, k, m, jtiles, ktiles);
  grid_sync(sync);

  const int wg = threadIdx.x >> 7;
  const int begin = blockIdx.x * per;
  const int end = begin + per < n ? begin + per : n;
  if (wg == 0) {              // the producers: a row of R's tile each
    regs_down<kProducerRegs>();
    int g = 0;
    for (int jt = 0; jt < jtiles; ++jt)
      for (int row0 = begin; row0 < end; row0 += kM)
        for (int kt = 0; kt < ktiles; ++kt, ++g) {
          const int c0 = kt * kBK;
          produce<kM, kRqtLd>(
              sh, g,
              [&](int i, const float*& src, int& count) {
                const bool in = row0 + i < end;
                src = r + static_cast<long long>(in ? row0 + i : begin) * ldr + c0;
                count = in ? (m - c0 < kBK ? m - c0 : kBK) : 0;
              },
              tiles + (static_cast<long long>(jt) * ktiles + kt) * kSplitBytes);
        }
    return;
  }

  // the consumers: warpgroup cw takes rows 64 cw .. 64 cw + 63 of a chunk
  regs_up<kConsumerRegs>();
  const int cw = wg - 1, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const uint64_t b_desc = make_desc(smem_addr(sh.tiles));
  int g = 0;
  for (int jt = 0; jt < jtiles; ++jt)
    for (int row0 = begin; row0 < end; row0 += kM) {
      // this lane's rows r0 and r0 + 8 of the chunk: 8 rows apart, one lead
      const int r0 = cw * 64 + warp * 16 + gq;
      const int lead =
          lead_floats(r + static_cast<long long>(row0 + r0 < end ? row0 + r0 : begin) * ldr);
      const bool pairs = (lead & 1) == 0;
      Sums s;
      s.zero();
      for (int kt = 0; kt < ktiles; ++kt, ++g) {
        const int slot = g % kStages;
        mbar_wait(sh.full + slot, (g / kStages) & 1);
        const float* lo_row = sh.stages + slot * kRqtStage + r0 * kRqtLd;
        const float* hi_row = lo_row + 8 * kRqtLd;
        const int valid = m - kt * kBK;
        const uint64_t b = b_desc + ((slot * kSplitBytes) >> 4);
#pragma unroll
        for (int ch = 0; ch < kChains; ++ch) {
          Frags a;
#pragma unroll
          for (int c = 0; c < kChain; ++c) {
            const int col = (ch * kChain + c) * 8 + 2 * t;
            if (valid < kBK)            // a last stage: columns past m
              set_a(a[c], tile_at(lo_row, lead, col, valid), tile_at(hi_row, lead, col, valid),
                    tile_at(lo_row, lead, col + 1, valid), tile_at(hi_row, lead, col + 1, valid));
            else if (pairs) {           // 8-byte aligned pairs: one float2 a row
              const float2 x = tf32x3::ld2(lo_row + lead + col);
              const float2 y = tf32x3::ld2(hi_row + lead + col);
              set_a(a[c], x.x, y.x, x.y, y.y);
            } else {
              set_a(a[c], lo_row[lead + col], hi_row[lead + col], lo_row[lead + col + 1],
                    hi_row[lead + col + 1]);
            }
          }
          s.chain(a, b, ch * kChain);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(sh.empty + slot);
        if (kt % kLevel == kLevel - 1) s.fold();
      }
      s.fold();
      const int j0 = jt * kN;
#pragma unroll
      for (int jb = 0; jb < kN / 8; ++jb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + r0 + (e >> 1) * 8;
          const int col = j0 + jb * 8 + 2 * t + (e & 1);
          if (row < end && col < k)
            out[static_cast<long long>(row) * k + col] = s.hi[4 * jb + e];
        }
    }
}

// ---------------------------------------------------------------------------
// P^T.R, as R^T.P
// ---------------------------------------------------------------------------

// P (n, k) split into tiles (64 of P's columns, 64 rows), tile (it, kb) at
// (it * kbtiles + kb) * kSplitBytes, B's k positions the rows in order
__device__ __forceinline__ void prepare_p(unsigned char* tiles, const float* p, long long ldp,
                                          int n, int k, int itiles, int kbtiles) {
  const long long chunks = static_cast<long long>(itiles) * kbtiles * kN * 16;
  for (long long u = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; u < chunks;
       u += static_cast<long long>(gridDim.x) * kThreads) {
    const long long tile = u >> 10;
    const int i = static_cast<int>(u >> 4) & (kN - 1), chunk = static_cast<int>(u) & 15;
    const int it = static_cast<int>(tile / kbtiles), kb = static_cast<int>(tile % kbtiles);
    const long long col = static_cast<long long>(it) * kN + i;
    const long long row = static_cast<long long>(kb) * kBK + chunk * 4;
    put_split(tiles + tile * kSplitBytes, swz(i, chunk * 4), at(p, ldp, row, col, n, k),
              at(p, ldp, row + 1, col, n, k), at(p, ldp, row + 2, col, n, k),
              at(p, ldp, row + 3, col, n, k));
  }
}

// An item of P^T.R: split sp of tile (its first P column i0, first R column
// n0), rows [k0, k1); rows is a multiple of kBK, so a stage is a B tile
struct Item {
  int sp, tile, it, i0, n0, k0, k1, ktiles;
  __device__ __forceinline__ Item(int item, int tiles, int tiles_n, int rows, int n) {
    sp = item / tiles;
    tile = item % tiles;
    it = tile / tiles_n;
    i0 = it * kN;
    n0 = (tile % tiles_n) * kM;
    const long long lo = static_cast<long long>(sp) * rows;
    k0 = lo < n ? static_cast<int>(lo) : n;
    k1 = k0 + rows < n ? k0 + rows : n;
    ktiles = (k1 - k0 + kBK - 1) / kBK;
  }
};

// p (n, k) with pitch ldp, r (n, m) with pitch ldr, out (k, m) dense.  Item
// i is split i / tiles of tile i % tiles; split s covers rows [s * rows, (s
// + 1) * rows).  Block b takes items b, b + grid, ...: split s of a tile
// waits only for split s - 1, an earlier item, so the CTA holding the
// earliest unfinished item always runs on.  tiles: P split (prepare_p);
// sync: an int, then a flag a tile, zero.
__global__ void __launch_bounds__(kThreads, 1)
ptr_kernel(const float* __restrict__ p, long long ldp, const float* __restrict__ r,
           long long ldr, int n, int m, int k, int tiles_n, int tiles, int splits, int rows,
           unsigned char* __restrict__ btiles, int* __restrict__ sync, float* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bars[2 * kStages];
  const Shared sh(smem_raw, bars);
  const int kbtiles = (n + kBK - 1) / kBK;
  prepare_p(btiles, p, ldp, n, k, (k + kN - 1) / kN, kbtiles);
  grid_sync(sync);

  const int wg = threadIdx.x >> 7;
  const int items = tiles * splits;
  if (wg == 0) {              // the producers: rows of R's tile, one each
    regs_down<kProducerRegs>();
    int g = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const Item it(item, tiles, tiles_n, rows, n);
      for (int kt = 0; kt < it.ktiles; ++kt, ++g) {
        const int row0 = it.k0 + kt * kBK;
        produce<kBK, kPtrLd>(
            sh, g,
            [&](int i, const float*& src, int& count) {
              const bool in = row0 + i < it.k1;
              src = r + static_cast<long long>(in ? row0 + i : it.k0) * ldr + it.n0;
              count = in ? (m - it.n0 < kM ? m - it.n0 : kM) : 0;
            },
            btiles + (static_cast<long long>(it.it) * kbtiles + it.k0 / kBK + kt) * kSplitBytes);
      }
    }
    return;
  }

  // the consumers: warpgroup cw takes R's columns n0 + 64 cw .. + 63
  regs_up<kConsumerRegs>();
  const int cw = wg - 1, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const uint64_t b_desc = make_desc(smem_addr(sh.tiles));
  int g = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const Item it(item, tiles, tiles_n, rows, n);
    const int c0 = cw * 64 + warp * 16 + gq;       // this lane's columns c0, c0 + 8
    Sums s;
    s.zero();
    for (int kt = 0; kt < it.ktiles; ++kt, ++g) {
      const int slot = g % kStages;
      mbar_wait(sh.full + slot, (g / kStages) & 1);
      const int row0 = it.k0 + kt * kBK;
      const int valid = it.k1 - row0;
      // rows t and t + 4 of each k-step: 4 apart, one lead
      const int lead = lead_floats(
          r + static_cast<long long>(row0 + t < it.k1 ? row0 + t : it.k0) * ldr + it.n0);
      const float* tile = sh.stages + slot * kPtrStage;
      const uint64_t b = b_desc + ((slot * kSplitBytes) >> 4);
#pragma unroll
      for (int ch = 0; ch < kChains; ++ch) {
        Frags a;
#pragma unroll
        for (int c = 0; c < kChain; ++c) {
          const int kr = (ch * kChain + c) * 8 + t;
          const float* lo_row = tile + kr * kPtrLd + lead;
          const float* hi_row = lo_row + 4 * kPtrLd;
          if (valid < kBK)              // a last stage: rows past the split's
            set_a(a[c], kr < valid ? lo_row[c0] : 0.0f, kr < valid ? lo_row[c0 + 8] : 0.0f,
                  kr + 4 < valid ? hi_row[c0] : 0.0f, kr + 4 < valid ? hi_row[c0 + 8] : 0.0f);
          else
            set_a(a[c], lo_row[c0], lo_row[c0 + 8], hi_row[c0], hi_row[c0 + 8]);
        }
        s.chain(a, b, ch * kChain);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(sh.empty + slot);
      if (kt % kLevel == kLevel - 1) s.fold();
    }
    s.fold();

    // the tile's sum in split order: split s adds its partials to the sum
    // of splits 0 .. s - 1 once split s - 1 has raised the tile's flag to s
    int* flag = sync + 1 + it.tile;
    if (it.sp > 0 && threadIdx.x == kProducers)
      while (ld_acquire(flag) < it.sp) __nanosleep(128);
    consumers_sync();
    // the earlier splits' sums first, all loads in flight at once
    float before[32];
#pragma unroll
    for (int jb = 0; jb < kN / 8; ++jb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = it.n0 + c0 + (e >> 1) * 8;
        const int i = it.i0 + jb * 8 + 2 * t + (e & 1);
        before[4 * jb + e] = it.sp > 0 && i < k && col < m
                                 ? __ldcg(out + static_cast<long long>(i) * m + col)
                                 : 0.0f;
      }
#pragma unroll
    for (int jb = 0; jb < kN / 8; ++jb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = it.n0 + c0 + (e >> 1) * 8;
        const int i = it.i0 + jb * 8 + 2 * t + (e & 1);
        if (i < k && col < m)
          __stcg(out + static_cast<long long>(i) * m + col,
                 before[4 * jb + e] + s.hi[4 * jb + e]);
      }
    __threadfence();
    consumers_sync();
    if (threadIdx.x == kProducers) st_release(flag, it.sp + 1);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// CTAs of `kernel` resident at once on the current device for `smem` bytes
// of dynamic shared memory (its limit raised to that once a process and
// device); 0 and the error where a call fails
template <typename Kernel>
int resident_ctas(Kernel kernel, int smem, cudaError_t& e) {
  constexpr int kDevices = 64;
  static int cached[kDevices] = {};
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return 0;
  const bool cache = dev >= 0 && dev < kDevices;
  if (cache && cached[dev] > 0) return cached[dev];
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return 0;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return 0;
  const int n = sms * (per_sm > 0 ? per_sm : 1);
  if (cache) cached[dev] = n;
  return n;
}

bool fits_int(long long x) { return x >= 0 && x < (1ll << 31); }

// the split count: the CTAs run ceil(tiles * S / slots) waves of items of
// ceil(n / S) rows and a fixed cost; the fewest S of least time
int ptr_splits(long long n, long long tiles, long long slots) {
  int best = 1;
  long long best_cost = -1;
  for (int s = 1; s <= kMaxSplits; ++s) {
    const long long rows = (n + s - 1) / s;
    if (s > 1 && rows < 4 * kBK) break;
    const long long cost = (tiles * s + slots - 1) / slots * (rows + kRowsPerItem);
    if (best_cost < 0 || cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

}  // namespace

// Bytes of the scratch nmf_rqt (which 0) or nmf_ptr (which 1) takes at (n, m,
// k): the split tiles of Q or P, then the ints it syncs by (a grid count, and
// for nmf_ptr a flag an output tile)
extern "C" long long nmf_products_scratch(int which, long long n, long long m, long long k) {
  const long long ntiles = (k + kN - 1) / kN;
  if (which == 0) return ntiles * ((m + kBK - 1) / kBK) * kSplitBytes + 16;
  return ntiles * ((n + kBK - 1) / kBK) * kSplitBytes + 4 * (1 + ntiles * ((m + kM - 1) / kM)) +
         16;
}

// out (n, k) = r (n, m) . q (k, m)^T: float32, rows of pitch ldr and ldq
// (elements), out dense; scratch: nmf_products_scratch(0, ...) bytes,
// 16-byte aligned.  n, m, k >= 1.
extern "C" int nmf_rqt(const float* r, long long n, long long m, long long ldr, const float* q,
                       long long k, long long ldq, void* scratch, float* out, void* stream) {
  if (n < 1 || m < 1 || k < 1 || !fits_int(n) || !fits_int(m) || !fits_int(k) || ldr < m ||
      ldq < m || reinterpret_cast<uintptr_t>(r) % 4 || reinterpret_cast<uintptr_t>(scratch) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  constexpr int smem = smem_bytes(kRqtStage);
  cudaError_t e = cudaSuccess;
  const long long slots = resident_ctas(rqt_kernel, smem, e);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tile_bytes = nmf_products_scratch(0, n, m, k) - 16;
  auto* tiles = static_cast<unsigned char*>(scratch);
  int* sync = reinterpret_cast<int*>(tiles + tile_bytes);
  e = cudaMemsetAsync(sync, 0, sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  // rows a CTA: n over the resident CTAs, in multiples of 16
  const long long units = (n + 15) / 16;
  const long long per = (units + slots - 1) / slots * 16;
  const unsigned grid = static_cast<unsigned>((n + per - 1) / per);
  rqt_kernel<<<grid, kThreads, smem, s>>>(r, ldr, q, ldq, static_cast<int>(n),
                                          static_cast<int>(m), static_cast<int>(k),
                                          static_cast<int>(per), tiles, sync, out);
  return static_cast<int>(cudaGetLastError());
}

// out (k, m) = p (n, k)^T . r (n, m): float32, rows of pitch ldp and ldr,
// out dense; scratch: nmf_products_scratch(1, ...) bytes, 16-byte aligned.
// n, m, k >= 1.
extern "C" int nmf_ptr(const float* p, long long n, long long k, long long ldp, const float* r,
                       long long m, long long ldr, void* scratch, float* out, void* stream) {
  if (n < 1 || m < 1 || k < 1 || !fits_int(n) || !fits_int(m) || !fits_int(k) || ldp < k ||
      ldr < m || reinterpret_cast<uintptr_t>(r) % 4 || reinterpret_cast<uintptr_t>(scratch) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  constexpr int smem = smem_bytes(kPtrStage);
  cudaError_t e = cudaSuccess;
  const long long slots = resident_ctas(ptr_kernel, smem, e);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tiles_n = (m + kM - 1) / kM;
  const long long tiles = (k + kN - 1) / kN * tiles_n;
  const int splits = ptr_splits(n, tiles, slots);
  // rows a split: whole stages, so that each stage is one of P's split tiles
  const long long rows = ((n + splits - 1) / splits + kBK - 1) / kBK * kBK;
  const long long tile_bytes = (k + kN - 1) / kN * ((n + kBK - 1) / kBK) * kSplitBytes;
  auto* btiles = static_cast<unsigned char*>(scratch);
  int* sync = reinterpret_cast<int*>(btiles + tile_bytes);
  e = cudaMemsetAsync(sync, 0, sizeof(int) * (1 + tiles), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long items = tiles * splits;
  const unsigned grid = static_cast<unsigned>(items < slots ? items : slots);
  ptr_kernel<<<grid, kThreads, smem, s>>>(
      p, ldp, r, ldr, static_cast<int>(n), static_cast<int>(m), static_cast<int>(k),
      static_cast<int>(tiles_n), static_cast<int>(tiles), splits, static_cast<int>(rows),
      btiles, sync, out);
  return static_cast<int>(cudaGetLastError());
}
