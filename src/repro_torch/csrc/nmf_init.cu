// nmf's initial factors on the card: abs(default_rng(seed).normal(size))
// rounded to float32, numpy's stream bit for bit.
//
// Replaces no TPU kernel.  The JAX package draws nmf's P0 (n, k) and Q0
// (k, m) with numpy on the host, and the port did the same: at the nmf
// cell's 480,189 x 64 that was ~0.9 s of one host core a job while the card
// waited.  The values are part of nmf's result (its trajectories are held to
// the JAX package's), so the kernels below make numpy's own numbers.
//
// numpy's Generator.normal is random_standard_normal (distributions.c) over
// PCG64 (XSL-RR 128/64): each attempt takes one 64-bit word w; idx = w &
// 0xff, rabs = bits 9..60 of w, x = rabs * wi[idx].  If rabs < ki[idx] the
// attempt returns x (the fast path, ~98.5% of words).  Else, for idx != 0,
// it takes one more word u and returns x if (fi[idx-1] - fi[idx]) * u +
// fi[idx] < exp(-x^2 / 2), or starts a new attempt after u (the wedge); for
// idx == 0 it takes pairs of words until yy + yy > xx * xx and returns r +
// xx (the tail).  The tables are numpy's (kernels/nmf_init/ziggurat.py),
// passed in by the wrapper as 768 u64 words: ki, then wi's bits, then fi's.
//
// The stream is one sequence of words; which positions start an attempt
// depends on every slow attempt before them.  In parallel:
//
// * count_kernel, slow_kernel: a CTA classifies a tile of 4,096 positions
//   (a thread 16, 256 apart: each thread jumps the LCG ahead to its first
//   position and then strides by the 256-step map).  slow_kernel lists the
//   tile's slow positions in order, at the tile's offset (scan_kernel over
//   count_kernel's counts), each with what its attempt would do if it were
//   a start: the position after its last word (next), whether it yields a
//   value and the value.
// * resolve_kernel: a slow position that no earlier slow position could
//   reach over (next > it) is certainly a start; from each such head one
//   thread walks its cluster (the slow positions up to the next head:
//   nearly always one), marking starts and the words they consume.  Each
//   start's count of words that yield nothing (its consumed words, and
//   itself if the wedge rejects) is then scanned (scan_kernel), so dex[j]
//   is the count before slow position j.
// * write_kernel: a position p yields the value at index p - (words before
//   p that yield nothing).  A fast position is consumed if the last start
//   before it reaches over it; a slow one yields if it is a start whose
//   attempt yields.  Index i < n0 goes to out0[i], then out1: successive
//   normal() calls continue one stream.  The thread writing the last index
//   sets done: every index below it is written too.
//
// Exactness: the fast path's value is an exact product of an integer below
// 2^52 and a table entry, as numpy's.  The wedge's and the tail's
// arithmetic is numpy's, operation for operation, with __dmul_rn /
// __dadd_rn so that nothing is contracted into an fma; exp and log1p are
// CUDA's, which may differ from the host libm's in the last bit, so the
// wrapper's callers hold the results to numpy's.
//
// Bound: the 4 B a value written (127 MB at the nmf cell) and the three
// passes' integer work on 128-bit states; the wrapper sizes the stream
// (n_words) and the slow list (cap) from the value count, with a shortfall
// out of reach, and done stays 0 on one.

#include <cstdint>

#include "common.cuh"

namespace {

typedef unsigned __int128 u128;
typedef unsigned long long u64;

constexpr int kThreads = 256;                 // a tile's CTA
constexpr int kRun = 16;                      // positions a thread, kThreads apart
constexpr long long kTile = kThreads * kRun;  // positions a tile
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr int kMaxTailTries = 64;             // a try is rejected with p ~0.06
constexpr int kBroken = 1 << 30;              // reach past every stream: the tail ran out
constexpr int kYield = 1, kStart = 2;         // flags of a slow position
constexpr double kNorR = 3.6541528853610087963519472518;
constexpr double kNorInvR = 0.27366123732975827203338247596;
constexpr double kTo01 = 1.0 / 9007199254740992.0;    // 2^-53
constexpr u64 kRabsMask = (1ull << 52) - 1;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ u128 pcg_mult() {
  return (static_cast<u128>(0x2360ED051FC65DA4ull) << 64) | 0x4385DF649FCCF645ull;
}

__device__ __forceinline__ u128 load_u128(const u64* p) {
  return (static_cast<u128>(p[1]) << 64) | p[0];
}

__device__ __forceinline__ u64 xsl_rr(u128 s) {
  const u64 hi = static_cast<u64>(s >> 64), lo = static_cast<u64>(s);
  const unsigned rot = static_cast<unsigned>(hi >> 58);
  const u64 x = hi ^ lo;
  return (x >> rot) | (x << ((64u - rot) & 63u));
}

// The state delta steps after s.
__device__ u128 advance(u128 s, u128 inc, u64 delta) {
  u128 am = 1, ap = 0, cm = pcg_mult(), cp = inc;
  while (delta) {
    if (delta & 1) {
      am *= cm;
      ap = ap * cm + cp;
    }
    cp = (cm + 1) * cp;
    cm *= cm;
    delta >>= 1;
  }
  return am * s + ap;
}

__device__ __forceinline__ u64 rabs_of(u64 w) { return (w >> 9) & kRabsMask; }

__device__ __forceinline__ double unit(u64 w) {    // numpy's next_double
  return static_cast<double>(w >> 11) * kTo01;
}

// The tables in shared memory; ki alone where only the class is needed.
struct Tables {
  u64 ki[256];
  double wi[256];
  double fi[256];
};

__device__ __forceinline__ void load_tables(Tables& t, const u64* tables, bool all) {
  static_assert(kThreads == 256, "one table entry a thread");
  const int i = threadIdx.x;
  t.ki[i] = tables[i];
  if (all) {
    t.wi[i] = __longlong_as_double(static_cast<long long>(tables[256 + i]));
    t.fi[i] = __longlong_as_double(static_cast<long long>(tables[512 + i]));
  }
  __syncthreads();
}

__device__ __forceinline__ bool is_slow(u64 w, const u64* ki) {
  return rabs_of(w) >= ki[w & 0xff];
}

// The attempt a slow word w starts, s being the state that gave w: the
// words it takes (w included), whether it yields, and |value| as float32.
__device__ void slow_attempt(u128 s, u128 inc, u64 w, const Tables& t, int& taken,
                             bool& yields, float& value) {
  const int idx = static_cast<int>(w & 0xff);
  const double x = __dmul_rn(static_cast<double>(rabs_of(w)), t.wi[idx]);
  const u128 m = pcg_mult();
  if (idx != 0) {
    s = m * s + inc;
    const double y = __dadd_rn(__dmul_rn(__dsub_rn(t.fi[idx - 1], t.fi[idx]), unit(xsl_rr(s))),
                               t.fi[idx]);
    yields = y < exp(__dmul_rn(__dmul_rn(-0.5, x), x));
    taken = 2;
    value = __double2float_rn(x);
    return;
  }
  for (int tries = 1; tries <= kMaxTailTries; ++tries) {
    s = m * s + inc;
    const double u1 = unit(xsl_rr(s));
    s = m * s + inc;
    const double u2 = unit(xsl_rr(s));
    const double xx = __dmul_rn(-kNorInvR, log1p(-u1));
    const double yy = -log1p(-u2);
    if (__dadd_rn(yy, yy) > __dmul_rn(xx, xx)) {
      taken = 1 + 2 * tries;
      yields = true;
      value = __double2float_rn(__dadd_rn(kNorR, xx));
      return;
    }
  }
  taken = kBroken;
  yields = false;
  value = 0.f;
}

// This thread's rank among the CTA's threads with flag set and a lower
// index, and the CTA's count; counts is [2][kWarps], alternated by parity,
// so one barrier an iteration keeps a fast warp from overwriting counts a
// slow one still reads.
__device__ __forceinline__ int block_rank(bool flag, int* counts, int parity, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(kFull, flag);
  int* c = counts + parity * kWarps;
  if (lane == 0) c[warp] = __popc(ballot);
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    before += k < warp ? c[k] : 0;
    total += c[k];
  }
  return before + __popc(ballot & ((1u << lane) - 1u));
}

struct Stream {
  u128 state, inc, m256, p256;
};

__device__ __forceinline__ Stream load_stream(const u64* params) {
  return {load_u128(params), load_u128(params + 2), load_u128(params + 4),
          load_u128(params + 6)};
}

// counts[tile] = the tile's slow positions.
__global__ void __launch_bounds__(kThreads)
count_kernel(const u64* __restrict__ params, const u64* __restrict__ tables, long long n_words,
             int* __restrict__ counts) {
  __shared__ Tables t;
  __shared__ int warp_counts[kWarps];
  load_tables(t, tables, false);
  const Stream st = load_stream(params);
  const long long first = blockIdx.x * kTile + threadIdx.x;
  u128 s = advance(st.state, st.inc, static_cast<u64>(first) + 1);
  int c = 0;
  for (int i = 0; i < kRun; ++i) {
    const long long pos = first + static_cast<long long>(i) * kThreads;
    c += pos < n_words && is_slow(xsl_rr(s), t.ki);
    s = st.m256 * s + st.p256;
  }
  for (int o = 16; o; o >>= 1) c += __shfl_xor_sync(kFull, c, o);
  if ((threadIdx.x & 31) == 0) warp_counts[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int k = 0; k < kWarps; ++k) sum += warp_counts[k];
    counts[blockIdx.x] = sum;
  }
}

// a[0..n) to its exclusive prefix sums in place, the total to a[n]; with
// n_dev, n is *n_dev, and nothing is done if that exceeds the room n.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(int* __restrict__ a, int n, const int* __restrict__ n_dev) {
  __shared__ int warp_totals[kScanThreads / 32];
  if (n_dev) {
    const int m = *n_dev;
    if (m > n) return;
    n = m;
  }
  const int per = (n + kScanThreads - 1) / kScanThreads;
  const int lo = min(n, static_cast<int>(threadIdx.x) * per), hi = min(n, lo + per);
  int sum = 0;
  for (int k = lo; k < hi; ++k) sum += a[k];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_totals[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = warp_totals[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, v, o);
      if (lane >= o) v += u;
    }
    warp_totals[lane] = v;
  }
  __syncthreads();
  int run = incl - sum + (warp ? warp_totals[warp - 1] : 0);
  for (int k = lo; k < hi; ++k) {
    const int v = a[k];
    a[k] = run;
    run += v;
  }
  if (threadIdx.x == kScanThreads - 1) a[n] = run;
}

// The slow table's arrays, each of cap entries (dex cap + 1).
struct Slow {
  int *pos, *next, *flags, *vals, *dex;
};

__device__ __forceinline__ Slow slow_table(int* base, int cap) {
  return {base, base + cap, base + 2 * static_cast<long long>(cap),
          base + 3 * static_cast<long long>(cap), base + 4 * static_cast<long long>(cap)};
}

// Each slow position of the tile, in order, at offsets[tile] + its rank:
// its position, the position after its attempt, kYield if it would yield,
// its value's bits; the largest reach (next - pos) into *reach.
__global__ void __launch_bounds__(kThreads)
slow_kernel(const u64* __restrict__ params, const u64* __restrict__ tables, long long n_words,
            const int* __restrict__ offsets, int cap, int* __restrict__ slow_base,
            int* __restrict__ reach) {
  __shared__ Tables t;
  __shared__ int counts[2 * kWarps];
  load_tables(t, tables, true);
  const Stream st = load_stream(params);
  const Slow sl = slow_table(slow_base, cap);
  const long long first = blockIdx.x * kTile + threadIdx.x;
  u128 s = advance(st.state, st.inc, static_cast<u64>(first) + 1);
  int running = offsets[blockIdx.x], my_reach = 1;
  for (int i = 0; i < kRun; ++i) {
    const long long pos = first + static_cast<long long>(i) * kThreads;
    const u64 w = xsl_rr(s);
    const bool slow = pos < n_words && is_slow(w, t.ki);
    int total;
    const int j = running + block_rank(slow, counts, i & 1, total);
    if (slow && j < cap) {
      int taken;
      bool yields;
      float value;
      slow_attempt(s, st.inc, w, t, taken, yields, value);
      sl.pos[j] = static_cast<int>(pos);
      sl.next[j] = taken >= kBroken ? kBroken : static_cast<int>(pos) + taken;
      sl.flags[j] = yields ? kYield : 0;
      sl.vals[j] = __float_as_int(value);
      my_reach = max(my_reach, taken);
    }
    running += total;
    s = st.m256 * s + st.p256;
  }
  if (my_reach > 1) atomicMax(reach, my_reach);
}

// Whether slow position i is a head: no earlier slow position reaches
// over it, were it a start.
__device__ __forceinline__ bool is_head(const Slow& sl, int i, int reach) {
  const int p = sl.pos[i];
  for (int j = i - 1; j >= 0 && sl.pos[j] > p - reach; --j)
    if (sl.next[j] > p) return false;
  return true;
}

// From each head, its cluster: kStart on each start, and dex[j] = the words
// start j takes that yield nothing (0 for a consumed slow position).
__global__ void __launch_bounds__(kThreads)
resolve_kernel(const int* __restrict__ count, int cap, int* __restrict__ slow_base,
               const int* __restrict__ reach_p) {
  const int n = *count, reach = *reach_p;
  if (n > cap || reach >= kBroken) return;
  const Slow sl = slow_table(slow_base, cap);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n || !is_head(sl, i, reach)) return;
  for (int cur = i;;) {
    const int f = sl.flags[cur] | kStart;
    sl.flags[cur] = f;
    const int nx = sl.next[cur];
    sl.dex[cur] = nx - sl.pos[cur] - (f & kYield);
    int j = cur + 1;
    for (; j < n && sl.pos[j] < nx; ++j) sl.dex[j] = 0;
    if (j >= n || is_head(sl, j, reach)) break;
    cur = j;
  }
}

__device__ __forceinline__ void put(long long index, float v, float* out0, long long n0,
                                    float* out1, long long n1, int* done) {
  if (index < n0)
    out0[index] = v;
  else if (index < n0 + n1)
    out1[index - n0] = v;
  if (index == n0 + n1 - 1) *done = 1;
}

// Every position's value, where it yields one, at its index.
__global__ void __launch_bounds__(kThreads)
write_kernel(const u64* __restrict__ params, const u64* __restrict__ tables, long long n_words,
             const int* __restrict__ offsets, int cap, int* __restrict__ slow_base,
             const int* __restrict__ reach, float* __restrict__ out0, long long n0,
             float* __restrict__ out1, long long n1, int* __restrict__ done) {
  const int n = offsets[(n_words + kTile - 1) / kTile];
  if (n > cap || *reach >= kBroken) return;
  __shared__ Tables t;
  __shared__ int counts[2 * kWarps];
  load_tables(t, tables, true);
  const Stream st = load_stream(params);
  const Slow sl = slow_table(slow_base, cap);
  const long long first = blockIdx.x * kTile + threadIdx.x;
  u128 s = advance(st.state, st.inc, static_cast<u64>(first) + 1);
  int running = offsets[blockIdx.x];
  for (int i = 0; i < kRun; ++i) {
    const long long pos = first + static_cast<long long>(i) * kThreads;
    const u64 w = xsl_rr(s);
    const bool in = pos < n_words;
    const bool slow = in && is_slow(w, t.ki);
    int total;
    const int j = running + block_rank(slow, counts, i & 1, total);   // first slow >= pos
    if (slow) {
      if (sl.flags[j] == (kStart | kYield))
        put(pos - sl.dex[j], __int_as_float(sl.vals[j]), out0, n0, out1, n1, done);
    } else if (in) {
      int k = j - 1;                       // the last start before pos
      while (k >= 0 && !(sl.flags[k] & kStart)) --k;
      if (k < 0 || sl.next[k] <= pos) {
        const long long index = k < 0 ? pos : pos - sl.dex[k + 1];
        put(index, __double2float_rn(__dmul_rn(static_cast<double>(rabs_of(w)), t.wi[w & 0xff])),
            out0, n0, out1, n1, done);
      }
    }
    running += total;
    s = st.m256 * s + st.p256;
  }
}

int tiles(long long n_words) { return static_cast<int>((n_words + kTile - 1) / kTile); }

}  // namespace

// params: 8 u64, the stream's state, inc, and the 256-step map (mult,
// plus), each 128 bits low word first.  tables: 768 u64 (ki, wi, fi).
// counts: tiles(n_words) + 1 int32.
extern "C" int nmf_init_count(const u64* params, const u64* tables, long long n_words,
                              int* counts, void* stream) {
  if (n_words <= 0) return 0;
  count_kernel<<<tiles(n_words), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      params, tables, n_words, counts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nmf_init_scan(int* a, int n, const int* n_dev, void* stream) {
  scan_kernel<<<1, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(a, n, n_dev);
  return static_cast<int>(cudaGetLastError());
}

// slow: 5 * cap + 1 int32 (pos, next, flags, vals, dex); reach: 1 int32 >= 1.
extern "C" int nmf_init_slow(const u64* params, const u64* tables, long long n_words,
                             const int* offsets, int cap, int* slow, int* reach, void* stream) {
  if (n_words <= 0) return 0;
  slow_kernel<<<tiles(n_words), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      params, tables, n_words, offsets, cap, slow, reach);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nmf_init_resolve(const int* count, int cap, int* slow, const int* reach,
                                void* stream) {
  resolve_kernel<<<(cap + kThreads - 1) / kThreads, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(count, cap, slow, reach);
  return static_cast<int>(cudaGetLastError());
}

// out0 (n0,), out1 (n1,) float32; done: 1 int32, zero before the call.
extern "C" int nmf_init_write(const u64* params, const u64* tables, long long n_words,
                              const int* offsets, int cap, int* slow, const int* reach,
                              float* out0, long long n0, float* out1, long long n1, int* done,
                              void* stream) {
  if (n_words <= 0) return 0;
  write_kernel<<<tiles(n_words), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      params, tables, n_words, offsets, cap, slow, reach, out0, n0, out1, n1, done);
  return static_cast<int>(cudaGetLastError());
}
