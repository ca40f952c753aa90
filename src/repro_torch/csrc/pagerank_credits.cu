// PageRank's credit sum by destination bins (propagation blocking).
//
// Replaces no TPU kernel.  The JAX package leaves pagerank's credits to
// XLA's scatter; the port's plain version (analytics/pagerank.py _credits:
// two gathers over int64 indices, a division and a cast an edge, then an
// fp64 index_add_) held 86% of the pagerank cell's device time, most of it
// one fp64 atomic an edge at a random address in device memory.
//
// Two parts, both over one thread's slice of the edge list, (E, 2) int32 or
// int64 rows (source, destination):
//
// * The set-up pass, once a job: a counting sort of the slice on the
//   destination's high bits (bin = dst >> shift, bins of 2^shift vertices).
//   bin_histogram_kernel counts each bin's edges (and the edges with an
//   index outside [0, V), which the wrapper raises on); the host scans the
//   counts into bin starts and plans the work items; bin_scatter_kernel
//   groups the edges into an int32 (src, dst) copy by dst >> shift.  Each
//   CTA takes a chunk of edges, counts it by group in shared memory,
//   reserves its range in each group with one global atomic a group, and
//   scatters.  A chunk spread over all 8,192 bins writes runs of a few
//   edges a bin, partial sectors scattered over the whole copy: one such
//   pass took 19.3 ms a slice at the cell on an H100, the two below 11.6.
//   So the wrapper scatters twice: by buckets of 128 bins into a staging
//   copy (runs of hundreds of edges), then that copy by bin (a chunk lies
//   in one or two buckets), a segment of the slice at a time so that the
//   staging copy stays small.  The caller's slice is only read.
//
// * The round, one launch: credits_kernel takes one work item a CTA, a bin
//   or a piece of one.  Its CTA zeroes the bin's fp64 partials in shared
//   memory (2^shift doubles: 64 KB at shift 13, three CTAs an SM), streams
//   the item's pairs (coalesced, evict-first), gathers w[src] (fp32, w =
//   ranks / out_deg per vertex), widens it to fp64 and adds it into the
//   partial of dst with a shared-memory atomic.  A whole bin then rounds
//   each partial once to fp32 and writes its credits.  A bin the histogram
//   shows far above the mean (the host's plan) is cut into pieces of about
//   the mean: each piece adds its nonzero partials into an fp64 scratch row
//   in device memory (L2 atomics), and the piece that finishes last rounds
//   that row to fp32, writes the credits and zeroes the row and its count
//   for the next launch.  The sum is fp64 from the first add to the one
//   rounding: no fp32 partial anywhere.  Every vertex lies in exactly one
//   bin, so every credit is written exactly once.  The order of the fp64
//   adds varies from run to run, so a credit may differ by one fp32 ulp
//   between runs, as the fp64 index_add_'s atomics do.
//
// Bound: device memory.  A round streams 8 B of pairs an edge and reads w
// and writes the credits once (4 B + 4 B a vertex): for the pagerank cell
// (4 slices of 268,435,456 edges, V = 67,108,864) 10.7 GB an iteration,
// 3.2 ms at 3.35 TB/s.  What bounds it instead is the gather of w[src]: a
// random 4-byte read an edge from a 268 MB vector that L2 holds only in
// part, one DRAM sector an edge.  The design keeps everything else off
// device memory: no E-sized temporary, the sums on chip, no atomic in
// device memory but the split bins' merge; work items run largest first,
// so the split pieces are not the tail.

#include <atomic>
#include <cstdint>

#include "common.cuh"

constexpr int kBinThreads = 1024;       // the set-up pass
constexpr int kMaxSharedBins = 16384;   // bins counted in shared memory (64 KB)
constexpr long long kScatterChunk = kBinThreads * 32;    // edges a scatter CTA
constexpr int kCreditThreads = 512;     // the round
constexpr int kUnroll = 4;              // edges a thread has in flight
constexpr int kMaxShift = 13;           // 2^13 fp64 partials: 64 KB

template <typename I> struct PairOf;
template <> struct PairOf<int> { using T = int2; };
template <> struct PairOf<long long> { using T = longlong2; };

// Edge e of a (E, 2) row-major slice, streamed (read once, evict first).
template <typename I>
__device__ __forceinline__ void load_edge(const I* edges, long long e, long long& s,
                                          long long& d) {
  const auto p = __ldcs(reinterpret_cast<const typename PairOf<I>::T*>(edges) + e);
  s = p.x;
  d = p.y;
}

// counts[b] += edges of bin b; counts[n_bins] += edges with an index outside
// [0, V) (not binned).  Bins counted in shared memory where they fit.
template <typename I>
__global__ void __launch_bounds__(kBinThreads)
bin_histogram_kernel(const I* __restrict__ edges, long long n_edges, long long n_vertices,
                     int shift, int n_bins, unsigned long long* __restrict__ counts) {
  extern __shared__ unsigned int hist[];
  const bool local = n_bins <= kMaxSharedBins;
  if (local) {
    for (int b = threadIdx.x; b < n_bins; b += blockDim.x) hist[b] = 0;
    __syncthreads();
  }
  unsigned long long bad = 0;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n_edges; e += step) {
    long long s, d;
    load_edge(edges, e, s, d);
    if (s < 0 || s >= n_vertices || d < 0 || d >= n_vertices) {
      ++bad;
      continue;
    }
    const int b = static_cast<int>(d >> shift);
    if (local)
      atomicAdd(hist + b, 1u);
    else
      atomicAdd(counts + b, 1ull);
  }
  if (bad) atomicAdd(counts + n_bins, bad);
  if (local) {
    __syncthreads();
    for (int b = threadIdx.x; b < n_bins; b += blockDim.x)
      if (hist[b]) atomicAdd(counts + b, static_cast<unsigned long long>(hist[b]));
  }
}

// Each edge of the CTA's chunk to cursor[group] + its rank in the chunk's
// share of the group (group = dst >> shift, n_bins groups).  cursor starts
// at the groups' starts and ends at their ends.  Every index was checked
// by the histogram.
template <typename I>
__global__ void __launch_bounds__(kBinThreads)
bin_scatter_kernel(const I* __restrict__ edges, long long n_edges, int shift, int n_bins,
                   unsigned long long* __restrict__ cursor, int2* __restrict__ out) {
  const long long lo = static_cast<long long>(blockIdx.x) * kScatterChunk;
  const long long hi = lo + kScatterChunk < n_edges ? lo + kScatterChunk : n_edges;
  long long s, d;
  if (n_bins > kMaxSharedBins) {   // a global atomic an edge
    for (long long e = lo + threadIdx.x; e < hi; e += blockDim.x) {
      load_edge(edges, e, s, d);
      out[atomicAdd(cursor + (d >> shift), 1ull)] =
          make_int2(static_cast<int>(s), static_cast<int>(d));
    }
    return;
  }
  extern __shared__ unsigned long long base[];   // n_bins, then fill
  unsigned int* fill = reinterpret_cast<unsigned int*>(base + n_bins);
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) fill[b] = 0;
  __syncthreads();
  for (long long e = lo + threadIdx.x; e < hi; e += blockDim.x) {
    load_edge(edges, e, s, d);
    atomicAdd(fill + (d >> shift), 1u);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) {
    const unsigned int n = fill[b];
    base[b] = n ? atomicAdd(cursor + b, static_cast<unsigned long long>(n)) : 0ull;
    fill[b] = 0;
  }
  __syncthreads();
  for (long long e = lo + threadIdx.x; e < hi; e += blockDim.x) {
    load_edge(edges, e, s, d);
    const int b = static_cast<int>(d >> shift);
    out[base[b] + atomicAdd(fill + b, 1u)] = make_int2(static_cast<int>(s), static_cast<int>(d));
  }
}

// One work item a CTA: items[4 i .. 4 i + 3] = begin, end (edges of the
// binned copy), bin, slot (-1: the item is the whole bin; else the bin's
// scratch row, shared by its pieces[slot] pieces).  acc (slots x 2^shift
// fp64) and done (slots) are zero before the launch and after it.
__global__ void __launch_bounds__(kCreditThreads, 3)
credits_kernel(const int2* __restrict__ pairs, const long long* __restrict__ items,
               const float* __restrict__ w, long long n_vertices, int shift,
               double* __restrict__ acc, unsigned int* __restrict__ done,
               const long long* __restrict__ pieces, float* __restrict__ out) {
  extern __shared__ double part[];
  __shared__ bool last;
  const long long* item = items + 4 * static_cast<long long>(blockIdx.x);
  const long long begin = item[0], end = item[1];
  const int slot = static_cast<int>(item[3]);
  const long long v0 = item[2] << shift;
  const long long rest = n_vertices - v0;
  const int nv = rest < (1ll << shift) ? static_cast<int>(rest) : 1 << shift;
  const int first = static_cast<int>(v0);   // v0 < 2^31
  for (int i = threadIdx.x; i < nv; i += blockDim.x) part[i] = 0.0;
  __syncthreads();

  const long long stride = blockDim.x;
  long long e = begin + threadIdx.x;
  for (; e + (kUnroll - 1) * stride < end; e += kUnroll * stride) {
    int2 p[kUnroll];
    float x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) p[u] = __ldcs(pairs + e + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) x[u] = __ldg(w + p[u].x);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) atomicAdd(part + (p[u].y - first), static_cast<double>(x[u]));
  }
  for (; e < end; e += stride) {
    const int2 p = __ldcs(pairs + e);
    atomicAdd(part + (p.y - first), static_cast<double>(__ldg(w + p.x)));
  }
  __syncthreads();

  if (slot < 0) {
    for (int i = threadIdx.x; i < nv; i += blockDim.x) out[v0 + i] = __double2float_rn(part[i]);
    return;
  }
  double* row = acc + (static_cast<long long>(slot) << shift);
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    const double y = part[i];
    if (y != 0.0) atomicAdd(row + i, y);   // adding +0.0 changes no sum
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(done + slot, 1u) == static_cast<unsigned>(pieces[slot]) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    out[v0 + i] = __double2float_rn(__ldcg(row + i));
    row[i] = 0.0;
  }
  if (threadIdx.x == 0) done[slot] = 0;
}

// SMs of a device, asked of the runtime once per device.
static int sm_count(int device) {
  static std::atomic<int> cached[64];
  const bool cache = device >= 0 && device < 64;
  int sms = cache ? cached[device].load(std::memory_order_relaxed) : 0;
  if (sms == 0) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (cache) cached[device].store(sms, std::memory_order_relaxed);
  }
  return sms;
}

// Dynamic shared memory above 48 KB, allowed before each launch (the
// attribute belongs to the function on the current device).
template <typename K>
static int allow_shared(K kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <typename I>
static int histogram(const void* edges, long long n_edges, long long n_vertices, int shift,
                     int n_bins, unsigned long long* counts, cudaStream_t s) {
  if (n_edges == 0) return 0;
  const int attr = allow_shared(bin_histogram_kernel<I>,
                                kMaxSharedBins * static_cast<int>(sizeof(unsigned int)));
  if (attr) return attr;
  int device = 0;
  cudaGetDevice(&device);
  long long blocks = (n_edges + kBinThreads - 1) / kBinThreads;
  const long long cap = 2ll * sm_count(device);
  if (blocks > cap) blocks = cap;
  const int smem = n_bins <= kMaxSharedBins ? n_bins * static_cast<int>(sizeof(unsigned int)) : 0;
  bin_histogram_kernel<I><<<static_cast<unsigned>(blocks), kBinThreads, smem, s>>>(
      static_cast<const I*>(edges), n_edges, n_vertices, shift, n_bins, counts);
  return static_cast<int>(cudaGetLastError());
}

template <typename I>
static int scatter(const void* edges, long long n_edges, int shift, int n_bins,
                   unsigned long long* cursor, int2* out, cudaStream_t s) {
  constexpr int kSlot = sizeof(unsigned long long) + sizeof(unsigned int);
  if (n_edges == 0) return 0;
  const int attr = allow_shared(bin_scatter_kernel<I>, kMaxSharedBins * kSlot);
  if (attr) return attr;
  const long long blocks = (n_edges + kScatterChunk - 1) / kScatterChunk;
  const int smem = n_bins <= kMaxSharedBins ? n_bins * kSlot : 0;
  bin_scatter_kernel<I><<<static_cast<unsigned>(blocks), kBinThreads, smem, s>>>(
      static_cast<const I*>(edges), n_edges, shift, n_bins, cursor, out);
  return static_cast<int>(cudaGetLastError());
}

// index_kind: 0 int32, 1 int64.  counts: n_bins + 1 zeroed u64.
extern "C" int pagerank_bin_histogram(int index_kind, const void* edges, long long n_edges,
                                      long long n_vertices, int shift, int n_bins,
                                      unsigned long long* counts, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (index_kind == 0) return histogram<int>(edges, n_edges, n_vertices, shift, n_bins, counts, s);
  return histogram<long long>(edges, n_edges, n_vertices, shift, n_bins, counts, s);
}

// cursor: n_bins u64, the starts of the groups dst >> shift (their ends after
// the call); out: (E, 2) int32.
extern "C" int pagerank_bin_scatter(int index_kind, const void* edges, long long n_edges,
                                    int shift, int n_bins, unsigned long long* cursor, void* out,
                                    void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  int2* o = static_cast<int2*>(out);
  if (index_kind == 0) return scatter<int>(edges, n_edges, shift, n_bins, cursor, o, s);
  return scatter<long long>(edges, n_edges, shift, n_bins, cursor, o, s);
}

// One launch: every credit of the V vertices, out (V,) float32.
extern "C" int pagerank_credits(const void* pairs, const long long* items, int n_items,
                                const float* w, long long n_vertices, int shift, double* acc,
                                unsigned int* done, const long long* pieces, float* out,
                                void* stream) {
  if (shift < 0 || shift > kMaxShift) return static_cast<int>(cudaErrorInvalidValue);
  if (n_items == 0) return 0;
  const int attr = allow_shared(credits_kernel, static_cast<int>(sizeof(double)) << kMaxShift);
  if (attr) return attr;
  const int smem = static_cast<int>(sizeof(double)) << shift;
  credits_kernel<<<static_cast<unsigned>(n_items), kCreditThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int2*>(pairs), items, w, n_vertices, shift, acc, done, pieces, out);
  return static_cast<int>(cudaGetLastError());
}
