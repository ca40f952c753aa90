// fp32 products on Hopper's tensor cores in 3xTF32 (mma.sync.m16n8k8), and
// the cp.async staging that feeds them.
//
// Each operand x = big + small: big = tf32(x), rounded as cvt.rna.tf32.f32
// rounds (to nearest, ties away from zero, 10 mantissa bits), and small = x -
// big, exact in fp32, handed to the tensor core as it is: an mma on .tf32
// operands reads a register's top 19 bits, so small is truncated to TF32
// there (CUTLASS's 3xTF32 hands over its small half the same way).  a.b =
// small.big + big.small + big.big, summed in fp32: the product of two TF32
// numbers is exact in fp32, so what is lost is small.small and small's
// truncation, each ~2^-21 of the product.  big's rounding is the fp32 flash
// body's (csrc/flash_attention.cu, namespace tc), which also rounds small.
//
// Fragment layouts of m16n8k8 (lane = 4g + t): A (16 x 8, row) a0 = A[g][t],
// a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4]; B (8 x 8, col) b0 =
// B[t][g], b1 = B[t+4][g]; C/D (16 x 8) c0 = C[g][2t], c1 = C[g][2t+1], c2 =
// C[g+8][2t], c3 = C[g+8][2t+1].  Which k a register holds is the caller's
// choice as long as A and B agree: the kernels map k = t, t + 4 to two
// adjacent columns or rows, so one 8- or 16-byte load fills two registers.
#pragma once

#include <stdint.h>

namespace tf32x3 {

// cvt.rna.tf32.f32 as two integer operations: add half a TF32 ulp to the
// magnitude and truncate (the same bits as the instruction for every finite
// or infinite x; the instruction compiles to four, with an Inf/NaN check)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small: big TF32, small = x - big in fp32 bits (the mma reads
// its next 11 bits; three operations where rounding small too takes five)
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
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

// A B fragment (8 x 8) as big and small halves, for a B that meets several A.
struct FragB {
  uint32_t big[2], small[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split(b0, big[0], small[0]);
    split(b1, big[1], small[1]);
  }
};

// d += a.b in 3xTF32: the two small terms first, then big.big
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma(d, a.small, b.big[0], b.big[1]);
  mma(d, a.big, b.small[0], b.small[1]);
  mma(d, a.big, b.big[0], b.big[1]);
}

__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, float b0, float b1) {
  FragB b;
  b.set(b0, b1);
  mma3(d, a, b);
}

// 16 bytes global -> shared, bypassing L1 (src-size 0 writes zeros)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes global -> shared (for rows that are not 16-byte aligned)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// all but the newest `pending` committed groups have landed
template <int pending>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

}  // namespace tf32x3
