// PTX helpers of the tensor-core kernels (bfloat16: conv3x3_fwd_tc.cu K1,
// conv3x3_bwd_tc.cu K2, conv3x3_bwd_dx_tc.cu K3, conv3x3_bwd_dw_tc.cu K4;
// float32: conv3x3_fwd_f32_tc.cu K1): ldmatrix fragment loads from shared
// memory, the mma.sync.m16n8k16 bf16 product with float32 sums, the
// mma.sync.m16n8k8 tf32 product and the big / small split of a float32
// value into two tf32 values (3xTF32), cp.async copies, and g' formed from
// packed bfloat16 pairs while staging.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace stroke {
namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 matrices of 16-bit elements; on float32 data a 16-byte row is 4
// floats, and lane l receives float l % 4 of row l / 4 of each matrix.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a * b for one 16x8x16 product: a row-major 16x16, b column-major
// 16x8 (k contiguous), d 16x8 float32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v rounded to tf32 by cvt.rna.tf32.f32: to nearest, ties away from zero,
// a 10-bit mantissa, the low 13 bits of the result zero.
__device__ __forceinline__ unsigned tf32_rna(float v) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// The 3xTF32 split: big = tf32(v), small = tf32(v - big); v - big - small
// is at most about 2^-22 |v|.
__device__ __forceinline__ void split_tf32(float v, unsigned& big,
                                           unsigned& small) {
  big = tf32_rna(v);
  small = tf32_rna(v - __uint_as_float(big));
}

// d += a * b for one 16x8x8 product: a row-major 16x8, b column-major 8x8
// (k contiguous), all tf32; d 16x8 float32 (the same layout as m16n8k16's).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes from global to shared memory; zeros when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 8 bytes (a float pair) from global to shared memory; zeros when !valid.
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

// 4 bytes (a bf16 pair, or one float) from global to shared memory; zeros
// when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Waits for every cp.async this thread has issued.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Closes the group of this thread's cp.async copies issued since the last
// commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float lo_bf16(unsigned u) {
  return __uint_as_float(u << 16);
}

__device__ __forceinline__ float hi_bf16(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}

// Two g' values (exact bfloat16) from two packed g and y values.
__device__ __forceinline__ unsigned cotangent2(unsigned g2, unsigned y2,
                                               int act, float alpha) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(
      cotangent<__nv_bfloat16>(lo_bf16(g2), lo_bf16(y2), act, alpha),
      cotangent<__nv_bfloat16>(hi_bf16(g2), hi_bf16(y2), act, alpha));
  return *reinterpret_cast<const unsigned*>(&r);
}

}  // namespace
}  // namespace stroke
