// PTX helpers of the bfloat16 tensor-core kernels (conv3x3_fwd_tc.cu: K1;
// conv3x3_bwd_tc.cu: K2; conv3x3_bwd_dx_tc.cu: K3; conv3x3_bwd_dw_tc.cu:
// K4): ldmatrix fragment loads from shared memory,
// the mma.sync.m16n8k16 bf16 product with float32 sums, cp.async copies,
// and g' formed from packed bfloat16 pairs while staging.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace stroke {
namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4],
                                        const __nv_bfloat16* p) {
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

// 16 bytes from global to shared memory; zeros when !valid.
__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes (a bf16 pair) from global to shared memory; zeros when !valid.
__device__ __forceinline__ void cp_async4(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
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
