// Device helpers of the mma.sync kernels (attn_diag.cu): bf16 packing, the
// mma.sync m16n8k16 product, ex2.approx, 16-byte cp.async and ldmatrix.trans.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint16_t bits(__nv_bfloat16 x) { return __bfloat16_as_ushort(x); }

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return (uint32_t)bits(__float2bfloat16(lo)) | ((uint32_t)bits(__float2bfloat16(hi)) << 16);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// b0/b1 fragments of two 16x8 (kv x d) blocks of row-major V in shared
// memory: matrices (kv 0-7, d0), (kv 8-15, d0), (kv 0-7, d0+8), (kv 8-15, d0+8)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const uint16_t* row_addr) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row_addr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

}  // namespace
