// mma.sync helpers shared by the port's kernels that issue the warp-level
// tensor-core product (quant_matmul.cu's decode GEMV, paged_attention.cu):
// the m16n8k16 bf16 product with f32 accumulators, and exact conversions of
// small integers (int8 codes) to bf16 operands.
#pragma once

#include <stdint.h>

namespace {

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Two f32 holding integers of at most 8 significant bits -> bf16x2 {lo, hi};
// truncation is exact for them.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);
}

// int8 codes r in bytes 0 and 2 of x -> bf16x2 {r0, r2}, exact: the sum
// of (128 + (r & 127)) and (-128 - 128 * sign bit), each built by one
// bit operation as an exact bf16 and summed exactly (|r| <= 128)
__device__ __forceinline__ uint32_t s8x2_bf16(uint32_t x) {
  const uint32_t a = (x & 0x007F007Fu) | 0x43004300u;
  const uint32_t b = (x & 0x00800080u) | 0xC300C300u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(a), "r"(0x3F803F80u), "r"(b));
  return d;
}

}  // namespace
