// Tensor-core building blocks shared by the kernels: the m16n8k16 bf16
// product and bf16 pair packing.
//
// Fragment layout of mma.sync m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row): a0 = (row g,     k 2t, 2t+1)   a1 = (row g + 8, k 2t, 2t+1)
//                     a2 = (row g,     k 2t+8, +9)   a3 = (row g + 8, k 2t+8, +9)
//   B (16 x 8, col):  b0 = (k 2t, 2t+1, col g)       b1 = (k 2t+8, +9, col g)
//   C/D (16 x 8):     d0, d1 = (row g, col 2t, 2t+1) d2, d3 = (row g + 8, col 2t, 2t+1)
#pragma once

#include "common.cuh"

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Bits 0-3 and 16-19 of v (the low nibbles of bytes 0 and 2) as an exact
// bf16 pair: under the exponent of 128 a nibble n is the bf16 128 + n, and
// the subtraction of 128 is exact (nibbles 0-15 are exact in bf16).
__device__ __forceinline__ uint32_t nib2(uint32_t v) {
  uint32_t p = (v & 0x000F000Fu) | 0x43004300u;  // (128 + n0, 128 + n1)
  const uint32_t bias = 0x43004300u;
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&p), *reinterpret_cast<const __nv_bfloat162*>(&bias));
  return *reinterpret_cast<uint32_t*>(&r);
}
