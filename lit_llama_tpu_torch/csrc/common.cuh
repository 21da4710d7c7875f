// Shared helpers for the port's kernels: bf16 conversion and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define LLT_EXPORT extern "C" __attribute__((visibility("default")))

// -1e30 rather than -inf: exp(NEG_INF - m) is 0 without an inf - inf NaN,
// as in the Pallas kernels.
#define LLT_NEG_INF (-1e30f)

__device__ __forceinline__ float bf16_to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
