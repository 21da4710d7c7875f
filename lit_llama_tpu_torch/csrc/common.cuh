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

// Element conversions of the kernels that take bf16 or f32 (the compute dtype)
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Eight consecutive elements (16-byte aligned for bf16, 32 for f32) as f32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = __bfloat162float(b[j]);
}
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p)), b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  o[0] = a.x, o[1] = a.y, o[2] = a.z, o[3] = a.w, o[4] = b.x, o[5] = b.y, o[6] = b.z, o[7] = b.w;
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

// ---- Hopper's asynchronous copies and programmatic dependent launch -------
// A 16-byte (or 4-byte) cp.async into shared memory; src_bytes = 0 fills the
// destination with zeros (a row or column past the tensor's end).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// Programmatic dependent launch: a kernel launched with launch_pdl may start
// while the kernel before it on the stream runs. It reads nothing that kernel
// writes, and writes nothing, before pdl_wait() returns (the kernel before it
// has finished and its writes are visible); pdl_trigger() lets the kernel
// after it start. Both are no-ops in a kernel launched the usual way. A
// kernel triggers after its own wait, so at most one kernel waits ahead of
// the one that runs, holding its blocks' registers and shared memory.
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }
__device__ __forceinline__ void pdl_trigger() { asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory"); }

// Once per kernel and device (ready: the call site's flags by device): the
// largest dynamic shared memory a block may take, and the largest
// shared-memory carveout of the SM, so that as many blocks fit as the shared
// memory allows (the CUDA runtime may otherwise pick a smaller carveout).
template <typename K>
int allow_smem(int* ready, K kernel) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || ready[dev & 15]) return (int)e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kernel);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)  // 227 KB a block, its static shared memory included
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024 - (int)fa.sharedSizeBytes);
  ready[dev & 15] = e == cudaSuccess;
  return (int)e;
}

template <typename... Params, typename... Args>
int launch_pdl(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem, cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}
