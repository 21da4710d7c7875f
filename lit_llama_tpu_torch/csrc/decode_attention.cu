// K8: per-slot cache-row write + single-query attention for continuous
// batching (B serving slots, each at its own position).
//
// Replaces lit_llama_tpu/ops/decode_attention.py _pipe_kernel (entry
// decode_attention_write_pipelined) and _write_attn_kernel (entry
// decode_attention_write_pallas): both compute this function, so one kernel
// stands behind both entries.
//
// Bound on the H100: bytes. Each slot reads the visible part of its k and v
// cache once, (min(pos, S - 1) + 1) * H * 128 * 2 * 2 bytes: 134 MB at 32 slots
// with 256 rows visible each; the arithmetic is four operations per cache
// element.
//
// Design: the Pallas kernels walk the slots one after another and carry the
// online softmax from cache block to cache block; on the card every (head,
// 64-row chunk, slot) is a block of its own and a second kernel merges the
// chunks of a head (the code shared with K1, attention_chunk.cuh).
// slot_pos is read from device memory, so the grid covers every chunk of the
// cache and a block whose chunk lies wholly above its slot's limit exits at
// once: no host sync, no launch per slot. The new row never races the reads:
// the block that owns row slot_pos % S writes it, synchronises and then reads
// its chunk; no other block touches that row. Row s is visible iff
// s <= slot_pos, so a slot at or past S - 1 sees the whole ring.
// Simple first: no cp.async/TMA pipeline, scores on the CUDA cores.

#include "attention_chunk.cuh"

namespace {

// q, kn, vn: (B, H, 128) bf16 with a slot stride (elements) each; caches
// (B, H, S, 128) bf16, row slot_pos % S written in place; part (B, H, nch,
// ATT_PART) f32.
__global__ void __launch_bounds__(ATT_HS)
write_attn_partial_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kn,
                          const __nv_bfloat16* __restrict__ vn, int q_stride, int k_stride,
                          int v_stride, __nv_bfloat16* kc, __nv_bfloat16* vc,
                          const int* __restrict__ slot_pos, float* __restrict__ part, int H, int S,
                          float scale) {
  __shared__ __align__(16) float q_s[ATT_HS];
  const int h = blockIdx.x, c = blockIdx.y, nch = gridDim.y, b = blockIdx.z;
  const int d = threadIdx.x;
  const int limit = max(slot_pos[b], 0);
  const int last = min(limit, S - 1);
  const int s0 = c * ATT_CHUNK;
  if (s0 > last) return;  // the whole chunk is above this slot's limit
  const int wp = limit % S;
  const size_t cbase = ((size_t)b * H + h) * (size_t)S * ATT_HS;

  q_s[d] = bf16_to_f32(q[(size_t)b * q_stride + h * ATT_HS + d]);
  if (wp >= s0 && wp < s0 + ATT_CHUNK) {
    kc[cbase + (size_t)wp * ATT_HS + d] = kn[(size_t)b * k_stride + h * ATT_HS + d];
    vc[cbase + (size_t)wp * ATT_HS + d] = vn[(size_t)b * v_stride + h * ATT_HS + d];
  }
  __syncthreads();  // q_s and the new cache row are visible to the block

  const int n = min(ATT_CHUNK, last - s0 + 1);
  attn_chunk_partial(q_s, kc + cbase, vc + cbase, s0, n, scale,
                     part + (((size_t)b * H + h) * nch + c) * ATT_PART);
}

__global__ void __launch_bounds__(ATT_HS)
write_attn_combine_kernel(const float* __restrict__ part, const int* __restrict__ slot_pos,
                          __nv_bfloat16* __restrict__ y, int H, int S, int nch_max) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int nch = min(max(slot_pos[b], 0), S - 1) / ATT_CHUNK + 1;
  const float* pp = part + ((size_t)b * H + h) * nch_max * ATT_PART;
  y[((size_t)b * H + h) * ATT_HS + d] = __float2bfloat16_rn(attn_combine(pp, nch, d));
}

}  // namespace

// q, kn, vn: bf16, element (b, h, d) at b * stride + h * 128 + d. kc, vc
// (B, H, S, 128) bf16 contiguous. slot_pos (B) int32 on the device. part:
// scratch of B * H * ceil(S / 64) * 130 floats. y (B, H, 128) bf16 contiguous.
LLT_EXPORT int k8_decode_attention_write(const void* q, const void* kn, const void* vn,
                                         int q_stride, int k_stride, int v_stride, void* kc,
                                         void* vc, const void* slot_pos, void* part, void* y, int B,
                                         int H, int S, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nch = (S + ATT_CHUNK - 1) / ATT_CHUNK;
  write_attn_partial_kernel<<<dim3(H, nch, B), ATT_HS, 0, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)kn, (const __nv_bfloat16*)vn, q_stride,
      k_stride, v_stride, (__nv_bfloat16*)kc, (__nv_bfloat16*)vc, (const int*)slot_pos,
      (float*)part, H, S, (float)(1.0 / sqrt((double)ATT_HS)));
  write_attn_combine_kernel<<<dim3(H, B), ATT_HS, 0, st>>>((const float*)part, (const int*)slot_pos,
                                                          (__nv_bfloat16*)y, H, S, nch);
  return (int)cudaGetLastError();
}
