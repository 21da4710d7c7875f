// Single-query attention over a ring cache in chunks of 64 slots, shared by
// K8 (one query per serving slot) and K1 in f32 compute (in bf16 K1 runs the
// split body of decode_sm90.cuh): a block of 128
// threads takes one (head, chunk), writes the chunk's running max, sum and
// unnormalised output; a second pass merges the chunks of a head.
#pragma once

#include "common.cuh"

constexpr int ATT_HS = 128;    // head size; also the block's thread count
constexpr int ATT_CHUNK = 64;  // cache slots per block
constexpr int ATT_PART = ATT_HS + 2;  // floats per (head, chunk): max, sum, acc[128]

// Softmax-weighted sum over the n >= 1 visible slots [s0, s0 + n) of one
// head. q_s: the query, 128 f32 in shared memory, visible to the block.
// kc/vc: the head's cache (S, 128), CT = bf16 or f32. pp: the (head, chunk)
// partial. Each pair of threads scores one slot (independent 16-byte loads of
// half the k row each); each thread then owns one head element of the v sum.
template <typename CT>
__device__ __forceinline__ void attn_chunk_partial(const float* q_s, const CT* kc, const CT* vc,
                                                   int s0, int n, float scale, float* pp) {
  constexpr int PER = 16 / sizeof(CT);        // elements of a 16-byte load
  constexpr int NV = ATT_HS / 2 / PER;        // loads of half a row
  __shared__ float sc[ATT_CHUNK];
  __shared__ float red[4];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  {
    const int slot = tid >> 1, half = tid & 1;
    float dot = 0.f;
    if (slot < n) {
      const uint4* kr = reinterpret_cast<const uint4*>(kc + (size_t)(s0 + slot) * ATT_HS + half * (ATT_HS / 2));
      uint4 kv[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) kv[j] = kr[j];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const CT* ke = reinterpret_cast<const CT*>(&kv[j]);
        const float* qh = q_s + half * (ATT_HS / 2) + PER * j;
#pragma unroll
        for (int e = 0; e < PER; ++e) dot += to_f32(ke[e]) * qh[e];
      }
    }
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    if (half == 0 && slot < n) sc[slot] = dot * scale;
  }
  __syncthreads();
  float m = tid < n ? sc[tid] : LLT_NEG_INF;
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
  __syncthreads();
  float p = 0.f;
  if (tid < n) {
    p = __expf(sc[tid] - m);
    sc[tid] = p;
  }
  float l = warp_sum(p);
  if (lane == 0) red[warp] = l;
  __syncthreads();
  l = red[0] + red[1] + red[2] + red[3];
  float acc = 0.f;
  const CT* vr = vc + (size_t)s0 * ATT_HS + tid;
#pragma unroll 8
  for (int i = 0; i < n; ++i) acc += sc[i] * to_f32(vr[(size_t)i * ATT_HS]);
  if (tid == 0) {
    pp[0] = m;
    pp[1] = l;
  }
  pp[2 + tid] = acc;
}

// Element d of a head's output from its nch chunk partials, each `part`
// floats apart (ATT_PART at head size 128):
// sum_c e^(m_c - M) acc_c[d] / sum_c e^(m_c - M) l_c
__device__ __forceinline__ float attn_combine(const float* pp, int nch, int d, int part = ATT_PART) {
  float M = LLT_NEG_INF;
  for (int c = 0; c < nch; ++c) M = fmaxf(M, pp[c * part]);
  float L = 0.f, acc = 0.f;
  for (int c = 0; c < nch; ++c) {
    const float w = __expf(pp[c * part] - M);
    L += w * pp[c * part + 1];
    acc += w * pp[c * part + 2 + d];
  }
  return acc / fmaxf(L, 1e-30f);
}
