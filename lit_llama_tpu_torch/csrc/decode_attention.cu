// K8 and K5: single-query attention against a (B, H, S, 128) cache. K8 (first
// below) also writes each slot's new row; K5 (second) reads a cache that is
// already written, in the compute dtype or int8 with one f32 scale per row.
//
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
// f32 compute (q.dtype f32): T = float below, the same kernel on an f32 cache.

#include "attention_chunk.cuh"
#include "decode_sm90.cuh"

namespace {

// q, kn, vn: (B, H, 128) of T (bf16 or f32) with a slot stride (elements)
// each; caches (B, H, S, 128) of T, row slot_pos % S written in place; part
// (B, H, nch, ATT_PART) f32.
template <typename T>
__global__ void __launch_bounds__(ATT_HS)
write_attn_partial_kernel(const T* __restrict__ q, const T* __restrict__ kn, const T* __restrict__ vn,
                          int q_stride, int k_stride, int v_stride, T* kc, T* vc,
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

  q_s[d] = to_f32(q[(size_t)b * q_stride + h * ATT_HS + d]);
  if (wp >= s0 && wp < s0 + ATT_CHUNK) {
    kc[cbase + (size_t)wp * ATT_HS + d] = kn[(size_t)b * k_stride + h * ATT_HS + d];
    vc[cbase + (size_t)wp * ATT_HS + d] = vn[(size_t)b * v_stride + h * ATT_HS + d];
  }
  __syncthreads();  // q_s and the new cache row are visible to the block

  const int n = min(ATT_CHUNK, last - s0 + 1);
  attn_chunk_partial<T>(q_s, kc + cbase, vc + cbase, s0, n, scale,
                        part + (((size_t)b * H + h) * nch + c) * ATT_PART);
}

template <typename T>
__global__ void __launch_bounds__(ATT_HS)
write_attn_combine_kernel(const float* __restrict__ part, const int* __restrict__ slot_pos,
                          T* __restrict__ y, int H, int S, int nch_max) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int nch = min(max(slot_pos[b], 0), S - 1) / ATT_CHUNK + 1;
  const float* pp = part + ((size_t)b * H + h) * nch_max * ATT_PART;
  y[((size_t)b * H + h) * ATT_HS + d] = from_f32<T>(attn_combine(pp, nch, d));
}

template <typename T>
int launch_write_attn(const void* q, const void* kn, const void* vn, int q_stride, int k_stride,
                      int v_stride, void* kc, void* vc, const void* slot_pos, void* part, void* y, int B,
                      int H, int S, cudaStream_t st) {
  const int nch = (S + ATT_CHUNK - 1) / ATT_CHUNK;
  write_attn_partial_kernel<T><<<dim3(H, nch, B), ATT_HS, 0, st>>>(
      (const T*)q, (const T*)kn, (const T*)vn, q_stride, k_stride, v_stride, (T*)kc, (T*)vc,
      (const int*)slot_pos, (float*)part, H, S, (float)(1.0 / sqrt((double)ATT_HS)));
  write_attn_combine_kernel<T><<<dim3(H, B), ATT_HS, 0, st>>>((const float*)part, (const int*)slot_pos,
                                                             (T*)y, H, S, nch);
  return (int)cudaGetLastError();
}

}  // namespace

// q, kn, vn: bf16 (cbf16 = 1) or f32, element (b, h, d) at b * stride +
// h * 128 + d. kc, vc (B, H, S, 128) of the same dtype, contiguous. slot_pos
// (B) int32 on the device. part: scratch of B * H * ceil(S / 64) * 130
// floats. y (B, H, 128) contiguous, of the same dtype.
LLT_EXPORT int k8_decode_attention_write(const void* q, const void* kn, const void* vn,
                                         int q_stride, int k_stride, int v_stride, void* kc,
                                         void* vc, const void* slot_pos, void* part, void* y, int B,
                                         int H, int S, int cbf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return cbf16 ? launch_write_attn<__nv_bfloat16>(q, kn, vn, q_stride, k_stride, v_stride, kc, vc, slot_pos,
                                                  part, y, B, H, S, st)
               : launch_write_attn<float>(q, kn, vn, q_stride, k_stride, v_stride, kc, vc, slot_pos, part,
                                          y, B, H, S, st);
}

// ---------------------------------------------------------------------------
// K5: one query per (batch row, head) against the whole cache.
//
// Replaces lit_llama_tpu/ops/decode_attention.py _kernel (entry
// decode_attention_pallas), both variants: a cache in the compute dtype (bf16
// or f32), and an int8 cache whose per-row scales are folded into the score
// (k) and into the softmax weight (v), so the cache is never dequantized.
//
// Bound on the H100: bytes. The visible rows of k and v are read once:
// (min(limit, S - 1) + 1) * H * hs * 2 elements per batch row, 33.6 MB at
// B = 1, S = 2048, hs = 128 in bf16, 67.1 MB in f32 and 17.3 MB in int8 with
// its scales; the arithmetic is four operations per cache element.
//
// Design: at every head size that is a multiple of 128 up to
// dsm90::MAX_HS (1024; every preset has 128), in bf16 and in f32 compute, the
// split body of decode_sm90.cuh: the cache of a (batch row, head) in splits
// whose size depends on S and hs alone (at most 8 at head size 128 and 256,
// 8 hs / 128 past it), a block of four warps a split streaming k and v
// through cp.async rings, the splits merged in the same launch by the last
// block to arrive. Past 1024, a static route by head size that no model the
// repo supports takes, the first port's wide kernels below, not rebuilt for
// Hopper: every (head, 64-row chunk, batch row) is a block of its own (128
// threads, each walking hs / 128 head elements), writes its chunk's (m, l,
// acc) and a second kernel merges the chunks of a head (the merge is K8's,
// attention_chunk.cuh).
// limit is read from device memory: the grid covers every split or chunk,
// and a block whose rows lie wholly past limit[b] exits at once, so a step
// costs no host sync. The arithmetic in bf16 is the Pallas kernel's:
// each product k * q and w * v is rounded to bf16 (the cache's compute dtype)
// and summed in f32; the k scale multiplies the f32 score, the v scale the
// f32 softmax weight before it is rounded; l is floored at 1e-30, so a row
// with limit < 0 gives zeros. In f32 compute (q.dtype f32) the products and
// the softmax weights stay f32 (no rounding), on an f32 cache or an int8 one.

namespace {

// 64 cache elements (half a row) times the matching half of q, each product
// rounded to bf16, summed in f32
__device__ __forceinline__ float half_row_dot(const __nv_bfloat16* kr, const __nv_bfloat162* q2) {
  uint4 kv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) kv[j] = reinterpret_cast<const uint4*>(kr)[j];
  float dot = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&kv[j]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 p = __hmul2(k2[e], q2[4 * j + e]);
      dot += __low2float(p);
      dot += __high2float(p);
    }
  }
  return dot;
}

__device__ __forceinline__ __nv_bfloat162 s8x2_to_bf162(uint32_t w, int pair) {
  return __floats2bfloat162_rn((float)(int8_t)((w >> (16 * pair)) & 0xFFu),
                               (float)(int8_t)((w >> (16 * pair + 8)) & 0xFFu));
}

__device__ __forceinline__ float half_row_dot(const int8_t* kr, const __nv_bfloat162* q2) {
  uint4 kv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) kv[j] = reinterpret_cast<const uint4*>(kr)[j];
  float dot = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t w[4] = {kv[j].x, kv[j].y, kv[j].z, kv[j].w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const __nv_bfloat162 p = __hmul2(s8x2_to_bf162(w[e / 2], e % 2), q2[8 * j + e]);
      dot += __low2float(p);
      dot += __high2float(p);
    }
  }
  return dot;
}

// 64 f32 cache elements times 64 f32 query elements, summed in f32
__device__ __forceinline__ float half_row_dot(const float* kr, const float* q) {
  float dot = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float4 k4 = reinterpret_cast<const float4*>(kr)[j];
    dot += k4.x * q[4 * j] + k4.y * q[4 * j + 1] + k4.z * q[4 * j + 2] + k4.w * q[4 * j + 3];
  }
  return dot;
}

// 64 int8 cache elements (exact in f32) times 64 f32 query elements
__device__ __forceinline__ float half_row_dot(const int8_t* kr, const float* q) {
  float dot = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint4 kv = reinterpret_cast<const uint4*>(kr)[j];
    const uint32_t w[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
    for (int e = 0; e < 16; ++e) dot += (float)(int8_t)((w[e / 4] >> (8 * (e % 4))) & 0xFFu) * q[16 * j + e];
  }
  return dot;
}

// the bf16 query as bf16 pairs, the f32 query as it is
__device__ __forceinline__ const __nv_bfloat162* query_view(const __nv_bfloat16* q) {
  return reinterpret_cast<const __nv_bfloat162*>(q);
}
__device__ __forceinline__ const float* query_view(const float* q) { return q; }

// w * v rounded to the compute dtype QT, as f32
__device__ __forceinline__ float weighted(__nv_bfloat16 w, __nv_bfloat16 v) { return __bfloat162float(__hmul(w, v)); }
__device__ __forceinline__ float weighted(__nv_bfloat16 w, int8_t v) {
  return __bfloat162float(__hmul(w, __float2bfloat16_rn((float)v)));
}
__device__ __forceinline__ float weighted(float w, float v) { return w * v; }
__device__ __forceinline__ float weighted(float w, int8_t v) { return w * (float)v; }

// Past head size 1024 (any multiple of 128): a fixed block of 128 threads.
// Two threads score a cache row, each walking half of it in pieces of 64
// elements; a thread then owns head elements tid, tid + 128, ... of the v sum.
// The query sits in dynamic shared memory (hs elements). The arithmetic is
// the one stated above, by the helpers below (QT the compute dtype of q, the
// products and y; CT the cache's element type, QT or int8_t).
constexpr int WIDE_THREADS = 128;

template <typename QT, typename CT>
__global__ void __launch_bounds__(WIDE_THREADS)
decode_attn_wide_partial_kernel(const QT* __restrict__ q, int q_stride, const CT* __restrict__ kc,
                                const CT* __restrict__ vc, const float* __restrict__ ks,
                                const float* __restrict__ vs, const int* __restrict__ limit,
                                float* __restrict__ part, int H, int S, int hs, float scale) {
  constexpr bool QUANT = sizeof(CT) == 1 && sizeof(QT) != 1;
  constexpr int NW = WIDE_THREADS / 32;
  extern __shared__ __align__(16) unsigned char q_raw[];
  QT* q_s = reinterpret_cast<QT*>(q_raw);  // [hs]
  __shared__ float sc[ATT_CHUNK];
  __shared__ QT w_s[ATT_CHUNK];
  __shared__ float red[NW];
  const int h = blockIdx.x, c = blockIdx.y, nch = gridDim.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int last = min(limit[b], S - 1);
  const int s0 = c * ATT_CHUNK;
  if (s0 > last) return;  // the whole chunk is past this row's limit
  const int n = min(ATT_CHUNK, last - s0 + 1);
  const size_t row0 = ((size_t)b * H + h) * (size_t)S + s0;

  for (int d = tid; d < hs; d += WIDE_THREADS) q_s[d] = q[(size_t)b * q_stride + (size_t)h * hs + d];
  __syncthreads();

  {  // scores: two threads per cache row, half a row each in pieces of 64
    const int slot = tid / 2, half = tid % 2;
    float dot = 0.f;
    if (slot < n)
      for (int p0 = half * (hs / 2); p0 < (half + 1) * (hs / 2); p0 += 64)
        dot += half_row_dot(kc + (row0 + slot) * hs + p0, query_view(q_s + p0));
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    if (half == 0 && slot < n) {
      if (QUANT) dot *= ks[row0 + slot];
      sc[slot] = dot * scale;
    }
  }
  __syncthreads();
  float m = tid < n ? sc[tid] : LLT_NEG_INF;
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) m = fmaxf(m, red[w]);
  __syncthreads();
  float p = 0.f;
  if (tid < n) {
    p = __expf(sc[tid] - m);
    w_s[tid] = from_f32<QT>(QUANT ? p * vs[row0 + tid] : p);
  }
  float l = warp_sum(p);
  if (lane == 0) red[warp] = l;
  __syncthreads();  // red and w_s are visible to the block
  l = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) l += red[w];
  float* pp = part + (((size_t)b * H + h) * nch + c) * (hs + 2);
  for (int d = tid; d < hs; d += WIDE_THREADS) {
    float acc = 0.f;
    const CT* vr = vc + row0 * hs + d;
#pragma unroll 8
    for (int i = 0; i < n; ++i) acc += weighted(w_s[i], vr[(size_t)i * hs]);
    pp[2 + d] = acc;
  }
  if (tid == 0) {
    pp[0] = m;
    pp[1] = l;
  }
}

template <typename QT>
__global__ void __launch_bounds__(WIDE_THREADS)
decode_attn_wide_combine_kernel(const float* __restrict__ part, const int* __restrict__ limit,
                                QT* __restrict__ y, int H, int S, int hs, int nch_max) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int last = min(limit[b], S - 1);
  const int nch = last < 0 ? 0 : last / ATT_CHUNK + 1;
  const float* pp = part + ((size_t)b * H + h) * nch_max * (hs + 2);
  for (int d = threadIdx.x; d < hs; d += WIDE_THREADS)
    y[((size_t)b * H + h) * hs + d] = from_f32<QT>(attn_combine(pp, nch, d, hs + 2));
}

template <typename QT, typename CT>
int launch_decode_attn_wide(const void* q, int q_stride, const void* k, const void* v, const void* ks,
                            const void* vs, const void* limit, void* part, void* y, int B, int H, int S, int hs,
                            cudaStream_t st) {
  const int nch = (S + ATT_CHUNK - 1) / ATT_CHUNK;
  const float scale = (float)(1.0 / sqrt((double)hs));
  const int smem = hs * (int)sizeof(QT);
  decode_attn_wide_partial_kernel<QT, CT><<<dim3(H, nch, B), WIDE_THREADS, smem, st>>>(
      (const QT*)q, q_stride, (const CT*)k, (const CT*)v, (const float*)ks, (const float*)vs, (const int*)limit,
      (float*)part, H, S, hs, scale);
  decode_attn_wide_combine_kernel<QT><<<dim3(H, B), WIDE_THREADS, 0, st>>>((const float*)part, (const int*)limit,
                                                                           (QT*)y, H, S, hs, nch);
  return (int)cudaGetLastError();
}

template <typename QT>
int launch_decode_attn_wide_c(const void* q, int q_stride, const void* k, const void* v, const void* ks,
                              const void* vs, const void* limit, void* part, void* y, int B, int H, int S, int hs,
                              int quantized, cudaStream_t st) {
  return quantized
             ? launch_decode_attn_wide<QT, int8_t>(q, q_stride, k, v, ks, vs, limit, part, y, B, H, S, hs, st)
             : launch_decode_attn_wide<QT, QT>(q, q_stride, k, v, ks, vs, limit, part, y, B, H, S, hs, st);
}

}  // namespace

// q: bf16 (cbf16 = 1) or f32, element (b, h, d) at b * q_stride + h * hs + d.
// k, v (B, H, S, hs) contiguous, of q's dtype (quantized == 0; ks, vs
// ignored) or int8 with ks, vs (B, H, S) f32. hs any multiple of 128. limit (B) int32
// on the device: row s is visible to batch row b iff s <= limit[b]. part:
// scratch of B * H * dsm90::n_splits(S, hs) * (hs + 2) floats (head size up
// to dsm90::MAX_HS) or B * H * ceil(S / 64) * (hs + 2) (past it); counter:
// B * H int32, zeros, left zeros (up to dsm90::MAX_HS; else unused). y (B, H,
// hs) contiguous, of q's dtype.
LLT_EXPORT int k5_decode_attention(const void* q, int q_stride, const void* k, const void* v,
                                   const void* ks, const void* vs, const void* limit, void* part,
                                   void* counter, void* y, int B, int H, int S, int quantized, int cbf16,
                                   int hs, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define LLT_K5_SPLIT(QT, HS)                                                                                   \
  return quantized ? dsm90::launch_k5<QT, int8_t, HS>(q, q_stride, k, v, ks, vs, limit, part, counter, y, B, H, S, \
                                                      st)                                                          \
                   : dsm90::launch_k5<QT, QT, HS>(q, q_stride, k, v, ks, vs, limit, part, counter, y, B, H, S, st)
#define LLT_K5_HS(HS)                         \
  if (hs == HS) {                             \
    if (cbf16) LLT_K5_SPLIT(__nv_bfloat16, HS); \
    LLT_K5_SPLIT(float, HS);                  \
  }
  LLT_K5_HS(128)
  LLT_K5_HS(256)
  LLT_K5_HS(384)
  LLT_K5_HS(512)
  LLT_K5_HS(640)
  LLT_K5_HS(768)
  LLT_K5_HS(896)
  LLT_K5_HS(1024)
  static_assert(dsm90::MAX_HS == 1024, "every head size up to MAX_HS has its split body above");
#undef LLT_K5_HS
#undef LLT_K5_SPLIT
  if (hs > dsm90::MAX_HS && hs % 128 == 0)
    return cbf16 ? launch_decode_attn_wide_c<__nv_bfloat16>(q, q_stride, k, v, ks, vs, limit, part, y, B, H, S, hs,
                                                            quantized, st)
                 : launch_decode_attn_wide_c<float>(q, q_stride, k, v, ks, vs, limit, part, y, B, H, S, hs,
                                                    quantized, st);
  return (int)cudaErrorInvalidValue;
}
