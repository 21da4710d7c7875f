// K1 (one decode token through one transformer block) and K2 (final RMSNorm
// + lm_head) at batch 1.
//
// Replace lit_llama_tpu/ops/fused_layer.py _layer_kernel (entry
// decode_layers_fused / decode_layer_fused) and _head_kernel (entry
// lm_head_fused).
//
// Bound on the H100: bytes. A 7B block streams 113.8 MB of int4 weights and
// f32 scale/zero planes per token and reads the visible part of its k/v cache
// (up to 33.6 MB at S = 2048); the arithmetic is two operations per weight.
// The lm_head streams 73.7 MB.
//
// Design: the Pallas kernel ran the block as one program with manual DMA; on
// the card one entry launches a fixed sequence of kernels, so each can spread
// over all SMs:
//   1. gemv_int4 with an RMSNorm prologue (rms_1) -> qkv, f32
//   2. attn_partial: per (head, 64-slot chunk) block: half-basis RoPE of q
//      (and, in the chunk holding write_pos, of k, with the bf16 k/v row
//      write), then softmax over the chunk's slots <= limit
//   3. attn_combine: merges the chunks' (max, sum, acc) per head -> y, f32
//   4. gemv_int4 with a residual epilogue (attn c_proj) -> xs, f32
//   5. gemv_int4 with an RMSNorm prologue (rms_2) and a SiLU(gate) * up
//      epilogue (c_fc12: a warp owns columns j and I + j) -> gg, f32
//   6. gemv_int4 with a residual epilogue (mlp c_proj) -> xs, f32, and the
//      bf16 output row on the last block of an entry
// gemv_int4 reads the decode layout that prepare_fused_params adds: each
// column's packed bytes contiguous (qw_t (N, K/2)) and its scale/zero rows
// (qscale_t, qzero_t (N, G)). A warp owns two columns and walks K in 16-byte
// loads (the loop over them unrolled four times), so any N spreads over the
// whole card without a cross-block reduction, and the column sums end in one
// warp shuffle reduction. Each block first writes the
// bf16-rounded, optionally normalised input to shared memory as f32, with its
// f32 group sums. The nibble products run in f32 on the bf16-rounded input
// (exact, as the MXU products of the Pallas kernel), the zero-point term
// comes from f32 group sums of the unrounded input, and the residual stays
// f32 inside the block, as in the Pallas kernel. Nibbles become floats by the
// exponent trick (no integer-to-float conversions, which run at a quarter
// rate). The blocks are persistent (two per SM), so the prologue is paid
// once per block. (Measured on the H100 against this form, in one call: an
// L2 prefetch of each warp's next columns, loads batched explicitly ahead of
// their products, and three blocks per SM were each slower.)
// attn_partial gives each pair of threads one cache slot of its 64-slot
// chunk for the score (8 independent 16-byte loads of half the k row each)
// and each thread one head element for the weighted sum of v.
// Simple first: no cp.async or TMA pipeline; later work.
//
// The LoRA operand (the Pallas kernel's _add_lora_delta after the QKV
// matvec: qkv += (h @ lora_af) @ lora_bf in f32, h the unrounded normed row)
// runs between steps 1 and 2 when the layer has one, as two more kernels:
//   1a. lora_down: one row of lora_af (D, R8) per thread, h recomputed from
//       x with the same norm as the prologue; the block's R8 column sums go
//       to part (blocks, R8), f32, in a fixed order
//   1b. lora_up: ax = the sum of part's rows; one qkv column per thread
//       adds ax @ lora_bf[:, n] (lora_bf (R8, 3D), scaling folded in)
// Bound: bytes, D * R8 * 2 + R8 * 3D * 2 (0.5 MB at 7B, R8 = 16: 0.16 us at
// 3.35 TB/s); the two launches' latency is most of their time.

#include "attention_chunk.cuh"
#include "gemv_int4.cuh"

namespace {

constexpr int HS = ATT_HS;
constexpr int CHUNK = ATT_CHUNK;  // cache slots per attention block

// Block (head h, chunk c) of one decode token's attention. qkv (3D) f32 in
// the half-rotation basis; caches (H, S, 128) bf16, updated in place at
// write_pos. Writes the chunk's running max, sum and unnormalised output.
__global__ void __launch_bounds__(128)
attn_partial_kernel(const float* __restrict__ qkv, const float* __restrict__ cosf,
                    const float* __restrict__ sinf, __nv_bfloat16* kc, __nv_bfloat16* vc,
                    float* __restrict__ part, int D, int S, int write_pos, int limit, float scale) {
  __shared__ __align__(16) float q_s[HS];
  const int h = blockIdx.x, c = blockIdx.y, nch = gridDim.y;
  const int d = threadIdx.x;  // one head element per thread
  const int partner = (d + HS / 2) % HS;
  const size_t cbase = (size_t)h * S * HS;

  q_s[d] = qkv[h * HS + d] * cosf[d] + qkv[h * HS + partner] * sinf[d];
  const int s0 = c * CHUNK;
  if (write_pos >= s0 && write_pos < s0 + CHUNK) {
    const float* kq = qkv + D + h * HS;
    kc[cbase + (size_t)write_pos * HS + d] = __float2bfloat16_rn(kq[d] * cosf[d] + kq[partner] * sinf[d]);
    vc[cbase + (size_t)write_pos * HS + d] = __float2bfloat16_rn(qkv[2 * D + h * HS + d]);
  }
  __syncthreads();  // q_s and the new cache row are visible to the block

  const int last = min(limit, S - 1);
  const int n = min(CHUNK, last - s0 + 1);  // visible slots of this chunk (>= 1)
  attn_chunk_partial(q_s, kc + cbase, vc + cbase, s0, n, scale,
                     part + ((size_t)h * nch + c) * ATT_PART);
}

__global__ void __launch_bounds__(128)
attn_combine_kernel(const float* __restrict__ part, float* __restrict__ y, int nch) {
  const int h = blockIdx.x, d = threadIdx.x;
  y[h * HS + d] = attn_combine(part + (size_t)h * nch * ATT_PART, nch, d);
}

constexpr int LORA_THREADS = 256;
constexpr int LORA_WARPS = LORA_THREADS / 32;
constexpr int LORA_MAX_R8 = 64;  // checked by the Python wrapper

// part[blockIdx.x][r] = sum over this block's rows k of h[k] * la[k][r], with
// h = rms_norm(x, norm_w) in f32 (not rounded). la (K, R8) bf16, R8 % 8 == 0.
__global__ void __launch_bounds__(LORA_THREADS)
lora_down_kernel(const void* __restrict__ x, int in_bf16, const __nv_bfloat16* __restrict__ norm_w,
                 float eps, const __nv_bfloat16* __restrict__ la, int K, int R8,
                 float* __restrict__ part) {
  __shared__ float wred[LORA_WARPS];
  __shared__ float rn;
  __shared__ float red[LORA_WARPS][LORA_MAX_R8];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float ss = 0.f;
  for (int k = tid; k < K; k += LORA_THREADS) {
    const float v = load_in(x, in_bf16, k);
    ss += v * v;
  }
  ss = warp_sum(ss);
  if (lane == 0) wred[warp] = ss;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
    for (int w = 0; w < LORA_WARPS; ++w) t += wred[w];
    rn = rsqrtf(t / (float)K + eps);
  }
  __syncthreads();
  const int k = blockIdx.x * LORA_THREADS + tid;
  const bool ok = k < K;
  const float h = ok ? load_in(x, in_bf16, k) * rn * bf16_to_f32(norm_w[k]) : 0.f;
  for (int r0 = 0; r0 < R8; r0 += 8) {
    float p[8];
    if (ok) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(la + (size_t)k * R8 + r0));
      const __nv_bfloat16* wb = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
      for (int j = 0; j < 8; ++j) p[j] = h * bf16_to_f32(wb[j]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) p[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float t = warp_sum(p[j]);
      if (lane == 0) red[warp][r0 + j] = t;
    }
  }
  __syncthreads();
  if (tid < R8) {
    float t = 0.f;
    for (int w = 0; w < LORA_WARPS; ++w) t += red[w][tid];
    part[blockIdx.x * R8 + tid] = t;
  }
}

// out[n] += sum_r ax[r] * lb[r][n], ax[r] = sum of part[b][r] over nb blocks.
// lb (R8, N) bf16.
__global__ void __launch_bounds__(LORA_THREADS)
lora_up_kernel(const float* __restrict__ part, int nb, const __nv_bfloat16* __restrict__ lb, int R8,
               int N, float* out) {
  __shared__ float ax[LORA_MAX_R8];
  const int tid = threadIdx.x;
  if (tid < R8) {
    float t = 0.f;
    for (int b = 0; b < nb; ++b) t += part[b * R8 + tid];
    ax[tid] = t;
  }
  __syncthreads();
  const int n = blockIdx.x * LORA_THREADS + tid;
  if (n >= N) return;
  float d = 0.f;
  for (int r = 0; r < R8; ++r) d += ax[r] * bf16_to_f32(lb[(size_t)r * N + n]);
  out[n] += d;
}

}  // namespace

// One block of a decode entry. x_in: (D) bf16 (in_bf16 = 1, the entry's first
// block) or the f32 residual xs itself (in_bf16 = 0). Weights in the decode
// layout (qw_t, qscale_t, qzero_t per linear). Scratch: qkv (3D), part
// (H * ceil(S/128) * 130), y (D), gg (I) f32; xs (D) f32 holds the residual
// on return. x_out (D) bf16 is written when not null. With la not null, the
// LoRA operand la (D, R8) and lb (R8, 3D) bf16 updates qkv before RoPE;
// lora_part is its scratch, (ceil(D / 256), R8) f32.
LLT_EXPORT int k1_decode_layer(const void* x_in, int in_bf16, const void* rms1, const void* rms2,
                               const void* ca_w, const void* ca_s, const void* ca_z,
                               const void* cp_w, const void* cp_s, const void* cp_z,
                               const void* f12_w, const void* f12_s, const void* f12_z,
                               const void* mp_w, const void* mp_s, const void* mp_z, void* kc,
                               void* vc, const void* cosf, const void* sinf, void* qkv, void* part,
                               void* y, void* xs, void* gg, void* x_out, const void* la,
                               const void* lb, void* lora_part, int R8, int D, int I, int H, int S,
                               int gs, int write_pos, int limit, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int err = launch_gemv(x_in, in_bf16, rms1, ca_w, ca_s, ca_z, D, 3 * D, gs, EPI_NONE, nullptr, 0,
                        qkv, nullptr, st);
  if (err) return err;
  if (la != nullptr) {
    const int nb = (D + LORA_THREADS - 1) / LORA_THREADS;
    lora_down_kernel<<<nb, LORA_THREADS, 0, st>>>(x_in, in_bf16, (const __nv_bfloat16*)rms1, 1e-5f,
                                                  (const __nv_bfloat16*)la, D, R8,
                                                  (float*)lora_part);
    lora_up_kernel<<<(3 * D + LORA_THREADS - 1) / LORA_THREADS, LORA_THREADS, 0, st>>>(
        (const float*)lora_part, nb, (const __nv_bfloat16*)lb, R8, 3 * D, (float*)qkv);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  const int nch = (limit < S - 1 ? limit : S - 1) / CHUNK + 1;
  attn_partial_kernel<<<dim3(H, nch), 128, 0, st>>>((const float*)qkv, (const float*)cosf,
                                                    (const float*)sinf, (__nv_bfloat16*)kc,
                                                    (__nv_bfloat16*)vc, (float*)part, D, S,
                                                    write_pos, limit, (float)(1.0 / sqrt((double)HS)));
  attn_combine_kernel<<<H, 128, 0, st>>>((const float*)part, (float*)y, nch);
  err = (int)cudaGetLastError();
  if (err) return err;
  err = launch_gemv(y, 0, nullptr, cp_w, cp_s, cp_z, D, D, gs, EPI_RESIDUAL, x_in, in_bf16, xs,
                    nullptr, st);
  if (err) return err;
  err = launch_gemv(xs, 0, rms2, f12_w, f12_s, f12_z, D, 2 * I, gs, EPI_SWIGLU, nullptr, 0, gg,
                    nullptr, st);
  if (err) return err;
  return launch_gemv(gg, 0, nullptr, mp_w, mp_s, mp_z, I, D, gs, EPI_RESIDUAL, xs, 0, xs, x_out, st);
}

// logits (V) bf16 = rms_norm(x, ln_w) @ dequant(w), x (D) bf16, w in the
// decode layout.
LLT_EXPORT int k2_lm_head(const void* x, const void* ln_w, const void* wt, const void* st,
                          const void* zt, void* logits, int D, int V, int gs, void* stream) {
  return launch_gemv(x, 1, ln_w, wt, st, zt, D, V, gs, EPI_NONE, nullptr, 0, nullptr, logits,
                     (cudaStream_t)stream);
}
