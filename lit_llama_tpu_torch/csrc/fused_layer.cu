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
// over all SMs. In bf16 compute (the main path) five launches, chained by
// programmatic dependent launch (each kernel asks for the weights or cache
// rows it needs before it waits on the kernel before it, csrc/common.cuh):
//   1. the int4 matvec with an RMSNorm prologue (rms_1) -> qkv, f32
//   2. the split attention (decode_sm90.cuh, its F32 arithmetic): per
//      (split, head) block, half-basis RoPE of q (and, in the split holding
//      write_pos, of k, with the bf16 k/v row write before that split is
//      read), the online softmax over the split's slots <= limit, and the
//      merge of the splits by the last block of a head to arrive -> y, f32
//   3. the matvec with a residual epilogue (attn c_proj) -> xs, f32
//   4. the matvec with an RMSNorm prologue (rms_2) and a SiLU(gate) * up
//      epilogue (c_fc12: a block owns gate columns j.. j + 7 and up I + j..)
//      -> gg, f32
//   5. the matvec with a residual epilogue (mlp c_proj) -> xs, f32, and the
//      bf16 output row on the last block of an entry
// The matvec (gemv_sm90.cuh: tensor cores, a cp.async ring, its design noted
// there) reads the decode layout that prepare_fused_params adds: each
// column's packed bytes contiguous (qw_t (N, K/2)) and its scale/zero rows
// (qscale_t, qzero_t (N, G)). The nibble products take the bf16-rounded input
// (exact, as the MXU products of the Pallas kernel), the zero-point term
// comes from f32 group sums of the unrounded input, and the residual stays
// f32 inside the block, as in the Pallas kernel.
// f32 compute keeps the first port's six launches: the FFMA matvec of
// gemv_int4.cuh (a warp owns two columns and walks K in 16-byte loads;
// nibbles become floats by the exponent trick; persistent blocks, two per
// SM), and attn_partial (a block per (head, 64-slot chunk): a pair of
// threads scores a slot, a thread owns a head element of the v sum) with
// attn_combine merging the chunks (attention_chunk.cuh).
//
// The LoRA operand (the Pallas kernel's _add_lora_delta after the QKV
// matvec: qkv += (h @ lora_af) @ lora_bf in f32, h the unrounded normed row)
// runs between steps 1 and 2 when the layer has one, as two more kernels:
//   1a. lora_down: one row of lora_af (D, R8) per thread, h recomputed from
//       x with the same norm as the prologue; the block's R8 column sums go
//       to part (blocks, R8), f32, in a fixed order, 64 columns a pass, so
//       any R8 fits the block's shared memory
//   1b. lora_up: ax = the sum of part's rows (R8 floats of dynamic shared
//       memory); one qkv column per thread adds ax @ lora_bf[:, n] (lora_bf
//       (R8, 3D), scaling folded in)
// The operand is bf16 or f32 (a template parameter), read as it is stored
// and summed in f32, as the Pallas kernel's astype(f32).
//
// f32 compute (the Pallas kernel's cdtype = f32): the matvecs take the input
// unrounded, the cache and the output row are f32, and the attention reads
// the f32 cache; everything else is the bf16 path's, which already sums and
// keeps its intermediates in f32. The norm weights are bf16 or f32, applied
// in f32 (_rms_norm_rows).
// Bound: bytes, D * R8 * 2 + R8 * 3D * 2 (0.5 MB at 7B, R8 = 16: 0.16 us at
// 3.35 TB/s); the two launches' latency is most of their time.

#include "attention_chunk.cuh"
#include "decode_sm90.cuh"
#include "gemv_sm90.cuh"

namespace {

constexpr int HS = ATT_HS;
constexpr int CHUNK = ATT_CHUNK;  // cache slots per attention block

// Block (head h, chunk c) of one decode token's attention. qkv (3D) f32 in
// the half-rotation basis; caches (H, S, 128) of CT (the compute dtype, bf16
// or f32), updated in place at write_pos. Writes the chunk's running max, sum
// and unnormalised output.
template <typename CT>
__global__ void __launch_bounds__(128)
attn_partial_kernel(const float* __restrict__ qkv, const float* __restrict__ cosf,
                    const float* __restrict__ sinf, CT* kc, CT* vc, float* __restrict__ part, int D,
                    int S, int write_pos, int limit, float scale) {
  __shared__ __align__(16) float q_s[HS];
  const int h = blockIdx.x, c = blockIdx.y, nch = gridDim.y;
  const int d = threadIdx.x;  // one head element per thread
  const int partner = (d + HS / 2) % HS;
  const size_t cbase = (size_t)h * S * HS;

  q_s[d] = qkv[h * HS + d] * cosf[d] + qkv[h * HS + partner] * sinf[d];
  const int s0 = c * CHUNK;
  if (write_pos >= s0 && write_pos < s0 + CHUNK) {
    const float* kq = qkv + D + h * HS;
    kc[cbase + (size_t)write_pos * HS + d] = from_f32<CT>(kq[d] * cosf[d] + kq[partner] * sinf[d]);
    vc[cbase + (size_t)write_pos * HS + d] = from_f32<CT>(qkv[2 * D + h * HS + d]);
  }
  __syncthreads();  // q_s and the new cache row are visible to the block

  const int last = min(limit, S - 1);
  const int n = min(CHUNK, last - s0 + 1);  // visible slots of this chunk (>= 1)
  attn_chunk_partial<CT>(q_s, kc + cbase, vc + cbase, s0, n, scale,
                         part + ((size_t)h * nch + c) * ATT_PART);
}

__global__ void __launch_bounds__(128)
attn_combine_kernel(const float* __restrict__ part, float* __restrict__ y, int nch) {
  const int h = blockIdx.x, d = threadIdx.x;
  y[h * HS + d] = attn_combine(part + (size_t)h * nch * ATT_PART, nch, d);
}

constexpr int LORA_THREADS = 256;
constexpr int LORA_WARPS = LORA_THREADS / 32;
constexpr int LORA_RC = 64;  // operand columns a pass of lora_down reduces

// part[blockIdx.x][r] = sum over this block's rows k of h[k] * la[k][r], with
// h = rms_norm(x, norm_w) in f32 (not rounded). la (K, R8) of LT (bf16 or
// f32), R8 % 8 == 0, any R8: the columns go in passes of LORA_RC.
template <typename LT>
__global__ void __launch_bounds__(LORA_THREADS)
lora_down_kernel(const void* __restrict__ x, int in_bf16, const void* __restrict__ norm_w,
                 int norm_bf16, float eps, const LT* __restrict__ la, int K, int R8,
                 float* __restrict__ part) {
  __shared__ float wred[LORA_WARPS];
  __shared__ float rn;
  __shared__ float red[LORA_WARPS][LORA_RC];
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
  const float h = ok ? load_in(x, in_bf16, k) * rn * load_in(norm_w, norm_bf16, k) : 0.f;
  for (int c0 = 0; c0 < R8; c0 += LORA_RC) {
    const int nc = min(LORA_RC, R8 - c0);
    for (int r0 = 0; r0 < nc; r0 += 8) {
      float p[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (ok) {
        load8(la + (size_t)k * R8 + c0 + r0, p);
#pragma unroll
        for (int j = 0; j < 8; ++j) p[j] *= h;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float t = warp_sum(p[j]);
        if (lane == 0) red[warp][r0 + j] = t;
      }
    }
    __syncthreads();
    if (tid < nc) {
      float t = 0.f;
      for (int w = 0; w < LORA_WARPS; ++w) t += red[w][tid];
      part[blockIdx.x * R8 + c0 + tid] = t;
    }
    __syncthreads();  // red is free for the next pass
  }
}

// out[n] += sum_r ax[r] * lb[r][n], ax[r] = sum of part[b][r] over nb blocks
// (R8 floats of dynamic shared memory). lb (R8, N) of LT.
template <typename LT>
__global__ void __launch_bounds__(LORA_THREADS)
lora_up_kernel(const float* __restrict__ part, int nb, const LT* __restrict__ lb, int R8, int N,
               float* out) {
  extern __shared__ float ax[];
  const int tid = threadIdx.x;
  for (int r = tid; r < R8; r += LORA_THREADS) {
    float t = 0.f;
    for (int b = 0; b < nb; ++b) t += part[b * R8 + r];
    ax[r] = t;
  }
  __syncthreads();
  const int n = blockIdx.x * LORA_THREADS + tid;
  if (n >= N) return;
  float d = 0.f;
  for (int r = 0; r < R8; ++r) d += ax[r] * to_f32(lb[(size_t)r * N + n]);
  out[n] += d;
}

template <typename LT>
int launch_lora(const void* x_in, int in_bf16, const void* rms1, int norm_bf16, const void* la,
                const void* lb, void* lora_part, int R8, int D, void* qkv, cudaStream_t st) {
  const int nb = (D + LORA_THREADS - 1) / LORA_THREADS;
  lora_down_kernel<LT><<<nb, LORA_THREADS, 0, st>>>(x_in, in_bf16, rms1, norm_bf16, 1e-5f,
                                                    (const LT*)la, D, R8, (float*)lora_part);
  const size_t smem = (size_t)R8 * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(lora_up_kernel<LT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  lora_up_kernel<LT><<<(3 * D + LORA_THREADS - 1) / LORA_THREADS, LORA_THREADS, smem, st>>>(
      (const float*)lora_part, nb, (const LT*)lb, R8, 3 * D, (float*)qkv);
  return (int)cudaGetLastError();
}

}  // namespace

// One block of a decode entry. x_in: (D) bf16 (in_bf16 = 1) or f32: the
// entry's row, or the f32 residual xs itself. cbf16: the compute dtype is
// bf16 (else f32): the matvecs' inputs are rounded to it, the caches (H, S,
// 128) and x_out (D) hold it. rms1/rms2 (D) bf16 (norm_bf16 = 1) or f32.
// Weights in the decode layout (qw_t, qscale_t, qzero_t per linear).
// Scratch: qkv (3D), part (H * ceil(S/64) * 130 floats in f32 compute,
// H * dsm90::n_splits(S) * 130 in bf16), y (D), gg (I) f32; counter (H)
// int32, zeros, left zeros (bf16); xs (D) f32 holds the residual on return. x_out is written when not null. With la
// not null, the LoRA operand la (D, R8) and lb (R8, 3D), bf16 (lora_bf16 = 1)
// or f32, R8 % 8 == 0, updates qkv before RoPE; lora_part is its scratch,
// (ceil(D / 256), R8) f32.
LLT_EXPORT int k1_decode_layer(const void* x_in, int in_bf16, const void* rms1, const void* rms2,
                               int norm_bf16, int cbf16, const void* ca_w, const void* ca_s,
                               const void* ca_z, const void* cp_w, const void* cp_s,
                               const void* cp_z, const void* f12_w, const void* f12_s,
                               const void* f12_z, const void* mp_w, const void* mp_s,
                               const void* mp_z, void* kc, void* vc, const void* cosf,
                               const void* sinf, void* qkv, void* part, void* counter, void* y, void* xs, void* gg,
                               void* x_out, const void* la, const void* lb, void* lora_part, int R8,
                               int lora_bf16, int D, int I, int H, int S, int gs, int write_pos,
                               int limit, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int err = launch_gemv(Gemv{x_in, in_bf16, rms1, norm_bf16, ca_w, ca_s, ca_z, D, 3 * D, gs, EPI_NONE,
                             nullptr, 0, cbf16, qkv, nullptr}, st);
  if (err) return err;
  if (la != nullptr) {
    err = lora_bf16 ? launch_lora<__nv_bfloat16>(x_in, in_bf16, rms1, norm_bf16, la, lb, lora_part, R8, D, qkv, st)
                    : launch_lora<float>(x_in, in_bf16, rms1, norm_bf16, la, lb, lora_part, R8, D, qkv, st);
    if (err) return err;
  }
  const int last = limit < S - 1 ? limit : S - 1;
  if (cbf16) {
    err = dsm90::launch_k1_attn((const float*)qkv, (const float*)cosf, (const float*)sinf, (__nv_bfloat16*)kc,
                                (__nv_bfloat16*)vc, (float*)part, (int*)counter, (float*)y, D, H, S, write_pos, last,
                                st);
  } else {
    const int nch = last / CHUNK + 1;
    attn_partial_kernel<float><<<dim3(H, nch), 128, 0, st>>>(
        (const float*)qkv, (const float*)cosf, (const float*)sinf, (float*)kc, (float*)vc, (float*)part, D,
        S, write_pos, limit, (float)(1.0 / sqrt((double)HS)));
    attn_combine_kernel<<<H, 128, 0, st>>>((const float*)part, (float*)y, nch);
    err = (int)cudaGetLastError();
  }
  if (err) return err;
  err = launch_gemv(Gemv{y, 0, nullptr, 0, cp_w, cp_s, cp_z, D, D, gs, EPI_RESIDUAL, x_in, in_bf16, cbf16,
                         xs, nullptr}, st);
  if (err) return err;
  err = launch_gemv(Gemv{xs, 0, rms2, norm_bf16, f12_w, f12_s, f12_z, D, 2 * I, gs, EPI_SWIGLU, nullptr, 0,
                         cbf16, gg, nullptr}, st);
  if (err) return err;
  return launch_gemv(Gemv{gg, 0, nullptr, 0, mp_w, mp_s, mp_z, I, D, gs, EPI_RESIDUAL, xs, 0, cbf16, xs,
                          x_out}, st);
}

// logits (V) = rms_norm(x, ln_w) @ dequant(w), w in the decode layout. cbf16:
// x (D) and the logits are bf16, else f32; ln_w (D) bf16 (norm_bf16 = 1) or
// f32.
LLT_EXPORT int k2_lm_head(const void* x, const void* ln_w, int norm_bf16, int cbf16, const void* wt,
                          const void* st, const void* zt, void* logits, int D, int V, int gs,
                          void* stream) {
  return launch_gemv(Gemv{x, cbf16, ln_w, norm_bf16, wt, st, zt, D, V, gs, EPI_NONE, nullptr, 0, cbf16,
                          nullptr, logits}, (cudaStream_t)stream);
}
