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

#include "attention_chunk.cuh"

namespace {

constexpr int GEMV_THREADS = 256;
constexpr int GEMV_WARPS = GEMV_THREADS / 32;
constexpr int CPW = 2;  // columns per warp
constexpr int GEMV_BLOCKS_PER_SM = 2;
constexpr int HS = ATT_HS;
constexpr int CHUNK = ATT_CHUNK;  // cache slots per attention block

enum Epilogue { EPI_NONE = 0, EPI_RESIDUAL = 1, EPI_SWIGLU = 2 };

__device__ __forceinline__ float load_in(const void* p, int in_bf16, int i) {
  return in_bf16 ? bf16_to_f32(reinterpret_cast<const __nv_bfloat16*>(p)[i])
                 : reinterpret_cast<const float*>(p)[i];
}

// v in [0, 15] -> float, exactly: 2^23 + v has v in its low mantissa bits
__device__ __forceinline__ float nibble_f32(uint32_t v) {
  return __uint_as_float(0x4B000000u | v) - 8388608.f;
}

// sum over 16 packed bytes of x_lo[i] * low nibble + x_hi[i] * high nibble
__device__ __forceinline__ void dot16(const uint4 w, const float* xl, const float* xh, float& lo,
                                      float& hi) {
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 a = *reinterpret_cast<const float4*>(xl + 4 * q);
    const float4 b = *reinterpret_cast<const float4*>(xh + 4 * q);
    const uint32_t v = ws[q];
    lo += a.x * nibble_f32(v & 0xFu) + a.y * nibble_f32((v >> 8) & 0xFu) +
          a.z * nibble_f32((v >> 16) & 0xFu) + a.w * nibble_f32((v >> 24) & 0xFu);
    hi += b.x * nibble_f32((v >> 4) & 0xFu) + b.y * nibble_f32((v >> 12) & 0xFu) +
          b.z * nibble_f32((v >> 20) & 0xFu) + b.w * nibble_f32(v >> 28);
  }
}

// the columns of gemv task t: CPW adjacent ones, or gate j and up I + j
__device__ __forceinline__ void task_cols(int t, int N, int epi, int* col, bool* ok) {
  if (epi == EPI_SWIGLU) {
    col[0] = t;
    col[1] = N / 2 + t;
    ok[0] = ok[1] = true;
  } else {
#pragma unroll
    for (int c = 0; c < CPW; ++c) {
      col[c] = t * CPW + c;
      ok[c] = col[c] < N;
    }
  }
}

// out = [rms_norm](x) @ dequant(w) with an epilogue, from the column-major
// decode layout: wt (N, K/2) u8, st/zt (N, G) f32. x is (K) f32 or bf16.
// EPI_SWIGLU: N = 2I, warp j computes columns j and I + j, out has I.
template <int GS>
__global__ void __launch_bounds__(GEMV_THREADS, GEMV_BLOCKS_PER_SM)
gemv_int4_kernel(const void* __restrict__ x, int in_bf16, const __nv_bfloat16* __restrict__ norm_w,
                 float eps, const uint8_t* __restrict__ wt, const float* __restrict__ st,
                 const float* __restrict__ zt, int K, int N, int epi, const void* res, int res_bf16,
                 float* out_f32, __nv_bfloat16* __restrict__ out_bf16) {
  extern __shared__ __align__(16) float xs_s[];  // [K] bf16-rounded input, then gx [G]
  const int G = K / GS, Gh = G / 2, Kh = K / 2;
  float* gx = xs_s + K;
  __shared__ float red[GEMV_WARPS];
  __shared__ float rnorm;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // persistent: each warp walks tasks of CPW columns, so the prologue below
  // is paid once per block, not once per 16 columns
  const int ntasks = epi == EPI_SWIGLU ? N / 2 : (N + CPW - 1) / CPW;
  const int stride = gridDim.x * GEMV_WARPS;

  // prologue: optional RMSNorm scale, bf16-rounded input, f32 group sums
  float r = 1.f;
  if (norm_w != nullptr) {
    float ss = 0.f;
    for (int k = tid; k < K; k += GEMV_THREADS) {
      const float v = load_in(x, in_bf16, k);
      ss += v * v;
    }
    ss = warp_sum(ss);
    if (lane == 0) red[warp] = ss;
    __syncthreads();
    if (tid == 0) {
      float t = 0.f;
      for (int w = 0; w < GEMV_WARPS; ++w) t += red[w];
      rnorm = rsqrtf(t / (float)K + eps);
    }
    __syncthreads();
    r = rnorm;
  }
  for (int g = warp; g < G; g += GEMV_WARPS) {
    float s = 0.f;
    for (int i = lane; i < GS; i += 32) {
      const int k = g * GS + i;
      float h = load_in(x, in_bf16, k);
      if (norm_w != nullptr) h = h * r * bf16_to_f32(norm_w[k]);
      xs_s[k] = round_bf16(h);
      s += h;
    }
    s = warp_sum(s);
    if (lane == 0) gx[g] = s;
  }
  __syncthreads();

  const int nvec = Kh / 16;  // 16-byte vectors per column
  for (int task = blockIdx.x * GEMV_WARPS + warp; task < ntasks; task += stride) {
    int col[CPW];
    bool ok[CPW];
    task_cols(task, N, epi, col, ok);

    float acc[CPW];
#pragma unroll
    for (int c = 0; c < CPW; ++c) acc[c] = 0.f;
#pragma unroll 4
    for (int v = lane; v < nvec; v += 32) {
      const int r0 = v * 16, g = r0 / GS;
      uint4 w[CPW];
#pragma unroll
      for (int c = 0; c < CPW; ++c)
        w[c] = ok[c] ? __ldg(reinterpret_cast<const uint4*>(wt + (size_t)col[c] * Kh + r0))
                     : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int c = 0; c < CPW; ++c) {
        float lo = 0.f, hi = 0.f;
        dot16(w[c], xs_s + r0, xs_s + Kh + r0, lo, hi);
        if (ok[c]) {
          const float* sc = st + (size_t)col[c] * G;
          acc[c] += lo * __ldg(sc + g) + hi * __ldg(sc + Gh + g);
        }
      }
    }
    for (int g = lane; g < G; g += 32) {
#pragma unroll
      for (int c = 0; c < CPW; ++c)
        if (ok[c]) acc[c] += gx[g] * __ldg(zt + (size_t)col[c] * G + g);
    }
#pragma unroll
    for (int c = 0; c < CPW; ++c) acc[c] = warp_sum(acc[c]);

    if (lane == 0) {
      if (epi == EPI_SWIGLU) {
        out_f32[task] = acc[0] * (1.f / (1.f + expf(-acc[0]))) * acc[1];
      } else {
#pragma unroll
        for (int c = 0; c < CPW; ++c) {
          if (!ok[c]) continue;
          float v = acc[c];
          if (epi == EPI_RESIDUAL) v += load_in(res, res_bf16, col[c]);
          if (out_f32 != nullptr) out_f32[col[c]] = v;
          if (out_bf16 != nullptr) out_bf16[col[c]] = __float2bfloat16_rn(v);
        }
      }
    }
  }
}

int sm_count() {
  static int n = 0;  // the card's SM count, read once
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

template <int GS>
int launch_gemv_gs(const void* x, int in_bf16, const void* norm_w, const void* wt, const void* st,
                   const void* zt, int K, int N, int epi, const void* res, int res_bf16,
                   void* out_f32, void* out_bf16, cudaStream_t stream) {
  const size_t smem = ((size_t)K + K / GS) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(gemv_int4_kernel<GS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tasks = epi == EPI_SWIGLU ? N / 2 : (N + CPW - 1) / CPW;
  const int need = (tasks + GEMV_WARPS - 1) / GEMV_WARPS, cap = GEMV_BLOCKS_PER_SM * sm_count();
  const int blocks = need < cap ? need : cap;
  gemv_int4_kernel<GS><<<blocks, GEMV_THREADS, smem, stream>>>(
      x, in_bf16, (const __nv_bfloat16*)norm_w, 1e-5f, (const uint8_t*)wt, (const float*)st,
      (const float*)zt, K, N, epi, res, res_bf16, (float*)out_f32, (__nv_bfloat16*)out_bf16);
  return (int)cudaGetLastError();
}

// gs in {64, 128, 256} (checked by the Python wrappers)
int launch_gemv(const void* x, int in_bf16, const void* norm_w, const void* wt, const void* st,
                const void* zt, int K, int N, int gs, int epi, const void* res, int res_bf16,
                void* out_f32, void* out_bf16, cudaStream_t stream) {
  switch (gs) {
    case 64:
      return launch_gemv_gs<64>(x, in_bf16, norm_w, wt, st, zt, K, N, epi, res, res_bf16, out_f32,
                                out_bf16, stream);
    case 128:
      return launch_gemv_gs<128>(x, in_bf16, norm_w, wt, st, zt, K, N, epi, res, res_bf16, out_f32,
                                 out_bf16, stream);
    case 256:
      return launch_gemv_gs<256>(x, in_bf16, norm_w, wt, st, zt, K, N, epi, res, res_bf16, out_f32,
                                 out_bf16, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

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

}  // namespace

// One block of a decode entry. x_in: (D) bf16 (in_bf16 = 1, the entry's first
// block) or the f32 residual xs itself (in_bf16 = 0). Weights in the decode
// layout (qw_t, qscale_t, qzero_t per linear). Scratch: qkv (3D), part
// (H * ceil(S/128) * 130), y (D), gg (I) f32; xs (D) f32 holds the residual
// on return. x_out (D) bf16 is written when not null.
LLT_EXPORT int k1_decode_layer(const void* x_in, int in_bf16, const void* rms1, const void* rms2,
                               const void* ca_w, const void* ca_s, const void* ca_z,
                               const void* cp_w, const void* cp_s, const void* cp_z,
                               const void* f12_w, const void* f12_s, const void* f12_z,
                               const void* mp_w, const void* mp_s, const void* mp_z, void* kc,
                               void* vc, const void* cosf, const void* sinf, void* qkv, void* part,
                               void* y, void* xs, void* gg, void* x_out, int D, int I, int H, int S,
                               int gs, int write_pos, int limit, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int err = launch_gemv(x_in, in_bf16, rms1, ca_w, ca_s, ca_z, D, 3 * D, gs, EPI_NONE, nullptr, 0,
                        qkv, nullptr, st);
  if (err) return err;
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
