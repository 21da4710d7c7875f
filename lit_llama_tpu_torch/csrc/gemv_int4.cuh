// The int4 matvec of K1 and K2 (and of the small-N probe): one row x (K) times
// dequant(w) from the column-major decode layout, with an optional RMSNorm
// prologue and a residual or SiLU(gate) * up epilogue. The design is noted in
// fused_layer.cu.
#pragma once

#include "common.cuh"

namespace {

constexpr int GEMV_THREADS = 256;
constexpr int GEMV_WARPS = GEMV_THREADS / 32;
constexpr int CPW = 2;  // columns per warp
constexpr int GEMV_BLOCKS_PER_SM = 2;

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

}  // namespace
