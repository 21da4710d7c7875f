// K4: causal flash-attention forward, O and the row log-sum-exp.
//
// Replaces lit_llama_tpu/ops/flash_attention.py _flash_kernel (entry
// _flash_forward / flash_attention).
//
// Bound on the H100: at prefill lengths (T <= 2048, hs = 128) the causal
// score and PV products, 2 * 2 * T * T/2 * hs per head, outweigh the bytes
// (q, k, v read once, o written once); exp and the row bookkeeping run on the
// CUDA cores beside them.
//
// Design (FlashAttention-2 shape): one block per (q-tile of 64 rows, head,
// batch), 4 warps, each warp owns 16 query rows. Q stays in registers as
// mma.sync A fragments; K and V tiles of 64 keys go through shared memory.
// S = Q K^T and O += P V run on mma.sync m16n8k16 (bf16 in, f32 accumulate);
// the running max and sum stay in f32 registers, P is rounded to bf16 for
// the PV product as the Pallas kernel does. Tiles above the diagonal are
// never visited; the diagonal tile and the ragged last tile (T % 64 != 0)
// are masked in the kernel, so T need not be a multiple of the tile.

#include "mma.cuh"

namespace {

constexpr int HS = 128, BQ = 64, BKV = 64, THREADS = 128;
constexpr int LDK = HS + 8;  // bf16 elements per shared row (bank spread)

__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int H, int T, float scale) {
  __shared__ __align__(16) __nv_bfloat16 Ks[BKV * LDK];
  __shared__ __align__(16) __nv_bfloat16 Vs[BKV * LDK];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t base = ((size_t)b * H + h) * (size_t)T * HS;
  const int q0 = qt * BQ + warp * 16;
  const int row0 = q0 + g, row1 = q0 + g + 8;

  // Q fragments for the warp's 16 rows, all 8 k-steps of hs = 128
  uint32_t qa[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const int c = kk * 16 + 2 * t;
    const uint32_t* r0p = reinterpret_cast<const uint32_t*>(q + base + (size_t)row0 * HS);
    const uint32_t* r1p = reinterpret_cast<const uint32_t*>(q + base + (size_t)row1 * HS);
    qa[kk][0] = row0 < T ? r0p[c / 2] : 0u;
    qa[kk][1] = row1 < T ? r1p[c / 2] : 0u;
    qa[kk][2] = row0 < T ? r0p[(c + 8) / 2] : 0u;
    qa[kk][3] = row1 < T ? r1p[(c + 8) / 2] : 0u;
  }

  float oacc[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m0 = LLT_NEG_INF, m1 = LLT_NEG_INF, l0 = 0.f, l1 = 0.f;

  const int n_tiles = qt + 1;  // BQ == BKV: tiles 0..qt reach the diagonal
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int vec = tid + THREADS * i;  // 64 rows x 16 vectors of 8 bf16
      const int r = vec / 16, c = (vec % 16) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < T) {
        kv = *reinterpret_cast<const uint4*>(k + base + (size_t)(k0 + r) * HS + c);
        vv = *reinterpret_cast<const uint4*>(v + base + (size_t)(k0 + r) * HS + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * LDK + c) = kv;
      *reinterpret_cast<uint4*>(Vs + r * LDK + c) = vv;
    }
    __syncthreads();

    // S = Q K^T: 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const uint32_t* krow = reinterpret_cast<const uint32_t*>(Ks + (j * 8 + g) * LDK);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        mma_bf16(s[j], qa[kk], krow[(kk * 16 + 2 * t) / 2], krow[(kk * 16 + 8 + 2 * t) / 2]);
    }
    // scale, causal and ragged masks, tile row max
    float mt0 = LLT_NEG_INF, mt1 = LLT_NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + j * 8 + 2 * t + e;
        const bool kin = key < T;
        s[j][e] = (kin && key <= row0) ? s[j][e] * scale : LLT_NEG_INF;
        s[j][2 + e] = (kin && key <= row1) ? s[j][2 + e] * scale : LLT_NEG_INF;
        mt0 = fmaxf(mt0, s[j][e]);
        mt1 = fmaxf(mt1, s[j][2 + e]);
      }
    }
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, o2));
      mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, o2));
    }
    const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);
    const float a0 = __expf(m0 - mn0), a1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = __expf(s[j][0] - mn0);
      s[j][1] = __expf(s[j][1] - mn0);
      s[j][2] = __expf(s[j][2] - mn1);
      s[j][3] = __expf(s[j][3] - mn1);
      ls0 += s[j][0] + s[j][1];
      ls1 += s[j][2] + s[j][3];
    }
    l0 = l0 * a0 + ls0;  // per-thread partial; the quad is summed at the end
    l1 = l1 * a1 + ls1;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      oacc[n][0] *= a0;
      oacc[n][1] *= a0;
      oacc[n][2] *= a1;
      oacc[n][3] *= a1;
    }
    // O += P V: P from the S accumulators (C layout -> A layout), 4 k-steps
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* v0 = Vs + (kk * 16 + 2 * t) * LDK;
      const __nv_bfloat16* v8 = Vs + (kk * 16 + 8 + 2 * t) * LDK;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int col = n * 8 + g;
        mma_bf16(oacc[n], pa, pack_bf16(v0[col], v0[LDK + col]), pack_bf16(v8[col], v8[LDK + col]));
      }
    }
  }

#pragma unroll
  for (int o2 = 1; o2 < 4; o2 <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o2);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const int col = n * 8 + 2 * t;
    if (row0 < T)
      *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)row0 * HS + col) =
          __floats2bfloat162_rn(oacc[n][0] * inv0, oacc[n][1] * inv0);
    if (row1 < T)
      *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)row1 * HS + col) =
          __floats2bfloat162_rn(oacc[n][2] * inv1, oacc[n][3] * inv1);
  }
  if (t == 0) {
    const size_t lbase = ((size_t)b * H + h) * (size_t)T;
    if (row0 < T) lse[lbase + row0] = m0 + logf(fmaxf(l0, 1e-30f));
    if (row1 < T) lse[lbase + row1] = m1 + logf(fmaxf(l1, 1e-30f));
  }
}

}  // namespace

// q, k, v, o (B, H, T, 128) bf16 contiguous; lse (B, H, T) f32.
LLT_EXPORT int k4_flash_forward(const void* q, const void* k, const void* v, void* o, void* lse,
                                int B, int H, int T, float scale, void* stream) {
  dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, (float*)lse, H, T, scale);
  return (int)cudaGetLastError();
}
