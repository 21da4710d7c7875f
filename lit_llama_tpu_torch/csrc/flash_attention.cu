// K4: causal flash-attention forward, O and the row log-sum-exp.
// K10: its backward, dQ and dK/dV (after K4 below).
//
// K4 replaces lit_llama_tpu/ops/flash_attention.py _flash_kernel (entry
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

// ---------------------------------------------------------------------------
// K10: causal flash-attention backward.
//
// Replaces lit_llama_tpu/ops/flash_attention.py _flash_dq_kernel and
// _flash_dkv_kernel (entry _flash_backward, under the custom_vjp of
// flash_attention).
//
// Bound on the H100: dQ runs three causal products (S = Q K^T, dP = dO V^T,
// dQ = dS K) and dK/dV four (S, dP, dV = P^T dO, dK = dS^T Q), each
// 2 * T * T/2 * hs per head; at T = 2048, hs = 128 they outweigh the bytes
// (q, k, v, o, dO read once, dq, dk, dv written once) about two to one.
//
// Design: the FlashAttention-2 recompute scheme in two kernels and no
// atomics, as the Pallas pair: every output element is summed by one thread
// in a fixed order, so the result repeats bit for bit from run to run.
//  - bwd_dot: D = rowsum(dO * O) in f32, one warp per row (JAX computes it in
//    XLA before its kernels).
//  - bwd_dq: one block per (64-row Q tile i, head, batch), 4 warps of 16 rows.
//    Q and dO stay in registers as mma A fragments; a loop over the KV tiles
//    j <= i (the TPU's sequential inner grid axis) stages K_j and V_j in
//    shared memory, recomputes S and dP on mma.sync m16n8k16, P = exp(S *
//    scale - lse) under the causal and ragged masks, dS = P * (dP - D) in
//    f32, and adds bf16(dS) K_j to an f32 register accumulator; times scale
//    at the end.
//  - bwd_dkv: one block per (64-row KV tile j, head, batch), 4 warps of 16
//    keys, computing the transposed tiles S^T = K Q^T and dP^T = V dO^T so
//    that P^T and dS^T come out of the accumulators already in the A layout of
//    the next products. K_j and V_j stay in shared memory for the whole loop
//    over Q tiles i >= j, which stages Q_i, dO_i, lse_i and D_i beside them
//    (70 KB of dynamic shared memory: K and V fragments in registers as well
//    would leave no room under 255 registers for the two (16 x 128) f32
//    accumulators). dV += bf16(P^T) dO_i, dK += bf16(dS^T) Q_i.
// Rounding follows the Pallas kernels: P is rounded to bf16 for dV, dS for dQ
// and dK; every sum is f32. Rows and keys past T (the ragged last tile) are
// loaded as zeros, masked out of P and never written.

constexpr int BWD_DKV_SMEM = 4 * BQ * LDK * 2 + 2 * BQ * 4;

__global__ void flash_bwd_dot_kernel(const __nv_bfloat16* __restrict__ o,
                                     const __nv_bfloat16* __restrict__ dout,
                                     float* __restrict__ dd, int rows) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const size_t off = (size_t)row * HS + lane * 4;
  const uint2 ov = *reinterpret_cast<const uint2*>(o + off);
  const uint2 dv = *reinterpret_cast<const uint2*>(dout + off);
  const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
  const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 a = __bfloat1622float2(o2[i]), b = __bfloat1622float2(d2[i]);
    s += a.x * b.x + a.y * b.y;
  }
  s = warp_sum(s);
  if (lane == 0) dd[row] = s;
}

// 64 rows x 128 bf16 of src (rows r0.. of one head, zeros past T) into dst
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int r0, int T,
                                           int tid) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int vec = tid + THREADS * i;  // 64 rows x 16 vectors of 8 bf16
    const int r = vec / 16, c = (vec % 16) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < T) val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * HS + c);
    *reinterpret_cast<uint4*>(dst + r * LDK + c) = val;
  }
}

// A fragments (16 rows from row0, all 8 k-steps of hs = 128) from global memory
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[8][4], const __nv_bfloat16* src, int row0,
                                            int T, int g, int t) {
  const int r0 = row0 + g, r1 = row0 + g + 8;
  const uint32_t* p0 = reinterpret_cast<const uint32_t*>(src + (size_t)r0 * HS);
  const uint32_t* p1 = reinterpret_cast<const uint32_t*>(src + (size_t)r1 * HS);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const int c = kk * 16 + 2 * t;
    a[kk][0] = r0 < T ? p0[c / 2] : 0u;
    a[kk][1] = r1 < T ? p1[c / 2] : 0u;
    a[kk][2] = r0 < T ? p0[(c + 8) / 2] : 0u;
    a[kk][3] = r1 < T ? p1[(c + 8) / 2] : 0u;
  }
}

__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dd,
                    __nv_bfloat16* __restrict__ dq, int H, int T, float scale) {
  __shared__ __align__(16) __nv_bfloat16 Ks[BKV * LDK];
  __shared__ __align__(16) __nv_bfloat16 Vs[BKV * LDK];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t base = ((size_t)b * H + h) * (size_t)T * HS;
  const size_t lbase = ((size_t)b * H + h) * (size_t)T;
  const int q0 = qt * BQ + warp * 16;
  const int row0 = q0 + g, row1 = q0 + g + 8;

  uint32_t qa[8][4], da[8][4];
  load_a_rows(qa, q + base, q0, T, g, t);
  load_a_rows(da, dout + base, q0, T, g, t);
  const float lse0 = row0 < T ? lse[lbase + row0] : 0.f, lse1 = row1 < T ? lse[lbase + row1] : 0.f;
  const float dd0 = row0 < T ? dd[lbase + row0] : 0.f, dd1 = row1 < T ? dd[lbase + row1] : 0.f;

  float acc[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {  // BQ == BKV: tiles 0..qt reach the diagonal
    const int k0 = kt * BKV;
    __syncthreads();
    stage_tile(Ks, k + base, k0, T, tid);
    stage_tile(Vs, v + base, k0, T, tid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 8 n-tiles of 8 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      const uint32_t* krow = reinterpret_cast<const uint32_t*>(Ks + (j * 8 + g) * LDK);
      const uint32_t* vrow = reinterpret_cast<const uint32_t*>(Vs + (j * 8 + g) * LDK);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        mma_bf16(s[j], qa[kk], krow[(kk * 16 + 2 * t) / 2], krow[(kk * 16 + 8 + 2 * t) / 2]);
        mma_bf16(dp[j], da[kk], vrow[(kk * 16 + 2 * t) / 2], vrow[(kk * 16 + 8 + 2 * t) / 2]);
      }
    }
    // P under the causal and ragged masks, then dS = P (dP - D) in place of S
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + j * 8 + 2 * t + e;
        const bool kin = key < T;
        const float p0 = (kin && key <= row0) ? __expf(s[j][e] * scale - lse0) : 0.f;
        const float p1 = (kin && key <= row1) ? __expf(s[j][2 + e] * scale - lse1) : 0.f;
        s[j][e] = p0 * (dp[j][e] - dd0);
        s[j][2 + e] = p1 * (dp[j][2 + e] - dd1);
      }
    }
    // dQ += bf16(dS) K: dS from the accumulators (C layout -> A layout), 4 k-steps of 16 keys
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* k0p = Ks + (kk * 16 + 2 * t) * LDK;
      const __nv_bfloat16* k8p = Ks + (kk * 16 + 8 + 2 * t) * LDK;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int col = n * 8 + g;
        mma_bf16(acc[n], pa, pack_bf16(k0p[col], k0p[LDK + col]), pack_bf16(k8p[col], k8p[LDK + col]));
      }
    }
  }

#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const int col = n * 8 + 2 * t;
    if (row0 < T)
      *reinterpret_cast<__nv_bfloat162*>(dq + base + (size_t)row0 * HS + col) =
          __floats2bfloat162_rn(acc[n][0] * scale, acc[n][1] * scale);
    if (row1 < T)
      *reinterpret_cast<__nv_bfloat162*>(dq + base + (size_t)row1 * HS + col) =
          __floats2bfloat162_rn(acc[n][2] * scale, acc[n][3] * scale);
  }
}

__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ dd,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H, int T,
                     float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + BKV * LDK;
  __nv_bfloat16* Qs = Vs + BKV * LDK;
  __nv_bfloat16* Ds = Qs + BQ * LDK;  // dO tile
  float* Ls = reinterpret_cast<float*>(Ds + BQ * LDK);
  float* DDs = Ls + BQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t base = ((size_t)b * H + h) * (size_t)T * HS;
  const size_t lbase = ((size_t)b * H + h) * (size_t)T;
  const int kw = warp * 16;  // the warp's first key inside the tile
  const int key0 = kt * BKV + kw + g, key1 = key0 + 8;

  stage_tile(Ks, k + base, kt * BKV, T, tid);
  stage_tile(Vs, v + base, kt * BKV, T, tid);

  float dka[16][4], dva[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }
  const uint32_t* kr0 = reinterpret_cast<const uint32_t*>(Ks + (kw + g) * LDK);
  const uint32_t* kr1 = reinterpret_cast<const uint32_t*>(Ks + (kw + g + 8) * LDK);
  const uint32_t* vr0 = reinterpret_cast<const uint32_t*>(Vs + (kw + g) * LDK);
  const uint32_t* vr1 = reinterpret_cast<const uint32_t*>(Vs + (kw + g + 8) * LDK);

  const int n_qt = (T + BQ - 1) / BQ;
  for (int qt = kt; qt < n_qt; ++qt) {  // Q tiles at or below the diagonal
    const int qs0 = qt * BQ;
    __syncthreads();
    stage_tile(Qs, q + base, qs0, T, tid);
    stage_tile(Ds, dout + base, qs0, T, tid);
    if (tid < BQ) {
      const bool in = qs0 + tid < T;
      Ls[tid] = in ? lse[lbase + qs0 + tid] : 0.f;
      DDs[tid] = in ? dd[lbase + qs0 + tid] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x 8 n-tiles of 8 queries
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int c0 = (kk * 16 + 2 * t) / 2, c8 = (kk * 16 + 8 + 2 * t) / 2;
      const uint32_t ka[4] = {kr0[c0], kr1[c0], kr0[c8], kr1[c8]};
      const uint32_t va[4] = {vr0[c0], vr1[c0], vr0[c8], vr1[c8]};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t* qrow = reinterpret_cast<const uint32_t*>(Qs + (j * 8 + g) * LDK);
        const uint32_t* drow = reinterpret_cast<const uint32_t*>(Ds + (j * 8 + g) * LDK);
        mma_bf16(s[j], ka, qrow[c0], qrow[c8]);
        mma_bf16(dp[j], va, drow[c0], drow[c8]);
      }
    }
    // P^T (kept in s) and dS^T (in place of dP^T); query qi sees key iff key <= qi < T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j * 8 + 2 * t + e, qi = qs0 + c;
        const float l = Ls[c], d = DDs[c];
        const bool qin = qi < T;
        const float p0 = (qin && qi >= key0) ? __expf(s[j][e] * scale - l) : 0.f;
        const float p1 = (qin && qi >= key1) ? __expf(s[j][2 + e] * scale - l) : 0.f;
        s[j][e] = p0;
        s[j][2 + e] = p1;
        dp[j][e] = p0 * (dp[j][e] - d);
        dp[j][2 + e] = p1 * (dp[j][2 + e] - d);
      }
    }
    // dV += bf16(P^T) dO_i and dK += bf16(dS^T) Q_i: 4 k-steps of 16 queries
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4], sa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      sa[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      sa[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      sa[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      sa[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
      const __nv_bfloat16* d0p = Ds + (kk * 16 + 2 * t) * LDK;
      const __nv_bfloat16* d8p = Ds + (kk * 16 + 8 + 2 * t) * LDK;
      const __nv_bfloat16* q0p = Qs + (kk * 16 + 2 * t) * LDK;
      const __nv_bfloat16* q8p = Qs + (kk * 16 + 8 + 2 * t) * LDK;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int col = n * 8 + g;
        mma_bf16(dva[n], pa, pack_bf16(d0p[col], d0p[LDK + col]), pack_bf16(d8p[col], d8p[LDK + col]));
        mma_bf16(dka[n], sa, pack_bf16(q0p[col], q0p[LDK + col]), pack_bf16(q8p[col], q8p[LDK + col]));
      }
    }
  }

#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const int col = n * 8 + 2 * t;
    if (key0 < T) {
      const size_t off = base + (size_t)key0 * HS + col;
      *reinterpret_cast<__nv_bfloat162*>(dk + off) = __floats2bfloat162_rn(dka[n][0] * scale, dka[n][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off) = __floats2bfloat162_rn(dva[n][0], dva[n][1]);
    }
    if (key1 < T) {
      const size_t off = base + (size_t)key1 * HS + col;
      *reinterpret_cast<__nv_bfloat162*>(dk + off) = __floats2bfloat162_rn(dka[n][2] * scale, dka[n][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off) = __floats2bfloat162_rn(dva[n][2], dva[n][3]);
    }
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

// K10, first half: D = rowsum(dO * O) into dd (B, H, T) f32, then dq. q, k,
// v, o, dout, dq (B, H, T, 128) bf16 contiguous; lse (B, H, T) f32.
LLT_EXPORT int k10_flash_backward_dq(const void* q, const void* k, const void* v, const void* o,
                                     const void* dout, const void* lse, void* dd, void* dq, int B,
                                     int H, int T, float scale, void* stream) {
  const int rows = B * H * T;
  flash_bwd_dot_kernel<<<(rows + 7) / 8, 256, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, (float*)dd, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_bwd_dq_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)dout, (const float*)lse, (const float*)dd, (__nv_bfloat16*)dq, H, T, scale);
  return (int)cudaGetLastError();
}

// K10, second half: dk and dv from the dd that k10_flash_backward_dq wrote.
LLT_EXPORT int k10_flash_backward_dkv(const void* q, const void* k, const void* v, const void* dout,
                                      const void* lse, const void* dd, void* dk, void* dv, int B,
                                      int H, int T, float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_DKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BKV - 1) / BKV, H, B);
  flash_bwd_dkv_kernel<<<grid, THREADS, BWD_DKV_SMEM, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)dout, (const float*)lse, (const float*)dd, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, H, T, scale);
  return (int)cudaGetLastError();
}
