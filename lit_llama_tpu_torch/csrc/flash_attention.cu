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
//
// Head size (HS, a template parameter): 128 or 256 in bf16 (past 256, the
// chunked kernels near the end of the file). At 256 a warp's
// (16 x 256) f32 O accumulator takes 128 registers, so Q's fragments are read
// from a shared tile at each k-step instead of held in registers; the
// backward kernels split their output columns in halves of 128 over the grid
// (each half recomputes S and dP over the full head), so their accumulators
// stay (16 x 128). f32 compute takes the FFMA bodies further below.

#include "mma.cuh"

namespace {

constexpr int BQ = 64, BKV = 64, THREADS = 128;
constexpr int NCOL = 128;  // output columns of a backward block

// bf16 elements per shared row of an HS-wide tile (bank spread)
template <int HS>
__host__ __device__ constexpr int ld_of() { return HS + 8; }

// 64 rows x HS bf16 of src (rows r0.. of one head, zeros past T) into dst
template <int HS>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int r0, int T,
                                           int tid) {
  constexpr int VR = HS / 8;  // 16-byte vectors a row
#pragma unroll
  for (int i = 0; i < 64 * VR / THREADS; ++i) {
    const int vec = tid + THREADS * i;
    const int r = vec / VR, c = (vec % VR) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < T) val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * HS + c);
    *reinterpret_cast<uint4*>(dst + r * ld_of<HS>() + c) = val;
  }
}

// A fragments (16 rows from row0, all HS / 16 k-steps) from global memory
template <int HS>
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[HS / 16][4], const __nv_bfloat16* src, int row0,
                                            int T, int g, int t) {
  const int r0 = row0 + g, r1 = row0 + g + 8;
  const uint32_t* p0 = reinterpret_cast<const uint32_t*>(src + (size_t)r0 * HS);
  const uint32_t* p1 = reinterpret_cast<const uint32_t*>(src + (size_t)r1 * HS);
#pragma unroll
  for (int kk = 0; kk < HS / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    a[kk][0] = r0 < T ? p0[c / 2] : 0u;
    a[kk][1] = r1 < T ? p1[c / 2] : 0u;
    a[kk][2] = r0 < T ? p0[(c + 8) / 2] : 0u;
    a[kk][3] = r1 < T ? p1[(c + 8) / 2] : 0u;
  }
}

// The A fragment of rows row0 + g (+ 8) at k-step kk from a shared tile
__device__ __forceinline__ void frag_a_smem(uint32_t* a, const __nv_bfloat16* tile, int ld, int row0, int kk,
                                            int g, int t) {
  const uint32_t* r0 = reinterpret_cast<const uint32_t*>(tile + (row0 + g) * ld);
  const uint32_t* r1 = reinterpret_cast<const uint32_t*>(tile + (row0 + g + 8) * ld);
  const int c0 = (kk * 16 + 2 * t) / 2, c8 = (kk * 16 + 8 + 2 * t) / 2;
  a[0] = r0[c0], a[1] = r1[c0], a[2] = r0[c8], a[3] = r1[c8];
}

template <int HS>
constexpr int fwd_smem() { return (2 * BKV + (HS > 128 ? BQ : 0)) * ld_of<HS>() * 2; }

template <int HS>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int H, int T, float scale) {
  constexpr int KS = HS / 16, NO = HS / 8, LD = ld_of<HS>();
  constexpr bool QREG = HS == 128;  // Q's fragments in registers, else read from Qs
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + BKV * LD;
  __nv_bfloat16* Qs = Vs + BKV * LD;  // [BQ][LD] past head size 128

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t base = ((size_t)b * H + h) * (size_t)T * HS;
  const int q0 = qt * BQ + warp * 16;
  const int row0 = q0 + g, row1 = q0 + g + 8;

  uint32_t qa[QREG ? KS : 1][4];
  if constexpr (QREG)
    load_a_rows<HS>(qa, q + base, q0, T, g, t);
  else
    stage_tile<HS>(Qs, q + base, qt * BQ, T, tid);  // visible after the loop's first sync

  float oacc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m0 = LLT_NEG_INF, m1 = LLT_NEG_INF, l0 = 0.f, l1 = 0.f;

  const int n_tiles = qt + 1;  // BQ == BKV: tiles 0..qt reach the diagonal
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();
    stage_tile<HS>(Ks, k + base, k0, T, tid);
    stage_tile<HS>(Vs, v + base, k0, T, tid);
    __syncthreads();

    // S = Q K^T: 8 n-tiles of 8 keys, summed over the k-steps in order
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t af[4];
      const uint32_t* a = af;
      if constexpr (QREG)
        a = qa[kk];
      else
        frag_a_smem(af, Qs, LD, warp * 16, kk, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t* krow = reinterpret_cast<const uint32_t*>(Ks + (j * 8 + g) * LD);
        mma_bf16(s[j], a, krow[(kk * 16 + 2 * t) / 2], krow[(kk * 16 + 8 + 2 * t) / 2]);
      }
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
    for (int n = 0; n < NO; ++n) {
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
      const __nv_bfloat16* v0 = Vs + (kk * 16 + 2 * t) * LD;
      const __nv_bfloat16* v8 = Vs + (kk * 16 + 8 + 2 * t) * LD;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int col = n * 8 + g;
        mma_bf16(oacc[n], pa, pack_bf16(v0[col], v0[LD + col]), pack_bf16(v8[col], v8[LD + col]));
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
  for (int n = 0; n < NO; ++n) {
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
//  - bwd_dq: one block per (64-row Q tile i, 128 output columns, head,
//    batch), 4 warps of 16 rows. Q and dO stay in registers as mma A
//    fragments (in shared memory past head size 128); a loop over the KV tiles
//    j <= i (the TPU's sequential inner grid axis) stages K_j and V_j in
//    shared memory, recomputes S and dP on mma.sync m16n8k16, P = exp(S *
//    scale - lse) under the causal and ragged masks, dS = P * (dP - D) in
//    f32, and adds bf16(dS) K_j to an f32 register accumulator; times scale
//    at the end.
//  - bwd_dkv: one block per (64-row KV tile j, 128 output columns, head,
//    batch), 4 warps of 16
//    keys, computing the transposed tiles S^T = K Q^T and dP^T = V dO^T so
//    that P^T and dS^T come out of the accumulators already in the A layout of
//    the next products. K_j and V_j stay in shared memory for the whole loop
//    over Q tiles i >= j, which stages Q_i, dO_i, lse_i and D_i beside them
//    (70 KB of dynamic shared memory at head size 128, 133 KB at 256: K and V
//    fragments in registers as well would leave no room under 255 registers
//    for the two (16 x 128) f32 accumulators). dV += bf16(P^T) dO_i, dK +=
//    bf16(dS^T) Q_i.
// Rounding follows the Pallas kernels: P is rounded to bf16 for dV, dS for dQ
// and dK; every sum is f32. Rows and keys past T (the ragged last tile) are
// loaded as zeros, masked out of P and never written.

__global__ void flash_bwd_dot_kernel(const __nv_bfloat16* __restrict__ o,
                                     const __nv_bfloat16* __restrict__ dout,
                                     float* __restrict__ dd, int rows) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const size_t off = (size_t)row * 128 + lane * 4;
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

template <int HS>
constexpr int dq_smem() { return (2 * BKV + (HS > 128 ? 2 * BQ : 0)) * ld_of<HS>() * 2; }

template <int HS>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dd,
                    __nv_bfloat16* __restrict__ dq, int H, int T, float scale) {
  constexpr int KS = HS / 16, LD = ld_of<HS>(), NSPL = HS / NCOL;
  constexpr bool QREG = HS == 128;  // Q's and dO's fragments in registers, else read from Qs, Ds
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + BKV * LD;
  __nv_bfloat16* Qs = Vs + BKV * LD;  // past head size 128: [BQ][LD] each
  __nv_bfloat16* Ds = Qs + BQ * LD;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int qt = blockIdx.x / NSPL, c_off = (blockIdx.x % NSPL) * NCOL, h = blockIdx.y, b = blockIdx.z;
  const size_t base = ((size_t)b * H + h) * (size_t)T * HS;
  const size_t lbase = ((size_t)b * H + h) * (size_t)T;
  const int q0 = qt * BQ + warp * 16;
  const int row0 = q0 + g, row1 = q0 + g + 8;

  uint32_t qa[QREG ? KS : 1][4], da[QREG ? KS : 1][4];
  if constexpr (QREG) {
    load_a_rows<HS>(qa, q + base, q0, T, g, t);
    load_a_rows<HS>(da, dout + base, q0, T, g, t);
  } else {  // visible after the loop's first sync
    stage_tile<HS>(Qs, q + base, qt * BQ, T, tid);
    stage_tile<HS>(Ds, dout + base, qt * BQ, T, tid);
  }
  const float lse0 = row0 < T ? lse[lbase + row0] : 0.f, lse1 = row1 < T ? lse[lbase + row1] : 0.f;
  const float dd0 = row0 < T ? dd[lbase + row0] : 0.f, dd1 = row1 < T ? dd[lbase + row1] : 0.f;

  float acc[NCOL / 8][4];
#pragma unroll
  for (int n = 0; n < NCOL / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {  // BQ == BKV: tiles 0..qt reach the diagonal
    const int k0 = kt * BKV;
    __syncthreads();
    stage_tile<HS>(Ks, k + base, k0, T, tid);
    stage_tile<HS>(Vs, v + base, k0, T, tid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 8 n-tiles of 8 keys, summed over the k-steps in order
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qf[4], df[4];
      const uint32_t *qa_ = qf, *da_ = df;
      if constexpr (QREG) {
        qa_ = qa[kk];
        da_ = da[kk];
      } else {
        frag_a_smem(qf, Qs, LD, warp * 16, kk, g, t);
        frag_a_smem(df, Ds, LD, warp * 16, kk, g, t);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t* krow = reinterpret_cast<const uint32_t*>(Ks + (j * 8 + g) * LD);
        const uint32_t* vrow = reinterpret_cast<const uint32_t*>(Vs + (j * 8 + g) * LD);
        mma_bf16(s[j], qa_, krow[(kk * 16 + 2 * t) / 2], krow[(kk * 16 + 8 + 2 * t) / 2]);
        mma_bf16(dp[j], da_, vrow[(kk * 16 + 2 * t) / 2], vrow[(kk * 16 + 8 + 2 * t) / 2]);
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
    // dQ[:, c_off ..] += bf16(dS) K: dS from the accumulators (C layout -> A
    // layout), 4 k-steps of 16 keys
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* k0p = Ks + (kk * 16 + 2 * t) * LD + c_off;
      const __nv_bfloat16* k8p = Ks + (kk * 16 + 8 + 2 * t) * LD + c_off;
#pragma unroll
      for (int n = 0; n < NCOL / 8; ++n) {
        const int col = n * 8 + g;
        mma_bf16(acc[n], pa, pack_bf16(k0p[col], k0p[LD + col]), pack_bf16(k8p[col], k8p[LD + col]));
      }
    }
  }

#pragma unroll
  for (int n = 0; n < NCOL / 8; ++n) {
    const int col = c_off + n * 8 + 2 * t;
    if (row0 < T)
      *reinterpret_cast<__nv_bfloat162*>(dq + base + (size_t)row0 * HS + col) =
          __floats2bfloat162_rn(acc[n][0] * scale, acc[n][1] * scale);
    if (row1 < T)
      *reinterpret_cast<__nv_bfloat162*>(dq + base + (size_t)row1 * HS + col) =
          __floats2bfloat162_rn(acc[n][2] * scale, acc[n][3] * scale);
  }
}

template <int HS>
constexpr int dkv_smem() { return 4 * BQ * ld_of<HS>() * 2 + 2 * BQ * 4; }

template <int HS>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ dd,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H, int T,
                     float scale) {
  constexpr int KS = HS / 16, LD = ld_of<HS>(), NSPL = HS / NCOL;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + BKV * LD;
  __nv_bfloat16* Qs = Vs + BKV * LD;
  __nv_bfloat16* Ds = Qs + BQ * LD;  // dO tile
  float* Ls = reinterpret_cast<float*>(Ds + BQ * LD);
  float* DDs = Ls + BQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int kt = blockIdx.x / NSPL, c_off = (blockIdx.x % NSPL) * NCOL, h = blockIdx.y, b = blockIdx.z;
  const size_t base = ((size_t)b * H + h) * (size_t)T * HS;
  const size_t lbase = ((size_t)b * H + h) * (size_t)T;
  const int kw = warp * 16;  // the warp's first key inside the tile
  const int key0 = kt * BKV + kw + g, key1 = key0 + 8;

  stage_tile<HS>(Ks, k + base, kt * BKV, T, tid);
  stage_tile<HS>(Vs, v + base, kt * BKV, T, tid);

  float dka[NCOL / 8][4], dva[NCOL / 8][4];
#pragma unroll
  for (int n = 0; n < NCOL / 8; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }
  const uint32_t* kr0 = reinterpret_cast<const uint32_t*>(Ks + (kw + g) * LD);
  const uint32_t* kr1 = reinterpret_cast<const uint32_t*>(Ks + (kw + g + 8) * LD);
  const uint32_t* vr0 = reinterpret_cast<const uint32_t*>(Vs + (kw + g) * LD);
  const uint32_t* vr1 = reinterpret_cast<const uint32_t*>(Vs + (kw + g + 8) * LD);

  const int n_qt = (T + BQ - 1) / BQ;
  for (int qt = kt; qt < n_qt; ++qt) {  // Q tiles at or below the diagonal
    const int qs0 = qt * BQ;
    __syncthreads();
    stage_tile<HS>(Qs, q + base, qs0, T, tid);
    stage_tile<HS>(Ds, dout + base, qs0, T, tid);
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
    for (int kk = 0; kk < KS; ++kk) {
      const int c0 = (kk * 16 + 2 * t) / 2, c8 = (kk * 16 + 8 + 2 * t) / 2;
      const uint32_t ka[4] = {kr0[c0], kr1[c0], kr0[c8], kr1[c8]};
      const uint32_t va[4] = {vr0[c0], vr1[c0], vr0[c8], vr1[c8]};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t* qrow = reinterpret_cast<const uint32_t*>(Qs + (j * 8 + g) * LD);
        const uint32_t* drow = reinterpret_cast<const uint32_t*>(Ds + (j * 8 + g) * LD);
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
    // dV[:, c_off ..] += bf16(P^T) dO_i and dK[:, c_off ..] += bf16(dS^T) Q_i:
    // 4 k-steps of 16 queries
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
      const __nv_bfloat16* d0p = Ds + (kk * 16 + 2 * t) * LD + c_off;
      const __nv_bfloat16* d8p = Ds + (kk * 16 + 8 + 2 * t) * LD + c_off;
      const __nv_bfloat16* q0p = Qs + (kk * 16 + 2 * t) * LD + c_off;
      const __nv_bfloat16* q8p = Qs + (kk * 16 + 8 + 2 * t) * LD + c_off;
#pragma unroll
      for (int n = 0; n < NCOL / 8; ++n) {
        const int col = n * 8 + g;
        mma_bf16(dva[n], pa, pack_bf16(d0p[col], d0p[LD + col]), pack_bf16(d8p[col], d8p[LD + col]));
        mma_bf16(dka[n], sa, pack_bf16(q0p[col], q0p[LD + col]), pack_bf16(q8p[col], q8p[LD + col]));
      }
    }
  }

#pragma unroll
  for (int n = 0; n < NCOL / 8; ++n) {
    const int col = c_off + n * 8 + 2 * t;
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

// ---------------------------------------------------------------------------
// The FFMA bodies of K4 and K10 for f32 compute (no TF32, which keeps about
// three decimal digits where JAX's f32 path and the plain versions keep f32),
// at head size (HS) 128 or 256. Simple and right first.
//
// Bound on the H100: operations, on the CUDA cores (67 TF/s f32). Every
// operand tile is staged as f32 in shared memory, rows padded by one word so
// that the threads of a warp reading one column of several rows hit distinct
// banks. A block has 128 threads, thread (r, c) = (tid / 8, tid % 8): 8
// threads share a row, and a thread owns the row's columns c + 8 j, so the
// row reductions are shuffles among 8 lanes. Everything is f32, as the plain
// versions in f32 round nowhere.
//  - simt_fwd: a block per (16 query rows, head, batch); key tiles of 32.
//  - simt_dq: a block per (16 query rows, head, batch); key tiles of 32,
//    dQ += dS K_j in registers.
//  - simt_dkv: a block per (16 keys, head, batch); query tiles of 32 at or
//    below the diagonal, dV += P^T dO_i and dK += dS^T Q_i in registers.

constexpr int SIMT_THREADS = 128, SIMT_BR = 16, SIMT_BC = 32;

template <int HS>
__host__ __device__ constexpr int simt_ld() { return HS + 1; }

// rows [r0, r0 + n) of a (T, HS) tensor into dst (n rows of ld), zeros past T
template <int HS>
__device__ __forceinline__ void simt_stage(float* dst, const float* src, int r0, int n, int T, int tid) {
  for (int e = tid; e < n * HS; e += SIMT_THREADS) {
    const int r = e / HS, d = e % HS;
    dst[r * simt_ld<HS>() + d] = r0 + r < T ? src[(size_t)(r0 + r) * HS + d] : 0.f;
  }
}

// the sum over 8 adjacent lanes (one row's threads)
__device__ __forceinline__ float row8_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}
__device__ __forceinline__ float row8_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}

template <int HS>
__global__ void __launch_bounds__(SIMT_THREADS)
simt_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                float* __restrict__ o, float* __restrict__ lse, int H, int T, float scale) {
  constexpr int LD = simt_ld<HS>(), NJ = HS / 8;
  extern __shared__ float sm[];
  float* Qs = sm;                     // [BR][LD]
  float* Ks = Qs + SIMT_BR * LD;      // [BC][LD]
  float* Vs = Ks + SIMT_BC * LD;      // [BC][LD]
  float* Ps = Vs + SIMT_BC * LD;      // [BR][BC]
  const int tid = threadIdx.x, r = tid / 8, c = tid % 8;
  const int q0 = blockIdx.x * SIMT_BR, h = blockIdx.y, b = blockIdx.z;
  const size_t base = ((size_t)b * H + h) * (size_t)T * HS;
  const int row = q0 + r;
  simt_stage<HS>(Qs, q + base, q0, SIMT_BR, T, tid);
  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;
  float m = LLT_NEG_INF, l = 0.f;
  const int kend = min(T, q0 + SIMT_BR);  // keys past the block's last row are masked for all
  for (int k0 = 0; k0 < kend; k0 += SIMT_BC) {
    __syncthreads();  // the previous tile's products are done
    simt_stage<HS>(Ks, k + base, k0, SIMT_BC, T, tid);
    simt_stage<HS>(Vs, v + base, k0, SIMT_BC, T, tid);
    __syncthreads();
    float s[SIMT_BC / 8];
    float mt = LLT_NEG_INF;
#pragma unroll
    for (int j = 0; j < SIMT_BC / 8; ++j) {
      const int key = k0 + c + 8 * j;
      const float* qr = Qs + r * LD;
      const float* kr = Ks + (c + 8 * j) * LD;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HS; ++d) dot += qr[d] * kr[d];
      s[j] = (key < T && key <= row) ? dot * scale : LLT_NEG_INF;
      mt = fmaxf(mt, s[j]);
    }
    mt = row8_max(mt);
    const float mn = fmaxf(m, mt), alpha = __expf(m - mn);
    m = mn;
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < SIMT_BC / 8; ++j) {
      const float p = __expf(s[j] - mn);
      ls += p;
      Ps[r * SIMT_BC + c + 8 * j] = p;
    }
    l = l * alpha + row8_sum(ls);
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j] *= alpha;
    __syncthreads();  // Ps is visible to the row's threads
#pragma unroll 4
    for (int kk = 0; kk < SIMT_BC; ++kk) {
      const float p = Ps[r * SIMT_BC + kk];
      const float* vr = Vs + kk * LD + c;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[j] += p * vr[8 * j];
    }
  }
  if (row >= T) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int j = 0; j < NJ; ++j) o[base + (size_t)row * HS + c + 8 * j] = acc[j] * inv;
  if (c == 0) lse[((size_t)b * H + h) * (size_t)T + row] = m + logf(fmaxf(l, 1e-30f));
}

// D = rowsum(dO * O) in f32, one warp per row; T_ bf16 (the tensor-core
// kernels past head size 128) or f32
template <typename T_, int HS>
__global__ void simt_dot_kernel(const T_* __restrict__ o, const T_* __restrict__ dout, float* __restrict__ dd,
                                int rows) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < HS / 32; ++i) {
    const size_t off = (size_t)row * HS + lane + 32 * i;
    s += to_f32(o[off]) * to_f32(dout[off]);
  }
  s = warp_sum(s);
  if (lane == 0) dd[row] = s;
}

template <int HS>
__global__ void __launch_bounds__(SIMT_THREADS)
simt_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
               const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dd,
               float* __restrict__ dq, int H, int T, float scale) {
  constexpr int LD = simt_ld<HS>(), NJ = HS / 8;
  extern __shared__ float sm[];
  float* Qs = sm;                     // [BR][LD]
  float* Ds = Qs + SIMT_BR * LD;      // dO [BR][LD]
  float* Ks = Ds + SIMT_BR * LD;      // [BC][LD]
  float* Vs = Ks + SIMT_BC * LD;      // [BC][LD]
  float* Ss = Vs + SIMT_BC * LD;      // dS [BR][BC]
  const int tid = threadIdx.x, r = tid / 8, c = tid % 8;
  const int q0 = blockIdx.x * SIMT_BR, h = blockIdx.y, b = blockIdx.z;
  const size_t base = ((size_t)b * H + h) * (size_t)T * HS, lbase = ((size_t)b * H + h) * (size_t)T;
  const int row = q0 + r;
  simt_stage<HS>(Qs, q + base, q0, SIMT_BR, T, tid);
  simt_stage<HS>(Ds, dout + base, q0, SIMT_BR, T, tid);
  const float lr = row < T ? lse[lbase + row] : 0.f, dr = row < T ? dd[lbase + row] : 0.f;
  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;
  const int kend = min(T, q0 + SIMT_BR);
  for (int k0 = 0; k0 < kend; k0 += SIMT_BC) {
    __syncthreads();
    simt_stage<HS>(Ks, k + base, k0, SIMT_BC, T, tid);
    simt_stage<HS>(Vs, v + base, k0, SIMT_BC, T, tid);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < SIMT_BC / 8; ++j) {
      const int key = k0 + c + 8 * j;
      const float* qr = Qs + r * LD;
      const float* dr_ = Ds + r * LD;
      const float* kr = Ks + (c + 8 * j) * LD;
      const float* vr = Vs + (c + 8 * j) * LD;
      float sdot = 0.f, pdot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HS; ++d) {
        sdot += qr[d] * kr[d];
        pdot += dr_[d] * vr[d];
      }
      const float p = (row < T && key < T && key <= row) ? __expf(sdot * scale - lr) : 0.f;
      Ss[r * SIMT_BC + c + 8 * j] = p * (pdot - dr);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < SIMT_BC; ++kk) {
      const float ds = Ss[r * SIMT_BC + kk];
      const float* kr = Ks + kk * LD + c;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[j] += ds * kr[8 * j];
    }
  }
  if (row >= T) return;
#pragma unroll
  for (int j = 0; j < NJ; ++j) dq[base + (size_t)row * HS + c + 8 * j] = acc[j] * scale;
}

template <int HS>
__global__ void __launch_bounds__(SIMT_THREADS)
simt_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dd,
                float* __restrict__ dk, float* __restrict__ dv, int H, int T, float scale) {
  constexpr int LD = simt_ld<HS>(), NJ = HS / 8;
  extern __shared__ float sm[];
  float* Ks = sm;                     // [BR][LD]: the block's 16 keys
  float* Vs = Ks + SIMT_BR * LD;      // [BR][LD]
  float* Qs = Vs + SIMT_BR * LD;      // [BC][LD]: a tile of 32 queries
  float* Ds = Qs + SIMT_BC * LD;      // dO [BC][LD]
  float* Ps = Ds + SIMT_BC * LD;      // P^T [BR][BC]
  float* Ss = Ps + SIMT_BR * SIMT_BC; // dS^T [BR][BC]
  float* Ls = Ss + SIMT_BR * SIMT_BC; // lse [BC]
  float* DDs = Ls + SIMT_BC;          // D [BC]
  const int tid = threadIdx.x, r = tid / 8, c = tid % 8;
  const int k0 = blockIdx.x * SIMT_BR, h = blockIdx.y, b = blockIdx.z;
  const size_t base = ((size_t)b * H + h) * (size_t)T * HS, lbase = ((size_t)b * H + h) * (size_t)T;
  const int key = k0 + r;
  simt_stage<HS>(Ks, k + base, k0, SIMT_BR, T, tid);
  simt_stage<HS>(Vs, v + base, k0, SIMT_BR, T, tid);
  float dka[NJ], dva[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) dka[j] = dva[j] = 0.f;
  for (int qs0 = k0 / SIMT_BC * SIMT_BC; qs0 < T; qs0 += SIMT_BC) {  // query tiles reaching the diagonal
    __syncthreads();
    simt_stage<HS>(Qs, q + base, qs0, SIMT_BC, T, tid);
    simt_stage<HS>(Ds, dout + base, qs0, SIMT_BC, T, tid);
    if (tid < SIMT_BC) {
      const bool in = qs0 + tid < T;
      Ls[tid] = in ? lse[lbase + qs0 + tid] : 0.f;
      DDs[tid] = in ? dd[lbase + qs0 + tid] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < SIMT_BC / 8; ++j) {
      const int cq = c + 8 * j, qi = qs0 + cq;
      const float* kr = Ks + r * LD;
      const float* vr = Vs + r * LD;
      const float* qr = Qs + cq * LD;
      const float* dr_ = Ds + cq * LD;
      float sdot = 0.f, pdot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HS; ++d) {
        sdot += kr[d] * qr[d];
        pdot += vr[d] * dr_[d];
      }
      const float p = (qi < T && key < T && qi >= key) ? __expf(sdot * scale - Ls[cq]) : 0.f;
      Ps[r * SIMT_BC + cq] = p;
      Ss[r * SIMT_BC + cq] = p * (pdot - DDs[cq]);
    }
    __syncthreads();
#pragma unroll 4
    for (int qq = 0; qq < SIMT_BC; ++qq) {
      const float p = Ps[r * SIMT_BC + qq], ds = Ss[r * SIMT_BC + qq];
      const float* dr_ = Ds + qq * LD + c;
      const float* qr = Qs + qq * LD + c;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        dva[j] += p * dr_[8 * j];
        dka[j] += ds * qr[8 * j];
      }
    }
  }
  if (key >= T) return;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const size_t off = base + (size_t)key * HS + c + 8 * j;
    dk[off] = dka[j] * scale;
    dv[off] = dva[j];
  }
}

template <int HS>
constexpr int simt_fwd_smem() { return (SIMT_BR * simt_ld<HS>() + 2 * SIMT_BC * simt_ld<HS>() + SIMT_BR * SIMT_BC) * 4; }
template <int HS>
constexpr int simt_dq_smem() { return (2 * SIMT_BR * simt_ld<HS>() + 2 * SIMT_BC * simt_ld<HS>() + SIMT_BR * SIMT_BC) * 4; }
template <int HS>
constexpr int simt_dkv_smem() {
  return (2 * SIMT_BR * simt_ld<HS>() + 2 * SIMT_BC * simt_ld<HS>() + 2 * SIMT_BR * SIMT_BC + 2 * SIMT_BC) * 4;
}

template <typename K>
int set_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int HS>
int simt_forward(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int T,
                 float scale, cudaStream_t st) {
  constexpr int smem = simt_fwd_smem<HS>();
  int err = set_smem(simt_fwd_kernel<HS>, smem);
  if (err) return err;
  simt_fwd_kernel<HS><<<dim3((T + SIMT_BR - 1) / SIMT_BR, H, B), SIMT_THREADS, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, (float*)lse, H, T, scale);
  return (int)cudaGetLastError();
}

template <int HS>
int simt_backward_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                     const void* lse, void* dd, void* dq, int B, int H, int T, float scale, cudaStream_t st) {
  const int rows = B * H * T;
  simt_dot_kernel<float, HS><<<(rows + 7) / 8, 256, 0, st>>>((const float*)o, (const float*)dout, (float*)dd, rows);
  constexpr int smem = simt_dq_smem<HS>();
  int err = set_smem(simt_dq_kernel<HS>, smem);
  if (err) return err;
  simt_dq_kernel<HS><<<dim3((T + SIMT_BR - 1) / SIMT_BR, H, B), SIMT_THREADS, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse, (const float*)dd, (float*)dq, H,
      T, scale);
  return (int)cudaGetLastError();
}

template <int HS>
int simt_backward_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                      const void* dd, void* dk, void* dv, int B, int H, int T, float scale, cudaStream_t st) {
  constexpr int smem = simt_dkv_smem<HS>();
  int err = set_smem(simt_dkv_kernel<HS>, smem);
  if (err) return err;
  simt_dkv_kernel<HS><<<dim3((T + SIMT_BR - 1) / SIMT_BR, H, B), SIMT_THREADS, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse, (const float*)dd, (float*)dk,
      (float*)dv, H, T, scale);
  return (int)cudaGetLastError();
}

template <int HS>
int mma_forward(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int T,
                float scale, cudaStream_t st) {
  constexpr int smem = fwd_smem<HS>();
  int err = set_smem(flash_fwd_kernel<HS>, smem);
  if (err) return err;
  flash_fwd_kernel<HS><<<dim3((T + BQ - 1) / BQ, H, B), THREADS, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (__nv_bfloat16*)o, (float*)lse,
      H, T, scale);
  return (int)cudaGetLastError();
}

template <int HS>
int mma_backward_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                    const void* lse, void* dd, void* dq, int B, int H, int T, float scale, cudaStream_t st) {
  const int rows = B * H * T;
  if constexpr (HS == 128)
    flash_bwd_dot_kernel<<<(rows + 7) / 8, 256, 0, st>>>((const __nv_bfloat16*)o, (const __nv_bfloat16*)dout,
                                                         (float*)dd, rows);
  else
    simt_dot_kernel<__nv_bfloat16, HS><<<(rows + 7) / 8, 256, 0, st>>>((const __nv_bfloat16*)o,
                                                                       (const __nv_bfloat16*)dout, (float*)dd, rows);
  constexpr int smem = dq_smem<HS>();
  int err = set_smem(flash_bwd_dq_kernel<HS>, smem);
  if (err) return err;
  flash_bwd_dq_kernel<HS><<<dim3((T + BQ - 1) / BQ * (HS / NCOL), H, B), THREADS, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout,
      (const float*)lse, (const float*)dd, (__nv_bfloat16*)dq, H, T, scale);
  return (int)cudaGetLastError();
}

template <int HS>
int mma_backward_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                     const void* dd, void* dk, void* dv, int B, int H, int T, float scale, cudaStream_t st) {
  constexpr int smem = dkv_smem<HS>();
  int err = set_smem(flash_bwd_dkv_kernel<HS>, smem);
  if (err) return err;
  flash_bwd_dkv_kernel<HS><<<dim3((T + BKV - 1) / BKV * (HS / NCOL), H, B), THREADS, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout,
      (const float*)lse, (const float*)dd, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, H, T, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Head sizes past 256 (any multiple of 128 that JAX's gate sends), K4 and
// K10 in bf16 and f32. The output's head columns are split over the grid in
// chunks of 128 (WIDE = 128), as the backward kernels split theirs above; the
// inputs pass through shared memory in chunks of 128 columns while the f32
// score tile (and dP) builds up, so shared memory and registers do not grow
// with hs. Each output chunk recomputes the scores over the full head: the
// score work is hs / 128 times the single-pass kernels', acceptable while no
// model the repo supports has such a head. The arithmetic, the rounding and
// the masks are those of the kernels above.

constexpr int WIDE = 128, WLD = WIDE + 8;  // columns a chunk; bf16 elements a shared chunk row

// rows r0.. (64, zeros past T) x columns c0..c0 + 127 of a (T, hs) bf16
// tensor into dst [64][WLD]
__device__ __forceinline__ void stage_chunk(__nv_bfloat16* dst, const __nv_bfloat16* src, int r0, int T, int hs,
                                            int c0, int tid) {
#pragma unroll
  for (int i = 0; i < 64 * (WIDE / 8) / THREADS; ++i) {
    const int vec = tid + THREADS * i;
    const int r = vec / (WIDE / 8), c = (vec % (WIDE / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < T) val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * hs + c0 + c);
    *reinterpret_cast<uint4*>(dst + r * WLD + c) = val;
  }
}

// acc[j] (16 rows of the warp x 8 n-tiles of 8 rows of B) += A (16 rows from
// a_row0 of As) B^T (64 rows of Bs), over one chunk of 128 columns
__device__ __forceinline__ void chunk_nt(float (*acc)[4], const __nv_bfloat16* As, int a_row0,
                                        const __nv_bfloat16* Bs, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < WIDE / 16; ++kk) {
    uint32_t a[4];
    frag_a_smem(a, As, WLD, a_row0, kk, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t* brow = reinterpret_cast<const uint32_t*>(Bs + (j * 8 + g) * WLD);
      mma_bf16(acc[j], a, brow[(kk * 16 + 2 * t) / 2], brow[(kk * 16 + 8 + 2 * t) / 2]);
    }
  }
}

// acc (16 x 128) += P (16 x 64, the C layout of p) V (64 x 128 of Vs)
__device__ __forceinline__ void chunk_pv(float (*acc)[4], const float (*p)[4], const __nv_bfloat16* Vs, int g,
                                        int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    pa[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    pa[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pa[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    const __nv_bfloat16* v0 = Vs + (kk * 16 + 2 * t) * WLD;
    const __nv_bfloat16* v8 = Vs + (kk * 16 + 8 + 2 * t) * WLD;
#pragma unroll
    for (int n = 0; n < WIDE / 8; ++n) {
      const int col = n * 8 + g;
      mma_bf16(acc[n], pa, pack_bf16(v0[col], v0[WLD + col]), pack_bf16(v8[col], v8[WLD + col]));
    }
  }
}

constexpr int WIDE_FWD_SMEM = 3 * 64 * WLD * 2, WIDE_DQ_SMEM = 4 * 64 * WLD * 2,
              WIDE_DKV_SMEM = 4 * 64 * WLD * 2 + 2 * 64 * 4;

// K4 past head size 256: a block per (64-row q tile x 128-column chunk, head, batch)
__global__ void __launch_bounds__(THREADS)
flash_fwd_wide_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int H, int T, int hs, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + 64 * WLD;
  __nv_bfloat16* Vs = Ks + 64 * WLD;
  const int nspl = hs / WIDE;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int qt = blockIdx.x / nspl, c_off = (blockIdx.x % nspl) * WIDE, h = blockIdx.y, b = blockIdx.z;
  const size_t base = ((size_t)b * H + h) * (size_t)T * hs;
  const int row0 = qt * BQ + warp * 16 + g, row1 = row0 + 8;

  float oacc[WIDE / 8][4];
#pragma unroll
  for (int n = 0; n < WIDE / 8; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m0 = LLT_NEG_INF, m1 = LLT_NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * BKV;
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    for (int d0 = 0; d0 < hs; d0 += WIDE) {  // S = Q K^T over the head, a chunk at a time
      __syncthreads();
      stage_chunk(Qs, q + base, qt * BQ, T, hs, d0, tid);
      stage_chunk(Ks, k + base, k0, T, hs, d0, tid);
      __syncthreads();
      chunk_nt(s, Qs, warp * 16, Ks, g, t);
    }
    stage_chunk(Vs, v + base, k0, T, hs, c_off, tid);  // Vs is not read before the sync below
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
    l0 = l0 * a0 + ls0;
    l1 = l1 * a1 + ls1;
#pragma unroll
    for (int n = 0; n < WIDE / 8; ++n) {
      oacc[n][0] *= a0;
      oacc[n][1] *= a0;
      oacc[n][2] *= a1;
      oacc[n][3] *= a1;
    }
    __syncthreads();  // Vs is staged
    chunk_pv(oacc, s, Vs, g, t);
  }

#pragma unroll
  for (int o2 = 1; o2 < 4; o2 <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o2);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < WIDE / 8; ++n) {
    const int col = c_off + n * 8 + 2 * t;
    if (row0 < T)
      *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)row0 * hs + col) =
          __floats2bfloat162_rn(oacc[n][0] * inv0, oacc[n][1] * inv0);
    if (row1 < T)
      *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)row1 * hs + col) =
          __floats2bfloat162_rn(oacc[n][2] * inv1, oacc[n][3] * inv1);
  }
  if (t == 0 && c_off == 0) {  // every chunk computes the same lse; the first writes it
    const size_t lbase = ((size_t)b * H + h) * (size_t)T;
    if (row0 < T) lse[lbase + row0] = m0 + logf(fmaxf(l0, 1e-30f));
    if (row1 < T) lse[lbase + row1] = m1 + logf(fmaxf(l1, 1e-30f));
  }
}

// D = rowsum(dO * O) in f32 at any head size, one warp per row
template <typename T_>
__global__ void wide_dot_kernel(const T_* __restrict__ o, const T_* __restrict__ dout, float* __restrict__ dd,
                                int rows, int hs) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  float s = 0.f;
  for (int d = lane; d < hs; d += 32) s += to_f32(o[(size_t)row * hs + d]) * to_f32(dout[(size_t)row * hs + d]);
  s = warp_sum(s);
  if (lane == 0) dd[row] = s;
}

// K10 dQ past head size 256: a block per (64-row q tile x 128-column chunk, head, batch)
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_wide_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ dd,
                         __nv_bfloat16* __restrict__ dq, int H, int T, int hs, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ds = Qs + 64 * WLD;
  __nv_bfloat16* Ks = Ds + 64 * WLD;
  __nv_bfloat16* Vs = Ks + 64 * WLD;
  const int nspl = hs / WIDE;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int qt = blockIdx.x / nspl, c_off = (blockIdx.x % nspl) * WIDE, h = blockIdx.y, b = blockIdx.z;
  const size_t base = ((size_t)b * H + h) * (size_t)T * hs, lbase = ((size_t)b * H + h) * (size_t)T;
  const int row0 = qt * BQ + warp * 16 + g, row1 = row0 + 8;
  const float lse0 = row0 < T ? lse[lbase + row0] : 0.f, lse1 = row1 < T ? lse[lbase + row1] : 0.f;
  const float dd0 = row0 < T ? dd[lbase + row0] : 0.f, dd1 = row1 < T ? dd[lbase + row1] : 0.f;

  float acc[WIDE / 8][4];
#pragma unroll
  for (int n = 0; n < WIDE / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * BKV;
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    for (int d0 = 0; d0 < hs; d0 += WIDE) {  // S = Q K^T and dP = dO V^T, a chunk at a time
      __syncthreads();
      stage_chunk(Qs, q + base, qt * BQ, T, hs, d0, tid);
      stage_chunk(Ds, dout + base, qt * BQ, T, hs, d0, tid);
      stage_chunk(Ks, k + base, k0, T, hs, d0, tid);
      stage_chunk(Vs, v + base, k0, T, hs, d0, tid);
      __syncthreads();
      chunk_nt(s, Qs, warp * 16, Ks, g, t);
      chunk_nt(dp, Ds, warp * 16, Vs, g, t);
    }
    __syncthreads();  // every warp is done with Ks
    stage_chunk(Ks, k + base, k0, T, hs, c_off, tid);
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
    __syncthreads();  // the K chunk at c_off is staged
    chunk_pv(acc, s, Ks, g, t);  // dQ[:, c_off ..] += bf16(dS) K
  }
#pragma unroll
  for (int n = 0; n < WIDE / 8; ++n) {
    const int col = c_off + n * 8 + 2 * t;
    if (row0 < T)
      *reinterpret_cast<__nv_bfloat162*>(dq + base + (size_t)row0 * hs + col) =
          __floats2bfloat162_rn(acc[n][0] * scale, acc[n][1] * scale);
    if (row1 < T)
      *reinterpret_cast<__nv_bfloat162*>(dq + base + (size_t)row1 * hs + col) =
          __floats2bfloat162_rn(acc[n][2] * scale, acc[n][3] * scale);
  }
}

// K10 dK/dV past head size 256: a block per (64-key tile x 128-column chunk,
// head, batch), the transposed tiles S^T = K Q^T and dP^T = V dO^T as above
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_wide_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ dd,
                          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H, int T, int hs,
                          float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + 64 * WLD;
  __nv_bfloat16* Qs = Vs + 64 * WLD;
  __nv_bfloat16* Ds = Qs + 64 * WLD;  // dO chunk
  float* Ls = reinterpret_cast<float*>(Ds + 64 * WLD);
  float* DDs = Ls + 64;
  const int nspl = hs / WIDE;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int kt = blockIdx.x / nspl, c_off = (blockIdx.x % nspl) * WIDE, h = blockIdx.y, b = blockIdx.z;
  const size_t base = ((size_t)b * H + h) * (size_t)T * hs, lbase = ((size_t)b * H + h) * (size_t)T;
  const int kw = warp * 16, key0 = kt * BKV + kw + g, key1 = key0 + 8;

  float dka[WIDE / 8][4], dva[WIDE / 8][4];
#pragma unroll
  for (int n = 0; n < WIDE / 8; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }
  const int n_qt = (T + BQ - 1) / BQ;
  for (int qt = kt; qt < n_qt; ++qt) {
    const int qs0 = qt * BQ;
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    for (int d0 = 0; d0 < hs; d0 += WIDE) {
      __syncthreads();
      stage_chunk(Ks, k + base, kt * BKV, T, hs, d0, tid);
      stage_chunk(Vs, v + base, kt * BKV, T, hs, d0, tid);
      stage_chunk(Qs, q + base, qs0, T, hs, d0, tid);
      stage_chunk(Ds, dout + base, qs0, T, hs, d0, tid);
      if (d0 == 0 && tid < BQ) {
        const bool in = qs0 + tid < T;
        Ls[tid] = in ? lse[lbase + qs0 + tid] : 0.f;
        DDs[tid] = in ? dd[lbase + qs0 + tid] : 0.f;
      }
      __syncthreads();
      chunk_nt(s, Ks, kw, Qs, g, t);
      chunk_nt(dp, Vs, kw, Ds, g, t);
    }
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
    __syncthreads();  // every warp is done with Qs, Ds and Ls
    stage_chunk(Qs, q + base, qs0, T, hs, c_off, tid);
    stage_chunk(Ds, dout + base, qs0, T, hs, c_off, tid);
    __syncthreads();
    chunk_pv(dva, s, Ds, g, t);   // dV[:, c_off ..] += bf16(P^T) dO_i
    chunk_pv(dka, dp, Qs, g, t);  // dK[:, c_off ..] += bf16(dS^T) Q_i
  }
#pragma unroll
  for (int n = 0; n < WIDE / 8; ++n) {
    const int col = c_off + n * 8 + 2 * t;
    if (key0 < T) {
      const size_t off = base + (size_t)key0 * hs + col;
      *reinterpret_cast<__nv_bfloat162*>(dk + off) = __floats2bfloat162_rn(dka[n][0] * scale, dka[n][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off) = __floats2bfloat162_rn(dva[n][0], dva[n][1]);
    }
    if (key1 < T) {
      const size_t off = base + (size_t)key1 * hs + col;
      *reinterpret_cast<__nv_bfloat162*>(dk + off) = __floats2bfloat162_rn(dka[n][2] * scale, dka[n][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off) = __floats2bfloat162_rn(dva[n][2], dva[n][3]);
    }
  }
}

// The FFMA bodies past head size 256 (f32 compute): the blocks of simt_fwd,
// simt_dq and simt_dkv above, each also over one 128-column output chunk,
// the dot products summed over the head a staged chunk at a time.
constexpr int SW_LD = WIDE + 1;  // f32 elements a shared chunk row

// rows [r0, r0 + n) x columns c0..c0 + 127 of a (T, hs) f32 tensor into dst
// [n][SW_LD], zeros past T
__device__ __forceinline__ void simt_chunk(float* dst, const float* src, int r0, int n, int T, int hs, int c0,
                                           int tid) {
  for (int e = tid; e < n * WIDE; e += SIMT_THREADS) {
    const int r = e / WIDE, d = e % WIDE;
    dst[r * SW_LD + d] = r0 + r < T ? src[(size_t)(r0 + r) * hs + c0 + d] : 0.f;
  }
}

constexpr int SW_FWD_SMEM = ((SIMT_BR + 2 * SIMT_BC) * SW_LD + SIMT_BR * SIMT_BC) * 4;
constexpr int SW_DQ_SMEM = ((2 * SIMT_BR + 2 * SIMT_BC) * SW_LD + SIMT_BR * SIMT_BC) * 4;
constexpr int SW_DKV_SMEM = ((2 * SIMT_BR + 2 * SIMT_BC) * SW_LD + 2 * SIMT_BR * SIMT_BC + 2 * SIMT_BC) * 4;

__global__ void __launch_bounds__(SIMT_THREADS)
simt_fwd_wide_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     float* __restrict__ o, float* __restrict__ lse, int H, int T, int hs, float scale) {
  constexpr int NJ = WIDE / 8;
  extern __shared__ float sm[];
  float* Qs = sm;                    // [BR][SW_LD]
  float* Ks = Qs + SIMT_BR * SW_LD;  // [BC][SW_LD]
  float* Vs = Ks + SIMT_BC * SW_LD;  // [BC][SW_LD]
  float* Ps = Vs + SIMT_BC * SW_LD;  // [BR][BC]
  const int nspl = hs / WIDE;
  const int tid = threadIdx.x, r = tid / 8, c = tid % 8;
  const int q0 = (blockIdx.x / nspl) * SIMT_BR, c_off = (blockIdx.x % nspl) * WIDE, h = blockIdx.y, b = blockIdx.z;
  const size_t base = ((size_t)b * H + h) * (size_t)T * hs;
  const int row = q0 + r;
  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;
  float m = LLT_NEG_INF, l = 0.f;
  const int kend = min(T, q0 + SIMT_BR);
  for (int k0 = 0; k0 < kend; k0 += SIMT_BC) {
    float s[SIMT_BC / 8];
#pragma unroll
    for (int j = 0; j < SIMT_BC / 8; ++j) s[j] = 0.f;
    for (int d0 = 0; d0 < hs; d0 += WIDE) {
      __syncthreads();
      simt_chunk(Qs, q + base, q0, SIMT_BR, T, hs, d0, tid);
      simt_chunk(Ks, k + base, k0, SIMT_BC, T, hs, d0, tid);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < SIMT_BC / 8; ++j) {
        const float* qr = Qs + r * SW_LD;
        const float* kr = Ks + (c + 8 * j) * SW_LD;
#pragma unroll 8
        for (int d = 0; d < WIDE; ++d) s[j] += qr[d] * kr[d];
      }
    }
    float mt = LLT_NEG_INF;
#pragma unroll
    for (int j = 0; j < SIMT_BC / 8; ++j) {
      const int key = k0 + c + 8 * j;
      s[j] = (key < T && key <= row) ? s[j] * scale : LLT_NEG_INF;
      mt = fmaxf(mt, s[j]);
    }
    mt = row8_max(mt);
    const float mn = fmaxf(m, mt), alpha = __expf(m - mn);
    m = mn;
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < SIMT_BC / 8; ++j) {
      const float p = __expf(s[j] - mn);
      ls += p;
      Ps[r * SIMT_BC + c + 8 * j] = p;
    }
    l = l * alpha + row8_sum(ls);
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j] *= alpha;
    __syncthreads();  // every thread is done with Ks
    simt_chunk(Vs, v + base, k0, SIMT_BC, T, hs, c_off, tid);
    __syncthreads();  // Vs and Ps are visible
#pragma unroll 4
    for (int kk = 0; kk < SIMT_BC; ++kk) {
      const float p = Ps[r * SIMT_BC + kk];
      const float* vr = Vs + kk * SW_LD + c;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[j] += p * vr[8 * j];
    }
  }
  if (row >= T) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int j = 0; j < NJ; ++j) o[base + (size_t)row * hs + c_off + c + 8 * j] = acc[j] * inv;
  if (c == 0 && c_off == 0) lse[((size_t)b * H + h) * (size_t)T + row] = m + logf(fmaxf(l, 1e-30f));
}

__global__ void __launch_bounds__(SIMT_THREADS)
simt_dq_wide_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dd,
                    float* __restrict__ dq, int H, int T, int hs, float scale) {
  constexpr int NJ = WIDE / 8;
  extern __shared__ float sm[];
  float* Qs = sm;                    // [BR][SW_LD]
  float* Ds = Qs + SIMT_BR * SW_LD;  // dO [BR][SW_LD]
  float* Ks = Ds + SIMT_BR * SW_LD;  // [BC][SW_LD]
  float* Vs = Ks + SIMT_BC * SW_LD;  // [BC][SW_LD]
  float* Ss = Vs + SIMT_BC * SW_LD;  // dS [BR][BC]
  const int nspl = hs / WIDE;
  const int tid = threadIdx.x, r = tid / 8, c = tid % 8;
  const int q0 = (blockIdx.x / nspl) * SIMT_BR, c_off = (blockIdx.x % nspl) * WIDE, h = blockIdx.y, b = blockIdx.z;
  const size_t base = ((size_t)b * H + h) * (size_t)T * hs, lbase = ((size_t)b * H + h) * (size_t)T;
  const int row = q0 + r;
  const float lr = row < T ? lse[lbase + row] : 0.f, dr = row < T ? dd[lbase + row] : 0.f;
  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;
  const int kend = min(T, q0 + SIMT_BR);
  for (int k0 = 0; k0 < kend; k0 += SIMT_BC) {
    float sdot[SIMT_BC / 8], pdot[SIMT_BC / 8];
#pragma unroll
    for (int j = 0; j < SIMT_BC / 8; ++j) sdot[j] = pdot[j] = 0.f;
    for (int d0 = 0; d0 < hs; d0 += WIDE) {
      __syncthreads();
      simt_chunk(Qs, q + base, q0, SIMT_BR, T, hs, d0, tid);
      simt_chunk(Ds, dout + base, q0, SIMT_BR, T, hs, d0, tid);
      simt_chunk(Ks, k + base, k0, SIMT_BC, T, hs, d0, tid);
      simt_chunk(Vs, v + base, k0, SIMT_BC, T, hs, d0, tid);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < SIMT_BC / 8; ++j) {
        const float* qr = Qs + r * SW_LD;
        const float* dr_ = Ds + r * SW_LD;
        const float* kr = Ks + (c + 8 * j) * SW_LD;
        const float* vr = Vs + (c + 8 * j) * SW_LD;
#pragma unroll 8
        for (int d = 0; d < WIDE; ++d) {
          sdot[j] += qr[d] * kr[d];
          pdot[j] += dr_[d] * vr[d];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < SIMT_BC / 8; ++j) {
      const int key = k0 + c + 8 * j;
      const float p = (row < T && key < T && key <= row) ? __expf(sdot[j] * scale - lr) : 0.f;
      Ss[r * SIMT_BC + c + 8 * j] = p * (pdot[j] - dr);
    }
    __syncthreads();  // every thread is done with Ks
    simt_chunk(Ks, k + base, k0, SIMT_BC, T, hs, c_off, tid);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < SIMT_BC; ++kk) {
      const float ds = Ss[r * SIMT_BC + kk];
      const float* kr = Ks + kk * SW_LD + c;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[j] += ds * kr[8 * j];
    }
  }
  if (row >= T) return;
#pragma unroll
  for (int j = 0; j < NJ; ++j) dq[base + (size_t)row * hs + c_off + c + 8 * j] = acc[j] * scale;
}

__global__ void __launch_bounds__(SIMT_THREADS)
simt_dkv_wide_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dd,
                     float* __restrict__ dk, float* __restrict__ dv, int H, int T, int hs, float scale) {
  constexpr int NJ = WIDE / 8;
  extern __shared__ float sm[];
  float* Ks = sm;                       // [BR][SW_LD]: the block's 16 keys
  float* Vs = Ks + SIMT_BR * SW_LD;     // [BR][SW_LD]
  float* Qs = Vs + SIMT_BR * SW_LD;     // [BC][SW_LD]: a tile of 32 queries
  float* Ds = Qs + SIMT_BC * SW_LD;     // dO [BC][SW_LD]
  float* Ps = Ds + SIMT_BC * SW_LD;     // P^T [BR][BC]
  float* Ss = Ps + SIMT_BR * SIMT_BC;   // dS^T [BR][BC]
  float* Ls = Ss + SIMT_BR * SIMT_BC;   // lse [BC]
  float* DDs = Ls + SIMT_BC;            // D [BC]
  const int nspl = hs / WIDE;
  const int tid = threadIdx.x, r = tid / 8, c = tid % 8;
  const int k0 = (blockIdx.x / nspl) * SIMT_BR, c_off = (blockIdx.x % nspl) * WIDE, h = blockIdx.y, b = blockIdx.z;
  const size_t base = ((size_t)b * H + h) * (size_t)T * hs, lbase = ((size_t)b * H + h) * (size_t)T;
  const int key = k0 + r;
  float dka[NJ], dva[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) dka[j] = dva[j] = 0.f;
  for (int qs0 = k0 / SIMT_BC * SIMT_BC; qs0 < T; qs0 += SIMT_BC) {
    float sdot[SIMT_BC / 8], pdot[SIMT_BC / 8];
#pragma unroll
    for (int j = 0; j < SIMT_BC / 8; ++j) sdot[j] = pdot[j] = 0.f;
    for (int d0 = 0; d0 < hs; d0 += WIDE) {
      __syncthreads();
      simt_chunk(Ks, k + base, k0, SIMT_BR, T, hs, d0, tid);
      simt_chunk(Vs, v + base, k0, SIMT_BR, T, hs, d0, tid);
      simt_chunk(Qs, q + base, qs0, SIMT_BC, T, hs, d0, tid);
      simt_chunk(Ds, dout + base, qs0, SIMT_BC, T, hs, d0, tid);
      if (d0 == 0 && tid < SIMT_BC) {
        const bool in = qs0 + tid < T;
        Ls[tid] = in ? lse[lbase + qs0 + tid] : 0.f;
        DDs[tid] = in ? dd[lbase + qs0 + tid] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < SIMT_BC / 8; ++j) {
        const float* kr = Ks + r * SW_LD;
        const float* vr = Vs + r * SW_LD;
        const float* qr = Qs + (c + 8 * j) * SW_LD;
        const float* dr_ = Ds + (c + 8 * j) * SW_LD;
#pragma unroll 8
        for (int d = 0; d < WIDE; ++d) {
          sdot[j] += kr[d] * qr[d];
          pdot[j] += vr[d] * dr_[d];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < SIMT_BC / 8; ++j) {
      const int cq = c + 8 * j, qi = qs0 + cq;
      const float p = (qi < T && key < T && qi >= key) ? __expf(sdot[j] * scale - Ls[cq]) : 0.f;
      Ps[r * SIMT_BC + cq] = p;
      Ss[r * SIMT_BC + cq] = p * (pdot[j] - DDs[cq]);
    }
    __syncthreads();  // every thread is done with Qs and Ds
    simt_chunk(Qs, q + base, qs0, SIMT_BC, T, hs, c_off, tid);
    simt_chunk(Ds, dout + base, qs0, SIMT_BC, T, hs, c_off, tid);
    __syncthreads();
#pragma unroll 4
    for (int qq = 0; qq < SIMT_BC; ++qq) {
      const float p = Ps[r * SIMT_BC + qq], ds = Ss[r * SIMT_BC + qq];
      const float* dr_ = Ds + qq * SW_LD + c;
      const float* qr = Qs + qq * SW_LD + c;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        dva[j] += p * dr_[8 * j];
        dka[j] += ds * qr[8 * j];
      }
    }
  }
  if (key >= T) return;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const size_t off = base + (size_t)key * hs + c_off + c + 8 * j;
    dk[off] = dka[j] * scale;
    dv[off] = dva[j];
  }
}

// the launches past head size 256: cbf16 picks the tensor-core kernels or
// the FFMA bodies
int wide_forward(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int T, int hs,
                 float scale, bool cbf16, cudaStream_t st) {
  const int nspl = hs / WIDE;
  if (cbf16) {
    int err = set_smem(flash_fwd_wide_kernel, WIDE_FWD_SMEM);
    if (err) return err;
    flash_fwd_wide_kernel<<<dim3((T + BQ - 1) / BQ * nspl, H, B), THREADS, WIDE_FWD_SMEM, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (__nv_bfloat16*)o, (float*)lse,
        H, T, hs, scale);
  } else {
    int err = set_smem(simt_fwd_wide_kernel, SW_FWD_SMEM);
    if (err) return err;
    simt_fwd_wide_kernel<<<dim3((T + SIMT_BR - 1) / SIMT_BR * nspl, H, B), SIMT_THREADS, SW_FWD_SMEM, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, (float*)lse, H, T, hs, scale);
  }
  return (int)cudaGetLastError();
}

int wide_backward_dq(const void* q, const void* k, const void* v, const void* o, const void* dout, const void* lse,
                     void* dd, void* dq, int B, int H, int T, int hs, float scale, bool cbf16, cudaStream_t st) {
  const int rows = B * H * T, nspl = hs / WIDE;
  if (cbf16) {
    wide_dot_kernel<__nv_bfloat16><<<(rows + 7) / 8, 256, 0, st>>>((const __nv_bfloat16*)o,
                                                                   (const __nv_bfloat16*)dout, (float*)dd, rows, hs);
    int err = set_smem(flash_bwd_dq_wide_kernel, WIDE_DQ_SMEM);
    if (err) return err;
    flash_bwd_dq_wide_kernel<<<dim3((T + BQ - 1) / BQ * nspl, H, B), THREADS, WIDE_DQ_SMEM, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout,
        (const float*)lse, (const float*)dd, (__nv_bfloat16*)dq, H, T, hs, scale);
  } else {
    wide_dot_kernel<float><<<(rows + 7) / 8, 256, 0, st>>>((const float*)o, (const float*)dout, (float*)dd, rows, hs);
    int err = set_smem(simt_dq_wide_kernel, SW_DQ_SMEM);
    if (err) return err;
    simt_dq_wide_kernel<<<dim3((T + SIMT_BR - 1) / SIMT_BR * nspl, H, B), SIMT_THREADS, SW_DQ_SMEM, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse, (const float*)dd,
        (float*)dq, H, T, hs, scale);
  }
  return (int)cudaGetLastError();
}

int wide_backward_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                      const void* dd, void* dk, void* dv, int B, int H, int T, int hs, float scale, bool cbf16,
                      cudaStream_t st) {
  const int nspl = hs / WIDE;
  if (cbf16) {
    int err = set_smem(flash_bwd_dkv_wide_kernel, WIDE_DKV_SMEM);
    if (err) return err;
    flash_bwd_dkv_wide_kernel<<<dim3((T + BKV - 1) / BKV * nspl, H, B), THREADS, WIDE_DKV_SMEM, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout,
        (const float*)lse, (const float*)dd, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, H, T, hs, scale);
  } else {
    int err = set_smem(simt_dkv_wide_kernel, SW_DKV_SMEM);
    if (err) return err;
    simt_dkv_wide_kernel<<<dim3((T + SIMT_BR - 1) / SIMT_BR * nspl, H, B), SIMT_THREADS, SW_DKV_SMEM, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse, (const float*)dd,
        (float*)dk, (float*)dv, H, T, hs, scale);
  }
  return (int)cudaGetLastError();
}

// (dtype, head size) -> the tensor-core kernels (bf16) or the FFMA bodies (f32)
#define LLT_FLASH(MMA, SIMT, WIDE_FN, ...)                                    \
  do {                                                                        \
    if (hs == 128) return cbf16 ? MMA<128>(__VA_ARGS__) : SIMT<128>(__VA_ARGS__); \
    if (hs == 256) return cbf16 ? MMA<256>(__VA_ARGS__) : SIMT<256>(__VA_ARGS__); \
    if (hs > 256 && hs % WIDE == 0) return WIDE_FN;                           \
    return (int)cudaErrorInvalidValue;                                        \
  } while (0)

}  // namespace

// q, k, v, o (B, H, T, hs) contiguous, bf16 (cbf16 = 1) or f32; hs any
// multiple of 128; lse (B, H, T) f32.
LLT_EXPORT int k4_flash_forward(const void* q, const void* k, const void* v, void* o, void* lse,
                                int B, int H, int T, float scale, int cbf16, int hs, void* stream) {
  LLT_FLASH(mma_forward, simt_forward,
            wide_forward(q, k, v, o, lse, B, H, T, hs, scale, cbf16, (cudaStream_t)stream), q, k, v, o, lse, B, H,
            T, scale, (cudaStream_t)stream);
}

// K10, first half: D = rowsum(dO * O) into dd (B, H, T) f32, then dq. q, k,
// v, o, dout, dq (B, H, T, hs) contiguous, bf16 (cbf16 = 1) or f32; hs any
// multiple of 128; lse (B, H, T) f32.
LLT_EXPORT int k10_flash_backward_dq(const void* q, const void* k, const void* v, const void* o,
                                     const void* dout, const void* lse, void* dd, void* dq, int B,
                                     int H, int T, float scale, int cbf16, int hs, void* stream) {
  LLT_FLASH(mma_backward_dq, simt_backward_dq,
            wide_backward_dq(q, k, v, o, dout, lse, dd, dq, B, H, T, hs, scale, cbf16, (cudaStream_t)stream), q, k,
            v, o, dout, lse, dd, dq, B, H, T, scale, (cudaStream_t)stream);
}

// K10, second half: dk and dv from the dd that k10_flash_backward_dq wrote.
LLT_EXPORT int k10_flash_backward_dkv(const void* q, const void* k, const void* v, const void* dout,
                                      const void* lse, const void* dd, void* dk, void* dv, int B,
                                      int H, int T, float scale, int cbf16, int hs, void* stream) {
  LLT_FLASH(mma_backward_dkv, simt_backward_dkv,
            wide_backward_dkv(q, k, v, dout, lse, dd, dk, dv, B, H, T, hs, scale, cbf16, (cudaStream_t)stream), q,
            k, v, dout, lse, dd, dk, dv, B, H, T, scale, (cudaStream_t)stream);
}
