// K4: causal flash-attention forward, O and the row log-sum-exp.
// K10: its backward, dQ and dK/dV.
//
// K4 replaces lit_llama_tpu/ops/flash_attention.py _flash_kernel (entry
// _flash_forward / flash_attention).
//
// Bound on the H100: at prefill lengths (T <= 2048) the causal score and PV
// products, 2 * 2 * T * T/2 * hs per head, outweigh the bytes (q, k, v read
// once, o written once); exp and the row bookkeeping run on the CUDA cores
// beside them.
//
// Which body runs (the entries at the end of the file): bf16 takes the Hopper
// kernels (wgmma, TMA, mbarrier rings) of flash_sm90.cuh at head size 128,
// the size of every LLaMA preset, flash_sm90_hs256.cuh at 256 and
// flash_sm90_wide.cuh past 256 (K4 and K10 each); f32 compute K4's FFMA
// bodies (below, and past 256 near the end) and K10's 3xTF32 tensor-core
// kernels of flash_tf32.cuh (the chunked FFMA kernels past 256).

#include "flash_sm90.cuh"
#include "flash_sm90_hs256.cuh"
#include "flash_sm90_wide.cuh"
#include "flash_tf32.cuh"

namespace {

// ---------------------------------------------------------------------------
// K10: causal flash-attention backward.
//
// Replaces lit_llama_tpu/ops/flash_attention.py _flash_dq_kernel and
// _flash_dkv_kernel (entry _flash_backward, under the custom_vjp of
// flash_attention).
//
// Bound on the H100: dQ runs three causal products (S = Q K^T, dP = dO V^T,
// dQ = dS K) and dK/dV four (S, dP, dV = P^T dO, dK = dS^T Q), each
// 2 * T * T/2 * hs per head; at T = 2048 they outweigh the bytes (q, k, v, o,
// dO read once, dq, dk, dv written once).
//
// The FlashAttention-2 recompute scheme in two kernels and no atomics, as the
// Pallas pair: every output element is summed by one thread in a fixed order,
// so the result repeats bit for bit from run to run. D = rowsum(dO * O) comes
// first, in f32, one warp per row (JAX computes it in XLA before its
// kernels): flash_bwd_dot at head size 128 in bf16, simt_dot at 256 or in
// f32, wide_dot past 256. The kernels themselves: flash_sm90.cuh (bf16, head
// size 128), flash_sm90_hs256.cuh (bf16, 256), flash_sm90_wide.cuh (bf16,
// past 256), flash_tf32.cuh (f32, 128 and 256), the chunked FFMA kernels
// below (f32, past 256).

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

// ---------------------------------------------------------------------------
// K4's FFMA body for f32 compute (no TF32, which keeps about three decimal
// digits where JAX's f32 path and the plain versions keep f32), at head size
// (HS) 128 or 256. Everything is f32, as the plain versions in f32 round
// nowhere. Bound on the H100: operations, on the CUDA cores (67 TF/s f32).
//
// K4's forward, ffma_fwd (replaces the Pallas _flash_kernel of
// lit_llama_tpu/ops/flash_attention.py in f32; GPTQ's calibration forwards
// run it at (4, 32, 2048, 128)). Its first body read both operands of every
// score's 128-long dot product from shared memory (two loads an FFMA, one for
// P V), so shared memory capped it near a quarter of the FFMA rate; a block
// held 16 query rows, so each head's K and V were staged T / 16 times; and
// staging was synchronous. This body:
//  - a block of 256 threads takes FF_BQ = 64 query rows against key tiles of
//    FF_BKV = 64 (the same under every shape: a row's online softmax takes
//    the same steps everywhere), visiting only the tiles at or below its
//    diagonal and masking the diagonal tile and the ragged end;
//  - blocks are issued heaviest first: blockIdx.y walks the query tiles from
//    the last, blockIdx.x the (batch, head) pairs;
//  - Q, and the K and V tiles in the order K_0, V_0, K_1, V_1, ..., come in
//    row-major by 16-byte cp.async, the tiles into a ring of ff_stages slots
//    (4 at HS 128, 2 at 256); rows padded to HS + 4 words, so four (eight)
//    consecutive rows start on distinct 16-byte bank groups;
//  - S = Q K^T as register-blocked outer products: warp w owns rows
//    16 (w / 2) .. + 15 and keys 32 (w % 2) .. + 31 of the tile; a thread
//    rows ry + 4 i and keys cx + 8 j (i, j < 4; ry = lane / 8, cx = lane %
//    8), and reads four head columns of each as one 16-byte word: 8 shared
//    loads per 64 FFMA, no bank touched twice;
//  - the online softmax: the row max and sum over a warp's 8 column lanes by
//    shuffles, over the row's two warps through shared memory; P goes
//    through shared memory (rows padded to 72 words);
//  - O += P V: a thread keeps the same rows and HS / 16 columns (4 x 8 at HS
//    128), columns cx * 4 + 32 t of its warp's half of the head, so P and V
//    come as 16-byte words too (12 loads per 128 FFMA at HS 128);
//  - outputs (o, lse) as the first body wrote them; K10's f32 kernels
//    (flash_tf32.cuh) read that lse.

// the FFMA bodies past head size 256 (below): threads a block, rows a block, keys a tile
constexpr int SIMT_THREADS = 128, SIMT_BR = 16, SIMT_BC = 32;

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

constexpr int FF_BQ = 64, FF_BKV = 64, FF_THREADS = 256;
constexpr int FF_LDP = FF_BKV + 8;  // f32 words a row of P

template <int HS>
__host__ __device__ constexpr int ff_ld() { return HS + 4; }
template <int HS>
__host__ __device__ constexpr int ff_stages() { return HS <= 128 ? 4 : 2; }
// Q, the ring, P, and each row's max and sum from both of its warps
template <int HS>
constexpr int ff_smem() { return ((1 + ff_stages<HS>()) * FF_BQ * ff_ld<HS>() + FF_BQ * FF_LDP + 4 * FF_BQ) * 4; }

template <int HS>
__global__ void __launch_bounds__(FF_THREADS, 1)
ffma_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                float* __restrict__ o, float* __restrict__ lse, int T, float scale) {
  constexpr int LD = ff_ld<HS>(), NS = ff_stages<HS>(), NC = HS / 64;  // NC 16-byte O words a row
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;                         // [BQ][LD]
  float* ring = Qs + FF_BQ * LD;          // NS slots of [BKV][LD]
  float* Ps = ring + NS * FF_BKV * LD;    // [BQ][LDP]
  float* red_max = Ps + FF_BQ * FF_LDP;   // [BQ][2]: each warp half's tile max
  float* red_sum = red_max + 2 * FF_BQ;   // [BQ][2]: each warp half's tile sum
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ry = lane / 8, cx = lane % 8, half = warp % 2;
  const int r0 = (warp / 2) * 16 + ry;  // this thread's rows: r0 + 4 i
  const int qt = gridDim.y - 1 - blockIdx.y, q0 = qt * FF_BQ;
  const size_t head = (size_t)blockIdx.x * T;
  const float *qh = q + head * HS, *kh = k + head * HS, *vh = v + head * HS;
  const int n_phase = 2 * (qt + 1);  // K_j and V_j for the key tiles j = 0..qt (FF_BKV == FF_BQ)

  auto stage = [&](float* dst, const float* src, int row0) {  // 64 rows of the head, zeros past T
#pragma unroll
    for (int e = 0; e < FF_BQ * (HS / 4) / FF_THREADS; ++e) {
      const int c = tid + e * FF_THREADS, r = c / (HS / 4), d = (c % (HS / 4)) * 4;
      const bool ok = row0 + r < T;
      cp_async16(dst + r * LD + d, ok ? src + (size_t)(row0 + r) * HS + d : src, ok ? 16 : 0);
    }
  };
  auto issue = [&](int u) { stage(ring + (u % NS) * FF_BKV * LD, (u & 1) ? vh : kh, (u / 2) * FF_BKV); };

  stage(Qs, qh, q0);  // in the first group, with K_0
#pragma unroll
  for (int u = 0; u < NS - 1; ++u) {
    if (u < n_phase) issue(u);
    cp_async_commit();
  }

  float acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  float m[4], l[4], alpha[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = LLT_NEG_INF, l[i] = 0.f, alpha[i] = 1.f;

  for (int u = 0; u < n_phase; ++u) {
    cp_async_wait<NS - 2>();  // this thread's copies of tile u have landed
    __syncthreads();          // everyone's; the phase before is done with its slot and with P
    if (u + NS - 1 < n_phase) issue(u + NS - 1);
    cp_async_commit();
    const float* tile = ring + (u % NS) * FF_BKV * LD;
    const int k0 = (u / 2) * FF_BKV;
    if (!(u & 1)) {
      // S = Q K_j^T: rows r0 + 4 i, keys 32 half + cx + 8 j, summed over the head in order
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      const float* qr = Qs + r0 * LD;
      const float* kr = tile + (32 * half + cx) * LD;
#pragma unroll 4
      for (int d = 0; d < HS; d += 4) {
        float4 a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(qr + 4 * i * LD + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(kr + 8 * j * LD + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
            s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
            s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
            s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
          }
      }
      // scale, causal and ragged masks; each row's max over this half's 32 keys
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + r0 + 4 * i;
        float mt = LLT_NEG_INF;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + 32 * half + cx + 8 * j;
          s[i][j] = (key < T && key <= row) ? s[i][j] * scale : LLT_NEG_INF;
          mt = fmaxf(mt, s[i][j]);
        }
        mt = row8_max(mt);
        if (cx == 0) red_max[(r0 + 4 * i) * 2 + half] = mt;
      }
      __syncthreads();  // both halves' maxima
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + 4 * i;
        const float mn = fmaxf(m[i], fmaxf(red_max[r * 2], red_max[r * 2 + 1]));
        alpha[i] = __expf(m[i] - mn);
        m[i] = mn;
        float ls = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = __expf(s[i][j] - mn);
          ls += p;
          Ps[r * FF_LDP + 32 * half + cx + 8 * j] = p;
        }
        ls = row8_sum(ls);
        if (cx == 0) red_sum[r * 2 + half] = ls;
#pragma unroll
        for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= alpha[i];
      }
    } else {
      // the tile's row sums from both halves (visible since the phase's barrier), then O += P V_j
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + 4 * i;
        l[i] = l[i] * alpha[i] + (red_sum[r * 2] + red_sum[r * 2 + 1]);
      }
      const float* pr = Ps + r0 * FF_LDP;
      const float* vc = tile + half * (HS / 2) + cx * 4;
#pragma unroll 2
      for (int c = 0; c < FF_BKV; c += 4) {
        float4 p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = *reinterpret_cast<const float4*>(pr + 4 * i * FF_LDP + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float4 b[NC];
#pragma unroll
          for (int t = 0; t < NC; ++t) b[t] = *reinterpret_cast<const float4*>(vc + (c + e) * LD + 32 * t);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pe = e == 0 ? p[i].x : e == 1 ? p[i].y : e == 2 ? p[i].z : p[i].w;
#pragma unroll
            for (int t = 0; t < NC; ++t) {
              acc[i][4 * t] = fmaf(pe, b[t].x, acc[i][4 * t]);
              acc[i][4 * t + 1] = fmaf(pe, b[t].y, acc[i][4 * t + 1]);
              acc[i][4 * t + 2] = fmaf(pe, b[t].z, acc[i][4 * t + 2]);
              acc[i][4 * t + 3] = fmaf(pe, b[t].w, acc[i][4 * t + 3]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r0 + 4 * i;
    if (row >= T) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* orow = o + (head + row) * HS + half * (HS / 2) + cx * 4;
#pragma unroll
    for (int t = 0; t < NC; ++t)
      *reinterpret_cast<float4*>(orow + 32 * t) =
          make_float4(acc[i][4 * t] * inv, acc[i][4 * t + 1] * inv, acc[i][4 * t + 2] * inv, acc[i][4 * t + 3] * inv);
    if (half == 0 && cx == 0) lse[head + row] = m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

// D = rowsum(dO * O) in f32, one warp per row; T_ bf16 (head size 256) or f32
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

template <typename K>
int set_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int HS>
int ffma_forward(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int T,
                 float scale, cudaStream_t st) {
  constexpr int smem = ff_smem<HS>();
  int err = set_smem(ffma_fwd_kernel<HS>, smem);
  if (err) return err;
  ffma_fwd_kernel<HS><<<dim3(B * H, (T + FF_BQ - 1) / FF_BQ), FF_THREADS, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, (float*)lse, T, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Head sizes past 256 (any multiple of 128 that JAX's gate sends) in f32:
// K4 and K10 (bf16 is flash_sm90_wide.cuh). The output's head columns are
// split over the grid in chunks of 128 (WIDE = 128); the inputs pass through
// shared memory in chunks of 128 columns while the f32 score tile (and dP)
// builds up, so shared memory and registers do not grow with hs. Each output
// chunk recomputes the scores over the full head: the score work is hs / 128
// times the single-pass kernels'. The arithmetic and the masks are those of
// the Pallas kernels.

constexpr int WIDE = 128;  // columns a chunk

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

// The FFMA bodies past head size 256 (f32 compute): a block of 128 threads
// per (16 query rows (keys for dK/dV) x 128-column output chunk, head,
// batch), thread (r, c) = (tid / 8, tid % 8): 8 threads share a row, a
// thread owns its columns c + 8 j, so the row reductions are shuffles among 8
// lanes; every operand is staged as f32 (rows padded by one word), the dot
// products summed over the head a staged chunk at a time.
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

// the launches past head size 256: K4 in f32 (bf16 K4 goes from the entry to
// flash_sm90_wide.cuh); K10's D, then flash_sm90_wide.cuh's kernels (bf16)
// or the FFMA bodies (f32)
int wide_forward(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int T, int hs,
                 float scale, cudaStream_t st) {
  const int nspl = hs / WIDE;
  int err = set_smem(simt_fwd_wide_kernel, SW_FWD_SMEM);
  if (err) return err;
  simt_fwd_wide_kernel<<<dim3((T + SIMT_BR - 1) / SIMT_BR * nspl, H, B), SIMT_THREADS, SW_FWD_SMEM, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, (float*)lse, H, T, hs, scale);
  return (int)cudaGetLastError();
}

int wide_backward_dq(const void* q, const void* k, const void* v, const void* o, const void* dout, const void* lse,
                     void* dd, void* dq, int B, int H, int T, int hs, float scale, bool cbf16, cudaStream_t st) {
  const int rows = B * H * T, nspl = hs / WIDE;
  if (cbf16) {
    wide_dot_kernel<__nv_bfloat16><<<(rows + 7) / 8, 256, 0, st>>>((const __nv_bfloat16*)o,
                                                                   (const __nv_bfloat16*)dout, (float*)dd, rows, hs);
    return fawide::backward_dq(q, k, v, dout, lse, dd, dq, B, H, T, hs, scale, st);
  }
  wide_dot_kernel<float><<<(rows + 7) / 8, 256, 0, st>>>((const float*)o, (const float*)dout, (float*)dd, rows, hs);
  int err = set_smem(simt_dq_wide_kernel, SW_DQ_SMEM);
  if (err) return err;
  simt_dq_wide_kernel<<<dim3((T + SIMT_BR - 1) / SIMT_BR * nspl, H, B), SIMT_THREADS, SW_DQ_SMEM, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse, (const float*)dd,
      (float*)dq, H, T, hs, scale);
  return (int)cudaGetLastError();
}

int wide_backward_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                      const void* dd, void* dk, void* dv, int B, int H, int T, int hs, float scale, bool cbf16,
                      cudaStream_t st) {
  if (cbf16) return fawide::backward_dkv(q, k, v, dout, lse, dd, dk, dv, B, H, T, hs, scale, st);
  const int nspl = hs / WIDE;
  int err = set_smem(simt_dkv_wide_kernel, SW_DKV_SMEM);
  if (err) return err;
  simt_dkv_wide_kernel<<<dim3((T + SIMT_BR - 1) / SIMT_BR * nspl, H, B), SIMT_THREADS, SW_DKV_SMEM, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse, (const float*)dd,
      (float*)dk, (float*)dv, H, T, hs, scale);
  return (int)cudaGetLastError();
}

// K10's first kernel: D = rowsum(dO * O), then dq, on the body of (dtype, hs)
int backward_dq(const void* q, const void* k, const void* v, const void* o, const void* dout, const void* lse,
                void* dd, void* dq, int B, int H, int T, int hs, float scale, bool cbf16, cudaStream_t st) {
  const int rows = B * H * T;
  if (hs == 128 && cbf16) {
    flash_bwd_dot_kernel<<<(rows + 7) / 8, 256, 0, st>>>((const __nv_bfloat16*)o, (const __nv_bfloat16*)dout,
                                                         (float*)dd, rows);
    return fa90::backward_dq(q, k, v, dout, lse, dd, dq, B, H, T, scale, st);
  }
  if (hs == 256 && cbf16) {
    simt_dot_kernel<__nv_bfloat16, 256><<<(rows + 7) / 8, 256, 0, st>>>((const __nv_bfloat16*)o,
                                                                        (const __nv_bfloat16*)dout, (float*)dd, rows);
    return fa256::backward_dq(q, k, v, dout, lse, dd, dq, B, H, T, scale, st);
  }
  if (hs == 128) {  // f32
    simt_dot_kernel<float, 128><<<(rows + 7) / 8, 256, 0, st>>>((const float*)o, (const float*)dout, (float*)dd, rows);
    return k10tf32::backward_dq<128>(q, k, v, dout, lse, dd, dq, B * H, T, scale, st);
  }
  if (hs == 256) {
    simt_dot_kernel<float, 256><<<(rows + 7) / 8, 256, 0, st>>>((const float*)o, (const float*)dout, (float*)dd, rows);
    return k10tf32::backward_dq<256>(q, k, v, dout, lse, dd, dq, B * H, T, scale, st);
  }
  if (hs > 256 && hs % WIDE == 0) return wide_backward_dq(q, k, v, o, dout, lse, dd, dq, B, H, T, hs, scale, cbf16, st);
  return (int)cudaErrorInvalidValue;
}

// K10's second kernel: dK and dV from the dd that backward_dq wrote
int backward_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* dd,
                 void* dk, void* dv, int B, int H, int T, int hs, float scale, bool cbf16, cudaStream_t st) {
  if (hs == 128) return cbf16 ? fa90::backward_dkv(q, k, v, dout, lse, dd, dk, dv, B, H, T, scale, st)
                              : k10tf32::backward_dkv<128>(q, k, v, dout, lse, dd, dk, dv, B * H, T, scale, st);
  if (hs == 256) return cbf16 ? fa256::backward_dkv(q, k, v, dout, lse, dd, dk, dv, B, H, T, scale, st)
                              : k10tf32::backward_dkv<256>(q, k, v, dout, lse, dd, dk, dv, B * H, T, scale, st);
  if (hs > 256 && hs % WIDE == 0) return wide_backward_dkv(q, k, v, dout, lse, dd, dk, dv, B, H, T, hs, scale, cbf16, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, o (B, H, T, hs) contiguous, bf16 (cbf16 = 1) or f32; hs any
// multiple of 128; lse (B, H, T) f32. bq: the query rows a block of the
// Hopper kernels at head size 128 and 256 (bf16), 64 or 128
// (ops/flash_attention.py flash_plan). bf16: the Hopper kernels (128:
// flash_sm90.cuh, 256: flash_sm90_hs256.cuh, past 256: flash_sm90_wide.cuh);
// f32: the FFMA bodies.
LLT_EXPORT int k4_flash_forward(const void* q, const void* k, const void* v, void* o, void* lse,
                                int B, int H, int T, float scale, int cbf16, int hs, int bq, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (hs == 128) return cbf16 ? fa90::forward(q, k, v, o, lse, B, H, T, scale, bq, st)
                              : ffma_forward<128>(q, k, v, o, lse, B, H, T, scale, st);
  if (hs == 256) return cbf16 ? fa256::forward(q, k, v, o, lse, B, H, T, scale, bq, st)
                              : ffma_forward<256>(q, k, v, o, lse, B, H, T, scale, st);
  if (hs > 256 && hs % WIDE == 0) return cbf16 ? fawide::forward(q, k, v, o, lse, B, H, T, hs, scale, st)
                                               : wide_forward(q, k, v, o, lse, B, H, T, hs, scale, st);
  return (int)cudaErrorInvalidValue;
}

// K10, first half: D = rowsum(dO * O) into dd (B, H, T) f32, then dq. q, k,
// v, o, dout, dq (B, H, T, hs) contiguous, bf16 (cbf16 = 1) or f32; hs any
// multiple of 128; lse (B, H, T) f32.
LLT_EXPORT int k10_flash_backward_dq(const void* q, const void* k, const void* v, const void* o,
                                     const void* dout, const void* lse, void* dd, void* dq, int B,
                                     int H, int T, float scale, int cbf16, int hs, void* stream) {
  return backward_dq(q, k, v, o, dout, lse, dd, dq, B, H, T, hs, scale, cbf16, (cudaStream_t)stream);
}

// K10, second half: dk and dv from the dd that k10_flash_backward_dq wrote.
LLT_EXPORT int k10_flash_backward_dkv(const void* q, const void* k, const void* v, const void* dout,
                                      const void* lse, const void* dd, void* dk, void* dv, int B,
                                      int H, int T, float scale, int cbf16, int hs, void* stream) {
  return backward_dkv(q, k, v, dout, lse, dd, dk, dv, B, H, T, hs, scale, cbf16, (cudaStream_t)stream);
}
