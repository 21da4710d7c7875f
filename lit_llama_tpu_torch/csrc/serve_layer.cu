// K7 (block head) and K9 (block tail) of the batched serving decode step:
// everything of a transformer block around the attention, for B slots.
//
// Replace lit_llama_tpu/ops/fused_layer.py _block_head_kernel (entry
// block_head_fused: rms_1, int4 QKV product, half-basis RoPE per slot) and
// _block_tail_kernel (entry block_tail_fused: x + c_proj(y), rms_2, c_fc12,
// SiLU(gate) * up, mlp c_proj + residual).
//
// Bound on the H100: bytes, if the products run on the tensor cores. K7
// streams 28.3 MB of int4 weights and f32 scale/zero planes, K9 85.5 MB, and
// each weight nibble is used 2 B times: at B = 32 that is 128 operations per
// byte, past the f32 rate of the CUDA cores (20 per byte) and well inside the
// tensor cores' (295 per byte). So the matvec of K1 widened to B rows would be
// compute-bound from about ten slots up, and the products here are
// mma.sync m16n8k16 (bf16 in, f32 accumulate).
//
// Design: one entry launches a short fixed sequence of kernels (K7 two, K9
// six), as K1 does, instead of the one program with manual DMA of the Pallas
// kernels:
//   rows_prologue: per slot row, the optional RMSNorm, the bf16-rounded input
//     and the f32 group sums of the unrounded input (the zero-point term).
//   rows_int4: out = xb @ nibbles, per group and plane scaled in f32, plus
//     the zero-point term, with an epilogue: RoPE (K7), residual (attn and
//     mlp c_proj) or SiLU(gate) * up (c_fc12).
// rows_int4 reads the column-major decode layout that K1 reads (qw_t
// (N, K/2), qscale_t/qzero_t (N, G)): a thread's 16 bytes of one column are
// 16 k-rows of the low plane and 16 of the high plane, which become mma B
// fragments in registers (byte -> bf16 by a byte permute under the exponent
// byte 0x43 and one exact subtraction), with no pass through shared memory
// and the nibbles exact, as in the Pallas matvec. The order of k inside an
// mma step is free, so it is chosen to make those 16 bytes four B fragments;
// the A fragments read the same order from the bf16 rows (L2 resident). Each
// 64-row step's products go to a fresh accumulator that is scaled by the
// group's scale for its columns in registers, since the accumulator layout
// of mma.sync is known. A block owns 32 or 64 output columns and all rows;
// its 8 warps split K (and the two halves of the rows past 32 slots) and
// reduce through shared memory, so no partial sum crosses blocks and the
// result does not depend on the schedule. The block's columns are two
// halves P apart: P = 64 pairs a RoPE column with its partner, P = I pairs
// gate column j with up column I + j, so both epilogues stay in the block.
// f32 intermediates at every B (the Pallas kernel's switch to the compute
// dtype at 48 rows is a VMEM limit). Simple first: no cp.async/TMA ring, one
// block per SM, the prologue as a kernel of its own. What holds it back is
// not the weight stream (with the weight loads taken out it is a fifth
// faster, and a cp.async ring four steps deep made it slower): 8 warps of
// ~250 registers leave two warps per scheduler, which wait on the chains of
// dependent mma and conversion instructions. The next step is a tile that
// needs fewer registers per warp (A from shared memory, warps split over N).

#include "mma.cuh"

namespace {

constexpr int THREADS = 256, WARPS = 8;
constexpr int HS = 128;   // head size (RoPE pairs d and d + 64)
constexpr int STEP = 64;  // packed rows (bytes of a column) per k-step

enum Epilogue { EPI_ROPE = 0, EPI_RESIDUAL = 1, EPI_SWIGLU = 2 };

__device__ __forceinline__ float load_in(const void* p, int in_bf16, size_t i) {
  return in_bf16 ? bf16_to_f32(reinterpret_cast<const __nv_bfloat16*>(p)[i])
                 : reinterpret_cast<const float*>(p)[i];
}

// Row blockIdx.x of x (B, K), f32 or bf16: h = [rms_norm](x); xb = bf16(h);
// gx[g] = sum of h over group g, f32.
__global__ void __launch_bounds__(THREADS)
rows_prologue_kernel(const void* __restrict__ x, int in_bf16,
                     const __nv_bfloat16* __restrict__ norm_w, float eps, int K, int gs,
                     __nv_bfloat16* __restrict__ xb, float* __restrict__ gx) {
  __shared__ float red[WARPS];
  __shared__ float rnorm;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t base = (size_t)blockIdx.x * K;
  const int G = K / gs;
  float r = 1.f;
  if (norm_w != nullptr) {
    float ss = 0.f;
    for (int k = tid; k < K; k += THREADS) {
      const float v = load_in(x, in_bf16, base + k);
      ss += v * v;
    }
    ss = warp_sum(ss);
    if (lane == 0) red[warp] = ss;
    __syncthreads();
    if (tid == 0) {
      float t = 0.f;
      for (int w = 0; w < WARPS; ++w) t += red[w];
      rnorm = rsqrtf(t / (float)K + eps);
    }
    __syncthreads();
    r = rnorm;
  }
  for (int g = warp; g < G; g += WARPS) {
    float s = 0.f;
    for (int i = lane; i < gs; i += 32) {
      const int k = g * gs + i;
      float h = load_in(x, in_bf16, base + k);
      if (norm_w != nullptr) h = h * r * bf16_to_f32(norm_w[k]);
      xb[base + k] = __float2bfloat16_rn(h);
      s += h;
    }
    s = warp_sum(s);
    if (lane == 0) gx[(size_t)blockIdx.x * G + g] = s;
  }
}

// out = xb @ dequant(w) with an epilogue. xb (B, K) bf16, gx (B, G) f32 from
// rows_prologue; wt (N, K/2) u8, st/zt (N, G) f32 (the decode layout).
// NT n8-tiles per warp: the block owns 8 NT columns, the first 4 NT at
// c1 = sb * 2P + q * 4 NT and the others P further (sb, q from blockIdx.x).
// MT m16-tiles per warp; past 32 rows the warps 4..7 take rows 32...
//   EPI_ROPE: N = 3D, P = 64; out_bf16 (B, N): columns below rope_cols are
//     rotated with the slot's cos/sin rows (B, 128), sin signed.
//   EPI_RESIDUAL: P = 4 NT (the halves adjoin); out = acc + res (B, N), to
//     out_f32 and/or out_bf16.
//   EPI_SWIGLU: N = 2I, P = I; out_f32 (B, I) = silu(gate) * up.
template <int NT, int MT>
__global__ void __launch_bounds__(THREADS, 1)
rows_int4_kernel(const __nv_bfloat16* __restrict__ xb, const float* __restrict__ gx,
                 const uint8_t* __restrict__ wt, const float* __restrict__ st,
                 const float* __restrict__ zt, int B, int K, int N, int gs, int epi, int P,
                 const float* __restrict__ cosr, const float* __restrict__ sinr, int rope_cols,
                 const void* res, int res_bf16, float* out_f32, __nv_bfloat16* out_bf16) {
  constexpr int BN = 8 * NT, HW = 4 * NT, ROWS = 16 * MT;
  extern __shared__ __align__(16) float red[];  // [WARPS][ROWS][BN]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g_ = lane / 4, t = lane % 4;
  const int Kh = K / 2, G = K / gs, Gh = G / 2;
  const int bpp = P / HW;  // blocks per pair of halves
  const int c1 = (blockIdx.x / bpp) * 2 * P + (blockIdx.x % bpp) * HW, c2 = c1 + P;
  const int RH = B > 32 ? 2 : 1, KW = WARPS / RH;
  const int rbase = (warp / KW) * 32, kw = warp % KW;
  const int nsteps = Kh / STEP, per = (nsteps + KW - 1) / KW;
  const int s_begin = kw * per, s_end = min(nsteps, s_begin + per);

  float acc[NT][MT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[j][m][0] = acc[j][m][1] = acc[j][m][2] = acc[j][m][3] = 0.f;

  for (int step = s_begin; step < s_end; ++step) {
    const int r0 = step * STEP;
    const int glo = r0 / gs, ghi = Gh + glo;
    // A: rows g_ and g_ + 8 of each m-tile, 16 bf16 (k = r0 + 16 t ...) of
    // each plane as 8 words; mma step s takes words 2s and 2s + 1
    uint32_t alo[MT][2][8], ahi[MT][2][8];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = rbase + 16 * m + 8 * rr + g_;
        uint4 l0 = make_uint4(0, 0, 0, 0), l1 = l0, h0 = l0, h1 = l0;
        if (row < B) {
          const uint4* pl = reinterpret_cast<const uint4*>(xb + (size_t)row * K + r0 + 16 * t);
          const uint4* ph = reinterpret_cast<const uint4*>(xb + (size_t)row * K + Kh + r0 + 16 * t);
          l0 = __ldg(pl), l1 = __ldg(pl + 1), h0 = __ldg(ph), h1 = __ldg(ph + 1);
        }
        alo[m][rr][0] = l0.x, alo[m][rr][1] = l0.y, alo[m][rr][2] = l0.z, alo[m][rr][3] = l0.w;
        alo[m][rr][4] = l1.x, alo[m][rr][5] = l1.y, alo[m][rr][6] = l1.z, alo[m][rr][7] = l1.w;
        ahi[m][rr][0] = h0.x, ahi[m][rr][1] = h0.y, ahi[m][rr][2] = h0.z, ahi[m][rr][3] = h0.w;
        ahi[m][rr][4] = h1.x, ahi[m][rr][5] = h1.y, ahi[m][rr][6] = h1.z, ahi[m][rr][7] = h1.w;
      }
    // B: 16 packed rows (r0 + 16 t ...) of column g_ of each n-tile
    uint4 w[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = (j < NT / 2 ? c1 + 8 * j : c2 + 8 * (j - NT / 2)) + g_;
      w[j] = __ldg(reinterpret_cast<const uint4*>(wt + (size_t)col * Kh + r0 + 16 * t));
    }
    const bool first = r0 % gs == 0;  // the group's zero-point term goes with its first step
    float gl[MT][2] = {}, gh[MT][2] = {};
    if (first) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int row = rbase + 16 * m + 8 * rr + g_;
          gl[m][rr] = row < B ? gx[(size_t)row * G + glo] : 0.f;
          gh[m][rr] = row < B ? gx[(size_t)row * G + ghi] : 0.f;
        }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float plo[MT][4], phi[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        plo[m][0] = plo[m][1] = plo[m][2] = plo[m][3] = 0.f;
        phi[m][0] = phi[m][1] = phi[m][2] = phi[m][3] = 0.f;
      }
      const uint32_t ws[4] = {w[j].x, w[j].y, w[j].z, w[j].w};
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const uint32_t lo = ws[s] & 0x0F0F0F0Fu, hi = (ws[s] >> 4) & 0x0F0F0F0Fu;
        const uint32_t bl0 = nibbles_bf16x2(lo, 0x4140), bl1 = nibbles_bf16x2(lo, 0x4342);
        const uint32_t bh0 = nibbles_bf16x2(hi, 0x4140), bh1 = nibbles_bf16x2(hi, 0x4342);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const uint32_t al[4] = {alo[m][0][2 * s], alo[m][1][2 * s], alo[m][0][2 * s + 1],
                                  alo[m][1][2 * s + 1]};
          const uint32_t ah[4] = {ahi[m][0][2 * s], ahi[m][1][2 * s], ahi[m][0][2 * s + 1],
                                  ahi[m][1][2 * s + 1]};
          mma_bf16(plo[m], al, bl0, bl1);
          mma_bf16(phi[m], ah, bh0, bh1);
        }
      }
      // the accumulator's columns are 2t and 2t + 1 of the tile
      const int col = (j < NT / 2 ? c1 + 8 * j : c2 + 8 * (j - NT / 2)) + 2 * t;
      const float* sc0 = st + (size_t)col * G;
      const float* sc1 = sc0 + G;
      const float sl[2] = {__ldg(sc0 + glo), __ldg(sc1 + glo)};
      const float sh[2] = {__ldg(sc0 + ghi), __ldg(sc1 + ghi)};
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][m][i] += plo[m][i] * sl[i & 1] + phi[m][i] * sh[i & 1];
      if (first) {
        const float* z0 = zt + (size_t)col * G;
        const float* z1 = z0 + G;
        const float zl[2] = {__ldg(z0 + glo), __ldg(z1 + glo)};
        const float zh[2] = {__ldg(z0 + ghi), __ldg(z1 + ghi)};
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[j][m][i] += gl[m][i >> 1] * zl[i & 1] + gh[m][i >> 1] * zh[i & 1];
      }
    }
  }

  // the warps' partial sums meet in shared memory, in a fixed order
  float* mine = red + (size_t)warp * ROWS * BN;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mine[(16 * m + 8 * (i >> 1) + g_) * BN + 8 * j + 2 * t + (i & 1)] = acc[j][m][i];
  __syncthreads();
  const int nrows = min(B, 32 * RH);
  for (int e = tid; e < nrows * BN; e += THREADS) {
    const int row = e / BN, lc = e % BN;
    float* slot = red + ((size_t)(row / 32) * KW * ROWS + row % 32) * BN + lc;
    float v = slot[0];
    for (int k2 = 1; k2 < KW; ++k2) v += slot[(size_t)k2 * ROWS * BN];
    slot[0] = v;
  }
  __syncthreads();
  const int nout = epi == EPI_SWIGLU ? BN / 2 : BN;
  for (int e = tid; e < nrows * nout; e += THREADS) {
    const int row = e / nout, lc = e % nout;
    const float* rrow = red + ((size_t)(row / 32) * KW * ROWS + row % 32) * BN;
    const int col = lc < HW ? c1 + lc : c2 + lc - HW;
    float v = rrow[lc];
    if (epi == EPI_SWIGLU) {
      out_f32[(size_t)row * (N / 2) + col] = v * (1.f / (1.f + expf(-v))) * rrow[lc + HW];
      continue;
    }
    if (epi == EPI_ROPE) {
      if (col < rope_cols) {
        const int d = col % HS;
        v = v * cosr[row * HS + d] + rrow[(lc + HW) % BN] * sinr[row * HS + d];
      }
    } else {
      v += load_in(res, res_bf16, (size_t)row * N + col);
    }
    if (out_f32 != nullptr) out_f32[(size_t)row * N + col] = v;
    if (out_bf16 != nullptr) out_bf16[(size_t)row * N + col] = __float2bfloat16_rn(v);
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

template <int NT, int MT>
int launch_rows_tile(const void* xb, const void* gx, const void* wt, const void* st, const void* zt,
                     int B, int K, int N, int gs, int epi, int P, const void* cosr,
                     const void* sinr, int rope_cols, const void* res, int res_bf16, void* out_f32,
                     void* out_bf16, cudaStream_t stream) {
  const int smem = WARPS * 16 * MT * 8 * NT * (int)sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(rows_int4_kernel<NT, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  rows_int4_kernel<NT, MT><<<N / (8 * NT), THREADS, smem, stream>>>(
      (const __nv_bfloat16*)xb, (const float*)gx, (const uint8_t*)wt, (const float*)st,
      (const float*)zt, B, K, N, gs, epi, P, (const float*)cosr, (const float*)sinr, rope_cols, res,
      res_bf16, (float*)out_f32, (__nv_bfloat16*)out_bf16);
  return (int)cudaGetLastError();
}

// Share of the card's block slots that `blocks` blocks, one per SM at a time,
// keep busy over their waves.
double wave_fill(int blocks) {
  const int sms = sm_count();
  return (double)blocks / (double)((blocks + sms - 1) / sms * sms);
}

// Blocks of 64 columns where they fill the waves as well as blocks of 32 do
// (c_fc12: 344 blocks, 2.6 waves), else of 32 (c_attn: 192 blocks of 64 would
// leave half of the second wave idle; the c_proj products have too few
// columns). The wrappers check 1 <= B <= 64, K % 128 == 0, gs in {64, 128,
// 256}, (K/2) % gs == 0, N % 64 == 0 and, for EPI_SWIGLU, (N/2) % 32 == 0.
int launch_rows(const void* xb, const void* gx, const void* wt, const void* st, const void* zt,
                int B, int K, int N, int gs, int epi, const void* cosr, const void* sinr,
                int rope_cols, const void* res, int res_bf16, void* out_f32, void* out_bf16,
                cudaStream_t stream) {
  const bool wide = wave_fill(N / 64) >= wave_fill(N / 32);
  const int HW = wide ? 32 : 16;
  const int P = epi == EPI_ROPE ? HS / 2 : epi == EPI_SWIGLU ? N / 2 : HW;
#define LLT_ROWS(NT, MT)                                                                         \
  return launch_rows_tile<NT, MT>(xb, gx, wt, st, zt, B, K, N, gs, epi, P, cosr, sinr, rope_cols, \
                                  res, res_bf16, out_f32, out_bf16, stream)
  if (wide) {
    if (B <= 16) LLT_ROWS(8, 1);
    LLT_ROWS(8, 2);
  }
  if (B <= 16) LLT_ROWS(4, 1);
  LLT_ROWS(4, 2);
#undef LLT_ROWS
}

int launch_prologue(const void* x, int in_bf16, const void* norm_w, int B, int K, int gs, void* xb,
                    void* gx, cudaStream_t stream) {
  rows_prologue_kernel<<<B, THREADS, 0, stream>>>(x, in_bf16, (const __nv_bfloat16*)norm_w, 1e-5f,
                                                  K, gs, (__nv_bfloat16*)xb, (float*)gx);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv (B, 3D) bf16 = rope(rms_norm(x, rms1) @ dequant(c_attn)), x (B, D)
// bf16, cosr/sinr (B, 128) f32 (sin signed), head size 128. Scratch: xb
// (B, D) bf16, gx (B, D / gs) f32.
LLT_EXPORT int k7_block_head(const void* x, const void* rms1, const void* ca_w, const void* ca_s,
                             const void* ca_z, const void* cosr, const void* sinr, void* xb,
                             void* gx, void* qkv, int B, int D, int gs, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int err = launch_prologue(x, 1, rms1, B, D, gs, xb, gx, st);
  if (err) return err;
  return launch_rows(xb, gx, ca_w, ca_s, ca_z, B, D, 3 * D, gs, EPI_ROPE, cosr, sinr, 2 * D,
                     nullptr, 0, nullptr, qkv, st);
}

// out (B, D) bf16 = the block after its attention: xs = x + y @ c_proj;
// out = xs + (silu(g) * u) @ mlp c_proj with (g, u) = rms_norm(xs, rms2) @
// c_fc12. x, y (B, D) bf16. Scratch: xb (B, max(D, I)) bf16, gx (B, max(D, I)
// / gs) f32, xs (B, D) f32, gg (B, I) f32.
LLT_EXPORT int k9_block_tail(const void* x, const void* y, const void* rms2, const void* cp_w,
                             const void* cp_s, const void* cp_z, const void* f12_w,
                             const void* f12_s, const void* f12_z, const void* mp_w,
                             const void* mp_s, const void* mp_z, void* xb, void* gx, void* xs,
                             void* gg, void* out, int B, int D, int I, int gs, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int err = launch_prologue(y, 1, nullptr, B, D, gs, xb, gx, st);
  if (err) return err;
  err = launch_rows(xb, gx, cp_w, cp_s, cp_z, B, D, D, gs, EPI_RESIDUAL, nullptr, nullptr, 0, x, 1,
                    xs, nullptr, st);
  if (err) return err;
  err = launch_prologue(xs, 0, rms2, B, D, gs, xb, gx, st);
  if (err) return err;
  err = launch_rows(xb, gx, f12_w, f12_s, f12_z, B, D, 2 * I, gs, EPI_SWIGLU, nullptr, nullptr, 0,
                    nullptr, 0, gg, nullptr, st);
  if (err) return err;
  err = launch_prologue(gg, 0, nullptr, B, I, gs, xb, gx, st);
  if (err) return err;
  return launch_rows(xb, gx, mp_w, mp_s, mp_z, B, I, D, gs, EPI_RESIDUAL, nullptr, nullptr, 0, xs,
                     0, nullptr, out, st);
}
