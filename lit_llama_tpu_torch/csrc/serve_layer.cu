// K7 (block head) and K9 (block tail) of the batched serving decode step:
// everything of a transformer block around the attention, for B slots.
//
// Replace lit_llama_tpu/ops/fused_layer.py _block_head_kernel (entry
// block_head_fused: rms_1, int4 QKV product, half-basis RoPE per slot) and
// _block_tail_kernel (entry block_tail_fused: x + c_proj(y), rms_2, c_fc12,
// SiLU(gate) * up, mlp c_proj + residual).
//
// Bound on the H100. The products read K7's 28.3 MB and K9's 85.5 MB of int4
// weights with their f32 scale and zero planes; each nibble is used 2 B times
// on the tensor cores, so at B = 32 they are bound by the bytes (8.8 and 25.8
// us at 3.35 TB/s) and from about B = 100 by the operations (989 TF/s bf16).
//
// Design (bf16). A chain of small kernels, each launched under programmatic
// dependent launch (common.cuh launch_pdl), so that a product asks for its
// first weights before it waits on the kernel before it:
//   K7: rows_prep (rms_1, the bf16 row, its 64-sums) [-> lora_down] ->
//       product c_attn (RoPE epilogue [+ the LoRA update]);
//   K9: rows_prep (y) -> product attn.c_proj (x + ., its sums of squares by
//       64 columns) -> rows_prep (rms_2 from those sums) -> product c_fc12
//       (SiLU(gate) * up, written as the next product's bf16 row and 64-sums)
//       -> product mlp.c_proj (xs + .).
// The product (rows_sm90_kernel) runs mma.sync m16n8k16 with the weight
// columns as the 16-row side and the tokens as the n side: a warp owns 16
// columns, turns its two columns' bytes of a step into bf16 nibbles once for
// every token tile (exact, by a mask and the exponent of 128), and reads the
// tokens' fragments from shared memory, where the block's token rows of a
// k-step are staged once for its 128 columns (the rows are stored with each
// aligned 4 as (0, 2, 1, 3), the mma's k order, by whoever writes them). A
// block owns 128 columns (a head under RoPE; 64 gate columns and their 64 up
// columns under SiLU(gate) * up) and a K split; the splits (from N and K
// alone: 2 for c_attn, 4 for both c_proj products at 7B) are merged in split
// order by the last block to arrive, so a row's bits depend neither on B nor
// on the schedule. Weights, scales and zeros (16-byte runs of the shared
// layout's (G, N) planes) and token rows come through one cp.async ring, a
// block barrier a step: 5 steps deep with two blocks an SM, 8 deep where the
// grid is one wave of one block an SM (both c_proj products).
// K7's LoRA operand (the Pallas kernel's _add_lora_delta on the normed rows,
// before the rotation: qkv += (h @ lora_af) @ lora_bf in f32; any multiple of
// 8 columns R8, bf16 or f32): rows_prep also writes h in f32, lora_down makes
// ax = h @ lora_af, and the c_attn product's epilogue adds ax @ lora_bf to each
// reduced sum, LORA_R operand columns a pass, before RoPE. Any slot count: the
// product walks the slots in tiles of 8 to 128 rows; norm weights bf16 or
// f32, applied in f32.
// Arithmetic, as the Pallas kernels': exact bf16(h) x nibble products summed
// in f32, each step's sums times the group's f32 scale, plus the zero-point
// term from f32 sums of the unrounded h (by 64 rows, times the group's zero);
// f32 residual and MLP intermediates at every B.
//
//
// What became of the five things that held the previous design back (its
// rows_int4 and rows_prologue kernels; measured on an NVIDIA H100 80GB HBM3
// at 700 W by tools/profile_serve_kernels.py and tools/spans.py rows, the
// previous design beside):
//   1. every block re-read all token rows from L2 at each 64-byte step: the
//      rows are staged once a block and step for 128 columns (a quarter of
//      the previous L2 traffic at c_attn);
//   2. 250-register warps that waited on chains of conversions and mma: the
//      nibbles are converted once per warp and step for every token tile
//      (the previous spans: conversion 30-49 % of a warp), 128 registers and
//      two blocks an SM up to 64 slots;
//   3. eight launches in series (K9 six, K7 two): now K9 five and K7 two
//      (three with LoRA), chained by programmatic dependent launch; the bf16
//      rounding and the 64-sums of mlp.c_proj's row fold into c_fc12's
//      epilogue, rms_2's sums of squares into attn.c_proj's;
//   4. 2.6-2.9 waves: every grid is one wave (c_attn 192 and c_fc12 172
//      blocks at two an SM; both c_proj products 128 blocks with a deeper
//      ring);
//   5. the LoRA operand's one block a row: lora_down takes 8 columns and 256
//      rows of lora_af a block on every SM, and the update is spread over the
//      epilogue's threads (K7 at R8 = 128, B = 32: 171.0 -> 90.1 us bf16,
//      255.4 -> 91.3 f32).
// The route: the products at B = 32 (c_attn, attn.c_proj, c_fc12,
// mlp.c_proj) take 38.6, 21.9, 54.9 and 30.8 us here; K3's wgmma / TMA
// mainloop (gemm_sm90.cuh) on the same rows 55.0, 23.4, 81.4 and 43.4, so
// mma.sync with the weights as the 16-row side won: K3 makes the tokens
// wgmma's n and the weight columns its 64-row A, which the threads convert
// into shared memory before each product (a pass through shared memory and a
// barrier a k-step for every tile); here each warp converts its own two
// columns in registers and only the tokens come from shared memory. K7 at
// B = 32 46.9 us (previously 60.6, bound
// 8.8), K9 122.2 (previously 172.3, bound 25.8), B = 128 132.0 / 370.4
// (previously 165.9 / 504.9). What bounds them now is the warps' own chain a step (mma,
// the scale and zero-point FMAs, the fragment reads; the ring's wait is 2-4 %
// of a warp in spans.py rows), not the bytes: 28.3 MB in 38.6 us is 0.7 TB/s.
//
// f32 compute (the Pallas kernels' cdtype = f32): the normed row stays f32, so
// the products cannot be bf16 mma. The f32 body is a fixed sequence of FFMA
// kernels: rows_prep writes the f32 row (lora_down its ax), the f32 GEMM tile
// of gemm_f32.cuh multiplies it by the dequantized int4 weight of the shared
// (K/2, N) layout into an f32 scratch, and rows_epilogue adds the LoRA update
// and applies RoPE, the residual or SiLU(gate) * up. Bound: operations on the
// CUDA cores from a few slots up; simple and right first.
#include "gemm_f32.cuh"
#include "mma.cuh"

namespace {

constexpr int HS = 128;  // head size (RoPE pairs d and d + 64)

enum Epilogue { EPI_ROPE = 0, EPI_RESIDUAL = 1, EPI_SWIGLU = 2 };

__device__ __forceinline__ float load_in(const void* p, int in_bf16, size_t i) {
  return in_bf16 ? bf16_to_f32(reinterpret_cast<const __nv_bfloat16*>(p)[i])
                 : reinterpret_cast<const float*>(p)[i];
}

// four consecutive elements (i a multiple of 4) of a bf16 or f32 array as f32
__device__ __forceinline__ void load4(const void* p, int is_bf16, size_t i, float* o) {
  if (is_bf16) {
    const uint2 w = *reinterpret_cast<const uint2*>(reinterpret_cast<const __nv_bfloat16*>(p) + i);
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&w);
    o[0] = __low2float(b[0]), o[1] = __high2float(b[0]), o[2] = __low2float(b[1]), o[3] = __high2float(b[1]);
  } else {
    const float4 f = *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(p) + i);
    o[0] = f.x, o[1] = f.y, o[2] = f.z, o[3] = f.w;
  }
}

// ---- the rows' prologue ----------------------------------------------------
constexpr int PREP_THREADS = 128, PREP_K = 4 * PREP_THREADS;  // elements of a row a block
enum Norm { NORM_NONE = 0, NORM_SELF = 1, NORM_PARTS = 2 };

// Row blockIdx.y, elements blockIdx.x * PREP_K .. + PREP_K of x (B, K), bf16
// (in_bf16) or f32; K % 128 == 0, so a warp's 128 elements are all in or all
// out. h = x * r * w with r = 1 (NORM_NONE; w = 1), rsqrt(mean(x^2) + eps) of
// the row (NORM_SELF) or of the row's sums of squares over each 64 columns in
// parts (B, K / 64) (NORM_PARTS, the residual product's epilogue wrote them);
// w bf16 (norm_bf16) or f32. Writes, each where its pointer is not null: xb
// (B, K) = bf16(h) with each aligned 4 stored in the order (0, 2, 1, 3) (the
// mma's k order, so a token fragment is one 8-byte read); hsum (B, K / 64),
// the f32 sums of the unrounded h over each 64; h32 (B, K) = h in f32.
__global__ void __launch_bounds__(PREP_THREADS)
rows_prep_kernel(const void* __restrict__ x, int in_bf16, const void* __restrict__ norm_w, int norm_bf16, int norm,
                 const float* __restrict__ parts, float eps, int K, __nv_bfloat16* __restrict__ xb,
                 float* __restrict__ hsum, float* __restrict__ h32) {
  __shared__ float red[PREP_THREADS / 32];
  __shared__ float rnorm;
  pdl_wait();
  pdl_trigger();
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const size_t row = blockIdx.y, base = row * (size_t)K;
  float r = 1.f;
  if (norm != NORM_NONE) {
    float ss = 0.f;
    if (norm == NORM_SELF) {
      for (int k = 4 * tid; k < K; k += 4 * PREP_THREADS) {
        float v[4];
        load4(x, in_bf16, base + k, v);
        ss += v[0] * v[0] + v[1] * v[1] + v[2] * v[2] + v[3] * v[3];
      }
    } else {
      for (int i = tid; i < K / 64; i += PREP_THREADS) ss += parts[row * (K / 64) + i];
    }
    ss = warp_sum(ss);
    if (lane == 0) red[warp] = ss;
    __syncthreads();
    if (tid == 0) rnorm = rsqrtf((red[0] + red[1] + red[2] + red[3]) / (float)K + eps);
    __syncthreads();
    r = rnorm;
  }
  const int k = blockIdx.x * PREP_K + 4 * tid;
  if (k >= K) return;
  float h[4];
  load4(x, in_bf16, base + k, h);
  if (norm != NORM_NONE) {
    float w4[4];
    load4(norm_w, norm_bf16, k, w4);
#pragma unroll
    for (int e = 0; e < 4; ++e) h[e] = h[e] * r * w4[e];
  }
  if (xb != nullptr)
    *reinterpret_cast<uint2*>(xb + base + k) = make_uint2(pack_bf16(h[0], h[2]), pack_bf16(h[1], h[3]));
  if (h32 != nullptr) *reinterpret_cast<float4*>(h32 + base + k) = make_float4(h[0], h[1], h[2], h[3]);
  if (hsum != nullptr) {
    float s = (h[0] + h[1]) + (h[2] + h[3]);
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if ((lane & 15) == 0) hsum[row * (K / 64) + k / 64] = s;
  }
}

// ---- K7's LoRA operand: ax = h @ la with every SM's help ---------------------
constexpr int LD_K = 256, LD_C = 8;  // rows and columns of la a block

// ax (B, R8) f32 = h32 (B, D) f32 @ la (D, R8) of LT. Block (c, q) takes
// columns 8c .. 8c + 7 and rows 256q .. 256q + 255 of la (staged in f32 once)
// for every row of h, a warp four rows at a time; its partial goes to part
// (n_q, B, R8) and the last block of column group c to arrive (counter[c])
// sums the n_q partials in order into ax and resets the counter: bits that
// depend on neither B nor the order of arrival.
template <typename LT>
__global__ void __launch_bounds__(256)
lora_down_kernel(const float* __restrict__ h32, const LT* __restrict__ la, int B, int D, int R8,
                 float* __restrict__ part, int* __restrict__ counter, float* __restrict__ ax) {
  __shared__ float las[LD_K][LD_C + 1];
  __shared__ int last;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = blockIdx.x * LD_C, k0 = blockIdx.y * LD_K, nq = gridDim.y;
  for (int i = tid; i < LD_K; i += 256) {  // la does not depend on the kernel before
    float w[LD_C] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (k0 + i < D) load8(la + (size_t)(k0 + i) * R8 + c0, w);
#pragma unroll
    for (int c = 0; c < LD_C; ++c) las[i][c] = w[c];
  }
  pdl_wait();
  pdl_trigger();
  __syncthreads();
  constexpr int RB = 4, KL = LD_K / 32;  // rows a warp takes at once; elements of a row a lane
  for (int r0 = RB * warp; r0 < B; r0 += RB * 8) {
    float hv[RB][KL];  // every load of the RB rows in flight before the first product
#pragma unroll
    for (int rr = 0; rr < RB; ++rr)
#pragma unroll
      for (int u = 0; u < KL; ++u) {
        const int i = lane + 32 * u;
        hv[rr][u] = r0 + rr < B && k0 + i < D ? h32[(size_t)(r0 + rr) * D + k0 + i] : 0.f;
      }
#pragma unroll
    for (int rr = 0; rr < RB; ++rr) {
      float p[LD_C] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int u = 0; u < KL; ++u)
#pragma unroll
        for (int c = 0; c < LD_C; ++c) p[c] = fmaf(hv[rr][u], las[lane + 32 * u][c], p[c]);
#pragma unroll
      for (int c = 0; c < LD_C; ++c) p[c] = warp_sum(p[c]);
      if (lane == 0 && r0 + rr < B) {
        float4* dst = reinterpret_cast<float4*>(part + ((size_t)blockIdx.y * B + r0 + rr) * R8 + c0);
        dst[0] = make_float4(p[0], p[1], p[2], p[3]);
        dst[1] = make_float4(p[4], p[5], p[6], p[7]);
      }
    }
  }
  __threadfence();  // the partial is visible before the count that announces it
  __syncthreads();
  if (tid == 0) last = atomicAdd(counter + blockIdx.x, 1) == nq - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int e = tid; e < B * LD_C; e += 256) {
    const int row = e / LD_C, c = c0 + e % LD_C;
    float s = 0.f;
    for (int q = 0; q < nq; ++q) s += __ldcg(part + ((size_t)q * B + row) * R8 + c);
    ax[(size_t)row * R8 + c] = s;
  }
  if (tid == 0) counter[blockIdx.x] = 0;  // ready for the next launch
}

// ---- the int4 products on the tensor cores ---------------------------------
namespace rs {

constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int COLS = 16 * WARPS;  // output columns a block: a warp's 16 are the mma's 16 rows
constexpr int STEP = 64;          // packed bytes of a column a k-step: 64 low-plane and 64 high-plane rows
constexpr int TROW = 272;         // bytes of a token's k-step in shared memory: 128 low, 128 high, pad
constexpr int SPLIT_TARGET = 128, MAX_SPLITS = 4, MIN_SPLIT_STEPS = 8;  // K splits (ops/fused_layer.py serve_plan)
constexpr int ONE_WAVE = 132;     // blocks of a grid that takes the deep ring: one a streaming multiprocessor
constexpr int TP = COLS + 4;      // floats of a token's row in the epilogue's tile
constexpr int LORA_R = 32;        // LoRA operand columns the epilogue stages a pass

// steps in the ring for a token tile of 8 NT slots: two blocks an SM share
// its shared memory up to 64 slots, or (deep) a grid of at most ONE_WAVE
// blocks has an SM each and a deeper ring. A stage holds the tile's token rows
// of a step, each warp's 16 columns of the step and their scales and zeros,
// and the tokens' 64-sums of the step (low, high plane).
__host__ __device__ constexpr int stages(int nt, bool deep) {
  return deep ? (nt <= 8 ? 8 : 4) : (nt <= 4 ? 5 : nt == 8 ? 4 : 3);
}
__host__ __device__ constexpr int stage_bytes(int nt) {
  return 8 * nt * TROW + WARPS * 32 * 32 + WARPS * 64 * 4 + 8 * nt * 8;
}
__host__ __device__ constexpr int tile_bytes(int nt) {
  return 8 * nt * TP * 4 + 8 * nt * LORA_R * 4 + LORA_R * COLS * 4;
}
__host__ __device__ constexpr int smem_bytes(int nt, bool deep) {
  return stages(nt, deep) * stage_bytes(nt) > tile_bytes(nt) ? stages(nt, deep) * stage_bytes(nt) : tile_bytes(nt);
}

// The arguments of one product; see rows_sm90_kernel.
struct Args {
  const __nv_bfloat16* xb;  // (B, K) bf16, aligned 4s in the order (0, 2, 1, 3)
  const float* hsum;        // (B, K / 64) f32 sums of the unrounded row
  const uint8_t* wt;        // (N, K/2) u8, the decode layout
  const float *st, *zt;     // (G, N) f32, the shared layout's scale and zero planes
  int B, K, N, gs, epi, splits;
  const float *cosr, *sinr;  // EPI_ROPE: (B, 128) f32, sin signed
  int rope_cols;
  const void* res;  // EPI_RESIDUAL: (B, N) bf16 (res_bf16) or f32
  int res_bf16;
  float* out_f32;            // EPI_RESIDUAL: (B, N); EPI_SWIGLU: the next hsum (B, N / 128)
  __nv_bfloat16* out_bf16;   // EPI_ROPE / EPI_RESIDUAL: (B, N); EPI_SWIGLU: the next xb (B, N / 2)
  float* ssq;                // EPI_RESIDUAL: (B, N / 64) sums of squares of out, or null
  const float* ax;           // EPI_ROPE with R8 > 0: (B, R8) f32 and lb (R8, N), bf16 (lb_bf16) or f32
  const void* lb;
  int R8, lb_bf16;
  float* ws;     // splits > 1: (splits, B, N) f32 partials
  int* counter;  // splits > 1: gridDim.x arrival counters, zero
};

// column of the block's local column c (0 .. COLS - 1): a run of COLS, or
// under EPI_SWIGLU 64 gate columns and their 64 up columns
__device__ __forceinline__ int col_of(const Args& a, int cb, int c) {
  if (a.epi == EPI_SWIGLU) return (c < 64 ? 0 : a.N / 2) + cb * 64 + (c & 63);
  return cb * COLS + c;
}

// The epilogue of rows row0 .. row0 + Bt - 1 from the tile T [8 NT][TP] of
// their reduced sums (local columns): the LoRA update, then RoPE, the residual
// or SiLU(gate) * up; all threads.
__device__ void epilogue(const Args& a, float* T, int cb, int row0, int Bt, int nt) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (a.R8 > 0) {  // T += ax @ lb[:, columns], LORA_R operand columns a pass
    float* axs = T + 8 * nt * TP;  // [8 NT][LORA_R]
    float* lbs = axs + 8 * nt * LORA_R;  // [LORA_R][COLS]
    const int c = tid % COLS;
    for (int r0 = 0; r0 < a.R8; r0 += LORA_R) {
      const int nr = min(LORA_R, a.R8 - r0);  // a multiple of 8
      __syncthreads();  // the last pass is done with axs and lbs
      for (int e = tid; e < Bt * LORA_R; e += THREADS) {
        const int row = e / LORA_R, r = e % LORA_R;
        axs[e] = r < nr ? a.ax[(size_t)(row0 + row) * a.R8 + r0 + r] : 0.f;
      }
      for (int e = tid; e < LORA_R * COLS; e += THREADS) {
        const int r = e / COLS, cc = e % COLS;
        const size_t i = (size_t)(r0 + r) * a.N + col_of(a, cb, cc);
        lbs[e] = r >= nr ? 0.f : a.lb_bf16 ? bf16_to_f32(reinterpret_cast<const __nv_bfloat16*>(a.lb)[i])
                                            : reinterpret_cast<const float*>(a.lb)[i];
      }
      __syncthreads();
      float lbr[LORA_R];
#pragma unroll
      for (int r = 0; r < LORA_R; ++r) lbr[r] = lbs[r * COLS + c];
      for (int row = tid / COLS; row < Bt; row += THREADS / COLS) {
        const float4* ar = reinterpret_cast<const float4*>(axs + row * LORA_R);
        float d = 0.f;
#pragma unroll
        for (int q = 0; q < LORA_R / 4; ++q) {
          const float4 v = ar[q];
          d = fmaf(v.x, lbr[4 * q], d);
          d = fmaf(v.y, lbr[4 * q + 1], d);
          d = fmaf(v.z, lbr[4 * q + 2], d);
          d = fmaf(v.w, lbr[4 * q + 3], d);
        }
        T[row * TP + c] += d;
      }
    }
    __syncthreads();
  }
  if (a.epi == EPI_ROPE) {
    for (int e = tid; e < Bt * COLS; e += THREADS) {
      const int row = e / COLS, c = e % COLS, col = cb * COLS + c, grow = row0 + row;
      float v = T[row * TP + c];
      if (col < a.rope_cols)  // the block is one head: d = c, its partner c ^ 64
        v = fmaf(T[row * TP + (c ^ 64)], a.sinr[grow * HS + c], v * a.cosr[grow * HS + c]);
      a.out_bf16[(size_t)grow * a.N + col] = __float2bfloat16_rn(v);
    }
  } else if (a.epi == EPI_RESIDUAL) {  // a warp a (row, 64 columns), a lane two columns
    for (int i = warp; i < Bt * 2; i += WARPS) {
      const int row = i / 2, c = 64 * (i % 2) + 2 * lane, grow = row0 + row;
      const size_t o = (size_t)grow * a.N + cb * COLS + c;
      float v0 = T[row * TP + c], v1 = T[row * TP + c + 1];
      if (a.res_bf16) {
        const __nv_bfloat162 r2 =
            *reinterpret_cast<const __nv_bfloat162*>(reinterpret_cast<const __nv_bfloat16*>(a.res) + o);
        v0 += __low2float(r2), v1 += __high2float(r2);
      } else {
        const float2 r2 = *reinterpret_cast<const float2*>(reinterpret_cast<const float*>(a.res) + o);
        v0 += r2.x, v1 += r2.y;
      }
      if (a.out_f32 != nullptr) *reinterpret_cast<float2*>(a.out_f32 + o) = make_float2(v0, v1);
      if (a.out_bf16 != nullptr) *reinterpret_cast<__nv_bfloat162*>(a.out_bf16 + o) = __floats2bfloat162_rn(v0, v1);
      if (a.ssq != nullptr) {
        const float s = warp_sum(v0 * v0 + v1 * v1);
        if (lane == 0) a.ssq[(size_t)grow * (a.N / 64) + (cb * COLS + 64 * (i % 2)) / 64] = s;
      }
    }
  } else {  // EPI_SWIGLU: a half-warp a row, a lane four gate columns and their up columns
    const int I = a.N / 2, l = lane % 16, c = 4 * l;
    for (int b = 2 * warp; b < Bt; b += 2 * WARPS) {
      const int row = b + lane / 16;
      const bool ok = row < Bt;
      float gg[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float gv = ok ? T[row * TP + c + e] : 0.f, u = ok ? T[row * TP + 64 + c + e] : 0.f;
        gg[e] = gv * (1.f / (1.f + expf(-gv))) * u;
      }
      float s = (gg[0] + gg[1]) + (gg[2] + gg[3]);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (ok) {
        const size_t grow = row0 + row;
        *reinterpret_cast<uint2*>(a.out_bf16 + grow * I + cb * 64 + c) =
            make_uint2(pack_bf16(gg[0], gg[2]), pack_bf16(gg[1], gg[3]));
        if (l == 0) a.out_f32[grow * (I / 64) + cb] = s;
      }
    }
  }
}

// out = xb @ dequant(w) with an epilogue, on mma.sync m16n8k16 (bf16 in, f32
// sums). Block (blockIdx.x, blockIdx.y) = (column block cb, K split sp): the
// COLS columns of col_of, warp w owning 16 (the mma's rows, g and g + 8 a
// thread), for the k-steps [sp * nsteps / splits, (sp + 1) * nsteps / splits)
// of STEP packed bytes. The slots go in tiles of 8 NT rows (the mma's n side,
// n-tile j the rows 8 j ..); for each tile the block streams its steps through
// a ring of stages(NT, DEEP) stages by cp.async, a block barrier a step. The
// tile's sums go to shared memory, then to the epilogue or, with splits > 1,
// to ws, merged in split order by the last block to arrive.
template <int NT, bool DEEP>
__global__ void __launch_bounds__(THREADS, NT <= 8 && !DEEP ? 2 : 1) rows_sm90_kernel(const Args a) {
  constexpr int BT = 8 * NT, S = stages(NT, DEEP), SB = stage_bytes(NT);
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int last;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int cb = blockIdx.x, sp = blockIdx.y;
  const int Kh = a.K / 2, G = a.K / a.gs, Gh = G / 2, K64 = a.K / 64, nsteps = Kh / STEP;
  const int s0 = sp * nsteps / a.splits, n = (sp + 1) * nsteps / a.splits - s0;
  const uint8_t* wa = a.wt + (size_t)col_of(a, cb, 16 * warp + g) * Kh + (size_t)s0 * STEP + 16 * t;
  const uint8_t* wb = a.wt + (size_t)col_of(a, cb, 16 * warp + g + 8) * Kh + (size_t)s0 * STEP + 16 * t;
  // lane l < 16 copies 4 columns' (16 bytes of a (G, N) row) scales (l < 8)
  // or zeros of the step's low (l % 8 < 4) or high group: the warp's table of
  // a step is s_lo, s_hi, z_lo, z_hi of its 16 columns
  const float* sz = (lane < 8 ? a.st : a.zt) + col_of(a, cb, 16 * warp + 4 * (lane % 4)) +
                    (size_t)(lane % 8 < 4 ? 0 : Gh) * a.N;
  const int gshift = a.gs == 64 ? 0 : a.gs == 128 ? 1 : 2;  // step s lies in group s >> gshift of its plane
  constexpr int TPIECES = (BT * 16 + THREADS - 1) / THREADS;  // 16-byte pieces of token rows a thread copies a step
  constexpr int OFF_W = BT * TROW, OFF_S = OFF_W + WARPS * 32 * 32, OFF_H = OFF_S + WARPS * 64 * 4;

  auto fetch_w = [&](int j) {  // the warp's weights of step s0 + j into stage j % S, with their scales and zeros
    uint8_t* stg = smem + (j % S) * SB;
    uint4* w = reinterpret_cast<uint4*>(stg + OFF_W) + warp * 64;
    cp_async16(w + lane, wa + (size_t)j * STEP, 16);
    cp_async16(w + 32 + lane, wb + (size_t)j * STEP, 16);
    if (lane < 16)
      cp_async16(reinterpret_cast<float*>(stg + OFF_S) + warp * 64 + 4 * lane,
                 sz + (size_t)((s0 + j) >> gshift) * a.N, 16);
  };
  // a thread's token pieces of a tile: piece tid + THREADS i is token p / 16,
  // low (p % 16 < 8) or high plane, 16 bytes p % 8; its 64-sum, thread tid <
  // 2 BT's, token tid / 2, low or high plane
  const __nv_bfloat16* tsrc[TPIECES];
  uint32_t tok_ok = 0;  // bit i: piece i is a row of the tile
  const int tdst = (tid / 16) * TROW + 16 * (tid % 16);  // piece i lands 16 i rows further
  const float* hsrc = a.hsum;
  int hbytes = 0;
  auto tile_pieces = [&](int row0) {
    tok_ok = 0;
#pragma unroll
    for (int i = 0; i < TPIECES; ++i) {
      const int p = tid + THREADS * i, q = p % 16, row = row0 + p / 16;
      const bool ok = p < BT * 16 && row < a.B;
      tsrc[i] = a.xb + (size_t)(ok ? row : 0) * a.K + (q < 8 ? 0 : Kh) + STEP * s0 + 8 * (q % 8);
      tok_ok |= (uint32_t)ok << i;
    }
    const int row = row0 + tid / 2;
    hbytes = tid < BT * 2 && row < a.B ? 4 : 0;
    hsrc = a.hsum + (size_t)(hbytes ? row : 0) * K64 + (tid % 2 ? Kh / 64 : 0) + s0;
  };
  auto fetch_t = [&](int j) {  // the tile's token rows of step s0 + j and their 64-sums
    uint8_t* stg = smem + (j % S) * SB;
#pragma unroll
    for (int i = 0; i < TPIECES; ++i)
      if (tid + THREADS * i < BT * 16)
        cp_async16(stg + tdst + 16 * i * TROW, tsrc[i] + STEP * j, (tok_ok >> i & 1) ? 16 : 0);
    if (tid < BT * 2) cp_async4(stg + OFF_H + 4 * tid, hsrc + j, hbytes);
  };

  // the first steps' weights depend on nothing: in flight before the wait
#pragma unroll 1
  for (int j = 0; j < S - 1; ++j) {
    if (j < n) fetch_w(j);
    cp_async_commit();
  }
  pdl_wait();
  pdl_trigger();

  float* T = reinterpret_cast<float*>(smem);  // the epilogue's tile [BT][TP], in the ring
  for (int row0 = 0; row0 < a.B; row0 += BT) {
    const int Bt = min(BT, a.B - row0);
    if (row0 > 0) {
#pragma unroll 1
      for (int j = 0; j < S - 1; ++j) {
        if (j < n) fetch_w(j);
        cp_async_commit();
      }
    }
    tile_pieces(row0);
#pragma unroll 1
    for (int j = 0; j < S - 1; ++j) {
      if (j < n) fetch_t(j);
      cp_async_commit();
    }
    float acc[NT][4];
#pragma unroll
    for (int jt = 0; jt < NT; ++jt) acc[jt][0] = acc[jt][1] = acc[jt][2] = acc[jt][3] = 0.f;

#pragma unroll 1
    for (int j = 0; j < n; ++j) {
      cp_async_wait<S - 2>();
      __syncthreads();  // step j is in for every thread; step j - 1's stage is free
      if (j + S - 1 < n) {
        fetch_w(j + S - 1);
        fetch_t(j + S - 1);
      }
      cp_async_commit();
      const uint8_t* stg = smem + (j % S) * SB;
      const uint4* w = reinterpret_cast<const uint4*>(stg + OFF_W) + warp * 64;
      const float* sc = reinterpret_cast<const float*>(stg + OFF_S) + warp * 64 + g;
      const uint4 va = w[lane], vb = w[32 + lane];
      // (lo, hi) of column g, then of g + 8
      const float4 s4 = make_float4(sc[0], sc[16], sc[8], sc[24]), z4 = make_float4(sc[32], sc[48], sc[40], sc[56]);
      const uint32_t A[4] = {va.x, va.y, va.z, va.w}, Bw[4] = {vb.x, vb.y, vb.z, vb.w};
      uint32_t al[4][4], ah[4][4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        al[m][0] = nib2(A[m]), al[m][1] = nib2(Bw[m]), al[m][2] = nib2(A[m] >> 8), al[m][3] = nib2(Bw[m] >> 8);
        ah[m][0] = nib2(A[m] >> 4), ah[m][1] = nib2(Bw[m] >> 4), ah[m][2] = nib2(A[m] >> 12),
        ah[m][3] = nib2(Bw[m] >> 12);
      }
#pragma unroll
      for (int jt = 0; jt < NT; ++jt) {
        const uint8_t* tr = stg + (8 * jt + g) * TROW + 32 * t;  // token 8 jt + g, k 16 t ..
        const uint4 l0 = reinterpret_cast<const uint4*>(tr)[0], l1 = reinterpret_cast<const uint4*>(tr)[1];
        const uint4 h0 = reinterpret_cast<const uint4*>(tr + 128)[0], h1 = reinterpret_cast<const uint4*>(tr + 128)[1];
        const uint32_t bl[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
        const uint32_t bh[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
        float dl[4] = {0.f, 0.f, 0.f, 0.f}, dh[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          mma_bf16(dl, al[m], bl[2 * m], bl[2 * m + 1]);
          mma_bf16(dh, ah[m], bh[2 * m], bh[2 * m + 1]);
        }
        // 64-sums (low, high) of tokens 8 jt + 2t and + 1 (the accumulator's columns 2t, 2t + 1)
        const float4 q = *reinterpret_cast<const float4*>(stg + OFF_H + (8 * jt + 2 * t) * 8);
        float* c = acc[jt];
        c[0] = fmaf(dl[0], s4.x, c[0]), c[0] = fmaf(dh[0], s4.y, c[0]);
        c[0] = fmaf(q.x, z4.x, c[0]), c[0] = fmaf(q.y, z4.y, c[0]);
        c[1] = fmaf(dl[1], s4.x, c[1]), c[1] = fmaf(dh[1], s4.y, c[1]);
        c[1] = fmaf(q.z, z4.x, c[1]), c[1] = fmaf(q.w, z4.y, c[1]);
        c[2] = fmaf(dl[2], s4.z, c[2]), c[2] = fmaf(dh[2], s4.w, c[2]);
        c[2] = fmaf(q.x, z4.z, c[2]), c[2] = fmaf(q.y, z4.w, c[2]);
        c[3] = fmaf(dl[3], s4.z, c[3]), c[3] = fmaf(dh[3], s4.w, c[3]);
        c[3] = fmaf(q.z, z4.z, c[3]), c[3] = fmaf(q.w, z4.w, c[3]);
      }
    }

    // the tile's sums into T [BT][TP] (the ring's memory)
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int jt = 0; jt < NT; ++jt)
#pragma unroll
      for (int i = 0; i < 4; ++i) T[(8 * jt + 2 * t + (i & 1)) * TP + 16 * warp + g + 8 * (i >> 1)] = acc[jt][i];
    __syncthreads();
    if (a.splits == 1) {
      epilogue(a, T, cb, row0, Bt, NT);
    } else {  // the partial to ws [sp][row][cb * COLS + c]
      for (int e = tid; e < Bt * COLS / 4; e += THREADS) {
        const int row = e / (COLS / 4), c4 = e % (COLS / 4);
        *reinterpret_cast<float4*>(a.ws + ((size_t)sp * a.B + row0 + row) * a.N + cb * COLS + 4 * c4) =
            *reinterpret_cast<const float4*>(T + row * TP + 4 * c4);
      }
    }
    __syncthreads();  // T is the next tile's ring
  }
  if (a.splits == 1) return;

  __threadfence();  // the partials are visible before the count that announces them
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.counter + cb, 1) == a.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int row0 = 0; row0 < a.B; row0 += BT) {
    const int Bt = min(BT, a.B - row0);
    for (int e = tid; e < Bt * COLS / 4; e += THREADS) {  // the splits in order
      const int row = e / (COLS / 4), c4 = e % (COLS / 4);
      float4 v = __ldcg(reinterpret_cast<const float4*>(a.ws + ((size_t)row0 + row) * a.N + cb * COLS + 4 * c4));
      for (int q = 1; q < a.splits; ++q) {
        const float4 u =
            __ldcg(reinterpret_cast<const float4*>(a.ws + ((size_t)q * a.B + row0 + row) * a.N + cb * COLS + 4 * c4));
        v.x += u.x, v.y += u.y, v.z += u.z, v.w += u.w;
      }
      *reinterpret_cast<float4*>(T + row * TP + 4 * c4) = v;
    }
    __syncthreads();
    epilogue(a, T, cb, row0, Bt, NT);
    __syncthreads();
  }
  if (tid == 0) a.counter[cb] = 0;  // ready for the next launch
}

// K splits of a product, from N and K alone (ops/fused_layer.py serve_plan):
// doubled while the blocks do not reach SPLIT_TARGET and a split keeps at
// least MIN_SPLIT_STEPS steps
inline int plan_splits(int N, int K) {
  const int blocks = N / COLS, steps = K / 2 / STEP;
  int s = 1;
  while (blocks * s < SPLIT_TARGET && s < MAX_SPLITS && steps / (2 * s) >= MIN_SPLIT_STEPS) s *= 2;
  return s;
}

template <int NT, bool DEEP>
int launch_ring(const Args& a, cudaStream_t stream) {
  static int ready[16];
  const int err = allow_smem(ready, rows_sm90_kernel<NT, DEEP>);
  if (err) return err;
  return launch_pdl(rows_sm90_kernel<NT, DEEP>, dim3(a.N / COLS, a.splits), dim3(THREADS),
                    (size_t)smem_bytes(NT, DEEP), stream, a);
}

template <int NT>
int launch_nt(const Args& a, cudaStream_t stream) {
  return a.N / COLS * a.splits <= ONE_WAVE ? launch_ring<NT, true>(a, stream) : launch_ring<NT, false>(a, stream);
}

// The token tile: the fewest n-tiles (1, 2, 4, 8, 16) that hold B, at most 16
// (128 slots; more go in tiles of 128). The tile decides no sum's order.
int launch(const Args& a, cudaStream_t stream) {
  if (a.splits != plan_splits(a.N, a.K)) return (int)cudaErrorInvalidValue;
  if (a.B <= 8) return launch_nt<1>(a, stream);
  if (a.B <= 16) return launch_nt<2>(a, stream);
  if (a.B <= 32) return launch_nt<4>(a, stream);
  if (a.B <= 64) return launch_nt<8>(a, stream);
  return launch_nt<16>(a, stream);
}

}  // namespace rs

int launch_prep(const void* x, int in_bf16, const void* norm_w, int norm_bf16, int norm, const void* parts, int B,
                int K, void* xb, void* hsum, void* h32, cudaStream_t st) {
  return launch_pdl(rows_prep_kernel, dim3((K + PREP_K - 1) / PREP_K, B), dim3(PREP_THREADS), 0, st, x, in_bf16,
                    norm_w, norm_bf16, norm, (const float*)parts, 1e-5f, K, (__nv_bfloat16*)xb, (float*)hsum,
                    (float*)h32);
}

int launch_lora_down(const void* h32, const void* la, int lora_bf16, int B, int D, int R8, void* part, void* counter,
                     void* ax, cudaStream_t st) {
  const dim3 grid(R8 / LD_C, (D + LD_K - 1) / LD_K);
  if (lora_bf16)
    return launch_pdl(lora_down_kernel<__nv_bfloat16>, grid, dim3(256), 0, st, (const float*)h32,
                      (const __nv_bfloat16*)la, B, D, R8, (float*)part, (int*)counter, (float*)ax);
  return launch_pdl(lora_down_kernel<float>, grid, dim3(256), 0, st, (const float*)h32, (const float*)la, B, D, R8,
                    (float*)part, (int*)counter, (float*)ax);
}

// The f32 body's epilogue, one thread per output element: acc (B, N) f32
// from the GEMM. EPI_ROPE: out (B, N) = acc (+ ax . lb[:, col], the LoRA
// operand of LT, with R8 > 0), columns below rope_cols rotated by the slot's
// cos/sin rows (B, 128). EPI_RESIDUAL: out (B, N) = acc + res (B, N) f32.
// EPI_SWIGLU: N = 2I, out (B, I) = silu(gate) * up.
template <typename LT>
__global__ void rows_epilogue_kernel(const float* __restrict__ acc, int B, int N, int epi,
                                     const float* __restrict__ cosr, const float* __restrict__ sinr,
                                     int rope_cols, const float* __restrict__ res,
                                     const float* __restrict__ ax, const LT* __restrict__ lb, int R8,
                                     float* __restrict__ out) {
  const int nout = epi == EPI_SWIGLU ? N / 2 : N;
  const size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (e >= (size_t)B * nout) return;
  const int row = (int)(e / nout), col = (int)(e % nout);
  const float* arow = acc + (size_t)row * N;
  if (epi == EPI_SWIGLU) {
    const float g = arow[col];
    out[e] = g * (1.f / (1.f + expf(-g))) * arow[nout + col];
    return;
  }
  if (epi == EPI_RESIDUAL) {
    out[e] = arow[col] + res[e];
    return;
  }
  auto val = [&](int c) {
    float v = arow[c];
    float d = 0.f;
    for (int r = 0; r < R8; ++r) d += ax[(size_t)row * R8 + r] * to_f32(lb[(size_t)r * N + c]);
    return v + d;
  };
  float v = val(col);
  if (col < rope_cols) {
    const int d = col % HS;
    const int partner = col - d + (d + HS / 2) % HS;
    v = v * cosr[row * HS + d] + val(partner) * sinr[row * HS + d];
  }
  out[e] = v;
}

// f32 body: acc (B, N) = h (B, K) f32 @ dequant(w), w in the shared (K/2, N)
// layout, K in up to `splits` parts added in order behind counter (the
// tile's int32 zeros), then the epilogue into out
int launch_rows_f32(const float* h, const void* qw, const void* qs, const void* qz, int B, int K, int N,
                    int gs, void* acc, void* counter, int splits, int epi, const void* cosr, const void* sinr,
                    int rope_cols, const void* res, const void* ax, const void* lb, int lora_bf16, int R8,
                    void* out, cudaStream_t stream) {
  int err = gemm_f32::launch(h, gemm_f32::Int4W{(const uint8_t*)qw, (const float*)qs, (const float*)qz, K, N, gs},
                             nullptr, (float*)acc, (int*)counter, B, N, K, splits, stream);
  if (err) return err;
  const size_t n = (size_t)B * (epi == EPI_SWIGLU ? N / 2 : N);
  const unsigned blocks = (unsigned)((n + 255) / 256);
  if (R8 > 0 && !lora_bf16)
    rows_epilogue_kernel<float><<<blocks, 256, 0, stream>>>(
        (const float*)acc, B, N, epi, (const float*)cosr, (const float*)sinr, rope_cols, (const float*)res,
        (const float*)ax, (const float*)lb, R8, (float*)out);
  else
    rows_epilogue_kernel<__nv_bfloat16><<<blocks, 256, 0, stream>>>(
        (const float*)acc, B, N, epi, (const float*)cosr, (const float*)sinr, rope_cols, (const float*)res,
        (const float*)ax, (const __nv_bfloat16*)lb, R8, (float*)out);
  return (int)cudaGetLastError();
}


}  // namespace

// qkv (B, 3D) = rope(rms_norm(x, rms1) @ dequant(c_attn)), head size 128,
// any B >= 1. rms1 (D) bf16 (norm_bf16 = 1) or f32. cos/sin (B, 128) f32 (sin
// signed). With la not null, the LoRA operand la (D, R8) and lb (R8, 3D), bf16
// (lora_bf16 = 1) or f32, adds (h @ la) @ lb before RoPE: h32 (B, D) f32 holds
// h, axpart (D / 256 rounded up, B, R8) f32 the partials of ax (B, R8) f32,
// counter (R8 / 8) int32 zeros. cbf16 = 1: x and qkv bf16, the weight in the
// decode layout (ca_w, ca_s, ca_z = qw_t, qscale_t, qzero_t); scratch xb (B, D)
// bf16, hsum (B, D / 64) f32 and, with splits > 1 (ops/fused_layer.py
// serve_plan), ws (splits, B, 3D) f32 and counter (3D / 128) zeros. cbf16 = 0:
// x and qkv f32, the weight in the shared layout (qw, qscale, qzero); h32 (B,
// D) f32 the normed row, acc (B, 3D) f32 the GEMM's sums, with splits > 1
// counter the f32 tile's int32 zeros (quant_matmul.f32_plan; ws unused).
LLT_EXPORT int k7_block_head(const void* x, const void* rms1, int norm_bf16, int cbf16, const void* ca_w,
                             const void* ca_s, const void* ca_z, const void* cosr, const void* sinr, void* xb,
                             void* hsum, void* h32, void* acc, void* ws, int splits, void* counter, const void* la,
                             const void* lb, void* ax, void* axpart, int R8, int lora_bf16, void* qkv, int B, int D,
                             int gs, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (la == nullptr) R8 = 0;
  int err = launch_prep(x, cbf16, rms1, norm_bf16, NORM_SELF, nullptr, B, D, cbf16 ? xb : nullptr,
                        cbf16 ? hsum : nullptr, R8 > 0 || !cbf16 ? h32 : nullptr, st);
  if (!err && R8 > 0) err = launch_lora_down(h32, la, lora_bf16, B, D, R8, axpart, counter, ax, st);
  if (err) return err;
  if (!cbf16)
    return launch_rows_f32((const float*)h32, ca_w, ca_s, ca_z, B, D, 3 * D, gs, acc, counter, splits, EPI_ROPE, cosr,
                           sinr, 2 * D, nullptr, ax, lb, lora_bf16, R8, qkv, st);
  return rs::launch(rs::Args{(const __nv_bfloat16*)xb, (const float*)hsum, (const uint8_t*)ca_w, (const float*)ca_s,
                             (const float*)ca_z, B, D, 3 * D, gs, EPI_ROPE, splits, (const float*)cosr,
                             (const float*)sinr, 2 * D, nullptr, 0, nullptr, (__nv_bfloat16*)qkv, nullptr,
                             (const float*)ax, lb, R8, lora_bf16, (float*)ws, (int*)counter},
                    st);
}

// out (B, D) = the block after its attention: xs = x + y @ c_proj; out = xs +
// (silu(g) * u) @ mlp c_proj with (g, u) = rms_norm(xs, rms2) @ c_fc12. Any
// B >= 1. rms2 (D) bf16 (norm_bf16 = 1) or f32; xs (B, D) f32 scratch. cbf16 =
// 1: x, y, out bf16, weights in the decode layout; scratch xb (B, D) and xb2
// (B, I) bf16, hsum (B, D / 64), hsum2 (B, I / 64) and ssq (B, D / 64) f32,
// and for the products with s_* > 1 (serve_plan) ws (max of s * N, B) f32 and
// counter (D / 128) zeros. cbf16 = 0: x, y, out f32, weights in the shared
// layout; scratch xb (B, D) f32 (the normed row), gg (B, I) f32, acc (B,
// max(D, 2I)) f32 (the GEMM's sums), counter the f32 tiles' int32 zeros for
// the three products' K splits (quant_matmul.f32_plan; ws unused).
LLT_EXPORT int k9_block_tail(const void* x, const void* y, const void* rms2, int norm_bf16, int cbf16,
                             const void* cp_w, const void* cp_s, const void* cp_z, const void* f12_w,
                             const void* f12_s, const void* f12_z, const void* mp_w, const void* mp_s,
                             const void* mp_z, void* xb, void* hsum, void* xb2, void* hsum2, void* ssq, void* xs,
                             void* gg, void* acc, void* out, void* ws, void* counter, int s_cp, int s_fc, int s_mp,
                             int B, int D, int I, int gs, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!cbf16) {
    int err = launch_rows_f32((const float*)y, cp_w, cp_s, cp_z, B, D, D, gs, acc, counter, s_cp, EPI_RESIDUAL,
                              nullptr, nullptr, 0, x, nullptr, nullptr, 1, 0, xs, st);
    if (!err) err = launch_prep(xs, 0, rms2, norm_bf16, NORM_SELF, nullptr, B, D, nullptr, nullptr, xb, st);
    if (!err)
      err = launch_rows_f32((const float*)xb, f12_w, f12_s, f12_z, B, D, 2 * I, gs, acc, counter, s_fc, EPI_SWIGLU,
                            nullptr, nullptr, 0, nullptr, nullptr, nullptr, 1, 0, gg, st);
    if (err) return err;
    return launch_rows_f32((const float*)gg, mp_w, mp_s, mp_z, B, I, D, gs, acc, counter, s_mp, EPI_RESIDUAL, nullptr,
                           nullptr, 0, xs, nullptr, nullptr, 1, 0, out, st);
  }
  using rs::Args;
  const __nv_bfloat16 *b1 = (const __nv_bfloat16*)xb, *b2 = (const __nv_bfloat16*)xb2;
  int err = launch_prep(y, 1, nullptr, 1, NORM_NONE, nullptr, B, D, xb, hsum, nullptr, st);
  if (!err)
    err = rs::launch(Args{b1, (const float*)hsum, (const uint8_t*)cp_w, (const float*)cp_s, (const float*)cp_z, B, D,
                          D, gs, EPI_RESIDUAL, s_cp, nullptr, nullptr, 0, x, 1, (float*)xs, nullptr, (float*)ssq,
                          nullptr, nullptr, 0, 1, (float*)ws, (int*)counter},
                     st);
  if (!err) err = launch_prep(xs, 0, rms2, norm_bf16, NORM_PARTS, ssq, B, D, xb, hsum, nullptr, st);
  if (!err)
    err = rs::launch(Args{b1, (const float*)hsum, (const uint8_t*)f12_w, (const float*)f12_s, (const float*)f12_z, B,
                          D, 2 * I, gs, EPI_SWIGLU, s_fc, nullptr, nullptr, 0, nullptr, 0, (float*)hsum2,
                          (__nv_bfloat16*)xb2, nullptr, nullptr, nullptr, 0, 1, (float*)ws, (int*)counter},
                     st);
  if (err) return err;
  return rs::launch(Args{b2, (const float*)hsum2, (const uint8_t*)mp_w, (const float*)mp_s, (const float*)mp_z, B, I,
                         D, gs, EPI_RESIDUAL, s_mp, nullptr, nullptr, 0, xs, 0, nullptr, (__nv_bfloat16*)out,
                         nullptr, nullptr, nullptr, 0, 1, (float*)ws, (int*)counter},
                    st);
}
