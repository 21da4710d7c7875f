// The int4 matvec of K1 and K2 (and of the small-N probe) in bf16 compute on
// Hopper's tensor cores: one row x (K) times dequant(w) from the column-major
// decode layout, with an optional RMSNorm prologue and a residual or
// SiLU(gate) * up epilogue. f32 compute keeps the FFMA body of gemv_int4.cuh;
// launch_gemv below picks the body.
//
// Bound on the H100: bytes, the packed nibbles and f32 scale and zero planes
// (28.3 MB at c_attn 4096 -> 12288, 47.2 MB at c_fc12 4096 -> 22016). The FFMA
// body spent about eight instructions a packed byte and ran at 28-39 % of the
// memory rate; at 3.35 TB/s an SM receives ~14 bytes a cycle.
//
// Design. A block of four warps owns 16 output columns (8 gate and their 8 up
// columns under SiLU(gate) * up) and the warps split K: warp w takes the
// 64-byte steps w, w + 4, ... of every column, so any N fills the card and
// the four partial sums meet in shared memory in warp order (bits that depend
// on K and N alone). Each thread of a quad (t = lane % 4) copies 16 bytes of
// each of its two columns (rows g = lane / 4 and g + 8 of the mma) a step,
// with cp.async into a ring of STAGES steps; it reads back only what it
// copied, and the 32 scales a step needs (16 columns, two groups) come with
// it, a lane's copy each, so the ring needs no barrier but the warp's. The
// zero planes of the 16 columns and the first STAGES steps are asked for
// before the kernel waits on the one before it (programmatic dependent
// launch), and only then is the input read: the prologue normalises it,
// rounds it to bf16 into shared memory and takes its f32 group sums while the
// first weights are in flight.
// Products on the tensor cores, mma.sync.m16n8k16 bf16 with f32 sums: the 16
// columns are the 16-row side, the token the n side (all eight columns the
// same row, so every thread holds its two columns' sums). A 32-bit word of
// packed bytes becomes four bf16 pairs by a mask, an OR with the exponent of
// 128 and a subtraction of 128 (nibbles 0-15 are exact in bf16). The order
// of k inside a group is free: a thread fills its fragment from its own 16
// bytes (low nibbles k0 .. k0 + 15, high nibbles K/2 + the same), taking k0 +
// 4m + {0, 2} as the slots 2t, 2t + 1 and k0 + 4m + {1, 3} as 2t + 8, 2t + 9,
// and the input sits in shared memory with each aligned 4 in the order
// (0, 2, 1, 3), so the token's fragment for those slots is one 8-byte read.
// Arithmetic, as the Pallas kernel's: exact bf16(x) * nibble products summed
// in f32 (on the tensor cores, in another order than FFMA), each step's
// group sums times the group's f32 scale, plus the zero-point term from f32
// group sums of the unrounded input; the residual stays f32.
#pragma once

#include "gemv_int4.cuh"
#include "mma.cuh"

namespace {
namespace gsm90 {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int COLS = 16;    // output columns a block: the mma's 16 rows
constexpr int STEP = 64;    // bytes of a column a warp's step takes: a quad's four 16-byte copies
constexpr int STAGES = 3;   // steps in a warp's ring
constexpr int RING = WARPS * STAGES * 2 * 32;  // uint4
static_assert(WARPS == 4, "the epilogue sums the four warps' partials");

// column of the mma's row r (0..15) in block `tile`, and whether it exists
__device__ __forceinline__ int tile_col(int tile, int r, int N, int epi, bool& ok) {
  if (epi == EPI_SWIGLU) {
    const int I = N / 2, j = tile * 8 + (r & 7);
    ok = j < I;
    return r < 8 ? j : I + j;
  }
  const int c = tile * COLS + r;
  ok = c < N;
  return c;
}

inline size_t smem_bytes(int K, int G) {
  return (size_t)RING * 16 + (size_t)WARPS * STAGES * 32 * 4 + (size_t)K * 2 + (size_t)((G + 3) & ~3) * 4 +
         (size_t)COLS * G * 4 + (size_t)K / 16;
}

// four consecutive elements (k a multiple of 4) of a bf16 or f32 vector as f32
__device__ __forceinline__ void load4(const void* p, int is_bf16, int k, float* o) {
  if (is_bf16) {
    const uint2 w = *reinterpret_cast<const uint2*>(reinterpret_cast<const __nv_bfloat16*>(p) + k);
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&w);
    o[0] = __low2float(b[0]), o[1] = __high2float(b[0]), o[2] = __low2float(b[1]), o[3] = __high2float(b[1]);
  } else {
    const float4 f = *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(p) + k);
    o[0] = f.x, o[1] = f.y, o[2] = f.z, o[3] = f.w;
  }
}

// out = [rms_norm](x) @ dequant(w) with an epilogue; the arguments are
// gemv_int4_kernel's, in bf16 compute (out_c bf16).
template <int GS>
__global__ void __launch_bounds__(THREADS)
gemv_sm90_kernel(const void* __restrict__ x, int in_bf16, const void* __restrict__ norm_w, int norm_bf16, float eps,
                 const uint8_t* __restrict__ wt, const float* __restrict__ st, const float* __restrict__ zt, int K,
                 int N, int epi, const void* res, int res_bf16, float* out_f32, __nv_bfloat16* out_c) {
  extern __shared__ __align__(16) uint4 dsm[];
  __shared__ float red[WARPS][COLS];
  __shared__ float tot[COLS];
  __shared__ float wred[WARPS];
  __shared__ float rnorm;
  const int G = K / GS, Gh = G / 2, Kh = K / 2, nsteps = Kh / STEP;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int tile = blockIdx.x;
  float* scales = reinterpret_cast<float*>(dsm + RING);              // [WARPS][STAGES][32]
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(scales + WARPS * STAGES * 32);  // [K], aligned 4s as (0, 2, 1, 3)
  float* gx = reinterpret_cast<float*>(xs + K);                      // [G]
  float* zer = gx + ((G + 3) & ~3);                                  // [COLS][G]
  float* hsum = zer + COLS * G;                                      // [K / 64]

  // what depends on nothing: the zero plane (read at the end), then the
  // first steps, each with the 32 scales of its 16 columns' two groups
  for (int i = tid; i < COLS * G; i += THREADS) {
    bool ok;
    const int c = tile_col(tile, i / G, N, epi, ok);
    cp_async4(zer + i, zt + (ok ? (size_t)c * G + i % G : 0), ok ? 4 : 0);
  }
  bool oka, okb;
  const int ca = tile_col(tile, g, N, epi, oka), cb = tile_col(tile, g + 8, N, epi, okb);
  const uint8_t* wa = wt + (size_t)(oka ? ca : 0) * Kh + 16 * t;
  const uint8_t* wb = wt + (size_t)(okb ? cb : 0) * Kh + 16 * t;
  // lane (g, t) copies the scale of row g + 8 (t / 2), low (t even) or high group
  const bool oks = t < 2 ? oka : okb;
  const float* sp = st + (size_t)(oks ? (t < 2 ? ca : cb) : 0) * G + (t & 1) * Gh;
  uint4* ring = dsm + warp * STAGES * 64;
  float* wsc = scales + warp * STAGES * 32;
  const int my_steps = warp < nsteps ? (nsteps - warp + WARPS - 1) / WARPS : 0;
  auto fetch = [&](int j) {  // step warp + j * WARPS into stage j % STAGES
    const int s = warp + j * WARPS;
    uint4* stg = ring + (j % STAGES) * 64;
    cp_async16(stg + lane, wa + s * STEP, oka ? 16 : 0);
    cp_async16(stg + 32 + lane, wb + s * STEP, okb ? 16 : 0);
    cp_async4(wsc + (j % STAGES) * 32 + lane, sp + (oks ? s * STEP / GS : 0), oks ? 4 : 0);
  };
#pragma unroll
  for (int j = 0; j < STAGES; ++j) {
    if (j < my_steps) fetch(j);
    cp_async_commit();
  }
  pdl_wait();
  pdl_trigger();

  // prologue: the optionally normalised input, rounded to bf16, and the f32
  // group sums of the unrounded input; thread tid takes the quads tid,
  // tid + THREADS, ..., so a half-warp's 16 quads are 64 elements of one group
  const int nq = K / 4;
  float r = 1.f;
  if (norm_w != nullptr) {
    float ss = 0.f;
#pragma unroll 4
    for (int q4 = tid; q4 < nq; q4 += THREADS) {
      float v[4];
      load4(x, in_bf16, 4 * q4, v);
      ss += v[0] * v[0] + v[1] * v[1] + v[2] * v[2] + v[3] * v[3];
    }
    ss = warp_sum(ss);
    if (lane == 0) wred[warp] = ss;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < WARPS; ++w) s += wred[w];
      rnorm = rsqrtf(s / (float)K + eps);
    }
    __syncthreads();
    r = rnorm;
  }
#pragma unroll 4
  for (int q4 = tid; q4 < nq; q4 += THREADS) {  // nq % 32 == 0: whole warps
    const int k = 4 * q4;
    float h[4];
    load4(x, in_bf16, k, h);
    if (norm_w != nullptr) {
      float w4[4];
      load4(norm_w, norm_bf16, k, w4);
#pragma unroll
      for (int e = 0; e < 4; ++e) h[e] = h[e] * r * w4[e];
    }
    *reinterpret_cast<uint2*>(xs + k) = make_uint2(pack_bf16(h[0], h[2]), pack_bf16(h[1], h[3]));
    float s = (h[0] + h[1]) + (h[2] + h[3]);
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if ((lane & 15) == 0) hsum[q4 / 16] = s;
  }
  __syncthreads();
  for (int gi = tid; gi < G; gi += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < GS / 64; ++j) s += hsum[gi * (GS / 64) + j];
    gx[gi] = s;
  }
  __syncthreads();

  float acc_a = 0.f, acc_b = 0.f;  // columns ca (row g) and cb (row g + 8)
  for (int j = 0; j < my_steps; ++j) {
    cp_async_wait<STAGES - 1>();
    __syncwarp();  // the scales other lanes copied
    const int s = warp + j * WARPS;
    const uint4* stg = ring + (j % STAGES) * 64;
    const uint4 va = stg[lane], vb = stg[32 + lane];
    const int k0 = s * STEP + 16 * t;  // the thread's first low-nibble k
    const uint4* xl = reinterpret_cast<const uint4*>(xs + k0);
    const uint4* xh = reinterpret_cast<const uint4*>(xs + Kh + k0);
    const uint4 l0 = xl[0], l1 = xl[1], h0 = xh[0], h1 = xh[1];
    const uint32_t bl[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
    const uint32_t bh[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
    const uint32_t A[4] = {va.x, va.y, va.z, va.w}, B[4] = {vb.x, vb.y, vb.z, vb.w};
    float dl[4] = {0.f, 0.f, 0.f, 0.f}, dh[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const uint32_t al[4] = {nib2(A[m]), nib2(B[m]), nib2(A[m] >> 8), nib2(B[m] >> 8)};
      const uint32_t ah[4] = {nib2(A[m] >> 4), nib2(B[m] >> 4), nib2(A[m] >> 12), nib2(B[m] >> 12)};
      mma_bf16(dl, al, bl[2 * m], bl[2 * m + 1]);
      mma_bf16(dh, ah, bh[2 * m], bh[2 * m + 1]);
    }
    const float4 sc = reinterpret_cast<const float4*>(wsc + (j % STAGES) * 32)[g];
    acc_a += dl[0] * sc.x + dh[0] * sc.y;
    acc_b += dl[2] * sc.z + dh[2] * sc.w;
    __syncwarp();  // every lane has read the stage's scales
    if (j + STAGES < my_steps) fetch(j + STAGES);
    cp_async_commit();
  }

  if (t == 0) {
    red[warp][g] = acc_a;
    red[warp][g + 8] = acc_b;
  }
  cp_async_wait<0>();  // the zero plane
  __syncthreads();
  {  // + the zero-point term: 8 threads a column
    const int c = tid / 8, p8 = tid % 8;
    float z = 0.f;
    for (int gi = p8; gi < G; gi += 8) z += zer[c * G + gi] * gx[gi];
    z += __shfl_xor_sync(0xffffffffu, z, 1);
    z += __shfl_xor_sync(0xffffffffu, z, 2);
    z += __shfl_xor_sync(0xffffffffu, z, 4);
    if (p8 == 0) tot[c] = red[0][c] + red[1][c] + red[2][c] + red[3][c] + z;
  }
  __syncthreads();
  if (epi == EPI_SWIGLU) {
    const int j = tile * 8 + tid;
    if (tid < 8 && j < N / 2) {
      const float a = tot[tid], b = tot[tid + 8];
      out_f32[j] = a * (1.f / (1.f + expf(-a))) * b;
    }
  } else if (tid < COLS && tile * COLS + tid < N) {
    const int c = tile * COLS + tid;
    float v = tot[tid];
    if (epi == EPI_RESIDUAL) v += load_in(res, res_bf16, c);
    if (out_f32 != nullptr) out_f32[c] = v;
    if (out_c != nullptr) out_c[c] = __float2bfloat16_rn(v);
  }
}

template <int GS>
int launch_gs(const Gemv& a, cudaStream_t stream) {
  const int K = a.K, N = a.N;
  const size_t smem = smem_bytes(K, K / GS);
  static int ready[16];
  const int err = allow_smem(ready, gemv_sm90_kernel<GS>);
  if (err) return err;
  const int tiles = a.epi == EPI_SWIGLU ? (N / 2 + 7) / 8 : (N + COLS - 1) / COLS;
  return launch_pdl(gemv_sm90_kernel<GS>, dim3(tiles), dim3(THREADS), smem, stream, a.x, a.in_bf16, a.norm_w,
                    a.norm_bf16, 1e-5f, (const uint8_t*)a.wt, (const float*)a.st, (const float*)a.zt, K, N, a.epi,
                    a.res, a.res_bf16, (float*)a.out_f32, (__nv_bfloat16*)a.out_c);
}

}  // namespace gsm90

// The matvec of a Gemv: bf16 compute on the tensor cores (gsm90), f32 on
// the FFMA body. gs in {64, 128, 256} (checked by the Python wrappers).
int launch_gemv(const Gemv& a, cudaStream_t stream) {
  if (!a.cbf16) return launch_gemv_ffma(a, stream);
  switch (a.gs) {
    case 64:
      return gsm90::launch_gs<64>(a, stream);
    case 128:
      return gsm90::launch_gs<128>(a, stream);
    case 256:
      return gsm90::launch_gs<256>(a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
