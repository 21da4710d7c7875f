// The int4 matvec of K1 and K2 (and of the small-N probe) on Hopper's tensor
// cores, in bf16 and in f32 compute (the template parameter F32): one row x
// (K) times dequant(w) from the column-major decode layout, with an optional
// RMSNorm prologue and a residual or SiLU(gate) * up epilogue.
//
// Bound on the H100: bytes, the packed nibbles and f32 scale and zero planes
// (28.3 MB at c_attn 4096 -> 12288, 47.2 MB at c_fc12 4096 -> 22016). The
// first port's FFMA body spent about eight instructions a packed byte and ran
// at 28-39 % of the memory rate; at 3.35 TB/s an SM receives ~14 bytes a cycle.
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
// stores it as bf16 planes in shared memory and takes its f32 group sums
// while the first weights are in flight.
// Products on the tensor cores, mma.sync.m16n8k16 bf16 with f32 sums: the 16
// columns are the 16-row side, the token the n side. A 32-bit word of
// packed bytes becomes four bf16 pairs by a mask, an OR with the exponent of
// 128 and a subtraction of 128 (nibbles 0-15 are exact in bf16). The order
// of k inside a group is free: a thread fills its fragment from its own 16
// bytes (low nibbles k0 .. k0 + 15, high nibbles K/2 + the same), taking k0 +
// 4m + {0, 2} as the slots 2t, 2t + 1 and k0 + 4m + {1, 3} as 2t + 8, 2t + 9,
// and the input sits in shared memory with each aligned 4 in the order
// (0, 2, 1, 3), so the token's fragment for those slots is one 8-byte read.
// bf16 compute: one plane, bf16(x), in all eight n columns (every thread
// holds its two columns' sums). Arithmetic, as the Pallas kernel's: exact
// bf16(x) * nibble products summed in f32 (in another order than the MXU),
// each step's group sums times the group's f32 scale, plus the zero-point
// term from f32 group sums of the unrounded input; the residual stays f32.
// f32 compute: x splits exactly into three bf16 terms by truncation, hi = x
// with its low 16 bits cleared, mid = (x - hi) the same, lo = x - hi - mid
// (both differences exact; lo has at most 8 significant bits, so it is a
// bf16 whenever x is a multiple of 2^-133, every |x| >= 2^-110; below, lo
// is truncated, an error under 2^-133; truncation, not rounding, so no term
// overflows near FLT_MAX). Three planes (K * 6 bytes of shared memory: 66 KB
// at K = 11008, 24.6 KB at K = 4096; with the rings of WARPS_F32 warps a
// block takes 91 and 45 KB, two and four blocks an SM) feed n columns
// 0, 1 and 2 (the B fragment of lane group g = lane / 4 reads plane g; groups
// 3-7 read a 32-byte zero block, so the split costs no extra mma). Each term
// times a nibble is exact in the f32 sums, so the products are the f32
// products of the Pallas kernel and only the order of the sums differs. A
// step adds its hi and mid column sums (lane t = 0 holds n = 0, 1) and scales
// them; lane t = 1 scales its lo column (n = 2; n = 3 is zero) apart; after
// the last step one quad shuffle adds the lo sums: (sum (hi + mid) * s) +
// (sum lo * s), the scale multiplies before the terms meet. The zero-point
// term and the residual are the bf16 path's, the output f32.
#pragma once

#include <type_traits>

#include "mma.cuh"

namespace {

enum Epilogue { EPI_NONE = 0, EPI_RESIDUAL = 1, EPI_SWIGLU = 2 };

__device__ __forceinline__ float load_in(const void* p, int in_bf16, int i) {
  return in_bf16 ? bf16_to_f32(reinterpret_cast<const __nv_bfloat16*>(p)[i])
                 : reinterpret_cast<const float*>(p)[i];
}

// The arguments of one matvec: see gemv_sm90_kernel; cbf16 picks the compute.
struct Gemv {
  const void* x;
  int in_bf16;
  const void* norm_w;  // nullptr: no RMSNorm prologue
  int norm_bf16;
  const void *wt, *st, *zt;
  int K, N, gs, epi;
  const void* res;
  int res_bf16, cbf16;
  void* out_f32;
  void* out_c;
};

namespace gsm90 {

constexpr int WARPS = 4;      // warps a block in bf16 compute
constexpr int WARPS_F32 = 8;  // in f32: eight warps share the three planes of the input
constexpr int COLS = 16;      // output columns a block: the mma's 16 rows
constexpr int STEP = 64;      // bytes of a column a warp's step takes: a quad's four 16-byte copies
constexpr int STAGES = 3;     // steps in a warp's ring in bf16 compute
constexpr int STAGES_F32 = 2; // in f32 (the planes' shared memory: more blocks an SM fit)

__host__ __device__ constexpr int warps(bool f32) { return f32 ? WARPS_F32 : WARPS; }
__host__ __device__ constexpr int stages(bool f32) { return f32 ? STAGES_F32 : STAGES; }
__host__ __device__ constexpr int ring_uint4(bool f32) { return warps(f32) * stages(f32) * 2 * 32; }

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

constexpr int PLANES_F32 = 3;  // bf16 terms of an f32 input
constexpr int ZERO_BF16 = 16;   // the zero block the padding lane groups read (f32 compute)

// planes of the input in shared memory, and the bf16 elements they take with the zero block
__host__ __device__ constexpr int planes(bool f32) { return f32 ? PLANES_F32 : 1; }
inline size_t xs_elems(int K, bool f32) { return (size_t)planes(f32) * K + (f32 ? ZERO_BF16 : 0); }

inline size_t smem_bytes(int K, int G, bool f32) {
  return (size_t)ring_uint4(f32) * 16 + (size_t)warps(f32) * stages(f32) * 32 * 4 + xs_elems(K, f32) * 2 +
         (size_t)((G + 3) & ~3) * 4 +
         (size_t)COLS * G * 4 + (size_t)K / 16;
}

// the bits of an f32 with the low 16 cleared: the f32 value of bf16 truncation
__device__ __forceinline__ float trunc_bf16(float v) { return __uint_as_float(__float_as_uint(v) & 0xFFFF0000u); }

// two truncated f32 values (low 16 bits zero) as a bf16 pair, exactly
__device__ __forceinline__ uint32_t pack_trunc(float lo, float hi) {
  return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xFFFF0000u);
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

// out = [rms_norm](x) @ dequant(w) with an epilogue, from the column-major
// decode layout: wt (N, K/2) u8, st/zt (N, G) f32. x is (K) f32 or bf16, the
// norm weight bf16 or f32 (norm_bf16), applied in f32. out_f32 and out_c
// (either may be null): f32, and the compute dtype (bf16, or f32 under F32).
// EPI_SWIGLU: N = 2I, out has I.
template <int GS, bool F32>
__global__ void __launch_bounds__(32 * warps(F32))
gemv_sm90_kernel(const void* __restrict__ x, int in_bf16, const void* __restrict__ norm_w, int norm_bf16, float eps,
                 const uint8_t* __restrict__ wt, const float* __restrict__ st, const float* __restrict__ zt, int K,
                 int N, int epi, const void* res, int res_bf16, float* out_f32,
                 std::conditional_t<F32, float, __nv_bfloat16>* out_c) {
  constexpr int W = warps(F32), THREADS = 32 * W, NS = stages(F32);
  extern __shared__ __align__(16) uint4 dsm[];
  __shared__ float red[W][COLS];
  __shared__ float tot[COLS];
  __shared__ float wred[W];
  __shared__ float rnorm;
  const int G = K / GS, Gh = G / 2, Kh = K / 2, nsteps = Kh / STEP;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int tile = blockIdx.x;
  float* scales = reinterpret_cast<float*>(dsm + ring_uint4(F32));  // [W][NS][32]
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(scales + W * NS * 32);  // [planes][K], aligned 4s as (0, 2, 1, 3)
  float* gx = reinterpret_cast<float*>(xs + planes(F32) * K + (F32 ? ZERO_BF16 : 0));  // [G]
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
  uint4* ring = dsm + warp * NS * 64;
  float* wsc = scales + warp * NS * 32;
  const int my_steps = warp < nsteps ? (nsteps - warp + W - 1) / W : 0;
  auto fetch = [&](int j) {  // step warp + j * W into stage j % NS
    const int s = warp + j * W;
    uint4* stg = ring + (j % NS) * 64;
    cp_async16(stg + lane, wa + s * STEP, oka ? 16 : 0);
    cp_async16(stg + 32 + lane, wb + s * STEP, okb ? 16 : 0);
    cp_async4(wsc + (j % NS) * 32 + lane, sp + (oks ? s * STEP / GS : 0), oks ? 4 : 0);
  };
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    if (j < my_steps) fetch(j);
    cp_async_commit();
  }
  pdl_wait();
  pdl_trigger();

  // prologue: the optionally normalised input as bf16 planes (rounded, or
  // the three terms of the split), and the f32 group sums of the unrounded
  // input; thread tid takes the quads tid,
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
      for (int w = 0; w < W; ++w) s += wred[w];
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
    if constexpr (F32) {
      float r[4] = {h[0], h[1], h[2], h[3]};
#pragma unroll
      for (int p = 0; p < PLANES_F32; ++p) {
        float tp[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) tp[e] = trunc_bf16(r[e]), r[e] -= tp[e];  // exact: r keeps what tp left
        *reinterpret_cast<uint2*>(xs + p * K + k) = make_uint2(pack_trunc(tp[0], tp[2]), pack_trunc(tp[1], tp[3]));
      }
    } else {
      *reinterpret_cast<uint2*>(xs + k) = make_uint2(pack_bf16(h[0], h[2]), pack_bf16(h[1], h[3]));
    }
    float s = (h[0] + h[1]) + (h[2] + h[3]);
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if ((lane & 15) == 0) hsum[q4 / 16] = s;
  }
  __syncthreads();
  if (F32 && tid < ZERO_BF16 / 2) reinterpret_cast<uint32_t*>(xs + PLANES_F32 * K)[tid] = 0u;
  for (int gi = tid; gi < G; gi += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < GS / 64; ++j) s += hsum[gi * (GS / 64) + j];
    gx[gi] = s;
  }
  __syncthreads();

  // the token's n columns: plane 0 in all eight (bf16), or term g in column
  // g < 3 and the zero block in the rest (f32)
  const bool feeds = !F32 || g < PLANES_F32;
  const __nv_bfloat16* xb = feeds ? xs + (F32 ? g : 0) * K : xs + PLANES_F32 * K;
  const int km = feeds ? 1 : 0;
  float acc_a = 0.f, acc_b = 0.f;  // columns ca (row g) and cb (row g + 8)
  for (int j = 0; j < my_steps; ++j) {
    cp_async_wait<NS - 1>();
    __syncwarp();  // the scales other lanes copied
    const int s = warp + j * W;
    const uint4* stg = ring + (j % NS) * 64;
    const uint4 va = stg[lane], vb = stg[32 + lane];
    const int k0 = s * STEP + 16 * t;  // the thread's first low-nibble k
    const uint4* xl = reinterpret_cast<const uint4*>(xb + km * k0);
    const uint4* xh = reinterpret_cast<const uint4*>(xb + km * (Kh + k0));
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
    const float4 sc = reinterpret_cast<const float4*>(wsc + (j % NS) * 32)[g];
    if constexpr (F32) {  // t = 0: hi + mid; t = 1: lo (its n = 3 is zero)
      acc_a += (dl[0] + dl[1]) * sc.x + (dh[0] + dh[1]) * sc.y;
      acc_b += (dl[2] + dl[3]) * sc.z + (dh[2] + dh[3]) * sc.w;
    } else {
      acc_a += dl[0] * sc.x + dh[0] * sc.y;
      acc_b += dl[2] * sc.z + dh[2] * sc.w;
    }
    __syncwarp();  // every lane has read the stage's scales
    if (j + NS < my_steps) fetch(j + NS);
    cp_async_commit();
  }

  if constexpr (F32) {  // + the lo column's scaled sums of lane t + 1
    acc_a += __shfl_down_sync(0xffffffffu, acc_a, 1);
    acc_b += __shfl_down_sync(0xffffffffu, acc_b, 1);
  }
  if (t == 0) {
    red[warp][g] = acc_a;
    red[warp][g + 8] = acc_b;
  }
  cp_async_wait<0>();  // the zero plane
  __syncthreads();
  if (tid < COLS * 8) {  // the warps' partials in warp order, + the zero-point term: 8 threads a column
    const int c = tid / 8, p8 = tid % 8;
    float z = 0.f;
    for (int gi = p8; gi < G; gi += 8) z += zer[c * G + gi] * gx[gi];
    z += __shfl_xor_sync(0xffffffffu, z, 1);
    z += __shfl_xor_sync(0xffffffffu, z, 2);
    z += __shfl_xor_sync(0xffffffffu, z, 4);
    if (p8 == 0) {
      float v = red[0][c];
#pragma unroll
      for (int w = 1; w < W; ++w) v += red[w][c];
      tot[c] = v + z;
    }
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
    if (out_c != nullptr) out_c[c] = from_f32<std::conditional_t<F32, float, __nv_bfloat16>>(v);
  }
}

template <int GS, bool F32>
int launch_gs(const Gemv& a, cudaStream_t stream) {
  const int K = a.K, N = a.N;
  const size_t smem = smem_bytes(K, K / GS, F32);
  static int ready[16];
  const int err = allow_smem(ready, gemv_sm90_kernel<GS, F32>);
  if (err) return err;
  const int tiles = a.epi == EPI_SWIGLU ? (N / 2 + 7) / 8 : (N + COLS - 1) / COLS;
  return launch_pdl(gemv_sm90_kernel<GS, F32>, dim3(tiles), dim3(32 * warps(F32)), smem, stream, a.x, a.in_bf16, a.norm_w,
                    a.norm_bf16, 1e-5f, (const uint8_t*)a.wt, (const float*)a.st, (const float*)a.zt, K, N, a.epi,
                    a.res, a.res_bf16, (float*)a.out_f32, (std::conditional_t<F32, float, __nv_bfloat16>*)a.out_c);
}

template <bool F32>
int launch_f(const Gemv& a, cudaStream_t stream) {
  switch (a.gs) {
    case 64:
      return launch_gs<64, F32>(a, stream);
    case 128:
      return launch_gs<128, F32>(a, stream);
    case 256:
      return launch_gs<256, F32>(a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace gsm90

// The matvec of a Gemv in its compute dtype. gs in {64, 128, 256} (checked
// by the Python wrappers).
int launch_gemv(const Gemv& a, cudaStream_t stream) {
  return a.cbf16 ? gsm90::launch_f<false>(a, stream) : gsm90::launch_f<true>(a, stream);
}

}  // namespace
