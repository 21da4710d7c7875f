// K6: int8 weight-only matmul, out = bf16((x @ qw) * scale), the sum over K
// in f32 and the per-column scale applied once at the end.
//
// Replaces lit_llama_tpu/ops/quant_matmul_pallas.py _int8_kernel, entry
// matmul_int8.
//
// Layout (ops/linear.py): qw (K, N) int8, a row contiguous along N; qscale
// (1, N) f32. int8 -> bf16 is exact, so the products are those of the Pallas
// kernel (x and w in the compute dtype, f32 accumulation).
//
// Bound on the H100: bytes. At M = 1 (one launch per linear and decoded
// token) the K * N weight bytes are all there is: 50 MB for c_attn, 15 us at
// the card's memory rate, against 0.1 GFLOP of work. At prefill M (8..512)
// the weight stream still dominates the bytes and the tensor-core work is
// 2 * M * K * N; the two bounds meet near M = 300.
//
// Design: one entry, two bodies chosen by M.
//  M == 1, a weight stream: a block of 256 threads owns a strip of 128
//   columns and a range of rows; eight threads read one row's 128 bytes as
//   16-byte vectors, 32 rows per step and four steps in flight per thread;
//   each thread keeps 16 f32 sums, the block adds its 32 row lanes through
//   shared memory. A byte becomes an f32 by a byte permute under the exponent
//   of 2^23 and one exact subtraction (no conversion instruction). K is split
//   over blockIdx.y so that every SM has work at N = 4096; the f32 partials
//   are summed in a fixed order by splitk_reduce_kernel, so the result does
//   not depend on the schedule.
//  M > 1, a tensor-core product: the 64 x 128 output tile of gemm_tile.cuh,
//   shared with K3 (bf16 WMMA, f32 accumulate, the scale in store_tile). A
//   k-step converts a 64-row slab of int8 to bf16 in shared memory; the next
//   step's operands are loaded into registers while the tensor cores work on
//   the current one. Rows past K and columns past N are zero-filled or
//   skipped, so K need not be a multiple of the k-step nor N of the tile.
//   Split-K as above when the output tiles alone are fewer than the SMs.
// Simple first: no cp.async/TMA ring, no wgmma; those are later work.
//
// f32 compute (the Pallas entry's compute dtype f32): at M == 1 the same
// weight stream with an f32 x and an f32 result (XT below); at M > 1 the FFMA
// tile of gemm_f32.cuh on the exact f32 weight, the scale applied to the f32
// sum at the end. Bound at M > 1: operations on the CUDA cores, 67 TF/s.

#include "gemm_f32.cuh"
#include "gemm_tile.cuh"

using namespace gemm_tile;

namespace {

// ---- M == 1 ----------------------------------------------------------------

constexpr int GV_THREADS = 256, GV_COLS = 128;
constexpr int GV_ROWS = GV_THREADS / (GV_COLS / 16);  // rows per step: 32
constexpr int GV_UNROLL = 4;

// acc[0..3] += xv * the four int8 of w. u = w ^ 0x80808080 holds each byte
// offset by 128; byte i under the bytes (0x4B, 0, 0) is the f32 2^23 + u_i,
// and subtracting 2^23 + 128 leaves the signed value, exactly.
__device__ __forceinline__ void fma_s8x4(float* acc, uint32_t w, float xv) {
  const uint32_t u = w ^ 0x80808080u;
  acc[0] = fmaf(xv, __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f, acc[0]);
  acc[1] = fmaf(xv, __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f, acc[1]);
  acc[2] = fmaf(xv, __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f, acc[2]);
  acc[3] = fmaf(xv, __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f, acc[3]);
}

// blockIdx.x: the 128-column strip; blockIdx.y: rows [y * rows_per_split,
// (y + 1) * rows_per_split). With ws the raw f32 sums go to ws[y], else the
// scaled result to out. XT: the compute dtype of x and out, bf16 or f32.
template <typename XT>
__global__ void __launch_bounds__(GV_THREADS)
int8_gemv_kernel(const XT* __restrict__ x, const int8_t* __restrict__ qw,
                 const float* __restrict__ qscale, XT* __restrict__ out,
                 float* __restrict__ ws, int N, int K, int rows_per_split) {
  __shared__ float red[GV_ROWS][GV_COLS];
  const int tid = threadIdx.x;
  const int cg = tid % (GV_COLS / 16), r = tid / (GV_COLS / 16);
  const int n = blockIdx.x * GV_COLS + cg * 16;
  const bool ok = n < N;  // N % 16 == 0: all 16 columns in or out
  const int k_begin = blockIdx.y * rows_per_split;
  const int k_end = min(K, k_begin + rows_per_split);

  float acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0.f;

  for (int k = k_begin + r; k < k_end; k += GV_ROWS * GV_UNROLL) {
    uint4 w[GV_UNROLL];
    float xv[GV_UNROLL];
#pragma unroll
    for (int u = 0; u < GV_UNROLL; ++u) {
      const int kk = k + u * GV_ROWS;
      w[u] = make_uint4(0, 0, 0, 0);
      xv[u] = 0.f;
      if (ok && kk < k_end) {
        w[u] = __ldg(reinterpret_cast<const uint4*>(qw + (size_t)kk * N + n));
        xv[u] = to_f32(x[kk]);
      }
    }
#pragma unroll
    for (int u = 0; u < GV_UNROLL; ++u) {
      fma_s8x4(acc + 0, w[u].x, xv[u]);
      fma_s8x4(acc + 4, w[u].y, xv[u]);
      fma_s8x4(acc + 8, w[u].z, xv[u]);
      fma_s8x4(acc + 12, w[u].w, xv[u]);
    }
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) red[r][cg * 16 + j] = acc[j];
  __syncthreads();
  if (tid < GV_COLS) {
    const int col = blockIdx.x * GV_COLS + tid;
    if (col < N) {
      float s = 0.f;
#pragma unroll 8
      for (int i = 0; i < GV_ROWS; ++i) s += red[i][tid];
      if (ws != nullptr)
        ws[(size_t)blockIdx.y * N + col] = s;
      else
        out[col] = from_f32<XT>(s * qscale[col]);
    }
  }
}

// ---- M > 1 -----------------------------------------------------------------

constexpr int SMEM_AB = (BM * LDA + BK * LDB) * 2;
constexpr int SMEM = SMEM_AB > SMEM_C ? SMEM_AB : SMEM_C;  // 33792 bytes, static
constexpr int A_VECS = BM * BK / 8 / THREADS;   // 16-byte x vectors per thread: 2
constexpr int B_VECS = BK * BN / 16 / THREADS;  // 16-byte weight vectors per thread: 2

// one k-step's operands in registers
struct Stage {
  uint4 a[A_VECS];
  uint4 b[B_VECS];
};

// rows [k0, k0 + BK) of the block's tiles; rows at or past k_end, x rows at
// or past M and columns at or past N read as zero (K % 8 == 0 and
// N % 16 == 0: a vector is wholly in or out)
__device__ __forceinline__ void load_stage(Stage& st, const __nv_bfloat16* __restrict__ x,
                                           const int8_t* __restrict__ qw, int M, int N, int K,
                                           int m0, int n0, int k0, int k_end, int tid) {
#pragma unroll
  for (int i = 0; i < A_VECS; ++i) {
    const int v = tid + THREADS * i;
    const int m = v / (BK / 8), kc = (v % (BK / 8)) * 8;
    st.a[i] = make_uint4(0, 0, 0, 0);
    if (m0 + m < M && k0 + kc < k_end)
      st.a[i] = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(m0 + m) * K + k0 + kc));
  }
#pragma unroll
  for (int i = 0; i < B_VECS; ++i) {
    const int v = tid + THREADS * i;
    const int row = v / (BN / 16), n = n0 + (v % (BN / 16)) * 16;
    st.b[i] = make_uint4(0, 0, 0, 0);
    if (k0 + row < k_end && n < N)
      st.b[i] = __ldg(reinterpret_cast<const uint4*>(qw + (size_t)(k0 + row) * N + n));
  }
}

// the four int8 of w as two bf16 pairs (exact)
__device__ __forceinline__ uint2 s8x4_to_bf16x4(uint32_t w) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn((float)(int8_t)(w & 0xFFu), (float)(int8_t)((w >> 8) & 0xFFu));
  const __nv_bfloat162 hi = __floats2bfloat162_rn((float)(int8_t)((w >> 16) & 0xFFu), (float)(int8_t)(w >> 24));
  return make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
}

__device__ __forceinline__ void store_stage(const Stage& st, __nv_bfloat16* As, __nv_bfloat16* Bs, int tid) {
#pragma unroll
  for (int i = 0; i < A_VECS; ++i) {
    const int v = tid + THREADS * i;
    const int m = v / (BK / 8), kc = (v % (BK / 8)) * 8;
    *reinterpret_cast<uint4*>(As + m * LDA + kc) = st.a[i];
  }
#pragma unroll
  for (int i = 0; i < B_VECS; ++i) {
    const int v = tid + THREADS * i;
    const int row = v / (BN / 16), c = (v % (BN / 16)) * 16;
    const uint2 p0 = s8x4_to_bf16x4(st.b[i].x), p1 = s8x4_to_bf16x4(st.b[i].y);
    const uint2 p2 = s8x4_to_bf16x4(st.b[i].z), p3 = s8x4_to_bf16x4(st.b[i].w);
    *reinterpret_cast<uint4*>(Bs + row * LDB + c) = make_uint4(p0.x, p0.y, p1.x, p1.y);
    *reinterpret_cast<uint4*>(Bs + row * LDB + c + 8) = make_uint4(p2.x, p2.y, p3.x, p3.y);
  }
}

// blockIdx.z takes rows [z * rows_per_split, (z + 1) * rows_per_split) of K
// (whole k-steps). With ws the raw f32 tile goes to ws[z], else the scaled
// bf16 result to out.
__global__ void __launch_bounds__(THREADS, 2)
int8_gemm_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ qw,
                 const float* __restrict__ qscale, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ ws, int M, int N, int K, int rows_per_split) {
  __shared__ __align__(128) unsigned char smem[SMEM];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [BM][LDA]
  __nv_bfloat16* Bs = As + BM * LDA;                             // [BK][LDB]
  float* Cs = reinterpret_cast<float*>(smem);                    // [BM][LDC]

  const int tid = threadIdx.x, warp = tid / 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int k_begin = blockIdx.z * rows_per_split;
  const int k_end = min(K, k_begin + rows_per_split);

  Acc acc;
  zero(acc);

  Stage st;
  load_stage(st, x, qw, M, N, K, m0, n0, k_begin, k_end, tid);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous step's products are done with the tiles
    store_stage(st, As, Bs, tid);
    __syncthreads();
    if (k0 + BK < k_end) load_stage(st, x, qw, M, N, K, m0, n0, k0 + BK, k_end, tid);
    mma_slab(acc, As, Bs, warp);
  }
  store_tile(acc, Cs, qscale, out, ws == nullptr ? nullptr : ws + (size_t)blockIdx.z * M * N, M, N, m0, n0, tid);
}

}  // namespace

// x (M, K), qw (K, N) int8, qscale (N) f32 -> out (M, N); x and out bf16
// (cbf16 = 1) or f32. splits > 1 splits K over the grid (at most `splits`
// parts) and needs ws (splits, M, N) f32. Requires K % 8 == 0, N % 16 == 0 and 16-byte aligned operands
// (checked by the Python wrapper).
LLT_EXPORT int k6_matmul_int8(const void* x, const void* qw, const void* qscale, void* out, void* ws,
                              int M, int N, int K, int splits, int cbf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!cbf16 && M > 1)
    return gemm_f32::launch((const float*)x, gemm_f32::Int8W{(const int8_t*)qw, N}, (const float*)qscale,
                            (float*)out, (float*)ws, M, N, K, splits, st);
  const __nv_bfloat16* xp = (const __nv_bfloat16*)x;
  const int8_t* wp = (const int8_t*)qw;
  const float* sp = (const float*)qscale;
  __nv_bfloat16* op = (__nv_bfloat16*)out;
  if (splits < 1) splits = 1;
  // whole steps per split; the last split may be shorter, none is empty
  const int step = M == 1 ? GV_ROWS : BK;
  const int steps = (K + step - 1) / step;
  const int per = (steps + splits - 1) / splits;
  splits = (steps + per - 1) / per;
  float* wsp = splits > 1 ? (float*)ws : nullptr;
  if (M == 1 && !cbf16) {
    int8_gemv_kernel<float><<<dim3((N + GV_COLS - 1) / GV_COLS, splits), GV_THREADS, 0, st>>>(
        (const float*)x, wp, sp, (float*)out, wsp, N, K, per * step);
    if (splits > 1) launch_splitk_reduce(wsp, sp, (float*)out, (size_t)N, N, splits, st);
    return (int)cudaGetLastError();
  }
  if (M == 1) {
    int8_gemv_kernel<__nv_bfloat16><<<dim3((N + GV_COLS - 1) / GV_COLS, splits), GV_THREADS, 0, st>>>(
        xp, wp, sp, op, wsp, N, K, per * step);
  } else {
    // M-tiles fastest: the blocks sharing a weight slab run together, so it
    // comes from DRAM once
    int8_gemm_kernel<<<dim3((M + BM - 1) / BM, (N + BN - 1) / BN, splits), THREADS, 0, st>>>(
        xp, wp, sp, op, wsp, M, N, K, per * step);
  }
  if (splits > 1) launch_splitk_reduce(wsp, sp, op, (size_t)M * N, N, splits, st);
  return (int)cudaGetLastError();
}
