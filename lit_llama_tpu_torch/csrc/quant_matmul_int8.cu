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
// Design: two bodies chosen by M, each behind its own entry.
//  M == 1, a weight stream: a block of 256 threads owns a strip of 128
//   columns and a range of rows; eight threads read one row's 128 bytes as
//   16-byte vectors, 32 rows per step and four steps in flight per thread;
//   each thread keeps 16 f32 sums, the block adds its 32 row lanes through
//   shared memory. A byte becomes an f32 by a byte permute under the exponent
//   of 2^23 and one exact subtraction (no conversion instruction). K is split
//   over blockIdx.y so that every SM has work at N = 4096; the f32 partials
//   are summed in a fixed order by splitk_reduce_kernel, so the result does
//   not depend on the schedule.
//  M > 1, a tensor-core product: the Hopper mainloop of gemm_sm90.cuh,
//   shared with K3 (tokens as wgmma's n, x by TMA and the int8 bytes by
//   cp.async into a ring of stages, converted exactly to bf16 by the
//   consumer warpgroup beside the wgmmas of the stage before, the column
//   scale on the f32 sum in the epilogue). Rows past K and columns past N are
//   zero-filled or skipped, so K need not be a multiple of the k-step nor N
//   of the tile. K is split by N and K alone (gemm_plan), so a row's output
//   does not depend on M.
//
// f32 compute (the Pallas entry's compute dtype f32): at M == 1 the same
// weight stream with an f32 x and an f32 result (XT below); at M > 1 the FFMA
// tile of gemm_f32.cuh (shared with K3 in f32) on the exact f32 weight, the
// scale applied to the f32 sum at the end. Bound at M > 1: operations on the
// CUDA cores, 67 TF/s.

#include "gemm_f32.cuh"
#include "gemm_sm90.cuh"

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

}  // namespace

// M == 1 (bf16 or f32): x (1, K), qw (K, N) int8, qscale (N) f32 -> out
// (1, N); x and out bf16 (cbf16 = 1) or f32. splits > 1 splits K over the
// grid (at most `splits` parts) and needs ws (splits, 1, N) f32. Requires K %
// 8 == 0, N % 16 == 0 and 16-byte aligned operands (checked by the Python
// wrapper).
LLT_EXPORT int k6_matmul_int8(const void* x, const void* qw, const void* qscale, void* out, void* ws,
                              int M, int N, int K, int splits, int cbf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M != 1) return (int)cudaErrorInvalidValue;  // k6_matmul_int8_sm90 or k6_matmul_int8_f32
  if (splits < 1) splits = 1;
  // whole steps per split; the last split may be shorter, none is empty
  const int steps = (K + GV_ROWS - 1) / GV_ROWS;
  const int per = (steps + splits - 1) / splits;
  splits = (steps + per - 1) / per;
  float* wsp = splits > 1 ? (float*)ws : nullptr;
  const dim3 grid((N + GV_COLS - 1) / GV_COLS, splits);
  if (cbf16) {
    int8_gemv_kernel<__nv_bfloat16><<<grid, GV_THREADS, 0, st>>>(
        (const __nv_bfloat16*)x, (const int8_t*)qw, (const float*)qscale, (__nv_bfloat16*)out, wsp, N, K,
        per * GV_ROWS);
    if (splits > 1) splitk::launch_splitk_reduce(wsp, (const float*)qscale, (__nv_bfloat16*)out, (size_t)N, N, splits, st);
  } else {
    int8_gemv_kernel<float><<<grid, GV_THREADS, 0, st>>>((const float*)x, (const int8_t*)qw, (const float*)qscale,
                                                          (float*)out, wsp, N, K, per * GV_ROWS);
    if (splits > 1) splitk::launch_splitk_reduce(wsp, (const float*)qscale, (float*)out, (size_t)N, N, splits, st);
  }
  return (int)cudaGetLastError();
}

// M > 1 in bf16: x (M, K) bf16 @ qw (K, N) int8, times qscale (N) -> out
// (M, N) bf16, through the plan of ops/quant_matmul.py gemm_plan (nt
// tokens a token tile, `stages` ring stages, K in `splits` parts of
// `per` 64-row k-steps, ws (splits, M, N) f32 where splits > 1).
LLT_EXPORT int k6_matmul_int8_sm90(const void* x, const void* qw, const void* qscale, void* out, void* ws,
                                   int M, int N, int K, int nt, int stages, int splits, int per, void* stream) {
  sm90::Params p{(const uint8_t*)qw, (const float*)qscale, nullptr, (__nv_bfloat16*)out,
                 splits > 1 ? (float*)ws : nullptr, M, N, K, 1, 1, 0, (K + 63) / 64, per, stages};
  return sm90::launch<false>(x, p, nt, splits, (cudaStream_t)stream);
}

// M > 1 in f32: x (M, K) f32 @ qw (K, N) int8, times qscale (N) -> out (M, N)
// f32, the FFMA tile of gemm_f32.cuh with K in up to `splits` parts added in
// order into out behind counter (ops/quant_matmul.py f32_plan: its row tiles
// x column tiles int32 zeros, left at zero).
LLT_EXPORT int k6_matmul_int8_f32(const void* x, const void* qw, const void* qscale, void* out, void* counter,
                                  int M, int N, int K, int splits, void* stream) {
  return gemm_f32::launch((const float*)x, gemm_f32::Int8W{(const int8_t*)qw, N}, (const float*)qscale,
                          (float*)out, (int*)counter, M, N, K, splits, (cudaStream_t)stream);
}
