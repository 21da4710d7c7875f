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
//  M == 1, a weight stream: gemv_int8_sm90.cuh (one wave of equal (strip,
//   K split) items, each streamed through a cp.async ring, the splits merged
//   in the kernel in split order, launched under programmatic dependent
//   launch). Its note has the bound and the design.
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
// weight stream with an f32 x and an f32 result; at M > 1 the FFMA
// tile of gemm_f32.cuh (shared with K3 in f32) on the exact f32 weight, the
// scale applied to the f32 sum at the end. Bound at M > 1: operations on the
// CUDA cores, 67 TF/s.

#include "gemm_f32.cuh"
#include "gemm_sm90.cuh"
#include "gemv_int8_sm90.cuh"

// M == 1 (bf16 or f32): x (1, K), qw (K, N) int8, qscale (N) f32 -> out
// (1, N); x and out bf16 (cbf16 = 1) or f32. One kernel of (N / 256 rounded
// up) x splits blocks (ops/quant_matmul.py gemv8_plan); with splits > 1, ws
// holds 256 f32 a block and counter one int32 zero a 256-column strip, left
// at zero (both kept across calls, one set a stream). Requires K % 8 == 0,
// N % 16 == 0 and 16-byte aligned operands (checked by the Python wrapper).
LLT_EXPORT int k6_matmul_int8(const void* x, const void* qw, const void* qscale, void* out, void* ws, void* counter,
                              int M, int N, int K, int splits, int cbf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M != 1 || splits < 1) return (int)cudaErrorInvalidValue;  // M > 1: k6_matmul_int8_sm90 or k6_matmul_int8_f32
  if (cbf16)
    return gemv8::launch((const __nv_bfloat16*)x, (const int8_t*)qw, (const float*)qscale, (__nv_bfloat16*)out,
                         (float*)ws, (int*)counter, N, K, splits, st);
  return gemv8::launch((const float*)x, (const int8_t*)qw, (const float*)qscale, (float*)out, (float*)ws,
                       (int*)counter, N, K, splits, st);
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
