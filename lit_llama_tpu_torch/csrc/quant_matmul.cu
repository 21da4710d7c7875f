// K3: int4 weight-only GEMM for M > 1 (prefill), out = x @ dequant(qw).
//
// Replaces lit_llama_tpu/ops/quant_matmul_pallas.py _int4_kernel (and its
// _int4_kernel_fused_scale variant), entry matmul_int4.
//
// Layout (ops/linear.py): qw (K/2, N) bytes, packed row r holds logical row r
// in its low nibble and row r + K/2 in its high nibble; qscale/qzero (G, N)
// f32 with G = K/gs, low plane groups [0, G/2), high plane [G/2, G).
// w = bf16(q * scale + zero), the rounding of matmul_int4_ref. Logical row k
// belongs to group k / gs.
//
// Bound on the H100: at prefill M (8..512) the packed weight stream
// (K*N/2 bytes, plus 8 bytes of scale/zero per group and column) up to
// about M = 150; the tensor-core work, 2*M*K*N, past it.
//
// Design: the Hopper mainloop of gemm_sm90.cuh, shared with K6 at M > 1:
// the product transposed so the tokens are wgmma's n, the packed bytes, their
// scales and zeros brought by cp.async and x by TMA into a ring of stages by
// one producer warp, and the consumer warpgroup dequantizing one stage
// (both nibble planes of 32 packed rows, each with its own group's scale and
// zero, any group size) while the tensor cores multiply the one before.
//
// f32 compute (the Pallas entry's compute dtype f32): the FFMA tile of
// gemm_f32.cuh (128 x 128 blocks, 8 x 8 sums a thread, x by cp.async into a
// ring, the weight dequantized once a block and k-step), k3_matmul_int4_f32
// below.

#include "gemm_f32.cuh"
#include "gemm_sm90.cuh"

// x (M, K) bf16, qw (K/2, N) u8, qscale/qzero (K/gs, N) f32 -> out (M, N)
// bf16, through the plan of ops/quant_matmul.py gemm_plan: nt tokens a token
// tile, `stages` ring stages, gr scale rows a plane of a stage spans,
// K in `splits` parts of `per` 64-row k-steps (ws (splits, M, N) f32 where
// splits > 1). Requires K % 128 == 0, K % gs == 0, N % 8 == 0, 16-byte
// aligned x (checked by the Python wrapper).
LLT_EXPORT int k3_matmul_int4(const void* x, const void* qw, const void* qscale, const void* qzero,
                              void* out, void* ws, int M, int N, int K, int gs, int nt, int stages, int gr,
                              int splits, int per, void* stream) {
  sm90::Params p{(const uint8_t*)qw, (const float*)qscale, (const float*)qzero, (__nv_bfloat16*)out,
                 splits > 1 ? (float*)ws : nullptr, M, N, K, gs, K / gs, gr, K / 64, per, stages};
  return sm90::launch<true>(x, p, nt, splits, (cudaStream_t)stream);
}

// f32 compute: out (M, N) f32 = x (M, K) f32 @ (q * scale + zero), the
// FFMA tile of gemm_f32.cuh, K in up to `splits` parts added in order into
// out behind counter (ops/quant_matmul.py f32_plan: its row tiles x column
// tiles int32 zeros, left at zero). K % gs == 0, K even, N % 4 == 0.
LLT_EXPORT int k3_matmul_int4_f32(const void* x, const void* qw, const void* qscale, const void* qzero,
                                  void* out, void* counter, int M, int N, int K, int gs, int splits, void* stream) {
  return gemm_f32::launch((const float*)x,
                          gemm_f32::Int4W{(const uint8_t*)qw, (const float*)qscale, (const float*)qzero, K, N, gs},
                          nullptr, (float*)out, (int*)counter, M, N, K, splits, (cudaStream_t)stream);
}
