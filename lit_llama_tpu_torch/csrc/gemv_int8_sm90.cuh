// K6 at M == 1: one token times an int8 weight, out = OT((x @ qw) * qscale),
// the single-token matvec of every int8 linear in the per-op decode step
// (4 a block and the lm_head: 129 launches a 7B token). bf16 or f32 compute,
// one body.
//
// Replaces lit_llama_tpu/ops/quant_matmul_pallas.py _int8_kernel (entry
// matmul_int8) at M == 1. Layout (ops/linear.py): qw (K, N) int8, a row
// contiguous along N; qscale (N) f32.
//
// Bound on the H100: bytes. The K * N weight bytes are all there is (16.8 MB
// at attn.c_proj, 5.0 us at 3.35 TB/s; 131 MB, 39.2 us, at the lm_head),
// against 2 * K * N operations on the CUDA cores.
//
// What the first body (int8_gemv_kernel) spent beyond the bytes:
// two kernels a call (the K-split partials in a fresh (splits, N) workspace,
// summed by a second kernel: 0.30 ms of a 7B token's 2.96 ms of K6 in the
// per-op step), blocks of two steps each ("four 16-byte loads, wait, sixteen
// FMAs"), and a launch that waited for the kernel before it to end.
//
// Design.
//  - One wave of equal items: the weight is cut into strips of COLS columns
//    (a row of a strip: COLS contiguous bytes) and K into `splits` ranges of
//    whole steps of ROWS rows (ops/quant_matmul.py gemv8_plan: as many as
//    BLOCKS_PER_SM blocks an SM hold, from N, K and the SM count alone); block
//    b takes strip b % strips of split b / strips, so the blocks of a split
//    read the same rows side by side.
//  - A cp.async ring of STAGES steps: thread (r, c) copies 16 bytes at
//    columns 16c and 128 + 16c of row r of each step (each copy instruction
//    of a warp reads 128 contiguous bytes of four rows) and x's element of
//    that row (4 bytes: the bf16 pair that holds it, or the f32), and reads
//    back only what it copied, so the ring needs no barrier. STAGES x 8 KB a
//    block and two blocks an SM keep 64 KB requested per SM (3.35 TB/s x ~1.3
//    us of latency / 132 SMs is ~33 KB). Step j is the j-th group of copies,
//    so every step waits for its own bytes only: x of the first steps, which
//    could not join their groups (below), comes by plain loads.
//  - Programmatic dependent launch: the first STAGES steps of the weight and
//    the strip's scales (long-lived parameters) are requested before
//    pdl_wait(); x, written by the kernel before, only after it. Nothing is
//    written before it (out, ws and the counters may be in use by the kernel
//    before).
//  - The K split merged in the kernel: the block sums its 32 row lanes
//    (shuffles over a warp's four rows, then its 8 warps in warp order
//    through shared memory) into the strip's partial of its split; with one
//    split that is the output, else it goes to ws and the last block of the
//    strip to arrive (counter[strip], left at zero) adds the strip's partials
//    in split order, applies the scale and writes out. The split comes from
//    N, K and the SM count alone, so the bits do not depend on which block
//    finishes last, on M or on the stream.
//  - Products on the CUDA cores (FFMA), as the first body: a byte becomes an
//    f32 by a byte permute under the exponent of 2^23 and one exact
//    subtraction, then an FMA with x: 3.25 instructions a weight byte, ~3.7
//    with the copies and the ring, so ~54 a cycle an SM at the ~14.5 bytes a
//    cycle the memory rate delivers, under half the SM's issue rate.
//    mma.sync in bf16 needs more a byte: an int8 value is exact in bf16 but
//    not under one exponent (the nibbles of gemv_sm90.cuh are), so the
//    conversion alone costs what the FFMA does.
//  Measured against it on the card (PERF.md, K6): 16 bytes a thread and
//  step (instruction-bound: 15 % slower in bf16 than in f32, whose x needs
//  no conversion), a persistent wave of equal runs over the strip-major
//  steps, deeper rings or three blocks an SM (each slower), and a TMA ring
//  with a producer warp (its consumers wait on the ring for 55 % of their
//  time; 9 % slower in the per-op step).
#pragma once

#include "common.cuh"

namespace gemv8 {
// Internal linkage: each library that includes this header keeps its own
// kernels and shared-memory flags.
namespace {

constexpr int THREADS = 256;
constexpr int COLS = 256;               // columns a strip: a row's contiguous bytes
constexpr int LANES = COLS / 32;        // threads a row, 32 bytes (two 16-byte pieces) each
constexpr int ROWS = THREADS / LANES;   // rows a step: 32
constexpr int STAGES = 4;               // steps in the ring
constexpr int WARPS = THREADS / 32;
constexpr int BLOCKS_PER_SM = 2;
constexpr int SMEM = STAGES * THREADS * 32 + STAGES * THREADS * 4 + WARPS * COLS * 4;
static_assert(LANES == 8, "a warp holds four rows of a step: the shuffles below add lanes l, l ^ 8, l ^ 16, l ^ 24");

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

__device__ __forceinline__ void fma_s8x16(float* acc, uint4 w, float xv) {
  fma_s8x4(acc + 0, w.x, xv);
  fma_s8x4(acc + 4, w.y, xv);
  fma_s8x4(acc + 8, w.z, xv);
  fma_s8x4(acc + 12, w.w, xv);
}

// x (K) in XT (bf16 or f32), qw (K, N) int8, qscale (N) f32 -> out (N) XT.
// The grid is strips x splits blocks; with splits > 1, ws holds a COLS-float
// partial a block and counter one int32 zero a strip, left at zero.
template <typename XT>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
gemv8_kernel(const XT* __restrict__ x, const int8_t* __restrict__ qw, const float* __restrict__ qscale,
             XT* __restrict__ out, float* __restrict__ ws, int* __restrict__ counter, int N, int K, int splits) {
  extern __shared__ __align__(16) uint4 dsm[];
  uint4* ring = dsm;                                                           // [STAGES][2][THREADS]
  uint32_t* xring = reinterpret_cast<uint32_t*>(ring + STAGES * 2 * THREADS);  // [STAGES][THREADS]
  float* red = reinterpret_cast<float*>(xring + STAGES * THREADS);            // [WARPS][COLS]
  __shared__ int last_block;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, r = tid / LANES;
  const int strips = gridDim.x / splits, strip = blockIdx.x % strips, split = blockIdx.x / strips;
  const int steps = (K + ROWS - 1) / ROWS;
  const int k0 = (int)((long long)split * steps / splits), n = (int)((long long)(split + 1) * steps / splits) - k0;
  const int col = strip * COLS + tid, wcol = strip * COLS + (tid % LANES) * 16;
  // N % 16 == 0: each 16-byte piece is all in or all out
  const bool ok0 = wcol < N, ok1 = wcol + COLS / 2 < N;
  // x's element of a row: the f32, or the bf16 of the pair (row & ~1, row | 1)
  // that the row's parity picks, moved to the high half by a byte permute
  const unsigned xsel = (r & 1) ? 0x3244u : 0x1044u;
  auto x_f32 = [&](uint32_t xw) { return __uint_as_float(sizeof(XT) == 2 ? __byte_perm(xw, 0u, xsel) : xw); };
  auto x_word = [&](int xrow) {  // the 4 bytes of x that hold the row's element
    return reinterpret_cast<const uint32_t*>(x) + (sizeof(XT) == 2 ? xrow / 2 : xrow);
  };

  // the row of this thread in the step being copied, and its 32 bytes
  int row = k0 * ROWS + r;
  const int8_t* wp = qw + (size_t)row * N + (ok0 ? wcol : 0);
  auto copy_w = [&](int stage) {
    const bool in = row < K;
    uint4* dst = ring + stage * 2 * THREADS + tid;
    cp_async16(dst, in && ok0 ? wp : qw, in && ok0 ? 16 : 0);
    cp_async16(dst + THREADS, in && ok1 ? wp + COLS / 2 : qw, in && ok1 ? 16 : 0);
  };
  // what depends on nothing: the first steps' weights and the strip's scales
#pragma unroll 1
  for (int j = 0; j < STAGES; ++j) {
    if (j < n) {
      copy_w(j);
      row += ROWS;
      wp += (size_t)ROWS * N;
    }
    cp_async_commit();
  }
  const float scale = col < N ? __ldg(qscale + col) : 0.f;
  pdl_wait();
  pdl_trigger();
  // x's rows of the first steps, by plain loads (the steps' groups were
  // committed before x could be read; each later step's x comes in its group)
  for (int j = 0; j < STAGES && j < n; ++j) {
    const int xrow = (k0 + j) * ROWS + r;
    xring[j * THREADS + tid] = xrow < K ? *x_word(xrow) : 0u;
  }

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  int stage = 0;
#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    // step j is group j; the groups of the STAGES - 1 steps after it may be in flight
    cp_async_wait<STAGES - 1>();
    const uint4 w0 = ring[stage * 2 * THREADS + tid], w1 = ring[(stage * 2 + 1) * THREADS + tid];
    const float xv = x_f32(xring[stage * THREADS + tid]);
    fma_s8x16(acc, w0, xv);
    fma_s8x16(acc + 16, w1, xv);
    if (j + STAGES < n) {  // the stage just read takes step j + STAGES
      const bool in = row < K;
      cp_async4(xring + stage * THREADS + tid, in ? x_word(row) : x_word(0), in ? 4 : 0);
      copy_w(stage);
      row += ROWS;
      wp += (size_t)ROWS * N;
    }
    cp_async_commit();
    stage = stage == STAGES - 1 ? 0 : stage + 1;
  }

  // the block's 32 row lanes in order: a warp's four rows, then the warps
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 8);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 16);
  if (lane < LANES) {
    float4* p = reinterpret_cast<float4*>(red + warp * COLS + lane * 16);
    float4* q = reinterpret_cast<float4*>(red + warp * COLS + COLS / 2 + lane * 16);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
      q[i] = make_float4(acc[16 + 4 * i], acc[16 + 4 * i + 1], acc[16 + 4 * i + 2], acc[16 + 4 * i + 3]);
    }
  }
  __syncthreads();
  float part = red[tid];
#pragma unroll
  for (int w8 = 1; w8 < WARPS; ++w8) part += red[w8 * COLS + tid];
  if (splits == 1) {
    if (col < N) out[col] = from_f32<XT>(part * scale);
  } else {
    ws[(size_t)blockIdx.x * COLS + tid] = part;
    __threadfence();  // the partial is visible before the count that announces it
    __syncthreads();
    if (tid == 0) last_block = atomicAdd(counter + strip, 1) == splits - 1;
    __syncthreads();
    if (last_block) {
      __threadfence();
      float v = __ldcg(ws + (size_t)strip * COLS + tid);
      for (int z = 1; z < splits; ++z) v += __ldcg(ws + ((size_t)z * strips + strip) * COLS + tid);
      // the strip out, and its counter back at zero for the next launch
      if (col < N) out[col] = from_f32<XT>(v * scale);
      if (tid == 0) counter[strip] = 0;
    }
  }
}

template <typename XT>
int launch(const XT* x, const int8_t* qw, const float* qscale, XT* out, float* ws, int* counter, int N, int K,
           int splits, cudaStream_t st) {
  static int ready[16];
  const int err = allow_smem(ready, gemv8_kernel<XT>);
  if (err) return err;
  const dim3 grid((N + COLS - 1) / COLS * splits);
  return launch_pdl(gemv8_kernel<XT>, grid, dim3(THREADS), (size_t)SMEM, st, x, qw, qscale, out, ws, counter, N, K, splits);
}

}  // namespace
}  // namespace gemv8
