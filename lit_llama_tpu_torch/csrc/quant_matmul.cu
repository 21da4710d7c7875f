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
// (K*N/2 bytes, plus 8 bytes of scale/zero per group and column) dominates
// the bytes; the tensor-core work is 2*M*K*N. At M = 128 on c_fc12 the two
// bounds are within 2x of each other.
//
// Design: the 64 x 128 output tile of gemm_tile.cuh, shared with K6 (bf16
// WMMA, f32 accumulate, split-K with a fixed-order reduce). Each k-step reads one 64-row
// slab of packed bytes ONCE and dequantizes both nibble planes into shared
// memory as bf16, against the matching two 64-column slabs of x, so the
// half-split layout costs no second pass over the weight. Where a k-step
// stays inside one group in both planes (gs % 64 == 0) its scales and zeros
// are loaded once with the step; otherwise (gs = 32, 16, ..., any gs that the
// JAX package's shape gate admits) each row loads its own group's (ROW
// below). The next k-step's x, packed bytes, scales
// and zeros are loaded into registers while the tensor cores work on the
// current one, so the global latency overlaps the products. Simple first: no
// cp.async/TMA ring, no wgmma; those are later work.
//
// f32 compute (the Pallas entry's compute dtype f32): the FFMA tile of
// gemm_f32.cuh on the dequantized f32 weight, k3_matmul_int4_f32 below.

#include "gemm_f32.cuh"
#include "gemm_tile.cuh"

using namespace gemm_tile;

namespace {

constexpr int SMEM_AB = 2 * BM * LDA * 2 + 2 * BK * LDB * 2;  // both nibble planes
constexpr int SMEM = SMEM_AB > SMEM_C ? SMEM_AB : SMEM_C;
constexpr int A_VECS = 2 * BM * BK / 8 / THREADS;  // 16-byte x vectors per thread: 4
constexpr int B_ROWS = BK * (BN / 8) / THREADS;    // 8-byte weight rows per thread: 4

// one k-step's operands in registers
struct Stage {
  uint4 a[A_VECS];
  uint2 b[B_ROWS];
  float s_lo[8], z_lo[8], s_hi[8], z_hi[8];
};

// the scales and zeros of 8 columns from n in group g
__device__ __forceinline__ void load_sz8(const float* __restrict__ qscale, const float* __restrict__ qzero,
                                         int g, int N, int n, bool ok, float* s, float* z) {
#pragma unroll
  for (int j = 0; j < 8; j += 4) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (ok) {
      a = __ldg(reinterpret_cast<const float4*>(qscale + (size_t)g * N + n + j));
      b = __ldg(reinterpret_cast<const float4*>(qzero + (size_t)g * N + n + j));
    }
    s[j] = a.x, s[j + 1] = a.y, s[j + 2] = a.z, s[j + 3] = a.w;
    z[j] = b.x, z[j + 1] = b.y, z[j + 2] = b.z, z[j + 3] = b.w;
  }
}

// ROW: the step's rows need not share a group; store_stage loads each row's
template <bool ROW>
__device__ __forceinline__ void load_stage(Stage& st, const __nv_bfloat16* __restrict__ x,
                                           const uint8_t* __restrict__ qw,
                                           const float* __restrict__ qscale,
                                           const float* __restrict__ qzero, int M, int N, int K,
                                           int gs, int m0, int n0, int r0, int tid) {
  const int Kh = K / 2;
#pragma unroll
  for (int i = 0; i < A_VECS; ++i) {
    const int v = tid + THREADS * i;  // 0..1023
    const int p = v / 512, rem = v % 512;
    const int m = rem / 8, kc = (rem % 8) * 8;
    st.a[i] = make_uint4(0, 0, 0, 0);
    if (m0 + m < M)
      st.a[i] = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(m0 + m) * K + p * Kh + r0 + kc));
  }
  const int cg = tid % (BN / 8), row0 = tid / (BN / 8);  // 8 columns, rows row0 + 16 i
  const int n = n0 + cg * 8;
  const bool ok = n < N;  // N % 8 == 0: all 8 columns in or out
#pragma unroll
  for (int i = 0; i < B_ROWS; ++i) {
    st.b[i] = make_uint2(0, 0);
    if (ok) st.b[i] = __ldg(reinterpret_cast<const uint2*>(qw + (size_t)(r0 + row0 + 16 * i) * N + n));
  }
  if (ROW) return;
  load_sz8(qscale, qzero, r0 / gs, N, n, ok, st.s_lo, st.z_lo);
  load_sz8(qscale, qzero, (r0 + Kh) / gs, N, n, ok, st.s_hi, st.z_hi);
}

__device__ __forceinline__ __nv_bfloat16 dq(uint32_t q, float s, float z) {
  return __float2bfloat16_rn(__fadd_rn(__fmul_rn((float)q, s), z));
}

template <bool ROW>
__device__ __forceinline__ void store_stage(Stage& st, __nv_bfloat16* As, __nv_bfloat16* Bs,
                                            const float* __restrict__ qscale,
                                            const float* __restrict__ qzero, int N, int K, int gs,
                                            int n0, int r0, int tid) {
#pragma unroll
  for (int i = 0; i < A_VECS; ++i) {
    const int v = tid + THREADS * i;
    const int p = v / 512, rem = v % 512;
    const int m = rem / 8, kc = (rem % 8) * 8;
    *reinterpret_cast<uint4*>(As + (p * BM + m) * LDA + kc) = st.a[i];
  }
  const int cg = tid % (BN / 8), row0 = tid / (BN / 8);
#pragma unroll
  for (int i = 0; i < B_ROWS; ++i) {
    const int row = row0 + 16 * i;
    if (ROW) {
      const int n = n0 + cg * 8;
      load_sz8(qscale, qzero, (r0 + row) / gs, N, n, n < N, st.s_lo, st.z_lo);
      load_sz8(qscale, qzero, (r0 + row + K / 2) / gs, N, n, n < N, st.s_hi, st.z_hi);
    }
    uint32_t lo[4], hi[4];  // bf16 pairs of columns (2j, 2j + 1)
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const uint32_t w = j < 4 ? st.b[i].x : st.b[i].y;
      const uint32_t b0 = (w >> (8 * (j % 4))) & 0xFFu, b1 = (w >> (8 * (j % 4) + 8)) & 0xFFu;
      __nv_bfloat162 l = __halves2bfloat162(dq(b0 & 0xFu, st.s_lo[j], st.z_lo[j]),
                                            dq(b1 & 0xFu, st.s_lo[j + 1], st.z_lo[j + 1]));
      __nv_bfloat162 h = __halves2bfloat162(dq(b0 >> 4, st.s_hi[j], st.z_hi[j]),
                                            dq(b1 >> 4, st.s_hi[j + 1], st.z_hi[j + 1]));
      lo[j / 2] = *reinterpret_cast<uint32_t*>(&l);
      hi[j / 2] = *reinterpret_cast<uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(Bs + row * LDB + cg * 8) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    *reinterpret_cast<uint4*>(Bs + (BK + row) * LDB + cg * 8) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  }
}

// blockIdx.z takes packed rows [z * rows_per_split, (z + 1) * rows_per_split);
// with one split the bf16 result goes to out, else the f32 partial to ws[z].
template <bool ROW>
__global__ void __launch_bounds__(THREADS, 2)
int4_gemm_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ qw,
                 const float* __restrict__ qscale, const float* __restrict__ qzero,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ ws, int M, int N, int K,
                 int gs, int rows_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][BM][LDA]
  __nv_bfloat16* Bs = As + 2 * BM * LDA;                         // [2][BK][LDB]
  float* Cs = reinterpret_cast<float*>(smem);                    // [BM][LDC]

  const int tid = threadIdx.x, warp = tid / 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int Kh = K / 2;
  const int r_begin = blockIdx.z * rows_per_split;
  const int r_end = min(Kh, r_begin + rows_per_split);

  Acc acc;
  zero(acc);

  Stage st;
  load_stage<ROW>(st, x, qw, qscale, qzero, M, N, K, gs, m0, n0, r_begin, tid);
  for (int r0 = r_begin; r0 < r_end; r0 += BK) {
    __syncthreads();  // the previous step's products are done with the tiles
    store_stage<ROW>(st, As, Bs, qscale, qzero, N, K, gs, n0, r0, tid);
    __syncthreads();
    if (r0 + BK < r_end) load_stage<ROW>(st, x, qw, qscale, qzero, M, N, K, gs, m0, n0, r0 + BK, tid);
#pragma unroll
    for (int p = 0; p < 2; ++p) mma_slab(acc, As + p * BM * LDA, Bs + p * BK * LDB, warp);
  }
  store_tile(acc, Cs, nullptr, out, ws == nullptr ? nullptr : ws + (size_t)blockIdx.z * M * N, M, N, m0, n0, tid);
}

}  // namespace

// x (M, K) bf16, qw (K/2, N) u8, qscale/qzero (K/gs, N) f32 -> out (M, N) bf16.
// splits > 1 splits K over blockIdx.z (at most `splits` parts of whole
// 64-row k-steps) and needs ws (splits, M, N) f32.
// Requires K % 128 == 0, K % gs == 0, N % 8 == 0, 16-byte aligned rows
// (checked by the Python wrapper).
LLT_EXPORT int k3_matmul_int4(const void* x, const void* qw, const void* qscale, const void* qzero,
                              void* out, void* ws, int M, int N, int K, int gs, int splits,
                              void* stream) {
  // one group for the whole 64-row step of both planes
  const bool row = gs % BK != 0 || (K / 2) % BK != 0;
  auto kernel = row ? int4_gemm_kernel<true> : int4_gemm_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  // whole k-steps per split; the last split may be shorter, none is empty
  const int steps = K / 2 / BK;
  const int per = (steps + splits - 1) / splits;
  splits = (steps + per - 1) / per;
  // M-tiles fastest: the blocks sharing a weight slab run together, so it
  // comes from DRAM once
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, splits);
  kernel<<<grid, THREADS, SMEM, st>>>(
      (const __nv_bfloat16*)x, (const uint8_t*)qw, (const float*)qscale, (const float*)qzero,
      (__nv_bfloat16*)out, splits > 1 ? (float*)ws : nullptr, M, N, K, gs, per * BK);
  if (splits > 1)
    launch_splitk_reduce((const float*)ws, nullptr, (__nv_bfloat16*)out, (size_t)M * N, N, splits, st);
  return (int)cudaGetLastError();
}

// f32 compute: out (M, N) f32 = x (M, K) f32 @ (q * scale + zero), the
// FFMA tile of gemm_f32.cuh, K in up to `splits` parts (ws (splits, M, N)
// f32). K % gs == 0, K even.
LLT_EXPORT int k3_matmul_int4_f32(const void* x, const void* qw, const void* qscale, const void* qzero,
                                  void* out, void* ws, int M, int N, int K, int gs, int splits, void* stream) {
  return gemm_f32::launch((const float*)x,
                          gemm_f32::Int4W{(const uint8_t*)qw, (const float*)qscale, (const float*)qzero, K, N, gs},
                          nullptr, (float*)out, (float*)ws, M, N, K, splits, (cudaStream_t)stream);
}
