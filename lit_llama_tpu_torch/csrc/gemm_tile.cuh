// The output tile of the weight-only GEMMs (K3 int4 in quant_matmul.cu, K6
// int8 at M > 1 in quant_matmul_int8.cu): what does not depend on how the
// weight is stored.
//
// One block of 256 threads per (64 x 128) output tile, 8 warps in 2 x 4, each
// warp a 32 x 32 WMMA tile (bf16 in, f32 accumulate). A kernel brings a
// 64-row slab of x and of the weight, as bf16, into shared memory its own way
// and calls mma_slab on it; store_tile writes the finished tile, as bf16
// (times a per-column scale where there is one) or, under split-K, as the raw
// f32 partial that splitk_reduce_kernel sums in a fixed order, so the result
// does not depend on the schedule.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace gemm_tile {

using namespace nvcuda;

constexpr int BM = 64, BN = 128, BK = 64, THREADS = 256;
constexpr int LDA = BK + 8, LDB = BN + 8, LDC = BN + 4;  // padded against bank conflicts
constexpr int SMEM_C = BM * LDC * 4;                      // the f32 tile of store_tile

struct Acc {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> f[2][2];
};

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc.f[i][j], 0.0f);
}

// acc += As @ Bs for this warp's 32 x 32 part: As [BM][LDA] holds BK columns
// of x, Bs [BK][LDB] the matching rows of the weight
__device__ __forceinline__ void mma_slab(Acc& acc, const __nv_bfloat16* As, const __nv_bfloat16* Bs, int warp) {
  const int wm = warp / 4, wn = warp % 4;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], Bs + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::mma_sync(acc.f[i][j], a[i], b[j], acc.f[i][j]);
  }
}

// The block's tile at (m0, n0) of the (M, N) result, through Cs [BM][LDC]
// (it may lie over the operand slabs: the block is synchronized first).
// With ws_z (this split's (M, N) f32 partial) the raw sums go there; else
// bf16 to out, times qscale[n] where qscale is given. N is even.
__device__ __forceinline__ void store_tile(Acc& acc, float* Cs, const float* __restrict__ qscale,
                                           __nv_bfloat16* __restrict__ out, float* __restrict__ ws_z,
                                           int M, int N, int m0, int n0, int tid) {
  const int warp = tid / 32, wm = warp / 4, wn = warp % 4;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, acc.f[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN / 2; e += THREADS) {  // two columns per store
    const int m = e / (BN / 2), n = (e % (BN / 2)) * 2;
    if (m0 + m >= M || n0 + n >= N) continue;
    const size_t o = (size_t)(m0 + m) * N + n0 + n;
    float c0 = Cs[m * LDC + n], c1 = Cs[m * LDC + n + 1];
    if (ws_z != nullptr) {
      *reinterpret_cast<float2*>(ws_z + o) = make_float2(c0, c1);
      continue;
    }
    if (qscale != nullptr) {
      const float2 s = *reinterpret_cast<const float2*>(qscale + n0 + n);
      c0 *= s.x, c1 *= s.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(c0, c1);
  }
}

// out[i] = OT(sum over z of ws[z, i]), times qscale[i % N] where qscale is
// given; i runs over the M * N results; OT the compute dtype, bf16 or f32
template <typename OT>
__global__ void splitk_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ qscale,
                                     OT* __restrict__ out, size_t MN, int N, int splits) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < MN; i += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int z = 0; z < splits; ++z) v += ws[z * MN + i];
    out[i] = from_f32<OT>(qscale != nullptr ? v * qscale[i % N] : v);
  }
}

template <typename OT>
inline void launch_splitk_reduce(const float* ws, const float* qscale, OT* out, size_t MN, int N,
                                 int splits, cudaStream_t st) {
  const size_t blocks = (MN + 255) / 256;
  splitk_reduce_kernel<OT><<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(ws, qscale, out, MN, N,
                                                                                       splits);
}

}  // namespace gemm_tile
