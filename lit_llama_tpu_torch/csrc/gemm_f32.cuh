// The f32 weight-only GEMM of the f32 compute dtype, shared by K3 (int4,
// quant_matmul.cu), K6 at M > 1 (int8, quant_matmul_int8.cu) and the f32
// bodies of K7 and K9 (serve_layer.cu): out (M, N) f32 = x (M, K) f32 @ W,
// times a per-column scale where there is one.
//
// Bound on the H100: operations at prefill M, 2 * M * K * N on the CUDA
// cores (FFMA, 67 TF/s); no tensor core takes f32 without TF32, which keeps
// about three decimal digits, and neither JAX's f32 path nor the plain
// versions round that way.
//
// Design, simple and right first: one block of 256 threads per (64 x 128)
// output tile; a k-step stages 16 columns of x and 16 rows of the weight,
// dequantized to f32 by the layout's loader (W below), in shared memory; each
// thread keeps a 4 x 8 register tile of sums (rows ty + 16 i, columns
// tx + 16 j, so a warp's loads are broadcasts and adjacent words). The
// dequantized int4 weight is q * scale + zero rounded as the plain version
// rounds it (f32 product, then f32 sum). K may be split over blockIdx.z (the
// split count comes from N and K alone, so a row's sums do not depend on M);
// the splits' f32 partials are summed in a fixed order by splitk.cuh's
// splitk_reduce_kernel, which applies the column scale. No double buffering.
#pragma once

#include "splitk.cuh"

namespace gemm_f32 {

constexpr int BM = 64, BN = 128, BK = 16, THREADS = 256;
constexpr int TM = BM / 16, TN = BN / 16;  // 4 x 8 sums a thread

// The int4 weight of ops/linear.py: qw (K/2, N) u8, packed row r holds row r
// in its low nibble and row r + K/2 in its high nibble; qscale/qzero (K/gs, N)
// f32. Any gs dividing K.
struct Int4W {
  const uint8_t* qw;
  const float* qs;
  const float* qz;
  int K, N, gs;
  __device__ __forceinline__ float operator()(int k, int n) const {
    const int Kh = K / 2;
    const bool lo = k < Kh;
    const uint32_t b = __ldg(qw + (size_t)(lo ? k : k - Kh) * N + n);
    const size_t g = (size_t)(k / gs) * N + n;
    return __fadd_rn(__fmul_rn((float)(lo ? b & 0xFu : b >> 4), __ldg(qs + g)), __ldg(qz + g));
  }
};

// The int8 weight: qw (K, N) int8, exact in f32; its scale goes to colscale.
struct Int8W {
  const int8_t* qw;
  int N;
  __device__ __forceinline__ float operator()(int k, int n) const {
    return (float)__ldg(qw + (size_t)k * N + n);
  }
};

// The block's (64 x 128) tile at (blockIdx.x, blockIdx.y) of out, over rows
// [z * k_per_split, (z + 1) * k_per_split) of K, z = blockIdx.z. Rows past M,
// columns past N and k past K read as zero and are not written. With ws the
// raw sums go to ws[z] (M, N), else out = sums * colscale.
template <class W>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const float* __restrict__ x, W w, const float* __restrict__ colscale,
            float* __restrict__ out, float* __restrict__ ws, int M, int N, int K, int k_per_split) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int k_begin = blockIdx.z * k_per_split, k_end = min(K, k_begin + k_per_split);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
#pragma unroll
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int m = e / BK, kk = e % BK;
      As[kk][m] = (m0 + m < M && k0 + kk < k_end) ? x[(size_t)(m0 + m) * K + k0 + kk] : 0.f;
    }
#pragma unroll
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int kk = e / BN, n = e % BN;
      Bs[kk][n] = (n0 + n < N && k0 + kk < k_end) ? w(k0 + kk, n0 + n) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      if (ws != nullptr)
        ws[(size_t)blockIdx.z * M * N + (size_t)m * N + n] = acc[i][j];
      else
        out[(size_t)m * N + n] = colscale != nullptr ? acc[i][j] * colscale[n] : acc[i][j];
    }
  }
}

// out = x @ W (times colscale) with K in at most `splits` parts of whole
// k-steps; ws (splits, M, N) f32 when splits > 1 (the Python wrappers size it
// with quant_matmul._f32_splits, which gives `splits`)
template <class W>
inline int launch(const float* x, W w, const float* colscale, float* out, float* ws, int M, int N, int K,
                  int splits, cudaStream_t st) {
  const int steps = (K + BK - 1) / BK;
  if (splits < 1) splits = 1;
  const int per = (steps + splits - 1) / splits;  // whole k-steps a split; none is empty
  splits = (steps + per - 1) / per;
  gemm_kernel<W><<<dim3((M + BM - 1) / BM, (N + BN - 1) / BN, splits), THREADS, 0, st>>>(
      x, w, colscale, out, splits > 1 ? ws : nullptr, M, N, K, per * BK);
  if (splits > 1) splitk::launch_splitk_reduce<float>(ws, colscale, out, (size_t)M * N, N, splits, st);
  return (int)cudaGetLastError();
}

}  // namespace gemm_f32
