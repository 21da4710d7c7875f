// P1-P5: single-construct probes of K1's building blocks.
//
// Replace scripts/probe_mosaic.py case_dot_nt (P1), case_iota_mask_dots (P2),
// case_reshape3 (P3), case_mv_small_n (P4) and case_concat (P5). On the TPU
// each case compiled one minimal Pallas kernel to find which construct made
// the remote compiler fail. Here each is one small CUDA kernel that computes
// the same function, so a probe run says whether the construct builds,
// launches and agrees with its plain PyTorch version on this card. P4 runs
// the int4 matvec device code of K1 (gemv_int4.cuh) at N = 256, fewer
// columns than one wave of its blocks has warps.
//
// Bound: launch latency; the largest probe moves 128 KB.
//
// Shapes (the JAX script's): H = 4 heads, ROWS = 64 slots a head, HS = 128;
// P4 K = 512, N = 256, group size 128, 8 rows; P5 (8, 512).

#include "gemv_int4.cuh"

namespace {

constexpr int PH = 4, PROWS = 64, PHS = 128;

// P1 and P3: out (M, N) = a (M, HS) @ b^T, b (N, HS) row-major. P3 hands b as
// (H, ROWS, HS) and reads it through the collapsed (H * ROWS, HS) view.
__global__ void dot_nt_kernel(const float* __restrict__ a, const float* __restrict__ b,
                              float* __restrict__ out, int M, int N, int three_d) {
  const int m = blockIdx.x, n = blockIdx.y * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const float* brow = three_d ? b + ((size_t)(n / PROWS) * PROWS + n % PROWS) * PHS
                              : b + (size_t)n * PHS;
  float s = 0.f;
  for (int d = 0; d < PHS; ++d) s += a[m * PHS + d] * brow[d];
  out[(size_t)m * N + n] = s;
}

// P2: s_all (H, H * ROWS) = q @ k^T; mask (r, c) = (c / ROWS == r); sel
// (c, j) = (c % ROWS == j); out (H, ROWS) = (s_all * mask) @ sel. One block
// per head row r: the scores go to shared memory, then each thread sums its
// output column over every c with the masks built from the indices.
__global__ void __launch_bounds__(256)
iota_mask_dots_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      float* __restrict__ out) {
  __shared__ float s_all[PH * PROWS];
  const int r = blockIdx.x, tid = threadIdx.x;
  for (int c = tid; c < PH * PROWS; c += blockDim.x) {
    float s = 0.f;
    for (int d = 0; d < PHS; ++d) s += q[r * PHS + d] * k[(size_t)c * PHS + d];
    s_all[c] = s;
  }
  __syncthreads();
  if (tid >= PROWS) return;
  float acc = 0.f;
  for (int c = 0; c < PH * PROWS; ++c) {
    const float mask = c / PROWS == r ? 1.f : 0.f;
    const float sel = c % PROWS == tid ? 1.f : 0.f;
    acc += s_all[c] * mask * sel;
  }
  out[r * PROWS + tid] = acc;
}

// P5: out (R, 4 * 128) = the concatenation of x[:, 128 i : 128 (i + 1)] * (i + 1).
__global__ void concat_kernel(const float* __restrict__ x, float* __restrict__ out, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int c = e % 512;
  out[e] = x[e] * (float)(c / 128 + 1);
}

}  // namespace

LLT_EXPORT int p1_dot_nt(const void* a, const void* b, void* out, int M, int N, int three_d,
                         void* stream) {
  dot_nt_kernel<<<dim3(M, (N + 127) / 128), 128, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)out, M, N, three_d);
  return (int)cudaGetLastError();
}

LLT_EXPORT int p2_iota_mask_dots(const void* q, const void* k, void* out, void* stream) {
  iota_mask_dots_kernel<<<PH, 256, 0, (cudaStream_t)stream>>>((const float*)q, (const float*)k,
                                                              (float*)out);
  return (int)cudaGetLastError();
}

// P4: out (rows, N) f32 = x (rows, K) bf16 @ dequant(w), one K1 gemv launch a
// row; w in the decode layout (wt (N, K/2) u8, st/zt (N, K/gs) f32).
LLT_EXPORT int p4_mv_small_n(const void* x, const void* wt, const void* st, const void* zt,
                             void* out, int rows, int K, int N, int gs, void* stream) {
  for (int i = 0; i < rows; ++i) {
    const int err = launch_gemv((const __nv_bfloat16*)x + (size_t)i * K, 1, nullptr, wt, st, zt, K,
                                N, gs, EPI_NONE, nullptr, 0, (float*)out + (size_t)i * N, nullptr,
                                (cudaStream_t)stream);
    if (err) return err;
  }
  return 0;
}

LLT_EXPORT int p5_concat(const void* x, void* out, int rows, void* stream) {
  const int n = rows * 512;
  concat_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>((const float*)x, (float*)out,
                                                                   n);
  return (int)cudaGetLastError();
}
