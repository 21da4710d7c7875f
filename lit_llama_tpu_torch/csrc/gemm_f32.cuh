// The f32 weight-only GEMM of the f32 compute dtype, shared by K3 (int4,
// quant_matmul.cu), K6 at M > 1 (int8, quant_matmul_int8.cu) and the f32
// bodies of K7 and K9 (serve_layer.cu): out (M, N) f32 = x (M, K) f32 @ W,
// times a per-column scale where there is one. K3's f32 body replaces the
// Pallas _int4_kernel (lit_llama_tpu/ops/quant_matmul_pallas.py) in f32
// compute; GPTQ's calibration forwards run it at M = batch x T (8192).
//
// Bound on the H100: operations at prefill M, 2 * M * K * N on the CUDA
// cores (FFMA, 67 TF/s); no tensor core takes f32 without TF32, which keeps
// about three decimal digits, and neither JAX's f32 path nor the plain
// versions round that way.
//
// What held the first tile (64 x 128, 4 x 8 sums a thread) to a quarter of
// that rate: 12 scalar shared loads per 32 FFMA, the weight dequantized per
// element (three loads, a division by gs, a select) by each of M / 64 row
// blocks, one buffer with a barrier on each side of every 16-deep step, and a
// K split whose f32 partials went through a (splits, M, N) workspace, 1.2 GB
// at M = 8192.
//
// Design: a block of 256 threads owns a (BM x 128) output tile, BM = 128 from
// M > 64 (32 or 64 below), and walks K in steps of BK = 32:
//  - each thread keeps an (RT x 8) register tile, RT = BM / 16: rows
//    ry + 4 i of its warp's (4 RT x 64) tile, columns cx * 4 and 32 + cx * 4
//    (four each), ry = lane / 8, cx = lane % 8; per two k it reads its rows
//    as 8-byte words and per k its columns as two 16-byte words, so a warp's
//    shared read touches at most 128 bytes and no bank twice;
//  - x's tile comes in row-major by 16-byte cp.async into a ring of STAGES
//    steps (rows padded to LDA = 36 words: four consecutive rows start on
//    four distinct 16-byte bank groups);
//  - the packed weight bytes of the next step are loaded into registers one
//    step ahead; they are dequantized once a block and step into the other
//    of two weight buffers, rounded as the plain version rounds,
//    __fadd_rn(__fmul_rn(q, scale), zero); int8 converts exactly. Where BK
//    divides gs a step has one group, whose (group, column) scale and zero
//    rows come by cp.async in the ring with x's tile of the step before;
//    otherwise each row's are loaded where they are used;
//  - one barrier per step: after it, the copy of step t + STAGES - 1 and the
//    dequantization of step t + 1 go into buffers nobody reads any more;
//  - K is split over blockIdx.z in `splits` parts of whole steps (the count
//    comes from N and K alone, ops/quant_matmul.py f32_plan, so a row's sums
//    do not depend on M). The splits of a tile add into out one after the
//    other, in split order, behind a counter (a serial fix-up): split z waits
//    until the counter reads z, adds its partial to out (split 0 writes its
//    own), and the last applies the column scale and resets the counter to 0.
//    The sum is ((p0 + p1) + p2) ..., the order of the workspace pass it
//    replaces, without the workspace. Blocks are dispatched in linear order
//    (z slowest), so split z - 1 of a tile is running or done when split z
//    waits for it.
#pragma once

#include "common.cuh"

namespace gemm_f32 {
// Internal linkage: each library that includes this header keeps its own
// kernels and flags (the static flags of an inline function would be one
// symbol across the libraries a process loads).
namespace {

constexpr int BN = 128, BK = 32, THREADS = 256, STAGES = 3;
constexpr int LDA = BK + 4;  // f32 words a staged x row
// block rows by a thread's rows RT: 32, 64 or 128 rows (RT = 2, 4, 8)
constexpr int ROWS_SMALL = 32, ROWS_MID = 64, ROWS_FULL = 128;

// x's ring, two dequantized weight steps, and a ring of the steps' (group,
// column) scale and zero rows
template <int RT>
constexpr int smem_bytes() { return (STAGES * 16 * RT * LDA + 2 * BK * BN + STAGES * 2 * BN) * 4; }

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ uint32_t ldg_u32(const void* p) { return __ldg(reinterpret_cast<const unsigned*>(p)); }
__device__ __forceinline__ float4 ldg_f4(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }

// The weight loaders. A thread dequantizes rows r0 + 8 j (j < 4) of a step
// at columns n..n+3 (n % 4 == 0, N % 4 == 0): load() brings the step's words
// into registers, dequant() turns them into f32; rows at or past k_end and
// columns past N give 0. stage_sz() copies a step's scale and zero rows for
// the block's 128 columns into shared memory (cp.async; the int4 weight where
// BK divides gs), where dequant() reads them at sz (the thread's columns:
// scales at sz[0..3], zeros at sz[BN..BN + 3]).

// The int4 weight of ops/linear.py: qw (K/2, N) u8, packed row r holds row r
// in its low nibble and row r + K/2 in its high nibble; qscale/qzero (K/gs, N)
// f32. Any gs dividing K.
struct Int4W {
  const uint8_t* qw;
  const float* qs;
  const float* qz;
  int K, N, gs;
  struct Regs {
    uint32_t q[4];
  };
  __device__ __forceinline__ void load(Regs& r, int k0, int k_end, int r0, int n) const {
    const int Kh = K / 2;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + r0 + 8 * j;
      r.q[j] = (n < N && k < k_end) ? ldg_u32(qw + (size_t)(k < Kh ? k : k - Kh) * N + n) : 0u;
    }
  }
  __device__ __forceinline__ void stage_sz(float* dst, int k0, int k_end, int n0, int tid) const {
    if (gs % BK != 0 || k0 >= k_end || tid >= 2 * BN / 4) return;
    const int c = (tid % (BN / 4)) * 4, zero = tid / (BN / 4);
    const bool ok = n0 + c < N;
    cp_async16(dst + zero * BN + c, ok ? (zero ? qz : qs) + (size_t)(k0 / gs) * N + n0 + c : qs, ok ? 16 : 0);
  }
  __device__ __forceinline__ void dequant(float4 (&w)[4], const Regs& r, int k0, int k_end, int r0, int n,
                                          const float* sz) const {
    const int Kh = K / 2;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f), z = s;
    if (gs % BK == 0) {  // one group a step: its scale and zero, staged
      s = *reinterpret_cast<const float4*>(sz);
      z = *reinterpret_cast<const float4*>(sz + BN);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + r0 + 8 * j;
      const bool in = n < N && k < k_end;
      if (gs % BK != 0 && in) {  // a group boundary inside the step: the row's own group
        const size_t g = (size_t)(k / gs) * N + n;
        s = ldg_f4(qs + g);
        z = ldg_f4(qz + g);
      }
      const uint32_t q = k < Kh ? r.q[j] : r.q[j] >> 4;
      w[j] = in ? make_float4(__fadd_rn(__fmul_rn((float)(q & 0xFu), s.x), z.x),
                              __fadd_rn(__fmul_rn((float)((q >> 8) & 0xFu), s.y), z.y),
                              __fadd_rn(__fmul_rn((float)((q >> 16) & 0xFu), s.z), z.z),
                              __fadd_rn(__fmul_rn((float)((q >> 24) & 0xFu), s.w), z.w))
                : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
};

// The int8 weight: qw (K, N) int8, exact in f32; its scale goes to colscale.
struct Int8W {
  const int8_t* qw;
  int N;
  struct Regs {
    uint32_t q[4];
  };
  __device__ __forceinline__ void load(Regs& r, int k0, int k_end, int r0, int n) const {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + r0 + 8 * j;
      r.q[j] = (n < N && k < k_end) ? ldg_u32(qw + (size_t)k * N + n) : 0u;
    }
  }
  __device__ __forceinline__ void stage_sz(float*, int, int, int, int) const {}
  __device__ __forceinline__ void dequant(float4 (&w)[4], const Regs& r, int, int, int, int, const float*) const {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t q = r.q[j];
      w[j] = make_float4((float)(int8_t)(q & 0xFFu), (float)(int8_t)((q >> 8) & 0xFFu),
                         (float)(int8_t)((q >> 16) & 0xFFu), (float)(int8_t)(q >> 24));
    }
  }
};

// The block's (16 RT x 128) tile at columns blockIdx.x * 128, rows
// blockIdx.y * 16 RT of out, over rows [z * k_per_split, (z + 1) *
// k_per_split) of K, z = blockIdx.z. Rows past M, columns past N and k past K
// read as zero and are not written. With gridDim.z > 1 the splits add into
// out in order behind counter[tile] (zero before the launch and after it).
template <class W, int RT>
__global__ void __launch_bounds__(THREADS, 2)
gemm_kernel(const float* __restrict__ x, W w, const float* __restrict__ colscale, float* __restrict__ out,
            int* __restrict__ counter, int M, int N, int K, int k_per_split) {
  constexpr int BM = 16 * RT;
  extern __shared__ __align__(16) float sm[];
  float* As = sm;                      // [STAGES][BM][LDA]
  float* Bs = sm + STAGES * BM * LDA;  // [2][BK][BN]
  float* SZ = Bs + 2 * BK * BN;        // [STAGES][2][BN]: step u's scale and zero rows in slot u % STAGES
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ry = lane / 8, cx = lane % 8;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_per_split, k_end = min(K, k_begin + k_per_split);
  const int nsteps = (k_end - k_begin + BK - 1) / BK;
  // this thread's sums: rows row0 + 4 i (i < RT), columns col0 + 32 h + c (h < 2, c < 4)
  const int row0 = (warp / 2) * 4 * RT + ry, col0 = (warp % 2) * 64 + cx * 4;
  // the weight it dequantizes: rows wr + 8 j of a step, columns n0 + wc .. + 3
  const int wr = tid / 32, wc = (tid % 32) * 4;

  // the copies of a step's group: x's tile of the step, and the scale and zero of the step after it
  auto load_x = [&](int step) {
    if (step + 1 < nsteps) w.stage_sz(SZ + ((step + 1) % STAGES) * 2 * BN, k_begin + (step + 1) * BK, k_end, n0, tid);
    float* dst = As + (step % STAGES) * BM * LDA;
    const int k0 = k_begin + step * BK;
#pragma unroll
    for (int e = 0; e < BM * (BK / 4) / THREADS; ++e) {
      const int c = tid + e * THREADS, r = c / (BK / 4), kc = (c % (BK / 4)) * 4;
      const bool ok = m0 + r < M && k0 + kc < k_end;
      cp_async16(dst + r * LDA + kc, ok ? x + (size_t)(m0 + r) * K + k0 + kc : x, ok ? 16 : 0);
    }
  };
  auto store_w = [&](const typename W::Regs& regs, int step) {
    float4 v[4];
    const int k0 = k_begin + step * BK;
    w.dequant(v, regs, k0, k_end, wr, n0 + wc, SZ + (step % STAGES) * 2 * BN + wc);
    float* dst = Bs + (step & 1) * BK * BN;
#pragma unroll
    for (int j = 0; j < 4; ++j) *reinterpret_cast<float4*>(dst + (wr + 8 * j) * BN + wc) = v[j];
  };

  float acc[RT][8];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  w.stage_sz(SZ, k_begin, k_end, n0, tid);  // step 0's, in the first group
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) load_x(s);
    cp_async_commit();
  }
  typename W::Regs regs;
  w.load(regs, k_begin, k_end, wr, n0 + wc);
  cp_async_wait<STAGES - 2>();  // the first group
  __syncthreads();
  store_w(regs, 0);
  if (nsteps > 1) w.load(regs, k_begin + BK, k_end, wr, n0 + wc);

  for (int t = 0; t < nsteps; ++t) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of step t (and step t + 1's scales) have landed
    __syncthreads();              // everyone's, and the weight of step t; step t - 1 is done
    if (t + STAGES - 1 < nsteps) load_x(t + STAGES - 1);
    cp_async_commit();
    if (t + 1 < nsteps) {
      store_w(regs, t + 1);
      if (t + 2 < nsteps) w.load(regs, k_begin + (t + 2) * BK, k_end, wr, n0 + wc);
    }
    const float* a = As + (t % STAGES) * BM * LDA + row0 * LDA;
    const float* b = Bs + (t & 1) * BK * BN + col0;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 2) {
      float2 av[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) av[i] = *reinterpret_cast<const float2*>(a + 4 * i * LDA + kk);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 b0 = *reinterpret_cast<const float4*>(b + (kk + e) * BN);
        const float4 b1 = *reinterpret_cast<const float4*>(b + (kk + e) * BN + 32);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float ai = e ? av[i].y : av[i].x;
          acc[i][0] = fmaf(ai, b0.x, acc[i][0]);
          acc[i][1] = fmaf(ai, b0.y, acc[i][1]);
          acc[i][2] = fmaf(ai, b0.z, acc[i][2]);
          acc[i][3] = fmaf(ai, b0.w, acc[i][3]);
          acc[i][4] = fmaf(ai, b1.x, acc[i][4]);
          acc[i][5] = fmaf(ai, b1.y, acc[i][5]);
          acc[i][6] = fmaf(ai, b1.z, acc[i][6]);
          acc[i][7] = fmaf(ai, b1.w, acc[i][7]);
        }
      }
    }
  }

  const int z = blockIdx.z, splits = gridDim.z;
  const bool last = z == splits - 1;
  int* cnt = counter + blockIdx.y * gridDim.x + blockIdx.x;
  if (splits > 1) {
    if (tid == 0)
      while (ld_acquire(cnt) != z) {
      }
    __syncthreads();  // split z - 1 of this tile is in out
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int m = m0 + row0 + 4 * i;
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + col0 + 32 * h;
      if (n >= N) continue;
      float* p = out + (size_t)m * N + n;
      float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      if (z > 0) {
        const float4 prev = __ldcg(reinterpret_cast<const float4*>(p));
        v = make_float4(prev.x + v.x, prev.y + v.y, prev.z + v.z, prev.w + v.w);
      }
      if (last && colscale != nullptr) {
        const float4 cs = ldg_f4(colscale + n);
        v = make_float4(v.x * cs.x, v.y * cs.y, v.z * cs.z, v.w * cs.w);
      }
      *reinterpret_cast<float4*>(p) = v;
    }
  }
  if (splits > 1) {
    __threadfence();
    __syncthreads();  // the whole tile is written
    if (tid == 0) st_release(cnt, last ? 0 : z + 1);
  }
}

template <class W, int RT>
int launch_rows(const float* x, W w, const float* colscale, float* out, int* counter, int M, int N, int K,
                       int splits, int per, cudaStream_t st) {
  static int ready[16];
  int err = allow_smem(ready, gemm_kernel<W, RT>);
  if (err) return err;
  gemm_kernel<W, RT><<<dim3((N + BN - 1) / BN, (M + 16 * RT - 1) / (16 * RT), splits), THREADS,
                       smem_bytes<RT>(), st>>>(x, w, colscale, out, counter, M, N, K, per * BK);
  return (int)cudaGetLastError();
}

// out = x @ W (times colscale) with K in at most `splits` parts of whole
// k-steps (the Python wrappers take `splits` from quant_matmul.f32_plan);
// with more than one part, counter holds (M / BM rounded up) x (N / 128
// rounded up) int32 zeros, and is left at zero. x, out and colscale 16-byte
// aligned; K % 4 == 0 and N % 4 == 0.
template <class W>
int launch(const float* x, W w, const float* colscale, float* out, int* counter, int M, int N, int K,
                  int splits, cudaStream_t st) {
  const int steps = (K + BK - 1) / BK;
  if (splits < 1) splits = 1;
  const int per = (steps + splits - 1) / splits;  // whole k-steps a split; none is empty
  splits = (steps + per - 1) / per;
  if (splits > 1 && counter == nullptr) return (int)cudaErrorInvalidValue;
  if (M <= ROWS_SMALL) return launch_rows<W, ROWS_SMALL / 16>(x, w, colscale, out, counter, M, N, K, splits, per, st);
  if (M <= ROWS_MID) return launch_rows<W, ROWS_MID / 16>(x, w, colscale, out, counter, M, N, K, splits, per, st);
  return launch_rows<W, ROWS_FULL / 16>(x, w, colscale, out, counter, M, N, K, splits, per, st);
}

}  // namespace
}  // namespace gemm_f32
