// K10 in f32 compute on the tensor cores, in 3xTF32, at head size 128 or 256.
// Included by flash_attention.cu, whose K10 entries send f32 at those head
// sizes here.
//
// Replaces lit_llama_tpu/ops/flash_attention.py _flash_dq_kernel and
// _flash_dkv_kernel (entry _flash_backward) in f32.
//
// Bound on the H100: operations. In 3xTF32 each f32 product is three TF32
// products (495 TF/s dense), so the tensor cores give ~165 TF/s of f32
// products, against 67 TF/s of FFMA on the CUDA cores: at (1, 32, 2048, 128)
// the bounds are 312 / 417 us (dq / dK/dV), against 769.6 / 1026.2 us in FFMA.
//
// Accuracy. TF32 keeps 10 of f32's 23 mantissa bits, about three decimal
// digits: one pass is far outside the f32 tolerance. Every f32 operand x is
// split into big = cvt.rna.tf32(x) and small = cvt.rna.tf32(x - big), and
// a b = big_a big_b + big_a small_b + small_a big_b up to small_a small_b
// (2^-22 of a b) and the rounding of small (2^-22 of x): the two cross terms
// go into the f32 accumulator first, then big x big (CUTLASS's
// OpMultiplyAddFastF32, which SDPA's f32 path runs). All five products (S, dP,
// dV, dK, dQ) run this way; D = rowsum(dO * O), lse and the exponentials stay
// f32, nothing is rounded to a narrower type, as the plain version in f32.
//
// Design (FlashAttention-2's shape on mma.sync m16n8k8 .tf32): a warp owns 16
// rows (queries in dq, keys in dK/dV); the tiles it streams (keys in dq,
// queries in dK/dV) come TILE = 32 rows at a time through a cp.async ring of
// f32 rows padded to hs + 4 words. The padding makes every fragment read
// conflict-free: A and the B of S = Q K^T read rows g and columns t (banks
// 4 g + t), the B of dQ += dS K reads rows 2 t and columns g (banks 8 t + g).
// P, dS, P^T and dS^T leave the score accumulator as the A operand of the next
// product without a shuffle: the accumulator holds a row's columns 2 t and
// 2 t + 1, which the A fragment takes as its k-slots t and t + 4, so B is read
// at rows 2 t and 2 t + 1 (the sum runs over the same keys in another order).
//  - Head size 128 (Tiling<128>): a block owns 128 rows, 8 warps; the rows
//    it owns (Q and dO in dq, K and V in dK/dV, 132 KB) stay, the streamed
//    tiles (K_j and V_j; Q_i and dO_i with their lse and D) take a ring of
//    two stages. A warp holds dQ (64 registers) or dK and dV (128).
//  - Head size 256 (Tiling<256>): dK and dV of 16 keys would take 256
//    registers a thread, so two warps share 16 rows and split the head's
//    columns: each owns 128 output columns and sums its half of the
//    contraction of S and dP, and the halves are added through shared
//    memory (the same bits in both warps: the sum is commutative). A block
//    owns 32 rows, 4 warps.
//  - Causal: a block visits only the tiles at or below its diagonal, a warp
//    skips the products of a tile wholly above its own rows; blocks are
//    issued heaviest first (dq the last Q tile first, dK/dV the first KV
//    tile first).
//  - No atomics: each output element is summed by one thread in tile order,
//    so a rerun repeats bit for bit.
#pragma once

#include "common.cuh"

namespace k10tf32 {

constexpr int TILE = 32;  // keys (dq) or queries (dK/dV) a streamed tile
constexpr int PAD = 4;    // f32 words of padding a staged row
constexpr int MAX_SMEM = 232448;

// rows a block owns (queries in dq, keys in dK/dV), warps splitting a row's
// head columns, ring stages
template <int HS>
struct Tiling;
template <>
struct Tiling<128> { static constexpr int ROWS = 128, CS = 1, STAGES = 2; };
template <>
struct Tiling<256> { static constexpr int ROWS = 32, CS = 2, STAGES = 2; };

template <int HS>
__host__ __device__ constexpr int ld() { return HS + PAD; }
template <int HS>
__host__ __device__ constexpr int threads() { return Tiling<HS>::ROWS / 16 * Tiling<HS>::CS * 32; }
// the partial S and dP (16 x TILE each) a warp hands its column partner
template <int HS>
__host__ __device__ constexpr int xchg_words() { return Tiling<HS>::CS == 2 ? threads<HS>() / 32 * 2 * 16 * TILE : 0; }
// the owned rows (two tensors), the ring, (dK/dV) each stage's lse and D, the exchange
template <int HS>
__host__ __device__ constexpr int dq_smem() {
  return ((2 * Tiling<HS>::ROWS + Tiling<HS>::STAGES * 2 * TILE) * ld<HS>() + xchg_words<HS>()) * 4;
}
template <int HS>
__host__ __device__ constexpr int dkv_smem() {
  return dq_smem<HS>() + Tiling<HS>::STAGES * 2 * TILE * 4;
}
static_assert(dq_smem<128>() <= MAX_SMEM && dkv_smem<128>() <= MAX_SMEM, "K10 f32 at head size 128 exceeds 227 KB");
static_assert(dq_smem<256>() <= MAX_SMEM && dkv_smem<256>() <= MAX_SMEM, "K10 f32 at head size 256 exceeds 227 KB");

// the bits cvt.rna.tf32.f32 gives (round to nearest, ties away from zero,
// 10 mantissa bits) for every finite x, by two integer operations: the
// conversion instruction issues at a fraction of their rate
__device__ __forceinline__ uint32_t to_tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u; }
// x = big + small (+ 2^-22 x at most)
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// d += A B, mma.sync m16n8k8 in TF32 (fragments as mma.cuh's m16n8k16, k
// halved: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (t,
// g), b1 (t + 4, g); d as m16n8k16's)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d[i] += A B_i in 3xTF32 for N accumulators: each takes the two cross terms
// first, then big x big; the passes go over all N, so that no mma waits on
// the one issued just before it (the asm is volatile: issued in this order)
template <int N>
__device__ __forceinline__ void mma3(float (*d)[4], const uint32_t (&ab)[4], const uint32_t (&as)[4],
                                     const uint32_t (&bb)[N][2], const uint32_t (&bs)[N][2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(d[i], as, bb[i][0], bb[i][1]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(d[i], ab, bs[i][0], bs[i][1]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(d[i], ab, bb[i][0], bb[i][1]);
}
// the same for two products side by side (S and dP; dV and dK), 2 N chains a pass
template <int N>
__device__ __forceinline__ void mma3x2(float (*d)[4], const uint32_t (&ab)[4], const uint32_t (&as)[4],
                                       const uint32_t (&bb)[N][2], const uint32_t (&bs)[N][2], float (*e)[4],
                                       const uint32_t (&eab)[4], const uint32_t (&eas)[4], const uint32_t (&ebb)[N][2],
                                       const uint32_t (&ebs)[N][2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mma_tf32(d[i], as, bb[i][0], bb[i][1]);
    mma_tf32(e[i], eas, ebb[i][0], ebb[i][1]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mma_tf32(d[i], ab, bs[i][0], bs[i][1]);
    mma_tf32(e[i], eab, ebs[i][0], ebs[i][1]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mma_tf32(d[i], ab, bb[i][0], bb[i][1]);
    mma_tf32(e[i], eab, ebb[i][0], ebb[i][1]);
  }
}

// the A fragment of rows r.. and columns c.. of a staged tile, split
__device__ __forceinline__ void frag_a(uint32_t (&ab)[4], uint32_t (&as)[4], const float* tile, int ld, int r, int c,
                                       int g, int t) {
  const float* p = tile + (r + g) * ld + c + t;
  split(p[0], ab[0], as[0]);
  split(p[8 * ld], ab[1], as[1]);
  split(p[4], ab[2], as[2]);
  split(p[8 * ld + 4], ab[3], as[3]);
}
// the B fragment of A B^T: B^T's rows n0.. (the tile's rows), columns c..
__device__ __forceinline__ void frag_bt(uint32_t (&bb)[2], uint32_t (&bs)[2], const float* tile, int ld, int n0, int c,
                                        int g, int t) {
  const float* p = tile + (n0 + g) * ld + c + t;
  split(p[0], bb[0], bs[0]);
  split(p[4], bb[1], bs[1]);
}
// the B fragment of A B where A came from an accumulator (k-slots t, t + 4 =
// its columns 2 t, 2 t + 1): B's rows k0 + 2 t, k0 + 2 t + 1, column n0 + g
__device__ __forceinline__ void frag_bn(uint32_t (&bb)[2], uint32_t (&bs)[2], const float* tile, int ld, int k0, int n0,
                                        int g, int t) {
  const float* p = tile + (k0 + 2 * t) * ld + n0 + g;
  split(p[0], bb[0], bs[0]);
  split(p[ld], bb[1], bs[1]);
}
// an accumulator's 8-column tile as the A fragment of the next product
__device__ __forceinline__ void frag_acc(uint32_t (&ab)[4], uint32_t (&as)[4], const float (&c)[4]) {
  split(c[0], ab[0], as[0]);
  split(c[2], ab[1], as[1]);
  split(c[1], ab[2], as[2]);
  split(c[3], ab[3], as[3]);
}

// rows [r0, r0 + rows) of a (T, HS) head into dst (rows of ld words) by
// 16-byte cp.async, zeros past T
template <int HS>
__device__ __forceinline__ void stage(float* dst, const float* src, int r0, int rows, int T, int tid) {
  constexpr int CH = HS / 4, NT = threads<HS>();
  for (int c = tid; c < rows * CH; c += NT) {
    const int r = c / CH, d = (c % CH) * 4;
    const bool ok = r0 + r < T;
    cp_async16(dst + r * ld<HS>() + d, ok ? src + (size_t)(r0 + r) * HS + d : src, ok ? 16 : 0);
  }
}

// With the head's columns split over two warps: a warp's partial S and dP
// (its half of the contraction) plus its partner's, the same bits in both.
// Every thread of the block calls it (two block barriers); `live` warps
// exchange.
template <int HS>
__device__ __forceinline__ void add_partner(float (&s)[4][4], float (&dp)[4][4], float* xchg, int warp, int lane,
                                            bool live) {
  constexpr int RG = Tiling<HS>::ROWS / 16, W = 16 * TILE;  // warps a column part; words a score tile
  float* mine = xchg + warp * 2 * W;
  if (live) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        mine[(4 * j + e) * 32 + lane] = s[j][e];
        mine[W + (4 * j + e) * 32 + lane] = dp[j][e];
      }
  }
  __syncthreads();
  if (live) {
    const float* other = xchg + ((warp + RG) % (2 * RG)) * 2 * W;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] += other[(4 * j + e) * 32 + lane];
        dp[j][e] += other[W + (4 * j + e) * 32 + lane];
      }
  }
  __syncthreads();  // before a later tile's partials overwrite these
}

// ---------------------------------------------------------------------------
// dq. A block per (head, ROWS query rows); D = rowsum(dO * O) comes from
// flash_attention.cu's dot kernel before the launch. lse natural-log, as K4's
// f32 forward writes it.
template <int HS>
__global__ void __launch_bounds__(threads<HS>(), 1)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dd,
          float* __restrict__ dq, int T, float scale) {
  constexpr int ROWS = Tiling<HS>::ROWS, CS = Tiling<HS>::CS, NS = Tiling<HS>::STAGES, LD = ld<HS>();
  constexpr int HC = HS / CS, RG = ROWS / 16, ST = 2 * TILE * LD;  // a warp's columns; a stage's words
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;
  float* Ds = Qs + ROWS * LD;  // dO
  float* ring = Ds + ROWS * LD;
  float* xchg = ring + NS * ST;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int r0 = 16 * (warp % RG), c0 = HC * (warp / RG);  // the warp's rows in the block, first column
  const int q_first = (gridDim.y - 1 - blockIdx.y) * ROWS;   // the last Q tile first
  const size_t head = (size_t)blockIdx.x * T;
  const float *kh = k + head * HS, *vh = v + head * HS;
  const int row_a = q_first + r0 + g, row_b = row_a + 8;
  const float la = row_a < T ? lse[head + row_a] : 0.f, lb = row_b < T ? lse[head + row_b] : 0.f;
  const float da = row_a < T ? dd[head + row_a] : 0.f, db = row_b < T ? dd[head + row_b] : 0.f;
  const int n_kv = (min(q_first + ROWS, T) + TILE - 1) / TILE;  // key tiles up to the diagonal

  auto issue = [&](int j) {
    float* st = ring + (j % NS) * ST;
    stage<HS>(st, kh, j * TILE, TILE, T, tid);
    stage<HS>(st + TILE * LD, vh, j * TILE, TILE, T, tid);
  };
  stage<HS>(Qs, q + head * HS, q_first, ROWS, T, tid);  // in the first group, with tile 0
  stage<HS>(Ds, dout + head * HS, q_first, ROWS, T, tid);
#pragma unroll
  for (int u = 0; u < NS - 1; ++u) {
    if (u < n_kv) issue(u);
    cp_async_commit();
  }

  float acc[HC / 8][4];
#pragma unroll
  for (int n = 0; n < HC / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = 0; j < n_kv; ++j) {
    cp_async_wait<NS - 2>();  // this thread's copies of tile j have landed
    __syncthreads();          // everyone's; the tile before is done with its slot
    if (j + NS - 1 < n_kv) issue(j + NS - 1);
    cp_async_commit();
    const float* Ks = ring + (j % NS) * ST;
    const float* Vs = Ks + TILE * LD;
    const int k0 = j * TILE;
    const bool live = k0 <= q_first + r0 + 15;  // some key of the tile at or below the warp's last row
    float s[4][4], dp[4][4];
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jn][e] = dp[jn][e] = 0.f;
    if (live) {  // S = Q K_j^T and dP = dO V_j^T over the warp's columns, 8 at a time
#pragma unroll 4
      for (int kk = 0; kk < HC / 8; ++kk) {
        const int c = c0 + 8 * kk;
        uint32_t qb[4], qs[4], ob[4], os[4], kb[4][2], ks[4][2], vb[4][2], vs[4][2];
        frag_a(qb, qs, Qs, LD, r0, c, g, t);
        frag_a(ob, os, Ds, LD, r0, c, g, t);
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {
          frag_bt(kb[jn], ks[jn], Ks, LD, 8 * jn, c, g, t);
          frag_bt(vb[jn], vs[jn], Vs, LD, 8 * jn, c, g, t);
        }
        mma3x2(s, qb, qs, kb, ks, dp, ob, os, vb, vs);
      }
    }
    if constexpr (CS == 2) add_partner<HS>(s, dp, xchg, warp, lane, live);
    if (!live) continue;
    // P = exp(S scale - lse) where key <= row, dS = P (dP - D) in place of S
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * jn + 2 * t + e;
        const float pa = key <= row_a ? __expf(s[jn][e] * scale - la) : 0.f;
        const float pb = key <= row_b ? __expf(s[jn][2 + e] * scale - lb) : 0.f;
        s[jn][e] = pa * (dp[jn][e] - da);
        s[jn][2 + e] = pb * (dp[jn][2 + e] - db);
      }
    // dQ += dS K_j: k-step jn takes keys k0 + 8 jn .., 8 output column tiles a pass
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      uint32_t ab[4], as[4];
      frag_acc(ab, as, s[jn]);
#pragma unroll
      for (int n0 = 0; n0 < HC / 8; n0 += 8) {
        uint32_t bb[8][2], bs[8][2];
#pragma unroll
        for (int i = 0; i < 8; ++i) frag_bn(bb[i], bs[i], Ks, LD, 8 * jn, c0 + 8 * (n0 + i), g, t);
        mma3(acc + n0, ab, as, bb, bs);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int n = 0; n < HC / 8; ++n) {
    const int col = c0 + 8 * n + 2 * t;
    if (row_a < T) *reinterpret_cast<float2*>(dq + (head + row_a) * HS + col) = make_float2(acc[n][0] * scale, acc[n][1] * scale);
    if (row_b < T) *reinterpret_cast<float2*>(dq + (head + row_b) * HS + col) = make_float2(acc[n][2] * scale, acc[n][3] * scale);
  }
}

// ---------------------------------------------------------------------------
// dK/dV. A block per (head, ROWS keys); the transposed tiles S^T = K Q_i^T
// and dP^T = V dO_i^T give P^T and dS^T as the A operands of dV += P^T dO_i
// and dK += dS^T Q_i.
template <int HS>
__global__ void __launch_bounds__(threads<HS>(), 1)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dd,
           float* __restrict__ dk, float* __restrict__ dv, int T, float scale) {
  constexpr int ROWS = Tiling<HS>::ROWS, CS = Tiling<HS>::CS, NS = Tiling<HS>::STAGES, LD = ld<HS>();
  constexpr int HC = HS / CS, RG = ROWS / 16, ST = 2 * TILE * LD;
  extern __shared__ __align__(16) float sm[];
  float* Ks = sm;
  float* Vs = Ks + ROWS * LD;
  float* ring = Vs + ROWS * LD;     // a stage: Q_i, dO_i
  float* xchg = ring + NS * ST;
  float* rows = xchg + xchg_words<HS>();  // a stage: TILE lse, TILE D
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int r0 = 16 * (warp % RG), c0 = HC * (warp / RG);
  const int k_first = blockIdx.y * ROWS;  // the first KV tile, which every Q tile sees, first
  const size_t head = (size_t)blockIdx.x * T;
  const float *qh = q + head * HS, *oh = dout + head * HS;
  const int key_a = k_first + r0 + g, key_b = key_a + 8;
  const int i0 = k_first / TILE, n_q = (T + TILE - 1) / TILE - i0;  // query tiles at or below the diagonal

  auto issue = [&](int u) {
    const int q0 = (i0 + u) * TILE;
    float* st = ring + (u % NS) * ST;
    stage<HS>(st, qh, q0, TILE, T, tid);
    stage<HS>(st + TILE * LD, oh, q0, TILE, T, tid);
    if (tid < 2 * TILE) {
      const int c = tid % TILE;
      const bool ok = q0 + c < T;
      const float* src = (tid < TILE ? lse : dd) + head + (ok ? q0 + c : 0);
      cp_async4(rows + (u % NS) * 2 * TILE + tid, src, ok ? 4 : 0);
    }
  };
  stage<HS>(Ks, k + head * HS, k_first, ROWS, T, tid);
  stage<HS>(Vs, v + head * HS, k_first, ROWS, T, tid);
#pragma unroll
  for (int u = 0; u < NS - 1; ++u) {
    if (u < n_q) issue(u);
    cp_async_commit();
  }

  float dka[HC / 8][4], dva[HC / 8][4];
#pragma unroll
  for (int n = 0; n < HC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int u = 0; u < n_q; ++u) {
    cp_async_wait<NS - 2>();
    __syncthreads();
    if (u + NS - 1 < n_q) issue(u + NS - 1);
    cp_async_commit();
    const float* Qs = ring + (u % NS) * ST;
    const float* Os = Qs + TILE * LD;
    const float* Lr = rows + (u % NS) * 2 * TILE;
    const int q0 = (i0 + u) * TILE;
    const bool live = q0 + TILE - 1 >= k_first + r0;  // some query of the tile at or past the warp's first key
    float s[4][4], dp[4][4];
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jn][e] = dp[jn][e] = 0.f;
    if (live) {  // S^T = K Q_i^T and dP^T = V dO_i^T over the warp's columns
#pragma unroll 4
      for (int kk = 0; kk < HC / 8; ++kk) {
        const int c = c0 + 8 * kk;
        uint32_t kb[4], ks[4], vb[4], vs[4], qb[4][2], qs[4][2], ob[4][2], os[4][2];
        frag_a(kb, ks, Ks, LD, r0, c, g, t);
        frag_a(vb, vs, Vs, LD, r0, c, g, t);
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {
          frag_bt(qb[jn], qs[jn], Qs, LD, 8 * jn, c, g, t);
          frag_bt(ob[jn], os[jn], Os, LD, 8 * jn, c, g, t);
        }
        mma3x2(s, kb, ks, qb, qs, dp, vb, vs, ob, os);
      }
    }
    if constexpr (CS == 2) add_partner<HS>(s, dp, xchg, warp, lane, live);
    if (!live) continue;
    // P^T (query q sees key iff key <= q < T) in place of S^T, dS^T = P^T
    // (dP^T - D) in place of dP^T
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * jn + 2 * t + e, qq = q0 + c;
        const float l = Lr[c], d = Lr[TILE + c];
        const float pa = qq >= key_a && qq < T ? __expf(s[jn][e] * scale - l) : 0.f;
        const float pb = qq >= key_b && qq < T ? __expf(s[jn][2 + e] * scale - l) : 0.f;
        s[jn][e] = pa, s[jn][2 + e] = pb;
        dp[jn][e] = pa * (dp[jn][e] - d);
        dp[jn][2 + e] = pb * (dp[jn][2 + e] - d);
      }
    // dV += P^T dO_i and dK += dS^T Q_i: k-step jn takes queries q0 + 8 jn ..,
    // 4 output column tiles of each a pass
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      uint32_t pb_[4], ps_[4], sb_[4], ss_[4];
      frag_acc(pb_, ps_, s[jn]);
      frag_acc(sb_, ss_, dp[jn]);
#pragma unroll
      for (int n0 = 0; n0 < HC / 8; n0 += 4) {
        uint32_t ob[4][2], os[4][2], qb[4][2], qs[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          frag_bn(ob[i], os[i], Os, LD, 8 * jn, c0 + 8 * (n0 + i), g, t);
          frag_bn(qb[i], qs[i], Qs, LD, 8 * jn, c0 + 8 * (n0 + i), g, t);
        }
        mma3x2(dva + n0, pb_, ps_, ob, os, dka + n0, sb_, ss_, qb, qs);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int n = 0; n < HC / 8; ++n) {
    const int col = c0 + 8 * n + 2 * t;
    if (key_a < T) {
      const size_t off = (head + key_a) * HS + col;
      *reinterpret_cast<float2*>(dk + off) = make_float2(dka[n][0] * scale, dka[n][1] * scale);
      *reinterpret_cast<float2*>(dv + off) = make_float2(dva[n][0], dva[n][1]);
    }
    if (key_b < T) {
      const size_t off = (head + key_b) * HS + col;
      *reinterpret_cast<float2*>(dk + off) = make_float2(dka[n][2] * scale, dka[n][3] * scale);
      *reinterpret_cast<float2*>(dv + off) = make_float2(dva[n][2], dva[n][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// The launches (D already in dd), on (B * H) heads of T rows.

template <int HS>
int backward_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* dd,
                void* dq, int BH, int T, float scale, cudaStream_t st) {
  int err = (int)cudaFuncSetAttribute(dq_kernel<HS>, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem<HS>());
  if (err) return err;
  const int n_qt = (T + Tiling<HS>::ROWS - 1) / Tiling<HS>::ROWS;
  dq_kernel<HS><<<dim3(BH, n_qt), threads<HS>(), dq_smem<HS>(), st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse, (const float*)dd,
      (float*)dq, T, scale);
  return (int)cudaGetLastError();
}

template <int HS>
int backward_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* dd,
                 void* dk, void* dv, int BH, int T, float scale, cudaStream_t st) {
  int err = (int)cudaFuncSetAttribute(dkv_kernel<HS>, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_smem<HS>());
  if (err) return err;
  const int n_kt = (T + Tiling<HS>::ROWS - 1) / Tiling<HS>::ROWS;
  dkv_kernel<HS><<<dim3(BH, n_kt), threads<HS>(), dkv_smem<HS>(), st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse, (const float*)dd,
      (float*)dk, (float*)dv, T, scale);
  return (int)cudaGetLastError();
}

}  // namespace k10tf32
