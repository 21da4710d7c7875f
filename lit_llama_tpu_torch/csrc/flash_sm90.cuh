// K4 and K10 at head size 128 in bf16 on Hopper: wgmma, TMA and an mbarrier
// ring. Included by flash_attention.cu, whose launchers send bf16 at head
// size 128 here (bf16 at 256 goes to K4 and K10 of flash_sm90_hs256.cuh,
// past 256 to those of flash_sm90_wide.cuh, both built on this file; f32 to
// K4's FFMA bodies in flash_attention.cu and K10's flash_tf32.cuh).
//
// Replaces lit_llama_tpu/ops/flash_attention.py _flash_kernel (K4, entry
// _flash_forward) and _flash_dq_kernel / _flash_dkv_kernel (K10, entry
// _flash_backward).
//
// Bound on the H100: the causal products, 2 * T * T/2 * hs a head each (two
// in the forward, three in dq, four in dK/dV), against the bytes (q, k, v,
// o, dO read once, the outputs written once): at T = 2048 the tensor cores
// bound every kernel. What stands between a kernel and that bound is keeping
// the tensor cores fed: the copies, the softmax on the CUDA cores and the
// tail of the causal grid.
//
// Design. A block holds a producer and one or two consumer warpgroups (128
// threads, wgmma's M = 64 rows each). With two, the block has 384 threads,
// which ptxas would hold to 168 registers a thread: the producer gives its
// registers up (setmaxnreg to 24) and the consumers take them (240), so
// that O, S and P (K4) or dK, dV, S^T and dP^T (dK/dV) stay in registers.
//  - The producer's lane 0 copies tiles by TMA from a 3-D tensor map (hs, T,
//    B * H) in boxes of 64 head columns x rows: one box stops at T, its rows
//    past T come as zeros, so the ragged last tile needs no bounds in the
//    copies, and no box reads the next head's rows. A tile (rows x 128) lands
//    as two 64-column panels of 128-byte rows with the 128-byte swizzle, the
//    layout wgmma reads both as a K-major operand (S = Q K^T: the head is K)
//    and as an MN-major one (O += P V: the keys are K, the head N).
//  - The tile the block owns (Q in K4 and dq; K and V in dK/dV) comes once;
//    the others stream through rings of *_STAGES tiles, each stage with a
//    full and an empty mbarrier. K4 and dq keep K and V in rings of their
//    own, so a K tile is released as soon as its scores are done.
//  - Scores and dP come from SS wgmma (both operands in shared memory, f32
//    in registers). P and dS are rounded to bf16 in registers, in the A
//    layout of the next product, which reads them from registers (RS wgmma):
//    they never pass through shared memory.
//  - Overlap. K4 issues tile j + 1's S before tile j's P V and runs the
//    exponentials of tile j + 1 while P V does; dq issues tile j - 1's dQ
//    product with tile j's S and dP. The two consumer warpgroups take turns
//    on the tensor cores (named barriers): one issues its products and hands
//    the turn over, so that its softmax runs beside the other's products.
//  - Causal skipping: a block visits only the tiles at or below its
//    diagonal; only the last tile of K4 and the tiles that cross a
//    warpgroup's diagonal in K10 are masked. Blocks are issued heaviest
//    first: the tile index is the grid's slowest axis, the last Q tile first
//    in K4 and dq, the first KV tile (which every Q tile sees) first in dK/dV.
//  - K4's KV tile is 128 keys under every plan (ops/flash_attention.py
//    flash_plan picks 64 or 128 query rows a block): a query row sees the same
//    tiles and the same steps of the online softmax either way, so its output
//    is the same bits whatever the plan.
//  - Outputs go through shared memory (a warpgroup's own rows of a tile it
//    no longer reads) and out by one TMA store a panel, which leaves out the
//    rows past T.
//  - No atomics: each output element is summed by one thread, in tile order,
//    so a rerun repeats bit for bit.
// Rounding as the Pallas kernels: f32 scores, P rounded to bf16 before P V
// and dV, dS before dQ and dK, every sum in f32, scale applied after the
// product for dq and dk, lse and D in f32. exp is ex2.approx of the score in
// units of log2(e).
#pragma once

#include <cuda.h>

#include "common.cuh"
#include "sm90.cuh"
#include "wgmma.cuh"

namespace fa90 {

using namespace sm90;

constexpr int HS = 128;                   // the head size these kernels take
constexpr int PANEL = 64;                 // head columns of a 128-byte swizzled panel
constexpr int FWD_BKV = 128;              // K4: keys a KV tile, the same under every plan
constexpr int DQ_BQ = 128, DQ_BKV = 64;   // dq: query rows a block, keys a KV tile
constexpr int DKV_BKV = 128, DKV_BQ = 64; // dK/dV: keys a block, queries a Q tile
constexpr int FWD_STAGES = 3, DQ_STAGES = 4, DKV_STAGES = 3;
constexpr int MAX_SMEM = 232448;          // what a block may use on the H100
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

// bytes of a (rows x 128) bf16 tile: two panels of rows x 128 bytes
__host__ __device__ constexpr int tile_bytes(int rows) { return rows * HS * 2; }

// dynamic shared memory of each kernel: alignment slack, tiles, barriers
__host__ __device__ constexpr int fwd_smem(int bq) {
  return 1024 + tile_bytes(bq) + FWD_STAGES * 2 * tile_bytes(FWD_BKV) + (4 * FWD_STAGES + 1) * 8;
}
__host__ __device__ constexpr int dq_smem() {
  return 1024 + 2 * tile_bytes(DQ_BQ) + DQ_STAGES * 2 * tile_bytes(DQ_BKV) + (4 * DQ_STAGES + 1) * 8;
}
// a dK/dV stage: Q_i and dO_i, then their lse (times log2(e)) and D rows
__host__ __device__ constexpr int dkv_stage() { return 2 * tile_bytes(DKV_BQ) + 1024; }
__host__ __device__ constexpr int dkv_smem() {
  return 1024 + 2 * tile_bytes(DKV_BKV) + DKV_STAGES * dkv_stage() + (2 * DKV_STAGES + 1) * 8;
}

struct Maps {
  CUtensorMap q, k, v, d;  // d: dO (K10)
  CUtensorMap o0, o1;      // the outputs (K4 o; dq; dk, dv) in boxes of 64 rows
};

struct Args {
  float* lse;           // K4 writes it, K10 reads it
  const float* dd;      // D = rowsum(dO * O) (K10)
  int T, n_tiles;       // n_tiles: the grid's y extent
  float scale, sl2;     // 1 / sqrt(hs), and times log2(e)
};

// the register budget of a warpgroup: the producer gives registers up, the
// consumers take them (a block of three warpgroups launches at 168 a thread)
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;  // 24 * 128 + 240 * 256 <= 65536

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the compiler must neither move reads of an accumulator above the
// wgmma.wait that completes it nor writes below the wgmma that reads it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// descriptors of a tile at shared address `tile` with `rows` rows (two
// panels of rows x 128 bytes, 128-byte swizzle):
//  K-major (the head is K): rows r0.. as M or N, k-step kk of 16 columns
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int r0, int kk) {
  return gmma_desc(tile + (kk / 4) * rows * 128 + r0 * 128 + (kk % 4) * 32, 16, 1024, 1);
}
//  MN-major (the rows are K, the head N): k-step kk of 16 rows; the second
//  panel's 64 columns lie one panel (rows x 128 bytes) on
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int kk) {
  return gmma_desc(tile + kk * 16 * 128, rows * 128, 1024, 1);
}

// the A operand of an RS wgmma, k-step kk (16 columns of d), from the f32
// accumulator layout: d[8 kk .. 8 kk + 7] hold the thread's values there
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 4], const float (&d)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(d[2 * i], d[2 * i + 1]);
    a[i] = *reinterpret_cast<const uint32_t*>(&v);
  }
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023) & ~1023u) - a);
}

__device__ __forceinline__ void init_barriers(uint32_t bars, int n, const int* counts) {
  for (int i = 0; i < n; ++i) mbar_init(bars + 8 * i, counts[i]);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// both panels of a (rows x 128) box at row r of head bh, completing on bar
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* m, int rows, int r, int bh, uint32_t bar) {
  tma_3d(dst, m, 0, r, bh, bar);
  tma_3d(dst + rows * 128, m, PANEL, r, bh, bar);
}

// the (c0, c1, c2) box of tensor map tm from shared memory at src (a bulk
// group: commit, then wait until it has been read)
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* tm, uint32_t src, int c0, int c1, int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(tm)),
               "r"(src), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}

// A warpgroup's 64 output rows (the f32 accumulator times mul0 for the
// thread's row r, mul1 for r + 8) to head bh, rows row0.. of the tensor
// map: written as bf16 into the warpgroup's own rows `r_off`.. of a dead
// (rows x 128) tile at `tile` (the 128-byte swizzle of the map), then one TMA
// store a panel, which leaves out the rows past T. The block's other
// warpgroup never touches those rows.
__device__ __forceinline__ void store_rows(unsigned char* tile_ptr, uint32_t tile, int rows, int r_off,
                                           const float (&acc)[64], float mul0, float mul1, const CUtensorMap* m,
                                           int row0, int bh, int wg, int t128) {
  const int lane = t128 % 32, t = lane % 4, r = 16 * (t128 / 32) + lane / 4;  // r, r + 8 in the warpgroup
#pragma unroll
  for (int i = 0; i < HS / 8; ++i)  // 8 head columns from 8 i: panel i / 8, 16-byte chunk i % 8
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r_off + r + 8 * h;
      const float mul = h ? mul1 : mul0;
      const __nv_bfloat162 v = __floats2bfloat162_rn(acc[4 * i + 2 * h] * mul, acc[4 * i + 2 * h + 1] * mul);
      *reinterpret_cast<__nv_bfloat162*>(tile_ptr + (i / 8) * rows * 128 + row * 128 + (((i % 8) ^ (row % 8)) << 4) +
                                         4 * t) = v;
    }
  fence_proxy_async();  // the threads' writes, read by the TMA store
  warpgroup_sync(wg);
  if (t128 == 0) {
    tma_store_3d(m, tile + r_off * 128, 0, row0, bh);
    tma_store_3d(m, tile + rows * 128 + r_off * 128, PANEL, row0, bh);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // before the block's shared memory goes
  }
}

// Turn-taking of a block's two consumer warpgroups on the tensor cores
// (named barriers 3 and 4): a warpgroup waits for its turn, issues its
// products, and hands the turn to the other, so that one's softmax runs
// beside the other's products rather than in step with them. Warpgroup 1
// hands warpgroup 0 the first turn; both take the same number of turns.
__device__ __forceinline__ void first_turn(int wg) {
  if (wg == 1) asm volatile("bar.arrive 3, 256;\n" ::: "memory");
}
__device__ __forceinline__ void turn_wait(int wg) {
  if (wg == 0)
    asm volatile("bar.sync 3, 256;\n" ::: "memory");
  else
    asm volatile("bar.sync 4, 256;\n" ::: "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  if (wg == 0)
    asm volatile("bar.arrive 4, 256;\n" ::: "memory");
  else
    asm volatile("bar.arrive 3, 256;\n" ::: "memory");
}

// A ring of STAGES: full barriers at `bars`, empty ones after them
template <int STAGES>
struct Ring {
  uint32_t bars;
  __device__ __forceinline__ uint32_t full(int i) const { return bars + 8 * (i % STAGES); }
  __device__ __forceinline__ uint32_t empty(int i) const { return bars + 8 * (STAGES + i % STAGES); }
  __device__ __forceinline__ int phase(int i) const { return (i / STAGES) & 1; }
};

// ---------------------------------------------------------------------------
// K4. One block per (head, Q tile of 64 WGS rows), WGS consumer warpgroups of
// 64 rows. Q once; K and V tiles of 128 keys in rings of their own.
// Threads: WGS consumer warpgroups and a producer, one warp where one
// consumer warpgroup leaves registers enough (221 a thread), a warpgroup
// giving its registers to the two consumers' O, S and P (setmaxnreg).
template <int WGS>
constexpr int fwd_threads() { return WGS == 1 ? 160 : 384; }

template <int WGS>
__global__ void __launch_bounds__(fwd_threads<WGS>(), 1) fwd_kernel(const __grid_constant__ Maps mp, const Args p) {
  constexpr int BQ = 64 * WGS, CONS = 128 * WGS, KV = tile_bytes(FWD_BKV);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  const uint32_t sq = smem_u32(sm), sk = sq + tile_bytes(BQ), sv = sk + FWD_STAGES * KV;
  const uint32_t bars = sv + FWD_STAGES * KV, qbar = bars + 8 * 4 * FWD_STAGES;
  const Ring<FWD_STAGES> rk{bars}, rv{bars + 8 * 2 * FWD_STAGES};

  const int tid = threadIdx.x, bh = blockIdx.x, qt = p.n_tiles - 1 - blockIdx.y;
  const int q_first = qt * BQ;
  const int n_kv = (min(q_first + BQ, p.T) + FWD_BKV - 1) / FWD_BKV;  // tiles up to the diagonal
  if (tid == 0) {
    int counts[4 * FWD_STAGES + 1];
    for (int i = 0; i < 4 * FWD_STAGES + 1; ++i) counts[i] = (i / FWD_STAGES) % 2 ? WGS : 1;  // empty: each warpgroup
    init_barriers(bars, 4 * FWD_STAGES + 1, counts);
  }
  __syncthreads();

  if (tid >= CONS) {  // the producer: lane 0 of its first warp issues every copy
    if constexpr (WGS == 2) regs_dec<PRODUCER_REGS>();
    if (tid == CONS) {
      mbar_expect_tx(qbar, tile_bytes(BQ));
      load_tile(sq, &mp.q, BQ, q_first, bh, qbar);
      for (int j = 0; j < n_kv; ++j) {
        mbar_wait(rk.empty(j), rk.phase(j) ^ 1);
        mbar_expect_tx(rk.full(j), KV);
        load_tile(sk + (j % FWD_STAGES) * KV, &mp.k, FWD_BKV, j * FWD_BKV, bh, rk.full(j));
        mbar_wait(rv.empty(j), rv.phase(j) ^ 1);
        mbar_expect_tx(rv.full(j), KV);
        load_tile(sv + (j % FWD_STAGES) * KV, &mp.v, FWD_BKV, j * FWD_BKV, bh, rv.full(j));
      }
    }
    return;
  }

  // a consumer warpgroup: rows q_first + 64 wg ..; this thread rows r0, r0 + 8
  if constexpr (WGS == 2) regs_inc<CONSUMER_REGS>();
  const int wg = tid / 128, t128 = tid % 128, lane = tid % 32, t = lane % 4;
  const int r0 = q_first + 64 * wg + 16 * (t128 / 32) + lane / 4;
  float o[64];
  uint32_t pa[32];  // P in bf16, the A operand of P V (8 k-steps of 16 keys)
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m0 = LLT_NEG_INF, m1 = LLT_NEG_INF, l0 = 0.f, l1 = 0.f, a0, a1;

  // Each tile's scores go to a fresh array: the first wgmma of a chain
  // (scale_d = 0) then depends on no earlier value, and nothing but wgmma
  // touches the array until the wait.
  auto issue_s = [&](int j, float (&s)[64]) {  // S = Q K_j^T: 8 k-steps of 16 head columns
    const uint32_t kt = sk + (j % FWD_STAGES) * KV;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HS / 16; ++kk)
      wgmma_ss<FWD_BKV>(s, desc_k(sq, BQ, 64 * wg, kk), desc_k(kt, FWD_BKV, 0, kk), kk > 0);
    wgmma_commit();
  };
  auto issue_pv = [&](int j) {  // O += P V_j: 8 k-steps of 16 keys
    const uint32_t vt = sv + (j % FWD_STAGES) * KV;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < FWD_BKV / 16; ++kk) wgmma_rs<HS>(o, pa + 4 * kk, desc_mn(vt, FWD_BKV, kk));
    wgmma_commit();
  };
  // tile j's scores -> unnormalised P in s; the new row max (in units of
  // log2(e)); a0, a1 rescale what was summed before. The scale is folded
  // into the exponent's FFMA (the max is taken over the raw scores).
  auto softmax = [&](int j, float (&s)[64]) {
    const bool diag = j == n_kv - 1;  // the only tile with keys past a row (or past T)
    const int k0 = j * FWD_BKV + 2 * t;
    float x0 = LLT_NEG_INF, x1 = LLT_NEG_INF;
#pragma unroll
    for (int i = 0; i < FWD_BKV / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * i + e;
        if (diag && key > r0) s[4 * i + e] = LLT_NEG_INF;
        if (diag && key > r0 + 8) s[4 * i + 2 + e] = LLT_NEG_INF;
        x0 = fmaxf(x0, s[4 * i + e]), x1 = fmaxf(x1, s[4 * i + 2 + e]);
      }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {  // a row's 128 keys lie on the 4 lanes of a quad
      x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, x));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, x));
    }
    const float mt0 = fmaxf(m0, x0 * p.sl2), mt1 = fmaxf(m1, x1 * p.sl2);
    a0 = ex2(m0 - mt0), a1 = ex2(m1 - mt1);
    m0 = mt0, m1 = mt1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int i = 0; i < FWD_BKV / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * i + e] = ex2(fmaf(s[4 * i + e], p.sl2, -m0));
        s[4 * i + 2 + e] = ex2(fmaf(s[4 * i + 2 + e], p.sl2, -m1));
        ls0 += s[4 * i + e], ls1 += s[4 * i + 2 + e];
      }
    l0 = l0 * a0 + ls0;  // the thread's part of the row sum; the quad's are summed at the end
    l1 = l1 * a1 + ls1;
  };

  mbar_wait(qbar, 0);
  if constexpr (WGS == 2) first_turn(wg);
  {
    float s[64];
    mbar_wait(rk.full(0), 0);
    if constexpr (WGS == 2) turn_wait(wg);
    issue_s(0, s);
    if constexpr (WGS == 2) turn_pass(wg);
    wgmma_wait<0>();
    fence_regs(s);
    if (t128 == 0) mbar_arrive(rk.empty(0));
    softmax(0, s);
    pack_a<FWD_BKV>(pa, s);
  }
  // the same wgmma groups in every pass (the last tile's P V is peeled off),
  // so the compiler sees one pipeline
  for (int j = 0; j + 1 < n_kv; ++j) {
    float s[64];
    mbar_wait(rk.full(j + 1), rk.phase(j + 1));
    mbar_wait(rv.full(j), rv.phase(j));
    if constexpr (WGS == 2) turn_wait(wg);
    issue_s(j + 1, s);
    issue_pv(j);
    if constexpr (WGS == 2) turn_pass(wg);
    wgmma_wait<1>();  // tile j + 1's scores; its softmax runs beside tile j's P V
    fence_regs(s);
    if (t128 == 0) mbar_arrive(rk.empty(j + 1));
    softmax(j + 1, s);
    wgmma_wait<0>();
    fence_regs(o);
    if (t128 == 0) mbar_arrive(rv.empty(j));
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      o[4 * i] *= a0, o[4 * i + 1] *= a0;
      o[4 * i + 2] *= a1, o[4 * i + 3] *= a1;
    }
    pack_a<FWD_BKV>(pa, s);
  }
  mbar_wait(rv.full(n_kv - 1), rv.phase(n_kv - 1));
  issue_pv(n_kv - 1);
  wgmma_wait<0>();
  fence_regs(o);

#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  // O through the warpgroup's rows of the Q tile (its last scores are done)
  store_rows(sm, sq, BQ, 64 * wg, o, inv0, inv1, &mp.o0, q_first + 64 * wg, bh, wg, t128);
  if (t == 0) {
    float* lb = p.lse + (size_t)bh * p.T;
    if (r0 < p.T) lb[r0] = m0 * LN2 + logf(fmaxf(l0, 1e-30f));
    if (r0 + 8 < p.T) lb[r0 + 8] = m1 * LN2 + logf(fmaxf(l1, 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// K10 dq. One block per (head, Q tile of 128 rows), two consumer warpgroups
// of 64 rows. Q and dO once; K and V tiles of 64 keys in rings of their own.
// D comes from flash_bwd_dot_kernel (flash_attention.cu) before the launch.
__global__ void __launch_bounds__(384, 1) dq_kernel(const __grid_constant__ Maps mp, const Args p) {
  constexpr int CONS = 256, QB = tile_bytes(DQ_BQ), KV = tile_bytes(DQ_BKV);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  const uint32_t sq = smem_u32(sm), sdo = sq + QB, sk = sdo + QB, sv = sk + DQ_STAGES * KV;
  const uint32_t bars = sv + DQ_STAGES * KV, qbar = bars + 8 * 4 * DQ_STAGES;
  const Ring<DQ_STAGES> rk{bars}, rv{bars + 8 * 2 * DQ_STAGES};

  const int tid = threadIdx.x, bh = blockIdx.x, qt = p.n_tiles - 1 - blockIdx.y;
  const int q_first = qt * DQ_BQ;
  const int n_kv = (min(q_first + DQ_BQ, p.T) + DQ_BKV - 1) / DQ_BKV;
  if (tid == 0) {
    int counts[4 * DQ_STAGES + 1];
    for (int i = 0; i < 4 * DQ_STAGES + 1; ++i) counts[i] = (i / DQ_STAGES) % 2 ? 2 : 1;
    init_barriers(bars, 4 * DQ_STAGES + 1, counts);
  }
  __syncthreads();

  if (tid >= CONS) {  // the producer warpgroup: lane 0 of its first warp issues every copy
    regs_dec<PRODUCER_REGS>();
    if (tid == CONS) {
      mbar_expect_tx(qbar, 2 * QB);
      load_tile(sq, &mp.q, DQ_BQ, q_first, bh, qbar);
      load_tile(sdo, &mp.d, DQ_BQ, q_first, bh, qbar);
      for (int j = 0; j < n_kv; ++j) {
        mbar_wait(rk.empty(j), rk.phase(j) ^ 1);
        mbar_expect_tx(rk.full(j), KV);
        load_tile(sk + (j % DQ_STAGES) * KV, &mp.k, DQ_BKV, j * DQ_BKV, bh, rk.full(j));
        mbar_wait(rv.empty(j), rv.phase(j) ^ 1);
        mbar_expect_tx(rv.full(j), KV);
        load_tile(sv + (j % DQ_STAGES) * KV, &mp.v, DQ_BKV, j * DQ_BKV, bh, rv.full(j));
      }
    }
    return;
  }

  regs_inc<CONSUMER_REGS>();
  const int wg = tid / 128, t128 = tid % 128, lane = tid % 32, t = lane % 4;
  const int wg_first = q_first + 64 * wg, r0 = wg_first + 16 * (t128 / 32) + lane / 4;
  const float* lb = p.lse + (size_t)bh * p.T;
  const float* db = p.dd + (size_t)bh * p.T;
  const float L0 = r0 < p.T ? lb[r0] * LOG2E : 0.f, L1 = r0 + 8 < p.T ? lb[r0 + 8] * LOG2E : 0.f;
  const float D0 = r0 < p.T ? db[r0] : 0.f, D1 = r0 + 8 < p.T ? db[r0 + 8] : 0.f;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  uint32_t da[16];  // tile j's dS in bf16, the A operand of dS K_j (4 k-steps of 16 keys)
  auto issue_dq = [&](int j) {  // dQ += bf16(dS) K_j, K_j as the MN-major B
    const uint32_t kt = sk + (j % DQ_STAGES) * KV;
#pragma unroll
    for (int kk = 0; kk < DQ_BKV / 16; ++kk) wgmma_rs<HS>(acc, da + 4 * kk, desc_mn(kt, DQ_BKV, kk));
  };
  // S = Q K_j^T and dP = dO V_j^T, into fresh arrays (as in K4)
  auto issue_ss = [&](int j, float (&s)[32], float (&dp)[32]) {
    const uint32_t kt = sk + (j % DQ_STAGES) * KV, vt = sv + (j % DQ_STAGES) * KV;
#pragma unroll
    for (int kk = 0; kk < HS / 16; ++kk)
      wgmma_ss<DQ_BKV>(s, desc_k(sq, DQ_BQ, 64 * wg, kk), desc_k(kt, DQ_BKV, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HS / 16; ++kk)
      wgmma_ss<DQ_BKV>(dp, desc_k(sdo, DQ_BQ, 64 * wg, kk), desc_k(vt, DQ_BKV, 0, kk), kk > 0);
  };
  // P = exp(S scale - lse), masked where the tile crosses the warpgroup's
  // diagonal; dS = P (dP - D), rounded into da
  auto ds_tile = [&](int j, float (&s)[32], const float (&dp)[32]) {
    const int k0 = j * DQ_BKV;
    const bool diag = k0 + DQ_BKV - 1 > wg_first;
#pragma unroll
    for (int i = 0; i < DQ_BKV / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * i + 2 * t + e;
        const float p0 = diag && key > r0 ? 0.f : ex2(s[4 * i + e] * p.sl2 - L0);
        const float p1 = diag && key > r0 + 8 ? 0.f : ex2(s[4 * i + 2 + e] * p.sl2 - L1);
        s[4 * i + e] = p0 * (dp[4 * i + e] - D0);
        s[4 * i + 2 + e] = p1 * (dp[4 * i + 2 + e] - D1);
      }
    pack_a<DQ_BKV>(da, s);
  };

  mbar_wait(qbar, 0);
  first_turn(wg);
  // tile j's S and dP go out in one turn with tile j - 1's dQ product, so
  // the loop body is the same in every pass (the first and last peeled off)
  {
    float s[32], dp[32];
    mbar_wait(rk.full(0), 0);
    mbar_wait(rv.full(0), 0);
    turn_wait(wg);
    wgmma_fence();
    issue_ss(0, s, dp);
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    if (t128 == 0) mbar_arrive(rv.empty(0));
    ds_tile(0, s, dp);
  }
  for (int j = 1; j < n_kv; ++j) {
    float s[32], dp[32];
    mbar_wait(rk.full(j), rk.phase(j));
    mbar_wait(rv.full(j), rv.phase(j));
    turn_wait(wg);
    wgmma_fence();
    issue_dq(j - 1);
    issue_ss(j, s, dp);
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    fence_regs(acc);
    if (t128 == 0) {
      mbar_arrive(rv.empty(j));
      mbar_arrive(rk.empty(j - 1));
    }
    ds_tile(j, s, dp);
  }
  wgmma_fence();
  issue_dq(n_kv - 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  if (t128 == 0) mbar_arrive(rk.empty(n_kv - 1));

  // dQ times scale through the warpgroup's rows of the Q tile
  store_rows(sm, sq, DQ_BQ, 64 * wg, acc, p.scale, p.scale, &mp.o0, wg_first, bh, wg, t128);
}

// ---------------------------------------------------------------------------
// K10 dK/dV. One block per (head, KV tile of 128 keys), two consumer
// warpgroups of 64 keys. K and V once; (Q_i, dO_i) tiles of 64 queries with
// their lse and D rows in one ring. The transposed tiles S^T = K Q_i^T and
// dP^T = V dO_i^T put P^T and dS^T in the A layout of dV += P^T dO_i and
// dK += dS^T Q_i.
__global__ void __launch_bounds__(384, 1) dkv_kernel(const __grid_constant__ Maps mp, const Args p) {
  constexpr int CONS = 256, KB = tile_bytes(DKV_BKV), QB = tile_bytes(DKV_BQ), SB = dkv_stage();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  const uint32_t sk = smem_u32(sm), sv = sk + KB, ring = sv + KB;
  const uint32_t bars = ring + DKV_STAGES * SB, kvbar = bars + 8 * 2 * DKV_STAGES;
  const Ring<DKV_STAGES> rq{bars};
  // a stage: Q_i, dO_i, then 64 lse values (times log2(e)) and 64 D values
  auto rows_of = [&](int i) { return reinterpret_cast<float*>(sm + 2 * KB + (i % DKV_STAGES) * SB + 2 * QB); };

  const int tid = threadIdx.x, bh = blockIdx.x, kt = blockIdx.y;  // kt = 0, which every Q tile sees, first
  const int k_first = kt * DKV_BKV;
  const int i0 = k_first / DKV_BQ, n_q = (p.T + DKV_BQ - 1) / DKV_BQ;  // Q tiles at or below the diagonal
  if (tid == 0) {
    int counts[2 * DKV_STAGES + 1];
    for (int i = 0; i < 2 * DKV_STAGES + 1; ++i) counts[i] = i < DKV_STAGES ? 33 : i < 2 * DKV_STAGES ? 2 : 1;
    init_barriers(bars, 2 * DKV_STAGES + 1, counts);
  }
  __syncthreads();

  if (tid >= CONS) {  // the producer warpgroup's first warp: lane 0 the TMA copies, every lane lse and D
    regs_dec<PRODUCER_REGS>();
    const int lane = tid - CONS;
    if (lane >= 32) return;
    if (lane == 0) {
      mbar_expect_tx(kvbar, 2 * KB);
      load_tile(sk, &mp.k, DKV_BKV, k_first, bh, kvbar);
      load_tile(sv, &mp.v, DKV_BKV, k_first, bh, kvbar);
    }
    const float* lb = p.lse + (size_t)bh * p.T;
    const float* db = p.dd + (size_t)bh * p.T;
    for (int i = i0; i < n_q; ++i) {
      const int n = i - i0;
      mbar_wait(rq.empty(n), rq.phase(n) ^ 1);
      if (lane == 0) {
        const uint32_t st = ring + (n % DKV_STAGES) * SB;
        mbar_expect_tx(rq.full(n), 2 * QB);
        load_tile(st, &mp.q, DKV_BQ, i * DKV_BQ, bh, rq.full(n));
        load_tile(st + QB, &mp.d, DKV_BQ, i * DKV_BQ, bh, rq.full(n));
      }
      float* rows = rows_of(n);
#pragma unroll
      for (int h = 0; h < DKV_BQ / 32; ++h) {
        const int c = lane + 32 * h, q = i * DKV_BQ + c;
        rows[c] = q < p.T ? lb[q] * LOG2E : 0.f;
        rows[DKV_BQ + c] = q < p.T ? db[q] : 0.f;
      }
      mbar_arrive(rq.full(n));  // each lane's stores, released to the consumers
    }
    return;
  }

  regs_inc<CONSUMER_REGS>();
  const int wg = tid / 128, t128 = tid % 128, lane = tid % 32, t = lane % 4;
  const int wg_last = k_first + 64 * wg + 63, kr0 = k_first + 64 * wg + 16 * (t128 / 32) + lane / 4;
  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(kvbar, 0);
  first_turn(wg);
  for (int i = i0; i < n_q; ++i) {
    const int n = i - i0;
    float s[32], dp[32];      // fresh each tile, as in K4
    uint32_t pa[16], sa[16];  // P^T and dS^T in bf16 (4 k-steps of 16 queries)
    const uint32_t qt = ring + (n % DKV_STAGES) * SB, dot = qt + QB;
    mbar_wait(rq.full(n), rq.phase(n));
    turn_wait(wg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HS / 16; ++kk)
      wgmma_ss<DKV_BQ>(s, desc_k(sk, DKV_BKV, 64 * wg, kk), desc_k(qt, DKV_BQ, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HS / 16; ++kk)
      wgmma_ss<DKV_BQ>(dp, desc_k(sv, DKV_BKV, 64 * wg, kk), desc_k(dot, DKV_BQ, 0, kk), kk > 0);
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    // P^T (query q sees key iff key <= q < T), dS^T = P^T (dP^T - D) in
    // place of dP^T; masks where the tile crosses the warpgroup's diagonal
    // or T
    const float* rows = rows_of(n);
    const int q0 = i * DKV_BQ;
    const bool edge = q0 < wg_last || q0 + DKV_BQ > p.T;
#pragma unroll
    for (int j = 0; j < DKV_BQ / 8; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 L = *reinterpret_cast<const float2*>(rows + c);
      const float2 D = *reinterpret_cast<const float2*>(rows + DKV_BQ + c);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = q0 + c + e;
        const bool out = q >= p.T;
        const float l = e ? L.y : L.x, d = e ? D.y : D.x;
        const float p0 = edge && (q < kr0 || out) ? 0.f : ex2(s[4 * j + e] * p.sl2 - l);
        const float p1 = edge && (q < kr0 + 8 || out) ? 0.f : ex2(s[4 * j + 2 + e] * p.sl2 - l);
        s[4 * j + e] = p0, s[4 * j + 2 + e] = p1;
        dp[4 * j + e] = p0 * (dp[4 * j + e] - d);
        dp[4 * j + 2 + e] = p1 * (dp[4 * j + 2 + e] - d);
      }
    }
    pack_a<DKV_BQ>(pa, s);
    pack_a<DKV_BQ>(sa, dp);
    turn_wait(wg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DKV_BQ / 16; ++kk) {
      wgmma_rs<HS>(dv, pa + 4 * kk, desc_mn(dot, DKV_BQ, kk));
      wgmma_rs<HS>(dk, sa + 4 * kk, desc_mn(qt, DKV_BQ, kk));
    }
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    if (t128 == 0) mbar_arrive(rq.empty(n));
  }

  // dK times scale and dV through the warpgroup's rows of the K and V tiles
  // (its last S^T and dP^T are done)
  const int k_wg = k_first + 64 * wg;
  store_rows(sm, sk, DKV_BKV, 64 * wg, dk, p.scale, p.scale, &mp.o0, k_wg, bh, wg, t128);
  store_rows(sm + KB, sv, DKV_BKV, 64 * wg, dv, 1.f, 1.f, &mp.o1, k_wg, bh, wg, t128);
}

// ---------------------------------------------------------------------------
// Host side: the tensor maps of (B * H, T, 128) bf16 tensors in boxes of 64
// head columns x `rows`, and the launches.

inline int tile_map(CUtensorMap* m, const void* base, int T, int BH, int rows) {
  return map_3d(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, HS, T, BH, PANEL, rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <typename K>
int prepare(K kernel, int smem) {
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// bq: the plan's query rows a block (64 or 128, ops/flash_attention.py flash_plan)
inline int forward(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int T, float scale,
                   int bq, cudaStream_t st) {
  if (bq != 64 && bq != 128) return (int)cudaErrorInvalidValue;
  Maps mp;
  int err = tile_map(&mp.q, q, T, B * H, bq);
  if (!err) err = tile_map(&mp.k, k, T, B * H, FWD_BKV);
  if (!err) err = tile_map(&mp.v, v, T, B * H, FWD_BKV);
  if (!err) err = tile_map(&mp.o0, o, T, B * H, 64);
  if (err) return err;
  mp.d = mp.o1 = mp.q;
  const int n_qt = (T + bq - 1) / bq;
  const Args a{(float*)lse, nullptr, T, n_qt, scale, scale * LOG2E};
  const dim3 grid(B * H, n_qt);
  if (bq == 64) {
    if ((err = prepare(fwd_kernel<1>, fwd_smem(64)))) return err;
    fwd_kernel<1><<<grid, fwd_threads<1>(), fwd_smem(64), st>>>(mp, a);
  } else {
    if ((err = prepare(fwd_kernel<2>, fwd_smem(128)))) return err;
    fwd_kernel<2><<<grid, fwd_threads<2>(), fwd_smem(128), st>>>(mp, a);
  }
  return (int)cudaGetLastError();
}

inline int backward_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* dd,
                       void* dq, int B, int H, int T, float scale, cudaStream_t st) {
  Maps mp;
  int err = tile_map(&mp.q, q, T, B * H, DQ_BQ);
  if (!err) err = tile_map(&mp.d, dout, T, B * H, DQ_BQ);
  if (!err) err = tile_map(&mp.k, k, T, B * H, DQ_BKV);
  if (!err) err = tile_map(&mp.v, v, T, B * H, DQ_BKV);
  if (!err) err = tile_map(&mp.o0, dq, T, B * H, 64);
  if (!err) err = prepare(dq_kernel, dq_smem());
  mp.o1 = mp.o0;
  if (err) return err;
  const int n_qt = (T + DQ_BQ - 1) / DQ_BQ;
  const Args a{(float*)lse, (const float*)dd, T, n_qt, scale, scale * LOG2E};
  dq_kernel<<<dim3(B * H, n_qt), 384, dq_smem(), st>>>(mp, a);
  return (int)cudaGetLastError();
}

inline int backward_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* dd,
                        void* dk, void* dv, int B, int H, int T, float scale, cudaStream_t st) {
  Maps mp;
  int err = tile_map(&mp.q, q, T, B * H, DKV_BQ);
  if (!err) err = tile_map(&mp.d, dout, T, B * H, DKV_BQ);
  if (!err) err = tile_map(&mp.k, k, T, B * H, DKV_BKV);
  if (!err) err = tile_map(&mp.v, v, T, B * H, DKV_BKV);
  if (!err) err = tile_map(&mp.o0, dk, T, B * H, 64);
  if (!err) err = tile_map(&mp.o1, dv, T, B * H, 64);
  if (!err) err = prepare(dkv_kernel, dkv_smem());
  if (err) return err;
  const int n_kt = (T + DKV_BKV - 1) / DKV_BKV;
  const Args a{(float*)lse, (const float*)dd, T, n_kt, scale, scale * LOG2E};
  dkv_kernel<<<dim3(B * H, n_kt), 384, dkv_smem(), st>>>(mp, a);
  return (int)cudaGetLastError();
}

}  // namespace fa90
