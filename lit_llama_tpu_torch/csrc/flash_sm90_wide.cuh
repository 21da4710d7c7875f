// K4 and K10 past head size 256 in bf16 on Hopper: wgmma, TMA and mbarrier
// rings, on the design of flash_sm90.cuh and flash_sm90_hs256.cuh. Included
// by flash_attention.cu, whose K4 and K10 entries send bf16 at every head
// size past 256 (a multiple of 128) here.
//
// Replaces lit_llama_tpu/ops/flash_attention.py _flash_kernel (K4, entry
// _flash_forward) and _flash_dq_kernel / _flash_dkv_kernel (K10, entry
// _flash_backward) past head size 256.
//
// Bound on the H100: at the prefill lengths such heads see (T ~ 1024) the
// bytes (q, k, v, o, dO read once, the outputs written once) and the causal
// products (2 * T * T/2 * hs a head each: two in the forward, three in dq,
// four in dK/dV) come out close; at (1, 8, 1024, 384 / 512) the forward's
// bytes bound (7.5 / 10.0 us), the products 6.5 / 8.7 us.
//
// The constraint: a consumer warpgroup's 64-row f32 output over the whole
// head would take hs / 2 registers a thread (192 at 384, 256 at 512), and a
// KV tile of the whole head hs / 4 bytes a key. So, in every kernel here,
//  - the output's head columns are split over the grid in chunks of CHUNK =
//    256 columns, wgmma's largest N: a block per (head and chunk, tile),
//    two consumer warpgroups of 64 rows and a producer warpgroup. Each block
//    computes the scores (and in K10 dP) over the whole head, so with c
//    chunks the score products run c times. A last chunk of 128 columns
//    (hs % 256 == 128) runs its output product at 256, of which the last 128
//    are neither loaded nor stored;
//  - the operands of the scores stream as 64-column panels: a stage of the
//    panel ring holds the same panel of every tile the scores read, so shared
//    memory does not grow with hs. A tile's scores are hs / 64 commit groups,
//    one a panel; a panel's stage is released as soon as its products are
//    done (wgmma_wait<1> after the next panel's), so the ring may hold fewer
//    panels than the head has. The chunk's columns of the output product's
//    other operand come through a ring of their own;
//  - no turns on the tensor cores: with the scores split into panels a
//    warpgroup may wait for a stage while it issues, and a stage is freed
//    only when both warpgroups are done with it, so each warpgroup goes at
//    its own pace;
//  - outputs go through shared memory (the panel ring, once both
//    warpgroups are done with it) and a TMA store a panel inside the head.
// K4 (fwd_kernel): a block per (head and chunk, Q tile of 128 rows); a stage
// holds a panel of the Q tile and of the KV tile, the V ring a KV tile's
// chunk of V. Each warpgroup issues tile j + 1's scores before tile j's P V
// and runs tile j + 1's softmax beside P V, as flash_sm90.cuh does, and
// visits the KV tiles up to its own diagonal (warpgroup 0 lets the block's
// last tile's panels pass through the ring unread); the first chunk's blocks
// write lse, which every chunk computes alike.
// K10 dq (dq_kernel): a block per (head and chunk, Q tile of 128 rows), as
// the hs-256 dq: each warpgroup holds its 64 x 256 dQ chunk (128 registers)
// beside S and dP (32 each). A stage holds a panel of Q, dO (128 rows), K_j
// and V_j (64 keys), so S and dP of a tile come from one chain of np stages;
// the chunk's columns of K_j come through a ring of their own. Tile j's dQ
// product is issued before tile j + 1's chain, whose first wait finds it done
// and releases its K chunk.
// K10 dK/dV (dkv_kernel): a block per (head and chunk, KV tile of 64 keys),
// on the hs-256 design (b): warpgroup 0 computes S^T = K Q_i^T and P^T and
// owns dV += P^T dO_i; warpgroup 1 computes dP^T = V dO_i^T and dS^T and owns
// dK += dS^T Q_i, taking P^T (f32) from warpgroup 0 through one of two
// mbarrier-guarded buffers. A stage holds a panel of K, Q_i (warpgroup 0's
// operands), V and dO_i (warpgroup 1's); the chunk stage Q_i's and dO_i's
// chunk of columns with the tile's lse and D rows, which the producer warp's
// lanes write beside the copies. As in dq, tile i's product is issued before
// tile i + 1's chain.
// Rounding and masks as flash_sm90_hs256.cuh (fa256::Online in K4; in K10 P =
// exp(S scale - lse) in f32, dS = P (dP - D), P^T and dS rounded to bf16 for
// their products, every sum in f32, the scale applied after the product in
// dq and dK): f32 scores summed over the head's panels in order. No atomics,
// and the tiles depend on hs alone: each output element is summed by one
// thread in tile order, so a rerun repeats bit for bit and a row's sums run
// in the same order at every B, H and T.
#pragma once

#include "flash_sm90_hs256.cuh"

namespace fawide {

using namespace sm90;
using fa90::Args;
using fa90::Maps;
using fa90::Ring;

constexpr int BQ = 128, BKV = 64;  // query rows a block (two consumer warpgroups), keys a KV tile
constexpr int CHUNK = 256;         // output columns a block
constexpr int QK_STAGES = 6, V_STAGES = 2;
constexpr int QK_STAGE = (BQ + BKV) * 128;  // a 64-column panel of the Q tile and of the KV tile
constexpr int V_TILE = BKV * CHUNK * 2;     // a KV tile's chunk of V: four panels of 64 keys x 128 bytes
constexpr int OUT_ROWS = 64;                // a warpgroup's rows of O, staged through the dead QK ring

// dynamic shared memory: alignment slack, the rings, their barriers
__host__ __device__ constexpr int fwd_smem() {
  return 1024 + QK_STAGES * QK_STAGE + V_STAGES * V_TILE + 2 * (QK_STAGES + V_STAGES) * 8;
}
static_assert(fwd_smem() <= fa90::MAX_SMEM, "K4's wide kernel exceeds 227 KB");
static_assert(QK_STAGES * QK_STAGE >= 2 * OUT_ROWS * CHUNK * 2, "O is staged through the QK ring");

// K10: dq takes 128 query rows a block against KV tiles of 64 keys, dK/dV 64
// keys a block against Q tiles of 64 rows; each streams its panels through a
// ring of *_STAGES stages. A dq stage: a 64-column panel of Q and dO (128
// rows) and of K_j and V_j (64 keys); a dK/dV stage: a panel of K, Q_i, V and
// dO_i (64 rows each)
constexpr int DQ_BQ = 128, DQ_BKV = 64, DQ_STAGES = 4, DQ_KC_STAGES = 1;
constexpr int DKV_BKV = 64, DKV_BQ = 64, DKV_STAGES = 4, DKV_PBUFS = 2;
constexpr int PANEL_ROW = fa90::PANEL * 2;  // bytes of a panel row: 64 bf16
constexpr int DQ_STAGE = (2 * DQ_BQ + 2 * DQ_BKV) * PANEL_ROW;
constexpr int KC_TILE = DQ_BKV * CHUNK * 2;  // a KV tile's chunk of K: four panels of 64 keys
constexpr int DKV_STAGE = (2 * DKV_BKV + 2 * DKV_BQ) * PANEL_ROW;
constexpr int DKV_CHUNK = 2 * DKV_BQ * CHUNK * 2 + 2 * DKV_BQ * 4;  // Q_i's and dO_i's chunk, its lse and D rows

__host__ __device__ constexpr int dq_smem() {
  return 1024 + DQ_STAGES * DQ_STAGE + DQ_KC_STAGES * KC_TILE + 2 * (DQ_STAGES + DQ_KC_STAGES) * 8;
}
__host__ __device__ constexpr int dkv_smem() {
  return 1024 + DKV_STAGES * DKV_STAGE + DKV_CHUNK + DKV_PBUFS * DKV_BKV * DKV_BQ * 4 +
         2 * (DKV_STAGES + 1 + DKV_PBUFS) * 8;
}
static_assert(dq_smem() <= fa90::MAX_SMEM && dkv_smem() <= fa90::MAX_SMEM, "a K10 wide kernel exceeds 227 KB");
static_assert(DQ_STAGES * DQ_STAGE >= 2 * OUT_ROWS * CHUNK * 2 && DKV_STAGES * DKV_STAGE >= 2 * DKV_BKV * CHUNK * 2,
              "the outputs are staged through the panel ring");

__global__ void __launch_bounds__(384, 1) fwd_kernel(const __grid_constant__ Maps mp, const Args p, int hs) {
  constexpr int CONS = 256;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = fa90::align1024(smem_raw);
  const uint32_t sqk = smem_u32(sm), sv = sqk + QK_STAGES * QK_STAGE, bars = sv + V_STAGES * V_TILE;
  const Ring<QK_STAGES> rqk{bars};
  const Ring<V_STAGES> rv{bars + 8 * 2 * QK_STAGES};

  const int n_chunks = (hs + CHUNK - 1) / CHUNK, np = hs / fa90::PANEL;  // np: panels of the head
  const int tid = threadIdx.x, bh = blockIdx.x / n_chunks, c0 = (blockIdx.x % n_chunks) * CHUNK;
  const int vp = min(hs - c0, CHUNK) / fa90::PANEL;  // the chunk's panels inside the head
  const int qt = p.n_tiles - 1 - blockIdx.y, q_first = qt * BQ;  // the last Q tile first
  const int n_kv = (min(q_first + BQ, p.T) + BKV - 1) / BKV;    // tiles up to the block's diagonal
  if (tid == 0) {
    constexpr int NB = 2 * (QK_STAGES + V_STAGES);
    int counts[NB];  // full: the producer; empty: both consumer warpgroups
    for (int i = 0; i < NB; ++i) counts[i] = (i / QK_STAGES == 1 || i >= 2 * QK_STAGES + V_STAGES) ? 2 : 1;
    fa90::init_barriers(bars, NB, counts);
  }
  __syncthreads();

  if (tid >= CONS) {  // the producer warpgroup: lane 0 of its first warp issues every copy
    fa90::regs_dec<fa90::PRODUCER_REGS>();
    if (tid == CONS) {
      for (int j = 0; j < n_kv; ++j) {
        for (int pp = 0; pp < np; ++pp) {  // tile j's panels of Q and K, then its chunk of V
          const int i = j * np + pp;
          const uint32_t st = sqk + (i % QK_STAGES) * QK_STAGE;
          mbar_wait(rqk.empty(i), rqk.phase(i) ^ 1);
          mbar_expect_tx(rqk.full(i), QK_STAGE);
          tma_3d(st, &mp.q, pp * fa90::PANEL, q_first, bh, rqk.full(i));
          tma_3d(st + BQ * 128, &mp.k, pp * fa90::PANEL, j * BKV, bh, rqk.full(i));
        }
        const uint32_t vt = sv + (j % V_STAGES) * V_TILE;
        mbar_wait(rv.empty(j), rv.phase(j) ^ 1);
        mbar_expect_tx(rv.full(j), vp * BKV * 128);
        for (int c = 0; c < vp; ++c) tma_3d(vt + c * BKV * 128, &mp.v, c0 + c * fa90::PANEL, j * BKV, bh, rv.full(j));
      }
    }
    return;
  }

  // a consumer warpgroup: rows wg_first ..; this thread rows r0, r0 + 8
  fa90::regs_inc<fa90::CONSUMER_REGS>();
  const int wg = tid / 128, t128 = tid % 128, lane = tid % 32, t = lane % 4;
  const int wg_first = q_first + 64 * wg, r0 = wg_first + 16 * (t128 / 32) + lane / 4;
  const int n_own = min(n_kv, wg_first / BKV + 1);  // the tiles up to this warpgroup's diagonal
  float o[128];
  uint32_t pa[16];  // P in bf16, the A operand of P V (4 k-steps of 16 keys)
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.f;
  fa256::Online sm_;

  // S = Q K_j^T over the head, a commit group a panel (4 k-steps of 16
  // columns): panel pp - 1's stage is released once panel pp is issued and
  // its own products are done; the caller releases the last panel's. Each
  // tile's scores go to a fresh array (as in flash_sm90.cuh), the first
  // panel peeled off so that its first product reads nothing before it
  auto issue_panel = [&](int i, float (&s)[32], int acc) {
    const uint32_t st = sqk + (i % QK_STAGES) * QK_STAGE;
    mbar_wait(rqk.full(i), rqk.phase(i));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<BKV>(s, fa90::desc_k(st, BQ, 64 * wg, kk), fa90::desc_k(st + BQ * 128, BKV, 0, kk), acc || kk > 0);
    wgmma_commit();
  };
  auto issue_s = [&](int j, float (&s)[32]) {
    issue_panel(j * np, s, 0);
    for (int i = j * np + 1; i < (j + 1) * np; ++i) {
      issue_panel(i, s, 1);
      wgmma_wait<1>();
      if (t128 == 0) mbar_arrive(rqk.empty(i - 1));
    }
  };
  auto issue_pv = [&](int j) {  // O[:, c0 ..] += P V_j: 4 k-steps of 16 keys, the chunk's 256 columns as N
    const uint32_t vt = sv + (j % V_STAGES) * V_TILE;
    mbar_wait(rv.full(j), rv.phase(j));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) wgmma_rs<CHUNK>(o, pa + 4 * kk, fa90::desc_mn(vt, BKV, kk));
    wgmma_commit();
  };

  {
    float s[32];
    issue_s(0, s);
    wgmma_wait<0>();
    fa90::fence_regs(s);
    if (t128 == 0) mbar_arrive(rqk.empty(np - 1));
    sm_.tile(s, n_own == 1, 2 * t, r0, p.sl2);
    fa90::pack_a<BKV>(pa, s);
  }
  for (int j = 0; j + 1 < n_own; ++j) {
    float s[32];
    issue_s(j + 1, s);
    issue_pv(j);
    wgmma_wait<1>();  // tile j + 1's scores; its softmax runs beside tile j's P V
    fa90::fence_regs(s);
    if (t128 == 0) mbar_arrive(rqk.empty((j + 2) * np - 1));
    sm_.tile(s, j + 2 == n_own, (j + 1) * BKV + 2 * t, r0, p.sl2);
    wgmma_wait<0>();
    fa90::fence_regs(o);
    if (t128 == 0) mbar_arrive(rv.empty(j));
    sm_.rescale(o);
    fa90::pack_a<BKV>(pa, s);
  }
  issue_pv(n_own - 1);
  wgmma_wait<0>();
  fa90::fence_regs(o);
  for (int i = n_own * np; i < n_kv * np; ++i) {  // warpgroup 0: the block's last tile, unread
    mbar_wait(rqk.full(i), rqk.phase(i));
    if (t128 == 0) mbar_arrive(rqk.empty(i));
  }

  float inv0, inv1;
  sm_.finish(inv0, inv1);
  asm volatile("bar.sync 5, 256;\n" ::: "memory");  // both consumer warpgroups are done with the QK ring
  const int off = wg * OUT_ROWS * CHUNK * 2;
  fa256::store_rows(sm + off, sqk + off, OUT_ROWS, 0, o, inv0, inv1, &mp.o0, wg_first, bh, wg, t128, c0, vp);
  if (c0 == 0) sm_.write_lse(p.lse + (size_t)bh * p.T, r0, p.T, t);
}

// ---------------------------------------------------------------------------
// K10 dq. One block per (head and chunk, Q tile of 128 rows): two consumer
// warpgroups of 64 rows and a producer warpgroup. D comes from the dot
// kernel of flash_attention.cu before the launch.
__global__ void __launch_bounds__(384, 1) dq_kernel(const __grid_constant__ Maps mp, const Args p, int hs) {
  constexpr int CONS = 256, QP = DQ_BQ * PANEL_ROW, KP = DQ_BKV * PANEL_ROW;  // a Q (dO) panel, a K (V) panel
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = fa90::align1024(smem_raw);
  const uint32_t ring = smem_u32(sm), skc = ring + DQ_STAGES * DQ_STAGE, bars = skc + DQ_KC_STAGES * KC_TILE;
  const Ring<DQ_STAGES> rp{bars};
  const Ring<DQ_KC_STAGES> rk{bars + 8 * 2 * DQ_STAGES};

  const int n_chunks = (hs + CHUNK - 1) / CHUNK, np = hs / fa90::PANEL;  // np: panels of the head
  const int tid = threadIdx.x, bh = blockIdx.x / n_chunks, c0 = (blockIdx.x % n_chunks) * CHUNK;
  const int vp = min(hs - c0, CHUNK) / fa90::PANEL;  // the chunk's panels inside the head
  const int qt = p.n_tiles - 1 - blockIdx.y, q_first = qt * DQ_BQ;  // the last Q tile first
  const int n_kv = (min(q_first + DQ_BQ, p.T) + DQ_BKV - 1) / DQ_BKV;  // tiles up to the block's diagonal
  if (tid == 0) {
    constexpr int NB = 2 * (DQ_STAGES + DQ_KC_STAGES);
    int counts[NB];  // full: the producer; empty: both consumer warpgroups
    for (int i = 0; i < NB; ++i) counts[i] = (i / DQ_STAGES == 1 || i >= 2 * DQ_STAGES + DQ_KC_STAGES) ? 2 : 1;
    fa90::init_barriers(bars, NB, counts);
  }
  __syncthreads();

  if (tid >= CONS) {  // the producer warpgroup: lane 0 of its first warp issues every copy
    fa90::regs_dec<fa90::PRODUCER_REGS>();
    if (tid == CONS) {
      for (int j = 0; j < n_kv; ++j) {
        for (int pp = 0; pp < np; ++pp) {  // panel pp of Q, dO, K_j and V_j
          const int i = j * np + pp, c = pp * fa90::PANEL;
          const uint32_t st = ring + (i % DQ_STAGES) * DQ_STAGE;
          mbar_wait(rp.empty(i), rp.phase(i) ^ 1);
          mbar_expect_tx(rp.full(i), DQ_STAGE);
          tma_3d(st, &mp.q, c, q_first, bh, rp.full(i));
          tma_3d(st + QP, &mp.d, c, q_first, bh, rp.full(i));
          tma_3d(st + 2 * QP, &mp.k, c, j * DQ_BKV, bh, rp.full(i));
          tma_3d(st + 2 * QP + KP, &mp.v, c, j * DQ_BKV, bh, rp.full(i));
        }
        const uint32_t kt = skc + (j % DQ_KC_STAGES) * KC_TILE;  // then the chunk's columns of K_j
        mbar_wait(rk.empty(j), rk.phase(j) ^ 1);
        mbar_expect_tx(rk.full(j), vp * KP);
        for (int c = 0; c < vp; ++c) tma_3d(kt + c * KP, &mp.k, c0 + c * fa90::PANEL, j * DQ_BKV, bh, rk.full(j));
      }
    }
    return;
  }

  // a consumer warpgroup: rows wg_first ..; this thread rows r0, r0 + 8
  fa90::regs_inc<fa90::CONSUMER_REGS>();
  const int wg = tid / 128, t128 = tid % 128, lane = tid % 32, t = lane % 4;
  const int wg_first = q_first + 64 * wg, r0 = wg_first + 16 * (t128 / 32) + lane / 4;
  const int n_own = min(n_kv, wg_first / DQ_BKV + 1);  // the tiles up to this warpgroup's diagonal
  const float* lb = p.lse + (size_t)bh * p.T;
  const float* db = p.dd + (size_t)bh * p.T;
  const float L0 = r0 < p.T ? lb[r0] * fa90::LOG2E : 0.f, L1 = r0 + 8 < p.T ? lb[r0 + 8] * fa90::LOG2E : 0.f;
  const float D0 = r0 < p.T ? db[r0] : 0.f, D1 = r0 + 8 < p.T ? db[r0 + 8] : 0.f;
  float acc[128];
  uint32_t da[16];  // dS in bf16, the A operand of dS K_j (4 k-steps of 16 keys)
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  // stage i's panel of S = Q K_j^T and of dP = dO V_j^T, one commit group
  auto issue_panel = [&](int i, float (&s)[32], float (&dp)[32], int acc_) {
    const uint32_t st = ring + (i % DQ_STAGES) * DQ_STAGE, kv = st + 2 * QP;
    mbar_wait(rp.full(i), rp.phase(i));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<DQ_BKV>(s, fa90::desc_k(st, DQ_BQ, 64 * wg, kk), fa90::desc_k(kv, DQ_BKV, 0, kk), acc_ || kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<DQ_BKV>(dp, fa90::desc_k(st + QP, DQ_BQ, 64 * wg, kk), fa90::desc_k(kv + KP, DQ_BKV, 0, kk),
                       acc_ || kk > 0);
    wgmma_commit();
  };
  // S and dP of tile j over the head, each into a fresh array, the first
  // panel peeled off (as K4 above): panel i - 1's stage is released once
  // panel i is issued and its own products are done. The first wait also
  // finds tile j - 1's dQ product, issued just before, done: its K chunk goes
  auto issue_sdp = [&](int j, float (&s)[32], float (&dp)[32]) {
    issue_panel(j * np, s, dp, 0);
    for (int i = j * np + 1; i < (j + 1) * np; ++i) {
      issue_panel(i, s, dp, 1);
      wgmma_wait<1>();
      if (t128 == 0) {
        mbar_arrive(rp.empty(i - 1));
        if (i == j * np + 1 && j > 0) mbar_arrive(rk.empty(j - 1));
      }
    }
    wgmma_wait<0>();
    fa90::fence_regs(s);
    fa90::fence_regs(dp);
    if (t128 == 0) mbar_arrive(rp.empty((j + 1) * np - 1));
  };

  for (int j = 0; j < n_own; ++j) {
    float s[32], dp[32];
    issue_sdp(j, s, dp);
    // P = exp(S scale - lse), masked where the tile crosses the warpgroup's
    // diagonal; dS = P (dP - D), rounded into da
    const int k0 = j * DQ_BKV;
    const bool diag = k0 + DQ_BKV - 1 > wg_first;
#pragma unroll
    for (int i = 0; i < DQ_BKV / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * i + 2 * t + e;
        const float p0 = diag && key > r0 ? 0.f : fa90::ex2(s[4 * i + e] * p.sl2 - L0);
        const float p1 = diag && key > r0 + 8 ? 0.f : fa90::ex2(s[4 * i + 2 + e] * p.sl2 - L1);
        s[4 * i + e] = p0 * (dp[4 * i + e] - D0);
        s[4 * i + 2 + e] = p1 * (dp[4 * i + 2 + e] - D1);
      }
    fa90::pack_a<DQ_BKV>(da, s);
    // dQ[:, c0 ..] += bf16(dS) K_j: the chunk's 256 columns of K_j as the MN-major B
    const uint32_t kt = skc + (j % DQ_KC_STAGES) * KC_TILE;
    mbar_wait(rk.full(j), rk.phase(j));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQ_BKV / 16; ++kk) wgmma_rs<CHUNK>(acc, da + 4 * kk, fa90::desc_mn(kt, DQ_BKV, kk));
    wgmma_commit();
  }
  wgmma_wait<0>();
  fa90::fence_regs(acc);
  if (t128 == 0) mbar_arrive(rk.empty(n_own - 1));
  for (int i = n_own * np; i < n_kv * np; ++i) {  // warpgroup 0: the block's last tile, unread
    mbar_wait(rp.full(i), rp.phase(i));
    if (t128 == 0) mbar_arrive(rp.empty(i));
  }

  // dQ times scale through the panel ring, once both warpgroups are done with it
  asm volatile("bar.sync 5, 256;\n" ::: "memory");
  const int off = wg * OUT_ROWS * CHUNK * 2;
  fa256::store_rows(sm + off, ring + off, OUT_ROWS, 0, acc, p.scale, p.scale, &mp.o0, wg_first, bh, wg, t128, c0,
                    vp);
}

// ---------------------------------------------------------------------------
// K10 dK/dV. One block per (head and chunk, KV tile of 64 keys): warpgroup 0
// computes P^T and dV, warpgroup 1 dS^T and dK (above); a producer warpgroup
// whose first warp's lane 0 issues the copies and whose 32 lanes write each
// Q tile's lse and D rows.
__global__ void __launch_bounds__(384, 1) dkv_kernel(const __grid_constant__ Maps mp, const Args p, int hs) {
  constexpr int CONS = 256, PP = DKV_BQ * PANEL_ROW;  // a panel of 64 rows
  constexpr int CT = DKV_BQ * CHUNK * 2;              // Q_i's (dO_i's) chunk of columns
  constexpr int PB = DKV_BKV * DKV_BQ * 4;            // a P^T buffer
  constexpr int C_OFF = DKV_STAGES * DKV_STAGE, P_OFF = C_OFF + DKV_CHUNK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = fa90::align1024(smem_raw);
  const uint32_t ring = smem_u32(sm), sc = ring + C_OFF, bars = ring + P_OFF + DKV_PBUFS * PB;
  const Ring<DKV_STAGES> rp{bars};
  const Ring<1> rc{bars + 8 * 2 * DKV_STAGES};
  const Ring<DKV_PBUFS> pb{bars + 8 * 2 * (DKV_STAGES + 1)};
  float* rows = reinterpret_cast<float*>(sm + C_OFF + 2 * CT);  // 64 lse values (times log2(e)), then 64 D values
  auto pbuf = [&](int n) { return reinterpret_cast<float4*>(sm + P_OFF + (n % DKV_PBUFS) * PB); };

  const int n_chunks = (hs + CHUNK - 1) / CHUNK, np = hs / fa90::PANEL;
  const int tid = threadIdx.x, bh = blockIdx.x / n_chunks, c0 = (blockIdx.x % n_chunks) * CHUNK;
  const int vp = min(hs - c0, CHUNK) / fa90::PANEL;
  const int k_first = blockIdx.y * DKV_BKV;  // the first KV tile, which every Q tile sees, first
  const int i0 = k_first / DKV_BQ, n_q = (p.T + DKV_BQ - 1) / DKV_BQ;  // Q tiles at or below the diagonal
  if (tid == 0) {
    constexpr int NB = 2 * (DKV_STAGES + 1 + DKV_PBUFS);
    int counts[NB];  // ring: full the TMA, empty both warpgroups; chunk: full the TMA and 32 lanes' rows, empty
    for (int i = 0; i < NB; ++i)  // both warpgroups; P^T: 128 threads
      counts[i] = i < DKV_STAGES ? 1 : i < 2 * DKV_STAGES ? 2 : i == 2 * DKV_STAGES ? 33 : i == 2 * DKV_STAGES + 1 ? 2 : 128;
    fa90::init_barriers(bars, NB, counts);
  }
  __syncthreads();

  if (tid >= CONS) {
    fa90::regs_dec<fa90::PRODUCER_REGS>();
    const int lane = tid - CONS;
    if (lane >= 32) return;
    const float* lb = p.lse + (size_t)bh * p.T;
    const float* db = p.dd + (size_t)bh * p.T;
    for (int i = i0; i < n_q; ++i) {
      const int n = i - i0;
      if (lane == 0)
        for (int pp = 0; pp < np; ++pp) {  // panel pp of K, Q_i, V and dO_i
          const int g = n * np + pp, c = pp * fa90::PANEL;
          const uint32_t st = ring + (g % DKV_STAGES) * DKV_STAGE;
          mbar_wait(rp.empty(g), rp.phase(g) ^ 1);
          mbar_expect_tx(rp.full(g), DKV_STAGE);
          tma_3d(st, &mp.k, c, k_first, bh, rp.full(g));
          tma_3d(st + PP, &mp.q, c, i * DKV_BQ, bh, rp.full(g));
          tma_3d(st + 2 * PP, &mp.v, c, k_first, bh, rp.full(g));
          tma_3d(st + 3 * PP, &mp.d, c, i * DKV_BQ, bh, rp.full(g));
        }
      // then Q_i's and dO_i's chunk of columns, with the tile's lse and D rows
      mbar_wait(rc.empty(n), rc.phase(n) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(rc.full(n), 2 * vp * PP);
        for (int c = 0; c < vp; ++c) {
          tma_3d(sc + c * PP, &mp.q, c0 + c * fa90::PANEL, i * DKV_BQ, bh, rc.full(n));
          tma_3d(sc + CT + c * PP, &mp.d, c0 + c * fa90::PANEL, i * DKV_BQ, bh, rc.full(n));
        }
      }
#pragma unroll
      for (int h = 0; h < DKV_BQ / 32; ++h) {
        const int c = lane + 32 * h, q = i * DKV_BQ + c;
        rows[c] = q < p.T ? lb[q] * fa90::LOG2E : 0.f;
        rows[DKV_BQ + c] = q < p.T ? db[q] : 0.f;
      }
      mbar_arrive(rc.full(n));  // each lane's stores, released to the consumers
    }
    return;
  }

  fa90::regs_inc<fa90::CONSUMER_REGS>();
  const int wg = tid / 128, t128 = tid % 128, lane = tid % 32, t = lane % 4;
  const int kr0 = k_first + 16 * (t128 / 32) + lane / 4;  // this thread's keys kr0, kr0 + 8
  float acc[128];  // dV (warpgroup 0) or dK (warpgroup 1)
  uint32_t a[16];  // P^T or dS^T in bf16, the A operand of the product (4 k-steps of 16 queries)
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  // stage g's panel of S^T = K Q_i^T (warpgroup 0) or dP^T = V dO_i^T (1)
  auto issue_panel = [&](int g, float (&s)[32], int acc_) {
    const uint32_t st = ring + (g % DKV_STAGES) * DKV_STAGE + wg * 2 * PP;
    mbar_wait(rp.full(g), rp.phase(g));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<DKV_BQ>(s, fa90::desc_k(st, DKV_BKV, 0, kk), fa90::desc_k(st + PP, DKV_BQ, 0, kk), acc_ || kk > 0);
    wgmma_commit();
  };
  // Q tile n's chain over the head, as dq's: the first wait finds tile n - 1's
  // product done, and the chunk stage goes
  auto issue_chain = [&](int n, float (&s)[32]) {
    issue_panel(n * np, s, 0);
    for (int g = n * np + 1; g < (n + 1) * np; ++g) {
      issue_panel(g, s, 1);
      wgmma_wait<1>();
      if (t128 == 0) {
        mbar_arrive(rp.empty(g - 1));
        if (g == n * np + 1 && n > 0) mbar_arrive(rc.empty(n - 1));
      }
    }
    wgmma_wait<0>();
    fa90::fence_regs(s);
    if (t128 == 0) mbar_arrive(rp.empty((n + 1) * np - 1));
  };

  const int n_tiles = n_q - i0;
  for (int n = 0; n < n_tiles; ++n) {
    const int q0 = (i0 + n) * DKV_BQ;
    float s[32];
    issue_chain(n, s);
    mbar_wait(rc.full(n), rc.phase(n));  // the chunk stage and its rows
    if (wg == 0) {  // P^T (query q sees key iff key <= q < T), handed to warpgroup 1 in f32
      const bool edge = q0 < k_first + DKV_BKV - 1 || q0 + DKV_BQ > p.T;  // crosses the diagonal or T
#pragma unroll
      for (int j = 0; j < DKV_BQ / 8; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 l = *reinterpret_cast<const float2*>(rows + c);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = q0 + c + e;
          const bool out = q >= p.T;
          const float le = e ? l.y : l.x;
          s[4 * j + e] = edge && (q < kr0 || out) ? 0.f : fa90::ex2(s[4 * j + e] * p.sl2 - le);
          s[4 * j + 2 + e] = edge && (q < kr0 + 8 || out) ? 0.f : fa90::ex2(s[4 * j + 2 + e] * p.sl2 - le);
        }
      }
      mbar_wait(pb.empty(n), pb.phase(n) ^ 1);
      float4* pw = pbuf(n) + t128;
#pragma unroll
      for (int j = 0; j < DKV_BQ / 8; ++j) pw[128 * j] = make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
      mbar_arrive(pb.full(n));  // each thread's stores, released to warpgroup 1
    } else {  // dS^T = P^T (dP^T - D): P^T as warpgroup 0 holds it, the same thread, the same slots
      const float* D = rows + DKV_BQ;
      mbar_wait(pb.full(n), pb.phase(n));
      const float4* pr = pbuf(n) + t128;
#pragma unroll
      for (int j = 0; j < DKV_BQ / 8; ++j) {
        const float4 pv = pr[128 * j];
        const float2 d = *reinterpret_cast<const float2*>(D + 8 * j + 2 * t);
        s[4 * j] = pv.x * (s[4 * j] - d.x);
        s[4 * j + 1] = pv.y * (s[4 * j + 1] - d.y);
        s[4 * j + 2] = pv.z * (s[4 * j + 2] - d.x);
        s[4 * j + 3] = pv.w * (s[4 * j + 3] - d.y);
      }
      mbar_arrive(pb.empty(n));
    }
    fa90::pack_a<DKV_BQ>(a, s);
    // dV[:, c0 ..] += bf16(P^T) dO_i (warpgroup 0), dK[:, c0 ..] += bf16(dS^T) Q_i (1)
    const uint32_t b = wg == 0 ? sc + CT : sc;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DKV_BQ / 16; ++kk) wgmma_rs<CHUNK>(acc, a + 4 * kk, fa90::desc_mn(b, DKV_BQ, kk));
    wgmma_commit();
  }
  wgmma_wait<0>();
  fa90::fence_regs(acc);
  if (t128 == 0) mbar_arrive(rc.empty(n_tiles - 1));

  // dV, and dK times scale, through the panel ring once both warpgroups are done with it
  asm volatile("bar.sync 5, 256;\n" ::: "memory");
  const int off = wg * DKV_BKV * CHUNK * 2;
  fa256::store_rows(sm + off, ring + off, DKV_BKV, 0, acc, wg ? p.scale : 1.f, wg ? p.scale : 1.f,
                    wg ? &mp.o0 : &mp.o1, k_first, bh, wg, t128, c0, vp);
}

// Host side: tensor maps of (B * H, T, hs) bf16 tensors in boxes of 64 head
// columns x rows, and the launch: blockIdx.x the (head, chunk) pairs,
// blockIdx.y the Q tiles from the last, so the heaviest blocks go first.
inline int tile_map(CUtensorMap* m, const void* base, int hs, int T, int BH, int rows) {
  return map_3d(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, hs, T, BH, fa90::PANEL, rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

inline int forward(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int T, int hs,
                   float scale, cudaStream_t st) {
  if (hs <= 256 || hs % 128) return (int)cudaErrorInvalidValue;
  Maps mp;
  int err = tile_map(&mp.q, q, hs, T, B * H, BQ);
  if (!err) err = tile_map(&mp.k, k, hs, T, B * H, BKV);
  if (!err) err = tile_map(&mp.v, v, hs, T, B * H, BKV);
  if (!err) err = tile_map(&mp.o0, o, hs, T, B * H, OUT_ROWS);
  if (!err) err = fa90::prepare(fwd_kernel, fwd_smem());
  if (err) return err;
  mp.d = mp.o1 = mp.q;
  const int n_qt = (T + BQ - 1) / BQ, n_chunks = (hs + CHUNK - 1) / CHUNK;
  const Args a{(float*)lse, nullptr, T, n_qt, scale, scale * fa90::LOG2E};
  fawide::fwd_kernel<<<dim3(B * H * n_chunks, n_qt), 384, fwd_smem(), st>>>(mp, a, hs);
  return (int)cudaGetLastError();
}

// K10's launches, D already in dd: blockIdx.x the (head, chunk) pairs,
// blockIdx.y the Q tiles from the last (dq) or the KV tiles from the first
// (dK/dV), so the heaviest blocks go first.
inline int backward_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* dd,
                       void* dq, int B, int H, int T, int hs, float scale, cudaStream_t st) {
  if (hs <= 256 || hs % 128) return (int)cudaErrorInvalidValue;
  Maps mp;
  int err = tile_map(&mp.q, q, hs, T, B * H, DQ_BQ);
  if (!err) err = tile_map(&mp.d, dout, hs, T, B * H, DQ_BQ);
  if (!err) err = tile_map(&mp.k, k, hs, T, B * H, DQ_BKV);
  if (!err) err = tile_map(&mp.v, v, hs, T, B * H, DQ_BKV);
  if (!err) err = tile_map(&mp.o0, dq, hs, T, B * H, OUT_ROWS);
  if (!err) err = fa90::prepare(dq_kernel, dq_smem());
  if (err) return err;
  mp.o1 = mp.o0;
  const int n_qt = (T + DQ_BQ - 1) / DQ_BQ, n_chunks = (hs + CHUNK - 1) / CHUNK;
  const Args a{(float*)lse, (const float*)dd, T, n_qt, scale, scale * fa90::LOG2E};
  fawide::dq_kernel<<<dim3(B * H * n_chunks, n_qt), 384, dq_smem(), st>>>(mp, a, hs);
  return (int)cudaGetLastError();
}

inline int backward_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* dd,
                        void* dk, void* dv, int B, int H, int T, int hs, float scale, cudaStream_t st) {
  if (hs <= 256 || hs % 128) return (int)cudaErrorInvalidValue;
  Maps mp;
  int err = tile_map(&mp.q, q, hs, T, B * H, DKV_BQ);
  if (!err) err = tile_map(&mp.d, dout, hs, T, B * H, DKV_BQ);
  if (!err) err = tile_map(&mp.k, k, hs, T, B * H, DKV_BKV);
  if (!err) err = tile_map(&mp.v, v, hs, T, B * H, DKV_BKV);
  if (!err) err = tile_map(&mp.o0, dk, hs, T, B * H, DKV_BKV);
  if (!err) err = tile_map(&mp.o1, dv, hs, T, B * H, DKV_BKV);
  if (!err) err = fa90::prepare(dkv_kernel, dkv_smem());
  if (err) return err;
  const int n_kt = (T + DKV_BKV - 1) / DKV_BKV, n_chunks = (hs + CHUNK - 1) / CHUNK;
  const Args a{(float*)lse, (const float*)dd, T, n_kt, scale, scale * fa90::LOG2E};
  fawide::dkv_kernel<<<dim3(B * H * n_chunks, n_kt), 384, dkv_smem(), st>>>(mp, a, hs);
  return (int)cudaGetLastError();
}

}  // namespace fawide
