// K4 past head size 256 in bf16 on Hopper: wgmma, TMA and mbarrier rings, on
// the design of flash_sm90.cuh and flash_sm90_hs256.cuh. Included by
// flash_attention.cu, whose K4 entry sends bf16 at every head size past 256
// (a multiple of 128) here.
//
// Replaces lit_llama_tpu/ops/flash_attention.py _flash_kernel (entry
// _flash_forward) past head size 256.
//
// Bound on the H100: at the prefill lengths such heads see (T ~ 1024) the
// bytes (q, k, v read once, o written once) and the causal products (2 * 2
// * T * T/2 * hs a head) come out close; at (1, 8, 1024, 384 / 512) the
// bytes bound (7.5 / 10.0 us), the products 6.5 / 8.7 us.
//
// The constraint: a consumer warpgroup's 64-row f32 output over the whole
// head would take hs / 2 registers a thread (192 at 384, 256 at 512), and a
// KV tile of the whole head hs / 4 bytes a key. So
//  - the output's head columns are split over the grid in chunks of CHUNK =
//    256 columns, wgmma's largest N: a block per (head and chunk, Q tile of
//    128 rows), two consumer warpgroups of 64 rows and a producer warpgroup.
//    Each block computes the scores over the whole head, so with c chunks
//    the score product runs c times. A last chunk of 128 columns (hs % 256
//    == 128) runs its P V at 256, of which the last 128 are neither loaded
//    nor stored: 1.5x the products at 512, 1.67x at 384;
//  - Q and K stream as 64-column panels: a stage of the QK ring holds a
//    panel of the Q tile and the same panel of the KV tile, so shared memory
//    does not grow with hs. The scores of a tile are hs / 64 commit groups,
//    one a panel; a panel's stage is released as soon as its products are
//    done (wgmma_wait<1> after the next panel's), so the ring may hold fewer
//    panels than the head has. The chunk's V columns of a KV tile (four
//    panels) come through a ring of their own;
//  - no turns on the tensor cores: with the scores split into panels a
//    warpgroup may wait for a stage while it issues, and a stage is freed
//    only when both warpgroups are done with it, so each warpgroup goes at
//    its own pace;
//  - each warpgroup issues tile j + 1's scores before tile j's P V and runs
//    tile j + 1's softmax beside P V, as flash_sm90.cuh does, and visits
//    the KV tiles up to its own diagonal (warpgroup 0 lets the block's last
//    tile's panels pass through the ring unread);
//  - O goes out through shared memory (the QK ring, once both warpgroups
//    are done with it) and a TMA store a panel inside the head; the first
//    chunk's blocks write lse, which every chunk computes alike.
// Rounding and masks as flash_sm90_hs256.cuh's K4 (fa256::Online): f32 scores
// summed over the head's panels in order, the scale applied to the score,
// unnormalised P rounded to bf16 for P V, O divided by the row sum at the
// end, lse in f32. No atomics: a rerun repeats bit for bit.
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

}  // namespace fawide
