// K4 and K10 at head size 256 in bf16 on Hopper: wgmma, TMA and mbarrier
// rings, on the design of flash_sm90.cuh (which stays at head size 128).
// Included by flash_attention.cu, whose entries send bf16 at head size 256
// here; flash_sm90_wide.cuh (K4 and K10 past 256) builds on this file's
// helpers.
//
// Replaces lit_llama_tpu/ops/flash_attention.py _flash_kernel (K4, entry
// _flash_forward) and _flash_dq_kernel / _flash_dkv_kernel (K10, entry
// _flash_backward) at head size 256.
//
// Bound on the H100: the causal products, 2 * T * T/2 * 256 a head each (two
// in the forward, three in dq, four in dK/dV), against the bytes (q, k, v, o,
// dO read once, the outputs written once): at T = 2048 the tensor cores
// bound every kernel (34.8 / 52.1 / 69.5 us at (1, 16, 2048, 256) and 989
// TF/s).
//
// What head size 256 changes against flash_sm90.cuh. A warpgroup's 64 x 256
// f32 accumulator takes 128 registers a thread, and a (rows x 256) bf16 tile
// is four 64-column panels of rows x 128 bytes (the 128-byte swizzle, read by
// the same descriptors: desc_k's panel is kk / 4, desc_mn's panel stride the
// LBO). Shared memory (232,448 bytes a block) holds half as many rows.
//  - K4: a block per (head, Q tile of 64 WGS rows), WGS = 1 or 2 consumer
//    warpgroups of 64 rows (ops/flash_attention.py flash_plan picks WGS as
//    at head size 128). Q stays (32 KB a warpgroup); K and V come in tiles
//    of 64 keys (32 KB: a 128-key tile, as head size 128 takes, would leave
//    no room for a second stage), each through a ring of two stages. A
//    warpgroup holds O (128 registers) beside S (64 x 64 f32, 32) and P in
//    bf16 (16), and issues tile j + 1's S before tile j's P V, as
//    flash_sm90.cuh does; the two consumer warpgroups take turns on the
//    tensor cores. A warpgroup visits the KV tiles up to its own diagonal,
//    so the 64 keys past warpgroup 0's rows are no work of its (it takes its
//    last turn empty). The KV tile is 64 keys under either plan, so a query
//    row takes the same steps, and gets the same bits, whichever plan its
//    shape picks. O goes out through the warpgroup's rows of the Q tile and
//    a TMA store a panel.
//  - dq: a block per (head, Q tile of 128 rows), two consumer warpgroups of
//    64 rows, each holding dQ (128 registers) beside S and dP (64 x 64, 32
//    each). Q and dO take 128 KB, so K and V of a 64-key tile stream through
//    rings of their own: two K stages, one V stage (96 KB). Each tile is two
//    turns on the tensor cores: S and dP, then (after dS) dQ += dS K_j. V_j
//    is released after the first, K_j after the second, so the V ring's one
//    stage refills while dS and dQ run, and K_j + 1 is in flight a whole tile
//    ahead.
//  - dK/dV: a warpgroup cannot hold both dK and dV (256 registers a thread
//    for a 64-key tile). A block per (head, KV tile of 64 keys) with two
//    consumer warpgroups that split the work, not the columns: warpgroup 0
//    computes S^T = K Q_i^T and P^T and owns dV += P^T dO_i; warpgroup 1
//    computes dP^T = V dO_i^T and owns dK += dS^T Q_i, taking P^T (f32, as
//    dS = P (dP - D) needs) from warpgroup 0 through one of two 16 KB
//    exchange buffers (full and empty mbarriers). Each warpgroup runs two
//    products of equal size a Q tile, and one's softmax or dS runs beside the
//    other's products. No product is computed twice (splitting the head's
//    columns instead would sum the halves of S^T and dP^T through shared
//    memory both ways; splitting them over the grid would compute S^T and
//    dP^T twice, 1.5x the products). K and V (64 KB) stay; (Q_i, dO_i)
//    tiles of 64 queries come through a ring of two stages (128 KB) with
//    their lse and D rows beside.
// Rounding as the Pallas kernels and flash_sm90.cuh: f32 scores, the scale
// applied to the score, unnormalised P rounded to bf16 for P V and dV, O
// divided by the row sum at the end, dS rounded for dQ and dK, every sum in
// f32, scale applied after the product in dq and dK, lse and D in f32; exp
// is ex2.approx of the score in units of log2(e). No atomics: each output
// element is summed by one thread in tile order, so a rerun repeats bit for
// bit.
#pragma once

#include "flash_sm90.cuh"

namespace fa256 {

using namespace sm90;
using fa90::Args;
using fa90::Maps;
using fa90::Ring;

constexpr int HS = 256;
constexpr int PANELS = HS / fa90::PANEL;  // 64-column panels of a tile
constexpr int FWD_BKV = 64, FWD_KSTAGES = 2, FWD_VSTAGES = 2;  // K4: keys a KV tile under every plan
constexpr int DQ_BQ = 128, DQ_BKV = 64, DQ_KSTAGES = 2, DQ_VSTAGES = 1;
constexpr int DKV_BKV = 64, DKV_BQ = 64, DKV_STAGES = 2, DKV_PBUFS = 2;

// bytes of a (rows x 256) bf16 tile: four panels of rows x 128 bytes
__host__ __device__ constexpr int tile_bytes(int rows) { return rows * HS * 2; }

// dynamic shared memory: alignment slack, tiles, barriers
__host__ __device__ constexpr int fwd_smem(int bq) {
  return 1024 + tile_bytes(bq) + (FWD_KSTAGES + FWD_VSTAGES) * tile_bytes(FWD_BKV) +
         (2 * (FWD_KSTAGES + FWD_VSTAGES) + 1) * 8;
}
__host__ __device__ constexpr int dq_smem() {
  return 1024 + 2 * tile_bytes(DQ_BQ) + (DQ_KSTAGES + DQ_VSTAGES) * tile_bytes(DQ_BKV) +
         (2 * (DQ_KSTAGES + DQ_VSTAGES) + 1) * 8;
}
// K and V, the (Q_i, dO_i) ring, the P^T buffers (f32), each stage's lse and D rows
__host__ __device__ constexpr int dkv_smem() {
  return 1024 + 2 * tile_bytes(DKV_BKV) + DKV_STAGES * 2 * tile_bytes(DKV_BQ) + DKV_PBUFS * DKV_BKV * DKV_BQ * 4 +
         DKV_STAGES * 2 * DKV_BQ * 4 + (2 * DKV_STAGES + 2 * DKV_PBUFS + 1) * 8;
}
static_assert(fwd_smem(128) <= fa90::MAX_SMEM && dq_smem() <= fa90::MAX_SMEM && dkv_smem() <= fa90::MAX_SMEM,
              "an hs-256 kernel exceeds 227 KB");

// the four panels of a (rows x 256) box at row r of head bh, completing on bar
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* m, int rows, int r, int bh, uint32_t bar) {
#pragma unroll
  for (int c = 0; c < PANELS; ++c) tma_3d(dst + c * rows * 128, m, c * fa90::PANEL, r, bh, bar);
}

// A warpgroup's 64 output rows (the f32 accumulator times mul0 for the
// thread's row r, mul1 for r + 8) to head bh, rows row0.. and columns c0..
// of the tensor map, through rows r_off.. of a dead (rows x 256) tile at
// `tile` (as fa90::store_rows, four panels; only the first `panels` go out)
__device__ __forceinline__ void store_rows(unsigned char* tile_ptr, uint32_t tile, int rows, int r_off,
                                           const float (&acc)[128], float mul0, float mul1, const CUtensorMap* m,
                                           int row0, int bh, int wg, int t128, int c0 = 0, int panels = PANELS) {
  const int lane = t128 % 32, t = lane % 4, r = 16 * (t128 / 32) + lane / 4;
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
  fence_proxy_async();
  warpgroup_sync(wg);
  if (t128 == 0) {
    for (int c = 0; c < panels; ++c)
      fa90::tma_store_3d(m, tile + c * rows * 128 + r_off * 128, c0 + c * fa90::PANEL, row0, bh);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// A consumer thread's online softmax over 64-key tiles (K4 here and in
// flash_sm90_wide.cuh), as flash_sm90.cuh's forward keeps it for its rows r0
// and r0 + 8: the running max m (in units of log2(e)), the thread's part of
// the row sum l (the quad's parts are summed at the end), and a, which
// rescales what was summed before the last tile.
struct Online {
  float m0 = LLT_NEG_INF, m1 = LLT_NEG_INF, l0 = 0.f, l1 = 0.f, a0 = 0.f, a1 = 0.f;

  // tile scores s (64 rows x 64 keys from k0, the wgmma accumulator) ->
  // unnormalised P in place. Only the diagonal tile masks (keys past the row,
  // or past T); the scale is folded into the exponent's FFMA
  __device__ __forceinline__ void tile(float (&s)[32], bool diag, int k0, int r0, float sl2) {
    float x0 = LLT_NEG_INF, x1 = LLT_NEG_INF;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * i + e;
        if (diag && key > r0) s[4 * i + e] = LLT_NEG_INF;
        if (diag && key > r0 + 8) s[4 * i + 2 + e] = LLT_NEG_INF;
        x0 = fmaxf(x0, s[4 * i + e]), x1 = fmaxf(x1, s[4 * i + 2 + e]);
      }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {  // a row's 64 keys lie on the 4 lanes of a quad
      x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, x));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, x));
    }
    const float mt0 = fmaxf(m0, x0 * sl2), mt1 = fmaxf(m1, x1 * sl2);
    a0 = fa90::ex2(m0 - mt0), a1 = fa90::ex2(m1 - mt1);
    m0 = mt0, m1 = mt1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * i + e] = fa90::ex2(fmaf(s[4 * i + e], sl2, -m0));
        s[4 * i + 2 + e] = fa90::ex2(fmaf(s[4 * i + 2 + e], sl2, -m1));
        ls0 += s[4 * i + e], ls1 += s[4 * i + 2 + e];
      }
    l0 = l0 * a0 + ls0;
    l1 = l1 * a1 + ls1;
  }
  // O (64 x 256 f32) times a, before the last tile's P V adds to it
  __device__ __forceinline__ void rescale(float (&o)[128]) const {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      o[4 * i] *= a0, o[4 * i + 1] *= a0;
      o[4 * i + 2] *= a1, o[4 * i + 3] *= a1;
    }
  }
  // the quad's row sums; then 1 / l, the multiplier of each row of O
  __device__ __forceinline__ void finish(float& inv0, float& inv1) {
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, x);
      l1 += __shfl_xor_sync(0xffffffffu, l1, x);
    }
    inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  }
  // lse = m + log l of the thread's rows, from lane t == 0 of each quad
  __device__ __forceinline__ void write_lse(float* lb, int r0, int T, int t) const {
    if (t == 0) {
      if (r0 < T) lb[r0] = m0 * fa90::LN2 + logf(fmaxf(l0, 1e-30f));
      if (r0 + 8 < T) lb[r0 + 8] = m1 * fa90::LN2 + logf(fmaxf(l1, 1e-30f));
    }
  }
};

// ---------------------------------------------------------------------------
// K4. One block per (head, Q tile of 64 WGS rows): WGS consumer warpgroups of
// 64 rows and a producer (a warp beside one consumer warpgroup, a warpgroup
// giving its registers to two). Q once; K and V tiles of 64 keys in rings
// of their own.
template <int WGS>
__global__ void __launch_bounds__(fa90::fwd_threads<WGS>(), 1) fwd_kernel(const __grid_constant__ Maps mp, const Args p) {
  constexpr int BQ = 64 * WGS, CONS = 128 * WGS, KV = tile_bytes(FWD_BKV);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = fa90::align1024(smem_raw);
  const uint32_t sq = smem_u32(sm), sk = sq + tile_bytes(BQ), sv = sk + FWD_KSTAGES * KV;
  const uint32_t bars = sv + FWD_VSTAGES * KV, qbar = bars + 8 * 2 * (FWD_KSTAGES + FWD_VSTAGES);
  const Ring<FWD_KSTAGES> rk{bars};
  const Ring<FWD_VSTAGES> rv{bars + 8 * 2 * FWD_KSTAGES};

  const int tid = threadIdx.x, bh = blockIdx.x, qt = p.n_tiles - 1 - blockIdx.y;  // the last Q tile first
  const int q_first = qt * BQ;
  const int n_kv = (min(q_first + BQ, p.T) + FWD_BKV - 1) / FWD_BKV;  // tiles up to the block's diagonal
  if (tid == 0) {
    constexpr int NB = 2 * (FWD_KSTAGES + FWD_VSTAGES) + 1;
    int counts[NB];  // full (and Q's): the producer; empty: each consumer warpgroup
    for (int i = 0; i < NB; ++i) counts[i] = 1;
    for (int i = 0; i < FWD_KSTAGES; ++i) counts[FWD_KSTAGES + i] = WGS;
    for (int i = 0; i < FWD_VSTAGES; ++i) counts[2 * FWD_KSTAGES + FWD_VSTAGES + i] = WGS;
    fa90::init_barriers(bars, NB, counts);
  }
  __syncthreads();

  if (tid >= CONS) {  // the producer: lane 0 of its first warp issues every copy
    if constexpr (WGS == 2) fa90::regs_dec<fa90::PRODUCER_REGS>();
    if (tid == CONS) {
      mbar_expect_tx(qbar, tile_bytes(BQ));
      load_tile(sq, &mp.q, BQ, q_first, bh, qbar);
      for (int j = 0; j < n_kv; ++j) {
        mbar_wait(rk.empty(j), rk.phase(j) ^ 1);
        mbar_expect_tx(rk.full(j), KV);
        load_tile(sk + (j % FWD_KSTAGES) * KV, &mp.k, FWD_BKV, j * FWD_BKV, bh, rk.full(j));
        mbar_wait(rv.empty(j), rv.phase(j) ^ 1);
        mbar_expect_tx(rv.full(j), KV);
        load_tile(sv + (j % FWD_VSTAGES) * KV, &mp.v, FWD_BKV, j * FWD_BKV, bh, rv.full(j));
      }
    }
    return;
  }

  // a consumer warpgroup: rows wg_first ..; this thread rows r0, r0 + 8
  if constexpr (WGS == 2) fa90::regs_inc<fa90::CONSUMER_REGS>();
  const int wg = tid / 128, t128 = tid % 128, lane = tid % 32, t = lane % 4;
  const int wg_first = q_first + 64 * wg, r0 = wg_first + 16 * (t128 / 32) + lane / 4;
  const int n_own = min(n_kv, wg_first / FWD_BKV + 1);  // the tiles up to this warpgroup's diagonal
  float o[128];
  uint32_t pa[16];  // P in bf16, the A operand of P V (4 k-steps of 16 keys)
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.f;
  Online sm_;

  // Each tile's scores go to a fresh array (as in flash_sm90.cuh)
  auto issue_s = [&](int j, float (&s)[32]) {  // S = Q K_j^T: 16 k-steps of 16 head columns
    const uint32_t kt = sk + (j % FWD_KSTAGES) * KV;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HS / 16; ++kk)
      wgmma_ss<FWD_BKV>(s, fa90::desc_k(sq, BQ, 64 * wg, kk), fa90::desc_k(kt, FWD_BKV, 0, kk), kk > 0);
    wgmma_commit();
  };
  auto issue_pv = [&](int j) {  // O += P V_j: 4 k-steps of 16 keys, the head's 256 columns as N
    const uint32_t vt = sv + (j % FWD_VSTAGES) * KV;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < FWD_BKV / 16; ++kk) wgmma_rs<HS>(o, pa + 4 * kk, fa90::desc_mn(vt, FWD_BKV, kk));
    wgmma_commit();
  };

  mbar_wait(qbar, 0);
  if constexpr (WGS == 2) fa90::first_turn(wg);
  {
    float s[32];
    mbar_wait(rk.full(0), 0);
    if constexpr (WGS == 2) fa90::turn_wait(wg);
    issue_s(0, s);
    if constexpr (WGS == 2) fa90::turn_pass(wg);
    wgmma_wait<0>();
    fa90::fence_regs(s);
    if (t128 == 0) mbar_arrive(rk.empty(0));
    sm_.tile(s, n_own == 1, 2 * t, r0, p.sl2);
    fa90::pack_a<FWD_BKV>(pa, s);
  }
  // tile j + 1's S goes out with tile j's P V, and its softmax runs beside
  // it; the last tile's P V is peeled off, so every pass has the same groups
  for (int j = 0; j + 1 < n_own; ++j) {
    float s[32];
    mbar_wait(rk.full(j + 1), rk.phase(j + 1));
    mbar_wait(rv.full(j), rv.phase(j));
    if constexpr (WGS == 2) fa90::turn_wait(wg);
    issue_s(j + 1, s);
    issue_pv(j);
    if constexpr (WGS == 2) fa90::turn_pass(wg);
    wgmma_wait<1>();
    fa90::fence_regs(s);
    if (t128 == 0) mbar_arrive(rk.empty(j + 1));
    sm_.tile(s, j + 2 == n_own, (j + 1) * FWD_BKV + 2 * t, r0, p.sl2);
    wgmma_wait<0>();
    fa90::fence_regs(o);
    if (t128 == 0) mbar_arrive(rv.empty(j));
    sm_.rescale(o);
    fa90::pack_a<FWD_BKV>(pa, s);
  }
  mbar_wait(rv.full(n_own - 1), rv.phase(n_own - 1));
  issue_pv(n_own - 1);
  wgmma_wait<0>();
  fa90::fence_regs(o);
  // warpgroup 0 of a 128-row block has no keys in the block's last tile: it
  // takes that turn empty, so both warpgroups take the same number
  if constexpr (WGS == 2)
    if (n_own < n_kv) {
      fa90::turn_wait(wg);
      fa90::turn_pass(wg);
    }

  float inv0, inv1;
  sm_.finish(inv0, inv1);
  // O through the warpgroup's rows of the Q tile (its last scores are done)
  store_rows(sm, sq, BQ, 64 * wg, o, inv0, inv1, &mp.o0, wg_first, bh, wg, t128);
  sm_.write_lse(p.lse + (size_t)bh * p.T, r0, p.T, t);
}

// ---------------------------------------------------------------------------
// dq. One block per (head, Q tile of 128 rows), two consumer warpgroups of 64
// rows and a producer warpgroup. D comes from the dot kernel of
// flash_attention.cu before the launch.
__global__ void __launch_bounds__(384, 1) dq_kernel(const __grid_constant__ Maps mp, const Args p) {
  constexpr int CONS = 256, QB = tile_bytes(DQ_BQ), KV = tile_bytes(DQ_BKV);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = fa90::align1024(smem_raw);
  const uint32_t sq = smem_u32(sm), sdo = sq + QB, sk = sdo + QB, sv = sk + DQ_KSTAGES * KV;
  const uint32_t bars = sv + DQ_VSTAGES * KV, qbar = bars + 8 * 2 * (DQ_KSTAGES + DQ_VSTAGES);
  const Ring<DQ_KSTAGES> rk{bars};
  const Ring<DQ_VSTAGES> rv{bars + 8 * 2 * DQ_KSTAGES};

  const int tid = threadIdx.x, bh = blockIdx.x, qt = p.n_tiles - 1 - blockIdx.y;  // the last Q tile first
  const int q_first = qt * DQ_BQ;
  const int n_kv = (min(q_first + DQ_BQ, p.T) + DQ_BKV - 1) / DQ_BKV;
  if (tid == 0) {
    constexpr int NB = 2 * (DQ_KSTAGES + DQ_VSTAGES) + 1;
    int counts[NB];  // full (and Q's): the producer; empty: each consumer warpgroup
    for (int i = 0; i < NB; ++i) counts[i] = 1;
    for (int i = 0; i < DQ_KSTAGES; ++i) counts[DQ_KSTAGES + i] = 2;
    for (int i = 0; i < DQ_VSTAGES; ++i) counts[2 * DQ_KSTAGES + DQ_VSTAGES + i] = 2;
    fa90::init_barriers(bars, NB, counts);
  }
  __syncthreads();

  if (tid >= CONS) {  // the producer warpgroup: lane 0 of its first warp issues every copy
    fa90::regs_dec<fa90::PRODUCER_REGS>();
    if (tid == CONS) {
      mbar_expect_tx(qbar, 2 * QB);
      load_tile(sq, &mp.q, DQ_BQ, q_first, bh, qbar);
      load_tile(sdo, &mp.d, DQ_BQ, q_first, bh, qbar);
      for (int j = 0; j < n_kv; ++j) {
        mbar_wait(rk.empty(j), rk.phase(j) ^ 1);
        mbar_expect_tx(rk.full(j), KV);
        load_tile(sk + (j % DQ_KSTAGES) * KV, &mp.k, DQ_BKV, j * DQ_BKV, bh, rk.full(j));
        mbar_wait(rv.empty(j), rv.phase(j) ^ 1);
        mbar_expect_tx(rv.full(j), KV);
        load_tile(sv + (j % DQ_VSTAGES) * KV, &mp.v, DQ_BKV, j * DQ_BKV, bh, rv.full(j));
      }
    }
    return;
  }

  fa90::regs_inc<fa90::CONSUMER_REGS>();
  const int wg = tid / 128, t128 = tid % 128, lane = tid % 32, t = lane % 4;
  const int wg_first = q_first + 64 * wg, r0 = wg_first + 16 * (t128 / 32) + lane / 4;
  const float* lb = p.lse + (size_t)bh * p.T;
  const float* db = p.dd + (size_t)bh * p.T;
  const float L0 = r0 < p.T ? lb[r0] * fa90::LOG2E : 0.f, L1 = r0 + 8 < p.T ? lb[r0 + 8] * fa90::LOG2E : 0.f;
  const float D0 = r0 < p.T ? db[r0] : 0.f, D1 = r0 + 8 < p.T ? db[r0 + 8] : 0.f;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  mbar_wait(qbar, 0);
  fa90::first_turn(wg);
  for (int j = 0; j < n_kv; ++j) {
    float s[32], dp[32];  // fresh each tile, as in flash_sm90.cuh
    uint32_t da[16];      // dS in bf16, the A operand of dS K_j (4 k-steps of 16 keys)
    const uint32_t kt = sk + (j % DQ_KSTAGES) * KV, vt = sv + (j % DQ_VSTAGES) * KV;
    mbar_wait(rk.full(j), rk.phase(j));
    mbar_wait(rv.full(j), rv.phase(j));
    // S = Q K_j^T and dP = dO V_j^T: 16 k-steps of 16 head columns each
    fa90::turn_wait(wg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HS / 16; ++kk)
      wgmma_ss<DQ_BKV>(s, fa90::desc_k(sq, DQ_BQ, 64 * wg, kk), fa90::desc_k(kt, DQ_BKV, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HS / 16; ++kk)
      wgmma_ss<DQ_BKV>(dp, fa90::desc_k(sdo, DQ_BQ, 64 * wg, kk), fa90::desc_k(vt, DQ_BKV, 0, kk), kk > 0);
    wgmma_commit();
    fa90::turn_pass(wg);
    wgmma_wait<0>();
    fa90::fence_regs(s);
    fa90::fence_regs(dp);
    if (t128 == 0) mbar_arrive(rv.empty(j));
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
    // dQ += bf16(dS) K_j, K_j as the MN-major B (the head's 256 columns as N)
    fa90::turn_wait(wg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQ_BKV / 16; ++kk) wgmma_rs<HS>(acc, da + 4 * kk, fa90::desc_mn(kt, DQ_BKV, kk));
    wgmma_commit();
    fa90::turn_pass(wg);
    wgmma_wait<0>();
    fa90::fence_regs(acc);
    if (t128 == 0) mbar_arrive(rk.empty(j));
  }

  // dQ times scale through the warpgroup's rows of the Q tile
  store_rows(sm, sq, DQ_BQ, 64 * wg, acc, p.scale, p.scale, &mp.o0, wg_first, bh, wg, t128);
}

// ---------------------------------------------------------------------------
// dK/dV. One block per (head, KV tile of 64 keys): warpgroup 0 computes P^T
// and dV, warpgroup 1 dS^T and dK (above); a producer warpgroup.
__global__ void __launch_bounds__(384, 1) dkv_kernel(const __grid_constant__ Maps mp, const Args p) {
  constexpr int CONS = 256, KB = tile_bytes(DKV_BKV), QB = tile_bytes(DKV_BQ), SB = 2 * QB;
  constexpr int PB = DKV_BKV * DKV_BQ * 4, RB = 2 * DKV_BQ * 4;  // a P^T buffer; a stage's lse and D rows
  constexpr int P_OFF = 2 * KB + DKV_STAGES * SB, R_OFF = P_OFF + DKV_PBUFS * PB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = fa90::align1024(smem_raw);
  const uint32_t sk = smem_u32(sm), sv = sk + KB, ring = sv + KB;
  const uint32_t bars = sk + R_OFF + DKV_STAGES * RB, kvbar = bars + 8 * 2 * (DKV_STAGES + DKV_PBUFS);
  const Ring<DKV_STAGES> rq{bars};
  const Ring<DKV_PBUFS> pb{bars + 8 * 2 * DKV_STAGES};
  // a stage's rows: 64 lse values (times log2(e)), then 64 D values
  auto rows_of = [&](int n) { return reinterpret_cast<float*>(sm + R_OFF + (n % DKV_STAGES) * RB); };
  auto pbuf = [&](int n) { return reinterpret_cast<float4*>(sm + P_OFF + (n % DKV_PBUFS) * PB); };

  const int tid = threadIdx.x, bh = blockIdx.x, kt = blockIdx.y;  // kt = 0, which every Q tile sees, first
  const int k_first = kt * DKV_BKV;
  const int i0 = k_first / DKV_BQ, n_q = (p.T + DKV_BQ - 1) / DKV_BQ;  // Q tiles at or below the diagonal
  if (tid == 0) {
    constexpr int NB = 2 * (DKV_STAGES + DKV_PBUFS) + 1;
    int counts[NB];
    for (int i = 0; i < NB; ++i)  // ring full: the TMA and 32 lanes' rows; empty: both warpgroups; P^T: 128 threads
      counts[i] = i < DKV_STAGES ? 33 : i < 2 * DKV_STAGES ? 2 : i < NB - 1 ? 128 : 1;
    fa90::init_barriers(bars, NB, counts);
  }
  __syncthreads();

  if (tid >= CONS) {  // the producer warpgroup's first warp: lane 0 the TMA copies, every lane lse and D
    fa90::regs_dec<fa90::PRODUCER_REGS>();
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
        mbar_expect_tx(rq.full(n), SB);
        load_tile(st, &mp.q, DKV_BQ, i * DKV_BQ, bh, rq.full(n));
        load_tile(st + QB, &mp.d, DKV_BQ, i * DKV_BQ, bh, rq.full(n));
      }
      float* rows = rows_of(n);
#pragma unroll
      for (int h = 0; h < DKV_BQ / 32; ++h) {
        const int c = lane + 32 * h, q = i * DKV_BQ + c;
        rows[c] = q < p.T ? lb[q] * fa90::LOG2E : 0.f;
        rows[DKV_BQ + c] = q < p.T ? db[q] : 0.f;
      }
      mbar_arrive(rq.full(n));  // each lane's stores, released to the consumers
    }
    return;
  }

  fa90::regs_inc<fa90::CONSUMER_REGS>();
  const int wg = tid / 128, t128 = tid % 128, lane = tid % 32, t = lane % 4;
  const int kr0 = k_first + 16 * (t128 / 32) + lane / 4;  // this thread's keys kr0, kr0 + 8
  float acc[128];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  mbar_wait(kvbar, 0);

  if (wg == 1) {  // dP^T = V dO_i^T, dS^T = P^T (dP^T - D), dK += dS^T Q_i
    for (int i = i0; i < n_q; ++i) {
      const int n = i - i0;
      float dp[32];
      uint32_t sa[16];  // dS^T in bf16 (4 k-steps of 16 queries)
      const uint32_t qt = ring + (n % DKV_STAGES) * SB, dot = qt + QB;
      mbar_wait(rq.full(n), rq.phase(n));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HS / 16; ++kk)
        wgmma_ss<DKV_BQ>(dp, fa90::desc_k(sv, DKV_BKV, 0, kk), fa90::desc_k(dot, DKV_BQ, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fa90::fence_regs(dp);
      const float* D = rows_of(n) + DKV_BQ;
      mbar_wait(pb.full(n), pb.phase(n));
      const float4* pr = pbuf(n) + t128;
#pragma unroll
      for (int j = 0; j < DKV_BQ / 8; ++j) {  // P^T as warpgroup 0 holds it: the same thread, the same slots
        const float4 pv = pr[128 * j];
        const float2 d = *reinterpret_cast<const float2*>(D + 8 * j + 2 * t);
        dp[4 * j] = pv.x * (dp[4 * j] - d.x);
        dp[4 * j + 1] = pv.y * (dp[4 * j + 1] - d.y);
        dp[4 * j + 2] = pv.z * (dp[4 * j + 2] - d.x);
        dp[4 * j + 3] = pv.w * (dp[4 * j + 3] - d.y);
      }
      mbar_arrive(pb.empty(n));
      fa90::pack_a<DKV_BQ>(sa, dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DKV_BQ / 16; ++kk) wgmma_rs<HS>(acc, sa + 4 * kk, fa90::desc_mn(qt, DKV_BQ, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fa90::fence_regs(acc);
      if (t128 == 0) mbar_arrive(rq.empty(n));
    }
    // dK times scale through the V tile, which only this warpgroup read
    store_rows(sm + KB, sv, DKV_BKV, 0, acc, p.scale, p.scale, &mp.o0, k_first, bh, 1, t128);
    return;
  }

  // warpgroup 0: S^T = K Q_i^T, P^T (query q sees key iff key <= q < T), handed
  // to warpgroup 1 in f32, and dV += bf16(P^T) dO_i
  for (int i = i0; i < n_q; ++i) {
    const int n = i - i0;
    float s[32];
    uint32_t pa[16];  // P^T in bf16 (4 k-steps of 16 queries)
    const uint32_t qt = ring + (n % DKV_STAGES) * SB, dot = qt + QB;
    mbar_wait(rq.full(n), rq.phase(n));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HS / 16; ++kk)
      wgmma_ss<DKV_BQ>(s, fa90::desc_k(sk, DKV_BKV, 0, kk), fa90::desc_k(qt, DKV_BQ, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fa90::fence_regs(s);
    const float* L = rows_of(n);
    const int q0 = i * DKV_BQ;
    const bool edge = q0 < k_first + DKV_BKV - 1 || q0 + DKV_BQ > p.T;  // crosses the diagonal or T
#pragma unroll
    for (int j = 0; j < DKV_BQ / 8; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 l = *reinterpret_cast<const float2*>(L + c);
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
    fa90::pack_a<DKV_BQ>(pa, s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DKV_BQ / 16; ++kk) wgmma_rs<HS>(acc, pa + 4 * kk, fa90::desc_mn(dot, DKV_BQ, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fa90::fence_regs(acc);
    if (t128 == 0) mbar_arrive(rq.empty(n));
  }
  // dV through the K tile, which only this warpgroup read
  store_rows(sm, sk, DKV_BKV, 0, acc, 1.f, 1.f, &mp.o1, k_first, bh, 0, t128);
}

// ---------------------------------------------------------------------------
// Host side: tensor maps of (B * H, T, 256) bf16 tensors in boxes of 64 head
// columns x `rows`, and the launches (K10's with D already in dd).

inline int tile_map(CUtensorMap* m, const void* base, int T, int BH, int rows) {
  return map_3d(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, HS, T, BH, fa90::PANEL, rows, CU_TENSOR_MAP_SWIZZLE_128B);
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
  const Args a{(float*)lse, nullptr, T, n_qt, scale, scale * fa90::LOG2E};
  const dim3 grid(B * H, n_qt);
  if (bq == 64) {
    if ((err = fa90::prepare(fa256::fwd_kernel<1>, fwd_smem(64)))) return err;
    fa256::fwd_kernel<1><<<grid, fa90::fwd_threads<1>(), fwd_smem(64), st>>>(mp, a);
  } else {
    if ((err = fa90::prepare(fa256::fwd_kernel<2>, fwd_smem(128)))) return err;
    fa256::fwd_kernel<2><<<grid, fa90::fwd_threads<2>(), fwd_smem(128), st>>>(mp, a);
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
  if (!err) err = fa90::prepare(dq_kernel, dq_smem());
  mp.o1 = mp.o0;
  if (err) return err;
  const int n_qt = (T + DQ_BQ - 1) / DQ_BQ;
  const Args a{(float*)lse, (const float*)dd, T, n_qt, scale, scale * fa90::LOG2E};
  fa256::dq_kernel<<<dim3(B * H, n_qt), 384, dq_smem(), st>>>(mp, a);  // qualified: Maps draws fa90 into the lookup
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
  if (!err) err = fa90::prepare(dkv_kernel, dkv_smem());
  if (err) return err;
  const int n_kt = (T + DKV_BKV - 1) / DKV_BKV;
  const Args a{(float*)lse, (const float*)dd, T, n_kt, scale, scale * fa90::LOG2E};
  fa256::dkv_kernel<<<dim3(B * H, n_kt), 384, dkv_smem(), st>>>(mp, a);
  return (int)cudaGetLastError();
}

}  // namespace fa256
