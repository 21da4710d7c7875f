// Single-query attention over a long cache on Hopper, in splits: K5 (the
// per-op step's decode attention, a bf16, f32 or int8 cache, one query per
// batch row and head) and the attention phase of K1 (one stream, the cache
// row written in place), on one body.
//
// Replaces, for K5, lit_llama_tpu/ops/decode_attention.py _kernel (entry
// decode_attention_pallas) at every head size that is a multiple of 128 up
// to MAX_HS (1024), in bf16 and in f32 compute; for K1, the attention of
// lit_llama_tpu/ops/fused_layer.py _layer_kernel in bf16 and in f32.
//
// Bound on the H100: bytes. The visible rows of k and v are read once: 33.6 MB
// at (B, H, S, hs) = (1, 32, 2048, 128) in bf16, 67.1 MB in f32, 17.3 MB in
// int8 with its scales; the arithmetic is a few operations per element on the
// CUDA cores.
//
// Design. The Pallas kernel walks a head's cache in order and carries
// (m, l, acc); here the cache of each (batch row, head) is cut into at most
// max_splits(hs) splits of split_rows(S, hs) rows (a multiple of 64), a pure
// function of S and hs, never of B or the limit, so a row's bits do not
// depend on the batch: at most MAX_SPLITS at head size 128 and 256, and past
// 256 MAX_SPLITS * hs / 128, so that a split holds about the bytes of an
// hs-128 split of the same cache. One block of four warps takes a split.
// Each warp streams its tiles (Geo::PIECES 16-byte pieces of k and of v a
// lane, LOADS or fewer: at hs 128 16 rows in bf16, 32 in int8, 8 in f32; at
// hs 256 half as many) with cp.async into a ring of STAGES tiles in shared
// memory, each lane copying the pieces it then reads (a lane owns 16 bytes of
// a row: 8 bf16, 16 int8 or 4 f32 elements; a row of CPR pieces lies on LPR
// lanes, the largest power of two up to 32 that divides CPR, so a lane holds
// PPL = CPR / LPR pieces of it, LPR pieces apart: two of an f32 row at hs
// 256, three of a bf16 row at hs 384 on 16 lanes), so the ring needs no
// barrier but the warp's; the copies
// of the next tiles overlap the online softmax of this one, the Pallas
// kernel's (m, l, acc) carry moved into the warp. A row's score is the sum of
// its lanes' pieces (a butterfly over the lanes of the row); a lane weights
// its own 16 bytes of each v row, so v is read 16 bytes a lane. At the end the
// four warps merge in warp order, and the split's (m, l, acc) goes to a
// scratch the wrapper owns; the last block of a (batch row, head) to arrive,
// which learns it from a counter (each block's __threadfence before its
// increment), merges the splits in split order and resets the counter. One
// launch, and bits that do not depend on the order of arrival. A (row, head)
// with one split writes its output at once, the same bits as a merge of one.
// Tiles past the limit are never read.
//
// Arithmetic. K5 in bf16 compute (ROUNDED): the Pallas kernel's: each product
// k * q and w * v rounded to bf16 and summed in f32; the k scale multiplies
// the f32 score, the v scale the f32 weight before it is rounded; l is
// floored at 1e-30, so a row with limit < 0 gives zeros. int8 elements become
// bf16 exactly (2^23 + u as an f32, minus 2^23 + 128). K5 in f32 compute and
// K1 (F32): q, the products and the weights in f32, no rounding, on a bf16
// (K1 in bf16), f32 or int8 cache (int8 elements exact in f32; the k scale
// multiplies the f32 score, the v scale the f32 weight). The arithmetics are
// kept apart by the template parameter.
#pragma once

#include "common.cuh"

namespace dsm90 {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int LOADS = 8;           // 16-byte pieces a lane copies of k, and of v, a tile, at most
constexpr int STAGES = 2;          // tiles in a warp's ring
constexpr int SPLIT_QUANTUM = 64;  // a split's rows are a multiple of this
constexpr int MAX_SPLITS = 8;      // splits of one (batch row, head)'s cache at head size 128 and 256
constexpr int MAX_HS = 1024;       // the widest head the body is built for (decode_attention.cu)

// splits of one (batch row, head)'s cache at most, rows a split takes and
// the number of splits, at cache length S >= 1 and head size hs
__host__ __device__ inline int max_splits(int hs) { return hs <= 256 ? MAX_SPLITS : MAX_SPLITS * hs / 128; }
__host__ __device__ inline int split_rows(int S, int hs) {
  const int per = (S + max_splits(hs) - 1) / max_splits(hs);
  return (per + SPLIT_QUANTUM - 1) / SPLIT_QUANTUM * SPLIT_QUANTUM;
}
__host__ __device__ inline int n_splits(int S, int hs) { return (S + split_rows(S, hs) - 1) / split_rows(S, hs); }

enum Arith { ROUNDED = 0, F32 = 1 };

template <typename CT, int HS>
struct Geo {
  static constexpr int EPL = 16 / (int)sizeof(CT);  // elements of a 16-byte piece of a row
  static constexpr int CPR = HS / EPL;              // pieces a row
  static constexpr int LPR = CPR % 32 == 0 ? 32 : CPR % 16 == 0 ? 16 : 8;  // lanes a row
  static constexpr int PPL = CPR / LPR;             // pieces of a row a lane holds (2: f32 at hs 256)
  static constexpr int RPL = 32 / LPR;              // rows a warp's pass
  // passes a tile: the largest power of two up to LOADS / PPL; pieces a lane copies of k (of v) a tile
  static constexpr int PASSES = PPL == 1 ? 8 : PPL == 2 ? 4 : PPL <= 4 ? 2 : 1;
  static constexpr int PIECES = PASSES * PPL;
  static constexpr int TILE = PASSES * RPL;         // rows a tile
  static constexpr bool QUANT = sizeof(CT) == 1;
  static constexpr int RING = WARPS * STAGES * 2 * PIECES * 32;       // uint4 of the rings
  static constexpr int SCALES = QUANT ? WARPS * STAGES * 2 * TILE : 0;  // floats of the scale rings
  static constexpr size_t SMEM = (size_t)RING * 16 + (size_t)SCALES * 4;
  static_assert(HS % 128 == 0 && HS <= MAX_HS && CPR % LPR == 0, "a row's pieces lie evenly on its lanes");
  static_assert(PIECES <= LOADS, "a lane copies at most LOADS pieces of k (of v) a tile");
  static_assert(SPLIT_QUANTUM % TILE == 0 && TILE <= 32, "a tile never crosses a split; a lane copies a scale");
};

// int8 byte i of x (x = the word ^ 0x80808080) as an exact f32
__device__ __forceinline__ float s8_f32(uint32_t x, int i) {
  return __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540 + i)) - 8388736.f;
}
__device__ __forceinline__ __nv_bfloat162 s8x2_bf16(uint32_t x, int pair) {
  return __floats2bfloat162_rn(s8_f32(x, 2 * pair), s8_f32(x, 2 * pair + 1));
}
__device__ __forceinline__ void add_pair(float& a, float& b, __nv_bfloat162 p) {
  a += __low2float(p);
  b += __high2float(p);
}

// The two arithmetics on one lane's 16-byte piece of a row: q's fragment
// (the piece's EPL elements as bf16 pairs, or as f32, in element order), its
// part of the row's score, and acc += w * (its piece of a v row).
template <int AR, typename CT>
struct Ops;

template <>
struct Ops<ROUNDED, __nv_bfloat16> {
  struct __align__(16) Q {
    __nv_bfloat162 v[4];
  };
  static __device__ __forceinline__ float dot(uint4 kw, const Q& q) {
    const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&kw);
    float d = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 p = __hmul2(k2[e], q.v[e]);
      d += __low2float(p);
      d += __high2float(p);
    }
    return d;
  }
  static __device__ __forceinline__ void axpy(float* acc, uint4 vw, float w) {
    const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&vw);
    const __nv_bfloat162 w2 = __bfloat162bfloat162(__float2bfloat16_rn(w));
#pragma unroll
    for (int e = 0; e < 4; ++e) add_pair(acc[2 * e], acc[2 * e + 1], __hmul2(w2, v2[e]));
  }
};

template <>
struct Ops<ROUNDED, int8_t> {
  struct __align__(16) Q {
    __nv_bfloat162 v[8];
  };
  static __device__ __forceinline__ float dot(uint4 kw, const Q& q) {
    const uint32_t w[4] = {kw.x ^ 0x80808080u, kw.y ^ 0x80808080u, kw.z ^ 0x80808080u, kw.w ^ 0x80808080u};
    float d = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const __nv_bfloat162 p = __hmul2(s8x2_bf16(w[e / 2], e % 2), q.v[e]);
      d += __low2float(p);
      d += __high2float(p);
    }
    return d;
  }
  static __device__ __forceinline__ void axpy(float* acc, uint4 vw, float w) {
    const uint32_t x[4] = {vw.x ^ 0x80808080u, vw.y ^ 0x80808080u, vw.z ^ 0x80808080u, vw.w ^ 0x80808080u};
    const __nv_bfloat162 w2 = __bfloat162bfloat162(__float2bfloat16_rn(w));
#pragma unroll
    for (int e = 0; e < 8; ++e) add_pair(acc[2 * e], acc[2 * e + 1], __hmul2(w2, s8x2_bf16(x[e / 2], e % 2)));
  }
};

template <>
struct Ops<F32, __nv_bfloat16> {
  struct __align__(16) Q {
    float v[8];
  };
  static __device__ __forceinline__ float dot(uint4 kw, const Q& q) {
    const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&kw);
    float d = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      d += __low2float(k2[e]) * q.v[2 * e];
      d += __high2float(k2[e]) * q.v[2 * e + 1];
    }
    return d;
  }
  static __device__ __forceinline__ void axpy(float* acc, uint4 vw, float w) {
    const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&vw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[2 * e] += w * __low2float(v2[e]);
      acc[2 * e + 1] += w * __high2float(v2[e]);
    }
  }
};

template <>
struct Ops<F32, float> {
  struct __align__(16) Q {
    float v[4];
  };
  static __device__ __forceinline__ float dot(uint4 kw, const Q& q) {
    const float k[4] = {__uint_as_float(kw.x), __uint_as_float(kw.y), __uint_as_float(kw.z), __uint_as_float(kw.w)};
    float d = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) d += k[e] * q.v[e];
    return d;
  }
  static __device__ __forceinline__ void axpy(float* acc, uint4 vw, float w) {
    acc[0] += w * __uint_as_float(vw.x);
    acc[1] += w * __uint_as_float(vw.y);
    acc[2] += w * __uint_as_float(vw.z);
    acc[3] += w * __uint_as_float(vw.w);
  }
};

template <>
struct Ops<F32, int8_t> {
  struct __align__(16) Q {
    float v[16];
  };
  static __device__ __forceinline__ float dot(uint4 kw, const Q& q) {
    const uint32_t w[4] = {kw.x ^ 0x80808080u, kw.y ^ 0x80808080u, kw.z ^ 0x80808080u, kw.w ^ 0x80808080u};
    float d = 0.f;
#pragma unroll
    for (int e = 0; e < 16; ++e) d += s8_f32(w[e / 4], e % 4) * q.v[e];
    return d;
  }
  static __device__ __forceinline__ void axpy(float* acc, uint4 vw, float w) {
    const uint32_t x[4] = {vw.x ^ 0x80808080u, vw.y ^ 0x80808080u, vw.z ^ 0x80808080u, vw.w ^ 0x80808080u};
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] += w * s8_f32(x[e / 4], e % 4);
  }
};

// One warp's share of one split: its tiles t = warp, warp + WARPS, ... of the
// split's rows [s0, r_end), copied into the warp's ring. kc, vc, ks, vs point
// at the (batch row, head)'s cache (S, HS) and scales (S).
template <typename CT, int HS>
struct Ring {
  using G = Geo<CT, HS>;
  uint4* ring;  // this warp's STAGES x (k, v) x PIECES x 32 pieces
  float* scl;   // this warp's STAGES x (ks, vs) x TILE scales (int8)
  const CT *kc, *vc;
  const float *ks, *vs;
  int s0, S, lane, n_tiles;
  int warp;

  __device__ Ring(uint4* dsm, const CT* kc_, const CT* vc_, const float* ks_, const float* vs_, int s0_, int r_end,
                  int S_)
      : kc(kc_), vc(vc_), ks(ks_), vs(vs_), s0(s0_), S(S_) {
    warp = threadIdx.x / 32;
    lane = threadIdx.x % 32;
    ring = dsm + warp * STAGES * 2 * G::PIECES * 32;
    scl = reinterpret_cast<float*>(dsm + G::RING) + warp * STAGES * 2 * G::TILE;
    const int tiles = (r_end - s0 + G::TILE - 1) / G::TILE;  // the split's tiles with a visible row
    n_tiles = warp < tiles ? (tiles - warp + WARPS - 1) / WARPS : 0;
  }
  __device__ int row0(int j) const { return s0 + (warp + j * WARPS) * G::TILE; }
  __device__ const uint4* stage(int j) const { return ring + (j % STAGES) * 2 * G::PIECES * 32; }
  __device__ const float* stage_scales(int j) const { return scl + (j % STAGES) * 2 * G::TILE; }

  // copies of the warp's tile j into its stage; rows past S are zeros
  __device__ void fetch(int j) {
    uint4* st = ring + (j % STAGES) * 2 * G::PIECES * 32;
    const int r0 = row0(j), rg = lane / G::LPR, cc = lane % G::LPR;
#pragma unroll
    for (int i = 0; i < G::PIECES; ++i) {  // pass i / PPL, the lane's piece i % PPL of the row
      const int r = r0 + (i / G::PPL) * G::RPL + rg;
      const size_t off = (size_t)(r < S ? r : 0) * HS + (cc + (i % G::PPL) * G::LPR) * G::EPL;
      cp_async16(st + i * 32 + lane, kc + off, r < S ? 16 : 0);
      cp_async16(st + (G::PIECES + i) * 32 + lane, vc + off, r < S ? 16 : 0);
    }
    if (G::QUANT && lane < G::TILE) {
      float* sc = scl + (j % STAGES) * 2 * G::TILE;
      const int r = r0 + lane;
      cp_async4(sc + lane, ks + (r < S ? r : 0), r < S ? 4 : 0);
      cp_async4(sc + G::TILE + lane, vs + (r < S ? r : 0), r < S ? 4 : 0);
    }
  }
  __device__ void prologue() {
#pragma unroll
    for (int j = 0; j < STAGES; ++j) {
      if (j < n_tiles) fetch(j);
      cp_async_commit();
    }
  }
};

// The warp's online softmax over its tiles (the ring's prologue already
// started), then its (m, l, acc) in shared memory: wm[warp], wl[warp],
// wacc[warp][0, HS). q: the lane's PPL fragments of the query.
template <int AR, typename CT, int HS>
__device__ __forceinline__ void run_warp(Ring<CT, HS>& rg_, const typename Ops<AR, CT>::Q* q, int r_end, float scale,
                                         float* wm, float* wl, float* wacc) {
  using G = Geo<CT, HS>;
  using O = Ops<AR, CT>;
  constexpr int NACC = G::PPL * G::EPL;
  const int lane = rg_.lane, rg = lane / G::LPR, cc = lane % G::LPR;
  float m = LLT_NEG_INF, l = 0.f, acc[NACC];
#pragma unroll
  for (int e = 0; e < NACC; ++e) acc[e] = 0.f;
  for (int j = 0; j < rg_.n_tiles; ++j) {
    cp_async_wait<STAGES - 1>();
    __syncwarp();  // the scales other lanes copied
    const uint4* st = rg_.stage(j);
    const float* sc = rg_.stage_scales(j);
    const int r0 = rg_.row0(j);
    float s[G::PASSES];
#pragma unroll
    for (int i = 0; i < G::PASSES; ++i) {
      float d = O::dot(st[i * G::PPL * 32 + lane], q[0]);
#pragma unroll
      for (int p = 1; p < G::PPL; ++p) d += O::dot(st[(i * G::PPL + p) * 32 + lane], q[p]);
#pragma unroll
      for (int o = 1; o < G::LPR; o <<= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      if (G::QUANT) d *= sc[i * G::RPL + rg];
      s[i] = r0 + i * G::RPL + rg < r_end ? d * scale : LLT_NEG_INF;
    }
    float mx = s[0];
#pragma unroll
    for (int i = 1; i < G::PASSES; ++i) mx = fmaxf(mx, s[i]);
#pragma unroll
    for (int o = G::LPR; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float mn = fmaxf(m, mx);
    const float alpha = __expf(m - mn);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < NACC; ++e) acc[e] *= alpha;
#pragma unroll
    for (int i = 0; i < G::PASSES; ++i) {
      const float p = __expf(s[i] - mn);
      l += p;
      const float w = G::QUANT ? p * sc[G::TILE + i * G::RPL + rg] : p;
#pragma unroll
      for (int pp = 0; pp < G::PPL; ++pp) O::axpy(acc + pp * G::EPL, st[(G::PIECES + i * G::PPL + pp) * 32 + lane], w);
    }
    m = mn;
    __syncwarp();  // every lane is done with the stage before it is refilled
    if (j + STAGES < rg_.n_tiles) rg_.fetch(j + STAGES);
    cp_async_commit();
  }
  // the row groups of the warp hold disjoint rows: sum them
#pragma unroll
  for (int o = G::LPR; o < 32; o <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
    for (int e = 0; e < NACC; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  }
  if (lane < G::LPR) {
#pragma unroll
    for (int e = 0; e < NACC; ++e) wacc[(cc + (e / G::EPL) * G::LPR) * G::EPL + e % G::EPL] = acc[e];
  }
  if (lane == 0) {
    wm[rg_.warp] = m;
    wl[rg_.warp] = l;
  }
}

// The block's split from its warps' (m, l, acc) in warp order; then the
// output row (one split), or the split's partial and, in the last block of
// the (batch row, head) to arrive, the merge of the splits in split order.
// part: the (batch row, head)'s n_splits x (HS + 2) floats; counter its
// arrival count (0 between launches); y its HS outputs.
template <int HS, typename OT>
__device__ __forceinline__ void finish(const float* wm, const float* wl, const float (*wacc)[HS], float* part,
                                       int* counter, int split, int n_valid, OT* y) {
  __shared__ int last_block;
  const int tid = threadIdx.x;
  __syncthreads();  // every warp's (m, l, acc)
  float M = wm[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) M = fmaxf(M, wm[w]);
  float f[WARPS], L = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    f[w] = __expf(wm[w] - M);
    L += f[w] * wl[w];
  }
  float* pp = part + (size_t)split * (HS + 2);
  for (int d = tid; d < HS; d += THREADS) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += f[w] * wacc[w][d];
    if (n_valid == 1)
      y[d] = from_f32<OT>(a / fmaxf(L, 1e-30f));
    else
      pp[2 + d] = a;
  }
  if (n_valid == 1) return;
  if (tid == 0) {
    pp[0] = M;
    pp[1] = L;
  }
  __threadfence();  // the partial is visible before the count that announces it
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(counter, 1) == n_valid - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  float Mx = LLT_NEG_INF;
  for (int c = 0; c < n_valid; ++c) Mx = fmaxf(Mx, __ldcg(part + (size_t)c * (HS + 2)));
  for (int d = tid; d < HS; d += THREADS) {
    float Lc = 0.f, a = 0.f;
    for (int c = 0; c < n_valid; ++c) {
      const float* pc = part + (size_t)c * (HS + 2);
      const float w = __expf(__ldcg(pc) - Mx);
      Lc += w * __ldcg(pc + 1);
      a += w * __ldcg(pc + 2 + d);
    }
    y[d] = from_f32<OT>(a / fmaxf(Lc, 1e-30f));
  }
  if (tid == 0) *counter = 0;  // ready for the next launch
}

// K5: grid (n_splits(S, HS), H, B). q (B, H, HS) of QT, the compute dtype (bf16:
// ROUNDED, f32: F32), with a batch stride; kc, vc (B, H, S, HS) of CT (QT,
// or int8 with ks, vs (B, H, S) f32); limit (B) int32 on the device; part
// (B, H, n_splits, HS + 2) f32; counter (B, H) int32, zeros; y (B, H, HS) of
// QT.
template <typename QT, typename CT, int HS>
__global__ void __launch_bounds__(THREADS)
k5_kernel(const QT* __restrict__ q, int q_stride, const CT* __restrict__ kc, const CT* __restrict__ vc,
          const float* __restrict__ ks, const float* __restrict__ vs, const int* __restrict__ limit,
          float* __restrict__ part, int* __restrict__ counter, QT* __restrict__ y, int H, int S, float scale) {
  constexpr int AR = sizeof(QT) == 4 ? F32 : ROUNDED;
  using G = Geo<CT, HS>;
  using O = Ops<AR, CT>;
  extern __shared__ __align__(16) uint4 dsm[];
  __shared__ float wm[WARPS], wl[WARPS];
  __shared__ __align__(16) float wacc[WARPS][HS];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nsp = gridDim.x;
  const int bh = b * H + h;
  const int last = min(limit[b], S - 1);
  QT* yb = y + (size_t)bh * HS;
  if (last < 0) {  // no row visible: zeros, as l's floor gives
    if (split == 0)
      for (int d = threadIdx.x; d < HS; d += THREADS) yb[d] = from_f32<QT>(0.f);
    return;
  }
  const int sr = split_rows(S, HS), s0 = split * sr;
  if (s0 > last) return;  // the whole split is past this row's limit
  const int r_end = min(s0 + sr, last + 1);
  const size_t base = (size_t)bh * S;
  Ring<CT, HS> ring(dsm, kc + base * HS, vc + base * HS, G::QUANT ? ks + base : nullptr,
                    G::QUANT ? vs + base : nullptr, s0, r_end, S);
  ring.prologue();
  typename O::Q qf[G::PPL];  // the query's elements of the lane's pieces, as the arithmetic takes them
#pragma unroll
  for (int p = 0; p < G::PPL; ++p) {
    const uint4* qp = reinterpret_cast<const uint4*>(q + (size_t)b * q_stride + (size_t)h * HS +
                                                     (ring.lane % G::LPR + p * G::LPR) * G::EPL);
#pragma unroll
    for (int j = 0; j < (int)(sizeof(qf[p]) / 16); ++j) reinterpret_cast<uint4*>(&qf[p])[j] = qp[j];
  }
  run_warp<AR, CT, HS>(ring, qf, r_end, scale, wm, wl, wacc[ring.warp]);
  finish<HS>(wm, wl, wacc, part + (size_t)bh * nsp * (HS + 2), counter + bh, split, last / sr + 1, yb);
}

// K1's attention: grid (n_valid, H), n_valid = last / split_rows(S, HS) + 1.
// qkv (3D) f32 in the half-rotation basis; kc, vc (H, S, HS) of CT, the
// compute dtype (bf16 or f32), row write_pos written here (k rotated) by the
// block whose split holds it, before that block reads its split; part (H,
// n_splits, HS + 2) f32; counter (H) int32, zeros; y (D) f32. Launched with
// launch_pdl: the copies of a split that does not hold write_pos start before
// the kernel before it ends.
template <typename CT, int HS>
__global__ void __launch_bounds__(THREADS)
k1_attn_kernel(const float* __restrict__ qkv, const float* __restrict__ cosf, const float* __restrict__ sinf,
               CT* kc, CT* vc, float* __restrict__ part, int* __restrict__ counter, float* __restrict__ y, int D,
               int S, int write_pos, int last, float scale) {
  using G = Geo<CT, HS>;
  using O = Ops<F32, CT>;
  extern __shared__ __align__(16) uint4 dsm[];
  __shared__ float wm[WARPS], wl[WARPS];
  __shared__ __align__(16) float wacc[WARPS][HS];
  const int split = blockIdx.x, h = blockIdx.y, n_valid = gridDim.x;
  const int sr = split_rows(S, HS), s0 = split * sr, r_end = min(s0 + sr, last + 1);
  const size_t base = (size_t)h * S * HS;
  Ring<CT, HS> ring(dsm, kc + base, vc + base, nullptr, nullptr, s0, r_end, S);
  const bool writes = write_pos >= s0 && write_pos < s0 + sr;
  if (!writes) ring.prologue();  // rows no kernel before this one writes
  pdl_wait();
  pdl_trigger();
  if (writes) {
    const float* kq = qkv + D + h * HS;
    for (int d = threadIdx.x; d < HS; d += THREADS) {
      const int partner = (d + HS / 2) % HS;
      kc[base + (size_t)write_pos * HS + d] = from_f32<CT>(kq[d] * cosf[d] + kq[partner] * sinf[d]);
      vc[base + (size_t)write_pos * HS + d] = from_f32<CT>(qkv[2 * D + h * HS + d]);
    }
    __threadfence();
    __syncthreads();  // the new row is in the cache before the split is copied
    ring.prologue();
  }
  typename O::Q qf[G::PPL];
  const float* qh = qkv + h * HS;
#pragma unroll
  for (int p = 0; p < G::PPL; ++p) {
#pragma unroll
    for (int e = 0; e < G::EPL; ++e) {
      const int d = (ring.lane % G::LPR + p * G::LPR) * G::EPL + e, partner = (d + HS / 2) % HS;
      qf[p].v[e] = qh[d] * cosf[d] + qh[partner] * sinf[d];
    }
  }
  run_warp<F32, CT, HS>(ring, qf, r_end, scale, wm, wl, wacc[ring.warp]);
  finish<HS>(wm, wl, wacc, part + (size_t)h * n_splits(S, HS) * (HS + 2), counter + h, split, n_valid, y + h * HS);
}

template <typename QT, typename CT, int HS>
int launch_k5(const void* q, int q_stride, const void* k, const void* v, const void* ks, const void* vs,
              const void* limit, void* part, void* counter, void* y, int B, int H, int S, cudaStream_t st) {
  using G = Geo<CT, HS>;
  static int ready[16];
  int err = allow_smem(ready, k5_kernel<QT, CT, HS>);
  if (err) return err;
  k5_kernel<QT, CT, HS><<<dim3(n_splits(S, HS), H, B), THREADS, G::SMEM, st>>>(
      (const QT*)q, q_stride, (const CT*)k, (const CT*)v, (const float*)ks, (const float*)vs, (const int*)limit,
      (float*)part, (int*)counter, (QT*)y, H, S, (float)(1.0 / sqrt((double)HS)));
  return (int)cudaGetLastError();
}

// K1's attention on a cache of CT (bf16 or f32), head size 128
template <typename CT>
int launch_k1_attn(const float* qkv, const float* cosf, const float* sinf, void* kc, void* vc, float* part,
                   int* counter, float* y, int D, int H, int S, int write_pos, int last, cudaStream_t st) {
  constexpr int HS = 128;
  using G = Geo<CT, HS>;
  static int ready[16];
  int err = allow_smem(ready, k1_attn_kernel<CT, HS>);
  if (err) return err;
  return launch_pdl(k1_attn_kernel<CT, HS>, dim3(last / split_rows(S, HS) + 1, H), dim3(THREADS), G::SMEM, st, qkv,
                    cosf, sinf, (CT*)kc, (CT*)vc, part, counter, y, D, S, write_pos, last,
                    (float)(1.0 / sqrt((double)HS)));
}

}  // namespace dsm90
