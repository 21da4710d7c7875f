// K3 at M == 1: one token times an int4 weight, out = x @ dequant(qw), the
// single-token matvec of every int4 linear in the per-op decode step (4 a
// block and the lm_head: 129 launches a 7B token). bf16 or f32 compute, one
// body.
//
// Replaces lit_llama_tpu/ops/quant_matmul_pallas.py _int4_kernel (and its
// _int4_kernel_fused_scale variant), entry matmul_int4, at M == 1. Layout
// (ops/linear.py): qw (K/2, N) bytes, packed row r holds logical row r in its
// low nibble and row r + K/2 in its high nibble; qscale / qzero (K/gs, N) f32,
// logical row k in group k / gs (with an odd group count a group straddles
// K/2; with gs = K both planes share group 0).
//
// Bound on the H100: bytes. The packed nibbles and 8 bytes of scale and zero
// a group and column (28.3 MB at c_attn 4096 -> 12288, 8.5 us at 3.35 TB/s;
// 73.7 MB, 22.0 us, at the lm_head; 3.72 GB, 1,113 us, a 7B token).
//
// What held the route it replaces (the prefill mainloop of gemm_sm90.cuh
// with an 8-token tile; 6,225 us a token, 18 % of the bound): its grid (96
// blocks on 132 SMs at c_attn), every weight rounded to bf16(q * scale +
// zero) and written to shared memory for a wgmma whose n = 8 held 7 zero
// tokens, a fresh (splits, 1, N) f32 workspace and a second kernel
// (splitk.cuh) for the split calls, and launches that waited for the kernel
// before them to end.
//
// Design.
//  - One wave of equal items (ops/quant_matmul.py gemv4_plan, from N, K and
//    the SM count alone): the weight is cut into strips of COLS columns and
//    the K/2 packed rows into `splits` ranges of whole steps of ROWS rows;
//    block b takes strip b % strips of split b / strips.
//  - Each warp owns WCOLS columns of its strip and keeps STAGES steps of
//    them (32 packed rows x 32 bytes) in flight in its registers, by plain
//    16-byte loads (a load instruction reads 16 rows of 32 contiguous bytes,
//    whole sectors); a step goes through the warp's own 1 KB tile in shared
//    memory to ldmatrix, so no block barrier is needed. Measured in the
//    per-op step against a cp.async ring of the same depth (3 % slower), a
//    6-step ring, three blocks an SM and block-wide loads of whole 256-byte
//    rows behind a block barrier (PERF.md §6, K3 at M = 1).
//  - Products on the tensor cores, mma.sync.m16n8k16: the weight's columns
//    on the 16-row side, K on k. ldmatrix.trans turns 8 packed rows x 16
//    columns into a thread's four nibble pairs of two columns, so one
//    32-bit word gives the whole A fragment: k slots 0-7 take the low
//    nibbles of 8 packed rows, slots 8-15 the high nibbles of the same rows
//    (logical rows K/2 later), and the token's columns of n separate the two
//    planes: n = 0 holds x at the low rows (slots 0-7), n = 1 x at the high
//    rows (slots 8-15), so an mma sums each plane of an 8-row octet apart.
//    With gs % 8 == 0 an octet lies in one group of each plane.
//  - bf16: a nibble pair becomes the exact bf16 pair (128 + n) by one mask
//    and OR, and the 128 * sum(x) this adds is taken out with the zero
//    point: a group adds scale * D + (zero - 128 * scale) * gx, D the mma's
//    f32 sum of bf16(x) * (128 + q) over the group's rows, gx the f32 sum of
//    x over them (the Pallas kernel's arithmetic: exact products summed in
//    f32, the group's sum times its f32 scale, the zero term from f32 group
//    sums of x). f32: x is split into three bf16 parts (x = x1 + x2 + x3,
//    exact), each on two columns of n (2p low, 2p + 1 high), and the
//    nibbles are exact (subtraction of 128): D is then the f32 sum of x * q.
//  - Programmatic dependent launch: the first STAGES steps of the weight and
//    the first groups' scales and zeros are requested before pdl_wait(); x,
//    written by the kernel before, only after it, and nothing is written
//    before it. The block's x rows (both planes), their bf16 parts, and the
//    f32 sums of x over each group's rows in the split (an octet's 8 rows
//    in order, then the octets in order) are staged in shared memory.
//  - The K split merged in the kernel, in split order, by the last block of a
//    strip to arrive (counter[strip], left at zero), from ws: the stream's
//    buffers of decode_attention.stream_buffer, so a call allocates only its
//    output. The order of every sum depends on N, K and the SM count alone.
#pragma once

#include <type_traits>

#include "mma.cuh"

namespace gemv4 {
// Internal linkage: each library that includes this header keeps its own
// kernels and shared-memory flags.
namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WCOLS = 32;                // columns a warp: two halves of 16, an mma's rows each
constexpr int COLS = WARPS * WCOLS;      // columns a strip: 256
constexpr int ROWS = 32;                 // packed rows a step: four octets, an mma's k each
constexpr int STAGES = 4;                // steps a warp keeps in flight
constexpr int BLOCKS_PER_SM = 2;
constexpr int STAGE_BYTES = ROWS * WCOLS;  // a warp's step: 1 KB
constexpr int TILE_BYTES = WARPS * STAGE_BYTES;

// The dynamic shared memory of a block whose split holds at most `rows`
// packed rows (a multiple of ROWS): the warps' tiles, x's bf16 parts (nb of
// them) of both planes, the octet sums and the group sums of x.
inline size_t smem_bytes(int rows, int nb) {
  return (size_t)TILE_BYTES + (size_t)nb * 2 * rows * 2 + (size_t)2 * (rows / 8) * 4 + (size_t)2 * (rows / 8 + 2) * 4;
}

// A warp's step in shared memory: 32 rows of 32 bytes, each row's two
// 16-byte halves swapped on rows 4-7 of every 8, so that the eight rows an
// ldmatrix phase reads fall in eight different bank quads.
__device__ __forceinline__ int swz(int row, int half) { return row * WCOLS + ((half ^ ((row >> 2) & 1)) << 4); }

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* smem) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// The A fragment of an octet from its ldmatrix word v (bytes: column 2g of
// packed rows 2t, 2t + 1 at 0 and 2, column 2g + 1 at 1 and 3): rows g and
// g + 8 are columns 2g and 2g + 1, k slots 2t, 2t + 1 their low nibbles and
// 2t + 8, 2t + 9 their high nibbles, as bf16 128 + q (EXACT: q).
template <bool EXACT>
__device__ __forceinline__ void a_frag(uint32_t v, uint32_t* a) {
  const uint32_t w[4] = {v, v >> 8, v >> 4, v >> 12};
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = EXACT ? nib2(w[i]) : (w[i] & 0x000F000Fu) | 0x43004300u;
}

// x (K) in XT (bf16 or f32), qw (K/2, N) u8, qscale / qzero (K/gs, N) f32
// -> out (N) XT, gs % 8 == 0 (STEPG: gs % 32 == 0, groups end only at step
// ends), N % VEC == 0 (VEC the load width: 16, or 8 where rows are 8-byte
// aligned only). The grid is strips x splits blocks; with splits > 1, ws
// holds a COLS-float partial a block and counter one int32 zero a strip,
// left at zero.
template <typename XT, int VEC, bool STEPG>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
gemv4_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ qw, const float* __restrict__ qs,
             const float* __restrict__ qz, XT* __restrict__ out, float* __restrict__ ws, int* __restrict__ counter,
             int N, int K, int gs, int splits) {
  constexpr bool F32 = sizeof(XT) == 4;
  constexpr int NB = F32 ? 3 : 1;                   // bf16 parts of x
  constexpr float BIAS = F32 ? 0.f : 128.f;         // what a nibble carries into the mma
  constexpr int PR = WCOLS / VEC;                   // loads a row of a warp's step
  constexpr int PIECES = ROWS * PR / 32;            // loads a lane and step
  using V = typename std::conditional<VEC == 16, uint4, uint2>::type;
  extern __shared__ __align__(16) uint8_t dsm[];
  __shared__ int last_block;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = lane / 4, t = lane % 4;
  const int strips = gridDim.x / splits, strip = blockIdx.x % strips, split = blockIdx.x / strips;
  const int Kh = K / 2, steps = Kh / ROWS, per = (steps + splits - 1) / splits;
  const int s0 = (int)((long long)split * steps / splits), n = (int)((long long)(split + 1) * steps / splits) - s0;
  const int R = per * ROWS, r0 = s0 * ROWS, nr = n * ROWS;  // R: the rows the buffers hold
  const int wc = strip * COLS + warp * WCOLS;               // the warp's first column
  uint8_t* tile = dsm + warp * STAGE_BYTES;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(dsm + TILE_BYTES);  // [NB][2][R]
  float* osum = reinterpret_cast<float*>(xs + NB * 2 * R);                // [2][R / 8]
  float* gxs = osum + 2 * (R / 8);                                        // [2][R / 8 + 2]
  const int GMAX = R / 8 + 2;

  // the warp's loads of a step: piece p = lane + 32 i is row p / PR, bytes
  // VEC * (p % PR) of the warp's 32 columns (a column past N reads qw's
  // first bytes: its sums are never written)
  const uint8_t* wsrc = qw + (size_t)r0 * N + wc;
  auto piece_src = [&](int j, int i) {
    const int p = lane + 32 * i, row = p / PR, off = VEC * (p % PR);
    return wc + off < N ? wsrc + ((size_t)j * ROWS + row) * N + off : qw;
  };
  auto piece_dst = [&](int i) {
    const int p = lane + 32 * i, row = p / PR, off = VEC * (p % PR);
    return swz(row, off >> 4) + (off & 15);
  };
  V regs[STAGES][PIECES];
  auto fetch = [&](int j, int u) {  // step j of the split into registers u
#pragma unroll
    for (int i = 0; i < PIECES; ++i) regs[u][i] = __ldg(reinterpret_cast<const V*>(piece_src(j, i)));
  };

  // the scales and zeros of a group of one plane for this lane's columns
  // (lanes t == 0 hold the sums: columns wc + 16 c + 2 g, + 1). Loaded by
  // every lane and unconditionally, a column past N from column N - 2 (its
  // sums are never written), so that nothing waits on them before their use
  // at the group's end.
  // Per-plane state is indexed by compile-time planes only (P0, P1), so it
  // stays in registers.
  float2 sc[2][2], zr[2][2];  // [plane][half]
  using P0 = std::integral_constant<int, 0>;
  using P1 = std::integral_constant<int, 1>;
  auto load_sz = [&](auto pc, int grp) {
    constexpr int plane = decltype(pc)::value;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const size_t at = (size_t)grp * N + min(wc + 16 * c + 2 * g, N - 2);
      sc[plane][c] = __ldg(reinterpret_cast<const float2*>(qs + at));
      zr[plane][c] = __ldg(reinterpret_cast<const float2*>(qz + at));
    }
  };

  // what depends on nothing: the first steps and the first groups' scales
#pragma unroll
  for (int j = 0; j < STAGES; ++j)
    if (j < n) fetch(j, j);
  int grp[2] = {r0 / gs, (Kh + r0) / gs};
  load_sz(P0{}, grp[0]);
  load_sz(P1{}, grp[1]);
  pdl_wait();
  pdl_trigger();

  // x of the split's rows in both planes: its bf16 parts, and the f32 sum of
  // each octet (8 rows in order); then each group's sum over its octets in
  // this split, in order
  const int noct = nr / 8;
  for (int i = tid; i < 2 * noct; i += THREADS) {
    const int plane = i / noct, o = i % noct;
    const XT* xp = x + (size_t)plane * Kh + r0 + 8 * o;
    float v[8];
    if constexpr (F32) {
      const float4 a = __ldcg(reinterpret_cast<const float4*>(xp)), b = __ldcg(reinterpret_cast<const float4*>(xp) + 1);
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
    } else {
      const uint4 a = __ldcg(reinterpret_cast<const uint4*>(xp));
      *reinterpret_cast<uint4*>(xs + (size_t)plane * R + 8 * o) = a;
      const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&a);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(b[e]);
    }
    float s = v[0];
#pragma unroll
    for (int e = 1; e < 8; ++e) s += v[e];
    osum[plane * (R / 8) + o] = s;
    if constexpr (F32) {  // x = x1 + x2 + x3, each bf16, exactly
      uint32_t p[3][4];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        float h[2] = {v[e], v[e + 1]};
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const __nv_bfloat16 lo = __float2bfloat16_rn(h[0]), hi = __float2bfloat16_rn(h[1]);
          p[q][e / 2] = pack_bf16(lo, hi);
          h[0] -= __bfloat162float(lo), h[1] -= __bfloat162float(hi);
        }
      }
#pragma unroll
      for (int q = 0; q < 3; ++q)
        *reinterpret_cast<uint4*>(xs + ((size_t)q * 2 + plane) * R + 8 * o) = make_uint4(p[q][0], p[q][1], p[q][2], p[q][3]);
    }
  }
  __syncthreads();
  for (int i = tid; i < 2 * GMAX; i += THREADS) {
    const int plane = i / GMAX, l = i % GMAX, gi = (plane * Kh + r0) / gs + l;
    // the group's rows of this plane in the split, as octets of the split
    const int lo = max(gi * gs - plane * Kh, r0) - r0, hi = min((gi + 1) * gs - plane * Kh, r0 + nr) - r0;
    if (lo >= hi) continue;
    float s = osum[plane * (R / 8) + lo / 8];
    for (int o = lo / 8 + 1; o < hi / 8; ++o) s += osum[plane * (R / 8) + o];
    gxs[plane * GMAX + l] = s;
  }
  __syncthreads();

  // x's word of an octet for this lane: rows 2t, 2t + 1 of part g / 2 in
  // plane g % 2 (lanes g >= 2 NB read part 0 and feed zeros)
  const bool feeds = g < 2 * NB;
  const uint32_t* xw = reinterpret_cast<const uint32_t*>(xs) + (size_t)(feeds ? g : 0) * R / 2 + t;
  const uint32_t m0 = feeds && !(g & 1) ? 0xFFFFFFFFu : 0u, m1 = feeds && (g & 1) ? 0xFFFFFFFFu : 0u;

  float d[2][4] = {}, acc[2][2] = {};
  int left[2] = {min(gs - r0 % gs, nr), min(gs - (Kh + r0) % gs, nr)}, lidx[2] = {0, 0};
  // a group of `plane` ends: its D (the x parts' columns summed, f32) times
  // the scale, plus the zero term, into the sums; the next group's scales
  auto flush = [&](auto pc, int done) {
    constexpr int plane = decltype(pc)::value;
    const float gx = gxs[plane * GMAX + lidx[plane]];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = d[c][2 * e + plane];
        if constexpr (NB == 3) {
          const float v1 = __shfl_down_sync(0xffffffffu, v, 1), v2 = __shfl_down_sync(0xffffffffu, v, 2);
          v = (v + v1) + v2;
        }
        const float s = e ? sc[plane][c].y : sc[plane][c].x, z = e ? zr[plane][c].y : zr[plane][c].x;
        acc[c][e] += fmaf(s, v, fmaf(-BIAS, s, z) * gx);
        d[c][2 * e + plane] = 0.f;
      }
    }
    const int rem = nr - done;
    if (rem > 0) {
      left[plane] = min(gs, rem);
      ++lidx[plane];
      load_sz(pc, ++grp[plane]);
    }
  };
  auto check = [&](int rows, int done) {
    left[0] -= rows;
    if (left[0] == 0) flush(P0{}, done);
    left[1] -= rows;
    if (left[1] == 0) flush(P1{}, done);
  };

#pragma unroll 1
  for (int j0 = 0; j0 < n; j0 += STAGES) {
#pragma unroll
    for (int u = 0; u < STAGES; ++u) {
      const int j = j0 + u;
      if (j >= n) break;
      // step j, from its registers through the warp's tile to the fragments;
      // its registers then take step j + STAGES
      uint32_t w[2][4];
#pragma unroll
      for (int i = 0; i < PIECES; ++i) *reinterpret_cast<V*>(tile + piece_dst(i)) = regs[u][i];
      __syncwarp();
      ldsm_x4_trans(w[0], tile + swz(lane, 0));
      ldsm_x4_trans(w[1], tile + swz(lane, 1));
      __syncwarp();
      if (j + STAGES < n) fetch(j + STAGES, u);
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        const uint32_t xv = xw[j * 16 + 4 * o];
        const uint32_t b0 = xv & m0, b1 = xv & m1;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          uint32_t a[4];
          a_frag<F32>(w[c][o], a);
          mma_bf16(d[c], a, b0, b1);
        }
        if constexpr (!STEPG) check(8, j * ROWS + 8 * (o + 1));
      }
      if constexpr (STEPG) {  // the groups that end with the step
        check(ROWS, (j + 1) * ROWS);
      }
    }
  }

  // lanes t == 0 hold the sums of columns wc + 16 c + 2 g + e
  if (splits == 1) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = wc + 16 * c + 2 * g;
      if (t == 0 && col < N) {
        out[col] = from_f32<XT>(acc[c][0]);
        out[col + 1] = from_f32<XT>(acc[c][1]);
      }
    }
    return;
  }
  if (t == 0) {
#pragma unroll
    for (int c = 0; c < 2; ++c)
      *reinterpret_cast<float2*>(ws + (size_t)blockIdx.x * COLS + warp * WCOLS + 16 * c + 2 * g) =
          make_float2(acc[c][0], acc[c][1]);
  }
  __threadfence();  // the partial is visible before the count that announces it
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(counter + strip, 1) == splits - 1;
  __syncthreads();
  if (last_block) {
    __threadfence();
    float v = __ldcg(ws + (size_t)strip * COLS + tid);
    for (int z = 1; z < splits; ++z) v += __ldcg(ws + ((size_t)z * strips + strip) * COLS + tid);
    // the strip out, and its counter back at zero for the next launch
    const int col = strip * COLS + tid;
    if (col < N) out[col] = from_f32<XT>(v);
    if (tid == 0) counter[strip] = 0;
  }
}

template <typename XT, int VEC, bool STEPG>
int launch_one(const XT* x, const uint8_t* qw, const float* qs, const float* qz, XT* out, float* ws, int* counter,
               int N, int K, int gs, int splits, cudaStream_t st) {
  static int ready[16];
  const int err = allow_smem(ready, gemv4_kernel<XT, VEC, STEPG>);
  if (err) return err;
  const int steps = K / 2 / ROWS, rows = (steps + splits - 1) / splits * ROWS;
  const dim3 grid((N + COLS - 1) / COLS * splits);
  return launch_pdl(gemv4_kernel<XT, VEC, STEPG>, grid, dim3(THREADS), smem_bytes(rows, sizeof(XT) == 4 ? 3 : 1), st,
                    x, qw, qs, qz, out, ws, counter, N, K, gs, splits);
}

// K % 128 == 0, gs % 8 == 0 dividing K, N % 8 == 0, 16-byte aligned operands
// (checked by the Python wrapper).
template <typename XT>
int launch(const XT* x, const uint8_t* qw, const float* qs, const float* qz, XT* out, float* ws, int* counter, int N,
           int K, int gs, int splits, cudaStream_t st) {
  if (K % 128 || gs % 8 || K % gs || N % 8) return (int)cudaErrorInvalidValue;
  const bool stepg = gs % ROWS == 0;
  if (N % 16 == 0)
    return stepg ? launch_one<XT, 16, true>(x, qw, qs, qz, out, ws, counter, N, K, gs, splits, st)
                 : launch_one<XT, 16, false>(x, qw, qs, qz, out, ws, counter, N, K, gs, splits, st);
  return stepg ? launch_one<XT, 8, true>(x, qw, qs, qz, out, ws, counter, N, K, gs, splits, st)
               : launch_one<XT, 8, false>(x, qw, qs, qz, out, ws, counter, N, K, gs, splits, st);
}

}  // namespace
}  // namespace gemv4
