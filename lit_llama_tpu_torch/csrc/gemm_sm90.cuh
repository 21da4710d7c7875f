// The Hopper mainloop of the weight-only GEMMs at M > 1 in bf16 compute:
// K3 (int4, quant_matmul.cu) and K6 (int8, quant_matmul_int8.cu).
//
// Bound on the H100 at prefill M (8..512): the packed weight stream (K * N
// bytes in int8, K * N / 2 in int4) up to about M = 300 (int8) or 150
// (int4), the tensor-core work 2 * M * K * N past it.
//
// Design. The product is computed transposed, out^T = W^T x^T, so that the
// weight's output columns take wgmma's 64-row M side and the tokens its n
// side: a block owns 128 weight columns and a token tile of NT tokens (a
// template parameter, wgmma's n: 8 to 256, the smallest that holds M, or M
// split evenly past 256), so a prefill of up to 256 tokens is one token tile,
// multiplies no rows of zeros beyond the rounding to NT, and reads and
// converts each weight element once. The weight keeps the (K, N) / (K/2, N)
// layout the JAX package stores: converted to bf16 it is wgmma's A operand in
// MN-major form (n contiguous, 128-byte swizzle), written to shared memory by
// the two consumer warpgroups themselves, each owning 64 of the block's 128
// columns, so a block reads 128 contiguous bytes of each int8 weight row (64
// of int4) and each x slab serves 128 columns.
//  - One producer warp keeps a ring of `stages` stages full by TMA
//    (cp.async.bulk.tensor): the x columns of the stage's 64 logical rows
//    (int8 one 64-column box, 128-byte swizzle; int4 two 32-column boxes K/2
//    apart, 64-byte swizzle: wgmma's K-major B operand as it lands), the
//    weight's raw bytes and, for int4, the rows of scale and zero they use.
//    Where the weight's row stride (N bytes) is no multiple of 16, as TMA
//    needs, the weight and the scales come by cp.async from the warp's 32
//    lanes. One mbarrier a stage says full (the TMA bytes, and the lanes'
//    cp.async where they copy), one says empty.
//  - A consumer warpgroup (128 threads) converts stage i + 1 to bf16 while
//    the tensor cores run stage i's four wgmmas (issued asynchronously; the
//    wait for stage i - 1 frees its bf16 buffer), so the conversion runs
//    beside the products, and the producer's copies beside both. A thread
//    converts 4 columns of 8 (int8) or 4 (int4) rows a stage, keeping the 4
//    columns' scales and zeros in registers while their group lasts.
//  - A stage is two planes of 32 logical k rows: int8 rows k0..k0+31 and
//    k0+32..k0+63; int4 the low and high nibbles of 32 packed rows (logical
//    rows r0.. and K/2 + r0..), against the matching x slabs, so the
//    half-split layout costs no second pass over the weight.
//  - Conversion: a byte or a nibble becomes an f32 by a byte permute under
//    the exponent of 2^23 and one exact subtraction; int8 -> bf16 then by one
//    cvt.rn.bf16x2.f32 a pair (exact); int4 bf16(q * scale + zero) with an
//    f32 product and an f32 sum, never contracted, bit-equal to the plain
//    version's dequantized weight. The int8 column scale multiplies the f32
//    sum in the epilogue.
//  - K is split over blockIdx.z by a count that comes from N and K alone
//    (ops/quant_matmul.py gemm_plan), the partials summed in split order by
//    splitk.cuh: a row's output is the same bits at any M and on a rerun.
#pragma once

#include <cuda.h>

#include "splitk.cuh"
#include "wgmma.cuh"

namespace sm90 {

constexpr int WN = 64;                     // weight columns a consumer warpgroup: wgmma's M
constexpr int WGS = 2;                     // consumer warpgroups a block
constexpr int BN = WGS * WN;               // weight columns a block
constexpr int KP = 32;                     // logical k rows of one plane a stage
constexpr int CONSUMERS = 128 * WGS, THREADS = CONSUMERS + 32;
constexpr int A_PLANE = KP * WN * 2;       // one bf16 plane of one warpgroup: 4096 bytes
constexpr int A_BUF = WGS * 2 * A_PLANE;   // one buffer: two planes a warpgroup
constexpr int A_BYTES = 2 * A_BUF;         // double-buffered
constexpr int MAX_SMEM = 232448;           // what a block may use on the H100

// bytes of one stage of the ring (1024-aligned, as the swizzles need): x (NT
// rows x 128 bytes), the raw weight, the int4 scale rows
__host__ __device__ constexpr int stage_bytes(bool int4, int nt, int gr) {
  return (nt * 2 * 64 + (int4 ? KP * BN + gr * 16 * BN : 2 * KP * BN) + 1023) / 1024 * 1024;
}
// the block's dynamic shared memory: alignment slack, the bf16 tiles, the
// ring and its barriers
__host__ __device__ constexpr int smem_bytes(bool int4, int nt, int stages, int gr) {
  return 1024 + A_BYTES + stages * stage_bytes(int4, nt, gr) + stages * 16;
}

struct Params {
  const uint8_t* w;       // int8 (K, N) or int4 packed (K/2, N)
  const float* qscale;    // int8 (N); int4 (G, N)
  const float* qzero;     // int4 (G, N)
  __nv_bfloat16* out;     // (M, N)
  float* ws;              // (splits, M, N) f32 partials, or null for one split
  int M, N, K, gs, G, gr; // gr: scale rows a plane of a stage spans (int4)
  int steps, per, stages; // k-steps of 64 logical rows, steps a split, ring depth
  int wmaps;              // 1: the weight and its scale rows come by TMA (N % 16 == 0), else by cp.async
};

// The tensor maps of a launch: x, the weight, and the int4 scale and zero
struct Maps {
  CUtensorMap x, w, s, z;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(b), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t b, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(b) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t b, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes) : "memory");
}
// one lane's earlier cp.async copies arrive on b when they land (counted in
// the barrier's init count)
__device__ __forceinline__ void cp_async_arrive(uint32_t b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(b) : "memory");
}
// 16 or 8 bytes global -> shared; zeros where !ok
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src), "r"(ok ? 8 : 0) : "memory");
}
// the (c0, c1) box of tensor map tm into shared memory, completing on b
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* tm, int c0, int c1, uint32_t b) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1), "r"(b)
      : "memory");
}
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
// the 128 threads of consumer warpgroup wg (barriers 1 and 2: immediates, so
// that the kernel holds three hardware barriers, not all sixteen)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  if (wg == 0)
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }

// wgmma's shared-memory matrix descriptor: start, leading and stride byte
// offsets (16-byte units) and the swizzle (1: 128 bytes, 2: 64 bytes)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint64_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | swizzle << 62;
}

// the f32 of a byte in [0, 255] placed by a byte permute under the exponent
// of 2^23: 2^23 + v, less 2^23 exactly
__device__ __forceinline__ float byte_f32(uint32_t w, uint32_t sel) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, sel)) - 8388608.f;
}
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// four int8 of w (columns 0..3) as two exact bf16 pairs: byte v + 128 under
// the exponent of 2^23, less 2^23 + 128
__device__ __forceinline__ uint2 s8x4_bf16(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) f[e] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + e)) - 8388736.f;
  return make_uint2(bf16x2(f[0], f[1]), bf16x2(f[2], f[3]));
}

// four nibbles (one a byte of q, columns 0..3) as bf16(q * s + z), the
// product and the sum each rounded in f32
__device__ __forceinline__ uint2 u4x4_bf16(uint32_t q, const float* s, const float* z) {
  float f[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) f[e] = __fadd_rn(__fmul_rn(byte_f32(q, 0x7440 + e), s[e]), z[e]);
  return make_uint2(bf16x2(f[0], f[1]), bf16x2(f[2], f[3]));
}

__device__ __forceinline__ void load4f(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
}

// The consumer thread's part of a stage: columns 4 cg .. 4 cg + 3 of its
// warpgroup's 64, rows rg + 8 j. A bf16 plane keeps row r's 16-byte chunk c
// at chunk c ^ (r % 8) (the 128-byte swizzle); r % 8 == rg here.
struct Part {
  int cg, rg, so;  // so: the byte offset of the thread's 8 bytes in a row
  __device__ __forceinline__ Part(int t) : cg(t % 16), rg(t / 16), so((((t % 16) >> 1) ^ (t / 16)) << 4 | (t & 1) << 3) {}
};

// int4 scales and zeros of the thread's 4 columns in both planes
struct Scales {
  float s0[4], z0[4], s1[4], z1[4];
};

// Which steps of an int4 weight bring scale rows other than the step
// before's: every step where a plane of a step spans more than one group
// (gr > 1); else (gs % 32 == 0) a plane's group changes where its first row
// is a multiple of gs. The rows' remainders mod gs are carried from step to
// step, so the loop divides nothing.
struct GroupTrack {
  int r0, r1;  // the first logical row of each plane, mod gs, at the next step
  __device__ __forceinline__ GroupTrack(const Params& p, int s)
      : r0(s * KP % p.gs), r1((p.K / 2 + s * KP) % p.gs) {}
  __device__ __forceinline__ bool next(const Params& p, bool first) {
    const bool fresh = first || p.gr != 1 || r0 == 0 || r1 == 0;
    r0 += KP, r1 += KP;
    if (r0 >= p.gs) r0 -= p.gs;
    if (r1 >= p.gs) r1 -= p.gs;
    return fresh;
  }
};

// warpgroup wg's 64 columns of the raw int8 bytes of a stage into its bf16
// planes at a
__device__ __forceinline__ void convert8(const unsigned char* raw, unsigned char* a, int wg, const Part& q) {
  const unsigned char* src = raw + q.rg * BN + wg * WN + q.cg * 4;
  uint32_t w[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] = *reinterpret_cast<const uint32_t*>(src + j * 8 * BN);
#pragma unroll
  for (int j = 0; j < 8; ++j)  // row rg + 8 j: plane j / 4, row rg + 8 (j % 4) in it
    *reinterpret_cast<uint2*>(a + (j / 4) * A_PLANE + (q.rg + 8 * (j % 4)) * 128 + q.so) = s8x4_bf16(w[j]);
}

// the same for the packed int4 bytes of step s: 32 packed rows, low nibbles
// into plane 0, high nibbles into plane 1; sz the stage's scale rows
// [plane][scale | zero][gr][BN]
__device__ __forceinline__ void convert4(const Params& p, const unsigned char* raw, const float* sz, unsigned char* a,
                                         int s, bool groups, int wg, const Part& q, Scales& sc) {
  const unsigned char* src = raw + q.rg * BN + wg * WN + q.cg * 4;
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = *reinterpret_cast<const uint32_t*>(src + j * 8 * BN);
  const int col = wg * WN + q.cg * 4, Kh = p.K / 2, r0 = s * KP;
  if (p.gr == 1 && groups) {  // one group a plane: the stage's first scale rows
    load4f(sz + col, sc.s0);
    load4f(sz + BN + col, sc.z0);
    load4f(sz + 2 * BN + col, sc.s1);
    load4f(sz + 3 * BN + col, sc.z1);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = q.rg + 8 * j;
    if (p.gr != 1) {  // the row's own groups
      const int g0 = (r0 + r) / p.gs - r0 / p.gs, g1 = (Kh + r0 + r) / p.gs - (Kh + r0) / p.gs;
      load4f(sz + g0 * BN + col, sc.s0);
      load4f(sz + (p.gr + g0) * BN + col, sc.z0);
      load4f(sz + (2 * p.gr + g1) * BN + col, sc.s1);
      load4f(sz + (3 * p.gr + g1) * BN + col, sc.z1);
    }
    const uint32_t lo = w[j] & 0x0F0F0F0Fu, hi = (w[j] >> 4) & 0x0F0F0F0Fu;
    *reinterpret_cast<uint2*>(a + r * 128 + q.so) = u4x4_bf16(lo, sc.s0, sc.z0);
    *reinterpret_cast<uint2*>(a + A_PLANE + r * 128 + q.so) = u4x4_bf16(hi, sc.s1, sc.z1);
  }
}

// the producer's copies for step s into stage memory at shared address spa,
// completing on the full barrier fb; `groups`: the int4 scale rows too. With
// p.wmaps one lane issues TMA for everything; else the weight and its scale
// rows come by cp.async from all 32 lanes (rows of N bytes need not be
// 16-byte aligned), each lane arriving on fb when its copies land.
template <bool INT4, int NT>
__device__ __forceinline__ void produce(const Params& p, const Maps& mp, uint32_t spa, uint32_t fb, int s,
                                        bool groups, int m0, int n0, int lane) {
  constexpr int X_SLAB = NT * 64;  // bytes of NT rows x 32 bf16: an int4 plane's x, half an int8 stage's
  constexpr int RAW = INT4 ? KP * BN : 2 * KP * BN;
  const uint32_t raw = spa + 2 * X_SLAB, sz = raw + RAW;
  const int gb0 = INT4 ? s * KP / p.gs : 0, gb1 = INT4 ? (p.K / 2 + s * KP) / p.gs : 0;
  if (lane == 0) {
    const int sz_bytes = INT4 && groups ? 4 * p.gr * BN * 4 : 0;
    mbar_expect_tx(fb, 2 * X_SLAB + (p.wmaps ? RAW + sz_bytes : 0));
    // int8: one box of 64 columns; int4: the two planes' 32 columns, K / 2 apart
    tma_2d(spa, &mp.x, INT4 ? s * KP : s * 2 * KP, m0, fb);
    if (INT4) tma_2d(spa + X_SLAB, &mp.x, p.K / 2 + s * KP, m0, fb);
    if (p.wmaps) {
      tma_2d(raw, &mp.w, n0, INT4 ? s * KP : s * 2 * KP, fb);
      if (sz_bytes) {  // [plane][scale | zero][gr][BN]
        tma_2d(sz, &mp.s, n0, gb0, fb);
        tma_2d(sz + p.gr * BN * 4, &mp.z, n0, gb0, fb);
        tma_2d(sz + 2 * p.gr * BN * 4, &mp.s, n0, gb1, fb);
        tma_2d(sz + 3 * p.gr * BN * 4, &mp.z, n0, gb1, fb);
      }
    }
  }
  if (p.wmaps) return;
  if constexpr (!INT4) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {  // 64 rows x 8 chunks of 16 bytes
      const int c = lane + 32 * j, row = c / 8, col = n0 + (c % 8) * 16, k = s * 2 * KP + row;
      const bool ok = k < p.K && col < p.N;
      cp_async16(raw + row * BN + (c % 8) * 16, p.w + (ok ? (size_t)k * p.N + col : 0), ok);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) {  // 32 packed rows x 16 chunks of 8 bytes
      const int c = lane + 32 * j, row = c / 16, col = n0 + (c % 16) * 8;
      const bool ok = col < p.N;
      cp_async8(raw + row * BN + (c % 16) * 8, p.w + (ok ? (size_t)(s * KP + row) * p.N + col : 0), ok);
    }
    if (groups) {
      for (int c = lane; c < 4 * p.gr * (BN / 4); c += 32) {  // [plane][scale | zero][gr] rows of 32 chunks
        const int col4 = c % (BN / 4), rest = c / (BN / 4), i = rest % p.gr, which = rest / p.gr;  // plane * 2 + zero
        const int g = ((which >> 1) ? gb1 : gb0) + i, col = n0 + col4 * 4;
        const bool ok = g < p.G && col < p.N;
        const float* src = (which & 1) ? p.qzero : p.qscale;
        cp_async16(sz + (which * p.gr + i) * BN * 4 + col4 * 16, src + (ok ? (size_t)g * p.N + col : 0), ok);
      }
    }
  }
  cp_async_arrive(fb);
}

// two blocks to an SM up to 128-token tiles (their ring fits twice)
template <bool INT4, int NT>
__global__ void __launch_bounds__(THREADS, NT <= 128 ? 2 : 1) wq_gemm_kernel(const __grid_constant__ Maps mp, const Params p) {
  constexpr int X_SLAB = NT * 64;  // as in produce
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_base = smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw_base + 1023) & ~1023u) - raw_base);  // 1024-aligned
  const uint32_t sma = smem_u32(sm);
  const int sb = stage_bytes(INT4, NT, p.gr);
  const uint32_t bars = sma + A_BYTES + p.stages * sb;  // full[stages], then empty[stages]

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * NT;
  const int s_begin = blockIdx.z * p.per;
  const int nsteps = min(p.steps, s_begin + p.per) - s_begin;
  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(bars + 8 * i, p.wmaps ? 1 : 33);  // the TMA bytes' arrival (+ 32 cp.async lanes)
      mbar_init(bars + 8 * (p.stages + i), WGS);  // each consumer warpgroup's release
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp
    const int lane = tid - CONSUMERS;
    GroupTrack gt(p, s_begin);
    for (int i = 0; i < nsteps; ++i) {
      const int st = i % p.stages;
      mbar_wait(bars + 8 * (p.stages + st), ((i / p.stages) & 1) ^ 1);
      produce<INT4, NT>(p, mp, sma + A_BYTES + st * sb, bars + 8 * st, s_begin + i, INT4 && gt.next(p, i == 0), m0,
                        n0, lane);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // a consumer warpgroup: 64 weight columns from n0 + 64 wg
  const int wg = tid / 128, t128 = tid % 128;
  const Part part(t128);
  Scales sc;
  GroupTrack gt(p, s_begin);
  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;

  auto stage_ptr = [&](int i) { return sm + A_BYTES + (i % p.stages) * sb; };
  auto a_tile = [&](int i) { return (i & 1) * A_BUF + wg * 2 * A_PLANE; };
  auto convert_step = [&](int i) {
    mbar_wait(bars + 8 * (i % p.stages), (i / p.stages) & 1);
    const unsigned char* raw = stage_ptr(i) + 2 * X_SLAB;
    if constexpr (INT4)
      convert4(p, raw, reinterpret_cast<const float*>(raw + KP * BN), sm + a_tile(i), s_begin + i, gt.next(p, i == 0),
               wg, part, sc);
    else
      convert8(raw, sm + a_tile(i), wg, part);
    fence_proxy_async();  // the bf16 tile, written by threads, is read by wgmma
  };
  if (nsteps > 0) convert_step(0);
  warpgroup_sync(wg);
  // stage i's wgmmas stay in flight while stage i + 1 is converted; the wait
  // for i - 1 frees its bf16 buffer and its ring stage
  for (int i = 0; i < nsteps; ++i) {
    // descriptors advance by their start address (16-byte units)
    const uint64_t da = gmma_desc(sma + a_tile(i), A_PLANE, 1024, 1);
    // x: int4 two slabs of 64-byte rows (64-byte swizzle), int8 one slab of
    // 128-byte rows (128-byte swizzle)
    const uint64_t db = INT4 ? gmma_desc(smem_u32(stage_ptr(i)), 16, 512, 2)
                             : gmma_desc(smem_u32(stage_ptr(i)), 16, 1024, 1);
    wgmma_fence();
#pragma unroll
    for (int pl = 0; pl < 2; ++pl)
#pragma unroll
      for (int j = 0; j < 2; ++j)  // k16 steps: 16 rows of the plane, 32 bytes of an x row
        wgmma<NT>(acc, da + (pl * A_PLANE + j * 2048) / 16, db + ((INT4 ? pl * X_SLAB : pl * 64) + j * 32) / 16);
    wgmma_commit();
    wgmma_wait<1>();
    if (i > 0 && t128 == 0) mbar_arrive(bars + 8 * (p.stages + (i - 1) % p.stages));
    if (i + 1 < nsteps) convert_step(i + 1);  // beside the products
    warpgroup_sync(wg);
  }
  wgmma_wait<0>();

  // acc[4 j + v]: weight column n0 + 64 wg + 16 warp + g (+ 8 for v >= 2),
  // token m0 + 8 j + 2 t (+ 1 for odd v)
  const int warp = t128 / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  float* wz = p.ws == nullptr ? nullptr : p.ws + (size_t)blockIdx.z * p.M * p.N;
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) {
    const int n = n0 + WN * wg + 16 * warp + g + 8 * ((i >> 1) & 1);
    const int m = m0 + 8 * (i >> 2) + 2 * t + (i & 1);
    if (m >= p.M || n >= p.N) continue;
    const size_t o = (size_t)m * p.N + n;
    if (wz != nullptr)
      wz[o] = acc[i];
    else
      p.out[o] = __float2bfloat16_rn(INT4 ? acc[i] : acc[i] * p.qscale[n]);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up through the CUDA runtime, so that
// nothing links libcuda by hand
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// a 2-D row-major tensor map: `cols` x `rows` elements of `bytes` each, a
// box of box_cols x box_rows
inline int map_2d(CUtensorMap* tm, CUtensorMapDataType type, int bytes, const void* base, int cols, int rows,
                  int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows}, strides[1] = {(cuuint64_t)cols * bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows}, one[2] = {1, 1};
  const CUresult r = enc(tm, type, 2, const_cast<void*>(base), dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// x (M, K) bf16 in slabs of 32 columns x NT tokens with the 64-byte swizzle;
// where N % 16 == 0 the weight in boxes of 128 columns x a stage's rows and
// the int4 scale and zero in boxes of 128 columns x gr rows (zeros past the
// edges), else p.wmaps = 0 and those come by cp.async
template <bool INT4, int NT>
int make_maps(Maps* mp, Params* p, const void* x) {
  int err = INT4 ? map_2d(&mp->x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, p->K, p->M, 32, NT, CU_TENSOR_MAP_SWIZZLE_64B)
                 : map_2d(&mp->x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, p->K, p->M, 64, NT, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  p->wmaps = p->N % 16 == 0;
  if (!p->wmaps) {
    mp->w = mp->s = mp->z = mp->x;
    return 0;
  }
  err = map_2d(&mp->w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p->w, p->N, INT4 ? p->K / 2 : p->K, BN,
               INT4 ? KP : 2 * KP, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err || !INT4) {
    mp->s = mp->z = mp->w;
    return err;
  }
  err = map_2d(&mp->s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, p->qscale, p->N, p->G, BN, p->gr, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  return map_2d(&mp->z, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, p->qzero, p->N, p->G, BN, p->gr, CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <bool INT4, int NT>
int launch_nt(const void* x, Params p, int splits, cudaStream_t st) {
  Maps mp;
  int err = make_maps<INT4, NT>(&mp, &p, x);
  if (err) return err;
  const int smem = smem_bytes(INT4, NT, p.stages, p.gr);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  err = (int)cudaFuncSetAttribute(wq_gemm_kernel<INT4, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  const dim3 grid((p.N + BN - 1) / BN, (p.M + NT - 1) / NT, splits);
  wq_gemm_kernel<INT4, NT><<<grid, THREADS, smem, st>>>(mp, p);
  return (int)cudaGetLastError();
}

// The GEMM, then the fixed-order sum of its splits (times the int8 column
// scale) where K is split. nt: the token tile, one of wgmma.cuh's widths.
template <bool INT4>
int launch(const void* x, const Params& p, int nt, int splits, cudaStream_t st) {
  int err;
  switch (nt) {
#define LLT_NT(N) \
  case N:         \
    err = launch_nt<INT4, N>(x, p, splits, st); \
    break;
    LLT_NT(8) LLT_NT(16) LLT_NT(32) LLT_NT(64) LLT_NT(96) LLT_NT(128) LLT_NT(160) LLT_NT(192) LLT_NT(224) LLT_NT(256)
#undef LLT_NT
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  if (splits > 1)
    splitk::launch_splitk_reduce(p.ws, INT4 ? nullptr : p.qscale, p.out, (size_t)p.M * p.N, p.N, splits, st);
  return (int)cudaGetLastError();
}

}  // namespace sm90
