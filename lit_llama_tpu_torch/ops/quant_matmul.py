"""Weight-only quantized matmuls: kernels K3 (int4) and K6 (int8) and their
plain versions (counterpart of lit_llama_tpu/ops/quant_matmul.py and
quant_matmul_pallas.py).

``matmul_int4`` replaces the Pallas ``_int4_kernel``
(lit_llama_tpu/ops/quant_matmul_pallas.py, entry ``matmul_int4``) with the
CUDA kernel in ``csrc/quant_matmul.cu``. On the card an int4 linear takes it
where its in and out widths are multiples of 256 (``quant_route``, the shape
condition of JAX's ``_use_pallas``), at any M and any group size: the TPU's
measured M thresholds are not carried over. Elsewhere ``ops.linear`` runs the
plain version, as JAX runs ``matmul_int4_xla`` there. bf16 compute takes the
Hopper mainloop (``csrc/gemm_sm90.cuh``: wgmma, TMA and cp.async, launched by
the plan of ``gemm_plan``), f32 compute an FFMA tile (``gemm_f32.cuh``:
register-blocked, cp.async ring, the weight dequantized once a block and
k-step, K splits added in order in the kernel, launched by the plan of
``f32_plan``). What bounds it and how its design answers that is noted in
the source.

``matmul_int4_ref`` is the plain version, the counterpart of
``matmul_int4_xla``: dequantize to the compute dtype, then one product with
float32 accumulation, rounded to the compute dtype.

``matmul_int8`` replaces the Pallas ``_int8_kernel`` (same file, entry
``matmul_int8``) with the CUDA kernel in ``csrc/quant_matmul_int8.cu``. On the
card an int8 linear takes it where ``quant_route`` holds, decode (M = 1) and
prefill alike, at any M, in bf16 or f32 compute: the TPU's M <= 128 gate is
not carried over. At M > 1 in bf16 it runs K3's mainloop (``gemm_plan``).

``matmul_int8_ref`` is K6's plain version, in the Pallas kernel's own
arithmetic: x and the int8 weight in the compute dtype, the sum over K in
float32, the per-column float32 scale applied once at the end, then rounded
to the compute dtype. (``ops.linear.matmul_int8_dequant`` is the counterpart
of ``matmul_int8_xla``, which rounds scale * weight to the compute dtype
before the product.)
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from lit_llama_tpu_torch.ops import _build, decode_attention
from lit_llama_tpu_torch.ops.linear import dequantize_int4

_SIGS = {"k3_matmul_int4": [_build.PTR] * 6 + [_build.INT] * 9 + [_build.PTR],
         "k3_matmul_int4_f32": [_build.PTR] * 6 + [_build.INT] * 5 + [_build.PTR]}
_SIGS8 = {"k6_matmul_int8": [_build.PTR] * 5 + [_build.INT] * 5 + [_build.PTR],
          "k6_matmul_int8_sm90": [_build.PTR] * 5 + [_build.INT] * 7 + [_build.PTR],
          "k6_matmul_int8_f32": [_build.PTR] * 5 + [_build.INT] * 4 + [_build.PTR]}
DTYPES = (torch.bfloat16, torch.float32)
_GV_COLS = 128  # columns per block of K6's M == 1 body
H100_SMS = 132

# The f32 tile (csrc/gemm_f32.cuh): 128 columns a block, k-steps of 32 rows,
# x's ring of F32_STAGES steps, 256 threads, two blocks an SM; a block takes
# the fewest of F32_ROWS rows that hold M, else 128
F32_BN, F32_BK, F32_STAGES, F32_THREADS = 128, 32, 3, 256
F32_ROWS = (32, 64, 128)
F32_SPLIT_MIN_K = 512  # rows of K a split takes at least

# The Hopper mainloop (csrc/gemm_sm90.cuh): 128 weight columns a block (64 a
# consumer warpgroup), k-steps of 64 logical rows, a token tile of one of
# SM90_TILES tokens (wgmma's n; csrc/wgmma.cuh has each)
SM90_BN, SM90_STEP, SM90_MAX_SMEM = 128, 64, 232448
SM90_TILES = (8, 16, 32, 64, 96, 128, 160, 192, 224, 256)


class GemmPlan(NamedTuple):
    """How K3, and K6 at M > 1, launch in bf16: a token tile of ``nt``
    tokens (``token_tiles`` of them over M), ``stages`` ring stages, ``gr``
    scale rows a plane of a stage spans (int4), K in ``splits`` parts of
    ``per`` k-steps of 64 logical rows, ``smem`` bytes a block."""
    nt: int
    token_tiles: int
    stages: int
    gr: int
    splits: int
    per: int
    smem: int


def _sm90_smem(int4: bool, nt: int, stages: int, gr: int) -> int:
    """A block's shared memory (csrc/gemm_sm90.cuh smem_bytes)."""
    bn = SM90_BN
    stage = -(-(nt * 2 * 64 + (32 * bn + gr * 16 * bn if int4 else 64 * bn)) // 1024) * 1024
    return 1024 + 2 * 2 * 2 * 32 * 64 * 2 + stages * stage + stages * 16


def gemm_plan(M: int, N: int, K: int, gs: int = 0, sm_count: int = H100_SMS) -> GemmPlan:
    """The launch plan of the Hopper mainloop, a pure function of the shapes:
    int4 where ``gs`` (the group size) is given, int8 where it is 0.

    The K split comes from N and K alone (about one wave of blocks over the
    SMs from the 128-column tiles, each split at least 8 k-steps), so a row's
    sums are added in the same order at any M. The token tile is the
    narrowest of SM90_TILES that holds M split evenly into tiles of at most
    256 (narrower where the scale rows of a group size under 32 leave no
    room); the ring is as deep as shared memory allows, at most 8 stages,
    with two blocks to an SM up to 128-token tiles."""
    if M < 1 or N < 1 or K < 1:
        raise ValueError(f"gemm_plan takes positive shapes, got M={M} N={N} K={K}")
    int4 = gs > 0
    steps = -(-K // SM90_STEP)
    tiles = -(-N // SM90_BN)
    splits = max(1, min(int(sm_count / tiles + 0.5), steps // 8))
    per = -(-steps // splits)
    splits = -(-steps // per)  # none empty
    gr = min(K // gs, 1 if gs % 32 == 0 else 31 // gs + 2) if int4 else 0
    rows = -(-M // -(-M // SM90_TILES[-1]))  # M split evenly into tiles of at most 256
    i = next(j for j, t in enumerate(SM90_TILES) if t >= rows)
    while True:
        nt = SM90_TILES[i]
        fixed = _sm90_smem(int4, nt, 0, gr)
        stage = _sm90_smem(int4, nt, 1, gr) - fixed
        budget = SM90_MAX_SMEM if nt > 128 else SM90_MAX_SMEM // 2 - 1024
        stages = min(8, (budget - fixed) // stage)
        if stages < 3:
            stages = min(8, (SM90_MAX_SMEM - fixed) // stage)
        if stages >= 2 or i == 0:
            break
        i -= 1  # the scale rows of a tiny group size leave no room: a narrower token tile
    if stages < 2:
        raise ValueError(f"gemm_plan: no ring of two stages fits (M={M} N={N} K={K} gs={gs})")
    return GemmPlan(nt, -(-M // nt), stages, gr, splits, per, _sm90_smem(int4, nt, stages, gr))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


class F32Plan(NamedTuple):
    """How the f32 tile launches: blocks of ``bm`` rows (``row_tiles`` of them
    over M) and 128 columns (``col_tiles``), K in ``splits`` parts of ``per``
    k-steps of 32 rows, ``smem`` bytes a block; ``step_groups``: one (group,
    column) scale and zero a k-step (32 divides gs), else one a row."""
    bm: int
    row_tiles: int
    col_tiles: int
    splits: int
    per: int
    smem: int
    step_groups: bool


def f32_smem(bm: int) -> int:
    """A block's shared memory (csrc/gemm_f32.cuh smem_bytes): x's ring, rows
    padded to 36 words, two dequantized weight steps, and a ring of the
    steps' scale and zero rows."""
    return (F32_STAGES * bm * (F32_BK + 4) + 2 * F32_BK * F32_BN + F32_STAGES * 2 * F32_BN) * 4


def f32_plan(M: int, N: int, K: int, gs: int = 0, sm_count: int = H100_SMS) -> F32Plan:
    """The launch plan of the f32 tile (K3 and K6 at M > 1 in f32, the f32
    bodies of K7 and K9), a pure function of the shapes; ``gs`` the int4
    group size (0: int8). The K split comes from N and K alone (about two
    blocks an SM over the 128-column tiles of one row tile, each split at
    least 512 rows of K), so a row's sums are added in the same order at any
    M; the splits of a tile are added into the output in split order."""
    if M < 1 or N < 1 or K < 1:
        raise ValueError(f"f32_plan takes positive shapes, got M={M} N={N} K={K}")
    col_tiles = -(-N // F32_BN)
    splits = max(1, min(-(-2 * sm_count // col_tiles), K // F32_SPLIT_MIN_K))
    steps = -(-K // F32_BK)
    per = -(-steps // splits)
    splits = -(-steps // per)  # none empty
    bm = next((r for r in F32_ROWS if r >= M), F32_ROWS[-1])
    return F32Plan(bm, -(-M // bm), col_tiles, splits, per, f32_smem(bm), gs % F32_BK == 0)


def f32_launch(M: int, N: int, K: int, device):
    """(splits, counter) for an f32-tile launch on ``device``: the plan's
    split count, and the tiles' arrival counters where K is split (None
    otherwise)."""
    plan = f32_plan(M, N, K, 0, _sm_count(device))
    if plan.splits == 1:
        return 1, None
    return plan.splits, decode_attention.arrival_counters(plan.row_tiles * plan.col_tiles, device)


def _gemv_splits_int8(N: int, K: int, device) -> int:
    """K splits of K6's M == 1 body: about four blocks per SM over the
    128-column strips, each with at least 256 rows to stream."""
    return max(1, min(-(-4 * _sm_count(device) // -(-N // _GV_COLS)), K // 256))


def quant_route(in_features: int, out_features: int) -> bool:
    """Whether a quantized linear takes its kernel (K3 or K6) on the card: a
    static predicate on the widths, decided before any launch."""
    return in_features % 256 == 0 and out_features % 256 == 0


def matmul_int4_ref(x, qw, qscale, qzero, compute_dtype=torch.bfloat16):
    w = dequantize_int4({"qw": qw, "qscale": qscale, "qzero": qzero}, compute_dtype)
    return (x.to(compute_dtype).float() @ w.float()).to(compute_dtype)


def check_int4(x, qw, qscale, qzero, compute_dtype):
    """What K3 takes, on any device; returns (K, N, gs). x in the compute
    dtype, bf16 or f32; K % 128 == 0, any group size gs dividing K, N % 8 ==
    0. Raises TypeError or ValueError otherwise."""
    if compute_dtype not in DTYPES or x.dtype != compute_dtype:
        raise TypeError(f"K3 takes bf16 or f32 compute with x in it (x {x.dtype}, compute {compute_dtype})")
    if qw.dtype != torch.uint8 or qscale.dtype != torch.float32 or qzero.dtype != torch.float32:
        raise TypeError("K3 takes uint8 qw and float32 qscale/qzero")
    Kh, N = qw.shape
    K = 2 * Kh
    G = qscale.shape[0]
    if x.shape[-1] != K or qscale.shape != (G, N) or qzero.shape != (G, N) or K % G:
        raise ValueError(f"K3 shape mismatch: x {tuple(x.shape)}, qw {tuple(qw.shape)}, "
                         f"qscale {tuple(qscale.shape)}")
    if K % 128 or N % 8:
        raise ValueError(f"K3 needs K % 128 == 0 and N % 8 == 0 (K={K} N={N})")
    return K, N, K // G


def _check_operands(x, qw, qscale, qzero, compute_dtype):
    K, N, gs = check_int4(x, qw, qscale, qzero, compute_dtype)
    for t in (x, qw, qscale, qzero):
        if not t.is_cuda or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("K3 operands must be contiguous, 16-byte aligned CUDA tensors")
    return K, N, gs


def matmul_int4(x, qw, qscale, qzero, compute_dtype=torch.bfloat16):
    """x (..., K) @ dequant(qw) -> (..., N) in the compute dtype. A CPU tensor
    takes the plain version; a CUDA tensor launches K3 or raises."""
    if not x.is_cuda:
        return matmul_int4_ref(x, qw, qscale, qzero, compute_dtype)
    K, N, gs = _check_operands(x, qw, qscale, qzero, compute_dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    lib = _build.library("quant_matmul", _SIGS)
    if x.dtype == torch.float32:
        splits, counter = f32_launch(M, N, K, x.device)
        err = lib.k3_matmul_int4_f32(
            x2.data_ptr(), qw.data_ptr(), qscale.data_ptr(), qzero.data_ptr(), out.data_ptr(),
            None if counter is None else counter.data_ptr(), M, N, K, gs, splits,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        _build.check(err, "K3 matmul_int4 (f32)")
        matmul_int4.launches += 1
        return out.reshape(*lead, N)
    plan = gemm_plan(M, N, K, gs, _sm_count(x.device))
    ws = torch.empty((plan.splits, M, N), dtype=torch.float32, device=x.device) if plan.splits > 1 else None
    err = lib.k3_matmul_int4(
        x2.data_ptr(), qw.data_ptr(), qscale.data_ptr(), qzero.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), M, N, K, gs, plan.nt, plan.stages, plan.gr, plan.splits,
        plan.per, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "K3 matmul_int4")
    matmul_int4.launches += 1
    return out.reshape(*lead, N)


matmul_int4.launches = 0


def matmul_int8_ref(x, qw, qscale, compute_dtype=torch.bfloat16):
    """K6's plain version: (x @ qw) summed in f32, times the (1, N) scale,
    rounded to the compute dtype once."""
    acc = x.to(compute_dtype).float() @ qw.float()
    return (acc * qscale.float().reshape(-1)).to(compute_dtype)


def check_int8(x, qw, qscale, compute_dtype):
    """What K6 takes, on any device; returns (K, N). x in the compute dtype,
    bf16 or f32; K % 8 == 0 and N % 16 == 0. Raises TypeError or ValueError
    otherwise."""
    if compute_dtype not in DTYPES or x.dtype != compute_dtype:
        raise TypeError(f"K6 takes bf16 or f32 compute with x in it (x {x.dtype}, compute {compute_dtype})")
    if qw.dtype != torch.int8 or qscale.dtype != torch.float32:
        raise TypeError("K6 takes int8 qw and float32 qscale")
    K, N = qw.shape
    if x.shape[-1] != K or qscale.numel() != N:
        raise ValueError(f"K6 shape mismatch: x {tuple(x.shape)}, qw {tuple(qw.shape)}, "
                         f"qscale {tuple(qscale.shape)}")
    if K % 8 or N % 16:
        raise ValueError(f"K6 needs K % 8 == 0 and N % 16 == 0 (K={K} N={N})")
    return K, N


def _check_operands_int8(x, qw, qscale, compute_dtype):
    K, N = check_int8(x, qw, qscale, compute_dtype)
    for t in (x, qw, qscale):
        if not t.is_cuda or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("K6 operands must be contiguous, 16-byte aligned CUDA tensors")
    return K, N


def matmul_int8(x, qw, qscale, compute_dtype=torch.bfloat16):
    """x (..., K) @ int8 qw (K, N), times qscale (1, N) -> (..., N) in the
    compute dtype. A CPU tensor takes the plain version; a CUDA tensor
    launches K6 or raises."""
    if not x.is_cuda:
        return matmul_int8_ref(x, qw, qscale, compute_dtype)
    K, N = _check_operands_int8(x, qw, qscale, compute_dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    cbf16 = x.dtype == torch.bfloat16
    lib = _build.library("quant_matmul_int8", _SIGS8)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if M > 1 and cbf16:
        plan = gemm_plan(M, N, K, 0, _sm_count(x.device))
        ws = torch.empty((plan.splits, M, N), dtype=torch.float32, device=x.device) if plan.splits > 1 else None
        err = lib.k6_matmul_int8_sm90(
            x2.data_ptr(), qw.data_ptr(), qscale.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), M, N, K, plan.nt, plan.stages, plan.splits, plan.per, stream,
        )
        _build.check(err, "K6 matmul_int8")
        matmul_int8.launches += 1
        return out.reshape(*lead, N)
    if M > 1:
        splits, counter = f32_launch(M, N, K, x.device)
        err = lib.k6_matmul_int8_f32(
            x2.data_ptr(), qw.data_ptr(), qscale.data_ptr(), out.data_ptr(),
            None if counter is None else counter.data_ptr(), M, N, K, splits, stream,
        )
        _build.check(err, "K6 matmul_int8 (f32)")
        matmul_int8.launches += 1
        return out.reshape(*lead, N)
    splits = _gemv_splits_int8(N, K, x.device)
    ws = torch.empty((splits, M, N), dtype=torch.float32, device=x.device) if splits > 1 else None
    err = lib.k6_matmul_int8(
        x2.data_ptr(), qw.data_ptr(), qscale.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), M, N, K, splits, int(cbf16), stream,
    )
    _build.check(err, "K6 matmul_int8")
    matmul_int8.launches += 1
    return out.reshape(*lead, N)


matmul_int8.launches = 0
