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
tensor cores, f32 compute an FFMA tile (``gemm_f32.cuh``). What bounds it and
how its design answers that is noted in the source.

``matmul_int4_ref`` is the plain version, the counterpart of
``matmul_int4_xla``: dequantize to the compute dtype, then one product with
float32 accumulation, rounded to the compute dtype.

``matmul_int8`` replaces the Pallas ``_int8_kernel`` (same file, entry
``matmul_int8``) with the CUDA kernel in ``csrc/quant_matmul_int8.cu``. On the
card an int8 linear takes it where ``quant_route`` holds, decode (M = 1) and
prefill alike, at any M, in bf16 or f32 compute: the TPU's M <= 128 gate is
not carried over.

``matmul_int8_ref`` is K6's plain version, in the Pallas kernel's own
arithmetic: x and the int8 weight in the compute dtype, the sum over K in
float32, the per-column float32 scale applied once at the end, then rounded
to the compute dtype. (``ops.linear.matmul_int8_dequant`` is the counterpart
of ``matmul_int8_xla``, which rounds scale * weight to the compute dtype
before the product.)
"""

from __future__ import annotations

import functools

import torch

from lit_llama_tpu_torch.ops import _build
from lit_llama_tpu_torch.ops.linear import dequantize_int4

_SIGS = {"k3_matmul_int4": [_build.PTR] * 6 + [_build.INT] * 5 + [_build.PTR],
         "k3_matmul_int4_f32": [_build.PTR] * 6 + [_build.INT] * 5 + [_build.PTR]}
_SIGS8 = {"k6_matmul_int8": [_build.PTR] * 5 + [_build.INT] * 5 + [_build.PTR]}
DTYPES = (torch.bfloat16, torch.float32)
_BM, _BN, _BK = 64, 128, 64  # the tile of both GEMM kernels (csrc/quant_matmul*.cu)
_GV_COLS = 128  # columns per block of K6's M == 1 body


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _gemm_splits(M: int, N: int, k_rows: int, device) -> int:
    """K splits of the tiled kernels (K3, and K6 at M > 1) that bring the grid
    to about two blocks per SM when the output tiles alone are fewer (small-N
    linears at prefill M). ``k_rows``: the weight rows a block walks (K/2
    packed rows for int4)."""
    tiles = -(-M // _BM) * -(-N // _BN)
    return max(1, min(2 * _sm_count(device) // tiles, k_rows // _BK // 4))


def f32_splits(N: int, K: int, device) -> int:
    """K splits of the f32 GEMM tile (``csrc/gemm_f32.cuh``: K3 and K6 at
    M > 1 in f32, the f32 bodies of K7 and K9): about two blocks per SM over
    the 128-column tiles of one 64-row tile, each split at least 512 rows of
    K. From the widths alone, so a row's sums do not depend on M."""
    return max(1, min(-(-2 * _sm_count(device) // -(-N // _BN)), K // 512))


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
        splits = f32_splits(N, K, x.device)
        ws = torch.empty((splits, M, N), dtype=torch.float32, device=x.device) if splits > 1 else None
        err = lib.k3_matmul_int4_f32(
            x2.data_ptr(), qw.data_ptr(), qscale.data_ptr(), qzero.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), M, N, K, gs, splits,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        _build.check(err, "K3 matmul_int4 (f32)")
        matmul_int4.launches += 1
        return out.reshape(*lead, N)
    splits = _gemm_splits(M, N, K // 2, x.device)
    ws = torch.empty((splits, M, N), dtype=torch.float32, device=x.device) if splits > 1 else None
    err = lib.k3_matmul_int4(
        x2.data_ptr(), qw.data_ptr(), qscale.data_ptr(), qzero.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), M, N, K, gs, splits,
        torch.cuda.current_stream(x.device).cuda_stream,
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
    if M == 1:
        splits = _gemv_splits_int8(N, K, x.device)
    else:
        splits = _gemm_splits(M, N, K, x.device) if cbf16 else f32_splits(N, K, x.device)
    ws = torch.empty((splits, M, N), dtype=torch.float32, device=x.device) if splits > 1 else None
    lib = _build.library("quant_matmul_int8", _SIGS8)
    err = lib.k6_matmul_int8(
        x2.data_ptr(), qw.data_ptr(), qscale.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), M, N, K, splits, int(cbf16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "K6 matmul_int8")
    matmul_int8.launches += 1
    return out.reshape(*lead, N)


matmul_int8.launches = 0
