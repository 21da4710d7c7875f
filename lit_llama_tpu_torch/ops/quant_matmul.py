"""Int4 weight-only matmul: kernel K3 and its plain version (counterpart of
lit_llama_tpu/ops/quant_matmul.py and quant_matmul_pallas.py).

``matmul_int4`` replaces the Pallas ``_int4_kernel``
(lit_llama_tpu/ops/quant_matmul_pallas.py, entry ``matmul_int4``) with the
CUDA kernel in ``csrc/quant_matmul.cu``. On the card every int4 linear of the
prefill takes it, at any M: the TPU's measured M thresholds are not carried
over. What bounds it and how its design answers that is noted in the source.

``matmul_int4_ref`` is the plain version, the counterpart of
``matmul_int4_xla``: dequantize to the compute dtype, then one product with
float32 accumulation, rounded to the compute dtype.
"""

from __future__ import annotations

import torch

from lit_llama_tpu_torch.ops import _build
from lit_llama_tpu_torch.ops.linear import dequantize_int4

_SIGS = {"k3_matmul_int4": [_build.PTR] * 6 + [_build.INT] * 5 + [_build.PTR]}
_BM, _BN, _BK = 64, 128, 64  # the kernel's tile (csrc/quant_matmul.cu)


def _splits(M: int, N: int, K: int, device) -> int:
    """K splits that bring the grid to about two blocks per SM when the
    output tiles alone are fewer (small-N linears at prefill M)."""
    tiles = -(-M // _BM) * -(-N // _BN)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(2 * sms // tiles, K // 2 // _BK // 4))


def matmul_int4_ref(x, qw, qscale, qzero, compute_dtype=torch.bfloat16):
    w = dequantize_int4({"qw": qw, "qscale": qscale, "qzero": qzero}, compute_dtype)
    return (x.to(compute_dtype).float() @ w.float()).to(compute_dtype)


def _check_operands(x, qw, qscale, qzero, compute_dtype):
    if compute_dtype != torch.bfloat16 or x.dtype != torch.bfloat16:
        raise TypeError(f"K3 takes bf16 compute only (x {x.dtype}, compute {compute_dtype})")
    if qw.dtype != torch.uint8 or qscale.dtype != torch.float32 or qzero.dtype != torch.float32:
        raise TypeError("K3 takes uint8 qw and float32 qscale/qzero")
    for t in (x, qw, qscale, qzero):
        if not t.is_cuda or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("K3 operands must be contiguous, 16-byte aligned CUDA tensors")
    Kh, N = qw.shape
    K = 2 * Kh
    G = qscale.shape[0]
    if x.shape[-1] != K or qscale.shape != (G, N) or qzero.shape != (G, N) or K % G:
        raise ValueError(f"K3 shape mismatch: x {tuple(x.shape)}, qw {tuple(qw.shape)}, "
                         f"qscale {tuple(qscale.shape)}")
    gs = K // G
    if gs % 64 or Kh % gs or N % 8:
        raise ValueError(f"K3 needs gs % 64 == 0, (K/2) % gs == 0, N % 8 == 0 (K={K} N={N} gs={gs})")
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
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    splits = _splits(M, N, K, x.device)
    ws = torch.empty((splits, M, N), dtype=torch.float32, device=x.device) if splits > 1 else None
    lib = _build.library("quant_matmul", _SIGS)
    err = lib.k3_matmul_int4(
        x2.data_ptr(), qw.data_ptr(), qscale.data_ptr(), qzero.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), M, N, K, gs, splits,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "K3 matmul_int4")
    matmul_int4.launches += 1
    return out.reshape(*lead, N)


matmul_int4.launches = 0
