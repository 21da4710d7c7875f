"""Linear-layer variants, resolved from parameter keys (counterpart of
lit_llama_tpu/ops/linear.py). A linear is a dict of tensors:

  dense        {"w": (in, out)}
  int8         {"qw": int8 (in, out), "qscale": f32 (1, out)}
  int4         {"qw": uint8 (in//2, out), "qscale": f32 (in//gs, out),
                "qzero": f32 (in//gs, out)}
  + adapter_v2 {"av2_scale": (1, out), "av2_bias": (1, out)}

Weights are stored (in, out), as in the JAX package, so one parameter tree
feeds both. Int4 nibbles are packed half-split along ``in``: packed row i holds
row i in its low nibble and row i + in//2 in its high nibble. Dequantization
is ``q * scale + zero`` with zero the group minimum.
"""

from __future__ import annotations

from typing import Dict

import torch

Params = Dict[str, torch.Tensor]


def quantize_int8(w: torch.Tensor) -> Params:
    """Symmetric per-output-channel int8 quantization of a (in, out) weight."""
    w32 = w.float()
    scale = torch.clamp(w32.abs().amax(dim=0, keepdim=True) / 127.0, min=1e-12)
    qw = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"qw": qw, "qscale": scale}


def dequantize_int8(params: Params, dtype=torch.float32) -> torch.Tensor:
    return (params["qw"].float() * params["qscale"]).to(dtype)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(in, out) nibble values -> (in//2, out) bytes, half-split planes."""
    half = q.shape[0] // 2
    return (q[:half] | (q[half:] << 4)).to(torch.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(in//2, out) bytes -> (in, out) uint8 nibble values in [0, 15]."""
    return torch.cat([packed & 0xF, packed >> 4], dim=0)


def quantize_int4(w: torch.Tensor, groupsize: int = 128) -> Params:
    """Asymmetric group quantization to 4 bits per (group of ``groupsize``
    input rows, output column): q = round((w - min) / scale) in [0, 15]."""
    in_f, out_f = w.shape
    if in_f % (2 * groupsize) and groupsize != -1:
        raise ValueError(f"in_features {in_f} not divisible by 2*groupsize {groupsize}")
    gs = in_f if groupsize == -1 else groupsize
    w32 = w.float().reshape(in_f // gs, gs, out_f)
    wmin = w32.amin(dim=1, keepdim=True)
    wmax = w32.amax(dim=1, keepdim=True)
    scale = torch.clamp((wmax - wmin) / 15.0, min=1e-12)
    q = torch.clamp(torch.round((w32 - wmin) / scale), 0, 15).to(torch.uint8)
    return {
        "qw": pack_int4(q.reshape(in_f, out_f)),
        "qscale": scale[:, 0, :].contiguous(),
        "qzero": wmin[:, 0, :].contiguous(),
    }


def dequantize_int4(params: Params, dtype=torch.float32) -> torch.Tensor:
    q = unpack_int4(params["qw"]).float()
    in_f, out_f = q.shape
    n_groups = params["qscale"].shape[0]
    q = q.reshape(n_groups, in_f // n_groups, out_f)
    w = q * params["qscale"][:, None, :] + params["qzero"][:, None, :]
    return w.reshape(in_f, out_f).to(dtype)


def matmul_int8_dequant(x, qw, qscale, compute_dtype):
    """x @ (qw * scale) with the dequantized weight rounded to the compute
    dtype first: the counterpart of the JAX package's ``matmul_int8_xla``.
    ``linear`` does not use it: int8 params go to
    ``quant_matmul.matmul_int8``, whose plain version
    (``quant_matmul.matmul_int8_ref``) follows the Pallas kernel and scales
    the f32 sum once at the end. The tests hold both against their JAX
    functions."""
    w = (qw.float() * qscale).to(compute_dtype)
    return x.to(compute_dtype) @ w


def linear(params: Params, x: torch.Tensor, compute_dtype=None, plain: bool = False):
    """Apply a linear-layer variant. ``x``: (..., in_features). Int4 params
    go to K3 and int8 params to K6 (``ops.quant_matmul``) where
    ``quant_route`` takes their widths, else to the kernel's plain version;
    ``plain`` runs the plain version even on a CUDA tensor (the reference path
    that the chip check compares the kernels against)."""
    compute_dtype = compute_dtype or x.dtype
    if "w" in params:
        out = x @ params["w"].to(compute_dtype)
    elif "qzero" in params:
        from lit_llama_tpu_torch.ops import quant_matmul

        kernel = not plain and quant_matmul.quant_route(2 * params["qw"].shape[0], params["qw"].shape[1])
        fn = quant_matmul.matmul_int4 if kernel else quant_matmul.matmul_int4_ref
        out = fn(x, params["qw"], params["qscale"], params["qzero"], compute_dtype)
    elif "qw" in params:
        from lit_llama_tpu_torch.ops import quant_matmul

        kernel = not plain and quant_matmul.quant_route(*params["qw"].shape)
        fn = quant_matmul.matmul_int8 if kernel else quant_matmul.matmul_int8_ref
        out = fn(x, params["qw"], params["qscale"], compute_dtype)
    else:
        raise ValueError(f"unrecognized linear params: {sorted(params)}")
    if "av2_scale" in params:
        out = (out + params["av2_bias"].to(out.dtype)) * params["av2_scale"].to(out.dtype)
    return out
