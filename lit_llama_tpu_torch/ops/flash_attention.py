"""Causal flash attention: the forward K4, the backward K10 and their plain
versions (counterpart of lit_llama_tpu/ops/flash_attention.py).

``flash_attention`` replaces the Pallas ``_flash_kernel``
(lit_llama_tpu/ops/flash_attention.py, entry ``_flash_forward``) with the
CUDA kernel in ``csrc/flash_attention.cu``. It serves every causal prefill
with T > 1 on the card, any T (the kernel masks the ragged last tile), head
size 128 and bf16 only.

``flash_attention_backward`` replaces the Pallas pair ``_flash_dq_kernel`` /
``_flash_dkv_kernel`` (entry ``_flash_backward``) with the two K10 kernels of
the same source, each behind its own launch counter (``flash_backward_dq``,
``flash_backward_dkv``). ``FlashAttention`` is the autograd Function around
the pair, the counterpart of the ``jax.custom_vjp`` of ``flash_attention``:
its forward runs K4 and saves (q, k, v, o, lse), its backward runs K10. A CPU
tensor, or ``plain=True``, takes the plain versions in the same Function.

``flash_attention_ref`` computes the same (o, lse) in plain PyTorch: f32
scores, the unnormalised probabilities rounded to the input dtype for the PV
product, normalised after it, as the Pallas kernel does.
``flash_attention_bwd_ref`` is the plain K10, rounded as the Pallas kernels
round.
"""

from __future__ import annotations

import math

import torch

from lit_llama_tpu_torch.ops import _build

NEG_INF = -1e30

_SIGS = {
    "k4_flash_forward": [_build.PTR] * 5 + [_build.INT] * 3 + [_build.FLOAT, _build.PTR],
    "k10_flash_backward_dq": [_build.PTR] * 8 + [_build.INT] * 3 + [_build.FLOAT, _build.PTR],
    "k10_flash_backward_dkv": [_build.PTR] * 8 + [_build.INT] * 3 + [_build.FLOAT, _build.PTR],
}


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q/k/v (B, H, T, hs) -> (o (B, H, T, hs) in q.dtype, lse (B, H, T, 1) f32)."""
    T, hs = q.shape[-2], q.shape[-1]
    s = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(hs))
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    s = torch.where(causal, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = (p.to(q.dtype).float() @ v.float()) / l
    return o.to(q.dtype), m + torch.log(l)


def _check_rows(what: str, *ts: torch.Tensor) -> None:
    """The kernels take contiguous bf16 (B, H, T, 128) tensors of one shape."""
    B, H, T, hs = ts[0].shape
    if hs != 128:
        raise ValueError(f"{what} takes head size 128, got {hs}")
    for t in ts:
        if t.dtype != torch.bfloat16 or t.shape != (B, H, T, hs) or not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous bf16 tensors of one shape (B, H, T, 128)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Causal attention over T == S positions, returning (o, lse). A CPU tensor
    takes the plain version; a CUDA tensor launches K4 or raises."""
    if not q.is_cuda:
        return flash_attention_ref(q, k, v)
    _check_rows("K4", q, k, v)
    B, H, T, hs = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T, 1), dtype=torch.float32, device=q.device)
    lib = _build.library("flash_attention", _SIGS)
    err = lib.k4_flash_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, H, T, 1.0 / math.sqrt(hs), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "K4 flash_attention")
    flash_attention.launches += 1
    return o, lse


flash_attention.launches = 0


def flash_attention_bwd_ref(q, k, v, o, lse, do):
    """The plain K10: (dq, dk, dv) of causal attention in the input dtype, from
    the forward's o and lse. D = rowsum(dO * O) and every sum in f32; P =
    exp(S * scale - lse) under the causal mask; P rounded to ``do.dtype`` for
    dV, dS = P (dP - D) rounded to ``k.dtype`` / ``q.dtype`` for dQ / dK;
    ``scale`` applied after the product, as the Pallas kernels do."""
    T, hs = q.shape[-2], q.shape[-1]
    scale = 1.0 / math.sqrt(hs)
    f32 = torch.float32
    dd = (do.to(f32) * o.to(f32)).sum(dim=-1, keepdim=True)
    s = (q.to(f32) @ k.to(f32).transpose(-1, -2)) * scale
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    p = torch.exp(torch.where(causal, s, torch.full_like(s, NEG_INF)) - lse)
    dp = do.to(f32) @ v.to(f32).transpose(-1, -2)
    ds = p * (dp - dd)
    dv = p.to(do.dtype).to(f32).transpose(-1, -2) @ do.to(f32)
    dq = (ds.to(k.dtype).to(f32) @ k.to(f32)) * scale
    dk = (ds.to(q.dtype).to(f32).transpose(-1, -2) @ q.to(f32)) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_backward_dq(q, k, v, o, lse, do):
    """K10's first kernel pair on the card: D = rowsum(dO * O), then dq.
    Returns (dq, dd), dd (B, H, T, 1) f32 for ``flash_backward_dkv``."""
    _check_rows("K10", q, k, v, o, do)
    B, H, T, hs = q.shape
    if lse.dtype != torch.float32 or lse.shape != (B, H, T, 1) or not lse.is_contiguous():
        raise ValueError("K10 takes the forward's lse, contiguous (B, H, T, 1) f32")
    dq = torch.empty_like(q)
    dd = torch.empty_like(lse)
    lib = _build.library("flash_attention", _SIGS)
    err = lib.k10_flash_backward_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dd.data_ptr(), dq.data_ptr(), B, H, T, 1.0 / math.sqrt(hs),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "K10 flash_backward_dq")
    flash_backward_dq.launches += 1
    return dq, dd


def flash_backward_dkv(q, k, v, do, lse, dd):
    """K10's second kernel on the card: (dk, dv) from the dd of
    ``flash_backward_dq``."""
    _check_rows("K10", q, k, v, do)
    B, H, T, hs = q.shape
    for t in (lse, dd):
        if t.dtype != torch.float32 or t.shape != (B, H, T, 1) or not t.is_contiguous():
            raise ValueError("K10 takes lse and dd contiguous (B, H, T, 1) f32")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _build.library("flash_attention", _SIGS)
    err = lib.k10_flash_backward_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), dd.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, H, T, 1.0 / math.sqrt(hs),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "K10 flash_backward_dkv")
    flash_backward_dkv.launches += 1
    return dk, dv


flash_backward_dq.launches = 0
flash_backward_dkv.launches = 0


def flash_attention_backward(q, k, v, o, lse, do):
    """(dq, dk, dv) of causal attention. A CPU tensor takes the plain version;
    a CUDA tensor launches K10 (both kernels) or raises."""
    if not q.is_cuda:
        return flash_attention_bwd_ref(q, k, v, o, lse, do)
    dq, dd = flash_backward_dq(q, k, v, o, lse, do)
    dk, dv = flash_backward_dkv(q, k, v, do, lse, dd)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Causal attention with a flash backward: K4 forward, K10 backward on the
    card (the plain versions on the CPU or with ``plain``). Takes contiguous
    q, k, v (B, H, T, hs) and returns o."""

    @staticmethod
    def forward(ctx, q, k, v, plain: bool = False):
        o, lse = (flash_attention_ref if plain else flash_attention)(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.plain = plain
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = flash_attention_bwd_ref if ctx.plain else flash_attention_backward
        dq, dk, dv = bwd(q, k, v, o, lse, do.contiguous())
        return dq, dk, dv, None
