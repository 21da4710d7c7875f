"""Causal flash-attention forward: kernel K4 and its plain version
(counterpart of lit_llama_tpu/ops/flash_attention.py).

``flash_attention`` replaces the Pallas ``_flash_kernel``
(lit_llama_tpu/ops/flash_attention.py, entry ``_flash_forward``) with the
CUDA kernel in ``csrc/flash_attention.cu``. It serves every causal prefill
with T > 1 on the card, any T (the kernel masks the ragged last tile), head
size 128 and bf16 only. The backward (K10) is a later slice.

``flash_attention_ref`` computes the same (o, lse) in plain PyTorch: f32
scores, the unnormalised probabilities rounded to the input dtype for the PV
product, normalised after it, as the Pallas kernel does.
"""

from __future__ import annotations

import math

import torch

from lit_llama_tpu_torch.ops import _build

NEG_INF = -1e30

_SIGS = {"k4_flash_forward": [_build.PTR] * 5 + [_build.INT] * 3 + [_build.FLOAT, _build.PTR]}


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Causal attention over T == S positions, returning (o, lse). A CPU tensor
    takes the plain version; a CUDA tensor launches K4 or raises."""
    if not q.is_cuda:
        return flash_attention_ref(q, k, v)
    B, H, T, hs = q.shape
    if hs != 128:
        raise ValueError(f"K4 takes head size 128, got {hs}")
    for t in (q, k, v):
        if t.dtype != torch.bfloat16 or t.shape != (B, H, T, hs) or not t.is_contiguous():
            raise ValueError("K4 takes contiguous bf16 q, k, v of one shape (B, H, T, 128)")
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
