"""Multi-head attention (counterpart of lit_llama_tpu/ops/attention.py).

``attention_ref`` is the counterpart of ``attention_xla``: scores and the
softmax in float32, probabilities rounded to the input dtype for the PV
product. ``attention`` sends causal self-attention over T > 1 positions
through ``FlashAttention`` (K4 forward and K10 backward on the card),
everything else to ``attention_ref``.
"""

from __future__ import annotations

import math

import torch

from lit_llama_tpu_torch.ops.flash_attention import FlashAttention


def attention_ref(q, k, v, mask):
    """q (B, H, T, hs); k/v (B, H, S, hs); mask broadcastable to (B, H, T, S),
    True = attend. Returns (B, H, T, hs) in q.dtype."""
    scores = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    scores = torch.where(mask, scores, torch.full_like(scores, float("-inf")))
    probs = torch.softmax(scores, dim=-1)
    return (probs.to(q.dtype).float() @ v.float()).to(q.dtype)


def attention(q, k, v, mask, *, causal: bool = False, plain: bool = False):
    """Dispatching attention. ``causal=True`` promises mask == tril over
    T == S. ``plain`` keeps the flash path on its plain versions."""
    T, S = q.shape[-2], k.shape[-2]
    if causal and T == S and T > 1:
        return FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), plain)
    return attention_ref(q, k, v, mask)
