"""Multi-head attention (counterpart of lit_llama_tpu/ops/attention.py).

``attention_ref`` is the counterpart of ``attention_xla``: scores and the
softmax in float32, probabilities rounded to the input dtype for the PV
product. ``attention`` sends causal self-attention over T > 1 positions whose
head size is a multiple of 128 (``flash_route``, JAX's ``_use_flash`` shape
condition) through ``FlashAttention`` (K4 forward and K10 backward on the
card), everything else to ``attention_ref``, as JAX runs ``attention_xla``
there. The TPU's measured gates (T >= 128, T % 128 == 0) are not carried
over.
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


def flash_route(T: int, S: int, hs: int, causal: bool) -> bool:
    """Whether ``attention`` takes the flash path (K4/K10 on the card): a
    static predicate on shapes, decided before any launch."""
    return causal and T == S and T > 1 and hs % 128 == 0


def attention(q, k, v, mask, *, causal: bool = False, plain: bool = False):
    """Dispatching attention. ``causal=True`` promises mask == tril over
    T == S. ``plain`` keeps the flash path on its plain versions."""
    T, S = q.shape[-2], k.shape[-2]
    if flash_route(T, S, q.shape[-1], causal):
        return FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), plain)
    return attention_ref(q, k, v, mask)
