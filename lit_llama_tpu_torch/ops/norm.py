"""RMSNorm (counterpart of lit_llama_tpu/ops/norm.py): the mean of squares is
taken in float32 whatever the activation dtype."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    norm = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (norm * scale).to(x.dtype)  # f32 * scale promotes to f32: no separate cast of the scale
