"""Rotary position embeddings (counterpart of lit_llama_tpu/ops/rope.py).

``build_rope_cache`` gives the (seq_len, hs/2, 2) cos/sin table, computed in
float32. ``apply_rope`` rotates Meta's interleaved pairs (2i, 2i+1);
``apply_rope_half`` rotates the pairs (i, i + hs/2) of weights whose q/k
columns were permuted by ``ops.fused_layer.permute_qk_columns``.
"""

from __future__ import annotations

import torch


def build_rope_cache(seq_len: int, n_elem: int, base: int = 10000, device=None) -> torch.Tensor:
    theta = 1.0 / (
        base ** (torch.arange(0, n_elem, 2, dtype=torch.float32, device=device) / n_elem)
    )
    seq_idx = torch.arange(seq_len, dtype=torch.float32, device=device)
    idx_theta = torch.outer(seq_idx, theta)
    return torch.stack([torch.cos(idx_theta), torch.sin(idx_theta)], dim=-1)


def _cos_sin(x: torch.Tensor, rope_cache: torch.Tensor):
    """``rope_cache`` (T, hs/2, 2) for all rows of the batch, or (B, T, hs/2, 2)
    with each slot's own positions."""
    B, T, H, hs = x.shape
    rc = rope_cache.float().reshape(-1, T, 1, hs // 2, 2)
    return rc[..., 0], rc[..., 1]


def apply_rope(x: torch.Tensor, rope_cache: torch.Tensor) -> torch.Tensor:
    """``x``: (B, T, H, hs); ``rope_cache``: (T, hs/2, 2) for x's positions, or
    (B, T, hs/2, 2) where the slots sit at different positions."""
    B, T, H, hs = x.shape
    xs = x.float().reshape(B, T, H, hs // 2, 2)
    cos, sin = _cos_sin(x, rope_cache)
    x1, x2 = xs[..., 0], xs[..., 1]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.reshape(B, T, H, hs).to(x.dtype)


def apply_rope_half(x: torch.Tensor, rope_cache: torch.Tensor) -> torch.Tensor:
    """Rotation in the half basis: element i pairs with i + hs/2."""
    hs = x.shape[-1]
    xs = x.float()
    cos, sin = _cos_sin(x, rope_cache)
    x1, x2 = xs[..., : hs // 2], xs[..., hs // 2 :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope_half_row(rope_cache: torch.Tensor, pos: int, hs: int):
    """(cos, sin_signed) (1, hs) f32 rows at ``pos`` for the fused decode
    layer: rot(q) = q * cos + roll(q, hs/2) * sin_s, sin_s negative on the
    first half."""
    row = rope_cache[pos].float()
    c, s = row[:, 0], row[:, 1]
    cos = torch.cat([c, c]).reshape(1, hs)
    sin_s = torch.cat([-s, s]).reshape(1, hs)
    return cos, sin_s


def rope_half_tables(rope_cache: torch.Tensor):
    """Every position's (cos, sin_signed) rows at once: two (seq_len, hs) f32
    tables, so that a decode step takes its rows as views without a launch."""
    c, s = rope_cache[..., 0].float(), rope_cache[..., 1].float()
    return torch.cat([c, c], dim=-1).contiguous(), torch.cat([-s, s], dim=-1).contiguous()


def slot_rope_rows(rope_cache: torch.Tensor, slot_pos: torch.Tensor):
    """Per-slot (cos, sin_signed) rows (B, hs) f32 for the batched serving
    step: ``rope_half_tables`` of the rows gathered at ``clip(slot_pos, 0,
    seq_len - 1)``, on the device. The JAX package expands these to (B, 3D)
    lane tables for its kernel; here the kernel takes one row per slot, as
    the single-stream kernel takes one row."""
    idx = slot_pos.long().clamp(0, rope_cache.shape[0] - 1)
    return rope_half_tables(rope_cache[idx])
