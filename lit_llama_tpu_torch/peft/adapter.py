"""LLaMA-Adapter v1 (prefix attention) and v2 (linear bias and scale)
(counterpart of lit_llama_tpu/peft/adapter.py).

v1: each block from ``start_layer`` on has a learnable prompt ``adapter_wte``
of ``prompt_length`` tokens and a per-head gate ``gating``, zero at first.
The prompt goes through the block's own ``c_attn`` (no RoPE on its keys); the
queries attend to its keys and values with no mask, and the result, scaled by
the gate, is added to the self-attention's output before ``c_proj``. v2 adds a
learnable bias and scale after every linear (applied in ``ops.linear``) and
trains the norm weights too.

Stacked layout, as in the JAX package: ``adapter_wte`` (L, aT, D), ``gating``
(L, H) and a frozen 0/1 ``adapter_active`` (L, 1) that holds the start-layer
cut, so every block runs the same code; v2's ``av2_bias`` / ``av2_scale`` are
(L, 1, out) on the five block linears and (1, V) on ``lm_head``. The prefix
attention is plain PyTorch ops in both packages: JAX runs it as einsums, with
no Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from lit_llama_tpu_torch.models.config import LLaMAConfig
from lit_llama_tpu_torch.ops.linear import linear
from lit_llama_tpu_torch.utils.device import torch_dtype

Params = Dict[str, Any]


def add_adapter_params(params: Params, config: LLaMAConfig, generator: Optional[torch.Generator] = None) -> Params:
    """Attach the adapter leaves to the stacked params, in place: the prompt
    normal(0, 0.02) from ``generator``, the gates zero, ``adapter_active`` 1
    from ``start_layer`` on; with ``config.adapter.v2`` also v2's bias (zeros)
    and scale (ones). The prompt is drawn on the generator's device and
    placed beside the layers."""
    cfg = config.adapter
    L, D, H = config.n_layer, config.n_embd, config.n_head
    dtype = torch_dtype(config.param_dtype)
    h = params["h"]
    dev = h["rms_1"].device
    draw = dev if generator is None else generator.device
    h["adapter_wte"] = (torch.randn((L, cfg.prompt_length, D), generator=generator, device=draw) * 0.02).to(dev, dtype)
    h["gating"] = torch.zeros((L, H), dtype=dtype, device=dev)
    h["adapter_active"] = (torch.arange(L, device=dev) >= cfg.start_layer).to(dtype)[:, None]
    if cfg.v2:
        _add_v2(params, config)
    return params


def _add_v2(params: Params, config: LLaMAConfig) -> None:
    """v2's bias (zeros) and scale (ones) on every block linear and on lm_head."""
    L, D, I, V = config.n_layer, config.n_embd, config.intermediate_size, config.padded_vocab_size
    dtype = torch_dtype(config.param_dtype)
    h = params["h"]
    dev = h["rms_1"].device

    def add(node, shape):
        node["av2_bias"] = torch.zeros(shape, dtype=dtype, device=dev)
        node["av2_scale"] = torch.ones(shape, dtype=dtype, device=dev)

    add(h["attn"]["c_attn"], (L, 1, 3 * D))
    add(h["attn"]["c_proj"], (L, 1, D))
    add(h["mlp"]["c_fc1"], (L, 1, I))
    add(h["mlp"]["c_fc2"], (L, 1, I))
    add(h["mlp"]["c_proj"], (L, 1, D))
    add(params["lm_head"], (1, V))


def init_adapter_cache(config: LLaMAConfig, batch_size: int, dtype) -> Params:
    """The prompt's keys and values are recomputed each call from fixed
    weights (aT rows through c_attn): the cache needs no entries for them."""
    return {}


def prefix_attention(layer_params: Params, q: torch.Tensor, y: torch.Tensor, config: LLaMAConfig,
                     head0: int = 0) -> torch.Tensor:
    """y + active * gate * softmax(q akᵀ / sqrt(hs)) av over one layer's
    prompt: q and y (B, H, T, hs), ``layer_params`` the layer's tree (its
    ``adapter_wte`` (aT, D), ``gating`` (all heads,), ``adapter_active``
    (1,) and ``attn.c_attn``). The scores are taken in q's dtype, the
    softmax in f32, its weights rounded to q's dtype, as in the JAX package.

    Under tensor parallelism q and y hold a rank's H heads from ``head0``
    on and ``c_attn`` is its shard of the columns, (q, k, v) of those heads
    (``parallel.tp``): the prompt's keys and values come out as the rank's
    heads, and the gates are taken from ``head0`` on."""
    B, H, T, hs = q.shape
    aT = config.adapter.prompt_length
    prefix = layer_params["adapter_wte"][None].to(q.dtype)  # (1, aT, D)
    akv = linear(layer_params["attn"]["c_attn"], prefix)
    _, ak, av = akv.chunk(3, dim=-1)
    ak = ak.reshape(1, aT, H, hs).transpose(1, 2)  # (1, H, aT, hs)
    av = av.reshape(1, aT, H, hs).transpose(1, 2)
    scores = torch.einsum("bhts,bhas->bhta", q, ak.to(q.dtype)).float() / math.sqrt(hs)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    ay = torch.einsum("bhta,bhas->bhts", probs, av.to(q.dtype))
    gate = layer_params["gating"][head0 : head0 + H][None, :, None, None].to(q.dtype)
    active = layer_params["adapter_active"][0].to(q.dtype)
    return y + active * gate * ay


def trainable_mask(params: Params, v2: bool = False) -> Params:
    """The tree's shape, True on ``adapter_wte`` and ``gating``; with ``v2``
    also on the ``av2_*`` leaves and the norm weights (rms_1, rms_2, ln_f).
    ``adapter_active`` stays frozen."""

    def visit(node, path):
        if isinstance(node, dict):
            return {k: visit(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(visit(v, path) for v in node)
        if "adapter_active" in path:
            return False
        if any(k in ("adapter_wte", "gating") for k in path):
            return True
        return v2 and any(k.startswith("av2_") or k in ("rms_1", "rms_2", "ln_f") for k in path)

    return visit(params, ())


def adapter_state(params: Params, v2: bool = False) -> Params:
    """The trainable sub-tree (what an adapter checkpoint holds)."""
    mask = trainable_mask(params, v2)

    def prune(p, m):
        if isinstance(p, dict):
            out = {k: sub for k, sub in ((k, prune(v, m[k])) for k, v in p.items()) if sub is not None}
            return out or None
        return p if m else None

    return prune(params, mask) or {}


def load_adapter_state(params: Params, state: Params) -> Params:
    """Overlay an adapter tree onto params; the dicts of ``params`` along the
    overlaid paths are copied, the leaves shared, the base tree unchanged."""

    def overlay(dst, src):
        out = dict(dst)
        for k, v in src.items():
            out[k] = overlay(dst.get(k, {}), v) if isinstance(v, dict) else v
        return out

    return overlay(params, state)
