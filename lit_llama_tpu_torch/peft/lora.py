"""LoRA on the fused QKV projection (counterpart of lit_llama_tpu/peft/lora.py).

The low-rank update applies to ``c_attn`` only, per enabled (q, k, v) group
(q and v by default), scaled by alpha / r, and zero-padded into the disabled
groups of the (..., 3D) output, as the reference's merged linear does.

Layout, the JAX package's (weights (in, out), layers stacked on a leading L):
``lora_a`` (L, D, n_en * r) and ``lora_b`` (L, n_en, r, D); after
``llama.unstack_layers`` each layer holds its (D, n_en * r) and
(n_en, r, D) views. The fused decode kernels take the update as two dense
operands instead (``ops.fused_layer.prepare_lora_operands``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from lit_llama_tpu_torch.models.config import LLaMAConfig, LoRAConfig
from lit_llama_tpu_torch.utils.device import torch_dtype

Params = Dict[str, Any]


def add_lora_params(params: Params, config: LLaMAConfig, generator: Optional[torch.Generator] = None) -> Params:
    """Attach LoRA A and B to the stacked c_attn params, in place: A
    kaiming-uniform (bound 1/sqrt(D), torch's ``kaiming_uniform_(a=sqrt(5))``
    over fan-in D), B zero, so the update starts at zero."""
    cfg = config.lora
    n_en = sum(cfg.enable)
    c_attn = params["h"]["attn"]["c_attn"]
    dev = next(iter(c_attn.values())).device
    L, D, r = config.n_layer, config.n_embd, cfg.r
    bound = 1.0 / math.sqrt(D)
    dtype = torch_dtype(config.param_dtype)
    a = torch.empty((L, D, n_en * r), dtype=torch.float32, device=dev).uniform_(-bound, bound, generator=generator)
    c_attn["lora_a"] = a.to(dtype)
    c_attn["lora_b"] = torch.zeros((L, n_en, r, D), dtype=dtype, device=dev)
    return params


def lora_delta(attn_params: Params, x: torch.Tensor, cfg: LoRAConfig,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The low-rank QKV update, zero-scattered into the disabled groups:
    x (B, T, D) -> (B, T, 3D) in x.dtype. A and B are cast to x.dtype first,
    as in the JAX package. With a ``generator`` (on x's device) and
    ``cfg.dropout > 0``, x is dropped out first: each entry kept with
    probability 1 - p and scaled by 1 / (1 - p). Without one (the model's
    forward, in training too, as the JAX package runs it) there is no
    dropout."""
    if generator is not None and cfg.dropout > 0.0:
        keep = 1.0 - cfg.dropout
        mask = torch.empty(x.shape, device=x.device).bernoulli_(keep, generator=generator).bool()
        x = torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
    a = attn_params["lora_a"].to(x.dtype)
    b = attn_params["lora_b"].to(x.dtype)
    n_en, r = b.shape[-3], b.shape[-2]
    B, T, _ = x.shape
    ax = (x @ a).reshape(B, T, n_en, r)
    # the group width comes from b, as in the JAX package
    delta = torch.einsum("btgr,grd->btgd", ax, b) * cfg.scaling
    return _zero_pad(delta, cfg, delta.shape[-1])


def _zero_pad(delta: torch.Tensor, cfg: LoRAConfig, D: int) -> torch.Tensor:
    """(B, T, n_en, D) per-group updates -> (B, T, 3D) with zeros in the
    disabled groups."""
    out = []
    g = 0
    for enabled in cfg.enable:
        if enabled:
            out.append(delta[:, :, g])
            g += 1
        else:
            out.append(delta.new_zeros(delta.shape[:2] + (D,)))
    return torch.cat(out, dim=-1)


def merge_lora(params: Params, config: LLaMAConfig) -> Params:
    """Fold the LoRA update into the dense stacked c_attn weight and drop A
    and B (the reference's merge for export). Needs a dense base weight."""
    cfg = config.lora
    c_attn = dict(params["h"]["attn"]["c_attn"])
    if "w" not in c_attn:
        raise ValueError("merge_lora needs a dense base weight (not quantized)")
    w = c_attn["w"]
    a = c_attn.pop("lora_a").float()
    b = c_attn.pop("lora_b").float()
    L, D, _ = a.shape
    n_en, r = b.shape[-3], b.shape[-2]
    delta = torch.einsum("ligr,lgro->ligo", a.reshape(L, D, n_en, r), b) * cfg.scaling
    cols = []
    g = 0
    for enabled in cfg.enable:
        if enabled:
            cols.append(delta[:, :, g])
            g += 1
        else:
            cols.append(torch.zeros((L, D, delta.shape[-1]), dtype=torch.float32, device=w.device))
    c_attn["w"] = (w.float() + torch.cat(cols, dim=-1)).to(w.dtype)
    out = dict(params)
    out["h"] = dict(params["h"])
    out["h"]["attn"] = dict(params["h"]["attn"], c_attn=c_attn)
    return out


def trainable_mask(params: Params) -> Params:
    """The tree's shape with True on the lora_* leaves only."""

    def visit(node, lora: bool):
        if isinstance(node, dict):
            return {k: visit(v, lora or str(k).startswith("lora_")) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(visit(v, lora) for v in node)
        return lora

    return visit(params, False)


def lora_state(params: Params) -> Params:
    """The LoRA-only sub-tree of a stacked tree (what a LoRA checkpoint holds)."""
    c_attn = params["h"]["attn"]["c_attn"]
    return {"h": {"attn": {"c_attn": {"lora_a": c_attn["lora_a"], "lora_b": c_attn["lora_b"]}}}}


def load_lora_state(params: Params, lora_params: Params) -> Params:
    """Overlay a LoRA-only tree onto stacked base params; the base tree is
    not changed."""
    out = dict(params)
    out["h"] = dict(params["h"])
    attn = dict(params["h"]["attn"])
    attn["c_attn"] = {**params["h"]["attn"]["c_attn"], **lora_params["h"]["attn"]["c_attn"]}
    out["h"]["attn"] = attn
    return out
