"""LLaMA forward over a parameter tree of tensors (counterpart of
lit_llama_tpu/models/llama.py).

The tree has the JAX package's keys and layout (weights stored (in, out)), so
``utils.jax_params.params_from_numpy`` carries a JAX tree across as it is.
Layers are stacked on a leading axis (``h`` a dict) as built, or a list of
per-layer dicts after ``unstack_layers`` (the inference layout, with c_fc1 and
c_fc2 fused into ``c_fc12``).

``forward`` covers two paths of this slice: no cache (causal over the tokens)
and ``prefill_from_zero`` (positions 0..T-1 written into a per-layer cache).
The per-op decode path with roll-left overflow, the ``slot_pos`` serving path
and the int8 KV cache are later slices.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from lit_llama_tpu_torch.models.config import LLaMAConfig
from lit_llama_tpu_torch.ops.attention import attention
from lit_llama_tpu_torch.ops.linear import linear, quantize_int4, quantize_int8
from lit_llama_tpu_torch.ops.norm import rms_norm
from lit_llama_tpu_torch.ops.rope import apply_rope, apply_rope_half, build_rope_cache
from lit_llama_tpu_torch.utils.device import resolve_device, torch_dtype

Params = Dict[str, Any]
KVCache = List[Dict[str, torch.Tensor]]  # per layer {"k", "v"}: (B, H, S, hs)


def init_params(config: LLaMAConfig, generator: Optional[torch.Generator] = None, device=None) -> Params:
    """Random init, normal(0, 0.02/sqrt(2*n_layer)) for the linears and the
    embedding, ones for the norms; layers stacked on a leading axis."""
    dev = resolve_device(device)
    std = 0.02 / math.sqrt(2 * config.n_layer)
    dtype = torch_dtype(config.param_dtype)
    D, V, I, L = config.n_embd, config.padded_vocab_size, config.intermediate_size, config.n_layer

    def normal(*shape):
        return (torch.randn(shape, generator=generator, device=dev) * std).to(dtype)

    return {
        "wte": normal(V, D),
        "h": {
            "rms_1": torch.ones((L, D), dtype=dtype, device=dev),
            "attn": {"c_attn": {"w": normal(L, D, 3 * D)}, "c_proj": {"w": normal(L, D, D)}},
            "rms_2": torch.ones((L, D), dtype=dtype, device=dev),
            "mlp": {
                "c_fc1": {"w": normal(L, D, I)},
                "c_fc2": {"w": normal(L, D, I)},
                "c_proj": {"w": normal(L, I, D)},
            },
        },
        "ln_f": torch.ones((D,), dtype=dtype, device=dev),
        "lm_head": {"w": normal(D, V)},
    }


def init_kv_cache(config: LLaMAConfig, batch_size: int, max_seq_length: int, dtype=None,
                  device=None) -> KVCache:
    """Zero per-layer caches, (B, H, S, hs) each, in the compute dtype."""
    if config.kv_cache_dtype is not None:
        raise NotImplementedError("the int8 KV cache is a later slice")
    dev = resolve_device(device)
    dtype = torch_dtype(dtype or config.compute_dtype)
    shape = (batch_size, config.n_head, max_seq_length, config.head_size)
    return [
        {"k": torch.zeros(shape, dtype=dtype, device=dev), "v": torch.zeros(shape, dtype=dtype, device=dev)}
        for _ in range(config.n_layer)
    ]


def _layer(h: Params, l: int) -> Params:
    return {k: (_layer(v, l) if isinstance(v, dict) else v[l]) for k, v in h.items()}


def _layers(params: Params) -> List[Params]:
    h = params["h"]
    if isinstance(h, (list, tuple)):
        return list(h)
    return [_layer(h, l) for l in range(h["rms_1"].shape[0])]


def _mlp(mlp: Params, x: torch.Tensor, plain: bool) -> torch.Tensor:
    if "c_fc12" in mlp:
        fc1, fc2 = linear(mlp["c_fc12"], x, plain=plain).chunk(2, dim=-1)
    else:
        fc1 = linear(mlp["c_fc1"], x, plain=plain)
        fc2 = linear(mlp["c_fc2"], x, plain=plain)
    return linear(mlp["c_proj"], F.silu(fc1) * fc2, plain=plain)


def _causal_self_attention(attn: Params, x, rope, config: LLaMAConfig, kv, plain: bool):
    """Causal attention over the T tokens of ``x``; with ``kv`` the new k/v
    are written into its first T slots (prefill from position 0)."""
    B, T, C = x.shape
    hs = config.head_size
    qkv = linear(attn["c_attn"], x, plain=plain)
    H = qkv.shape[-1] // 3 // hs
    q, k, v = (t.reshape(B, T, H, hs) for t in qkv.split(C, dim=-1))
    rot = apply_rope_half if config.rope_layout == "half" else apply_rope
    q, k = rot(q, rope), rot(k, rope)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, T, hs)
    if kv is not None:
        kv["k"][:, :, :T] = k.to(kv["k"].dtype)
        kv["v"][:, :, :T] = v.to(kv["v"].dtype)
    mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    y = attention(q, k, v, mask, causal=True, plain=plain)
    y = y.transpose(1, 2).reshape(B, T, H * hs)
    return linear(attn["c_proj"], y, plain=plain)


def _block(lp: Params, x, rope, config: LLaMAConfig, kv, plain: bool = False):
    """One pre-norm residual block."""
    x = x + _causal_self_attention(lp["attn"], rms_norm(x, lp["rms_1"]), rope, config, kv, plain)
    return x + _mlp(lp["mlp"], rms_norm(x, lp["rms_2"]), plain)


def forward(
    params: Params,
    tokens: torch.Tensor,
    config: LLaMAConfig,
    *,
    rope_cache: Optional[torch.Tensor] = None,
    kv_cache: Optional[KVCache] = None,
    prefill_from_zero: bool = False,
    plain: bool = False,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the model over (B, T) tokens; returns (logits (B, T, V), cache).

    Without ``kv_cache``: causal forward, cache None. With ``kv_cache`` and
    ``prefill_from_zero=True``: the tokens sit at positions 0..T-1, their k/v
    are written into each layer's cache in place, and attention is causal over
    them. ``plain`` runs every kernel's plain version (the reference path the
    chip check holds the kernels against).
    """
    if kv_cache is not None and not prefill_from_zero:
        raise NotImplementedError(
            "per-op decode with input_pos (roll-left overflow) is a later slice; "
            "decode through models.generate's fused step"
        )
    B, T = tokens.shape
    cd = torch_dtype(config.compute_dtype)
    if rope_cache is None:
        rope_cache = build_rope_cache(config.block_size, config.head_size, device=tokens.device)
    rope = rope_cache[:T]
    x = params["wte"][tokens].to(cd)
    layers = _layers(params)
    caches = kv_cache if kv_cache is not None else [None] * len(layers)
    for lp, kv in zip(layers, caches):
        x = _block(lp, x, rope, config, kv, plain)
    x = rms_norm(x, params["ln_f"])
    return linear(params["lm_head"], x, plain=plain), kv_cache


def unstack_layers(params: Params) -> Params:
    """Stacked (L, ...) layers -> a list of per-layer dicts (views, no copy),
    with c_fc1/c_fc2 concatenated along the output axis into ``c_fc12``."""
    if isinstance(params.get("h"), (list, tuple)):
        return params
    out = dict(params)
    layers = []
    for lp in _layers(params):
        mlp = lp["mlp"]
        f1, f2 = mlp["c_fc1"], mlp["c_fc2"]
        if set(f1) == set(f2):
            lp["mlp"] = {
                "c_fc12": {k: torch.cat([f1[k], f2[k]], dim=-1) for k in f1},
                "c_proj": mlp["c_proj"],
            }
        layers.append(lp)
    out["h"] = layers
    return out


_QUANT_TARGETS = ("c_attn", "c_proj", "c_fc1", "c_fc2", "lm_head")


def _quantizer(config: LLaMAConfig):
    if config.quantize == "int8":
        return quantize_int8
    if config.quantize == "int4":
        return lambda w: quantize_int4(w, groupsize=config.quant_groupsize)
    raise ValueError(f"unknown quantize mode {config.quantize!r}")


def quantize_params(params: Params, config: LLaMAConfig) -> Params:
    """Dense linear weights -> the quantized representation, for the five
    per-block linears and lm_head (round to nearest); embedding and norms
    stay dense. Stacked (L, in, out) weights are quantized per layer."""
    if config.quantize is None:
        return params
    quant = _quantizer(config)

    def quant_one(w):
        if w.ndim == 3:
            per = [quant(w[l]) for l in range(w.shape[0])]
            return {k: torch.stack([p[k] for p in per]) for k in per[0]}
        return quant(w)

    def visit(d):
        out = {}
        for name, sub in d.items():
            if isinstance(sub, dict):
                if name in _QUANT_TARGETS and "w" in sub:
                    rest = {k: v for k, v in sub.items() if k != "w"}
                    out[name] = {**quant_one(sub["w"]), **rest}
                else:
                    out[name] = visit(sub)
            else:
                out[name] = sub
        return out

    return visit(params)
