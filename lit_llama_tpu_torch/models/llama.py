"""LLaMA forward over a parameter tree of tensors (counterpart of
lit_llama_tpu/models/llama.py).

The tree has the JAX package's keys and layout (weights stored (in, out)), so
``utils.jax_params.params_from_numpy`` carries a JAX tree across as it is.
Layers are stacked on a leading axis (``h`` a dict) as built, or a list of
per-layer dicts after ``unstack_layers`` (the inference layout, with c_fc1 and
c_fc2 fused into ``c_fc12``).

``forward`` covers: no cache (causal over the tokens), ``prefill_from_zero``
(positions 0..T-1 written into a per-layer cache), ``input_pos`` (a continuing
chunk, or one token with the roll-left overflow) and ``slot_pos`` (the
continuous-batching decode step, one token per slot). A cached single token
(``input_pos`` with T == 1, and ``slot_pos`` on layers that are not the fused
int4 layout) attends through ``decode_attention`` (K5 on the card) where the
head size is a multiple of 128 (``decode_route``), else through its plain
version, as JAX runs ``attention_xla`` there. With
``config.kv_cache_dtype == "int8"`` the cache holds int8 rows with one f32
scale per (batch row, head, position), and K5 reads it as it is.

With ``config.adapter`` (LLaMA-Adapter, ``peft.adapter``) every path adds the
gated prefix attention to the self-attention's output before ``c_proj``, as
the JAX ``forward`` does; the fused kernels have no prefix term, so an
adapter model takes none of them (``use_serve_fused``, the fused step of
``models.generate``).

With ``tp_group`` (a model group of ``torch.distributed``, the JAX
``tp_axis``) the weights are this rank's tensor-parallel shard
(``parallel.tp``): each block sums its two projections over the group and
the vocab-sharded logits are gathered (``parallel.comm``). With ``layout``
(``parallel.sharding.Layout``) the forward trains across ranks: the params
are this rank's FSDP and TP shards, gathered where they are used, and the
collectives are differentiable.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from lit_llama_tpu_torch.models.config import LLaMAConfig
from lit_llama_tpu_torch.ops import fused_layer
from lit_llama_tpu_torch.ops.attention import attention
from lit_llama_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_ref,
    decode_attention_write,
    decode_attention_write_ref,
    decode_route,
)
from lit_llama_tpu_torch.ops.fused_layer import use_serve_fused
from lit_llama_tpu_torch.ops.linear import linear, quantize_int4, quantize_int8
from lit_llama_tpu_torch.ops.norm import rms_norm
from lit_llama_tpu_torch.ops.rope import apply_rope, apply_rope_half, build_rope_cache, slot_rope_rows
from lit_llama_tpu_torch.parallel import comm
from lit_llama_tpu_torch.peft import adapter, lora
from lit_llama_tpu_torch.utils.device import resolve_device, torch_dtype

Params = Dict[str, Any]
# per layer {"k", "v"}: (B, H, S, hs); an int8 cache adds {"ks", "vs"}: (B, H, S, 1) f32
KVCache = List[Dict[str, torch.Tensor]]


def init_params(config: LLaMAConfig, generator: Optional[torch.Generator] = None, device=None) -> Params:
    """Random init, normal(0, 0.02/sqrt(2*n_layer)) for the linears and the
    embedding, ones for the norms; layers stacked on a leading axis. With
    ``config.lora`` the c_attn leaves gain LoRA A and B (``peft.lora``), with
    ``config.adapter`` the adapter leaves (``peft.adapter``), both drawn from
    ``generator`` after the base weights."""
    dev = resolve_device(device)
    std = 0.02 / math.sqrt(2 * config.n_layer)
    dtype = torch_dtype(config.param_dtype)
    D, V, I, L = config.n_embd, config.padded_vocab_size, config.intermediate_size, config.n_layer

    def normal(*shape):
        return (torch.randn(shape, generator=generator, device=dev) * std).to(dtype)

    params = {
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
    if config.lora is not None:
        lora.add_lora_params(params, config, generator)
    if config.adapter is not None:
        adapter.add_adapter_params(params, config, generator)
    return params


def init_kv_cache(config: LLaMAConfig, batch_size: int, max_seq_length: int, dtype=None,
                  device=None, n_head: Optional[int] = None) -> KVCache:
    """Zero per-layer caches, (B, H, S, hs) each, in the compute dtype. With
    ``config.kv_cache_dtype == "int8"`` k and v are int8 and each layer also
    holds ``ks`` and ``vs``, (B, H, S, 1) f32 scales: half the bytes of a bf16
    cache to keep and to read. An adapter adds no entries
    (``peft.adapter.init_adapter_cache``). ``n_head`` (default
    ``config.n_head``) is a tensor-parallel rank's share of the heads."""
    if config.kv_cache_dtype not in (None, "int8"):
        raise ValueError(f"unknown kv_cache_dtype {config.kv_cache_dtype!r}")
    dev = resolve_device(device)
    dtype = torch_dtype(dtype or config.compute_dtype)
    shape = (batch_size, n_head or config.n_head, max_seq_length, config.head_size)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    if config.kv_cache_dtype == "int8":
        return [
            {"k": zeros(shape, torch.int8), "v": zeros(shape, torch.int8),
             "ks": zeros(shape[:-1] + (1,), torch.float32), "vs": zeros(shape[:-1] + (1,), torch.float32)}
            for _ in range(config.n_layer)
        ]
    return [{"k": zeros(shape, dtype), "v": zeros(shape, dtype)} for _ in range(config.n_layer)]


def _quantize_kv(x: torch.Tensor):
    """Symmetric int8 quantization of k/v rows, one f32 scale per (batch row,
    head, position): scale = max|x| / 127 floored at 1e-12, q = round half to
    even of x / scale, clipped to +-127."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def _layers(params: Params) -> List[Params]:
    """Per-layer trees: the list as it is, or views of the stacked (L, ...)
    leaves. The views come from ``unbind``, whose backward stacks a leaf's L
    grads in one pass; indexing each layer would give L zero-padded grads of
    the whole stacked leaf to add up."""
    h = params["h"]
    if isinstance(h, (list, tuple)):
        return list(h)

    def split(node):
        return {k: split(v) for k, v in node.items()} if isinstance(node, dict) else node.unbind(0)

    def pick(node, l):
        return {k: pick(v, l) for k, v in node.items()} if isinstance(node, dict) else node[l]

    views = split(h)
    return [pick(views, l) for l in range(h["rms_1"].shape[0])]


def _into_group(x: torch.Tensor, tp_group) -> torch.Tensor:
    """The input of a column-split product: its gradient is summed over the
    model group (Megatron's f; nothing to do without gradients)."""
    if tp_group is None or not torch.is_grad_enabled():
        return x
    return comm.copy_to_group(x, tp_group)


def _sum_group(out: torch.Tensor, tp_group) -> torch.Tensor:
    """A row-split product's partial sums added over the model group
    (Megatron's g): differentiable when gradients are on, in place
    otherwise (the decode paths)."""
    if tp_group is None:
        return out
    return comm.reduce_from_group(out, tp_group) if torch.is_grad_enabled() else comm.all_reduce(out, tp_group)


def _mlp(mlp: Params, x: torch.Tensor, plain: bool, tp_group=None) -> torch.Tensor:
    x = _into_group(x, tp_group)
    if "c_fc12" in mlp:
        fc1, fc2 = linear(mlp["c_fc12"], x, plain=plain).chunk(2, dim=-1)
    else:
        fc1 = linear(mlp["c_fc1"], x, plain=plain)
        fc2 = linear(mlp["c_fc2"], x, plain=plain)
    out = linear(mlp["c_proj"], F.silu(fc1) * fc2, plain=plain)
    # a TP rank holds a slice of the hidden dim: its product is a partial sum
    return _sum_group(out, tp_group)


def _cache_write(kv, new: Dict[str, torch.Tensor], write_pos) -> None:
    """Write the new rows (B, H, T, d) of each named array into the layer's
    cache in place at ``write_pos``: an int (T rows from there) or a (B,)
    tensor (one row per slot)."""
    for name, rows in new.items():
        c = kv[name]
        if isinstance(write_pos, int):
            c[:, :, write_pos : write_pos + rows.shape[2]] = rows.to(c.dtype)
        else:
            c[torch.arange(rows.shape[0], device=rows.device), :, write_pos] = rows[:, :, 0].to(c.dtype)


def _causal_self_attention(lp: Params, x, rope, mask, config: LLaMAConfig, kv, write_pos,
                           attend_len, causal: bool, plain: bool, limit=None, tp_group=None):
    """Fused-QKV attention of layer ``lp`` over the T tokens of ``x``, with the
    adapter's prefix term when ``config.adapter`` is set. With ``kv`` the new k/v
    are written in place at ``write_pos`` (quantized first when the cache is
    int8). ``attend_len`` promises a prefill from position 0: the attention is
    causal over the T new rows (of an int8 cache: as they read back from it).
    ``limit`` ((B,) int32, T == 1) sends the token through
    ``decode_attention`` against the cache as it is stored; otherwise the
    attention runs over the whole cache, dequantized to ``q.dtype``, under
    ``mask``. Under ``tp_group`` the heads are this rank's share (H comes
    from the width of ``c_attn``) and ``c_proj``'s partial sum is summed over
    the group."""
    B, T, _ = x.shape
    hs = config.head_size
    attn = lp["attn"]
    x = _into_group(x, tp_group)
    qkv = linear(attn["c_attn"], x, plain=plain)
    if "lora_a" in attn["c_attn"]:
        qkv = qkv + lora.lora_delta(attn["c_attn"], x, config.lora)
    H = qkv.shape[-1] // 3 // hs
    rot = apply_rope_half if config.rope_layout == "half" else apply_rope
    # q and k rotate in one call, as 2H heads: half the small launches of two calls
    qk = rot(qkv[..., : 2 * H * hs].reshape(B, T, 2 * H, hs), rope)
    v = qkv[..., 2 * H * hs :].reshape(B, T, H, hs)
    q, k, v = (t.transpose(1, 2) for t in (qk[:, :, :H], qk[:, :, H:], v))  # (B, H, T, hs)
    y = None
    if kv is not None:
        quant_cache = "ks" in kv
        if quant_cache:
            (kq, vq), (ksc, vsc) = _quantize_kv(torch.stack((k, v)))  # both in one pass
            _cache_write(kv, {"k": kq, "ks": ksc, "v": vq, "vs": vsc}, write_pos)
        else:
            _cache_write(kv, {"k": k, "v": v}, write_pos)
        if limit is not None:
            attend = decode_attention if not plain and decode_route(hs) else decode_attention_ref
            y = attend(q, kv["k"], kv["v"], kv.get("ks"), kv.get("vs"), limit)
        elif attend_len is not None:
            if quant_cache:  # the new rows as the cache gives them back, as the JAX package attends
                k, v = (kq.float() * ksc).to(q.dtype), (vq.float() * vsc).to(q.dtype)
        elif quant_cache:
            k, v = (kv["k"].float() * kv["ks"]).to(q.dtype), (kv["v"].float() * kv["vs"]).to(q.dtype)
        else:
            k, v = kv["k"].to(q.dtype), kv["v"].to(q.dtype)
    if y is None:
        y = attention(q, k, v, mask, causal=causal, plain=plain)
    if config.adapter is not None:
        y = adapter.prefix_attention(lp, q, y, config)
    y = y.transpose(1, 2).reshape(B, T, H * hs)
    out = linear(attn["c_proj"], y, plain=plain)
    return _sum_group(out, tp_group)


def _block(lp: Params, x, rope, mask, config: LLaMAConfig, kv, write_pos=None, attend_len=None,
           causal: bool = False, plain: bool = False, limit=None, tp_group=None):
    """One pre-norm residual block."""
    x = x + _causal_self_attention(lp, rms_norm(x, lp["rms_1"]), rope, mask, config, kv,
                                   write_pos, attend_len, causal, plain, limit, tp_group)
    return x + _mlp(lp["mlp"], rms_norm(x, lp["rms_2"]), plain, tp_group)


def _layer_block(lp: Params, x, layout=None, **kwargs):
    """``_block`` of a training layer; with ``layout`` its leaves are first
    gathered as the forward uses them (inside the activation checkpoint, so
    that the backward gathers them again instead of keeping them)."""
    return _block(layout.use_layer(lp) if layout is not None else lp, x, **kwargs)


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep the outputs of the plain matrix products (the block's five
    linears, ``aten.mm``) and recompute the rest, attention included: the
    counterpart of ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``
    (the attention's products have batch dims; on the card it is K4)."""
    return CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context(policy: str):
    """``context_fn`` of ``checkpoint`` for a remat policy: "dots" saves the
    matmul outputs, "full" only the block input."""
    if policy == "full":
        return None
    if policy == "dots":
        return functools.partial(create_selective_checkpoint_contexts, _dots_policy)
    raise ValueError(f"unknown remat policy {policy!r} (use 'dots' or 'full')")


def _block_slot_fused(lp: Params, x2d, cos, sin, config: LLaMAConfig, kv, slot_pos, plain: bool):
    """Batched serving block as three entries: block head (K7: rms_1, QKV,
    RoPE), cache write + attention (K8), block tail (K9). ``plain`` runs their
    plain versions (what a CPU tensor takes anyway)."""
    B, D = x2d.shape
    H, hs = config.n_head, config.head_size
    head, attn, tail = (
        (fused_layer.block_head_fused_ref, decode_attention_write_ref, fused_layer.block_tail_fused_ref)
        if plain else
        (fused_layer.block_head_fused, decode_attention_write, fused_layer.block_tail_fused)
    )
    qkv = head(x2d, lp["rms_1"], cos, sin, lp["attn"]["c_attn"], config)
    q, k, v = (qkv[:, i * D : (i + 1) * D].reshape(B, H, 1, hs) for i in range(3))
    y, _, _ = attn(q, k, v, kv["k"], kv["v"], slot_pos)
    return tail(x2d, y.reshape(B, D), lp["rms_2"], lp["attn"]["c_proj"], lp["mlp"]["c_fc12"],
                lp["mlp"]["c_proj"], config)


def forward(
    params: Params,
    tokens: torch.Tensor,
    config: LLaMAConfig,
    *,
    rope_cache: Optional[torch.Tensor] = None,
    input_pos=None,
    slot_pos: Optional[torch.Tensor] = None,
    kv_cache: Optional[KVCache] = None,
    prefill_from_zero: bool = False,
    plain: bool = False,
    remat: bool = False,
    remat_policy: str = "dots",
    tp_group=None,
    layout=None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the model over (B, T) tokens; returns (logits (B, T, V), cache).

    Without ``kv_cache``: causal forward, cache None. With ``kv_cache`` (a
    per-layer list, written IN PLACE and returned) one of:

    ``prefill_from_zero=True``: the tokens sit at positions 0..T-1 and the
    attention is causal over them.

    ``input_pos`` (T contiguous positions; a sequence or a CPU tensor, since
    they are read on the host): the new k/v go to those cache rows and the
    attention runs over the whole cache, row ``s`` visible to the query at
    position ``p`` iff ``s <= p``. This is the continuing chunk of a chunked
    prefill (T > 1) and the per-op decode step (T == 1), which attends through
    ``decode_attention`` (K5 on the card). With T == 1 and a position at or
    past the cache length S the cache is rolled one row left and the token
    written at S - 1; it then sees every row.

    ``slot_pos`` ((B,) ints on the tokens' device): continuous-batching
    decode, T == 1. Each slot is its own sequence: its token is written at
    ``slot_pos[b] % S`` (a ring past the cache), row ``s`` is visible iff
    ``s <= slot_pos[b]``, so a slot at or past S - 1 sees every row. Prepared
    int4 layers (``fused_layer.use_serve_fused``) on a cache in the compute
    dtype take the three fused entries per block, K7, K8 and K9 on the card;
    other layers (dense, int8), and any layers on an int8 cache, take the
    per-op block with ``decode_attention``.

    ``plain`` runs every kernel's plain version (the reference path the chip
    check holds the kernels against).

    ``remat`` (no cache only, the training path) runs each block under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are recomputed
    in the backward, all but the matmul outputs with ``remat_policy="dots"``,
    all but the block input with ``"full"``. The stacked (L, ...) tree stays
    the training layout: the layers are views of it, so the grads land on the
    stacked leaves.

    ``tp_group`` (a ``torch.distributed`` group): Megatron-style tensor
    parallelism over its ranks, with the weights of ``parallel.tp``'s layout
    (this rank's heads, MLP hidden columns and vocab columns; norms and the
    embedding whole). Each block all-reduces the outputs of its two
    projections and the logits are all-gathered along the vocab, so every
    rank returns the whole (B, T, V). The fused serving blocks (K7-K9) are
    not taken under a group, as the JAX package gates them: K9 fuses the
    attention's projection with the MLP, leaving no point for the sum
    between them. An adapter raises: its prefix attention spans every head.
    With gradients on, the group's sums are ``parallel.comm``'s
    differentiable collectives (Megatron's f before each column-split
    product and the lm_head, g after each row-split one).

    ``layout`` (no cache: the training path across ranks) holds this rank's
    place in a ``(data, model)`` mesh and the layout of ``params``, its
    shards (``parallel.sharding``): each layer's FSDP leaves are gathered
    inside its checkpoint region, wte and the lm_head around the lookup and
    the head; under TP the lookup is vocab-parallel and the tokens' logits
    come back whole. ``tp_group`` is the layout's model group.
    """
    if layout is not None:
        if kv_cache is not None:
            raise ValueError("the sharded training forward takes no cache")
        tp_group = layout.model_group
    if tp_group is not None and config.adapter is not None:
        raise NotImplementedError("adapter overlays are not supported under tensor parallelism")
    B, T = tokens.shape
    cd = torch_dtype(config.compute_dtype)
    dev = tokens.device
    if rope_cache is None:
        rope_cache = build_rope_cache(config.block_size, config.head_size, device=dev)
    if layout is not None:
        x = layout.embed(params["wte"], tokens).to(cd)
        layers = _layers({**params, "h": layout.use_stacked(params["h"])})
    else:
        x = params["wte"][tokens].to(cd)
        layers = _layers(params)
    write_pos = attend_len = mask = limit = None
    causal = False

    if kv_cache is None:
        rope = rope_cache[:T]
        mask = torch.ones(T, T, dtype=torch.bool, device=dev).tril()
        causal = True
    elif not isinstance(kv_cache, (list, tuple)):
        raise TypeError("kv_cache is a per-layer list of {'k', 'v'[, 'ks', 'vs']} (init_kv_cache)")
    elif slot_pos is not None:
        if T != 1:
            raise ValueError("slot_pos decode takes one token per slot")
        S = kv_cache[0]["k"].shape[-2]
        # K8 reads a cache in the compute dtype
        if tp_group is None and use_serve_fused(config, layers[0], batch=B) and kv_cache[0]["k"].dtype == cd:
            cos, sin = slot_rope_rows(rope_cache, slot_pos)
            pos32 = slot_pos.to(torch.int32)
            x2d = x[:, 0]
            for lp, kv in zip(layers, kv_cache):
                x2d = _block_slot_fused(lp, x2d, cos, sin, config, kv, pos32, plain)
            x = rms_norm(x2d[:, None], params["ln_f"])
            return linear(params["lm_head"], x, plain=plain), kv_cache
        pos = slot_pos.long()
        rope = rope_cache[pos.clamp(0, config.block_size - 1)][:, None]  # (B, 1, hs/2, 2)
        limit = slot_pos.to(torch.int32)
        write_pos = pos % S
    elif prefill_from_zero:
        rope = rope_cache[:T]
        mask = torch.ones(T, T, dtype=torch.bool, device=dev).tril()
        causal = True
        attend_len = T
        write_pos = 0
    elif input_pos is not None:
        S = kv_cache[0]["k"].shape[-2]
        positions = [int(p) for p in input_pos]
        if len(positions) != T or positions != list(range(positions[0], positions[0] + T)):
            raise ValueError(f"input_pos must be {T} contiguous positions, got {positions}")
        write_pos = positions[0]
        if T == 1 and write_pos >= S:
            for kv in kv_cache:  # roll one row left, write at the last row
                for c in kv.values():
                    c.copy_(torch.roll(c, -1, dims=-2))
            write_pos = S - 1
        elif write_pos + T > S:
            raise ValueError(f"positions {positions[0]}..{positions[-1]} run past the cache length {S}")
        pos = torch.tensor(positions, device=dev)
        rope = rope_cache[pos.clamp(0, config.block_size - 1)]
        if T == 1:
            limit = pos.to(torch.int32).expand(B).contiguous()  # the unrolled position: past S - 1 sees all
        else:
            mask = torch.arange(S, device=dev)[None, :] <= pos[:, None]  # (T, S)
    else:
        raise ValueError("a forward with kv_cache needs prefill_from_zero, input_pos or slot_pos")

    if kv_cache is None and (remat or layout is not None):
        context = _remat_context(remat_policy) if remat else None
        kwargs = {} if context is None else {"context_fn": context}
        for lp in layers:
            block = functools.partial(_layer_block, lp, layout=layout, rope=rope, mask=mask, config=config,
                                      kv=None, causal=True, plain=plain, tp_group=tp_group)
            x = checkpoint(block, x, use_reentrant=False, preserve_rng_state=False, **kwargs) if remat else block(x)
    else:
        caches = kv_cache if kv_cache is not None else [None] * len(layers)
        for lp, kv in zip(layers, caches):
            x = _block(lp, x, rope, mask, config, kv, write_pos, attend_len, causal, plain, limit, tp_group)
    if layout is not None:
        x = rms_norm(x, layout.use_root("ln_f", params["ln_f"]))
        logits = linear(layout.use_root("lm_head", params["lm_head"]), _into_group(x, tp_group), plain=plain)
        return layout.logits(logits), None
    x = rms_norm(x, params["ln_f"])
    logits = linear(params["lm_head"], _into_group(x, tp_group), plain=plain)
    if tp_group is not None:
        logits = comm.all_gather_last(logits, tp_group)
    return logits, kv_cache


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


def unfuse_mlp_layer(lp: Params) -> Params:
    """A layer with ``c_fc12`` split back into ``c_fc1`` and ``c_fc2`` (views),
    for layouts that shard the two separately (``parallel.tp``); other
    layers come back as they are."""
    mlp = lp.get("mlp", {})
    if "c_fc12" not in mlp:
        return lp
    halves = {k: v.chunk(2, dim=-1) for k, v in mlp["c_fc12"].items()}
    return {**lp, "mlp": {"c_fc1": {k: v[0] for k, v in halves.items()},
                          "c_fc2": {k: v[1] for k, v in halves.items()}, "c_proj": mlp["c_proj"]}}


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
