"""Tensor-parallel inference (counterpart of lit_llama_tpu/parallel/tp.py).

Every rank of a model group holds its shard of the heads, the MLP hidden dim
and the vocab columns, its kernels see LOCAL shapes, and the only
communication is one all-reduce after each block's two projections and one
all-gather of the logits: the Megatron schedule (``llama.forward``'s
``tp_group``; the collectives are ``parallel.comm``'s).

Layout (per rank, mp = the model group's size):
  wte, norms          whole
  c_attn              (D, 3·D/mp)   columns permuted so a contiguous shard is
                                    (q, k, v) of H/mp heads
  attn c_proj         (D/mp, D)     row shard -> all-reduce
  c_fc1 / c_fc2       (D, I/mp)     unfused (the inference layout's c_fc12
                                    would put fc1 on one rank, fc2 on another)
  mlp c_proj          (I/mp, D)     row shard -> all-reduce
  lm_head             (D, V/mp)     logits all-gathered
  kv cache            (B, H/mp, S, hs) a layer (B/dp slots under a data axis)

Quantized leaves shard with their weight: int4 ``qscale`` / ``qzero`` like
the weight's sharded dim (groups follow the rows of a row shard); int8
``qscale`` (one per output column) like the output dim, and whole for a row
shard. A row-sharded int4 weight is re-packed so that each shard is
half-split over its own rows (the global half-split pairs rows K/2 apart,
which a row shard would tear), and the MLP hidden dim is zero-padded to a
multiple of mp·2·gs (int4), mp·256 (int8, so that every shard stays on K6)
or mp (dense): padded channels give exact zeros end to end. The JAX package treats an int8 ``c_proj`` as int4 (it
re-packs its bytes as nibbles) and shards its (1, D) scale over the rows,
which its device placement refuses; the port shards int8 rows as they are.

The local lm_head (V/mp columns: 16000 at mp = 2 for LLaMA's 32000) is not
a multiple of 256, so ``ops.quant_matmul.quant_route`` sends it to K3's plain
version, as JAX's shape gate sends it to XLA; every block linear stays on K3
or K6.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from lit_llama_tpu_torch.models import llama
from lit_llama_tpu_torch.models.config import LLaMAConfig
from lit_llama_tpu_torch.models.generate import sample_logits
from lit_llama_tpu_torch.ops.linear import pack_int4, unpack_int4
from lit_llama_tpu_torch.ops.rope import build_rope_cache
from lit_llama_tpu_torch.parallel.mesh import coordinate, mesh_shape, model_group
from lit_llama_tpu_torch.utils.math import find_multiple

Params = Dict[str, Any]


def tp_param_specs(params: Params):
    """The tree's shape with, at each leaf, the axis (counted from the end)
    that shards over the model axis, or None where the leaf is whole. Holds
    for stacked and per-layer trees alike."""

    def spec(name: str, parent: str, node: Params) -> Optional[int]:
        if name in ("wte", "lora_a"):
            return None  # lora_a is small and its input whole
        if name == "lora_b":
            return -1  # (..., g, r, D): the q / v head columns, contiguous in D
        if parent in ("lm_head", "c_attn", "c_fc1", "c_fc2"):
            return -1  # output columns
        if parent == "c_proj":
            if name == "qscale" and "qzero" not in node:
                return None  # int8: one scale per output column
            return -2 if name in ("w", "qw", "qscale", "qzero") else None  # rows (int4 groups follow them)
        return None

    def visit(node, name: str, parent: str, owner):
        if isinstance(node, dict):
            return {k: visit(v, k, name, node) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(visit(v, name, parent, owner) for v in node)
        return spec(name, parent, owner)

    return visit(params, "", "", params)


def _qkv_col_perm(d3: int, mp: int) -> torch.Tensor:
    """Permutation making contiguous 1/mp chunks of the fused QKV columns
    equal (q shard, k shard, v shard) per rank: a contiguous shard of
    [q | k | v] would give rank 0 all of q instead of its heads."""
    d = d3 // 3
    sh = d // mp
    idx = [t * d + dev * sh + i for dev in range(mp) for t in range(3) for i in range(sh)]
    return torch.tensor(idx, dtype=torch.long)


def qkv_columns(t: torch.Tensor, mp: int, inverse: bool = False) -> torch.Tensor:
    """``t``'s fused QKV columns (its last axis) in the order that shards over
    mp ranks, or (``inverse``) back in the order of [q | k | v]."""
    perm = _qkv_col_perm(t.shape[-1], mp)
    return t[..., (torch.argsort(perm) if inverse else perm).to(t.device)]


# the axis of a dense block weight that holds the MLP hidden dim
_HIDDEN_AXIS = {"mlp/c_fc1/w": -1, "mlp/c_fc2/w": -1, "mlp/c_proj/w": -2}


def hidden_axis(rel: str) -> Optional[int]:
    """The MLP hidden axis (from the end) of the dense block leaf at ``rel``
    (its path in a block, such as ``mlp/c_proj/w``), None for other leaves."""
    return _HIDDEN_AXIS.get(rel)


def dense_to_tp(rel: str, t: torch.Tensor, mp: int, hidden: int) -> torch.Tensor:
    """The dense block leaf at ``rel`` in the layout that shards over mp
    ranks, for inference and training alike: c_attn's columns permuted
    (``qkv_columns``), the MLP hidden axis (``hidden`` wide) zero-padded to a
    multiple of mp. Any leading axes (a stacked leaf); other leaves come back
    as they are."""
    if rel == "attn/c_attn/w":
        return qkv_columns(t, mp)
    axis = hidden_axis(rel)
    extra = find_multiple(hidden, mp) - hidden
    if axis is None or not extra:
        return t
    return torch.nn.functional.pad(t, [0, 0] * (-axis - 1) + [0, extra])


def dense_from_tp(rel: str, t: torch.Tensor, mp: int, hidden: int) -> torch.Tensor:
    """``dense_to_tp`` undone: the columns back in place, the padding cut."""
    if rel == "attn/c_attn/w":
        return qkv_columns(t, mp, inverse=True)
    axis = hidden_axis(rel)
    return t if axis is None else t.narrow(axis, 0, hidden)


def _dense_layer_to_tp(lp: Params, mp: int) -> Params:
    """A dense layer (MLP unfused) in the TP layout (``dense_to_tp``)."""
    hidden = lp["mlp"]["c_proj"]["w"].shape[-2]
    out = dict(lp)
    for part in ("attn", "mlp"):
        out[part] = {lin: ({k: dense_to_tp(f"{part}/{lin}/{k}", v, mp, hidden) for k, v in leaf.items()}
                           if isinstance(leaf, dict) else leaf)
                     for lin, leaf in lp[part].items()}
    return out


def _repack_rows(q: torch.Tensor, mp: int) -> torch.Tensor:
    """(K, N) nibble values -> (K/2, N) bytes, each of the mp row shards
    half-split over its own rows."""
    return torch.cat([pack_int4(s) for s in q.chunk(mp, dim=0)], dim=0)


_QUANT_KEYS = ("qw", "qscale", "qzero")


def _pad_cols(leaf: Params, n: int) -> Params:
    """``n`` zero output columns on every quantized entry of a linear."""
    return {k: (torch.nn.functional.pad(v, (0, n)) if k in _QUANT_KEYS else v) for k, v in leaf.items()}


def _fix_proj(proj: Params, mp: int, gs: int, k_pad: int = 0) -> Params:
    """A row-sharded quantized ``c_proj``: rows zero-padded to ``k_pad``
    (zero-valued groups for int4: scale = zero = 0 dequantizes to exactly
    0), and int4 re-packed per shard."""
    out = dict(proj)
    if "qzero" not in proj:  # int8: rows as they are
        if k_pad:
            out["qw"] = torch.nn.functional.pad(proj["qw"], (0, 0, 0, k_pad - proj["qw"].shape[0]))
        return out
    q = unpack_int4(proj["qw"])
    if k_pad:
        pad_groups = (k_pad - q.shape[0]) // gs
        q = torch.nn.functional.pad(q, (0, 0, 0, k_pad - q.shape[0]))
        out["qscale"] = torch.nn.functional.pad(proj["qscale"], (0, 0, 0, pad_groups))
        out["qzero"] = torch.nn.functional.pad(proj["qzero"], (0, 0, 0, pad_groups))
    out["qw"] = _repack_rows(q, mp)
    return out


def _hidden_multiple(proj: Params, mp: int, gs: int) -> int:
    """What a quantized MLP hidden dim is padded to a multiple of: mp · 2 ·
    gs for int4 (whole half-split group pairs a shard), mp · 256 for int8
    (each shard's width a multiple of 256, which ``quant_route`` sends to
    K6; the JAX package has no int8 TP to follow). Dense weights take mp
    (JAX's; ``dense_to_tp``)."""
    return mp * 2 * gs if "qzero" in proj else mp * 256


def _rows(proj: Params) -> int:
    """The contraction width of a quantized (K, N) linear."""
    return proj["qw"].shape[-2] * (2 if "qzero" in proj else 1)


def prepare_tp_params(params: Params, config: LLaMAConfig, mp: int) -> Params:
    """The whole model in the layout that shards over ``mp`` ranks (per-layer
    list, MLP unfused; see the module docstring): c_attn's columns permuted,
    the row-sharded int4 weights re-packed per shard, the MLP hidden dim
    zero-padded where mp does not divide it. New tensors where a leaf
    changes; the input tree is not changed."""
    tree = llama.unstack_layers(params)
    if config.rope_layout == "half" or any("qw_t" in lp["attn"]["c_attn"] for lp in tree["h"]):
        raise ValueError("tensor parallelism takes the weights as loaded, not prepared for the fused decode step")
    gs = config.quant_groupsize
    if config.n_head % mp:
        raise ValueError(f"{config.n_head} heads do not shard over {mp} ranks")
    if "qzero" in tree["h"][0]["attn"]["c_proj"] and (config.n_embd // mp) % gs:
        raise ValueError(f"a shard's {config.n_embd // mp} rows of attn.c_proj do not hold whole int4 groups of {gs}")
    layers = []
    for lp in tree["h"]:
        lp = llama.unfuse_mlp_layer(lp)
        if "w" in lp["mlp"]["c_proj"]:  # dense (GPTQ quantizes the five linears or none)
            layers.append(_dense_layer_to_tp(lp, mp))
            continue
        attn, mlp = dict(lp["attn"]), dict(lp["mlp"])
        attn["c_attn"] = {k: (qkv_columns(v, mp) if k in _QUANT_KEYS else v) for k, v in attn["c_attn"].items()}
        attn["c_proj"] = _fix_proj(attn["c_proj"], mp, gs)
        I = _rows(mlp["c_proj"])
        I_pad = find_multiple(I, _hidden_multiple(mlp["c_proj"], mp, gs))
        if I_pad != I:
            mlp["c_fc1"], mlp["c_fc2"] = _pad_cols(mlp["c_fc1"], I_pad - I), _pad_cols(mlp["c_fc2"], I_pad - I)
        mlp["c_proj"] = _fix_proj(mlp["c_proj"], mp, gs, k_pad=I_pad if I_pad != I else 0)
        layers.append({**lp, "attn": attn, "mlp": mlp})
    return {**tree, "h": layers}


def shard_params_tp(params: Params, mesh, config: Optional[LLaMAConfig] = None, device=None) -> Params:
    """This rank's shard of ``params`` (stacked or per-layer, as loaded),
    laid out by ``prepare_tp_params`` when the mesh's model axis is > 1, on
    ``device`` (default: where the leaves lie). With a model axis of 1 the
    per-layer tree comes back whole."""
    _, mp = mesh_shape(mesh)
    _, m = coordinate(mesh)
    tree = prepare_tp_params(params, config, mp) if mp > 1 and config is not None else llama.unstack_layers(params)
    specs = tp_param_specs(tree)

    def take(node, spec):
        if isinstance(node, dict):
            return {k: take(v, spec[k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(take(v, s) for v, s in zip(node, spec))
        local = node if spec is None else node.chunk(mp, dim=spec)[m].contiguous()
        return local if device is None else local.to(device)

    return take(tree, specs)


def init_tp_cache(config: LLaMAConfig, mesh, batch_size: int, max_seq_length: int, dtype=None, device=None):
    """This rank's per-layer KV cache: its H/mp heads, and its B/dp slots
    where the mesh's data axis is > 1 and divides the batch."""
    dp, mp = mesh_shape(mesh)
    local_b = batch_size // dp if dp > 1 and batch_size % dp == 0 else batch_size
    return llama.init_kv_cache(config, local_b, max_seq_length, dtype, device=device, n_head=config.n_head // mp)


def make_sharded_forwards(config: LLaMAConfig, mesh, rope_cache: Optional[torch.Tensor] = None):
    """(prefill, decode) over this rank's shard, as closures over its model
    group:

    prefill(params, tokens (B, T), cache, plain=False) -> (logits, cache):
        positions 0..T-1 (``prefill_from_zero``);
    decode(params, tokens (B, 1), slot_pos (B,), cache, plain=False) ->
        (logits, cache): the continuous-batching step, B this rank's slots.

    Logits come back whole (B, T, V) on every rank. A data axis needs no
    communication here: each data group passes its own slots."""
    group = model_group(mesh)

    def prefill(params, tokens, cache, plain: bool = False):
        return llama.forward(params, tokens, config, rope_cache=rope_cache, kv_cache=cache, prefill_from_zero=True,
                             tp_group=group, plain=plain)

    def decode(params, tokens, slot_pos, cache, plain: bool = False):
        return llama.forward(params, tokens, config, rope_cache=rope_cache, slot_pos=slot_pos, kv_cache=cache,
                             tp_group=group, plain=plain)

    return prefill, decode


@torch.no_grad()
def generate_tp(
    params: Params,
    prompt,
    max_new_tokens: int,
    *,
    config: LLaMAConfig,
    mesh,
    max_seq_length: Optional[int] = None,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    eos_id: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Single-prompt generation through the TP forward (the sibling of
    ``models.generate.generate``): one prefill, then the ``slot_pos`` ring
    step a token (past the cache the write wraps, keeping the last S
    positions), stopping after ``eos_id`` (included). ``params`` come from
    ``shard_params_tp``; a LoRA overlay composes (``lora_b`` shards with the
    head columns). Every rank of the group returns the same prompt +
    generated tokens, a 1-D int64 CPU tensor: the logits are gathered whole
    and sampling draws from ``generator``, which every rank seeds alike."""
    dev = params["wte"].device
    prompt = torch.as_tensor(prompt, dtype=torch.long).to(dev)
    T = int(prompt.shape[0])
    S = min(max_seq_length or T + max_new_tokens, config.block_size)
    rope = build_rope_cache(config.block_size, config.head_size, device=dev)
    prefill, decode = make_sharded_forwards(config, mesh, rope)
    cache = init_tp_cache(config, mesh, 1, S, device=dev)

    logits, cache = prefill(params, prompt[None], cache)
    tok = sample_logits(logits[0, -1:].float(), temperature, top_k, generator)  # (1,)
    out = [tok]
    for i in range(max_new_tokens - 1):
        if eos_id is not None and int(tok) == eos_id:
            break
        pos = torch.tensor([T + i], dtype=torch.int32, device=dev)
        logits, cache = decode(params, tok[None], pos, cache)
        tok = sample_logits(logits[:, -1].float(), temperature, top_k, generator)
        out.append(tok)
    return torch.cat([prompt] + out).cpu()
