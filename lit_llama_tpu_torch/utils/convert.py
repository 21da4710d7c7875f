"""Checkpoint layouts: Meta and HF state dicts -> lit-llama names, and
lit-llama state dicts <-> the port's parameter tree (counterpart of
lit_llama_tpu/utils/convert.py).

The tree is the JAX package's: linear weights transposed to (in, out), layers
stacked on a leading axis, the vocabulary padded to ``padded_vocab_size``.
A state dict holds lit-llama names in torch orientation (out, in). Values are
torch tensors (``torch.load`` of a ``.pth``, memory-mapped) or anything
``torch.as_tensor`` takes.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from lit_llama_tpu_torch.models.config import LLaMAConfig
from lit_llama_tpu_torch.utils.device import resolve_device, torch_dtype

_MLP = ("c_fc1", "c_fc2", "c_proj")


def _tensor(t) -> torch.Tensor:
    return t if isinstance(t, torch.Tensor) else torch.as_tensor(t)


def _owned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when it is contiguous and spans its whole storage, else a
    copy: ``torch.save`` writes a view's whole storage."""
    whole = t.untyped_storage().nbytes() == t.numel() * t.element_size()
    return t if t.is_contiguous() and t.storage_offset() == 0 and whole else t.contiguous().clone()


def hf_permute_back(w: torch.Tensor, n_head: int) -> torch.Tensor:
    """Undo HF's rotary q/k permutation (half-split layout -> Meta's
    interleaved pairs); ``w`` is (dim, dim) in torch orientation (out, in)."""
    dim_out, dim_in = w.shape
    return w.reshape(n_head, 2, dim_out // n_head // 2, dim_in).transpose(1, 2).reshape(dim_out, dim_in)


_HF_LAYER = {
    "self_attn.o_proj.weight": "attn.c_proj.weight",
    "mlp.gate_proj.weight": "mlp.c_fc1.weight",
    "mlp.up_proj.weight": "mlp.c_fc2.weight",
    "mlp.down_proj.weight": "mlp.c_proj.weight",
    "input_layernorm.weight": "rms_1.scale",
    "post_attention_layernorm.weight": "rms_2.scale",
}
_HF_TOP = {
    "model.embed_tokens.weight": "transformer.wte.weight",
    "model.norm.weight": "transformer.ln_f.scale",
    "lm_head.weight": "lm_head.weight",
}


def hf_to_lit(sd: Mapping[str, Any], config: LLaMAConfig) -> Dict[str, torch.Tensor]:
    """HF LLaMA state dict -> lit-llama names (torch orientation, dtypes kept):
    q and k un-permuted, then q, k, v fused into ``c_attn``. ``rotary_emb.inv_freq``
    and every key outside ``model.layers.*`` and the three top-level weights
    are skipped."""
    out: Dict[str, torch.Tensor] = {}
    qkv: Dict[int, Dict[str, torch.Tensor]] = {}
    for name, t in sd.items():
        if "rotary_emb.inv_freq" in name:
            continue
        if name in _HF_TOP:
            out[_HF_TOP[name]] = _owned(_tensor(t))
            continue
        if not name.startswith("model.layers."):
            continue
        layer = int(name.split(".")[2])
        sub = ".".join(name.split(".")[3:])
        if sub in ("self_attn.q_proj.weight", "self_attn.k_proj.weight", "self_attn.v_proj.weight"):
            qkv.setdefault(layer, {})[sub.split(".")[1]] = _tensor(t)
            continue
        out[f"transformer.h.{layer}.{_HF_LAYER[sub]}"] = _owned(_tensor(t))
    for layer, parts in qkv.items():
        q = hf_permute_back(parts["q_proj"], config.n_head)
        k = hf_permute_back(parts["k_proj"], config.n_head)
        out[f"transformer.h.{layer}.attn.c_attn.weight"] = torch.cat([q, k, parts["v_proj"]])
    return out


# Meta name -> (lit-llama name, the dim its tensor-parallel shards split;
# None: replicated on every shard)
_META_TOP = {
    "tok_embeddings.weight": ("transformer.wte.weight", 1),
    "output.weight": ("lm_head.weight", 0),
    "norm.weight": ("transformer.ln_f.scale", None),
}
_META_LAYER = {
    "attention.wq.weight": ("attn.wq", 0),
    "attention.wk.weight": ("attn.wk", 0),
    "attention.wv.weight": ("attn.wv", 0),
    "attention.wo.weight": ("attn.c_proj.weight", 1),
    "feed_forward.w1.weight": ("mlp.c_fc1.weight", 0),
    "feed_forward.w2.weight": ("mlp.c_proj.weight", 1),
    "feed_forward.w3.weight": ("mlp.c_fc2.weight", 0),
    "attention_norm.weight": ("rms_1.scale", None),
    "ffn_norm.weight": ("rms_2.scale", None),
}


def meta_to_lit(shards: list, config: LLaMAConfig, dtype="float32") -> Dict[str, torch.Tensor]:
    """Meta ``consolidated.*.pth`` state dicts, in rank order -> lit-llama
    names in ``dtype``. Each tensor-parallel shard is concatenated along its
    own dim (a replicated norm is taken from the last shard); wq, wk and wv
    are fused into ``c_attn`` after the merge, which re-interleaves the
    shards' q, k and v rows as the reference does."""
    dt = torch_dtype(dtype)
    merged: Dict[str, Tuple[Optional[int], list]] = {}
    for shard in shards:
        for name, t in shard.items():
            if name in _META_TOP:
                to_name, dim = _META_TOP[name]
            elif name.startswith("layers.") and ".".join(name.split(".")[2:]) in _META_LAYER:
                to_sub, dim = _META_LAYER[".".join(name.split(".")[2:])]
                to_name = f"transformer.h.{name.split('.')[1]}.{to_sub}"
            else:
                continue
            t = _tensor(t).to(dt)
            if dim is None:
                merged[to_name] = (None, [t])
            else:
                merged.setdefault(to_name, (dim, []))[1].append(t)
    out: Dict[str, torch.Tensor] = {}
    wqkv: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, (dim, parts) in merged.items():
        t = torch.cat(parts, dim=dim) if len(parts) > 1 else _owned(parts[0])
        if ".attn.w" in name:
            base, which = name.rsplit(".", 1)  # ...attn, wq | wk | wv
            wqkv.setdefault(base, {})[which] = t
        else:
            out[name] = t
    for base, parts in wqkv.items():
        out[base.replace(".attn", ".attn.c_attn.weight")] = torch.cat([parts["wq"], parts["wk"], parts["wv"]])
    return out


def lit_to_pytree(sd: Mapping[str, Any], config: LLaMAConfig, dtype=None, device=None) -> Dict[str, Any]:
    """lit-llama state dict -> the stacked tree in ``dtype`` (the config's
    param dtype when None) on ``device`` (the card when None). Each tensor
    goes to the device on its own, so the host holds no second copy of the
    model; the embedding and lm_head are zero-padded to the padded
    vocabulary."""
    dt = torch_dtype(dtype or config.param_dtype)
    dev = resolve_device(device)
    L, V = config.n_layer, config.padded_vocab_size

    def get(name, transpose=False):
        t = _tensor(sd[name]).to(dev, dt)
        return t.t() if transpose else t

    def pad_vocab(t):
        return torch.cat([t, t.new_zeros((V - t.shape[0],) + tuple(t.shape[1:]))]) if t.shape[0] < V else t

    def stack(suffix, transpose=True):
        return torch.stack([get(f"transformer.h.{i}.{suffix}", transpose) for i in range(L)])

    return {
        "wte": pad_vocab(get("transformer.wte.weight")),
        "ln_f": get("transformer.ln_f.scale"),
        "lm_head": {"w": pad_vocab(get("lm_head.weight")).t().contiguous()},
        "h": {
            "rms_1": stack("rms_1.scale", False),
            "rms_2": stack("rms_2.scale", False),
            "attn": {"c_attn": {"w": stack("attn.c_attn.weight")}, "c_proj": {"w": stack("attn.c_proj.weight")}},
            "mlp": {name: {"w": stack(f"mlp.{name}.weight")} for name in _MLP},
        },
    }


def pytree_to_lit(params: Dict[str, Any], config: LLaMAConfig) -> Dict[str, torch.Tensor]:
    """The stacked dense tree -> a lit-llama state dict (CPU tensors, torch
    orientation), for ``torch.save``."""
    h = params["h"]

    def cpu(t):
        return t.detach().cpu().contiguous()

    out = {"transformer.wte.weight": cpu(params["wte"]), "transformer.ln_f.scale": cpu(params["ln_f"]),
           "lm_head.weight": cpu(params["lm_head"]["w"].t())}
    for i in range(config.n_layer):
        out[f"transformer.h.{i}.rms_1.scale"] = cpu(h["rms_1"][i])
        out[f"transformer.h.{i}.rms_2.scale"] = cpu(h["rms_2"][i])
        out[f"transformer.h.{i}.attn.c_attn.weight"] = cpu(h["attn"]["c_attn"]["w"][i].t())
        out[f"transformer.h.{i}.attn.c_proj.weight"] = cpu(h["attn"]["c_proj"]["w"][i].t())
        for name in _MLP:
            out[f"transformer.h.{i}.mlp.{name}.weight"] = cpu(h["mlp"][name]["w"][i].t())
    return out


def llama_model_lookup(sd: Mapping[str, Any]) -> str:
    """The preset of a checkpoint from its embedding width."""
    embd_to_name = {4096: "7B", 5120: "13B", 6656: "30B", 8192: "65B"}
    for key in ("transformer.wte.weight", "tok_embeddings.weight", "model.embed_tokens.weight"):
        if key in sd:
            width = _tensor(sd[key]).shape[1]
            if width not in embd_to_name:
                raise ValueError(f"no preset has an embedding width of {width}; give config.json or model_size")
            return embd_to_name[width]
    raise ValueError("cannot find an embedding weight in the checkpoint")


# ---------------------------------------------------------------------------
# Reference-format LoRA checkpoints <-> the overlay tree
# ---------------------------------------------------------------------------


def peft_sd_kind(sd: Mapping[str, Any]) -> Optional[str]:
    """'lora' (``*.lora_A`` / ``*.lora_B`` entries), 'adapter'
    (``*.adapter_wte.weight`` / ``*.gating_factor``) or None."""
    for name in sd:
        if "lora_A" in name or "lora_B" in name:
            return "lora"
        if "adapter_wte" in name or "gating_factor" in name:
            return "adapter"
    return None


def lora_sd_to_overlay(sd: Mapping[str, Any], config: LLaMAConfig, dtype=None,
                       device=None) -> Tuple[Dict[str, Any], int]:
    """Reference LoRA state dict -> ({"h": {"attn": {"c_attn": {"lora_a",
    "lora_b"}}}}, r).

    Reference layout per layer: ``lora_A`` (n_en * r, D), one (r, D) block per
    enabled group, rows [q; v] for the default groups; ``lora_B``
    (n_en * D, r). Ours: ``lora_a`` (L, D, n_en * r) = lora_A^T stacked and
    ``lora_b`` (L, n_en, r, D) with b[g] = lora_B[g D:(g + 1) D]^T. The rank
    comes from the weights."""
    dt = torch_dtype(dtype or config.param_dtype)
    dev = resolve_device(device)
    enable = config.lora.enable if config.lora is not None else (True, False, True)
    n_en = sum(enable)
    a_list, b_list = [], []
    r = None
    for i in range(config.n_layer):
        A = _tensor(sd[f"transformer.h.{i}.attn.c_attn.lora_A"]).float()
        B = _tensor(sd[f"transformer.h.{i}.attn.c_attn.lora_B"]).float()
        r = A.shape[0] // n_en
        group = B.shape[0] // n_en  # n_embd for the fused c_attn
        a_list.append(A.t())
        b_list.append(torch.stack([B[g * group : (g + 1) * group].t() for g in range(n_en)]))
    overlay = {"h": {"attn": {"c_attn": {"lora_a": torch.stack(a_list).to(dev, dt),
                                         "lora_b": torch.stack(b_list).to(dev, dt)}}}}
    return overlay, int(r)


def lora_overlay_to_sd(overlay: Dict[str, Any], config: LLaMAConfig) -> Dict[str, torch.Tensor]:
    """The overlay tree -> a reference-format LoRA state dict (CPU f32
    tensors)."""
    c_attn = overlay["h"]["attn"]["c_attn"]
    a = c_attn["lora_a"].detach().float().cpu()  # (L, D, n_en * r)
    b = c_attn["lora_b"].detach().float().cpu()  # (L, n_en, r, D)
    out = {}
    for i in range(a.shape[0]):
        out[f"transformer.h.{i}.attn.c_attn.lora_A"] = a[i].t().contiguous()
        out[f"transformer.h.{i}.attn.c_attn.lora_B"] = torch.cat([b[i, g].t() for g in range(b.shape[1])])
    return out


# ---------------------------------------------------------------------------
# Reference-format adapter checkpoints (v1 and v2) -> the overlay tree
# ---------------------------------------------------------------------------


def adapter_sd_to_overlay(sd: Mapping[str, Any], config: LLaMAConfig, dtype=None,
                          device=None) -> Tuple[Dict[str, Any], int, int, bool]:
    """Reference adapter state dict -> (overlay, prompt_length, start_layer, v2).

    The reference stores ``attn.adapter_wte.weight`` (aT, D) and
    ``attn.gating_factor`` only on the layers from its start layer on; an old
    checkpoint's gate is one scalar, broadcast here to every head, a newer
    one's is (1, H, 1, 1). The stacked overlay gives the layers below the
    start zero prompts and gates, and ``adapter_active`` masks them out. v2
    (any ``adapter_bias`` entry) adds each linear's ``adapter_bias`` /
    ``adapter_scale`` as ``av2_bias`` / ``av2_scale`` (L, 1, out) (zeros and
    ones where a layer has none), lm_head's padded to the padded vocabulary
    (bias 0, scale 1), and the norm weights it holds."""
    dt = torch_dtype(dtype or config.param_dtype)
    dev = resolve_device(device)
    L, D, H = config.n_layer, config.n_embd, config.n_head
    wte_by_layer: Dict[int, torch.Tensor] = {}
    gate_by_layer: Dict[int, torch.Tensor] = {}
    for name, t in sd.items():
        if ".attn.adapter_wte.weight" in name:
            wte_by_layer[int(name.split(".")[2])] = _tensor(t).float()
        elif ".attn.gating_factor" in name:
            g = _tensor(t).float()
            gate_by_layer[int(name.split(".")[2])] = g.reshape(-1)[0].expand(H) if g.ndim < 4 else g.reshape(H)
    if not wte_by_layer:
        raise ValueError("no adapter_wte entries: not a reference adapter checkpoint")
    start_layer = min(wte_by_layer)
    aT = next(iter(wte_by_layer.values())).shape[0]
    wte = torch.zeros((L, aT, D))
    gating = torch.zeros((L, H))
    for i, w in wte_by_layer.items():
        wte[i] = w
    for i, g in gate_by_layer.items():
        gating[i] = g
    h: Dict[str, Any] = {"adapter_wte": wte, "gating": gating,
                         "adapter_active": (torch.arange(L) >= start_layer).float()[:, None]}
    overlay: Dict[str, Any] = {"h": h}
    is_v2 = any("adapter_bias" in name for name in sd)
    if is_v2:
        for lit_name, ours, out_dim in (("attn.c_attn", ("attn", "c_attn"), 3 * D), ("attn.c_proj", ("attn", "c_proj"), D),
                                        ("mlp.c_fc1", ("mlp", "c_fc1"), config.intermediate_size),
                                        ("mlp.c_fc2", ("mlp", "c_fc2"), config.intermediate_size),
                                        ("mlp.c_proj", ("mlp", "c_proj"), D)):
            bias, scale = torch.zeros((L, 1, out_dim)), torch.ones((L, 1, out_dim))
            for i in range(L):
                b = sd.get(f"transformer.h.{i}.{lit_name}.adapter_bias")
                s = sd.get(f"transformer.h.{i}.{lit_name}.adapter_scale")
                if b is not None:
                    bias[i, 0] = _tensor(b).float()
                if s is not None:
                    scale[i, 0] = _tensor(s).float()
            node = h.setdefault(ours[0], {}).setdefault(ours[1], {})
            node["av2_bias"], node["av2_scale"] = bias, scale
        V = config.padded_vocab_size

        def pad_cols(t: torch.Tensor, fill: float) -> torch.Tensor:
            t = _tensor(t).float()[None, :]
            return torch.cat([t, t.new_full((1, V - t.shape[-1]), fill)], dim=-1) if t.shape[-1] < V else t

        if "lm_head.adapter_bias" in sd:
            overlay["lm_head"] = {"av2_bias": pad_cols(sd["lm_head.adapter_bias"], 0.0),
                                  "av2_scale": pad_cols(sd["lm_head.adapter_scale"], 1.0)}
        for norm in ("rms_1", "rms_2"):
            rows = [sd.get(f"transformer.h.{i}.{norm}.scale") for i in range(L)]
            if all(t is not None for t in rows):
                h[norm] = torch.stack([_tensor(t).float() for t in rows])
        if "transformer.ln_f.scale" in sd:
            overlay["ln_f"] = _tensor(sd["transformer.ln_f.scale"]).float()

    def cast(node):
        return {k: cast(v) for k, v in node.items()} if isinstance(node, dict) else node.to(dev, dt)

    return cast(overlay), int(aT), int(start_layer), is_v2
