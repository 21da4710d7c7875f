"""Single-stream generation (counterpart of lit_llama_tpu/models/generate.py).

``generate`` runs one prefill of the prompt through ``llama.forward``
(``prefill_from_zero``: K3 or K6 for every quantized linear and K4 for the
attention on the card), then a Python decode loop that chooses its step as
the JAX ``generate`` does:

* Params prepared by ``fused_layer.prepare_fused_params`` (int4, per-layer
  list, ``rope_layout == "half"``) with a plain cache decode through the fused
  step: each block is one ``fused_layer.decode_layers_fused`` call (K1) and
  the logits come from ``fused_layer.lm_head_fused`` (K2). The cache is a
  per-layer ring: token ``pos`` is written at ``pos % S`` and sees every slot
  <= pos, so a generation that runs past S keeps the last S positions.
* Anything else (dense, int8, unprepared int4; stacked or unstacked layers;
  either rope layout; an int8 KV cache; an adapter model) decodes per op: one
  ``llama.forward(input_pos=[pos])`` per token, every quantized linear one K3
  or K6 launch and the attention one ``decode_attention`` launch (K5) per
  block on the card. Past S the cache rolls one row left, which keeps the same
  last S positions.

Capturing either step in a CUDA graph is later work.
"""

from __future__ import annotations

from typing import Optional

import torch

from lit_llama_tpu_torch.models import llama
from lit_llama_tpu_torch.models.config import LLaMAConfig
from lit_llama_tpu_torch.ops import fused_layer
from lit_llama_tpu_torch.ops.linear import linear
from lit_llama_tpu_torch.ops.norm import rms_norm
from lit_llama_tpu_torch.ops.rope import build_rope_cache, rope_half_tables
from lit_llama_tpu_torch.utils.device import resolve_device, torch_dtype


def sample_logits(
    logits: torch.Tensor,
    temperature: float,
    top_k: Optional[int],
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Next token from (..., V) logits: greedy argmax at ``temperature == 0``,
    else temperature / exact top-k sampling (the JAX package uses
    ``approx_max_k``, so only greedy output matches it token for token)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, float("-inf")), logits)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1, generator=generator).reshape(
        probs.shape[:-1]
    )


def plan_seq_length(config: LLaMAConfig, t_new: int, max_seq_length: Optional[int] = None) -> int:
    """The cache length a generation of ``t_new`` total tokens uses, identical
    to the JAX package's rule (S decides which tokens survive past the cache)."""
    if max_seq_length is None:
        max_seq_length = min(t_new, config.block_size)
    if config.rope_layout == "half":
        if max_seq_length > 128:
            max_seq_length = min(-(-max_seq_length // 128) * 128, config.block_size)
        elif max_seq_length % 16:
            max_seq_length = min(-(-max_seq_length // 16) * 16, config.block_size)
    return max_seq_length


@torch.no_grad()
def generate(
    params,
    prompt,
    max_new_tokens: int,
    *,
    config: LLaMAConfig,
    max_seq_length: Optional[int] = None,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    eos_id: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> torch.Tensor:
    """Generate a continuation of ``prompt`` (1-D ints). Returns prompt +
    generated tokens as a 1-D int64 CPU tensor; stops after ``eos_id``
    (included). ``params`` must lie on ``device`` (the card when None)."""
    dev = resolve_device(device)
    if params["wte"].device.type != dev.type:
        raise ValueError(f"params lie on {params['wte'].device}, generate was asked for {dev}")
    prompt = torch.as_tensor(prompt, dtype=torch.long).to(dev)
    T = int(prompt.shape[0])
    S = plan_seq_length(config, T + max_new_tokens, max_seq_length)
    cd = torch_dtype(config.compute_dtype)
    rope_cache = build_rope_cache(config.block_size, config.head_size, device=dev)
    cache = llama.init_kv_cache(config, 1, S, cd, device=dev)
    # an adapter's prefix term is in no fused kernel: such a model decodes per op
    fused = (config.rope_layout == "half" and isinstance(params.get("h"), (list, tuple))
             and config.kv_cache_dtype is None and config.adapter is None)

    logits, cache = llama.forward(
        params, prompt[None], config, rope_cache=rope_cache, kv_cache=cache,
        prefill_from_zero=True,
    )
    tok = sample_logits(logits[0, -1:].float(), temperature, top_k, generator)  # (1,)
    out = [tok]
    if eos_id is not None and int(tok) == eos_id:
        return torch.cat([prompt, tok]).cpu()

    if fused:
        cos_tab, sin_tab = rope_half_tables(rope_cache)
        quant_head = "qzero" in params["lm_head"]

        def step(tok, pos):
            rp = min(pos, config.block_size - 1)
            cosf, sinf = cos_tab[rp : rp + 1], sin_tab[rp : rp + 1]
            x = params["wte"][tok].to(cd)  # (1, D)
            for lp, kv in zip(params["h"], cache):
                x, _ = fused_layer.decode_layers_fused(x, [lp], [kv], cosf, sinf, pos % S, pos, config)
            if quant_head:
                return fused_layer.lm_head_fused(x, params["ln_f"], params["lm_head"], config)
            return linear(params["lm_head"], rms_norm(x, params["ln_f"]))
    else:

        def step(tok, pos):
            logits, _ = llama.forward(params, tok[None], config, rope_cache=rope_cache, input_pos=[pos],
                                      kv_cache=cache)
            return logits[0]  # (1, V)

    for i in range(max_new_tokens - 1):
        tok = sample_logits(step(tok, T + i).float(), temperature, top_k, generator)
        out.append(tok)
        if eos_id is not None and int(tok) == eos_id:
            break
    return torch.cat([prompt] + out).cpu()
