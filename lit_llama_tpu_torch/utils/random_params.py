"""Random quantized weights built directly at their stored shapes
(counterpart of ``random_int4_params`` and ``random_int8_params`` in the JAX
package's bench.py).

Decode speed does not depend on weight values, so the chip check runs the
full model on these. Int4: uniform random bytes for the packed nibbles, a
scale drawn from U[0.002, 0.006] and a zero from U[-0.04, -0.02] for each
(group, column), so weights spread about zero. Int8: uniform values in
[-127, 127] and a scale drawn from U[0.0002, 0.0004] for each output column.
The scales vary so that a kernel that reads the wrong group, nibble plane or
column of them disagrees with its plain version. Normal(0, 0.02) embedding,
unit norms. A LoRA overlay (``random_lora_overlay``) has A as the JAX
package initialises it and B drawn too, not zero: with B = 0 the update
vanishes and a kernel that dropped it would still agree. Built from a seeded ``torch.Generator`` on the target device;
dense 7B weights are never materialised.
"""

from __future__ import annotations

import torch

from lit_llama_tpu_torch.models.config import LLaMAConfig
from lit_llama_tpu_torch.utils.device import resolve_device, torch_dtype


def _random_tree(config: LLaMAConfig, seed: int, device, make_linear):
    """The stacked (L, ...) parameter tree with every linear made by
    ``make_linear(gen, uniform, *shape)`` from one seeded generator."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    D, V, I, L = config.n_embd, config.padded_vocab_size, config.intermediate_size, config.n_layer
    dtype = torch_dtype(config.param_dtype)

    def uniform(shape, lo, hi):
        return torch.empty(shape, dtype=torch.float32, device=dev).uniform_(lo, hi, generator=gen)

    def lin(*shape):
        return make_linear(gen, uniform, *shape)

    return {
        "wte": (torch.randn((V, D), generator=gen, device=dev) * 0.02).to(dtype),
        "h": {
            "rms_1": torch.ones((L, D), dtype=dtype, device=dev),
            "attn": {"c_attn": lin(L, D, 3 * D), "c_proj": lin(L, D, D)},
            "rms_2": torch.ones((L, D), dtype=dtype, device=dev),
            "mlp": {"c_fc1": lin(L, D, I), "c_fc2": lin(L, D, I), "c_proj": lin(L, I, D)},
        },
        "ln_f": torch.ones((D,), dtype=dtype, device=dev),
        "lm_head": lin(D, V),
    }


def random_int4_params(config: LLaMAConfig, seed: int = 0, device=None):
    """Stacked (L, ...) int4 parameter tree, the layout ``llama.quantize_params``
    gives; pass it through ``llama.unstack_layers`` and
    ``fused_layer.prepare_fused_params`` for generation."""
    gs = config.quant_groupsize

    def q4(gen, uniform, *shape):
        *lead, in_f, out_f = shape
        qw = torch.randint(0, 255, (*lead, in_f // 2, out_f), generator=gen, device=gen.device, dtype=torch.uint8)
        planes = (*lead, in_f // gs, out_f)
        return {"qw": qw, "qscale": uniform(planes, 0.002, 0.006), "qzero": uniform(planes, -0.04, -0.02)}

    return _random_tree(config, seed, device, q4)


def random_int8_params(config: LLaMAConfig, seed: int = 0, device=None):
    """Stacked (L, ...) int8 parameter tree, the layout ``llama.quantize_params``
    gives ((in, out) int8 ``qw``, (1, out) f32 ``qscale``); pass it through
    ``llama.unstack_layers`` for generation."""

    def q8(gen, uniform, *shape):
        *lead, in_f, out_f = shape
        qw = torch.randint(-127, 128, (*lead, in_f, out_f), generator=gen, device=gen.device, dtype=torch.int8)
        return {"qw": qw, "qscale": uniform((*lead, 1, out_f), 0.0002, 0.0004)}

    return _random_tree(config, seed, device, q8)


def random_lora_overlay(config: LLaMAConfig, seed: int = 0, device=None):
    """Stacked LoRA overlay for ``peft.lora.load_lora_state``, at
    ``config.lora``'s rank and groups: ``lora_a`` (L, D, n_en * r) from
    U[-1/sqrt(D), 1/sqrt(D)] (the JAX package's init), ``lora_b``
    (L, n_en, r, D) from N(0, 0.1)."""
    cfg = config.lora
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    L, D, n_en = config.n_layer, config.n_embd, sum(cfg.enable)
    dtype = torch_dtype(config.param_dtype)
    bound = D ** -0.5
    a = torch.empty((L, D, n_en * cfg.r), dtype=torch.float32, device=dev).uniform_(-bound, bound, generator=gen)
    b = torch.randn((L, n_en, cfg.r, D), generator=gen, device=dev) * 0.1
    return {"h": {"attn": {"c_attn": {"lora_a": a.to(dtype), "lora_b": b.to(dtype)}}}}
