"""Random int4 weights built directly at packed shapes (counterpart of
``random_int4_params`` in the JAX package's bench.py).

Decode speed does not depend on weight values, so the chip check runs the
full model on these: uniform random bytes for the packed nibbles, a scale
drawn from U[0.002, 0.006] and a zero from U[-0.04, -0.02] for each (group,
column), so weights spread about zero and a kernel that reads the wrong
group, nibble plane or column of the scales disagrees with its plain
version; normal(0, 0.02) embedding, unit norms. Built from a seeded
``torch.Generator`` on the target device; dense 7B weights are never
materialised.
"""

from __future__ import annotations

import torch

from lit_llama_tpu_torch.models.config import LLaMAConfig
from lit_llama_tpu_torch.utils.device import resolve_device, torch_dtype


def random_int4_params(config: LLaMAConfig, seed: int = 0, device=None):
    """Stacked (L, ...) int4 parameter tree, the layout ``llama.quantize_params``
    gives; pass it through ``llama.unstack_layers`` and
    ``fused_layer.prepare_fused_params`` for generation."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    D, V, I, L = config.n_embd, config.padded_vocab_size, config.intermediate_size, config.n_layer
    gs = config.quant_groupsize
    dtype = torch_dtype(config.param_dtype)

    def dense(*shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dtype)

    def uniform(shape, lo, hi):
        return torch.empty(shape, dtype=torch.float32, device=dev).uniform_(lo, hi, generator=gen)

    def q4(*shape):
        *lead, in_f, out_f = shape
        qw = torch.randint(0, 255, (*lead, in_f // 2, out_f), generator=gen, device=dev, dtype=torch.uint8)
        planes = (*lead, in_f // gs, out_f)
        return {"qw": qw, "qscale": uniform(planes, 0.002, 0.006), "qzero": uniform(planes, -0.04, -0.02)}

    return {
        "wte": dense(V, D),
        "h": {
            "rms_1": torch.ones((L, D), dtype=dtype, device=dev),
            "attn": {"c_attn": q4(L, D, 3 * D), "c_proj": q4(L, D, D)},
            "rms_2": torch.ones((L, D), dtype=dtype, device=dev),
            "mlp": {"c_fc1": q4(L, D, I), "c_fc2": q4(L, D, I), "c_proj": q4(L, I, D)},
        },
        "ln_f": torch.ones((D,), dtype=dtype, device=dev),
        "lm_head": q4(D, V),
    }
