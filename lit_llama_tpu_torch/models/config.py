"""Model configuration (counterpart of lit_llama_tpu/models/config.py).

Same presets (7B/13B/30B/65B), vocab padding to a multiple of 64 and SwiGLU
hidden sizing as the JAX package, so one config describes the same model in
both. Plain dataclasses: no torch import here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

from lit_llama_tpu_torch.utils.math import find_multiple


@dataclass(frozen=True)
class LoRAConfig:
    """LoRA hyperparameters: low-rank updates on the fused QKV projection,
    q and v enabled, k disabled by default."""

    r: int = 8
    alpha: float = 16.0
    dropout: float = 0.05
    enable_q: bool = True
    enable_k: bool = False
    enable_v: bool = True

    @property
    def scaling(self) -> float:
        return self.alpha / self.r

    @property
    def enable(self) -> Tuple[bool, bool, bool]:
        return (self.enable_q, self.enable_k, self.enable_v)


@dataclass(frozen=True)
class AdapterConfig:
    """LLaMA-Adapter v1/v2 hyperparameters."""

    prompt_length: int = 10
    start_layer: int = 2
    v2: bool = False


@dataclass(frozen=True)
class LLaMAConfig:
    """Hyperparameters of one LLaMA model."""

    block_size: int = 2048
    vocab_size: int = 32000
    padded_vocab_size: Optional[int] = None
    n_layer: int = 32
    n_head: int = 32
    n_embd: int = 4096
    # dtype names as strings ("float32", "bfloat16"); utils.device.torch_dtype
    # maps them to torch dtypes
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # None | "int8" | "int4"
    quantize: Optional[str] = None
    quant_groupsize: int = 128
    # None keeps the cache in compute_dtype; "int8" stores int8 rows with one
    # f32 scale per (batch row, head, position)
    kv_cache_dtype: Optional[str] = None
    # "interleaved" (Meta pairs (2i, 2i+1)) or "half" (pairs (i, i + hs/2), set
    # by ops.fused_layer.prepare_fused_params with the matching q/k permutation)
    rope_layout: str = "interleaved"
    lora: Optional[LoRAConfig] = None
    adapter: Optional[AdapterConfig] = None

    def __post_init__(self):
        if self.padded_vocab_size is None:
            object.__setattr__(
                self, "padded_vocab_size", find_multiple(self.vocab_size, 64)
            )

    @property
    def head_size(self) -> int:
        return self.n_embd // self.n_head

    @property
    def intermediate_size(self) -> int:
        """SwiGLU hidden dim."""
        return find_multiple(int(2 * 4 * self.n_embd / 3), 256)

    @classmethod
    def from_name(cls, name: str, **overrides) -> "LLaMAConfig":
        return cls(**{**llama_configs[name], **overrides})

    def replace(self, **kwargs) -> "LLaMAConfig":
        return dataclasses.replace(self, **kwargs)


llama_configs = {
    "7B": dict(n_layer=32, n_head=32, n_embd=4096),
    "13B": dict(n_layer=40, n_head=40, n_embd=5120),
    "30B": dict(n_layer=60, n_head=52, n_embd=6656),
    "65B": dict(n_layer=80, n_head=64, n_embd=8192),
}
