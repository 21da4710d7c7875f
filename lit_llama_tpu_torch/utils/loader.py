"""Model loading for the entry points (counterpart of
lit_llama_tpu/utils/loader.py).

Two checkpoint families:
* a lit-llama ``.pth``, read with ``torch.load(mmap=True)`` so a 7B load
  pages the file in tensor by tensor instead of holding a second copy in
  host memory; the config comes from a ``config.json`` beside it or from the
  embedding width;
* the native manifest directory (``utils.checkpoint``), as either package
  writes it.
Round-to-nearest weight quantization may be applied at load.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from lit_llama_tpu_torch.models import llama
from lit_llama_tpu_torch.models.config import LLaMAConfig
from lit_llama_tpu_torch.utils import checkpoint as ckpt
from lit_llama_tpu_torch.utils import convert
from lit_llama_tpu_torch.utils.device import resolve_device

_CONFIG_KEYS = ("block_size", "vocab_size", "padded_vocab_size", "n_layer", "n_head", "n_embd", "quantize",
                "quant_groupsize")
_QUANT_MODES = {"llm.int8": "int8", "gptq.int4": "int4", "int8": "int8", "int4": "int4"}


def _mode(quantize: Optional[str]) -> Optional[str]:
    if quantize is None:
        return None
    if quantize not in _QUANT_MODES:
        raise ValueError(f"unknown quantize mode {quantize!r}: use one of {sorted(_QUANT_MODES)}")
    return _QUANT_MODES[quantize]


def _load_pth(path: Path) -> Dict[str, torch.Tensor]:
    return torch.load(path, mmap=True, weights_only=True, map_location="cpu")


def load_model(
    checkpoint_path: Path,
    quantize: Optional[str] = None,
    model_size: Optional[str] = None,
    dtype: Optional[str] = None,
    device=None,
) -> Tuple[Dict[str, Any], LLaMAConfig]:
    """(params, config) from a lit-llama ``.pth`` or a native checkpoint
    directory, the params stacked on ``device`` (the card when None).

    ``quantize``: None, "llm.int8" / "int8" or "gptq.int4" / "int4":
    round-to-nearest at load (a GPTQ output directory is loaded as it is).
    ``dtype``: the param and compute dtype, bf16 on the card and f32 on the
    CPU when None. A native directory's leaves keep their stored dtypes, as
    in the JAX package."""
    dev = resolve_device(device)
    if dtype is None:
        dtype = "bfloat16" if dev.type == "cuda" else "float32"
    mode = _mode(quantize)
    checkpoint_path = Path(checkpoint_path)
    if checkpoint_path.is_dir():
        meta = ckpt.load_metadata(checkpoint_path)
        if "config" in meta:
            config = LLaMAConfig(**{k: v for k, v in meta["config"].items() if k in _CONFIG_KEYS})
        else:
            config = LLaMAConfig.from_name(model_size or "7B")
        config = config.replace(param_dtype=dtype, compute_dtype=dtype)
        tree = ckpt.load_checkpoint(checkpoint_path, transform=lambda name, t: t.to(dev))
        params = tree["params"] if "params" in tree else tree
        if mode is not None:
            if config.quantize is None:  # a dense native checkpoint: quantize at load
                config = _clamp_groupsize(config.replace(quantize=mode))
                params = llama.quantize_params(params, config)
            elif config.quantize != mode:
                raise ValueError(f"{checkpoint_path} is already quantized as {config.quantize}; "
                                 f"cannot re-quantize to {mode}")
        return params, config

    sd = _load_pth(checkpoint_path)
    config_json = checkpoint_path.parent / "config.json"
    if model_size is None and config_json.is_file():
        kw = {k: v for k, v in json.loads(config_json.read_text()).items() if k in _CONFIG_KEYS}
        config = LLaMAConfig(**kw, param_dtype=dtype, compute_dtype=dtype)
    else:
        name = model_size or convert.llama_model_lookup(sd)
        config = LLaMAConfig.from_name(name, param_dtype=dtype, compute_dtype=dtype)
    if mode is not None:
        config = config.replace(quantize=mode)
    params = convert.lit_to_pytree(sd, config, dtype=dtype, device=dev)
    del sd
    if config.quantize is not None:
        config = _clamp_groupsize(config)
        params = llama.quantize_params(params, config)
    return params, config


def _clamp_groupsize(config: LLaMAConfig) -> LLaMAConfig:
    """The largest int4 group size up to the configured one that every
    quantized linear's input width (n_embd, the intermediate size) divides
    twice over (half-split nibble planes): small models cannot take 128."""
    if config.quantize != "int4":
        return config
    widths = (config.n_embd, config.intermediate_size)
    gs = config.quant_groupsize
    while gs > 1 and any(w % (2 * gs) for w in widths):
        gs //= 2
    return config.replace(quant_groupsize=gs) if gs != config.quant_groupsize else config


def load_peft_checkpoint(path: Path, config: LLaMAConfig, device=None) -> Tuple[str, Dict[str, Any], Dict[str, Any]]:
    """A LoRA or adapter checkpoint, as a native directory (the PEFT sub-tree
    that finetuning saves) or a reference-format ``.pth`` state dict.
    Returns ``(kind, overlay, info)`` with the overlay on ``device`` (the card
    when None): ("lora", overlay, {"r": r}) for ``peft.lora.load_lora_state``,
    the rank from ``lora_b``; ("adapter", overlay, {"prompt_length",
    "start_layer", "v2"}) for ``peft.adapter.load_adapter_state``. A native
    adapter directory without ``adapter_active`` (finetuning saves only the
    trainable leaves) has start layer 0, as in the JAX package."""
    dev = resolve_device(device)
    path = Path(path)
    if path.is_dir():
        tree = ckpt.load_checkpoint(path, transform=lambda name, t: t.to(dev))
        overlay = tree["params"] if "params" in tree else tree
        h = overlay.get("h", {})
        if "lora_a" in h.get("attn", {}).get("c_attn", {}):
            return "lora", overlay, {"r": int(h["attn"]["c_attn"]["lora_b"].shape[-2])}
        if "adapter_wte" in h:
            # the first active layer (argmax of no active layer is 0, as in the JAX package)
            start_layer = int(torch.argmax((h["adapter_active"][:, 0] != 0).int())) if "adapter_active" in h else 0
            return "adapter", overlay, {"prompt_length": int(h["adapter_wte"].shape[1]), "start_layer": start_layer,
                                        "v2": "av2_bias" in h.get("attn", {}).get("c_attn", {})}
        raise ValueError(f"{path} is not a LoRA or adapter checkpoint")
    sd = _load_pth(path)
    kind = convert.peft_sd_kind(sd)
    if kind == "lora":
        overlay, r = convert.lora_sd_to_overlay(sd, config, device=dev)
        return "lora", overlay, {"r": r}
    if kind == "adapter":
        overlay, aT, start_layer, v2 = convert.adapter_sd_to_overlay(sd, config, device=dev)
        return "adapter", overlay, {"prompt_length": aT, "start_layer": start_layer, "v2": v2}
    raise ValueError(f"{path} holds neither LoRA nor adapter entries")
