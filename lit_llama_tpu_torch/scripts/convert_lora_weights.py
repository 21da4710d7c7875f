"""Merge a LoRA checkpoint into its base weights (counterpart of the JAX
package's scripts/convert_lora_weights.py: the same flags, plus ``--device``).

    python -m lit_llama_tpu_torch.scripts.convert_lora_weights --lora_path out/lora/alpaca/lit-llama-lora-finetuned \
        --checkpoint_path checkpoints/lit-llama/7B/lit-llama.pth --output_path out/lora/merged.pth [--device cpu]

The base loads in f32 (``.pth`` or native directory), the LoRA checkpoint is a
native directory or a reference-format ``.pth`` (its rank comes from the
weights, ``lora_alpha`` from the flag); the update is folded into ``c_attn``
on the device and the merged weights are written as a lit-llama ``.pth``
(``output_path`` ending in ``.pth``) or as a native directory with the
config in its metadata. A checkpoint that is not LoRA raises ``ValueError``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional


def main(
    lora_path: Path = Path("out/lora/alpaca/lit-llama-lora-finetuned"),
    checkpoint_path: Path = Path("checkpoints/lit-llama/7B/lit-llama.pth"),
    output_path: Path = Path("out/lora/alpaca/lit-llama-lora-merged.pth"),
    lora_alpha: float = 16.0,
    device: Optional[str] = None,
) -> None:
    """Merge a LoRA checkpoint into base weights and save a plain checkpoint.

    Args:
        lora_path: LoRA checkpoint directory (from finetune.lora) or reference-format .pth.
        checkpoint_path: The base model checkpoint (.pth or native dir).
        output_path: Output path (.pth writes torch format; else a native dir).
        lora_alpha: LoRA alpha used at finetune time (rank inferred from weights).
        device: cuda (the default) or cpu.
    """
    import torch

    from lit_llama_tpu_torch.models.config import LoRAConfig
    from lit_llama_tpu_torch.peft import lora as lora_mod
    from lit_llama_tpu_torch.training.loop import config_meta
    from lit_llama_tpu_torch.utils import checkpoint as ckpt
    from lit_llama_tpu_torch.utils import convert
    from lit_llama_tpu_torch.utils.device import resolve_device
    from lit_llama_tpu_torch.utils.loader import load_model, load_peft_checkpoint

    dev = resolve_device(device)
    params, config = load_model(Path(checkpoint_path), dtype="float32", device=dev)
    kind, lora_params, info = load_peft_checkpoint(Path(lora_path), config, device=dev)
    if kind != "lora":
        raise ValueError(f"{lora_path} is a {kind} checkpoint, not LoRA")
    config = config.replace(lora=LoRAConfig(r=info["r"], alpha=lora_alpha, dropout=0.0))
    merged = lora_mod.merge_lora(lora_mod.load_lora_state(params, lora_params), config)
    config = config.replace(lora=None)

    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    if output_path.suffix == ".pth":
        torch.save(convert.pytree_to_lit(merged, config), output_path)
    else:
        ckpt.save_checkpoint(output_path, {"params": merged}, metadata={"config": config_meta(config)})
    print(f"merged checkpoint written to {output_path}")


if __name__ == "__main__":
    from lit_llama_tpu_torch.utils.cli import cli

    cli(main)
