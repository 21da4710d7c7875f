"""Perplexity with a LoRA overlay on a base checkpoint (counterpart of the JAX
package's evaluate/lora.py: the same flags, plus ``--device``).

    python -m lit_llama_tpu_torch.evaluate.lora --lora_path out/lora/lit-llama-lora-finetuned \
        --checkpoint_path ckpt/lit-llama.pth --tokenizer_path ckpt/tokenizer.model --data_file text.txt

The LoRA checkpoint is a native directory or a reference-format ``.pth``;
its rank comes from ``lora_b``, ``lora_alpha`` from the flag. ``--quantize``
quantizes the base only; the update stays dense on top. The protocol is
``evaluate.full``'s.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional


def main(
    datasets: str = "wikitext",
    lora_path: Path = Path("out/lora/alpaca/lit-llama-lora-finetuned"),
    checkpoint_path: Path = Path("checkpoints/lit-llama/7B/lit-llama.pth"),
    tokenizer_path: Path = Path("checkpoints/lit-llama/tokenizer.model"),
    lora_alpha: float = 16.0,
    quantize: Optional[str] = None,
    block_size: int = 2048,
    max_windows: Optional[int] = None,
    data_file: Optional[Path] = None,
    device: Optional[str] = None,
) -> None:
    """Evaluate perplexity of a LoRA-finetuned model.

    Args:
        datasets: Comma-separated dataset names (wikitext, ptb, c4).
        lora_path: LoRA checkpoint (native directory from finetune.lora, or reference-format .pth).
        checkpoint_path: The base model checkpoint (.pth or native dir).
        tokenizer_path: The tokenizer path to load.
        lora_alpha: LoRA alpha used at finetune time.
        quantize: Quantize the BASE weights at load: "llm.int8" or "gptq.int4" (the LoRA update stays dense, applied on top).
        block_size: Window length (reference: 2048).
        max_windows: Cap the number of windows (quick checks).
        data_file: Local text (or pre-tokenized uint16 .bin) file instead of downloading.
        device: cuda (the default) or cpu (the plain PyTorch path).
    """
    from lit_llama_tpu_torch.evaluate.full import evaluate
    from lit_llama_tpu_torch.models.config import LoRAConfig
    from lit_llama_tpu_torch.models.llama import unstack_layers
    from lit_llama_tpu_torch.peft import lora as lora_mod
    from lit_llama_tpu_torch.utils.device import resolve_device
    from lit_llama_tpu_torch.utils.loader import load_model, load_peft_checkpoint

    dev = resolve_device(device)
    params, config = load_model(Path(checkpoint_path), quantize, device=dev)
    kind, lora_params, info = load_peft_checkpoint(Path(lora_path), config, device=dev)
    if kind != "lora":
        raise ValueError(f"{lora_path} is a {kind} checkpoint, not LoRA")
    config = config.replace(lora=LoRAConfig(r=info["r"], alpha=lora_alpha, dropout=0.0))
    params = unstack_layers(lora_mod.load_lora_state(params, lora_params))
    evaluate(params, config, tokenizer_path, datasets, data_file, block_size, max_windows, dev)


if __name__ == "__main__":
    from lit_llama_tpu_torch.utils.cli import cli

    cli(main)
