"""Perplexity with an Adapter v2 checkpoint on a base checkpoint (counterpart
of the JAX package's evaluate/adapter_v2.py: the same flags, plus
``--device``). ``evaluate.adapter`` with the v2 parameter set forced.

    python -m lit_llama_tpu_torch.evaluate.adapter_v2 --adapter_path out/adapter_v2/lit-llama-adapter-v2-finetuned \
        --checkpoint_path ckpt/lit-llama.pth --tokenizer_path ckpt/tokenizer.model --data_file text.txt
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional


def main(
    datasets: str = "wikitext",
    adapter_path: Path = Path("out/adapter_v2/alpaca/lit-llama-adapter-v2-finetuned"),
    checkpoint_path: Path = Path("checkpoints/lit-llama/7B/lit-llama.pth"),
    tokenizer_path: Path = Path("checkpoints/lit-llama/tokenizer.model"),
    quantize: Optional[str] = None,
    block_size: int = 2048,
    max_windows: Optional[int] = None,
    data_file: Optional[Path] = None,
    device: Optional[str] = None,
) -> None:
    """Evaluate perplexity of an Adapter-v2-finetuned model.

    Args:
        datasets: Comma-separated dataset names (wikitext, ptb, c4).
        adapter_path: Adapter v2 checkpoint (native directory from finetune.adapter_v2, or reference-format .pth).
        checkpoint_path: The base model checkpoint (.pth or native dir).
        tokenizer_path: The tokenizer path to load.
        quantize: Quantize the BASE weights at load: "llm.int8" or "gptq.int4" (the adapter weights stay dense, applied on top).
        block_size: Window length (reference: 2048).
        max_windows: Cap the number of windows (quick checks).
        data_file: Local text (or pre-tokenized uint16 .bin) file instead of downloading.
        device: cuda (the default) or cpu (the plain PyTorch path).
    """
    from lit_llama_tpu_torch.evaluate.adapter import evaluate_with_adapter

    evaluate_with_adapter(datasets, adapter_path, checkpoint_path, tokenizer_path, quantize, block_size, max_windows,
                          data_file, device, v2=True)


if __name__ == "__main__":
    from lit_llama_tpu_torch.utils.cli import cli

    cli(main)
