"""Perplexity with an Adapter v1 (or v2) checkpoint on a base checkpoint
(counterpart of the JAX package's evaluate/adapter.py: the same flags, plus
``--device``).

    python -m lit_llama_tpu_torch.evaluate.adapter --adapter_path out/adapter/lit-llama-adapter-finetuned \
        --checkpoint_path ckpt/lit-llama.pth --tokenizer_path ckpt/tokenizer.model --data_file text.txt

The adapter checkpoint is a native directory (what ``finetune.adapter`` and
``finetune.adapter_v2`` save) or a reference-format ``.pth``; its prompt
length, start layer and version come from the weights, as in
``generate.adapter``. ``--quantize`` quantizes the base only; the adapter
leaves stay dense on top. The protocol is ``evaluate.full``'s.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional


def evaluate_with_adapter(datasets: str, adapter_path: Path, checkpoint_path: Path, tokenizer_path: Path,
                          quantize: Optional[str], block_size: int, max_windows: Optional[int],
                          data_file: Optional[Path], device: Optional[str], v2: bool) -> float:
    """``main``'s work; ``v2`` forces the v2 parameter set (the
    ``evaluate.adapter_v2`` entry point), else the checkpoint decides."""
    from lit_llama_tpu_torch.evaluate.full import evaluate
    from lit_llama_tpu_torch.models.config import AdapterConfig
    from lit_llama_tpu_torch.models.llama import unstack_layers
    from lit_llama_tpu_torch.peft import adapter as adapter_mod
    from lit_llama_tpu_torch.utils.device import resolve_device
    from lit_llama_tpu_torch.utils.loader import load_model, load_peft_checkpoint

    dev = resolve_device(device)
    params, config = load_model(Path(checkpoint_path), quantize, device=dev)
    kind, state, info = load_peft_checkpoint(Path(adapter_path), config, device=dev)
    if kind != "adapter":
        raise ValueError(f"{adapter_path} is a {kind} checkpoint, not adapter")
    config = config.replace(adapter=AdapterConfig(v2=v2 or info["v2"], prompt_length=info["prompt_length"],
                                                  start_layer=info["start_layer"]))
    params = adapter_mod.add_adapter_params(params, config)
    params = unstack_layers(adapter_mod.load_adapter_state(params, state))
    return evaluate(params, config, tokenizer_path, datasets, data_file, block_size, max_windows, dev)


def main(
    datasets: str = "wikitext",
    adapter_path: Path = Path("out/adapter/alpaca/lit-llama-adapter-finetuned"),
    checkpoint_path: Path = Path("checkpoints/lit-llama/7B/lit-llama.pth"),
    tokenizer_path: Path = Path("checkpoints/lit-llama/tokenizer.model"),
    quantize: Optional[str] = None,
    block_size: int = 2048,
    max_windows: Optional[int] = None,
    data_file: Optional[Path] = None,
    device: Optional[str] = None,
) -> None:
    """Evaluate perplexity of an Adapter-finetuned model.

    Args:
        datasets: Comma-separated dataset names (wikitext, ptb, c4).
        adapter_path: Adapter checkpoint (native directory from finetune.adapter, or reference-format .pth).
        checkpoint_path: The base model checkpoint (.pth or native dir).
        tokenizer_path: The tokenizer path to load.
        quantize: Quantize the BASE weights at load: "llm.int8" or "gptq.int4" (the adapter weights stay dense, applied on top).
        block_size: Window length (reference: 2048).
        max_windows: Cap the number of windows (quick checks).
        data_file: Local text (or pre-tokenized uint16 .bin) file instead of downloading.
        device: cuda (the default) or cpu (the plain PyTorch path).
    """
    evaluate_with_adapter(datasets, adapter_path, checkpoint_path, tokenizer_path, quantize, block_size, max_windows,
                          data_file, device, v2=False)


if __name__ == "__main__":
    from lit_llama_tpu_torch.utils.cli import cli

    cli(main)
