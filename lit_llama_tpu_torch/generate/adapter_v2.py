"""Generate with an Adapter v2 checkpoint on a base checkpoint (counterpart of
the JAX package's generate/adapter_v2.py: the same flags, plus ``--device``).

    python -m lit_llama_tpu_torch.generate.adapter_v2 --adapter_path out/adapter_v2/lit-llama-adapter-v2-finetuned \
        --checkpoint_path ckpt/lit-llama.pth --tokenizer_path ckpt/tokenizer.model [--device cpu]

``generate.adapter``'s flow with v2's parameter set (a bias and a scale on
every linear) added before the checkpoint is overlaid.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from lit_llama_tpu_torch.generate.adapter import generate_with_adapter


def main(
    prompt: str = "What food do lamas eat?",
    input: str = "",
    adapter_path: Path = Path("out/adapter_v2/alpaca/lit-llama-adapter-v2-finetuned"),
    checkpoint_path: Path = Path("checkpoints/lit-llama/7B/lit-llama.pth"),
    tokenizer_path: Path = Path("checkpoints/lit-llama/tokenizer.model"),
    quantize: Optional[str] = None,
    max_new_tokens: int = 100,
    top_k: int = 200,
    temperature: float = 0.8,
    seed: int = 1234,
    device: Optional[str] = None,
) -> None:
    """Generates a response based on a given instruction with an Adapter v2 overlay.

    Args:
        prompt: The instruction string.
        input: Optional input for the instruction template.
        adapter_path: Adapter v2 checkpoint (native directory from finetune.adapter_v2, or reference-format .pth).
        checkpoint_path: The base model checkpoint (.pth or native dir).
        tokenizer_path: The tokenizer path to load.
        quantize: Quantize the BASE weights at load: "llm.int8" or "gptq.int4" (the adapter stays dense on top).
        max_new_tokens: The number of generation steps to take.
        top_k: The number of top most probable tokens to consider in the sampling process.
        temperature: A value controlling the randomness of the sampling process (0: greedy).
        seed: Random seed for sampling.
        device: cuda (the default) or cpu (the plain PyTorch path).
    """
    generate_with_adapter(prompt, input, adapter_path, checkpoint_path, tokenizer_path, quantize, max_new_tokens,
                          top_k, temperature, seed, device, v2=True)


if __name__ == "__main__":
    from lit_llama_tpu_torch.utils.cli import cli

    cli(main)
