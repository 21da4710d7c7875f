"""Generate from a fully finetuned or a GPTQ checkpoint with the alpaca
prompt template (counterpart of the JAX package's generate/full.py: the same
flags, plus ``--device``).

    python -m lit_llama_tpu_torch.generate.full --checkpoint_path out/full/lit-llama-full-finetuned \
        --tokenizer_path ckpt/tokenizer.model [--quantize llm.int8] [--device cpu]

A lit-llama ``.pth`` or a native directory (``finetune.full``'s output, or
``quantize.gptq``'s, which loads as it is); round-to-nearest int8 or int4
at load. Int4 weights that the fused step takes are prepared for it (K1 and
K2 on the card); anything else decodes per op (K5, and K6 under int8).
Prints each sample, and its time and the generated token ids on stderr.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional


def main(
    prompt: str = "Hello, my name is",
    num_samples: int = 1,
    max_new_tokens: int = 50,
    top_k: int = 200,
    temperature: float = 0.8,
    checkpoint_path: Path = Path("checkpoints/lit-llama/7B/lit-llama.pth"),
    tokenizer_path: Path = Path("checkpoints/lit-llama/tokenizer.model"),
    model_size: Optional[str] = None,
    quantize: Optional[str] = None,
    instruction_tuning: bool = True,
    seed: int = 1234,
    device: Optional[str] = None,
) -> None:
    """Generates text samples with the alpaca instruction template.

    Args:
        prompt: The prompt/instruction string.
        num_samples: The number of text samples to generate.
        max_new_tokens: The number of generation steps to take.
        top_k: The number of top most probable tokens to consider in the sampling process.
        temperature: A value controlling the randomness of the sampling process (0: greedy).
        checkpoint_path: The checkpoint path to load (.pth or native dir).
        tokenizer_path: The tokenizer path to load.
        model_size: Override the model preset if it cannot be inferred.
        quantize: Whether to quantize the model: "llm.int8" or "gptq.int4".
        instruction_tuning: Wrap the prompt in the alpaca instruction template.
        seed: Random seed for sampling.
        device: cuda (the default) or cpu (the plain PyTorch path).
    """
    from lit_llama_tpu_torch.data import sft
    from lit_llama_tpu_torch.data.tokenizer import Tokenizer
    from lit_llama_tpu_torch.generate.base import load_and_sample

    tokenizer = Tokenizer(tokenizer_path)
    if instruction_tuning:
        prompt = sft.generate_prompt({"instruction": prompt, "input": ""})
    load_and_sample(checkpoint_path, tokenizer, tokenizer.encode(prompt, bos=True, eos=False), tokenizer.eos_id,
                    num_samples, max_new_tokens, top_k, temperature, quantize, model_size, None, seed, device)


if __name__ == "__main__":
    from lit_llama_tpu_torch.utils.cli import cli

    cli(main)
