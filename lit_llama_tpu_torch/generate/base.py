"""Generate text from a LLaMA checkpoint (counterpart of the JAX package's
root generate.py: the same flags, plus ``--device``).

    python -m lit_llama_tpu_torch.generate.base --checkpoint_path ckpt/lit-llama.pth \
        --tokenizer_path ckpt/tokenizer.model [--quantize gptq.int4] [--device cpu]

A lit-llama ``.pth`` (with a ``config.json`` beside it, or a preset found
from its width) or a native checkpoint directory; round-to-nearest int8 or
int4 at load. Int4 weights that the fused step takes are prepared for it (K1
and K2 on the card); anything else decodes per op. Prints each sample, and
its time and the generated token ids on stderr.
"""

from __future__ import annotations

import sys
import time
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
    quantize: Optional[str] = None,
    model_size: Optional[str] = None,
    kv_cache_dtype: Optional[str] = None,
    seed: int = 1234,
    device: Optional[str] = None,
) -> None:
    """Generates text samples based on a pre-trained LLaMA model and tokenizer.

    Args:
        prompt: The prompt string to use for generating the samples.
        num_samples: The number of text samples to generate.
        max_new_tokens: The number of generation steps to take.
        top_k: The number of top most probable tokens to consider in the sampling process.
        temperature: A value controlling the randomness of the sampling process (0: greedy).
        checkpoint_path: The checkpoint path to load (lit-llama .pth or native dir).
        tokenizer_path: The tokenizer path to load.
        quantize: Whether to quantize the model: "llm.int8" (8-bit weight-only) or "gptq.int4" (4-bit round-to-nearest).
        model_size: Override the model preset (7B/13B/30B/65B) if it cannot be inferred.
        kv_cache_dtype: KV-cache storage: None (compute dtype) or "int8".
        seed: Random seed for sampling.
        device: cuda (the default) or cpu (the plain PyTorch path).
    """
    from lit_llama_tpu_torch.data.tokenizer import Tokenizer

    tokenizer_path = Path(tokenizer_path)
    if not tokenizer_path.is_file():
        raise FileNotFoundError(tokenizer_path)
    tokenizer = Tokenizer(tokenizer_path)
    load_and_sample(checkpoint_path, tokenizer, tokenizer.encode(prompt, bos=True, eos=False), None, num_samples,
                    max_new_tokens, top_k, temperature, quantize, model_size, kv_cache_dtype, seed, device)


def load_and_sample(checkpoint_path, tokenizer, encoded, eos_id, num_samples, max_new_tokens, top_k, temperature,
                    quantize, model_size, kv_cache_dtype, seed, device) -> None:
    """Load the checkpoint (int4 prepared for the fused step where it takes
    it), then print ``num_samples`` samples that continue the token ids
    ``encoded``, each stopping at ``eos_id`` (None: never), with its time
    and token ids on stderr, and the peak memory."""
    import torch

    from lit_llama_tpu_torch.models.generate import generate
    from lit_llama_tpu_torch.models.llama import unstack_layers
    from lit_llama_tpu_torch.ops.fused_layer import maybe_prepare_fused
    from lit_llama_tpu_torch.utils.device import resolve_device
    from lit_llama_tpu_torch.utils.loader import load_model
    from lit_llama_tpu_torch.utils.memory import print_peak_memory

    checkpoint_path = Path(checkpoint_path)
    if not checkpoint_path.exists():
        raise FileNotFoundError(checkpoint_path)
    dev = resolve_device(device)

    print("Loading model ...", file=sys.stderr)
    t0 = time.time()
    params, config = load_model(checkpoint_path, quantize, model_size, device=dev)
    if kv_cache_dtype:
        config = config.replace(kv_cache_dtype=kv_cache_dtype)
    params, config = maybe_prepare_fused(unstack_layers(params), config)
    print(f"Time to load model: {time.time() - t0:.02f} seconds.", file=sys.stderr)

    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    for i in range(num_samples):
        t0 = time.perf_counter()
        y = generate(params, encoded, max_new_tokens, config=config, temperature=temperature, top_k=top_k,
                     eos_id=eos_id, generator=generator, device=dev)
        t = time.perf_counter() - t0
        print(tokenizer.decode(y))
        n_new = len(y) - len(encoded)
        print(f"Time for inference {i + 1}: {t:.02f} sec total, {n_new / t:.02f} tokens/sec", file=sys.stderr)
        print(f"Token ids {i + 1}: {y.tolist()}", file=sys.stderr)
    print_peak_memory(dev)


if __name__ == "__main__":
    from lit_llama_tpu_torch.utils.cli import cli

    cli(main)
