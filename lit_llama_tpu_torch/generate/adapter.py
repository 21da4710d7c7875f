"""Generate with an Adapter v1 (or v2) checkpoint on a base checkpoint
(counterpart of the JAX package's generate/adapter.py: the same flags, plus
``--device``).

    python -m lit_llama_tpu_torch.generate.adapter --adapter_path out/adapter/lit-llama-adapter-finetuned \
        --checkpoint_path ckpt/lit-llama.pth --tokenizer_path ckpt/tokenizer.model [--device cpu]

The adapter checkpoint is a native directory (what ``finetune.adapter`` and
``finetune.adapter_v2`` save) or a reference-format ``.pth`` (old
single-gate checkpoints included); its prompt length, start layer and
version come from the weights. The base weights may be quantized at load;
the adapter leaves stay dense on top, and the model decodes per op (no fused
kernel has the prefix term). The instruction goes through the alpaca prompt
template; the text after ``### Response:`` is printed, the time and the
generated token ids on stderr.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Optional


def generate_with_adapter(prompt: str, input: str, adapter_path: Path, checkpoint_path: Path, tokenizer_path: Path,
                          quantize: Optional[str], max_new_tokens: int, top_k: int, temperature: float, seed: int,
                          device: Optional[str], v2: bool) -> None:
    """``main``'s work; ``v2`` forces the v2 parameter set (the
    ``generate.adapter_v2`` entry point), else the checkpoint decides."""
    import torch

    from lit_llama_tpu_torch.data import sft
    from lit_llama_tpu_torch.data.tokenizer import Tokenizer
    from lit_llama_tpu_torch.models.config import AdapterConfig
    from lit_llama_tpu_torch.models.generate import generate
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

    tokenizer = Tokenizer(tokenizer_path)
    encoded = tokenizer.encode(sft.generate_prompt({"instruction": prompt, "input": input}), bos=True, eos=False)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    t0 = time.perf_counter()
    y = generate(params, encoded, max_new_tokens, config=config, temperature=temperature, top_k=top_k,
                 eos_id=tokenizer.eos_id, generator=generator, device=dev)
    t = time.perf_counter() - t0
    print(tokenizer.decode(y).split("### Response:")[-1].strip())
    print(f"Time for inference: {t:.02f} sec total, {(len(y) - len(encoded)) / t:.02f} tokens/sec", file=sys.stderr)
    print(f"Token ids: {y.tolist()}", file=sys.stderr)


def main(
    prompt: str = "What food do lamas eat?",
    input: str = "",
    adapter_path: Path = Path("out/adapter/alpaca/lit-llama-adapter-finetuned"),
    checkpoint_path: Path = Path("checkpoints/lit-llama/7B/lit-llama.pth"),
    tokenizer_path: Path = Path("checkpoints/lit-llama/tokenizer.model"),
    quantize: Optional[str] = None,
    max_new_tokens: int = 100,
    top_k: int = 200,
    temperature: float = 0.8,
    seed: int = 1234,
    device: Optional[str] = None,
) -> None:
    """Generates a response based on a given instruction with an Adapter overlay.

    Args:
        prompt: The instruction string.
        input: Optional input for the instruction template.
        adapter_path: Adapter checkpoint (native directory from finetune.adapter, or reference-format .pth).
        checkpoint_path: The base model checkpoint (.pth or native dir).
        tokenizer_path: The tokenizer path to load.
        quantize: Quantize the BASE weights at load: "llm.int8" or "gptq.int4" (round-to-nearest).
        max_new_tokens: The number of generation steps to take.
        top_k: The number of top most probable tokens to consider in the sampling process.
        temperature: A value controlling the randomness of the sampling process (0: greedy).
        seed: Random seed for sampling.
        device: cuda (the default) or cpu (the plain PyTorch path).
    """
    generate_with_adapter(prompt, input, adapter_path, checkpoint_path, tokenizer_path, quantize, max_new_tokens,
                          top_k, temperature, seed, device, v2=False)


if __name__ == "__main__":
    from lit_llama_tpu_torch.utils.cli import cli

    cli(main)
