"""Generate with a LoRA overlay on a base checkpoint (counterpart of the JAX
package's generate/lora.py: the same flags, plus ``--device``).

    python -m lit_llama_tpu_torch.generate.lora --lora_path out/lora/lit-llama-lora-finetuned \
        --checkpoint_path ckpt/lit-llama.pth --tokenizer_path ckpt/tokenizer.model \
        [--quantize gptq.int4] [--device cpu]

The LoRA checkpoint is a native directory or a reference-format ``.pth``;
its rank comes from the weights, ``lora_alpha`` from the flag. With
``--quantize gptq.int4`` the base weights are int4 and the update stays
dense on top: the fused step takes it as K1's LoRA operand on the card. The
instruction goes through the alpaca prompt template; the text after
``### Response:`` is printed, the time and the generated token ids on
stderr. One card: ``model_parallel`` other than 1 raises.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Optional


def main(
    prompt: str = "What food do lamas eat?",
    input: str = "",
    lora_path: Path = Path("out/lora/alpaca/lit-llama-lora-finetuned"),
    checkpoint_path: Path = Path("checkpoints/lit-llama/7B/lit-llama.pth"),
    tokenizer_path: Path = Path("checkpoints/lit-llama/tokenizer.model"),
    lora_alpha: float = 16.0,
    quantize: Optional[str] = None,
    max_new_tokens: int = 100,
    top_k: int = 200,
    temperature: float = 0.8,
    seed: int = 1234,
    model_parallel: int = 1,
    device: Optional[str] = None,
) -> None:
    """Generates a response based on a given instruction with a LoRA overlay.

    Args:
        prompt: The instruction string.
        input: Optional input for the instruction template.
        lora_path: LoRA checkpoint (native directory or reference-format .pth).
        checkpoint_path: The base model checkpoint (.pth or native dir).
        tokenizer_path: The tokenizer path to load.
        lora_alpha: LoRA alpha used at finetune time (rank is inferred from the weights).
        quantize: Quantize the BASE weights at load: "llm.int8" or "gptq.int4" (round-to-nearest).
        max_new_tokens: The number of generation steps to take.
        top_k: The number of top most probable tokens to consider in the sampling process.
        temperature: A value controlling the randomness of the sampling process (0: greedy).
        seed: Random seed for sampling.
        model_parallel: Tensor-parallel degree; the port runs on one card (1).
        device: cuda (the default) or cpu (the plain PyTorch path).
    """
    if model_parallel != 1:
        raise NotImplementedError("model_parallel > 1: multi-device generation is a later slice of the port")
    import torch

    from lit_llama_tpu_torch.data import sft
    from lit_llama_tpu_torch.data.tokenizer import Tokenizer
    from lit_llama_tpu_torch.models.config import LoRAConfig
    from lit_llama_tpu_torch.models.generate import generate
    from lit_llama_tpu_torch.models.llama import unstack_layers
    from lit_llama_tpu_torch.ops.fused_layer import maybe_prepare_fused
    from lit_llama_tpu_torch.peft import lora as lora_mod
    from lit_llama_tpu_torch.utils.device import resolve_device
    from lit_llama_tpu_torch.utils.loader import load_model, load_peft_checkpoint

    dev = resolve_device(device)
    params, config = load_model(Path(checkpoint_path), quantize, device=dev)
    kind, lora_params, info = load_peft_checkpoint(Path(lora_path), config, device=dev)
    if kind != "lora":
        raise ValueError(f"{lora_path} is a {kind} checkpoint, not LoRA")
    config = config.replace(lora=LoRAConfig(r=info["r"], alpha=lora_alpha, dropout=0.0))
    params = lora_mod.load_lora_state(params, lora_params)
    params, config = maybe_prepare_fused(unstack_layers(params), config)

    tokenizer = Tokenizer(tokenizer_path)
    full_prompt = sft.generate_prompt({"instruction": prompt, "input": input})
    encoded = tokenizer.encode(full_prompt, bos=True, eos=False)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)

    t0 = time.perf_counter()
    y = generate(params, encoded, max_new_tokens, config=config, temperature=temperature, top_k=top_k,
                 eos_id=tokenizer.eos_id, generator=generator, device=dev)
    t = time.perf_counter() - t0
    output = tokenizer.decode(y).split("### Response:")[-1].strip()
    print(output)
    print(f"Time for inference: {t:.02f} sec total, {(len(y) - len(encoded)) / t:.02f} tokens/sec", file=sys.stderr)
    print(f"Token ids: {y.tolist()}", file=sys.stderr)


if __name__ == "__main__":
    from lit_llama_tpu_torch.utils.cli import cli

    cli(main)
