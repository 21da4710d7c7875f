"""Convert HuggingFace LLaMA weights to a lit-llama ``.pth`` (counterpart of
the JAX package's scripts/convert_hf_checkpoint.py: the same flags).

    python -m lit_llama_tpu_torch.scripts.convert_hf_checkpoint --checkpoint_dir checkpoints/hf-llama/7B \
        --output_dir checkpoints/lit-llama/7B [--model_size 7B] [--verify true]

Reads every ``*.bin`` under ``checkpoint_dir``, un-permutes HF's rotary q/k
layout, fuses q / k / v into ``c_attn`` and writes
``output_dir/lit-llama.pth``; the weights keep their stored dtype (``dtype``
is accepted and unused, as in the JAX script). ``--verify`` compares the
converted model's logits on the CPU in f32 with
``transformers.LlamaForCausalLM`` on the same files (atol / rtol 2e-3). Host
work only: no ``--device``.
"""

from __future__ import annotations

from pathlib import Path

from lit_llama_tpu_torch.utils.cli import host_only


@host_only
def convert_hf_checkpoint(
    output_dir: Path = Path("checkpoints/lit-llama/7B"),
    checkpoint_dir: Path = Path("checkpoints/hf-llama/7B"),
    model_size: str = "7B",
    dtype: str = "float32",
    verify: bool = False,
) -> None:
    """Convert HF pytorch_model*.bin files into a single lit-llama.pth.

    Args:
        output_dir: Output directory (writes lit-llama.pth).
        checkpoint_dir: Directory with HF pytorch_model*.bin files.
        model_size: Config preset (7B/13B/30B/65B).
        dtype: Output dtype (accepted and unused: the weights keep their stored dtype).
        verify: Compare the converted model's logits with transformers' on the CPU.
    """
    from lit_llama_tpu_torch.models.config import LLaMAConfig

    config = LLaMAConfig.from_name(model_size)
    out = convert_dir(Path(checkpoint_dir), Path(output_dir), config)
    print(f"written {out}")
    if verify:
        verify_logits(out, Path(checkpoint_dir), config)
        print("verify: logits match transformers")


def convert_dir(checkpoint_dir: Path, output_dir: Path, config) -> Path:
    """``checkpoint_dir/*.bin`` -> ``output_dir/lit-llama.pth`` under
    ``config``'s head count; returns the written path."""
    import torch

    from lit_llama_tpu_torch.utils import convert

    bins = sorted(Path(checkpoint_dir).glob("*.bin"))
    if not bins:
        raise FileNotFoundError(f"no .bin files under {checkpoint_dir}")
    merged = {}
    for b in bins:
        merged.update(torch.load(b, mmap=True, weights_only=True, map_location="cpu"))
    output_dir.mkdir(parents=True, exist_ok=True)
    out = output_dir / "lit-llama.pth"
    torch.save(convert.hf_to_lit(merged, config), out)
    return out


def verify_logits(lit_path: Path, hf_dir: Path, config) -> None:
    """The port's ``forward`` on ``lit_path`` against
    ``transformers.LlamaForCausalLM`` on ``hf_dir``, both in f32 on the CPU,
    over 32 tokens drawn from ``default_rng(0)``; raises when a logit differs
    by more than 2e-3 + 2e-3 * |theirs|."""
    import numpy as np
    import torch
    from transformers import LlamaForCausalLM

    from lit_llama_tpu_torch.models import llama
    from lit_llama_tpu_torch.utils import convert

    tokens = np.random.default_rng(0).integers(0, config.vocab_size, size=(1, 32)).astype(np.int32)
    config = config.replace(param_dtype="float32", compute_dtype="float32")
    sd = torch.load(lit_path, mmap=True, weights_only=True, map_location="cpu")
    params = convert.lit_to_pytree(sd, config, dtype="float32", device="cpu")
    with torch.no_grad():
        ours = llama.forward(params, torch.from_numpy(tokens).long(), config)[0][..., : config.vocab_size]
        model = LlamaForCausalLM.from_pretrained(hf_dir, torch_dtype=torch.float32)
        theirs = model(torch.from_numpy(tokens).long())["logits"]
    torch.testing.assert_close(ours.float(), theirs.float(), atol=2e-3, rtol=2e-3)


if __name__ == "__main__":
    from lit_llama_tpu_torch.utils.cli import cli

    cli(convert_hf_checkpoint)
