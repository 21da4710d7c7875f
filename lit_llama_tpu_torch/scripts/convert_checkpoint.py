"""Convert Meta's LLaMA weights to a lit-llama ``.pth`` (counterpart of the
JAX package's scripts/convert_checkpoint.py: the same flags).

    python -m lit_llama_tpu_torch.scripts.convert_checkpoint --input_dir checkpoints/llama/7B \
        --output_dir checkpoints/lit-llama/7B [--model_size 7B] [--dtype float32]

Reads every ``consolidated.*.pth`` under ``input_dir`` (memory-mapped), merges
the tensor-parallel shards of 13B and larger, fuses wq / wk / wv into
``c_attn`` and writes ``output_dir/lit-llama.pth``. Host work only: no
``--device``.
"""

from __future__ import annotations

from pathlib import Path

from lit_llama_tpu_torch.utils.cli import host_only


@host_only
def convert_checkpoint(
    output_dir: Path = Path("checkpoints/lit-llama/7B"),
    input_dir: Path = Path("checkpoints/llama/7B"),
    model_size: str = "7B",
    dtype: str = "float32",
) -> None:
    """Convert Meta consolidated.*.pth shards into a single lit-llama.pth.

    Args:
        output_dir: Output directory (writes lit-llama.pth).
        input_dir: Directory with Meta's consolidated.NN.pth shard files.
        model_size: Config preset (7B/13B/30B/65B).
        dtype: Output dtype.
    """
    import torch

    from lit_llama_tpu_torch.models.config import LLaMAConfig
    from lit_llama_tpu_torch.utils import convert

    input_dir, output_dir = Path(input_dir), Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    shard_files = sorted(input_dir.glob("consolidated.*.pth"))
    if not shard_files:
        raise FileNotFoundError(f"no consolidated.*.pth under {input_dir}")
    shards = [torch.load(f, mmap=True, weights_only=True, map_location="cpu") for f in shard_files]
    sd = convert.meta_to_lit(shards, LLaMAConfig.from_name(model_size), dtype=dtype)
    torch.save(sd, output_dir / "lit-llama.pth")
    print(f"written {output_dir / 'lit-llama.pth'}")


if __name__ == "__main__":
    from lit_llama_tpu_torch.utils.cli import cli

    cli(convert_checkpoint)
