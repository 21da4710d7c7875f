"""Write a tiny random lit-llama checkpoint and tokenizer for runs without
real weights (counterpart of the JAX package's scripts/make_tiny_checkpoint.py:
the same flags and files).

    python -m lit_llama_tpu_torch.scripts.make_tiny_checkpoint --out_dir checkpoints/tiny [--n_layer 3]

``out_dir`` gets ``lit-llama.pth`` (``utils.convert.pytree_to_lit`` through
``torch.save``), ``tokenizer.model`` (``train_bpe`` on the JAX script's
three-line corpus, repeated 50 times) and ``config.json`` (the JAX script's
keys). The tokenizer and the config are the JAX script's byte for byte; the
weights are ``models.llama.init_params`` drawn from a ``torch.Generator``
seeded ``seed`` on the host, and so differ from the JAX script's
``PRNGKey(seed)`` draws (the same layout and scale, other values). Host work
only: no ``--device``.
"""

from __future__ import annotations

import json
from pathlib import Path

from lit_llama_tpu_torch.utils.cli import host_only

CORPUS = ("the quick brown fox jumps over the lazy dog\n"
          "pack my box with five dozen liquor jugs\n"
          "how vexingly quick daft zebras jump\n" * 50)


@host_only
def main(
    out_dir: Path = Path("checkpoints/tiny"),
    vocab_size: int = 256,
    n_layer: int = 2,
    n_head: int = 4,
    n_embd: int = 64,
    block_size: int = 128,
    seed: int = 0,
) -> None:
    """Write <out_dir>/lit-llama.pth, <out_dir>/tokenizer.model and config.json.

    Args:
        out_dir: Output directory.
        vocab_size: Tokenizer/model vocab size.
        n_layer: Number of transformer blocks.
        n_head: Attention heads.
        n_embd: Embedding width.
        block_size: Context length.
        seed: Weight init seed.
    """
    import torch

    from lit_llama_tpu_torch.data.tokenizer import Tokenizer
    from lit_llama_tpu_torch.models import llama
    from lit_llama_tpu_torch.models.config import LLaMAConfig
    from lit_llama_tpu_torch.utils import convert

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    shape = dict(block_size=block_size, vocab_size=vocab_size, n_layer=n_layer, n_head=n_head, n_embd=n_embd)
    config = LLaMAConfig(**shape)
    params = llama.init_params(config, torch.Generator().manual_seed(seed), device="cpu")
    torch.save(convert.pytree_to_lit(params, config), out_dir / "lit-llama.pth")

    corpus = out_dir / "_corpus.txt"
    corpus.write_text(CORPUS)
    Tokenizer.train(str(corpus), str(out_dir), vocab_size=vocab_size)
    corpus.unlink()
    (out_dir / "config.json").write_text(json.dumps(shape))
    print(f"tiny checkpoint written to {out_dir}")


if __name__ == "__main__":
    from lit_llama_tpu_torch.utils.cli import cli

    cli(main)
