"""Prepare tiny-shakespeare: train a small BPE tokenizer and write the token
files (counterpart of the JAX package's scripts/prepare_shakespeare.py: the
same flags and files, local input only).

    python -m lit_llama_tpu_torch.scripts.prepare_shakespeare --input_file input.txt \
        --destination_path data/shakespeare [--vocab_size 100]

The corpus is ``--input_file`` (copied to ``destination_path/input.txt``) or
an ``input.txt`` already there; nothing is downloaded. The first 90 % of the
characters train ``tokenizer.model`` and become ``train.bin``, the rest
``val.bin`` (uint16 ids, no bos). Host work only: no ``--device``.
"""

from __future__ import annotations

from pathlib import Path

from lit_llama_tpu_torch.utils.cli import host_only


@host_only
def prepare(
    destination_path: Path = Path("data/shakespeare"),
    vocab_size: int = 100,
    input_file: Path = None,
) -> None:
    """Prepare the tiny-shakespeare dataset.

    Args:
        destination_path: Output directory (input.txt, tokenizer.model, train.bin, val.bin).
        vocab_size: Tokenizer vocabulary size (reference trains 100).
        input_file: Local corpus file; without it, destination_path/input.txt must exist.
    """
    import numpy as np

    from lit_llama_tpu_torch.data.tokenizer import Tokenizer

    destination_path = Path(destination_path)
    destination_path.mkdir(parents=True, exist_ok=True)
    target = destination_path / "input.txt"
    if input_file is not None:
        target.write_text(Path(input_file).read_text())
    elif not target.exists():
        raise FileNotFoundError(f"no corpus: pass --input_file or put input.txt in {destination_path}")

    text = target.read_text()
    n = len(text)
    train_text, val_text = text[: int(n * 0.9)], text[int(n * 0.9) :]

    corpus = destination_path / "_train_corpus.txt"
    corpus.write_text(train_text)
    Tokenizer.train(str(corpus), str(destination_path), vocab_size)
    corpus.unlink()
    tok = Tokenizer(destination_path / "tokenizer.model")

    for name, part in (("train", train_text), ("val", val_text)):
        ids = tok.encode(part, bos=False).numpy().astype(np.uint16)
        ids.tofile(destination_path / f"{name}.bin")
        print(f"{name} has {len(ids):,} tokens")


if __name__ == "__main__":
    from lit_llama_tpu_torch.utils.cli import cli

    cli(prepare)
