"""Prepare line-per-sample text for finetuning (counterpart of the JAX
package's scripts/prepare_any_text.py: the same flags and files).

    python -m lit_llama_tpu_torch.scripts.prepare_any_text --train_data_path input.txt \
        --tokenizer_path checkpoints/lit-llama/tokenizer.model --destination_path data/any_text

Each non-empty line is a sample (bos + tokens + eos, cut at
``max_seq_length``, labels equal to the inputs); a seeded permutation keeps
``test_split_ratio`` of the lines for ``train.pt`` (the name is the
reference's) and the rest for ``test.pt``. Host work only: no ``--device``.
"""

from __future__ import annotations

from pathlib import Path

from lit_llama_tpu_torch.utils.cli import host_only


@host_only
def prepare(
    train_data_path: Path = Path("data/any_text/input.txt"),
    destination_path: Path = Path("data/any_text"),
    tokenizer_path: Path = Path("checkpoints/lit-llama/tokenizer.model"),
    test_split_ratio: float = 0.9,
    max_seq_length: int = 256,
    seed: int = 42,
) -> None:
    """Prepare a plain-text dataset (one sample per line).

    Args:
        train_data_path: Input text file, one sample per line.
        destination_path: Output directory for train.pt / test.pt.
        tokenizer_path: SentencePiece tokenizer model.
        test_split_ratio: Fraction of lines kept for training.
        max_seq_length: Token truncation length.
        seed: Split shuffle seed.
    """
    import numpy as np

    from lit_llama_tpu_torch.data import sft
    from lit_llama_tpu_torch.data.tokenizer import Tokenizer

    destination_path = Path(destination_path)
    destination_path.mkdir(parents=True, exist_ok=True)
    tokenizer = Tokenizer(tokenizer_path)
    lines = [line for line in Path(train_data_path).read_text().splitlines() if line.strip()]

    perm = np.random.default_rng(seed).permutation(len(lines))
    n_train = int(len(lines) * test_split_ratio)
    train_lines = [lines[i] for i in perm[:n_train]]
    test_lines = [lines[i] for i in perm[n_train:]]
    print(f"train has {len(train_lines):,} samples, test has {len(test_lines):,}")

    def sample(line: str):
        ids = tokenizer.encode(line, bos=True, eos=True, max_length=max_seq_length).numpy()
        # three arrays, as the reference writes them (one shared array would be
        # one storage in the file)
        return {key: ids.astype(np.int32) for key in ("input_ids", "input_ids_no_response", "labels")}

    sft.save_samples([sample(line) for line in train_lines], destination_path / "train.pt")
    sft.save_samples([sample(line) for line in test_lines], destination_path / "test.pt")


if __name__ == "__main__":
    from lit_llama_tpu_torch.utils.cli import cli

    cli(prepare)
