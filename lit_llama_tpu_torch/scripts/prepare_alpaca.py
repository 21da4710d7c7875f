"""Prepare the alpaca-cleaned instruction data for finetuning (counterpart of
the JAX package's scripts/prepare_alpaca.py: the same flags and files, local
input only).

    python -m lit_llama_tpu_torch.scripts.prepare_alpaca --data_file alpaca_data_cleaned_archive.json \
        --tokenizer_path checkpoints/lit-llama/tokenizer.model --destination_path data/alpaca

A seeded train / test split, the alpaca prompt template, tokens cut at
``max_seq_length``, labels with the prompt masked out when ``mask_inputs``;
writes ``train.pt`` and ``test.pt``. Host work only: no ``--device``.
"""

from __future__ import annotations

import json
from pathlib import Path

from lit_llama_tpu_torch.utils.cli import host_only

DATA_FILE_NAME = "alpaca_data_cleaned_archive.json"


@host_only
def prepare(
    destination_path: Path = Path("data/alpaca"),
    tokenizer_path: Path = Path("checkpoints/lit-llama/tokenizer.model"),
    test_split_size: int = 2000,
    max_seq_length: int = 256,
    seed: int = 42,
    mask_inputs: bool = False,
    data_file: Path = None,
) -> None:
    """Prepare the Alpaca dataset for instruction tuning.

    Args:
        destination_path: Output directory for train.pt / test.pt.
        tokenizer_path: SentencePiece tokenizer model.
        test_split_size: Number of held-out test samples (reference: 2000).
        max_seq_length: Token truncation length (reference: 256).
        seed: Split shuffle seed.
        mask_inputs: Mask the prompt out of the labels with IGNORE_INDEX.
        data_file: Local JSON file (default: destination_path/alpaca_data_cleaned_archive.json).
    """
    from lit_llama_tpu_torch.data import sft
    from lit_llama_tpu_torch.data.tokenizer import Tokenizer
    from lit_llama_tpu_torch.scripts import _sft_prep

    destination_path = Path(destination_path)
    destination_path.mkdir(parents=True, exist_ok=True)
    file_path = _sft_prep.data_file_path(destination_path, data_file, DATA_FILE_NAME)
    tokenizer = Tokenizer(tokenizer_path)
    with open(file_path) as f:
        data = json.load(f)
    train, test = _sft_prep.split(data, test_split_size, seed)
    _sft_prep.write_splits(destination_path, train, test,
                           lambda s: sft.prepare_sample(s, tokenizer, max_seq_length, mask_inputs))


if __name__ == "__main__":
    from lit_llama_tpu_torch.utils.cli import cli

    cli(prepare)
