"""What the instruction-data preparations share: the local data file, the
seeded train / test split, and the sample files."""

from __future__ import annotations

from pathlib import Path
from typing import Callable, List, Optional


def data_file_path(destination_path: Path, data_file: Optional[Path], default_name: str) -> Path:
    """``data_file``, or ``destination_path/default_name`` where it already
    lies; nothing is downloaded."""
    path = Path(data_file) if data_file is not None else Path(destination_path) / default_name
    if not path.is_file():
        raise FileNotFoundError(f"no data file at {path}: pass --data_file (nothing is downloaded)")
    return path


def split(data: List, test_split_size: int, seed: int):
    """(train, test): the first ``test_split_size`` of a seeded permutation go
    to test; both keep the data's order."""
    import numpy as np

    perm = np.random.default_rng(seed).permutation(len(data))
    test_ids = set(perm[:test_split_size].tolist())
    train = [data[i] for i in range(len(data)) if i not in test_ids]
    test = [data[i] for i in range(len(data)) if i in test_ids]
    print(f"train has {len(train):,} samples, test has {len(test):,}")
    return train, test


def write_splits(destination_path: Path, train: List, test: List, sample: Callable) -> None:
    """``train.pt`` and ``test.pt`` of ``sample(example)`` over each split."""
    from lit_llama_tpu_torch.data import sft

    for name, part in (("train", train), ("test", test)):
        print(f"Processing {name} split ...")
        sft.save_samples([sample(s) for s in part], Path(destination_path) / f"{name}.pt")
