"""Packed token dataset: LITPKDS binary chunks, rank sharding, weighted
mixtures (counterpart of lit_llama_tpu/data/packed_dataset.py, numpy only).

Derived from lit-llama's ``packed_dataset.py`` (Apache-2.0, LICENSE at repo
root), as the JAX package's copy is: the header and byte format, class and
attribute names and the shard arithmetic are kept line-compatible, so chunk
files written by either package load in the other and the same seed yields
the same blocks.

Format: ``LITPKDS`` magic + uint64 version (1) + uint8 dtype code + uint64
chunk_size header, then the raw token array.

* file sharding round-robin by ``process_rank * num_workers + worker_id``,
  truncated to a multiple of the shard count;
* the iterator mmaps ``n_chunks`` files at a time and yields shuffled
  ``block_size`` slices (numpy ``default_rng(seed)``), loading the next window
  on exhaustion, optionally wrapping;
* the builder streams arrays into fixed chunks padded with ``sep_token``,
  uint16 when the vocabulary is under 65500;
* ``CombinedDataset``: per-sample weighted random choice of a dataset with
  ``random.Random(seed)``;
* ``batcher`` stacks (accum, batch, block) numpy arrays for one train step.
"""


from __future__ import annotations

import os
import random
import struct
from typing import Iterator, List, Sequence

import numpy as np

dtypes = {
    1: np.uint8,
    2: np.int8,
    3: np.int16,
    4: np.int32,
    5: np.int64,
    6: np.float32,
    7: np.float64,
    8: np.uint16,
}

HDR_MAGIC = b"LITPKDS"
HDR_SIZE = 24  # bytes


def code(dtype) -> int:
    for k, v in dtypes.items():
        if v == dtype:
            return k
    raise ValueError(dtype)


def read_header(path):
    with open(path, "rb") as f:
        magic = f.read(len(HDR_MAGIC))
        if magic != HDR_MAGIC:
            raise ValueError(f"{path}: not a LITPKDS file")
        (version,) = struct.unpack("<Q", f.read(8))
        if version != 1:
            raise ValueError(f"{path}: unsupported version {version}")
        (dtype_code,) = struct.unpack("<B", f.read(1))
        (chunk_size,) = struct.unpack("<Q", f.read(8))
    return dtypes[dtype_code], chunk_size


class PackedDatasetBuilder:
    """Streams token arrays into fixed-size chunk files
    (reference: packed_dataset.py:70-136)."""

    def __init__(self, outdir, prefix, chunk_size, sep_token, dtype="auto", vocab_size=None):
        if dtype == "auto":
            if vocab_size is None:
                raise ValueError("vocab_size cannot be None when dtype='auto'")
            self._dtype = np.uint16 if vocab_size < 65500 else np.int32
        else:
            self._dtype = dtype
        self._counter = 0
        self._chunk_size = chunk_size
        self._outdir = outdir
        self._prefix = prefix
        self._sep_token = sep_token
        self._arr = np.full(chunk_size, sep_token, dtype=self._dtype)
        self._idx = 0
        self._version = 1
        self._filenames: List[str] = []

    @property
    def dtype(self):
        return self._dtype

    @property
    def filenames(self) -> List[str]:
        return self._filenames.copy()

    def _write_chunk(self) -> None:
        filename = os.path.join(self._outdir, f"{self._prefix}_{self._counter:010d}.bin")
        with open(filename, "wb") as f:
            f.write(HDR_MAGIC)
            f.write(struct.pack("<Q", self._version))
            f.write(struct.pack("<B", code(self._dtype)))
            f.write(struct.pack("<Q", self._chunk_size))
            f.write(self._arr.tobytes(order="C"))
        self._filenames.append(filename)
        self._counter += 1
        self._arr.fill(self._sep_token)
        self._idx = 0

    def add_array(self, arr: np.ndarray) -> None:
        while self._idx + arr.shape[0] > self._chunk_size:
            part_len = self._chunk_size - self._idx
            self._arr[self._idx : self._idx + part_len] = arr[:part_len]
            self._write_chunk()
            arr = arr[part_len:]
        self._arr[self._idx : self._idx + arr.shape[0]] = arr
        self._idx += arr.shape[0]

    def write_reminder(self) -> None:
        self._write_chunk()


class PackedDataset:
    """Iterable over ``block_size`` token slices of sharded chunk files
    (reference: packed_dataset.py:39-67)."""

    def __init__(
        self,
        filenames: Sequence,
        n_chunks: int,
        block_size: int,
        seed: int = 12345,
        shuffle: bool = True,
        wrap: bool = False,
        num_processes: int = 1,
        process_rank: int = 0,
        num_workers: int = 1,
        worker_id: int = 0,
    ):
        self._filenames = [str(f) for f in filenames]
        self._n_chunks = n_chunks
        self._block_size = block_size
        self._seed = seed
        self._shuffle = shuffle
        self._wrap = wrap
        self._num_processes = num_processes
        self._process_rank = process_rank
        self._num_workers = num_workers
        self._worker_id = worker_id

    def __iter__(self) -> "PackedDatasetIterator":
        num_shards = self._num_workers * self._num_processes
        shard_id = self._process_rank * self._num_workers + self._worker_id
        max_num_files = len(self._filenames) // num_shards * num_shards
        filenames = self._filenames[shard_id:max_num_files:num_shards]
        return PackedDatasetIterator(
            filenames=filenames,
            n_chunks=self._n_chunks,
            block_size=self._block_size,
            seed=self._seed,
            shuffle=self._shuffle,
            wrap=self._wrap,
        )


class PackedDatasetIterator:
    """(reference: packed_dataset.py:139-238)"""

    def __init__(self, filenames, n_chunks, block_size, seed, shuffle, wrap):
        self._seed = seed
        self._shuffle = shuffle
        self._rng = np.random.default_rng(seed) if shuffle else None
        self._wrap = wrap
        self._filenames = filenames
        self._file_idx = 0
        self._n_chunks = n_chunks
        self._dtype = None
        self._block_size = block_size
        self._n_blocks = None
        self._mmaps: List[np.memmap] = []
        self._block_idxs: Sequence[int] = []
        self._curr_idx = 0
        self._load_n_chunks()

    def _close_mmaps(self) -> None:
        for mm in self._mmaps:
            mm._mmap.close()
        self._mmaps = []

    def _load_n_chunks(self) -> None:
        self._close_mmaps()
        if self._n_chunks > len(self._filenames[self._file_idx :]):
            if not self._wrap:
                raise StopIteration
            self._file_idx = 0
        for i in range(self._n_chunks):
            filename = self._filenames[self._file_idx + i]
            if self._dtype is None:
                self._dtype, self._chunk_size = read_header(filename)
                self._n_blocks = self._chunk_size // self._block_size
            self._mmaps.append(np.memmap(filename, mode="r", order="C", offset=HDR_SIZE))
        self._file_idx += self._n_chunks
        n_all_blocks = self._n_chunks * self._n_blocks
        self._block_idxs = (
            self._rng.permutation(n_all_blocks) if self._shuffle else range(n_all_blocks)
        )
        self._curr_idx = 0

    def __del__(self):
        try:
            self._close_mmaps()
        except Exception:
            pass

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._curr_idx >= len(self._block_idxs):
            self._load_n_chunks()
        block_idx = self._block_idxs[self._curr_idx]
        chunk_id = block_idx // self._n_blocks
        elem_id = (block_idx % self._n_blocks) * self._block_size
        offset = np.dtype(self._dtype).itemsize * elem_id
        arr = np.frombuffer(
            self._mmaps[chunk_id], dtype=self._dtype, count=self._block_size, offset=offset
        )
        self._curr_idx += 1
        return arr.astype(np.int32)


class CombinedDataset:
    """Per-sample weighted random mixture (reference: packed_dataset.py:241-262)."""

    def __init__(self, datasets, seed, weights=None):
        self._seed = seed
        self._datasets = datasets
        n = len(datasets)
        self._weights = weights if weights is not None else [1 / n] * n

    def __iter__(self):
        return CombinedDatasetIterator(self._datasets, self._seed, self._weights)


class CombinedDatasetIterator:
    def __init__(self, datasets, seed, weights):
        self._datasets = [iter(d) for d in datasets]
        self._weights = weights
        self._rng = random.Random(seed)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        (dataset,) = self._rng.choices(self._datasets, weights=self._weights, k=1)
        return next(dataset)


def batcher(
    dataset,
    batch_size: int,
    accum_steps: int = 1,
    drop_last: bool = True,
) -> Iterator[np.ndarray]:
    """Group an iterable of (T,) blocks into (accum, batch, T) arrays for one
    train step (replaces the reference's torch DataLoader,
    pretrain/redpajama.py:237-298)."""
    it = iter(dataset)
    n = accum_steps * batch_size
    while True:
        blocks = []
        try:
            for _ in range(n):
                blocks.append(next(it))
        except StopIteration:
            if drop_last or not blocks:
                return
        if len(blocks) < n:
            return
        yield np.stack(blocks).reshape(accum_steps, batch_size, -1)
