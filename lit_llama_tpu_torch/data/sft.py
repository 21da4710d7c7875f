"""Instruction-tuning (SFT) data: prompt template, tokenization, batching
(counterpart of lit_llama_tpu/data/sft.py).

The alpaca template (``### Instruction:`` / ``### Input:`` / ``### Response:``),
labels with the prompt masked out (``IGNORE_INDEX`` = -1) and right-padded
batches (inputs pad 0, labels pad -1) whose length is rounded up to a multiple
of ``pad_multiple``.

Batches are drawn with numpy's ``np.random.Generator`` in the JAX package's
call order (``rng.integers`` for a batch, ``rng.permutation`` and a stable
argsort for length grouping), so one seed gives both packages the same
batches, bit for bit. Sample files are the JAX package's: ``.pt`` (a list of
dicts of int tensors, as the reference's prepare scripts write) or ``.npz``
(each key's samples concatenated, with their lengths); each package reads
what the other writes.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

IGNORE_INDEX = -1
_KEYS = ("input_ids", "input_ids_no_response", "labels")


def generate_prompt(example: dict) -> str:
    """The alpaca instruction prompt, with an ``### Input:`` section when the
    example has a non-empty ``input``."""
    if example.get("input"):
        return (
            "Below is an instruction that describes a task, paired with an input that provides further context. "
            "Write a response that appropriately completes the request.\n\n"
            f"### Instruction:\n{example['instruction']}\n\n### Input:\n{example['input']}\n\n### Response:"
        )
    return (
        "Below is an instruction that describes a task. "
        "Write a response that appropriately completes the request.\n\n"
        f"### Instruction:\n{example['instruction']}\n\n### Response:"
    )


def prepare_sample(example: dict, tokenizer, max_length: int, mask_inputs: bool = True) -> Dict[str, np.ndarray]:
    """One instruction example -> int32 ``input_ids`` (prompt + output + eos),
    ``input_ids_no_response`` (bos + prompt) and ``labels`` (``input_ids``
    with the prompt's positions set to ``IGNORE_INDEX`` when
    ``mask_inputs``), each cut to ``max_length``."""
    full_prompt = generate_prompt(example)
    enc_prompt = np.asarray(tokenizer.encode(full_prompt, bos=True, eos=False, max_length=max_length))
    enc_full = np.asarray(tokenizer.encode(full_prompt + example["output"], bos=True, eos=True,
                                           max_length=max_length))
    labels = enc_full.copy()
    if mask_inputs:
        labels[: len(enc_prompt)] = IGNORE_INDEX
    return {"input_ids": enc_full.astype(np.int32), "input_ids_no_response": enc_prompt.astype(np.int32),
            "labels": labels.astype(np.int32)}


def save_samples(samples: List[Dict[str, np.ndarray]], path) -> None:
    """``.pt``: a list of dicts of tensors (``torch.save``); else ``.npz``."""
    path = Path(path)
    if path.suffix == ".pt":
        import torch

        torch.save([{k: torch.from_numpy(np.asarray(v)) for k, v in s.items() if isinstance(v, np.ndarray)}
                    for s in samples], path)
        return
    flat = {}
    for key in _KEYS:
        arrs = [np.asarray(s[key]) for s in samples]
        flat[f"{key}_cat"] = np.concatenate(arrs) if arrs else np.zeros(0, np.int32)
        flat[f"{key}_len"] = np.asarray([len(a) for a in arrs], np.int64)
    np.savez(path, **flat)


def load_samples(path) -> List[Dict[str, np.ndarray]]:
    """Samples as int32 numpy arrays from a ``.pt`` or ``.npz`` file (a path
    without a suffix means ``.npz``)."""
    path = Path(path)
    if path.suffix == ".pt":
        import torch

        data = torch.load(path, map_location="cpu", weights_only=False)
        return [{k: v.numpy().astype(np.int32) for k, v in s.items() if hasattr(v, "numpy")} for s in data]
    z = np.load(path if path.suffix == ".npz" else str(path) + ".npz")
    lens = {k: z[f"{k}_len"] for k in _KEYS if f"{k}_len" in z}
    n = len(next(iter(lens.values())))
    offs = {k: np.concatenate([[0], np.cumsum(v)]) for k, v in lens.items()}
    return [{k: z[f"{k}_cat"][offs[k][i] : offs[k][i + 1]].astype(np.int32) for k in lens} for i in range(n)]


def get_batch(
    data: List[Dict[str, np.ndarray]],
    batch_size: int,
    rng: np.random.Generator,
    accum_steps: int = 1,
    pad_multiple: int = 64,
    max_seq_length: Optional[int] = None,
    sequential: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """A right-padded (accum, batch, T) int32 pair (input_ids, labels), next-token
    aligned: inputs drop each sample's last token and labels its first. T is
    the longest input rounded up to ``pad_multiple``, at most
    ``max_seq_length``. ``sequential`` takes the first samples of ``data`` in
    order (the caller grouped them by length) instead of drawing them."""
    n = accum_steps * batch_size
    ix = np.arange(n) % len(data) if sequential else rng.integers(len(data), size=n)
    input_ids = [data[i]["input_ids"][:-1] for i in ix]
    labels = [data[i]["labels"][1:] for i in ix]
    max_len = max(max(len(s) for s in input_ids), 1)
    T = -(-max_len // pad_multiple) * pad_multiple
    if max_seq_length is not None:
        T = min(T, max_seq_length)
    x = np.zeros((n, T), np.int32)
    y = np.full((n, T), IGNORE_INDEX, np.int32)
    for j, (ids, lab) in enumerate(zip(input_ids, labels)):
        L = min(len(ids), T)
        x[j, :L] = ids[:L]
        y[j, :L] = lab[:L]
    return x.reshape(accum_steps, batch_size, T), y.reshape(accum_steps, batch_size, T)


def length_grouped_indices(lengths: List[int], batch_size: int, rng: np.random.Generator,
                           mega_factor: int = 50) -> np.ndarray:
    """A random permutation cut into megabatches of ``batch_size *
    mega_factor``, each sorted longest first (stable); the longest sample of
    all is swapped to the front, so a run that would run out of memory does so
    at once."""
    n = len(lengths)
    perm = rng.permutation(n)
    mega = batch_size * mega_factor
    chunks = [perm[i : i + mega] for i in range(0, n, mega)]
    chunks = [c[np.argsort(-np.asarray([lengths[i] for i in c]), kind="stable")] for c in chunks]
    if not chunks:
        return np.zeros(0, np.int64)
    best = int(np.argmax([lengths[int(c[0])] for c in chunks]))
    c0, cb = chunks[0].copy(), chunks[best].copy()
    c0[0], cb[0] = cb[0], c0[0]
    chunks[0], chunks[best] = c0, cb
    return np.concatenate(chunks)
