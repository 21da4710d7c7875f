"""Native checkpoint format: JSON manifest + one raw data file (counterpart of
lit_llama_tpu/utils/checkpoint.py, byte-compatible with it).

Every leaf of a nested dict of tensors is a contiguous record in
``data.bin`` (64-byte aligned), described by ``manifest.json`` with its dtype
name, shape, offset and size. bf16 leaves are written as their raw 16-bit
patterns under the dtype name ``"bfloat16"``, as the JAX writer records
ml_dtypes' bf16, so each package reads what the other writes. Reads are
``np.memmap``-backed: one leaf at a time is copied out of the file.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

_ALIGN = 64
_SEP = "/"
_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}


def tree_leaves(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """{"h/attn/c_attn/w": leaf, ...} in sorted key order: the record names."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(tree_leaves(tree[k], f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(tree_leaves(v, f"{prefix}{i}{_SEP}"))
    else:
        out[prefix[: -len(_SEP)]] = tree
    return out


def tree_unflatten(flat: Dict[str, Any]) -> Any:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def _record(leaf):
    """(dtype name, shape, bytes) of a tensor, numpy array or scalar."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return name, list(leaf.shape), t.numpy().tobytes()
    arr = np.ascontiguousarray(np.asarray(leaf))
    return arr.dtype.name, list(arr.shape), arr.tobytes()


def save_checkpoint(path, tree: Any, metadata: Optional[dict] = None) -> None:
    """Write a nested dict of tensors (or arrays) to ``path`` (a directory)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    records = {}
    offset = 0
    with open(path / "data.bin", "wb") as f:
        for name, leaf in tree_leaves(tree).items():
            pad = (-offset) % _ALIGN
            if pad:
                f.write(b"\0" * pad)
                offset += pad
            dtype, shape, data = _record(leaf)
            f.write(data)
            records[name] = {"dtype": dtype, "shape": shape, "offset": offset, "nbytes": len(data)}
            offset += len(data)
    manifest = {"format": "lit-llama-tpu.ckpt.v1", "records": records}
    if metadata:
        manifest["metadata"] = metadata
    (path / "manifest.json").write_text(json.dumps(manifest, indent=1))


def load_checkpoint(path, *, transform: Optional[Callable[[str, torch.Tensor], Any]] = None) -> Any:
    """Load a tree saved by :func:`save_checkpoint` (of either package) as CPU
    tensors. ``transform(name, tensor) -> leaf`` runs per record (e.g. a copy
    to the card), so peak host memory stays at one leaf."""
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    mm = np.memmap(path / "data.bin", dtype=np.uint8, mode="r")
    flat = {}
    for name, rec in manifest["records"].items():
        if rec["dtype"] not in _TORCH_DTYPES:
            raise ValueError(f"{path}: record {name} has dtype {rec['dtype']}, which the port does not read")
        # into memory torch allocates (and aligns), then viewed as the dtype
        t = torch.empty(rec["nbytes"], dtype=torch.uint8)
        t.numpy()[:] = mm[rec["offset"] : rec["offset"] + rec["nbytes"]]
        t = t.view(_TORCH_DTYPES[rec["dtype"]]).reshape(rec["shape"])
        flat[name] = transform(name, t) if transform else t
    return tree_unflatten(flat)


def load_metadata(path) -> dict:
    manifest = json.loads((Path(path) / "manifest.json").read_text())
    return manifest.get("metadata", {})
