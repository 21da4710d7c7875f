"""Carry a JAX parameter tree across to the port.

``params_from_numpy`` takes the tree as ``jax.tree_util.tree_map(np.asarray,
params)`` gives it (numpy leaves; bf16 leaves are ``ml_dtypes.bfloat16``) and
returns the same keys and layout with torch tensors on ``device``. The
kernels' relayout of the TPU toolchain (``qscale_b``/``qzero_b`` from
``blocked_scales``) is dropped. ``cache_from_numpy`` does the same for a
per-layer KV cache. Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from lit_llama_tpu_torch.utils.device import resolve_device

_DROP = ("qscale_b", "qzero_b")


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # torch tensors assume writable memory
        a = a.copy()
    if a.dtype.name == "bfloat16":  # torch.from_numpy rejects ml_dtypes' bf16
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, device=None):
    """Numpy (or array-like) leaves -> tensors on ``device`` (the card when
    None), keeping dicts, lists and tuples as they are."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items() if k not in _DROP}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return tensor_from_numpy(np.asarray(node), dev)

    return conv(tree)


def cache_from_numpy(layers, device=None):
    """A JAX per-layer KV cache -> the port's: a list of {"k", "v"} tensors
    (B, H, S, hs) on ``device`` (the card when None), or of {"k", "v", "ks",
    "vs"} for an int8 cache (int8 rows, (B, H, S, 1) f32 scales). ``layers``
    is the tuple of per-layer dicts with numpy leaves; a packed u32 pair cache
    must be unpacked first (``fused_layer.unpack_kv`` on the JAX side), since
    the port keeps plain rows."""
    dev = resolve_device(device)
    out = []
    for kv in layers:
        if set(kv) not in ({"k", "v"}, {"k", "v", "ks", "vs"}):
            raise ValueError(f"the port's cache holds k and v, or k, v, ks and vs, got {sorted(kv)}")
        entry = {name: tensor_from_numpy(np.asarray(a), dev) for name, a in kv.items()}
        quant = "ks" in entry
        for name, t in entry.items():
            rows_ok = t.dtype == torch.int8 if quant and name in ("k", "v") else t.is_floating_point()
            if t.ndim != 4 or not rows_ok:
                raise ValueError(f"cache leaf {name}: expected unpacked (B, H, S, hs) rows "
                                 f"(int8 beside f32 ks/vs, else float), got {t.dtype} {tuple(t.shape)}")
        out.append(entry)
    return out
