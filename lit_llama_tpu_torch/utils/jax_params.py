"""Carry a JAX parameter tree across to the port.

``params_from_numpy`` takes the tree as ``jax.tree_util.tree_map(np.asarray,
params)`` gives it (numpy leaves; bf16 leaves are ``ml_dtypes.bfloat16``) and
returns the same keys and layout with torch tensors on ``device``. The
kernels' relayout of the TPU toolchain (``qscale_b``/``qzero_b`` from
``blocked_scales``) is dropped. Nothing here imports JAX.
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
