"""Small numeric helpers (counterpart of lit_llama_tpu/utils/math.py)."""

from __future__ import annotations


def find_multiple(n: int, k: int) -> int:
    """Round ``n`` up to the nearest multiple of ``k`` (vocab padding to 64,
    SwiGLU hidden size to 256)."""
    if n % k == 0:
        return n
    return n + k - (n % k)

