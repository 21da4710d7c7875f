"""Device memory reporting (counterpart of lit_llama_tpu/utils/memory.py: the
reference prints ``torch.cuda.max_memory_reserved`` after inference; the
entry points here print the peak the caching allocator handed out)."""

from __future__ import annotations

import sys
from typing import Optional

import torch


def peak_memory_gb(device=None) -> Optional[float]:
    """Peak bytes allocated on ``device`` (the current card when None), in
    GiB; None on the CPU or without a card."""
    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    peak = torch.cuda.max_memory_allocated(device)
    return None if not peak else peak / 2**30


def print_peak_memory(device=None, file=None) -> None:
    """The peak on ``file`` (stderr), from rank 0 only under ``torchrun``."""
    from lit_llama_tpu_torch.parallel.launch import is_main_process

    peak = peak_memory_gb(device)
    if peak is not None and is_main_process():
        print(f"Peak device memory in use: {peak:.02f} GB", file=file or sys.stderr)
