"""Device and dtype resolution shared by the entry points."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}

# (name substring, memory bytes/s, dense bf16 tensor FLOP/s, f32 FLOP/s):
# NVIDIA's data sheets; first match wins
_PEAKS = (
    ("H100 PCIe", 2.0e12, 756e12, 51e12),
    ("H100 NVL", 3.9e12, 835e12, 60e12),
    ("H200", 4.8e12, 989e12, 67e12),
    ("H100", 3.35e12, 989e12, 67e12),
)


def device_peaks(kind: str) -> Tuple[float, float, float]:
    """(memory bytes/s, bf16 tensor FLOP/s, f32 FLOP/s) of the card named
    ``kind`` (``torch.cuda.get_device_name``); an unknown name gets the H100
    SXM's."""
    return next((p[1:] for p in _PEAKS if p[0] in kind), _PEAKS[-1][1:])


def torch_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    """Config dtype name ("float32", "bfloat16", ...) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype name {name!r}") from None


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the card. Raises when a CUDA device is asked for and none
    is present: nothing falls back to the CPU unless the caller passes
    ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev
