"""Device time of one call on the card, as every timing tool of the package
and ``chip_smoke.py`` take it.

``make_timer(device)`` returns ``time_us(fn, iters=20, clean=False)``: the
median device time of ``fn`` over ``iters`` runs (CUDA events), after one
untimed run. Before each run the L2 is flushed through a 128 MB buffer (more
than the H100's 50 MB L2), by writing it, or with ``clean`` by reading it: a
writing flush leaves up to 50 MB of dirty lines that the timed kernel's own
reads must first write back, a reading one a cold L2 of clean lines. A spin
on the card ahead of the start event keeps it busy while the host enqueues
``fn``, so the host's time in the wrapper is not counted.

The profile tools run as files and import this module from beside them, so
that their ``--root`` may point at a checkout that lacks it.
"""

from __future__ import annotations

import subprocess
from typing import Callable

import torch

FLUSH_BYTES = 128 << 20


def make_timer(device) -> Callable[..., float]:
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)

    def time_us(fn: Callable[[], object], iters: int = 20, clean: bool = False) -> float:
        fn()
        times = []
        for _ in range(iters):
            if clean:
                flush.sum(dtype=torch.int32)
            else:
                flush.zero_()
            torch.cuda._sleep(1_000_000)  # ~0.5 ms of device cycles
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b) * 1e3)
        return sorted(times)[len(times) // 2]

    time_us.flush = flush  # for a caller that flushes around a trace of its own
    return time_us


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
