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

``kernel_sequence(call, time_us)`` times each kernel an entry launches, by
its place in the entry's sequence, from a torch.profiler trace.

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


def kernel_sequence(call: Callable[[], object], time_us, n: int = 20) -> dict:
    """Each kernel ``call`` launches, by its place in the sequence, over ``n``
    calls each after a reading L2 flush and a spin (torch.profiler): the
    median device time, the median start after the previous kernel's end
    (negative where programmatic dependent launch overlaps them), and the
    median first start to last end of a call."""
    from torch.profiler import ProfilerActivity, profile

    def kernels(prof):
        return sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                      key=lambda e: e.time_range.start)

    names = []
    for _ in range(3):  # the entry's own kernels (a first trace may come back empty)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        names = [e.name for e in kernels(prof)]
        if names:
            break
    k, runs = len(names), []
    for _ in range(3):  # a trace now and then drops a kernel's record: trace again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                time_us.flush.sum(dtype=torch.int32)
                torch.cuda._sleep(1_000_000)
                call()
            torch.cuda.synchronize()
        events = [e for e in kernels(prof) if e.name in names]
        runs = [events[i:i + k] for i in range(0, len(events), k)] if k else []
        if k and len(runs) == n and all([e.name for e in r] == names for r in runs):
            break
    else:
        raise RuntimeError(f"kernel_sequence: {len(events)} kernels in {n} calls of {k}")
    med = lambda v: sorted(v)[len(v) // 2]
    seq = [dict(kernel=names[i][:90], us=med([r[i].time_range.elapsed_us() for r in runs]),
                start_after_previous_end_us=med([r[i].time_range.start - r[i - 1].time_range.end for r in runs])
                if i else 0.0) for i in range(k)]
    return dict(sequence=seq, first_start_to_last_end_us=med([r[-1].time_range.end - r[0].time_range.start
                                                              for r in runs]))
