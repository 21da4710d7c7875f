"""Where one batched serving step's time goes on the card.

    python lit_llama_tpu_torch/tools/profile_serve.py [--root DIR] [--layers 32] [--seq 256] [--batch 8 32] [--lora]

Builds the 7B int4 model on random weights and, for each ``--batch`` B, a
``DecodeEngine`` of B slots whose slots all hold a running request (prompts of
``--prompt`` tokens). It then runs decode chunks through the engine's own
``_step`` (``llama.forward(slot_pos=...)``: K7, K8 and K9 per block, K3 for
the lm_head, argmax on the device; ``--lora`` adds a seeded LoRA overlay,
r = 8, alpha 16, q and v, which K7 takes as its LoRA operand) and prints: the host wall time of a step
(ending in the chunk's copy to the host), the device time per kernel name from
``torch.profiler``, and the device's busy time: the union of the kernels'
intervals (kernels launched early by programmatic dependent launch overlap
the one before, so a sum would count that time twice; ``credited`` of
``tools/profile_decode.py``), with its share of the wall time. Per kernel name,
the time credited to it (each instant of the union goes to the
earliest-started kernel still running) beside the sum of its own intervals.
Run as a file: ``--root DIR`` imports ``lit_llama_tpu_torch`` from DIR, so
another checkout (the parent commit unpacked under ``build/``) is read by the
same tool in the same call. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(1, str(Path(__file__).resolve().parent))
import devtime  # noqa: E402  (beside this file)
from profile_decode import credited  # noqa: E402


def profile_batch(params, cfg, B: int, seq: int, prompt: int, chunk: int, chunks: int) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lit_llama_tpu_torch.serve import DecodeEngine

    engine = DecodeEngine(params, cfg, max_batch=B, max_seq_length=seq, steps_per_sync=chunk,
                          prefill_budget=None)
    rng = np.random.default_rng(0)
    for _ in range(B):  # far more new tokens than the profile runs: no slot retires
        engine.submit(rng.integers(1, cfg.vocab_size, size=prompt), 1 << 30)
    engine._admit()
    assert engine.n_active == B and not engine.queue
    engine._harvest(engine._step(chunk))  # warm-up chunk
    torch.cuda.synchronize()

    steps = chunk * chunks
    t0 = time.perf_counter()
    for _ in range(chunks):
        engine._harvest(engine._step(chunk))
    wall_us = (time.perf_counter() - t0) / steps * 1e6

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(chunks):
            engine._harvest(engine._step(chunk))
        torch.cuda.synchronize()
    kernels = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
    credit = credited([(a, b) for a, b, _ in kernels])
    per_name = {}
    for (a, b, name), c in zip(kernels, credit):
        r = per_name.setdefault(name, [0.0, 0.0, 0])
        r[0], r[1], r[2] = r[0] + c, r[1] + (b - a), r[2] + 1
    rows = sorted(((c / steps, t / steps, n / steps, name) for name, (c, t, n) in per_name.items()), reverse=True)
    busy_us = sum(credit) / steps
    lora = ", LoRA r=8 on q and v" if cfg.lora else ""
    print(f"7B int4 serving step{lora}, {cfg.n_layer} layers, B={B} slots, S={seq}, positions from {prompt}, "
          f"{chunk} steps per sync: wall {wall_us:.1f} us/step ({B * 1e6 / wall_us:.1f} tok/s aggregate), "
          f"device busy {busy_us:.1f} us ({100 * busy_us / wall_us:.1f} % of the wall time; the union of the "
          f"kernels' intervals)")
    for c, t, count, name in rows:
        print(f"  {c:9.1f} us/step credited  {t:9.1f} us/step own  {count:6.1f} launches/step  {name[:100]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="the directory to import lit_llama_tpu_torch from")
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, nargs="+", default=[8, 32])
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=8, help="decode steps per host sync")
    ap.add_argument("--chunks", type=int, default=3, help="chunks timed and profiled")
    ap.add_argument("--lora", action="store_true", help="a LoRA overlay (K7's LoRA operand)")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch

    from lit_llama_tpu_torch import LLaMAConfig, LoRAConfig
    from lit_llama_tpu_torch.models import llama
    from lit_llama_tpu_torch.ops import fused_layer
    from lit_llama_tpu_torch.peft.lora import load_lora_state
    from lit_llama_tpu_torch.utils.device import resolve_device
    from lit_llama_tpu_torch.utils.random_params import random_int4_params, random_lora_overlay

    dev = resolve_device(None)
    cfg = LLaMAConfig.from_name("7B", n_layer=args.layers, param_dtype="bfloat16", compute_dtype="bfloat16",
                                quantize="int4", lora=LoRAConfig(r=8, alpha=16.0, dropout=0.0) if args.lora else None)
    params = random_int4_params(cfg, seed=0, device=dev)
    if args.lora:
        params = load_lora_state(params, random_lora_overlay(cfg, seed=1, device=dev))
    params, cfg = fused_layer.prepare_fused_params(llama.unstack_layers(params), cfg)
    print(torch.cuda.get_device_name(0), "|", devtime.card_name_and_power_limit())
    for B in args.batch:
        profile_batch(params, cfg, B, args.seq, args.prompt, args.chunk, args.chunks)


if __name__ == "__main__":
    main()
