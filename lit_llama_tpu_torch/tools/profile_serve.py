"""Where one batched serving step's time goes on the card.

    python -m lit_llama_tpu_torch.tools.profile_serve [--layers 32] [--seq 256] [--batch 8 32]

Builds the 7B int4 model on random weights and, for each ``--batch`` B, a
``DecodeEngine`` of B slots whose slots all hold a running request (prompts of
``--prompt`` tokens). It then runs decode chunks through the engine's own
``_step`` (``llama.forward(slot_pos=...)``: K7, K8 and K9 per block, K3 for
the lm_head, argmax on the device) and prints: the host wall time of a step
(ending in the chunk's copy to the host), the device time per kernel name from
``torch.profiler``, and the device's busy share of the step (kernel time /
wall time). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def profile_batch(params, cfg, B: int, seq: int, prompt: int, chunk: int, chunks: int) -> None:
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
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / steps, evt.count / steps, evt.key))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    print(f"7B int4 serving step, {cfg.n_layer} layers, B={B} slots, S={seq}, positions from {prompt}, "
          f"{chunk} steps per sync: wall {wall_us:.1f} us/step ({B * 1e6 / wall_us:.1f} tok/s aggregate), "
          f"device busy {busy_us:.1f} us ({100 * busy_us / wall_us:.1f} % of the wall time)")
    for us, count, name in rows:
        print(f"  {us:9.1f} us/step  {count:6.1f} launches/step  {name[:100]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, nargs="+", default=[8, 32])
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=8, help="decode steps per host sync")
    ap.add_argument("--chunks", type=int, default=3, help="chunks timed and profiled")
    args = ap.parse_args()

    from lit_llama_tpu_torch import LLaMAConfig
    from lit_llama_tpu_torch.models import llama
    from lit_llama_tpu_torch.ops import fused_layer
    from lit_llama_tpu_torch.utils.device import resolve_device
    from lit_llama_tpu_torch.utils.random_params import random_int4_params

    dev = resolve_device(None)
    cfg = LLaMAConfig.from_name("7B", n_layer=args.layers, param_dtype="bfloat16",
                                compute_dtype="bfloat16", quantize="int4")
    params, cfg = fused_layer.prepare_fused_params(
        llama.unstack_layers(random_int4_params(cfg, seed=0, device=dev)), cfg)
    print(torch.cuda.get_device_name(0))
    for B in args.batch:
        profile_batch(params, cfg, B, args.seq, args.prompt, args.chunk, args.chunks)


if __name__ == "__main__":
    main()
