"""Where one decode token's time goes on the card.

    python -m lit_llama_tpu_torch.tools.profile_decode [--layers 32] [--seq 2048] [--pos 1000]

Builds the 7B int4 model on random weights, runs decode steps (each block one
``decode_layers_fused`` call, then ``lm_head_fused``) at ``--pos`` against an
S = ``--seq`` cache, and prints: the host wall time of a step (ending in a
synchronise), the device time per kernel name from ``torch.profiler``, and
the device's busy share of the step (kernel time / wall time). Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import time

import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--pos", type=int, default=1000)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()

    from lit_llama_tpu_torch import LLaMAConfig
    from lit_llama_tpu_torch.models import llama
    from lit_llama_tpu_torch.ops import fused_layer
    from lit_llama_tpu_torch.ops.rope import build_rope_cache, rope_half_row
    from lit_llama_tpu_torch.utils.device import resolve_device
    from lit_llama_tpu_torch.utils.random_params import random_int4_params

    dev = resolve_device(None)
    cfg = LLaMAConfig.from_name("7B", n_layer=args.layers, param_dtype="bfloat16",
                                compute_dtype="bfloat16", quantize="int4")
    params, cfg = fused_layer.prepare_fused_params(
        llama.unstack_layers(random_int4_params(cfg, seed=0, device=dev)), cfg)
    cache = llama.init_kv_cache(cfg, 1, args.seq, device=dev)
    rope = build_rope_cache(cfg.block_size, cfg.head_size, device=dev)
    cos, sin = rope_half_row(rope, min(args.pos, cfg.block_size - 1), cfg.head_size)
    tok = torch.tensor([1], device=dev)

    def step():
        x = params["wte"][tok]
        for lp, kv in zip(params["h"], cache):
            x, _ = fused_layer.decode_layers_fused(
                x, [lp], [kv], cos, sin, args.pos % args.seq, args.pos, cfg)
        return fused_layer.lm_head_fused(x, params["ln_f"], params["lm_head"], cfg)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        step()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) / args.steps * 1e6

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / args.steps, evt.count // args.steps, evt.key))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    print(torch.cuda.get_device_name(0))
    print(f"7B int4 decode step, {args.layers} layers, S={args.seq}, pos={args.pos}: "
          f"wall {wall_us:.1f} us/step ({1e6 / wall_us:.1f} tok/s), device busy {busy_us:.1f} us "
          f"({100 * busy_us / wall_us:.1f} % of the wall time)")
    for us, count, name in rows:
        print(f"  {us:9.1f} us/step  {count:4d} launches/step  {name[:100]}")

    # the gemv launches of a step come in a fixed order: per block c_attn,
    # attn c_proj, c_fc12, mlp c_proj; then the lm_head
    roles = ["c_attn", "attn.c_proj", "c_fc12", "mlp.c_proj"] * args.layers + ["lm_head"]
    kernels = sorted(
        (e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda e: e.time_range.start,
    )
    gemvs = [e for e in kernels if "gemv_int4" in e.name]
    per_role = {}
    for i, e in enumerate(gemvs):
        per_role.setdefault(roles[i % len(roles)], []).append(e.time_range.elapsed_us())
    for role, ts in per_role.items():
        print(f"  gemv {role:12s} mean {sum(ts) / len(ts):8.1f} us over {len(ts)} launches")


if __name__ == "__main__":
    main()
