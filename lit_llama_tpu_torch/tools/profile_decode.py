"""Where one decode token's time goes on the card.

    python -m lit_llama_tpu_torch.tools.profile_decode [--quantize int4|int8] [--kv int8] [--lora]
        [--layers 32] [--seq 2048] [--pos 1000]

Builds the 7B model on random weights and runs decode steps at ``--pos``
against an S = ``--seq`` cache. ``--quantize int4`` (the default) takes the
fused step (each block one ``decode_layers_fused`` call, then
``lm_head_fused``); ``--quantize int8`` the per-op step
(``llama.forward(input_pos=[pos])``: K6 for every linear, K5 for the
attention), with ``--kv int8`` on the int8 KV cache. ``--lora`` (int4) adds a
seeded LoRA overlay (r = 8, alpha 16, q and v), which the fused step takes
as K1's LoRA operand. Prints the host wall time
of a step (ending in a synchronise), the device time per kernel name from
``torch.profiler``, the device's busy share of the step (kernel time / wall
time), the mean time of each linear's launches by its role in the block, and
the host's own time per operator name (where a host-bound step spends it).
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import time

import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quantize", choices=("int4", "int8"), default="int4")
    ap.add_argument("--kv", choices=("int8",), default=None, help="KV cache dtype (per-op step only)")
    ap.add_argument("--lora", action="store_true", help="a LoRA overlay on the int4 model (K1's LoRA operand)")
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--pos", type=int, default=1000)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    if args.kv and args.quantize == "int4":
        ap.error("--kv int8 goes with --quantize int8: the fused int4 step keeps a plain cache")
    if args.lora and args.quantize != "int4":
        ap.error("--lora goes with --quantize int4 (the fused step)")

    from lit_llama_tpu_torch import LLaMAConfig, LoRAConfig
    from lit_llama_tpu_torch.models import llama
    from lit_llama_tpu_torch.ops import fused_layer
    from lit_llama_tpu_torch.ops.rope import build_rope_cache, rope_half_row
    from lit_llama_tpu_torch.peft.lora import load_lora_state
    from lit_llama_tpu_torch.utils.device import resolve_device
    from lit_llama_tpu_torch.utils.random_params import random_int4_params, random_int8_params, random_lora_overlay

    dev = resolve_device(None)
    cfg = LLaMAConfig.from_name("7B", n_layer=args.layers, param_dtype="bfloat16", compute_dtype="bfloat16",
                                quantize=args.quantize, kv_cache_dtype=args.kv,
                                lora=LoRAConfig(r=8, alpha=16.0, dropout=0.0) if args.lora else None)
    rope = build_rope_cache(cfg.block_size, cfg.head_size, device=dev)
    tok = torch.tensor([1], device=dev)
    if args.quantize == "int4":
        params = random_int4_params(cfg, seed=0, device=dev)
        if args.lora:
            params = load_lora_state(params, random_lora_overlay(cfg, seed=1, device=dev))
        params, cfg = fused_layer.prepare_fused_params(llama.unstack_layers(params), cfg)
        cache = llama.init_kv_cache(cfg, 1, args.seq, device=dev)
        cos, sin = rope_half_row(rope, min(args.pos, cfg.block_size - 1), cfg.head_size)
        gemv_name = "gemv_int4"

        def step():
            x = params["wte"][tok]
            for lp, kv in zip(params["h"], cache):
                x, _ = fused_layer.decode_layers_fused(
                    x, [lp], [kv], cos, sin, args.pos % args.seq, args.pos, cfg)
            return fused_layer.lm_head_fused(x, params["ln_f"], params["lm_head"], cfg)
    else:
        params = llama.unstack_layers(random_int8_params(cfg, seed=0, device=dev))
        cache = llama.init_kv_cache(cfg, 1, args.seq, device=dev)
        pos = min(args.pos, args.seq - 1)  # inside the cache: a position past S would roll it every step
        gemv_name = "int8_gemv"

        def step():
            return llama.forward(params, tok[None], cfg, rope_cache=rope, input_pos=[pos], kv_cache=cache)[0]

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
    rows, host_rows = [], []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / args.steps, evt.count // args.steps, evt.key))
        if evt.self_cpu_time_total > 0:
            host_rows.append((evt.self_cpu_time_total / args.steps, evt.count // args.steps, evt.key))
    rows.sort(reverse=True)
    host_rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    print(torch.cuda.get_device_name(0))
    kv = (f", {args.kv} KV cache" if args.kv else "") + (", LoRA r=8 on q and v" if args.lora else "")
    print(f"7B {args.quantize} decode step{kv}, {args.layers} layers, S={args.seq}, pos={args.pos}: "
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
    gemvs = [e for e in kernels if gemv_name in e.name]
    per_role = {}
    for i, e in enumerate(gemvs):
        per_role.setdefault(roles[i % len(roles)], []).append(e.time_range.elapsed_us())
    for role, ts in per_role.items():
        print(f"  gemv {role:12s} mean {sum(ts) / len(ts):8.1f} us over {len(ts)} launches")
    print(f"host, self time per operator under the profiler ({sum(r[0] for r in host_rows):.1f} us/step in all):")
    for us, count, name in host_rows[:12]:
        print(f"  {us:9.1f} us/step  {count:4d} calls/step  {name[:100]}")


if __name__ == "__main__":
    main()
