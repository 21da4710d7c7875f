"""Where one decode token's time goes on the card.

    python lit_llama_tpu_torch/tools/profile_decode.py [--root DIR] [--quantize int4|int8] [--kv int8]
        [--lora] [--layers 32] [--seq 2048] [--pos 1000]

Builds the 7B model on random weights and runs decode steps at ``--pos``
against an S = ``--seq`` cache. ``--quantize int4`` (the default) takes the
fused step (each block one ``decode_layers_fused`` call, then
``lm_head_fused``); ``--quantize int8`` the per-op step
(``llama.forward(input_pos=[pos])``: K6 for every linear, K5 for the
attention), with ``--kv int8`` on the int8 KV cache; ``--quantize int4 --kv
int8`` the per-op int4 step (as ``generate`` takes it for an int4 model on an
int8 cache: K3 at M = 1 for every linear, K5). ``--lora`` (int4) adds a
seeded LoRA overlay (r = 8, alpha 16, q and v), which the fused step takes
as K1's LoRA operand. Run as a file: ``--root DIR`` imports
``lit_llama_tpu_torch`` from DIR, so another checkout (the parent commit
unpacked under ``build/``) is read by the same tool in the same call.

Prints the host wall time of a step (ending in a synchronise); from
``torch.profiler``, the device's busy time (the union of the kernels'
intervals: kernels launched early by programmatic dependent launch overlap
the one before, so a sum would count that time twice) and its share of the
wall time; per kernel name, the device time credited to it (each instant of
the union goes to the earliest-started kernel still running, the one a
dependent launch waits on) beside the sum of its own intervals; the mean
interval and credited time of each int4 matvec launch by its role in the
block (``gemv_sm90`` in both compute dtypes, or ``gemv_int4`` in f32 in a
checkout before it; K6's
``gemv8_kernel`` per op, or ``int8_gemv_kernel`` in a checkout before it;
K3's ``gemv4_kernel`` per op, or the prefill mainloop ``wq_gemm_kernel`` in
a checkout before it), the matvec's share of the busy time and, int4, the
bytes it reads a token (the decode layout in the fused step, the packed
weights per op) over its credited time; per op, K6's or K3's kernels a step
(its matvec and, in the earlier bodies, the split sum
``splitk_reduce_kernel`` that followed a split launch) and their credited
time; and the host's own time per operator name (where a host-bound step
spends it).
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

# the matvec kernels of the steps: K1/K2's int4 bodies, K6's int8 one, K3's per-op int4 one
GEMV_NAMES = {"int4": ("gemv_int4", "gemv_sm90"), "int8": ("int8_gemv", "gemv8_kernel"),
              "int4 per op": ("wq_gemm", "gemv4_kernel")}
SPLIT_SUM = "splitk_reduce"  # the earlier M = 1 bodies' second kernel (the per-op step runs no other)
LINEARS = (("attn", "c_attn"), ("attn", "c_proj"), ("mlp", "c_fc12"), ("mlp", "c_proj"))
HBM_TB_S = 3.35  # H100 SXM HBM3


def credited(intervals):
    """Per interval (start, end), sorted by start: the part of it that no
    earlier-started interval covers. The credits sum to the union."""
    out, reach = [], float("-inf")
    for start, end in intervals:
        out.append(max(0.0, end - max(start, reach)))
        reach = max(reach, end)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="the directory to import lit_llama_tpu_torch from")
    ap.add_argument("--quantize", choices=("int4", "int8"), default="int4")
    ap.add_argument("--kv", choices=("int8",), default=None, help="KV cache dtype (per-op step only)")
    ap.add_argument("--lora", action="store_true", help="a LoRA overlay on the int4 model (K1's LoRA operand)")
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--pos", type=int, default=1000)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    if args.lora and (args.quantize != "int4" or args.kv):
        ap.error("--lora goes with --quantize int4 and a plain cache (the fused step)")
    kind = "int4 per op" if args.quantize == "int4" and args.kv else args.quantize
    sys.path.insert(0, args.root)
    import torch

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
    if kind == "int4":
        params = random_int4_params(cfg, seed=0, device=dev)
        if args.lora:
            params = load_lora_state(params, random_lora_overlay(cfg, seed=1, device=dev))
        params, cfg = fused_layer.prepare_fused_params(llama.unstack_layers(params), cfg)
        cache = llama.init_kv_cache(cfg, 1, args.seq, device=dev)
        cos, sin = rope_half_row(rope, min(args.pos, cfg.block_size - 1), cfg.head_size)

        def step():
            x = params["wte"][tok]
            for lp, kv in zip(params["h"], cache):
                x, _ = fused_layer.decode_layers_fused(
                    x, [lp], [kv], cos, sin, args.pos % args.seq, args.pos, cfg)
            return fused_layer.lm_head_fused(x, params["ln_f"], params["lm_head"], cfg)
    else:
        random_params = random_int4_params if args.quantize == "int4" else random_int8_params
        params = llama.unstack_layers(random_params(cfg, seed=0, device=dev))
        cache = llama.init_kv_cache(cfg, 1, args.seq, device=dev)
        pos = min(args.pos, args.seq - 1)  # inside the cache: a position past S would roll it every step

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
    kernels = sorted(
        ((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA),
    )
    credit = credited([(a, b) for a, b, _ in kernels])
    per_name = {}
    for (a, b, name), c in zip(kernels, credit):
        r = per_name.setdefault(name, [0.0, 0.0, 0])
        r[0], r[1], r[2] = r[0] + c, r[1] + (b - a), r[2] + 1
    rows = sorted(((c / args.steps, t / args.steps, n // args.steps, name) for name, (c, t, n) in per_name.items()),
                  reverse=True)
    host_rows = sorted(((e.self_cpu_time_total / args.steps, e.count // args.steps, e.key)
                        for e in prof.key_averages() if e.self_cpu_time_total > 0), reverse=True)
    busy_us = sum(credit) / args.steps
    print(torch.cuda.get_device_name(0))
    kv = (f", {args.kv} KV cache" if args.kv else "") + (", LoRA r=8 on q and v" if args.lora else "")
    print(f"7B {kind} decode step{kv}, {args.layers} layers, S={args.seq}, pos={args.pos}: "
          f"wall {wall_us:.1f} us/step ({1e6 / wall_us:.1f} tok/s), device busy {busy_us:.1f} us "
          f"({100 * busy_us / wall_us:.1f} % of the wall time; the union of the kernels' intervals)")
    for cred, tot, count, name in rows:
        print(f"  {cred:9.1f} us/step credited  {tot:9.1f} us/step in its intervals  {count:4d} launches/step  "
              f"{name[:90]}")

    # the matvec launches of a step come in a fixed order: per block c_attn,
    # attn c_proj, c_fc12, mlp c_proj; then the lm_head
    roles = ["c_attn", "attn.c_proj", "c_fc12", "mlp.c_proj"] * args.layers + ["lm_head"]
    gemvs = [(b - a, c) for (a, b, name), c in zip(kernels, credit)
             if any(g in name for g in GEMV_NAMES[kind])]
    assert gemvs, f"no matvec kernel ({GEMV_NAMES[kind]}) in the trace"
    per_role = {}
    for i, (span, c) in enumerate(gemvs):
        per_role.setdefault(roles[i % len(roles)], []).append((span, c))
    for role, ts in per_role.items():
        print(f"  gemv {role:12s} mean {sum(t for t, _ in ts) / len(ts):8.1f} us in its interval, "
              f"{sum(c for _, c in ts) / len(ts):8.1f} us credited, over {len(ts)} launches")
    gemv_us = sum(c for _, c in gemvs) / args.steps
    print(f"  gemv in all: {gemv_us:.1f} us/step credited, {100 * gemv_us / busy_us:.1f} % of the busy time")
    if kind != "int4":  # K6's or K3's kernels: the matvec (and the earlier bodies' split sums)
        sums = [c for (a, b, name), c in zip(kernels, credit) if SPLIT_SUM in name]
        print(f"  {'K6' if kind == 'int8' else 'K3'}: {(len(gemvs) + len(sums)) / args.steps:.1f} kernels/step "
              f"({len(gemvs) / args.steps:.1f} matvec, {len(sums) / args.steps:.1f} split sum), "
              f"{(gemv_us * args.steps + sum(sums)) / args.steps:.1f} us/step credited")
    if args.quantize == "int4":  # the weight bytes the matvec reads, once a token
        linears = [lp[a][b] for lp in params["h"] for a, b in LINEARS] + [params["lm_head"]]
        keys = ("qw_t", "qscale_t", "qzero_t") if kind == "int4" else ("qw", "qscale", "qzero")
        nbytes = sum(w[k].nbytes for w in linears for k in keys)
        print(f"  gemv reads {nbytes / 1e6:.1f} MB a token: {nbytes / gemv_us / 1e6:.3f} TB/s credited, "
              f"{100 * nbytes / gemv_us / 1e6 / HBM_TB_S:.1f} % of {HBM_TB_S} TB/s")
    print(f"host, self time per operator under the profiler ({sum(r[0] for r in host_rows):.1f} us/step in all):")
    for us, count, name in host_rows[:12]:
        print(f"  {us:9.1f} us/step  {count:4d} calls/step  {name[:100]}")


if __name__ == "__main__":
    main()
