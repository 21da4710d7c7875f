"""Device time of the prefill GEMMs, K3 (int4) and K6 (int8) at M > 1, on the
five 7B linears, beside torch.matmul on the dequantized bf16 weight and the
least time the card could take.

    python lit_llama_tpu_torch/tools/profile_gemm.py [--root DIR] [--prefill] [--tag NAME] [--m 1 8 128 200]

Run as a file: ``--root DIR`` imports ``lit_llama_tpu_torch`` from DIR (its
kernels build beside it), so another checkout, such as the parent commit
unpacked under ``build/``, is timed on the same card in the same call; the
repo root is the default. Weights are random (seeded), quantized with the
package's own ``quantize_int4`` (gs 128) and ``quantize_int8``. Each time is
the median device time of 20 launches (CUDA events, the L2 flushed before
each, a spin on the card ahead of the start event so the host's time in the
wrapper is not counted). ``--prefill`` also times, on the host's clock,
``generate`` of one token after prompts of 8, 128 and 200 tokens on the
32-layer 7B int4 model, and of 8 and 128 tokens on the int8 model (the
prefill, which takes 129 K3 or K6 launches). Prints one JSON line. Needs a
CUDA card. ``--m`` names the M to time (8, 128 and 200 by default): M = 1 is
K3's single-token product on the per-op step (a model that takes no fused
step, such as an adapter model on GPTQ int4 weights, 4 L + 1 launches a
token) and K6's weight stream.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

LINEARS = (("c_attn", 4096, 12288), ("attn.c_proj", 4096, 4096), ("c_fc12", 4096, 22016),
           ("mlp.c_proj", 11008, 4096), ("lm_head", 4096, 32000))
BYTES_PER_S, BF16_OPS_PER_S = 3.35e12, 989e12  # H100 SXM: HBM3, dense bf16 tensor cores
GS = 128


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="the directory to import lit_llama_tpu_torch from")
    ap.add_argument("--prefill", action="store_true", help="also time the 7B int4 and int8 prefill end to end")
    ap.add_argument("--tag", default="", help="a name for this run in the output")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--m", type=int, nargs="+", default=(8, 128, 200), help="the token counts to time")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import devtime  # beside this file
    import torch

    if not torch.cuda.is_available():
        print("profile_gemm: no CUDA device", file=sys.stderr)
        return 1
    from lit_llama_tpu_torch.ops import _build, quant_matmul as qm
    from lit_llama_tpu_torch.ops.linear import dequantize_int4, dequantize_int8, quantize_int4, quantize_int8

    dev = torch.device("cuda")
    _build.build(["quant_matmul", "quant_matmul_int8"])
    g = torch.Generator().manual_seed(args.seed)
    time_us = devtime.make_timer(dev)

    def bound_us(nbytes, ops):
        return max(nbytes / BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e6

    shapes = {}
    for name, K, N in LINEARS:
        w = torch.randn(K, N, generator=g) * 0.02
        q4 = {k: v.to(dev) for k, v in quantize_int4(w, GS).items()}
        q8 = {k: v.to(dev) for k, v in quantize_int8(w).items()}
        w4, w8 = dequantize_int4(q4, torch.bfloat16), dequantize_int8(q8, torch.bfloat16)
        for M in args.m:
            x = torch.randn(M, K, generator=g).to(dev, torch.bfloat16)
            io = M * K * 2 + M * N * 2
            shapes[f"{name} {K}->{N} M={M}"] = dict(
                k3_us=time_us(lambda: qm.matmul_int4(x, q4["qw"], q4["qscale"], q4["qzero"])),
                k6_us=time_us(lambda: qm.matmul_int8(x, q8["qw"], q8["qscale"])),
                matmul_int4_weight_us=time_us(lambda: torch.matmul(x, w4)),
                matmul_int8_weight_us=time_us(lambda: torch.matmul(x, w8)),
                k3_bound_us=bound_us(io + K // 2 * N + 2 * (K // GS) * N * 4, 2 * M * K * N),
                k6_bound_us=bound_us(io + K * N + N * 4, 2 * M * K * N))
        del q4, q8, w4, w8
    out = {"tag": args.tag, "root": args.root, "device": torch.cuda.get_device_name(0),
           "nvidia_smi": devtime.card_name_and_power_limit(),
           "shapes": shapes}
    if args.prefill:
        out["prefill_ms"] = prefill_ms(torch, dev, args.seed)
    print(json.dumps(out))
    return 0


def prefill_ms(torch, dev, seed):
    """Host time of generate(prompt, 1 token) on the 7B models, median of 3."""
    from lit_llama_tpu_torch.models import generate as gen, llama
    from lit_llama_tpu_torch.models.config import LLaMAConfig
    from lit_llama_tpu_torch.ops import fused_layer
    from lit_llama_tpu_torch.utils.random_params import random_int4_params, random_int8_params

    g = torch.Generator().manual_seed(seed)
    res = {}
    for quant, prompts in (("int4", (8, 128, 200)), ("int8", (8, 128))):
        cfg = LLaMAConfig.from_name("7B", param_dtype="bfloat16", compute_dtype="bfloat16", quantize=quant)
        if quant == "int4":
            params, cfg = fused_layer.prepare_fused_params(
                llama.unstack_layers(random_int4_params(cfg, seed=seed, device=dev)), cfg)
        else:
            params = llama.unstack_layers(random_int8_params(cfg, seed=seed, device=dev))
        gen.generate(params, torch.randint(0, cfg.vocab_size, (8,), generator=g), 2, config=cfg, temperature=0.0)
        for T in prompts:
            prompt = torch.randint(0, cfg.vocab_size, (T,), generator=g)
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                gen.generate(params, prompt, 1, config=cfg, temperature=0.0)
                times.append((time.perf_counter() - t0) * 1e3)
            res[f"{quant} T={T}"] = sorted(times)[1]
        del params
        torch.cuda.empty_cache()
    return res


if __name__ == "__main__":
    sys.exit(main())
