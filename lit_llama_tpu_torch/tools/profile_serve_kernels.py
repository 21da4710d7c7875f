"""Device time of the serving step's block halves, K7 (block head) and K9
(block tail), beside the least time the card could take, each kernel they
launch, and two yardsticks for their four int4 products.

    python lit_llama_tpu_torch/tools/profile_serve_kernels.py [--root DIR] [--tag NAME] [--batch 1 8 32 128]

Run as a file: ``--root DIR`` imports ``lit_llama_tpu_torch`` from DIR (its
kernels build beside it), so another checkout, such as the parent commit
unpacked under ``build/``, is timed on the same card in the same call (run
A B B A); the repo root is the default. Weights are one block of the 7B
preset, random int4 from seed 0; inputs seeded normal bf16, slot positions
seeded uniform in [0, block_size).

For each slot count B (``--batch``): K7 without the LoRA operand and with
one at R8 = 16 and 128 (r = 8 and 64 on q and v), in bf16 and in f32; K9.
Each is timed twice, after an L2 flush that writes 128 MB (``us``, the way
``chip_smoke.py`` times: it leaves up to 50 MB of dirty lines that the timed
kernel's reads must first write back) and after one that reads 128 MB
(``us_clean_l2``); the median of 20 launches (``tools/devtime.py``).
``bound_us`` is the larger of the bytes over 3.35 TB/s and the tensor-core
operations over 989 TFLOP/s.

``kernels``: at B = 32 and 128, a torch.profiler trace of 20 calls of K7, K7
with the R8 = 16 operand and K9 (each after the reading flush): the median
device time of each kernel by its place in the entry's sequence, its start
after the previous one's end (negative where programmatic dependent launch
overlaps them), and the entry's first start to last end.

``products``: at each B, the four int4 products (c_attn, attn.c_proj,
c_fc12, mlp.c_proj) as ``torch.matmul`` of the bf16 rows with the
dequantized bf16 weight (``matmul_us``: a yardstick, never a route of the
port) and as K3 on the same rows (``k3_us``: the wgmma / TMA mainloop of
``csrc/gemm_sm90.cuh`` on the shared layout, the other route the products
could take), each after the reading flush, with each product's own bound.
Prints one JSON line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BYTES_PER_S, TC_FLOPS = 3.35e12, 989e12  # H100 SXM: HBM3, dense bf16 tensor cores
HS = 128


def int4_bytes(K: int, N: int, gs: int = 128) -> int:
    """The packed nibbles and the f32 scale and zero planes of an int4 linear."""
    return K // 2 * N + 2 * (K // gs) * N * 4


def bound_us(nbytes: float, ops: float) -> dict:
    b, o = nbytes / BYTES_PER_S * 1e6, ops / TC_FLOPS * 1e6
    return dict(bound_us=max(b, o), bound_by="bytes" if b >= o else "operations")


def k7_bound(B: int, D: int, R8: int = 0, lora_elt: int = 2) -> dict:
    """x and the norm weight in, c_attn, the cos/sin rows, qkv out, the LoRA
    operand; the QKV product and the operand's two products."""
    return bound_us(B * D * 2 + D * 2 + int4_bytes(D, 3 * D) + 2 * B * HS * 4 + B * 3 * D * 2
                    + (D * R8 + R8 * 3 * D) * lora_elt,
                    2 * B * D * 3 * D + 2 * B * (D * R8 + R8 * 3 * D))


def k9_bound(B: int, D: int, I: int) -> dict:
    """x and y in, the norm weight, the three linears, the new x out."""
    return bound_us(2 * B * D * 2 + D * 2 + int4_bytes(D, D) + int4_bytes(D, 2 * I) + int4_bytes(I, D) + B * D * 2,
                    2 * B * (D * D + 2 * I * D + I * D))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="the directory to import lit_llama_tpu_torch from")
    ap.add_argument("--tag", default="", help="a name for this run in the output")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 8, 32, 128])
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import devtime  # beside this file
    import torch

    if not torch.cuda.is_available():
        print("profile_serve_kernels: no CUDA device", file=sys.stderr)
        return 1
    from lit_llama_tpu_torch import LLaMAConfig, LoRAConfig
    from lit_llama_tpu_torch.models import llama
    from lit_llama_tpu_torch.ops import _build, fused_layer, quant_matmul
    from lit_llama_tpu_torch.ops.rope import build_rope_cache, slot_rope_rows
    from lit_llama_tpu_torch.utils.random_params import random_int4_params, random_lora_overlay

    dev = torch.device("cuda")
    _build.build(["serve_layer", "quant_matmul"])
    time_us = devtime.make_timer(dev)
    smi = devtime.card_name_and_power_limit()
    g = torch.Generator().manual_seed(args.seed)

    cfg7 = LLaMAConfig.from_name("7B", n_layer=1, param_dtype="bfloat16", compute_dtype="bfloat16", quantize="int4")
    params, cfg = fused_layer.prepare_fused_params(
        llama.unstack_layers(random_int4_params(cfg7, seed=args.seed, device=dev)), cfg7)
    D, I = cfg.n_embd, cfg.intermediate_size
    lp = params["h"][0]
    ca, cp, f12, mp = lp["attn"]["c_attn"], lp["attn"]["c_proj"], lp["mlp"]["c_fc12"], lp["mlp"]["c_proj"]
    heads = {"": (ca, cfg, 0, 2)}
    for r in (8, 64):
        lc = LoRAConfig(r=r, alpha=16.0, dropout=0.0)
        ov = random_lora_overlay(cfg7.replace(param_dtype="float32", lora=lc), seed=args.seed + r,
                                 device=dev)["h"]["attn"]["c_attn"]
        op = fused_layer.prepare_lora_operands({**ca, "lora_a": ov["lora_a"][0], "lora_b": ov["lora_b"][0]}, lc, D, HS)
        R8 = op["lora_af"].shape[1]
        for dt, elt in ((torch.bfloat16, 2), (torch.float32, 4)):
            cal = {**op, "lora_af": op["lora_af"].to(dt), "lora_bf": op["lora_bf"].to(dt)}
            heads[f" LoRA R8={R8} {'bf16' if elt == 2 else 'f32'}"] = (cal, cfg.replace(lora=lc), R8, elt)
    rope = build_rope_cache(cfg.block_size, HS, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=g).to(dev, torch.bfloat16)

    def dequant(w):
        """The shared (K/2, N) layout as a bf16 (K, N) weight."""
        qw, qs, qz = w["qw"], w["qscale"], w["qzero"]
        Kh, N = qw.shape
        G = qs.shape[0]
        gs = 2 * Kh // G
        q = torch.cat([qw & 0xF, qw >> 4]).float().reshape(G, gs, N)
        return (q * qs[:, None] + qz[:, None]).reshape(2 * Kh, N).to(torch.bfloat16)

    products = {"c_attn": ca, "attn.c_proj": cp, "c_fc12": f12, "mlp.c_proj": mp}
    dense = {k: dequant(w) for k, w in products.items()}
    out = dict(k7={}, k9={}, kernels={}, products={})
    for B in args.batch:
        pos = torch.randint(0, cfg.block_size, (B,), generator=g).to(dev, torch.int32)
        cos, sin = slot_rope_rows(rope, pos)
        x, y = randn(B, D), randn(B, D)
        for tag, (cah, c, R8, elt) in heads.items():
            call = lambda cah=cah, c=c: fused_layer.block_head_fused(x, lp["rms_1"], cos, sin, cah, c)
            out["k7"][f"B={B}{tag}"] = dict(us=time_us(call), us_clean_l2=time_us(call, clean=True),
                                            **k7_bound(B, D, R8, elt))
        tail = lambda: fused_layer.block_tail_fused(x, y, lp["rms_2"], cp, f12, mp, cfg)
        out["k9"][f"B={B}"] = dict(us=time_us(tail), us_clean_l2=time_us(tail, clean=True), **k9_bound(B, D, I))
        if B in (32, 128):
            cal, cl = heads[" LoRA R8=16 bf16"][:2]
            for key, call in ((f"K7 B={B}", lambda: fused_layer.block_head_fused(x, lp["rms_1"], cos, sin, ca, cfg)),
                              (f"K7 LoRA R8=16 B={B}",
                               lambda: fused_layer.block_head_fused(x, lp["rms_1"], cos, sin, cal, cl)),
                              (f"K9 B={B}", tail)):
                try:
                    out["kernels"][key] = devtime.kernel_sequence(call, time_us)
                except RuntimeError as e:  # the trace kept dropping records: say so, time the rest
                    out["kernels"][key] = dict(error=str(e))
        for name, w in products.items():
            K, N = 2 * w["qw"].shape[0], w["qw"].shape[1]
            rows = randn(B, K)
            out["products"][f"{name} B={B}"] = dict(
                K=K, N=N, matmul_us=time_us(lambda: torch.matmul(rows, dense[name]), clean=True),
                k3_us=time_us(lambda: quant_matmul.matmul_int4(rows, w["qw"], w["qscale"], w["qzero"]), clean=True),
                **bound_us(B * K * 2 + int4_bytes(K, N) + B * N * 2, 2 * B * K * N))
    print(json.dumps({"tag": args.tag, "root": args.root, "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
