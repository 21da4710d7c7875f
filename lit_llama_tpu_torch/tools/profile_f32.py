"""Device time of the f32 compute bodies, K3 f32 and K4 f32 first (GPTQ's
calibration forwards), then K6 at M > 1, K7 and K9 in f32 (which share K3's
f32 tile), each beside its plain version's error, one PyTorch call for the
same function and the least time the card could take.

    python lit_llama_tpu_torch/tools/profile_f32.py [--root DIR] [--tag NAME] [--only k3 k4 k6 k7_k9]

Run as a file: ``--root DIR`` imports ``lit_llama_tpu_torch`` from DIR (its
kernels build beside it), so another checkout, such as the parent commit
unpacked under ``build/``, is timed on the same card in the same call (run
A B B A); the repo root is the default. Inputs are seeded normal f32; the
weights random (seeded), quantized with the package's ``quantize_int4``
(gs 128) and ``quantize_int8``, K7 / K9 on one block of the 7B preset.

Shapes: K3 f32 at M = 8192 (calibration batch 4 x 2048) on GPTQ's five
linears of a 7B block, and at M = 8 and 128 on c_fc12 (4096 -> 22016); K4
f32 at (1, 32, 200, 128), (1, 32, 2048, 128), (4, 32, 2048, 128) (the
calibration batch) and (1, 16, 2048, 256); K6 f32 at M = 128 on c_fc12; K7
and K9 f32 at B = 32. Each time is the median device time of ``iters``
launches (``tools/devtime.py``: CUDA events, the L2 flushed by writing
128 MB before each, a spin on the card ahead of the start event). The
yardsticks: ``torch.matmul`` in f32 on the dequantized weight (with
``torch.backends.cuda.matmul.allow_tf32`` False, which the output records)
and SDPA in f32 with ``is_causal=True``, whose kernels the output names
from a torch.profiler trace. Bounds: bytes over 3.35 TB/s, operations over
67 TFLOP/s (f32 on the CUDA cores). Each output is held against its plain
version at 1e-4 + 1e-4 |plain| (``held``). ``--only`` picks the bodies to
time. Prints one JSON line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12  # H100 SXM: HBM3, f32 on the CUDA cores
TOL_F32 = (1e-4, 1e-4)
GS = 128
GPTQ_LINEARS = (("attn.c_attn", 4096, 12288), ("attn.c_proj", 4096, 4096), ("mlp.c_fc1", 4096, 11008),
                ("mlp.c_fc2", 4096, 11008), ("mlp.c_proj", 11008, 4096))
K4_SHAPES = ((1, 32, 200, 128), (1, 32, 2048, 128), (4, 32, 2048, 128), (1, 16, 2048, 256))


def bound_ms(nbytes: float, ops: float) -> dict:
    b, o = nbytes / BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(b, o), bound_by="bytes" if b >= o else "operations")


def int4_bytes(K: int, N: int, gs: int = GS) -> int:
    return K // 2 * N + 2 * (K // gs) * N * 4


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="the directory to import lit_llama_tpu_torch from")
    ap.add_argument("--tag", default="", help="a name for this run in the output")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", nargs="+", choices=("k3", "k4", "k6", "k7_k9"), default=("k3", "k4", "k6", "k7_k9"),
                    help="time these bodies only")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import devtime  # beside this file
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("profile_f32: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from lit_llama_tpu_torch import LLaMAConfig
    from lit_llama_tpu_torch.models import llama
    from lit_llama_tpu_torch.ops import _build, fused_layer, quant_matmul as qm
    from lit_llama_tpu_torch.ops import flash_attention as fa
    from lit_llama_tpu_torch.ops.linear import dequantize_int4, dequantize_int8, quantize_int4, quantize_int8
    from lit_llama_tpu_torch.ops.rope import build_rope_cache, slot_rope_rows
    from lit_llama_tpu_torch.utils.random_params import random_int4_params
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    _build.build(["quant_matmul", "quant_matmul_int8", "flash_attention", "serve_layer"])
    timer = devtime.make_timer(dev)
    g = torch.Generator().manual_seed(args.seed)

    def time_ms(fn, iters):
        return timer(fn, iters) / 1e3

    def err(got, want):
        got, want = got.float(), want.float()
        e = (got - want).abs()
        return dict(max_abs_err=float(e.max()), held=bool(torch.isfinite(got).all())
                    and bool((e <= TOL_F32[0] + TOL_F32[1] * want.abs()).all()))

    def kernel_names(fn):
        names = []
        for _ in range(3):  # a trace may come back empty (devtime.kernel_sequence)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            names = sorted({e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA})
            if names:
                break
        return names

    def randf(*shape):
        return torch.randn(shape, generator=g).to(dev)

    out = {"tag": args.tag, "root": args.root, "device": torch.cuda.get_device_name(0),
           "nvidia_smi": devtime.card_name_and_power_limit(),
           "allow_tf32": {"cuda.matmul": torch.backends.cuda.matmul.allow_tf32,
                          "cudnn": torch.backends.cudnn.allow_tf32,
                          "float32_matmul_precision": torch.get_float32_matmul_precision()},
           "k3_f32": {}, "k4_f32": {}, "k6_f32": {}, "k7_k9_f32": {}}

    c_fc12 = ("c_fc12", 4096, 22016)
    for (name, K, N), Ms in ([(lin, (8192,)) for lin in GPTQ_LINEARS] + [(c_fc12, (8, 128))]) * ("k3" in args.only):
        q = {k: v.to(dev) for k, v in quantize_int4(torch.randn(K, N, generator=g) * 0.02, GS).items()}
        wd = dequantize_int4(q, torch.float32)
        for M in Ms:
            x = randf(M, K)
            args4 = (x, q["qw"], q["qscale"], q["qzero"], torch.float32)
            iters = 5 if M > 1024 else 20
            out["k3_f32"][f"{name} {K}->{N} M={M}"] = dict(
                ms=time_ms(lambda: qm.matmul_int4(*args4), iters),
                matmul_ms=time_ms(lambda: torch.matmul(x, wd), iters),
                **err(qm.matmul_int4(*args4), qm.matmul_int4_ref(*args4)),
                **bound_ms(M * K * 4 + int4_bytes(K, N) + M * N * 4, 2 * M * K * N))
            del x
        del q, wd
        torch.cuda.empty_cache()

    for B, H, T, hs in K4_SHAPES * ("k4" in args.only):
        qkv = [randf(B, H, T, hs) for _ in range(3)]
        rows, pairs = B * H * T, B * H * T * (T + 1) // 2
        o, lse = fa.flash_attention(*qkv)
        ro, rlse = fa.flash_attention_ref(*qkv)
        e_o, e_l = err(o, ro), err(lse, rlse)
        del o, lse, ro, rlse
        sdpa = lambda: F.scaled_dot_product_attention(*qkv, is_causal=True)
        out["k4_f32"][f"({B}, {H}, {T}, {hs})"] = dict(
            ms=time_ms(lambda: fa.flash_attention(*qkv), 5 if T > 1024 else 20),
            sdpa_ms=time_ms(sdpa, 5 if T > 1024 else 20), sdpa_kernels=kernel_names(sdpa),
            max_abs_err=max(e_o["max_abs_err"], e_l["max_abs_err"]), held=e_o["held"] and e_l["held"],
            **bound_ms(4 * rows * hs * 4 + rows * 4, 4 * hs * pairs))
        del qkv
        torch.cuda.empty_cache()

    K, N = 4096, 22016
    q8 = {k: v.to(dev) for k, v in quantize_int8(torch.randn(K, N, generator=g) * 0.02).items()}
    wd8 = dequantize_int8(q8, torch.float32)
    for M in (128,) * ("k6" in args.only):
        x = randf(M, K)
        args8 = (x, q8["qw"], q8["qscale"], torch.float32)
        out["k6_f32"][f"c_fc12 {K}->{N} M={M}"] = dict(
            ms=time_ms(lambda: qm.matmul_int8(*args8), 20), matmul_ms=time_ms(lambda: torch.matmul(x, wd8), 20),
            **err(qm.matmul_int8(*args8), qm.matmul_int8_ref(*args8)),
            **bound_ms(M * K * 4 + K * N + N * 4 + M * N * 4, 2 * M * K * N))
    del q8, wd8

    cfg7 = LLaMAConfig.from_name("7B", n_layer=1, param_dtype="bfloat16", compute_dtype="bfloat16", quantize="int4")
    params, cfg = fused_layer.prepare_fused_params(
        llama.unstack_layers(random_int4_params(cfg7, seed=args.seed, device=dev)), cfg7)
    cfg32 = cfg.replace(compute_dtype="float32")
    D, I, hs = cfg.n_embd, cfg.intermediate_size, cfg.head_size
    lp = params["h"][0]
    rope = build_rope_cache(cfg.block_size, hs, device=dev)
    for B in (32,) * ("k7_k9" in args.only):
        x, y = randf(B, D), randf(B, D)
        pos = torch.randint(0, cfg.block_size, (B,), generator=g).to(dev, torch.int32)
        cos, sin = slot_rope_rows(rope, pos)
        ha = (x, lp["rms_1"], cos, sin, lp["attn"]["c_attn"], cfg32)
        ta = (x, y, lp["rms_2"], lp["attn"]["c_proj"], lp["mlp"]["c_fc12"], lp["mlp"]["c_proj"], cfg32)
        out["k7_k9_f32"][f"K7 B={B}"] = dict(
            ms=time_ms(lambda: fused_layer.block_head_fused(*ha), 20),
            **err(fused_layer.block_head_fused(*ha), fused_layer.block_head_fused_ref(*ha)),
            **bound_ms(B * D * 4 + D * 2 + int4_bytes(D, 3 * D) + 2 * B * hs * 4 + B * 3 * D * 4,
                       2 * B * D * 3 * D))
        out["k7_k9_f32"][f"K9 B={B}"] = dict(
            ms=time_ms(lambda: fused_layer.block_tail_fused(*ta), 20),
            **err(fused_layer.block_tail_fused(*ta), fused_layer.block_tail_fused_ref(*ta)),
            **bound_ms(2 * B * D * 4 + D * 2 + int4_bytes(D, D) + int4_bytes(D, 2 * I) + int4_bytes(I, D) + B * D * 4,
                       2 * B * (D * D + 2 * I * D + I * D)))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
