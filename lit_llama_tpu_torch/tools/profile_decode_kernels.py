"""Device time of the single-stream decode kernels, K5 (decode attention), K1
(one fused decode block, and each kernel it launches), K2 (the lm_head), K6
at M = 1 (the int8 matvec of the per-op step) and K3 at M = 1 (its int4
matvec), beside the least time the card could take and, for K5, PyTorch's
scaled_dot_product_attention, for K6 and K3 ``torch.matmul`` on the
dequantized weight.

    python lit_llama_tpu_torch/tools/profile_decode_kernels.py [--root DIR] [--tag NAME]
        [--only k5 k1 k2 k6 k3] [--scan | --accuracy]

Run as a file: ``--root DIR`` imports ``lit_llama_tpu_torch`` from DIR (its
kernels build beside it), so another checkout, such as the parent commit
unpacked under ``build/``, is timed on the same card in the same call (run
A B B A); the repo root is the default. Weights are the 7B preset's, random
int4 from seed 0 (one block and the lm_head); inputs seeded normal bf16.

Each kernel is timed twice: after an L2 flush that writes 128 MB (the
way ``chip_smoke.py`` times, which leaves up to 50 MB of dirty lines that the
timed kernel's reads must first write back) and after one that reads 128 MB
(``_clean_l2``: a cold L2 of clean lines).

Shapes: K5 at (B, H, S) = (1, 32, 72), (1, 32, 256), (1, 32, 2048) and
(8, 32, 2048), hs 128, bf16 and int8 cache, every row visible, with SDPA on
the masked cache (the int8 one dequantized to bf16 first) beside it, and in
f32 compute (f32 q, an f32 cache or the int8 one, SDPA in f32) at
(1, 32, 2048) and (8, 32, 2048), hs 128, and (1, 16, 2048), hs 256, and past
head size 256 at (1, 8, 1024), hs 384 and 512, in bf16 compute (bf16 and
int8 cache) and f32 compute (f32 and int8 cache); K1 at
S = 256 (pos 255) and S = 2048 (pos 2047), without and with a LoRA operand
(r = 8 on q and v, R8 = 16), and in f32 compute (f32 row and cache) at
S = 2048; K2 at V = 32 000 in bf16 and in f32; K6 at M = 1 on the five 7B
int8 linears (c_attn, attn.c_proj, c_fc12, mlp.c_proj, lm_head) and an odd
shape (1000 -> 1040), in bf16 and in f32 compute (random int8 weights and
column scales from the seed), with the kernels a call launches (their names,
from a torch.profiler trace), the largest error against the plain version,
and a decoded token's sum (32 x the four block linears + the lm_head) beside
its bound; beside each, the time of a PyTorch reduction that reads the same
weight bytes once (``read_us``: what streaming them costs this timer), and
an empty timed region (``empty_us``); K3 at M = 1 the same way on the five
7B int4 linears (gs 128: random packed nibbles, scales and zeros from the
seed) and the odd shape 1024 -> 1040, its bound the packed bytes, the f32
scale and zero planes, x and the output. ``--only`` times a subset (K1 and K2 share one set-up; K1's
kernel trace comes with k1). Each time is the median
device time of 20 launches (CUDA events, the L2 flushed before each, a spin
on the card ahead of the start event so the host's time in the wrapper is not
counted). K1's own kernels are timed from a torch.profiler trace of 20 K1
calls at S = 2048 (each after an L2 flush), in bf16 and in f32: the median
device time of each launch by its place in the block's sequence, and the
gaps between them.
``--scan`` instead times K2 over V = 1024 .. 32 000 (the 7B lm_head's first
V columns) and K5 (bf16, B = 1, H = 32) over S = 256 .. 4096, after the
reading flush, beside an empty timed region: the time as a fixed part plus
a rate. ``--accuracy`` instead holds K5 (B = 8, S = 2048, the limits of the
card test ``test_decode_attention_kernel_rows_equal_alone_and_in_a_batch``,
hs 128 at H = 32 and hs 256 at H = 16) against its plain version and both
against the exact attention (f64, nothing rounded) on the same inputs:
a bf16 cache, rows quantized as the int8 cache holds them, and uniform
random int8 with random row scales (``c * U(0, 1)``, c = 0.01, 0.03, 0.1);
and in f32 compute (``f32_vs_f64``) K5 on an f32 cache and on uniform int8
(c = 0.01), K2 (final norm and lm_head) and one K1 block at S = 2048 (pos
2047, 1000 and 0; f32 row and cache), each kernel and its plain version
against the same function in f64 (the weights dequantized in f64, nothing
rounded): the largest error of each beside the largest |f64 value|.
``--bits`` instead prints, for the bf16 bodies (K1 at S = 2048, K2, K5 at
hs 128 and 256 on a bf16 and an int8 cache, K8 at 32 slots) and their f32
counterparts, a SHA-256 of the output (and of K1's and K8's written cache)
on seeded inputs and the call's time: two checkouts with the same bits give
the same hashes. ``--token`` instead times one decoded token of the 32-layer
7B int4 model (random weights from the seed) as ``chip_smoke.py`` phase 8i
decodes it, a K1 call a block and K2, at S = 2048 (pos 2047), in bf16 and
in f32 compute (f32 cache): the host's wall time a token over 20 tokens
ending in a synchronise, and the device time between CUDA events.
Prints one JSON line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

BYTES_PER_S = 3.35e12  # H100 SXM HBM3
H, HS = 32, 128  # the 7B preset's heads and head size
K5_SHAPES = ((1, 72), (1, 256), (1, 2048), (8, 2048))
K5_PAST_256 = ((1, 8, 1024, 384), (1, 8, 1024, 512))  # (B, H, S, hs) in both compute dtypes
K6_SHAPES = (("c_attn", 4096, 12288), ("attn.c_proj", 4096, 4096), ("c_fc12", 4096, 22016),
             ("mlp.c_proj", 11008, 4096), ("lm_head", 4096, 32000), ("odd", 1000, 1040))
K3_SHAPES = K6_SHAPES[:5] + (("odd", 1024, 1040),)
LAYERS = 32  # the 7B preset's blocks: a token runs each block linear 32 times
K1_SEQS = ((256, 255), (2048, 2047))


def int4_bytes(K: int, N: int, gs: int = 128) -> int:
    """The packed nibbles and the f32 scale and zero planes of an int4 linear."""
    return K // 2 * N + 2 * (K // gs) * N * 4


def k5_bytes(B: int, S: int, int8: bool, es: int = 2, heads: int = H, hs: int = HS) -> int:
    """k and v read once (with their f32 row scales on an int8 cache), q read
    and y written (es bytes an element: the compute dtype's), limit read."""
    rows = B * heads * S
    return 2 * rows * hs * (1 if int8 else es) + (2 * rows * 4 if int8 else 0) + 2 * B * heads * hs * es + B * 4


def k1_bytes(D: int, I: int, visible: int, R8: int = 0, es: int = 2) -> int:
    """A block's four int4 linears, its norm weights, the row in and out, the
    RoPE rows, the new k/v row, the visible cache (es bytes an element) and
    the LoRA operand."""
    w = int4_bytes(D, 3 * D) + int4_bytes(D, D) + int4_bytes(D, 2 * I) + int4_bytes(I, D)
    return (w + 2 * D * 2 + 2 * HS * 4 + 2 * D * es + 2 * H * HS * es + 2 * H * visible * HS * es
            + D * R8 * 2 + R8 * 3 * D * 2)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="the directory to import lit_llama_tpu_torch from")
    ap.add_argument("--tag", default="", help="a name for this run in the output")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", nargs="+", choices=("k5", "k1", "k2", "k6", "k3"),
                    default=("k5", "k1", "k2", "k6", "k3"),
                    help="the kernels to time (default: all)")
    ap.add_argument("--scan", action="store_true", help="K2 over V and K5 over S, clean L2")
    ap.add_argument("--accuracy", action="store_true", help="K5 against its plain version and the exact result")
    ap.add_argument("--bits", action="store_true", help="hashes of the bf16 and f32 bodies' outputs")
    ap.add_argument("--token", action="store_true", help="a 32-layer token as phase 8i decodes it")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import devtime  # beside this file
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("profile_decode_kernels: no CUDA device", file=sys.stderr)
        return 1
    from lit_llama_tpu_torch.models import llama
    from lit_llama_tpu_torch.ops import _build
    from lit_llama_tpu_torch.ops import decode_attention as da

    dev = torch.device("cuda")
    _build.build(["fused_layer", "decode_attention", "quant_matmul_int8", "quant_matmul"])
    g = torch.Generator().manual_seed(args.seed)
    time_us = devtime.make_timer(dev)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev, torch.bfloat16)

    def bound_us(nbytes):
        return nbytes / BYTES_PER_S * 1e6

    smi = devtime.card_name_and_power_limit()
    if args.scan:
        return scan(args, torch, time_us, randn, smi)
    if args.accuracy:
        return accuracy(args, torch, smi)
    if args.bits or args.token:
        out = {"tag": args.tag, "root": args.root, "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
        out.update(bits(args, torch, time_us, dev, da) if args.bits else token(args, torch, time_us, dev))
        print(json.dumps(out))
        return 0

    out = {"tag": args.tag, "root": args.root, "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    for kind in ("k6", "k3"):
        if kind in args.only:
            out[kind] = m1_times(args, torch, time_us, devtime, dev, bound_us, kind)
    if "k5" in args.only:
        out["k5"] = k5_times(torch, F, time_us, randn, bound_us, dev, llama, da)
    if "k1" in args.only or "k2" in args.only:
        out.update(k1_k2_times(args, torch, time_us, randn, bound_us, dev))
    print(json.dumps(out))
    return 0


def m1_times(args, torch, time_us, devtime, dev, bound_us, kind: str) -> dict:
    """K6 (``kind`` "k6", on K6_SHAPES) or K3 ("k3", on K3_SHAPES) at M = 1
    in both compute dtypes: device time (writing and reading L2 flush),
    torch.matmul on the weight dequantized to the compute dtype, the bound,
    the kernels of a call, the largest error against the plain version; and
    a decoded token's sum."""
    from lit_llama_tpu_torch.ops import quant_matmul as qm
    from lit_llama_tpu_torch.ops.linear import dequantize_int4, dequantize_int8

    g = torch.Generator(device=dev).manual_seed(args.seed)
    int8 = kind == "k6"
    fn, ref, dequant = ((qm.matmul_int8, qm.matmul_int8_ref, dequantize_int8) if int8 else
                        (qm.matmul_int4, qm.matmul_int4_ref, dequantize_int4))

    def weight(K, N):  # int8 weights and column scales, or int4 nibbles, scales and zeros at gs 128
        if int8:
            return {"qw": torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8),
                    "qscale": torch.empty(1, N, device=dev).uniform_(0.0002, 0.0004, generator=g)}
        return {"qw": torch.randint(0, 256, (K // 2, N), generator=g, device=dev, dtype=torch.uint8),
                "qscale": torch.empty(K // 128, N, device=dev).uniform_(0.0005, 0.0015, generator=g),
                "qzero": torch.empty(K // 128, N, device=dev).uniform_(-0.012, -0.006, generator=g)}

    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        xb = 2 if dtype == torch.bfloat16 else 4
        rows = {}
        for name, K, N in K6_SHAPES if int8 else K3_SHAPES:
            w = weight(K, N)
            x = torch.randn(1, K, generator=g, device=dev).to(dtype)
            wd = dequant(w, dtype)
            call = lambda: fn(x, *w.values(), dtype)
            err = float((call().float() - ref(x, *w.values(), dtype).float()).abs().max())
            try:  # a trace now and then comes back without the kernels
                kernels = [k["kernel"] for k in devtime.kernel_sequence(call, time_us)["sequence"]]
            except RuntimeError as e:
                kernels = str(e)
            nbytes = K * N + N * 4 if int8 else int4_bytes(K, N)
            rows[f"{name} {K}->{N}"] = dict(
                us=time_us(call), us_clean_l2=time_us(call, clean=True),
                matmul_us=time_us(lambda: torch.matmul(x, wd)), bound_us=bound_us(nbytes + (K + N) * xb),
                read_us=time_us(lambda: w["qw"].view(torch.int32).sum(dtype=torch.int32)),
                max_abs_err=err, kernels=kernels)
            del w, wd
        block = [r for k, r in rows.items() if not k.startswith(("lm_head", "odd"))]
        head = next(r for k, r in rows.items() if k.startswith("lm_head"))
        rows["token"] = {key: LAYERS * sum(r[key] for r in block) + head[key]
                         for key in ("us", "us_clean_l2", "matmul_us", "bound_us", "read_us")}
        rows["token"]["launches"] = 4 * LAYERS + 1
        res["bf16" if dtype == torch.bfloat16 else "f32"] = rows
    res["empty_us"] = time_us(lambda: None)
    return res


def k5_times(torch, F, time_us, randn, bound_us, dev, llama, da) -> dict:
    k5 = {}
    for B, S in K5_SHAPES:
        q = randn(B, 1, H, HS).transpose(1, 2)  # (B, H, 1, hs) as the model hands it over
        kf, vf = randn(B, H, S, HS, scale=0.5), randn(B, H, S, HS, scale=0.5)
        (kq, ksc), (vq, vsc) = llama._quantize_kv(kf), llama._quantize_kv(vf)
        every = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
        vis = (torch.arange(S, device=dev)[None, :] <= every[:, None])[:, None, None, :]
        for name, (k, v, ks, vs) in (("bf16", (kf, vf, None, None)), ("int8", (kq, vq, ksc, vsc))):
            kd, vd = ((kq.float() * ksc).to(torch.bfloat16), (vq.float() * vsc).to(torch.bfloat16)) if ks is not None \
                else (kf, vf)
            k5_call = lambda: da.decode_attention(q, k, v, ks, vs, every)
            sdpa_call = lambda: F.scaled_dot_product_attention(q, kd, vd, attn_mask=vis)
            k5[f"{name} B={B} S={S}"] = dict(
                us=time_us(k5_call), sdpa_us=time_us(sdpa_call), us_clean_l2=time_us(k5_call, clean=True),
                sdpa_us_clean_l2=time_us(sdpa_call, clean=True), bound_us=bound_us(k5_bytes(B, S, ks is not None)))
            del kd, vd
        del kf, vf, kq, vq, ksc, vsc
    for B, heads, S, hs in ((1, H, 2048, HS), (8, H, 2048, HS), (1, 16, 2048, 256)):  # f32 compute
        q = randn(B, 1, heads, hs).transpose(1, 2).float()
        kf, vf = randn(B, heads, S, hs, scale=0.5).float(), randn(B, heads, S, hs, scale=0.5).float()
        (kq, ksc), (vq, vsc) = llama._quantize_kv(kf), llama._quantize_kv(vf)
        every = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
        vis = (torch.arange(S, device=dev)[None, :] <= every[:, None])[:, None, None, :]
        for name, (k, v, ks, vs) in (("f32", (kf, vf, None, None)), ("f32 int8", (kq, vq, ksc, vsc))):
            kd, vd = (kq.float() * ksc, vq.float() * vsc) if ks is not None else (kf, vf)
            k5_call = lambda: da.decode_attention(q, k, v, ks, vs, every)
            sdpa_call = lambda: F.scaled_dot_product_attention(q, kd, vd, attn_mask=vis)
            k5[f"{name} B={B} H={heads} S={S} hs={hs}"] = dict(
                us=time_us(k5_call), sdpa_us=time_us(sdpa_call), us_clean_l2=time_us(k5_call, clean=True),
                sdpa_us_clean_l2=time_us(sdpa_call, clean=True),
                bound_us=bound_us(k5_bytes(B, S, ks is not None, 4, heads, hs)))
            del kd, vd
        del kf, vf, kq, vq, ksc, vsc
    for B, heads, S, hs in K5_PAST_256:
        for cd, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            q = randn(B, 1, heads, hs).transpose(1, 2).to(cd)
            kf, vf = randn(B, heads, S, hs, scale=0.5).to(cd), randn(B, heads, S, hs, scale=0.5).to(cd)
            (kq, ksc), (vq, vsc) = llama._quantize_kv(kf), llama._quantize_kv(vf)
            every = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
            vis = (torch.arange(S, device=dev)[None, :] <= every[:, None])[:, None, None, :]
            for cache, (k, v, ks, vs) in ((name, (kf, vf, None, None)), (f"{name} int8", (kq, vq, ksc, vsc))):
                kd, vd = ((kq.float() * ksc).to(cd), (vq.float() * vsc).to(cd)) if ks is not None else (kf, vf)
                k5_call = lambda: da.decode_attention(q, k, v, ks, vs, every)
                sdpa_call = lambda: F.scaled_dot_product_attention(q, kd, vd, attn_mask=vis)
                k5[f"{cache} B={B} H={heads} S={S} hs={hs}"] = dict(
                    us=time_us(k5_call), sdpa_us=time_us(sdpa_call), us_clean_l2=time_us(k5_call, clean=True),
                    sdpa_us_clean_l2=time_us(sdpa_call, clean=True),
                    bound_us=bound_us(k5_bytes(B, S, ks is not None, cd.itemsize, heads, hs)))
                del kd, vd
            del kf, vf, kq, vq, ksc, vsc
    return k5


def k1_k2_times(args, torch, time_us, randn, bound_us, dev) -> dict:
    """K1 (without and with LoRA) and K2, and K1's own kernels at S = 2048."""
    from lit_llama_tpu_torch import LLaMAConfig, LoRAConfig
    from lit_llama_tpu_torch.models import llama
    from lit_llama_tpu_torch.ops import fused_layer
    from lit_llama_tpu_torch.ops.rope import build_rope_cache, rope_half_row
    from lit_llama_tpu_torch.utils.random_params import random_int4_params, random_lora_overlay

    cfg7 = LLaMAConfig.from_name("7B", n_layer=1, param_dtype="bfloat16", compute_dtype="bfloat16",
                                 quantize="int4")
    params, cfg = fused_layer.prepare_fused_params(
        llama.unstack_layers(random_int4_params(cfg7, seed=args.seed, device=dev)), cfg7)
    D, I = cfg.n_embd, cfg.intermediate_size
    lcfg = cfg.replace(lora=LoRAConfig(r=8, alpha=16.0, dropout=0.0))
    overlay = random_lora_overlay(cfg7.replace(lora=lcfg.lora), seed=args.seed + 2, device=dev)["h"]["attn"]["c_attn"]
    lp = params["h"][0]
    lpl = {**lp, "attn": {**lp["attn"], "c_attn": fused_layer.prepare_lora_operands(
        {**lp["attn"]["c_attn"], "lora_a": overlay["lora_a"][0], "lora_b": overlay["lora_b"][0]}, lcfg.lora, D, HS)}}
    R8 = lpl["attn"]["c_attn"]["lora_af"].shape[1]
    rope = build_rope_cache(cfg.block_size, HS, device=dev)
    k1, calls = {}, {}
    for S, pos in K1_SEQS:
        kv = {"k": randn(1, H, S, HS, scale=0.3), "v": randn(1, H, S, HS, scale=0.3)}
        x = randn(1, D)
        cos, sin = rope_half_row(rope, min(pos, cfg.block_size - 1), HS)
        visible = min(pos, S - 1) + 1
        for tag, (lay, c, r8) in (("", (lp, cfg, 0)), (" LoRA", (lpl, lcfg, R8))):
            call = (lambda lay=lay, c=c: fused_layer.decode_layers_fused(x, [lay], [kv], cos, sin, pos % S, pos, c))
            k1[f"S={S} pos={pos}{tag}"] = dict(us=time_us(call), us_clean_l2=time_us(call, clean=True),
                                                bound_us=bound_us(k1_bytes(D, I, visible, r8)))
            calls[(S, tag)] = call
    S, pos = K1_SEQS[-1]  # f32 compute: f32 row and cache
    kv32 = {"k": randn(1, H, S, HS, scale=0.3).float(), "v": randn(1, H, S, HS, scale=0.3).float()}
    x32, c32 = randn(1, D).float(), cfg.replace(compute_dtype="float32")
    cos, sin = rope_half_row(rope, min(pos, cfg.block_size - 1), HS)
    call = lambda: fused_layer.decode_layers_fused(x32, [lp], [kv32], cos, sin, pos % S, pos, c32)
    k1[f"S={S} pos={pos} f32"] = dict(us=time_us(call), us_clean_l2=time_us(call, clean=True),
                                      bound_us=bound_us(k1_bytes(D, I, min(pos, S - 1) + 1, es=4)))
    calls[(S, " f32")] = call
    x = randn(1, D)
    V = params["lm_head"]["qw"].shape[-1]
    k2 = {}
    for tag, xh, c, es in (("", x, cfg, 2), (" f32", x.float(), cfg.replace(compute_dtype="float32"), 4)):
        head = lambda xh=xh, c=c: fused_layer.lm_head_fused(xh, params["ln_f"], params["lm_head"], c)
        k2[f"D={D} V={V}{tag}"] = dict(us=time_us(head), us_clean_l2=time_us(head, clean=True),
                                       bound_us=bound_us(D * es + D * 2 + int4_bytes(D, V) + V * es))
    out = {"k1": k1, "k2": k2}
    for tag in ("", " f32"):
        out["k1_kernels_s2048" + tag.replace(" ", "_")] = k1_trace(torch, time_us, calls[(2048, tag)])
    return out


def k1_trace(torch, time_us, call) -> dict:
    """K1's own kernels from a torch.profiler trace of 20 calls, each after
    an L2 flush: the median time of each launch by its place in the block's
    sequence, the gap before it, and the first start to the last end."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            time_us.flush.zero_()
            torch.cuda._sleep(1_000_000)
            call()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    runs, cur = [], None
    for e in events:
        if "sleep" in e.name or "fill" in e.name.lower() or "zero" in e.name.lower():
            cur = None
            continue
        if cur is None:
            cur = []
            runs.append(cur)
        cur.append(e)
    seq = []
    if runs and all(len(r) == len(runs[0]) for r in runs):
        for i in range(len(runs[0])):
            durs = sorted(r[i].time_range.elapsed_us() for r in runs)
            gaps = sorted(r[i].time_range.start - r[i - 1].time_range.end for r in runs) if i else [0.0]
            seq.append(dict(kernel=runs[0][i].name[:80], us=durs[len(durs) // 2], gap_before_us=gaps[len(gaps) // 2]))
    spans = sorted(r[-1].time_range.end - r[0].time_range.start for r in runs) if runs else [0.0]
    return dict(sequence=seq, first_start_to_last_end_us=spans[len(spans) // 2])


def scan(args, torch, time_us, randn, smi) -> int:
    """K2 over V and K5 over S (clean L2), and an empty timed region."""
    from lit_llama_tpu_torch import LLaMAConfig
    from lit_llama_tpu_torch.models import llama
    from lit_llama_tpu_torch.ops import fused_layer
    from lit_llama_tpu_torch.ops import decode_attention as da
    from lit_llama_tpu_torch.utils.random_params import random_int4_params

    cfg7 = LLaMAConfig.from_name("7B", n_layer=1, param_dtype="bfloat16", compute_dtype="bfloat16", quantize="int4")
    params, cfg = fused_layer.prepare_fused_params(
        llama.unstack_layers(random_int4_params(cfg7, seed=args.seed, device="cuda")), cfg7)
    head, x = params["lm_head"], randn(1, cfg.n_embd)
    out = {}
    for V in (1024, 2048, 4096, 8192, 16384, 32000):
        hv = {k: (t[:V] if k.endswith("_t") else t[:, :V]) for k, t in head.items()}
        out[f"K2 V={V}"] = dict(us=time_us(lambda: fused_layer.lm_head_fused(x, params["ln_f"], hv, cfg), clean=True),
                                bound_us=(2 * 4096 * 2 + int4_bytes(4096, V) + V * 2) / BYTES_PER_S * 1e6)
    for S in (256, 512, 1024, 2048, 4096):
        q, k, v = randn(1, H, 1, HS), randn(1, H, S, HS), randn(1, H, S, HS)
        lim = torch.full((1,), S - 1, dtype=torch.int32, device="cuda")
        out[f"K5 S={S}"] = dict(us=time_us(lambda: da.decode_attention(q, k, v, None, None, lim), clean=True),
                                bound_us=k5_bytes(1, S, False) / BYTES_PER_S * 1e6)
    out["empty"] = dict(us=time_us(lambda: None, clean=True))
    print(json.dumps({"tag": args.tag, "root": args.root, "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "scan": out}))
    return 0


def accuracy(args, torch, smi) -> int:
    """K5 against its plain version as the card test holds it (TOL_CARD:
    atol 1e-3, rtol 2e-2), and both against the exact attention: the largest
    error and the largest share of that tolerance (relative to the exact
    value for the ``*_exact_share`` readings)."""
    from lit_llama_tpu_torch.ops import decode_attention as da

    g = torch.Generator(device="cuda").manual_seed(args.seed)
    S, atol, rtol = 2048, 1e-3, 2e-2
    limits = [255, 256, 3 * 256 + 5, S - 1, S + 100, 0, 63, -1]  # 256 rows a split at S = 2048
    B, dev = len(limits), torch.device("cuda")
    limit = torch.tensor(limits, dtype=torch.int32, device=dev)

    def exact(q, k, v, ks, vs):
        """f64 attention of the dequantized cache, nothing rounded."""
        q, k, v = q.double(), k.double(), v.double()
        if ks is not None:
            k, v = k * ks.double(), v * vs.double()
        s = (k * q).sum(-1) / math.sqrt(k.shape[-1])  # (B, H, S)
        vis = torch.arange(S, device=dev)[None, None, :] <= limit.long()[:, None, None]
        p = torch.softmax(s.masked_fill(~vis, float("-inf")), -1).nan_to_num(0.0)
        return (p[..., None] * v).sum(2, keepdim=True)

    out = {}
    for hs, H in ((128, 32), (256, 16)):
        q = torch.randn(B, H, 1, hs, generator=g, device=dev).to(torch.bfloat16)
        kf, vf = (torch.randn(B, H, S, hs, generator=g, device=dev) * 0.5 for _ in range(2))
        cases = {"bf16": (kf.to(torch.bfloat16), vf.to(torch.bfloat16), None, None)}
        rows = []
        for t in (kf, vf):  # as the int8 cache holds them: each row's largest element at 127
            sc = t.abs().amax(-1, keepdim=True) / 127.0
            rows += [torch.round(t / sc).clamp(-127, 127).to(torch.int8), sc]
        cases["int8 rows"] = (rows[0], rows[2], rows[1], rows[3])
        for c in (0.01, 0.03, 0.1):
            k8, v8 = (torch.randint(-127, 128, (B, H, S, hs), generator=g, device=dev, dtype=torch.int8)
                      for _ in range(2))
            ks, vs = (c * torch.rand(B, H, S, 1, generator=g, device=dev) for _ in range(2))
            cases[f"int8 uniform c={c}"] = (k8, v8, ks, vs)
        for name, (k, v, ks, vs) in cases.items():
            got = da.decode_attention(q, k, v, ks, vs, limit).double()
            want = da.decode_attention_ref(q, k, v, ks, vs, limit).double()
            ex = exact(q, k, v, ks, vs)
            err, bar = (got - want).abs(), atol + rtol * ex.abs()
            out[f"hs={hs} {name}"] = dict(
                kernel_vs_plain=float(err.max()), tol_share=float((err / (atol + rtol * want.abs())).max()),
                kernel_vs_exact=float((got - ex).abs().max()), plain_vs_exact=float((want - ex).abs().max()),
                kernel_exact_share=float(((got - ex).abs() / bar).max()),
                plain_exact_share=float(((want - ex).abs() / bar).max()), max_abs_exact=float(ex.abs().max()))
    print(json.dumps({"tag": args.tag, "root": args.root, "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "accuracy": out, "f32_vs_f64": f32_vs_f64(args, torch, exact, limit, S)}))
    return 0


def f32_vs_f64(args, torch, exact, limit, S: int) -> dict:
    """K5, K2 and K1 in f32 compute, kernel and plain version, each against
    the same function in f64 on the same inputs: max |error| of each and the
    largest |f64 value|."""
    from lit_llama_tpu_torch import LLaMAConfig
    from lit_llama_tpu_torch.models import llama
    from lit_llama_tpu_torch.ops import decode_attention as da
    from lit_llama_tpu_torch.ops import fused_layer
    from lit_llama_tpu_torch.ops.rope import build_rope_cache, rope_half_row
    from lit_llama_tpu_torch.utils.random_params import random_int4_params

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed + 1)
    B = limit.numel()

    def errs(got, want, ex):
        return dict(kernel_vs_f64=float((got.double() - ex).abs().max()),
                    plain_vs_f64=float((want.double() - ex).abs().max()), max_abs_f64=float(ex.abs().max()))

    out = {}
    for hs, heads in ((128, 32), (256, 16)):
        q = torch.randn(B, heads, 1, hs, generator=g, device=dev)
        kf, vf = (torch.randn(B, heads, S, hs, generator=g, device=dev) * 0.5 for _ in range(2))
        k8, v8 = (torch.randint(-127, 128, (B, heads, S, hs), generator=g, device=dev, dtype=torch.int8)
                  for _ in range(2))
        ks, vs = (0.01 * torch.rand(B, heads, S, 1, generator=g, device=dev) for _ in range(2))
        for name, c in (("f32", (kf, vf, None, None)), ("int8 uniform c=0.01", (k8, v8, ks, vs))):
            out[f"K5 hs={hs} {name}"] = errs(da.decode_attention(q, *c, limit), da.decode_attention_ref(q, *c, limit),
                                             exact(q, *c))

    cfg7 = LLaMAConfig.from_name("7B", n_layer=1, param_dtype="float32", compute_dtype="float32", quantize="int4")
    params, cfg = fused_layer.prepare_fused_params(
        llama.unstack_layers(random_int4_params(cfg7, seed=args.seed, device=dev)), cfg7)
    D, I, H_, hs = cfg.n_embd, cfg.intermediate_size, cfg.n_head, cfg.head_size

    def deq(w):  # (K, N) f64: nibble * scale + zero, low nibbles k < K/2, high ones K/2 + k
        qw = w["qw"]
        nib = torch.cat([(qw & 0xF), (qw >> 4)]).double()
        gs = nib.shape[0] // w["qscale"].shape[0]
        return nib * w["qscale"].double().repeat_interleave(gs, 0) + w["qzero"].double().repeat_interleave(gs, 0)

    def rms(x, w):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-5) * w.double()

    x = torch.randn(1, D, generator=g, device=dev)
    ln = params["ln_f"]
    out["K2 f32"] = errs(fused_layer.lm_head_fused(x, ln, params["lm_head"], cfg),
                         fused_layer.lm_head_fused_ref(x, ln, params["lm_head"], cfg),
                         rms(x.double(), ln) @ deq(params["lm_head"]))
    lp = params["h"][0]
    W = {n: deq(w) for n, w in (("ca", lp["attn"]["c_attn"]), ("cp", lp["attn"]["c_proj"]),
                                ("f12", lp["mlp"]["c_fc12"]), ("mp", lp["mlp"]["c_proj"]))}
    rope = build_rope_cache(cfg.block_size, hs, device=dev)
    Sk = 2048
    kc, vc = (torch.randn(1, H_, Sk, hs, generator=g, device=dev) * 0.3 for _ in range(2))
    for pos in (2047, 1000, 0):
        cos, sin = rope_half_row(rope, pos, hs)
        x = torch.randn(1, D, generator=g, device=dev)
        kv, rkv = ({"k": kc.clone(), "v": vc.clone()} for _ in range(2))
        got, _ = fused_layer.decode_layers_fused(x, [lp], [kv], cos, sin, pos, pos, cfg)
        want, _ = fused_layer.decode_layers_fused_ref(x, [lp], [rkv], cos, sin, pos, pos, cfg)
        xs = x.double()
        q, k, v = (rms(xs, lp["rms_1"]) @ W["ca"]).reshape(3, H_, hs)
        c, s_ = cos.double(), sin.double()
        q, k = (t * c + torch.roll(t, hs // 2, dims=-1) * s_ for t in (q, k))
        k64, v64 = kc[0].double().clone(), vc[0].double().clone()
        k64[:, pos], v64[:, pos] = k, v
        p = torch.softmax((k64[:, : pos + 1] * q[:, None]).sum(-1) / math.sqrt(hs), -1)
        y = (p[..., None] * v64[:, : pos + 1]).sum(1).reshape(1, D)
        xs = y @ W["cp"] + xs
        fg = rms(xs, lp["rms_2"]) @ W["f12"]
        xs = (fg[:, :I] * torch.sigmoid(fg[:, :I]) * fg[:, I:]) @ W["mp"] + xs
        out[f"K1 f32 S={Sk} pos={pos}"] = errs(got, want, xs)
    return out


def bits(args, torch, time_us, dev, da) -> dict:
    """SHA-256 of each body's output on seeded inputs, and its time."""
    import hashlib

    from lit_llama_tpu_torch import LLaMAConfig
    from lit_llama_tpu_torch.models import llama
    from lit_llama_tpu_torch.ops import fused_layer
    from lit_llama_tpu_torch.ops.rope import build_rope_cache, rope_half_row
    from lit_llama_tpu_torch.utils.random_params import random_int4_params

    g = torch.Generator(device=dev).manual_seed(args.seed + 3)

    def sha(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    out = {}
    for cd in (torch.bfloat16, torch.float32):
        name = "bf16" if cd == torch.bfloat16 else "f32"
        for hs, heads in ((128, 32), (256, 16)):
            B, S = 3, 2048
            q = torch.randn(B, heads, 1, hs, generator=g, device=dev).to(cd)
            kf, vf = (torch.randn(B, heads, S, hs, generator=g, device=dev).to(cd) * 0.5 for _ in range(2))
            (kq, ksc), (vq, vsc) = llama._quantize_kv(kf), llama._quantize_kv(vf)
            lim = torch.tensor([0, 700, S + 5], dtype=torch.int32, device=dev)
            for cache, c in ((name, (kf, vf, None, None)), ("int8", (kq, vq, ksc, vsc))):
                call = lambda c=c: da.decode_attention(q, *c, lim)
                out[f"K5 {name} q, {cache} cache, hs={hs}"] = dict(sha=sha(call()), us=time_us(call))
        Bs, Ss = 32, 256
        q, kn, vn = (torch.randn(Bs, 32, 1, 128, generator=g, device=dev).to(cd) for _ in range(3))
        kc, vc = (torch.randn(Bs, 32, Ss, 128, generator=g, device=dev).to(cd) for _ in range(2))
        pos = torch.randint(0, 2 * Ss, (Bs,), generator=g, device=dev, dtype=torch.int32)
        y, kc2, vc2 = da.decode_attention_write(q, kn, vn, kc.clone(), vc.clone(), pos)
        out[f"K8 {name}"] = dict(sha=sha(y, kc2, vc2), us=time_us(lambda: da.decode_attention_write(
            q, kn, vn, kc2, vc2, pos)))
    cfg7 = LLaMAConfig.from_name("7B", n_layer=1, param_dtype="bfloat16", compute_dtype="bfloat16", quantize="int4")
    params, cfg = fused_layer.prepare_fused_params(
        llama.unstack_layers(random_int4_params(cfg7, seed=args.seed, device=dev)), cfg7)
    rope = build_rope_cache(cfg.block_size, HS, device=dev)
    S, pos = K1_SEQS[-1]
    cos, sin = rope_half_row(rope, min(pos, cfg.block_size - 1), HS)
    for cd in (torch.bfloat16, torch.float32):
        name = "bf16" if cd == torch.bfloat16 else "f32"
        c = cfg.replace(compute_dtype="float32") if cd == torch.float32 else cfg
        kv = {n: (torch.randn(1, H, S, HS, generator=g, device=dev) * 0.3).to(cd) for n in "kv"}
        x = torch.randn(1, cfg.n_embd, generator=g, device=dev).to(cd)
        y, _ = fused_layer.decode_layers_fused(x, params["h"], [kv], cos, sin, pos % S, pos, c)
        out[f"K1 {name} S={S} pos={pos}"] = dict(sha=sha(y, kv["k"], kv["v"]), us=time_us(
            lambda: fused_layer.decode_layers_fused(x, params["h"], [kv], cos, sin, pos % S, pos, c)))
        head = lambda: fused_layer.lm_head_fused(x, params["ln_f"], params["lm_head"], c)
        out[f"K2 {name}"] = dict(sha=sha(head()), us=time_us(head))
    return {"bits": out}


def token(args, torch, time_us, dev) -> dict:
    """One decoded token of the 32-layer 7B int4 model, a K1 call a block
    and K2, as phase 8i decodes it: host wall and device time."""
    import time

    from lit_llama_tpu_torch import LLaMAConfig
    from lit_llama_tpu_torch.models import llama
    from lit_llama_tpu_torch.ops import fused_layer
    from lit_llama_tpu_torch.ops.rope import build_rope_cache, rope_half_row
    from lit_llama_tpu_torch.utils.random_params import random_int4_params

    cfg7 = LLaMAConfig.from_name("7B", param_dtype="bfloat16", compute_dtype="bfloat16", quantize="int4")
    params, cfg = fused_layer.prepare_fused_params(
        llama.unstack_layers(random_int4_params(cfg7, seed=args.seed, device=dev)), cfg7)
    g = torch.Generator(device=dev).manual_seed(args.seed + 4)
    rope = build_rope_cache(cfg.block_size, HS, device=dev)
    S, pos = K1_SEQS[-1]
    cos, sin = rope_half_row(rope, min(pos, cfg.block_size - 1), HS)
    out = {}
    for cd in (torch.bfloat16, torch.float32):
        c = cfg.replace(compute_dtype="float32") if cd == torch.float32 else cfg
        kvs = [{n: (torch.randn(1, H, S, HS, generator=g, device=dev) * 0.3).to(cd) for n in "kv"}
               for _ in params["h"]]
        x0 = torch.randn(1, cfg.n_embd, generator=g, device=dev).to(cd)

        def step():
            x = x0
            for lp, kv in zip(params["h"], kvs):
                x, _ = fused_layer.decode_layers_fused(x, [lp], [kv], cos, sin, pos % S, pos, c)
            return fused_layer.lm_head_fused(x, params["ln_f"], params["lm_head"], c)

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(20):
                step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / 20 * 1e3)
        out["bf16" if cd == torch.bfloat16 else "f32"] = dict(
            wall_ms_a_token=sorted(walls)[2], wall_ms_runs=walls, device_us_a_token=time_us(step),
            layers=cfg.n_layer, launches_a_token=dict(K1=cfg.n_layer, K2=1))
        del kvs
    return {"token": out}


if __name__ == "__main__":
    sys.exit(main())
