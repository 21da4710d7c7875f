#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one GPU.

    python3 chip_smoke.py

Builds the hand-written kernels of lit_llama_tpu_torch (K1-K4 of int4
single-stream generation, K7, K8/K8b and K9 of the batched serving step, K1's
and K7's LoRA operand, K5 and K6 of the per-op int8 decode path, K4 and K10 of
training, the probes P1-P5) with nvcc, holds each against its plain
PyTorch version at 7B shapes and times both, checks the kernel path of a
2-layer full-width model against the plain path (fused step and serving step,
without and with LoRA; per-op step with the bf16 and the int8 KV cache), then
drives the main paths on full 32-layer 7B models (random weights from a
seed): on int4 weights a few greedy single-stream requests through
``generate`` and 64 requests through a 32-slot ``DecodeEngine``, then the
same model with a seeded LoRA overlay (r = 8, q and v) through both, beside
the same requests without it; the probe tool's cases; the two generation
entry points (``generate.base``, ``generate.lora``) in subprocesses on a
2-layer 7B-width lit-llama ``.pth`` with a reference-format LoRA ``.pth``,
whose greedy tokens must equal the in-process ``generate``'s; then, the int4
model freed, three greedy requests through ``generate`` on int8 weights,
which decodes per op (short context, S = 2048, and S = 2048 on the int8 KV
cache). Then the training path: K10 (the
flash-attention backward) against its plain version, a 2-layer full-width
training step kernel path against plain path, 7 steps of 8-layer full-width
pretraining at T = 2048 through ``training.loop.train`` on LITPKDS chunks, and
the ``pretrain.redpajama`` entry point saving and resuming in a subprocess.
The launch counters, set to 0 before each path and read after it, prove that
the path ran through the kernels. Any failure raises and exits nonzero.

Output: findings on earlier lines; one line with the card's name and power
limit; one JSON line {"kernels": [...]} with each kernel's launches on the
main path, error, time, plain time, bound and library yardstick; and last
{"ok": true, "device": {...}}. Without a CUDA device, or run from a directory
that lacks the package, it exits nonzero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

SEED = 0
TOL = {  # |kernel - plain| <= atol + rtol * |plain|, bf16 outputs: ~2 ulp at |v| ~ 2
    "K3": (2e-2, 2e-2),
    "K4": (2e-2, 2e-2),
    "K4 lse": (1e-3, 1e-3),
    "K1": (2e-2, 2e-2),
    "K1 cache": (1e-2, 1e-2),
    "K2": (2e-2, 2e-2),
    # the serving kernels sum in f32 from the same bf16-rounded inputs as their
    # plain versions, in another order: the bf16 outputs differ by an ulp or two
    "K7": (2e-2, 2e-2),
    "K9": (2e-2, 2e-2),
    # K1 and K7 with the LoRA operand: the same rounding points, the update
    # summed in f32 in another order
    "K1 LoRA": (2e-2, 2e-2),
    "K7 LoRA": (2e-2, 2e-2),
    "K8": (2e-2, 2e-2),  # y; the caches must be identical
    # K6 rounds the same f32 sum times the scale as its plain version, summed in
    # another order: an ulp of an O(10) value
    "K6": (2e-2, 2e-2),
    # K5 rounds every product to bf16 as its plain version does, but takes each
    # softmax weight relative to its 64-row chunk's maximum before rounding it.
    # With every row of a long cache visible the outputs are small means
    # (|y| <= 0.05 at S = 2048, 0.3 at S = 72), so the absolute part is set from
    # the errors seen there (2.4e-4 to 9.8e-4): a chunk left out of the merge or
    # a scale not applied moves most values by more
    "K5": (1e-3, 2e-2),
}
# 2-layer full-width model, kernel path vs plain path: per-op errors of the
# table above compound through 2 blocks and the lm_head
TOL_MODEL = (5e-2, 5e-2)
# K10, bf16, held row by row (a query's dq, a key's dk or dv: the last axis):
# |kernel - plain| <= row * rowmax + rel * |plain|, with rowmax the row's
# largest |plain|, at least floor * the output's largest. Both round P and dS
# to bf16 at the same places from f32 scores that differ in the last bits, and
# round the outputs to bf16, so an element may differ by an ulp of itself
# (2^-7 of its size at most; rel allows 2.5 of them) and otherwise by much
# less than its row's size. The absolute part follows each row's own size:
# a late query's dq is the sum of ~T/64 KV tiles, so one tile left out moves
# that row by ~1/sqrt(T/64) of its size (18 % at T = 2048), while the output's
# largest values sit in the first rows, which have one partner each. The floor
# is for the one row whose exact grad is 0: the first query's softmax has one
# term, so its dS = dP - D is f32 rounding noise. On the H100 sound runs need
# a row part of at most 2.5e-3; a dQ that leaves out one KV tile, or a dK/dV
# that leaves out one Q tile, needs 0.98 to 1.35
TOL_K10 = dict(row=1e-2, rel=2e-2, floor=1e-3)
# the Function's grads (K4 + K10) against autograd of attention_ref, which
# rounds elsewhere: the flash backward takes D = rowsum(dO * O) from the bf16
# O, so in a row whose softmax is nearly one-hot (dq near 0) D's rounding is
# the whole value. These rows are held to the output's largest value (floor 1:
# rowmax is max |plain| everywhere); this check is of the Function's wiring
# (which grad goes where, the scale, the saved lse), the tiles are held row by
# row above
TOL_FUNCTION = dict(row=1e-2, rel=2e-2, floor=1.0)
# training step, kernel path vs plain path (bf16 activations through 2 blocks,
# K4 and K10): each leaf's grad error, as max |dgrad| / max |grad| and as
# RMS(dgrad) / RMS(grad); the RMS reading sees a bias spread over most
# elements, which a leaf's few largest grads would hide from the max reading.
# On the H100 sound runs read at most 0.0114 / 0.0100; a K10 that leaves out
# one KV tile of dQ reads 0.024 to 0.079 (both readings) on every leaf whose
# grad passes through an attention backward (all but ln_f and lm_head).
# One AdamW step from zero moments moves each element by lr * (g / (|g| +
# eps) + wd * p): the two paths agree to TOL_TRAIN_UPDATE * lr wherever the
# plain grad is farther from 0 than twice the leaf's largest grad error, and
# may step the other way (up to 2 lr) where it is not
TOL_TRAIN_GRAD = dict(max=2e-2, rms=2e-2)
TOL_TRAIN_UPDATE = 5e-2


def log(*a):
    print(*a, flush=True)


def main() -> int:
    import gc

    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if not (ROOT / "lit_llama_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: the package lit_llama_tpu_torch is not beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False

    from lit_llama_tpu_torch import LLaMAConfig, LoRAConfig
    from lit_llama_tpu_torch.models import generate as gen
    from lit_llama_tpu_torch.models import llama
    from lit_llama_tpu_torch.ops import _build, fused_layer, quant_matmul
    from lit_llama_tpu_torch.ops import decode_attention as da
    from lit_llama_tpu_torch.ops import flash_attention as fa
    from lit_llama_tpu_torch.ops.linear import dequantize_int4, dequantize_int8
    from lit_llama_tpu_torch.ops.rope import build_rope_cache, rope_half_row, slot_rope_rows
    from lit_llama_tpu_torch.serve import DecodeEngine
    from lit_llama_tpu_torch.tools import probe_kernels
    from lit_llama_tpu_torch.utils.device import device_peaks
    from lit_llama_tpu_torch.utils.random_params import random_int4_params, random_int8_params, random_lora_overlay

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()

    # ---- 1. set-up ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    bw, tc_peak, f32_peak = device_peaks(kind)
    log(f"peaks for {kind}: {bw / 1e12} TB/s, {tc_peak / 1e12} TF/s bf16, {f32_peak / 1e12} TF/s f32")
    t0 = time.perf_counter()
    took = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s wall; per library {took}")
    for name in _build.SOURCES:
        for line in _build.lib_path(name).with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    def bound_ms(nbytes, ops, peak):
        return max(nbytes / bw, ops / peak) * 1e3, ("bytes" if nbytes / bw >= ops / peak else "operations")

    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2

    def time_ms(fn, iters=20):
        """Median device time of fn over iters runs, L2 flushed before each.
        A spin on the card ahead of the start event keeps it busy while the
        host enqueues fn, so the host's time in the wrapper is not counted."""
        fn()
        times = []
        for _ in range(iters):
            flush.zero_()
            torch.cuda._sleep(1_000_000)  # ~0.5 ms of device cycles
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return sorted(times)[len(times) // 2]

    def max_err(got, want, key):
        got, want = got.float(), want.float()
        assert torch.isfinite(got).all(), f"{key}: non-finite kernel output"
        err = (got - want).abs()
        atol, rtol = TOL[key]
        bad = err > atol + rtol * want.abs()
        assert not bad.any(), f"{key}: {int(bad.sum())} values beyond tolerance, max err {err.max():.3g}"
        return float(err.max())

    def model_err(got, want, what):
        got, want = got.float(), want.float()
        assert torch.isfinite(got).all(), f"{what}: non-finite logits"
        err = float((got - want).abs().max())
        limit = TOL_MODEL[0] + TOL_MODEL[1] * float(want.abs().max())
        assert err <= limit, f"{what}: max |dlogit| {err:.3g} > {limit:.3g}"
        return err

    def wall_s(params, config, prompt, n_new, s, reps=3):
        """Median host time of a greedy request (generate ends in a copy to the host)."""
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            gen.generate(params, prompt, n_new, config=config, max_seq_length=s, temperature=0.0)
            times.append(time.perf_counter() - t0)
        return sorted(times)[reps // 2]

    counters = {"K1": fused_layer.decode_layers_fused, "K2": fused_layer.lm_head_fused,
                "K3": quant_matmul.matmul_int4, "K4": fa.flash_attention, "K5": da.decode_attention,
                "K6": quant_matmul.matmul_int8, "K7": fused_layer.block_head_fused,
                "K8": da.decode_attention_write, "K9": fused_layer.block_tail_fused,
                "K1 LoRA": fused_layer.k1_lora, "K7 LoRA": fused_layer.k7_lora}

    gcpu = torch.Generator().manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gcpu) * scale).to(dev, torch.bfloat16)

    def int4_paths():
        """The int4 paths: K1-K4 and K7-K9 against their plain versions, then
        single-stream generate and the serving engine on the 7B int4 model.
        Its tensors die with the call, so the int8 model finds the card free."""
        cfg7 = LLaMAConfig.from_name("7B", param_dtype="bfloat16", compute_dtype="bfloat16", quantize="int4")
        D, I, H, hs, gs = cfg7.n_embd, cfg7.intermediate_size, cfg7.n_head, cfg7.head_size, cfg7.quant_groupsize
        V = cfg7.padded_vocab_size
        t0 = time.perf_counter()
        params, cfg = fused_layer.prepare_fused_params(
            llama.unstack_layers(random_int4_params(cfg7, seed=SEED, device=dev)), cfg7
        )
        torch.cuda.synchronize()
        log(f"random 7B int4 params: {time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
        lp0 = params["h"][0]
        results = {}
        # the same model with a seeded LoRA overlay (r = 8, alpha 16, q and v; B
        # drawn, not zero): each c_attn gains the folded operand as
        # prepare_fused_params folds it into an overlaid layer once its q/k
        # columns are permuted, and shares every other tensor with `params`
        lcfg = cfg.replace(lora=LoRAConfig(r=8, alpha=16.0, dropout=0.0))
        overlay = random_lora_overlay(cfg7.replace(lora=lcfg.lora), seed=SEED + 2, device=dev)["h"]["attn"]["c_attn"]
        params_l = dict(params, h=[
            {**lp, "attn": {**lp["attn"], "c_attn": fused_layer.prepare_lora_operands(
                {**lp["attn"]["c_attn"], "lora_a": overlay["lora_a"][j], "lora_b": overlay["lora_b"][j]},
                lcfg.lora, D, hs)}}
            for j, lp in enumerate(params["h"])])
        del overlay
        lp0l = params_l["h"][0]
        R8 = lp0l["attn"]["c_attn"]["lora_af"].shape[1]
        lora_bytes, lora_ops = D * R8 * 2 + R8 * 3 * D * 2, 2 * (D * R8 + R8 * 3 * D)
        log(f"LoRA overlay on the 7B int4 model: r = 8 on q and v, R8 = {R8} operand columns, "
            f"{lora_bytes / 2**20:.2f} MiB a block")

        def q4_bytes(K, N, g=gs):
            return K // 2 * N + 2 * (K // g) * N * 4

        # ---- 2. K3 vs plain ------------------------------------------------------
        linears = [("c_attn", lp0["attn"]["c_attn"], D), ("attn.c_proj", lp0["attn"]["c_proj"], D),
                   ("c_fc12", lp0["mlp"]["c_fc12"], D), ("mlp.c_proj", lp0["mlp"]["c_proj"], I),
                   ("lm_head", params["lm_head"], D)]
        errs = []
        for M in (8, 128):
            for lname, w, K in linears:
                N = w["qw"].shape[1]
                x = randn(M, K)
                args = (x, w["qw"], w["qscale"], w["qzero"])
                errs.append(max_err(quant_matmul.matmul_int4(*args), quant_matmul.matmul_int4_ref(*args), "K3"))
                ms = time_ms(lambda: quant_matmul.matmul_int4(*args))
                bms, _ = bound_ms(M * K * 2 + q4_bytes(K, N) + M * N * 2, 2 * M * K * N, tc_peak)
                log(f"K3 M={M} {lname} {K}->{N}: {ms * 1e3:.1f} us, bound {bms * 1e3:.1f} us")
                if M == 128 and lname == "c_fc12":
                    wd = dequantize_int4(w, torch.bfloat16)
                    k3 = dict(shape=f"M={M} K={K} N={N} (c_fc12)", ms=ms,
                              plain_ms=time_ms(lambda: quant_matmul.matmul_int4_ref(*args), 3),
                              library_ms=time_ms(lambda: torch.matmul(x, wd)))
                    k3["bound_ms"], k3["bound_by"] = bound_ms(
                        M * K * 2 + q4_bytes(K, N) + M * N * 2, 2 * M * K * N, tc_peak)
                    del wd
        results["K3"] = dict(k3, max_abs_err=max(errs))

        # ---- 3. K4 vs plain ------------------------------------------------------
        errs = []
        for T in (128, 200, 512):
            q, k, v = (randn(1, H, T, hs) for _ in range(3))
            o, lse = fa.flash_attention(q, k, v)
            ro, rlse = fa.flash_attention_ref(q, k, v)
            errs.append(max_err(o, ro, "K4"))
            max_err(lse, rlse, "K4 lse")
            ms = time_ms(lambda: fa.flash_attention(q, k, v))
            nbytes, ops = 4 * H * T * hs * 2 + H * T * 4, 4 * hs * H * T * (T + 1) // 2
            log(f"K4 T={T}: {ms * 1e3:.1f} us, bound {bound_ms(nbytes, ops, tc_peak)[0] * 1e3:.1f} us")
            if T == 200:
                k4 = dict(shape=f"B=1 H={H} T={T} hs={hs}", ms=ms,
                          plain_ms=time_ms(lambda: fa.flash_attention_ref(q, k, v), 3),
                          library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)))
                k4["bound_ms"], k4["bound_by"] = bound_ms(nbytes, ops, tc_peak)
        results["K4"] = dict(k4, max_abs_err=max(errs))

        # ---- 4. K1 vs plain: one 7B block, S = 2048 ------------------------------
        S = 2048
        rope = build_rope_cache(cfg.block_size, hs, device=dev)
        kc0, vc0 = randn(1, H, S, hs, scale=0.3), randn(1, H, S, hs, scale=0.3)
        layer_bytes = (q4_bytes(D, 3 * D) + q4_bytes(D, D) + q4_bytes(D, 2 * I) + q4_bytes(I, D)
                       + 2 * D * 2 + 2 * hs * 4 + 2 * D * 2 + 2 * H * hs * 2)
        layer_ops = 2 * (3 * D * D + D * D + 2 * I * D + I * D)
        errs = []
        for pos in (0, 1000, 2047, 2053):
            x = randn(1, D)
            cos, sin = rope_half_row(rope, min(pos, cfg.block_size - 1), hs)
            kv = {"k": kc0.clone(), "v": vc0.clone()}
            rkv = {"k": kc0.clone(), "v": vc0.clone()}
            out, _ = fused_layer.decode_layers_fused(x, [lp0], [kv], cos, sin, pos % S, pos, cfg)
            ref, _ = fused_layer.decode_layers_fused_ref(x, [lp0], [rkv], cos, sin, pos % S, pos, cfg)
            errs.append(max_err(out, ref, "K1"))
            max_err(kv["k"], rkv["k"], "K1 cache")
            max_err(kv["v"], rkv["v"], "K1 cache")
            visible = min(pos, S - 1) + 1
            nbytes = layer_bytes + 2 * H * visible * hs * 2
            ops = layer_ops + 4 * H * visible * hs
            call = lambda: fused_layer.decode_layers_fused(x, [lp0], [kv], cos, sin, pos % S, pos, cfg)
            ms = time_ms(call, 20)
            log(f"K1 S={S} pos={pos}: {ms * 1e3:.1f} us, bound {bound_ms(nbytes, ops, f32_peak)[0] * 1e3:.1f} us")
            if pos == 2047:
                k1 = dict(shape=f"one 7B block, S={S}, pos={pos} ({visible} slots visible)", ms=ms,
                          plain_ms=time_ms(lambda: fused_layer.decode_layers_fused_ref(
                              x, [lp0], [rkv], cos, sin, pos % S, pos, cfg), 3),
                          library_ms=None)
                k1["bound_ms"], k1["bound_by"] = bound_ms(nbytes, ops, f32_peak)
        results["K1"] = dict(k1, max_abs_err=max(errs))

        # ---- 4b. K1 with the LoRA operand vs plain: the same block, S = 2048 -------
        errs = []
        for pos in (0, 1000, 2047, 2053):
            x = randn(1, D)
            cos, sin = rope_half_row(rope, min(pos, cfg.block_size - 1), hs)
            kv, rkv, bkv = ({"k": kc0.clone(), "v": vc0.clone()} for _ in range(3))
            out, _ = fused_layer.decode_layers_fused(x, [lp0l], [kv], cos, sin, pos % S, pos, lcfg)
            ref, _ = fused_layer.decode_layers_fused_ref(x, [lp0l], [rkv], cos, sin, pos % S, pos, lcfg)
            errs.append(max_err(out, ref, "K1 LoRA"))
            max_err(kv["k"], rkv["k"], "K1 cache")
            max_err(kv["v"], rkv["v"], "K1 cache")
            # the update is live: the v row written (v has one) moves far beyond the cache tolerance
            fused_layer.decode_layers_fused(x, [lp0], [bkv], cos, sin, pos % S, pos, cfg)
            moved = float((bkv["v"][0, :, pos % S] - kv["v"][0, :, pos % S]).float().abs().max())
            assert moved > 10 * TOL["K1 cache"][0], f"K1 LoRA pos={pos}: the operand moves v by {moved:.3g} only"
            if pos == 2047:
                visible = min(pos, S - 1) + 1
                nbytes = layer_bytes + lora_bytes + 2 * H * visible * hs * 2
                ops = layer_ops + lora_ops + 4 * H * visible * hs
                with_op = lambda: fused_layer.decode_layers_fused(x, [lp0l], [kv], cos, sin, pos % S, pos, lcfg)
                without = lambda: fused_layer.decode_layers_fused(x, [lp0], [kv], cos, sin, pos % S, pos, cfg)
                ms_w = [time_ms(with_op), time_ms(without), time_ms(without), time_ms(with_op)]
                k1l = dict(shape=f"one 7B block, S={S}, pos={pos}, R8={R8}", ms=(ms_w[0] + ms_w[3]) / 2,
                           ms_without_operand=(ms_w[1] + ms_w[2]) / 2, library_ms=None,
                           plain_ms=time_ms(lambda: fused_layer.decode_layers_fused_ref(
                               x, [lp0l], [rkv], cos, sin, pos % S, pos, lcfg), 3))
                k1l["bound_ms"], k1l["bound_by"] = bound_ms(nbytes, ops, f32_peak)
                log(f"K1 with the LoRA operand, S={S} pos={pos}: {ms_w[0] * 1e3:.1f} / {ms_w[3] * 1e3:.1f} us, "
                    f"without {ms_w[1] * 1e3:.1f} / {ms_w[2] * 1e3:.1f} us (timed with, without, without, with); "
                    f"bound {k1l['bound_ms'] * 1e3:.1f} us with it, {bound_ms(nbytes - lora_bytes, ops - lora_ops, f32_peak)[0] * 1e3:.1f} without")
        results["K1 LoRA"] = dict(k1l, max_abs_err=max(errs))
        del kc0, vc0, kv, rkv, bkv

        # ---- 5. K2 vs plain -------------------------------------------------------
        x = randn(1, D)
        head_args = (x, params["ln_f"], params["lm_head"], cfg)
        err = max_err(fused_layer.lm_head_fused(*head_args), fused_layer.lm_head_fused_ref(*head_args), "K2")
        results["K2"] = dict(shape=f"D={D} V={V}", ms=time_ms(lambda: fused_layer.lm_head_fused(*head_args), 20),
                             plain_ms=time_ms(lambda: fused_layer.lm_head_fused_ref(*head_args), 3),
                             library_ms=None, max_abs_err=err)
        results["K2"]["bound_ms"], results["K2"]["bound_by"] = bound_ms(
            2 * D * 2 + q4_bytes(D, V) + V * 2, 2 * D * V, f32_peak)
        log(f"K2 D={D} V={V}: {results['K2']['ms'] * 1e3:.1f} us, bound {results['K2']['bound_ms'] * 1e3:.1f} us")

        # ---- 5b. K7 and K9 vs plain: the block halves of the serving step ---------
        odd7 = LLaMAConfig(n_layer=1, n_head=14, n_embd=1792, param_dtype="bfloat16",
                           compute_dtype="bfloat16", quantize="int4")  # 7 and 19 groups per nibble plane
        odd_params, odd_cfg = fused_layer.prepare_fused_params(
            llama.unstack_layers(random_int4_params(odd7, seed=SEED + 1, device=dev)), odd7)

        def halves_args(lp, c, B):
            x, y = randn(B, c.n_embd), randn(B, c.n_embd)
            pos = torch.randint(0, c.block_size + 100, (B,), generator=gcpu).to(dev, torch.int32)
            cos, sin = slot_rope_rows(rope, pos)
            return ((x, lp["rms_1"], cos, sin, lp["attn"]["c_attn"], c),
                    (x, y, lp["rms_2"], lp["attn"]["c_proj"], lp["mlp"]["c_fc12"], lp["mlp"]["c_proj"], c))

        errs7, errs9 = [], []
        for lp, c, what in ((lp0, cfg, "7B"), (odd_params["h"][0], odd_cfg, "odd groups")):
            Dm, Im, g = c.n_embd, c.intermediate_size, c.quant_groupsize
            for B in (1, 8, 32, 64):
                ha, ta = halves_args(lp, c, B)
                errs7.append(max_err(fused_layer.block_head_fused(*ha), fused_layer.block_head_fused_ref(*ha), "K7"))
                errs9.append(max_err(fused_layer.block_tail_fused(*ta), fused_layer.block_tail_fused_ref(*ta), "K9"))
                ms7 = time_ms(lambda: fused_layer.block_head_fused(*ha))
                ms9 = time_ms(lambda: fused_layer.block_tail_fused(*ta))
                b7 = bound_ms(B * Dm * 2 + Dm * 2 + q4_bytes(Dm, 3 * Dm, g) + 2 * B * hs * 4 + B * 3 * Dm * 2,
                              2 * B * Dm * 3 * Dm, tc_peak)
                b9 = bound_ms(2 * B * Dm * 2 + Dm * 2 + q4_bytes(Dm, Dm, g) + q4_bytes(Dm, 2 * Im, g)
                              + q4_bytes(Im, Dm, g) + B * Dm * 2,
                              2 * B * (Dm * Dm + 2 * Im * Dm + Im * Dm), tc_peak)
                log(f"K7 {what} D={Dm} B={B}: {ms7 * 1e3:.1f} us, bound {b7[0] * 1e3:.1f} us ({b7[1]}); "
                    f"K9 I={Im}: {ms9 * 1e3:.1f} us, bound {b9[0] * 1e3:.1f} us ({b9[1]})")
                if what == "7B" and B == 32:
                    k7 = dict(shape=f"B={B} D={Dm} -> 3D (c_attn)", ms=ms7, library_ms=None,
                              plain_ms=time_ms(lambda: fused_layer.block_head_fused_ref(*ha), 3),
                              bound_ms=b7[0], bound_by=b7[1])
                    k9 = dict(shape=f"B={B} D={Dm} I={Im}", ms=ms9, library_ms=None,
                              plain_ms=time_ms(lambda: fused_layer.block_tail_fused_ref(*ta), 3),
                              bound_ms=b9[0], bound_by=b9[1])
        results["K7"] = dict(k7, max_abs_err=max(errs7))
        results["K9"] = dict(k9, max_abs_err=max(errs9))
        del odd_params

        # ---- 5b'. K7 with the LoRA operand vs plain, B = 1, 8, 32, 64 -------------
        errs7l = []
        for B in (1, 8, 32, 64):
            ha, _ = halves_args(lp0l, lcfg, B)
            errs7l.append(max_err(fused_layer.block_head_fused(*ha), fused_layer.block_head_fused_ref(*ha), "K7 LoRA"))
            bare = fused_layer.block_head_fused_ref(*ha[:4], lp0["attn"]["c_attn"], cfg)
            moved = float((bare.float() - fused_layer.block_head_fused_ref(*ha).float()).abs().max())
            assert moved > 10 * TOL["K7 LoRA"][0], f"K7 LoRA B={B}: the operand moves the output by {moved:.3g} only"
            if B == 32:
                hb = ha[:4] + (lp0["attn"]["c_attn"], cfg)
                ms_w = [time_ms(lambda: fused_layer.block_head_fused(*ha)), time_ms(lambda: fused_layer.block_head_fused(*hb)),
                        time_ms(lambda: fused_layer.block_head_fused(*hb)), time_ms(lambda: fused_layer.block_head_fused(*ha))]
                b7l = bound_ms(B * D * 2 + D * 2 + q4_bytes(D, 3 * D) + lora_bytes + 2 * B * hs * 4 + B * 3 * D * 2,
                               2 * B * D * 3 * D + B * lora_ops, tc_peak)
                k7l = dict(shape=f"B={B} D={D} -> 3D (c_attn), R8={R8}", ms=(ms_w[0] + ms_w[3]) / 2,
                           ms_without_operand=(ms_w[1] + ms_w[2]) / 2, library_ms=None,
                           plain_ms=time_ms(lambda: fused_layer.block_head_fused_ref(*ha), 3),
                           bound_ms=b7l[0], bound_by=b7l[1])
                log(f"K7 with the LoRA operand, B={B}: {ms_w[0] * 1e3:.1f} / {ms_w[3] * 1e3:.1f} us, without "
                    f"{ms_w[1] * 1e3:.1f} / {ms_w[2] * 1e3:.1f} us (with, without, without, with); bound "
                    f"{b7l[0] * 1e3:.1f} us ({b7l[1]})")
        results["K7 LoRA"] = dict(k7l, max_abs_err=max(errs7l))

        # ---- 5c. K8 vs plain through both entries: cache write + attention -------
        entries = {"K8": da.decode_attention_write_pipelined, "K8b": da.decode_attention_write_pallas}
        errs8 = dict.fromkeys(entries, 0.0)
        for B, S8 in ((32, 256), (8, 2048)):
            qkv = randn(B, 3 * D)
            q8, kn8, vn8 = (qkv[:, i * D : (i + 1) * D].reshape(B, H, 1, hs) for i in range(3))
            kc0, vc0 = randn(B, H, S8, hs, scale=0.5), randn(B, H, S8, hs, scale=0.5)
            # mixed positions: a retired slot (0), a parked one (S - 1), wrapped ones (>= S)
            mixed = torch.randint(0, 3 * S8, (B,), generator=gcpu)
            mixed[:6] = torch.tensor([0, S8 - 1, S8, 2 * S8 + 63, 64, 63])
            mixed = mixed.to(dev, torch.int32)
            full_pos = torch.randint(S8 - 1, 2 * S8, (B,), generator=gcpu).to(dev, torch.int32)  # every row visible
            for key, entry in entries.items():
                for pos8 in (mixed, full_pos):
                    kc, vc, rk, rv = kc0.clone(), vc0.clone(), kc0.clone(), vc0.clone()
                    y8, _, _ = entry(q8, kn8, vn8, kc, vc, pos8)
                    ry8, _, _ = da.decode_attention_write_ref(q8, kn8, vn8, rk, rv, pos8)
                    errs8[key] = max(errs8[key], max_err(y8, ry8, "K8"))
                    assert torch.equal(kc, rk) and torch.equal(vc, rv), f"{key} B={B} S={S8}: caches differ"
                # timed with every row visible: (S rows of k and of v) per slot and head
                nbytes = 2 * B * H * S8 * hs * 2 + 4 * B * D * 2 + 2 * B * D * 2 + B * 4
                b8 = bound_ms(nbytes, 4 * B * H * S8 * hs, f32_peak)
                ms8 = time_ms(lambda: entry(q8, kn8, vn8, kc, vc, full_pos))
                log(f"{key} B={B} S={S8}, every row visible: {ms8 * 1e3:.1f} us, bound {b8[0] * 1e3:.1f} us ({b8[1]})")
                if B == 32:
                    rows8 = torch.arange(B, device=dev)
                    wp8 = (full_pos % S8).long()
                    vis8 = (torch.arange(S8, device=dev)[None, :] <= full_pos[:, None])[:, None, None, :]

                    def library_call():
                        kc[rows8, :, wp8] = kn8[:, :, 0]  # index_put_
                        vc[rows8, :, wp8] = vn8[:, :, 0]
                        return F.scaled_dot_product_attention(q8, kc, vc, attn_mask=vis8)

                    results[key] = dict(
                        shape=f"B={B} H={H} S={S8} hs={hs}, every row visible", ms=ms8,
                        plain_ms=time_ms(lambda: da.decode_attention_write_ref(q8, kn8, vn8, rk, rv, full_pos), 3),
                        library_ms=time_ms(library_call), bound_ms=b8[0], bound_by=b8[1])
            del kc0, vc0, kc, vc, rk, rv
        for key in entries:
            results[key]["max_abs_err"] = errs8[key]

        for tag, pp, cc in (("", params, cfg), (" with LoRA", params_l, lcfg)):
            # ---- 6. full width, depth cut to 2 blocks: kernel path vs plain path ------
            p2 = dict(pp, h=pp["h"][:2])
            c2 = cc.replace(n_layer=2)
            prompt = torch.randint(0, cfg.vocab_size, (1, 37), generator=gcpu).to(dev)
            caches = {plain: llama.init_kv_cache(c2, 1, 64, device=dev) for plain in (False, True)}
            logits = {plain: llama.forward(p2, prompt, c2, rope_cache=rope, kv_cache=caches[plain],
                                           prefill_from_zero=True, plain=plain)[0] for plain in (False, True)}

            errs = [model_err(logits[False], logits[True], f"2-layer{tag} prefill")]
            tok = logits[False][0, -1:].float().argmax(-1)
            for step in range(8):
                pos = prompt.shape[1] + step
                cos, sin = rope_half_row(rope, pos, hs)
                step_logits = {}
                for plain in (False, True):
                    layer = fused_layer.decode_layers_fused_ref if plain else fused_layer.decode_layers_fused
                    head = fused_layer.lm_head_fused_ref if plain else fused_layer.lm_head_fused
                    x = params["wte"][tok].to(torch.bfloat16)
                    for lp, kv in zip(p2["h"], caches[plain]):
                        x, _ = layer(x, [lp], [kv], cos, sin, pos % 64, pos, c2)
                    step_logits[plain] = head(x, params["ln_f"], params["lm_head"], c2)
                errs.append(model_err(step_logits[False], step_logits[True], f"2-layer{tag} decode step {step}"))
                tok = step_logits[False].float().argmax(-1)
            log(f"2-layer 7B-width model{tag}, kernel vs plain path: prefill max |dlogit| {errs[0]:.4g}, "
                f"8 decode steps max {max(errs[1:]):.4g}")
            del caches, logits

            # ---- 6b. the same 2 blocks, serving step: 3 slots at their own positions ----
            S6, lens6 = 64, (10, 37, 60)  # the third slot passes S during the 8 steps: its ring wraps
            caches = {plain: llama.init_kv_cache(c2, 3, S6, device=dev) for plain in (False, True)}
            first = []
            for b, n in enumerate(lens6):
                p6 = torch.randint(0, cfg.vocab_size, (1, n), generator=gcpu).to(dev)
                for plain in (False, True):
                    view = [{name: t[b : b + 1] for name, t in kv.items()} for kv in caches[plain]]
                    lg = llama.forward(p2, p6, c2, rope_cache=rope, kv_cache=view, prefill_from_zero=True, plain=plain)[0]
                    if not plain:
                        first.append(lg[0, -1].float().argmax())
            tok6 = torch.stack(first)
            pos6 = torch.tensor(lens6, dtype=torch.int32, device=dev)
            errs = []
            for step in range(8):
                lg = {plain: llama.forward(p2, tok6[:, None], c2, rope_cache=rope, slot_pos=pos6,
                                           kv_cache=caches[plain], plain=plain)[0][:, -1] for plain in (False, True)}
                errs.append(model_err(lg[False], lg[True], f"2-layer{tag} serving step {step}"))
                tok6, pos6 = lg[False].float().argmax(-1), pos6 + 1
            log(f"2-layer 7B-width serving step{tag} (K7, K8, K9, K3), kernel vs plain path, slots at {lens6} "
                f"of S={S6}: 8 steps max |dlogit| {max(errs):.4g}")
            del caches, lg

        # ---- 7. the full model: a few greedy requests ------------------------------
        full = {}
        ref_prompt = torch.randint(0, cfg.vocab_size, (8,), generator=gcpu)
        kern_logits = llama.forward(params, ref_prompt[None].to(dev), cfg, rope_cache=rope,
                                    kv_cache=llama.init_kv_cache(cfg, 1, 16, device=dev), prefill_from_zero=True)[0]
        plain_logits = llama.forward(params, ref_prompt[None].to(dev), cfg, rope_cache=rope,
                                     kv_cache=llama.init_kv_cache(cfg, 1, 16, device=dev), prefill_from_zero=True,
                                     plain=True)[0]
        assert torch.isfinite(kern_logits.float()).all(), "32-layer prefill: non-finite logits"
        rel = float((kern_logits.float() - plain_logits.float()).abs().max() / plain_logits.float().abs().max())
        log(f"32-layer prefill (8 tokens), kernel vs plain path: max |dlogit| / max |logit| = {rel:.4g}")
        assert rel < 0.1, "32-layer prefill: kernel path far from the plain path"
        del kern_logits, plain_logits

        requests = [(8, None), (128, None), (200, None), (128, 2048)]
        new = 64
        gen.generate(params, ref_prompt, 4, config=cfg, temperature=0.0)  # warm-up, not counted
        torch.cuda.synchronize()
        totals = dict.fromkeys(counters, 0)
        for T, s in requests:
            prompt = torch.randint(0, cfg.vocab_size, (T,), generator=gcpu)
            for fn in counters.values():
                fn.launches = 0
            out = gen.generate(params, prompt, new, config=cfg, max_seq_length=s, temperature=0.0)
            got = {k: fn.launches for k, fn in counters.items()}
            prefill_s, total_s = wall_s(params, cfg, prompt, 1, s), wall_s(params, cfg, prompt, new, s)
            want = dict.fromkeys(counters, 0)
            want.update({"K1": cfg.n_layer * (new - 1), "K2": new - 1, "K3": 4 * cfg.n_layer + 1, "K4": cfg.n_layer})
            assert got == want, f"request T={T} S={s}: launches {got}, expected {want}"
            assert out.shape == (T + new,) and int(out.min()) >= 0 and int(out.max()) < V, "bad tokens"
            for k in totals:
                totals[k] += got[k]
            S_used = gen.plan_seq_length(cfg, T + new, s)
            tok_s = (new - 1) / (total_s - prefill_s)
            full[f"T={T},S={S_used}"] = dict(prefill_ms=prefill_s * 1e3, decode_tok_s=tok_s)
            log(f"request prompt {T} S={S_used}: prefill {prefill_s * 1e3:.1f} ms, "
                f"decode {tok_s:.1f} tok/s ({new} new tokens, launches {got})")

        # ---- 7b. the same model with the LoRA overlay: greedy requests beside the same
        # requests without it (timed without, with, with, without) ----------------------
        L = cfg.n_layer
        full_lora = {}
        gen.generate(params_l, ref_prompt, 4, config=lcfg, temperature=0.0)  # warm-up, not counted
        for T, s in ((8, None), (128, 2048)):
            prompt = torch.randint(0, cfg.vocab_size, (T,), generator=gcpu)
            for fn in counters.values():
                fn.launches = 0
            out = gen.generate(params_l, prompt, new, config=lcfg, max_seq_length=s, temperature=0.0)
            got = {k: fn.launches for k, fn in counters.items()}
            want = dict.fromkeys(counters, 0)
            want.update({"K1": L * (new - 1), "K1 LoRA": L * (new - 1), "K2": new - 1, "K3": 4 * L + 1, "K4": L})
            assert got == want, f"LoRA request T={T} S={s}: launches {got}, expected {want}"
            assert out.shape == (T + new,) and int(out.min()) >= 0 and int(out.max()) < V, "bad tokens"
            base_out = gen.generate(params, prompt, new, config=cfg, max_seq_length=s, temperature=0.0)
            differ = int((out != base_out).sum())
            for k in totals:
                totals[k] += got[k]
            tok_s, pre_ms = {}, {}
            for p_, c_ in ((params, cfg), (params_l, lcfg), (params_l, lcfg), (params, cfg)):
                prefill_s, total_s = wall_s(p_, c_, prompt, 1, s), wall_s(p_, c_, prompt, new, s)
                tok_s.setdefault("lora" if c_.lora else "base", []).append((new - 1) / (total_s - prefill_s))
                pre_ms.setdefault("lora" if c_.lora else "base", []).append(prefill_s * 1e3)
            S_used = gen.plan_seq_length(lcfg, T + new, s)
            full_lora[f"T={T},S={S_used}"] = dict(decode_tok_s=tok_s["lora"], decode_tok_s_without=tok_s["base"],
                                                   prefill_ms=pre_ms["lora"], prefill_ms_without=pre_ms["base"],
                                                   tokens_differing_from_base=differ)
            log(f"LoRA request prompt {T} S={S_used}: decode {tok_s['lora'][0]:.1f} / {tok_s['lora'][1]:.1f} tok/s, "
                f"without LoRA {tok_s['base'][0]:.1f} / {tok_s['base'][1]:.1f} tok/s; prefill "
                f"{pre_ms['lora'][0]:.1f} / {pre_ms['lora'][1]:.1f} ms, without {pre_ms['base'][0]:.1f} / "
                f"{pre_ms['base'][1]:.1f} ms (timed without, with, with, without); {differ} of {T + new} tokens "
                f"differ from the model without it; launches {got}")

        # ---- 8. the serving path: 64 requests through a 32-slot engine ---------------
        n_req, new_e, slots, S_e = 64, 32, 32, 256
        rng = np.random.default_rng(SEED)
        lens = np.exp(rng.uniform(np.log(8), np.log(max(9, S_e // 2)), n_req)).astype(int)  # log-uniform in [8, 128]
        prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).astype(np.int64) for n in lens]
        engine = DecodeEngine(params, cfg, max_batch=slots, max_seq_length=S_e, steps_per_sync=8)
        engine.warmup()
        torch.cuda.synchronize()
        steps0, prefills0 = engine.decode_steps, engine.prefills
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        ids = [engine.submit(p, new_e) for p in prompts]
        done = engine.run()
        wall = time.perf_counter() - t0
        got = {k: fn.launches for k, fn in counters.items()}
        steps, prefills = engine.decode_steps - steps0, engine.prefills - prefills0
        want = dict.fromkeys(counters, 0)
        want.update({"K3": prefills * (4 * L + 1) + steps, "K4": L * prefills, "K7": L * steps, "K8": L * steps,
                     "K9": L * steps})
        assert got == want, f"engine: launches {got}, expected {want}"
        assert prefills == n_req and steps > 0 and sorted(done) == ids and not engine.has_work()
        for i, p in zip(ids, prompts):
            toks = done[i].generated
            assert len(toks) == new_e and min(toks) >= 0 and max(toks) < V, f"request {i}: bad tokens"
        for i in (ids[0], ids[-1]):  # the first token comes from the same prefill as generate's
            alone = gen.generate(params, prompts[i - ids[0]], 1, config=cfg, temperature=0.0)
            assert int(alone[-1]) == done[i].generated[0], f"request {i}: first token differs from generate's"
        for k in totals:
            totals[k] += got[k]
        n_tok = sum(len(r.generated) for r in done.values())
        ttfts = sorted(r.ttft for r in done.values())
        serving = dict(requests=n_req, slots=slots, S=S_e, steps_per_sync=8, new_tokens=new_e,
                       prompt_tokens=int(lens.sum()), decode_steps=steps, prefills=prefills, wall_s=wall,
                       tok_s=n_tok / wall, ttft_p50_ms=ttfts[len(ttfts) // 2] * 1e3,
                       ttft_p95_ms=ttfts[int(len(ttfts) * 0.95)] * 1e3)
        log(f"engine, {slots} slots, S={S_e}, {n_req} requests (prompts {lens.min()}..{lens.max()}, "
            f"{new_e} new tokens each): {n_tok} tokens in {wall:.2f} s = {n_tok / wall:.1f} tok/s aggregate; "
            f"TTFT p50 {serving['ttft_p50_ms']:.0f} ms, p95 {serving['ttft_p95_ms']:.0f} ms (host clock); "
            f"{steps} decode steps, {prefills} prefills, launches {got}")

        del engine
        # ---- 8b. the serving path with LoRA: the same 64 requests, K7 with its operand
        engine = DecodeEngine(params_l, lcfg, max_batch=slots, max_seq_length=S_e, steps_per_sync=8)
        engine.warmup()
        torch.cuda.synchronize()
        steps0, prefills0 = engine.decode_steps, engine.prefills
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        ids = [engine.submit(p, new_e) for p in prompts]
        done = engine.run()
        wall = time.perf_counter() - t0
        got = {k: fn.launches for k, fn in counters.items()}
        steps, prefills = engine.decode_steps - steps0, engine.prefills - prefills0
        want = dict.fromkeys(counters, 0)
        want.update({"K3": prefills * (4 * L + 1) + steps, "K4": L * prefills, "K7": L * steps,
                     "K7 LoRA": L * steps, "K8": L * steps, "K9": L * steps})
        assert got == want, f"LoRA engine: launches {got}, expected {want}"
        assert prefills == n_req and steps > 0 and sorted(done) == ids and not engine.has_work()
        for i in (ids[0], ids[-1]):  # the first token comes from the same prefill as generate's
            alone = gen.generate(params_l, prompts[i - ids[0]], 1, config=lcfg, temperature=0.0)
            assert int(alone[-1]) == done[i].generated[0], f"LoRA request {i}: first token differs from generate's"
        for k in totals:
            totals[k] += got[k]
        n_tok = sum(len(r.generated) for r in done.values())
        ttfts = sorted(r.ttft for r in done.values())
        serving_lora = dict(decode_steps=steps, prefills=prefills, wall_s=wall, tok_s=n_tok / wall,
                            ttft_p50_ms=ttfts[len(ttfts) // 2] * 1e3, ttft_p95_ms=ttfts[int(len(ttfts) * 0.95)] * 1e3)
        log(f"engine with LoRA, {slots} slots, S={S_e}, the same {n_req} requests: {n_tok} tokens in {wall:.2f} s = "
            f"{n_tok / wall:.1f} tok/s aggregate; TTFT p50 {serving_lora['ttft_p50_ms']:.0f} ms, p95 "
            f"{serving_lora['ttft_p95_ms']:.0f} ms (host clock); {steps} decode steps, launches {got}")
        # the same requests once more, with LoRA and then without: the four engine
        # runs go without, with, with, without
        for tag, p_, c_, rec in (("with", params_l, lcfg, serving_lora), ("without", params, cfg, serving)):
            engine = DecodeEngine(p_, c_, max_batch=slots, max_seq_length=S_e, steps_per_sync=8)
            engine.warmup()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for p in prompts:
                engine.submit(p, new_e)
            n_tok = sum(len(r.generated) for r in engine.run().values())
            rec["tok_s_again"] = n_tok / (time.perf_counter() - t0)
            log(f"engine {tag} LoRA again: {rec['tok_s_again']:.1f} tok/s aggregate")

        return results, totals, full, serving, full_lora, serving_lora

    results, totals, full, serving, full_lora, serving_lora = int4_paths()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"int4 model and caches freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated")

    # ---- 8c. the probes P1-P5: the tool's cases, then each kernel vs plain, timed --
    probe_ids = {"dot_nt": "P1", "iota_mask_dots": "P2", "reshape3": "P3", "mv_small_n": "P4", "concat": "P5"}
    for fn, _, _ in probe_kernels.CASES.values():
        fn.launches = 0
    for name in probe_kernels.CASES:
        assert probe_kernels.main(["--case", name]) == 0
    for name, key in probe_ids.items():
        totals[key] = probe_kernels.CASES[name][0].launches
    proc = subprocess.run([sys.executable, "-m", "lit_llama_tpu_torch.tools.probe_kernels", "--all"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.count(": OK (") == 5, f"probe_kernels --all:\n{proc.stdout}{proc.stderr[-2000:]}"
    log("probe_kernels --all (a process a case):\n" + proc.stdout.strip())
    for name, key in probe_ids.items():
        fn, ref, _ = probe_kernels.CASES[name]
        args = probe_kernels.case_inputs(name, dev)
        got, want = fn(*args), ref(*args)
        err = float((got.float() - want.float()).abs().max())
        atol, rtol = probe_kernels.TOL[name]
        assert not bool(((got.float() - want.float()).abs() > atol + rtol * want.float().abs()).any()), f"{key} {name}: {err}"
        if name == "mv_small_n":
            x, w = args
            nbytes = x.numel() * 2 + sum(w[k].numel() * w[k].element_size() for k in fused_layer._DECODE_KEYS) + got.numel() * 4
            ops = 2 * x.numel() * got.shape[1]
            lib = None
        else:
            nbytes = sum(a.numel() * 4 for a in args) + got.numel() * 4
            ops = {"dot_nt": 2 * got.numel() * 128, "reshape3": 2 * got.numel() * 128,
                   "iota_mask_dots": 2 * 4 * 256 * 128 + 2 * 4 * 256 * 64, "concat": got.numel()}[name]
            a0 = args[0]
            lib = {"dot_nt": lambda: torch.matmul(a0, args[1].t()),
                   "reshape3": lambda: torch.matmul(a0, args[1].reshape(-1, 128).t()),
                   "iota_mask_dots": lambda: torch.bmm(a0[:, None, :], args[1].reshape(4, 64, 128).transpose(1, 2)),
                   "concat": None}[name]
            if name == "concat":
                scale = (torch.arange(512, device=dev) // 128 + 1).float()
                lib = lambda: a0 * scale
        b = bound_ms(nbytes, ops, f32_peak)
        results[key] = dict(shape=name, ms=time_ms(lambda: fn(*args)), plain_ms=time_ms(lambda: ref(*args), 3),
                            library_ms=time_ms(lib) if lib else None, bound_ms=b[0], bound_by=b[1], max_abs_err=err)
        log(f"{key} {name}: {results[key]['ms'] * 1e3:.1f} us (bound {b[0] * 1e3:.3f} us, {b[1]}), plain "
            f"{results[key]['plain_ms'] * 1e3:.1f} us, max |err| {err:.3g}")

    # ---- 8d. the entry points in subprocesses: generate.base and generate.lora ------
    import tempfile

    from lit_llama_tpu_torch.data import sft
    from lit_llama_tpu_torch.data import sp_model
    from lit_llama_tpu_torch.data.tokenizer import Tokenizer
    from lit_llama_tpu_torch.peft import lora as lora_mod
    from lit_llama_tpu_torch.utils.convert import lora_overlay_to_sd, pytree_to_lit
    from lit_llama_tpu_torch.utils.loader import load_model

    work_e = Path(tempfile.mkdtemp(prefix="chip_smoke_entry_"))
    # a BPE tokenizer of 128 pieces, written by the port's serialize_model; the
    # model's vocabulary is the same 128, so every id it generates decodes
    letters = "abcdefghijklmnopqrstuvwxyz"
    pieces = [sp_model.Piece("<unk>", 0.0, sp_model.UNKNOWN), sp_model.Piece("<s>", 0.0, sp_model.CONTROL),
              sp_model.Piece("</s>", 0.0, sp_model.CONTROL), sp_model.Piece(sp_model.WS, -1.0)]
    pieces += [sp_model.Piece(c, -2.0 - i) for i, c in enumerate(letters + "?.,'")]
    merges = [sp_model.WS + c for c in letters] + [a + b for a in "aeiou" for b in letters]
    pieces += [sp_model.Piece(m, -100.0 - i) for i, m in enumerate(merges[: 128 - len(pieces)])]
    assert len(pieces) == 128
    (work_e / "tokenizer.model").write_bytes(sp_model.serialize_model(sp_model.SPModel(pieces=pieces, model_type=2)))
    ce = LLaMAConfig(n_layer=2, n_head=32, n_embd=4096, vocab_size=128, param_dtype="bfloat16",
                     compute_dtype="bfloat16", lora=LoRAConfig(r=8, alpha=16.0, dropout=0.0))
    dense = llama.init_params(ce.replace(lora=None), torch.Generator(device=dev).manual_seed(SEED + 3), device=dev)
    torch.save(pytree_to_lit(dense, ce), work_e / "lit-llama.pth")
    del dense
    (work_e / "config.json").write_text(json.dumps(dict(n_layer=2, n_head=32, n_embd=4096, vocab_size=128)))
    overlay_e = random_lora_overlay(ce, seed=SEED + 4, device=dev)
    torch.save(lora_overlay_to_sd(overlay_e, ce), work_e / "lora.pth")
    tok_e = Tokenizer(work_e / "tokenizer.model")
    new_e4 = 24
    entry_runs = {}
    for entry in ("base", "lora"):
        params_e, cfg_e = load_model(work_e / "lit-llama.pth", "gptq.int4", device=dev)
        if entry == "lora":
            params_e = lora_mod.load_lora_state(params_e, overlay_e)
            cfg_e = cfg_e.replace(lora=ce.lora)
            enc = tok_e.encode(sft.generate_prompt({"instruction": "What food do lamas eat?", "input": ""}))
        else:
            enc = tok_e.encode("Hello, my name is")
        params_e, cfg_e = fused_layer.maybe_prepare_fused(llama.unstack_layers(params_e), cfg_e)
        assert cfg_e.rope_layout == "half", "the entry point's model should take the fused step"
        fused_layer.k1_lora.launches = 0
        want_e = gen.generate(params_e, enc, new_e4, config=cfg_e, temperature=0.0, top_k=200,
                              eos_id=tok_e.eos_id if entry == "lora" else None).tolist()
        assert fused_layer.k1_lora.launches == (2 * (len(want_e) - len(enc) - 1) if entry == "lora" else 0)
        del params_e
        cmd = [sys.executable, "-m", f"lit_llama_tpu_torch.generate.{entry}", "--checkpoint_path",
               str(work_e / "lit-llama.pth"), "--tokenizer_path", str(work_e / "tokenizer.model"), "--quantize",
               "gptq.int4", "--temperature", "0", "--max_new_tokens", str(new_e4)]
        if entry == "lora":
            cmd += ["--lora_path", str(work_e / "lora.pth")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
        took = time.perf_counter() - t0
        assert proc.returncode == 0, f"generate.{entry} exited {proc.returncode}:\n{proc.stderr[-3000:]}"
        got_e = json.loads(proc.stderr.split("Token ids" + (" 1" if entry == "base" else "") + ": ")[-1].splitlines()[0])
        assert got_e == want_e, f"generate.{entry}: tokens {got_e} differ from the in-process generate's {want_e}"
        assert proc.stdout.strip(), f"generate.{entry} printed no text"
        entry_runs[entry] = dict(seconds=took, new_tokens=len(got_e) - len(enc))
        log(f"python -m lit_llama_tpu_torch.generate.{entry} (2 layers at 7B width, int4 at load"
            f"{', reference-format LoRA .pth' if entry == 'lora' else ''}): exit 0 in {took:.1f} s, "
            f"{len(got_e) - len(enc)} greedy tokens equal to the in-process generate's; text {proc.stdout.strip()[:80]!r}")
    import shutil

    shutil.rmtree(work_e)
    del overlay_e
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 9. the per-op int8 path: the 7B int8 model, K6 vs plain ---------------
    cfg8 = LLaMAConfig.from_name("7B", param_dtype="bfloat16", compute_dtype="bfloat16", quantize="int8")
    D, I, H, hs, V, L = (cfg8.n_embd, cfg8.intermediate_size, cfg8.n_head, cfg8.head_size,
                         cfg8.padded_vocab_size, cfg8.n_layer)
    t0 = time.perf_counter()
    params8 = llama.unstack_layers(random_int8_params(cfg8, seed=SEED, device=dev))
    torch.cuda.synchronize()
    log(f"random 7B int8 params: {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    rope = build_rope_cache(cfg8.block_size, hs, device=dev)
    lp8 = params8["h"][0]
    odd8 = {"qw": torch.randint(-127, 128, (1000, 1040), generator=gcpu, dtype=torch.int8).to(dev),
            "qscale": torch.empty(1, 1040).uniform_(0.0002, 0.0004, generator=gcpu).to(dev)}
    linears8 = [("c_attn", lp8["attn"]["c_attn"]), ("attn.c_proj", lp8["attn"]["c_proj"]),
                ("c_fc12", lp8["mlp"]["c_fc12"]), ("mlp.c_proj", lp8["mlp"]["c_proj"]),
                ("lm_head", params8["lm_head"]), ("odd", odd8)]  # odd: K % 64 != 0, N % 128 != 0
    errs, k6_shapes = [], {}
    for lname, w in linears8:
        K, N = w["qw"].shape
        wd = dequantize_int8(w, torch.bfloat16)
        for M in (1, 8, 128, 200):
            x = randn(M, K)
            args = (x, w["qw"], w["qscale"])
            errs.append(max_err(quant_matmul.matmul_int8(*args), quant_matmul.matmul_int8_ref(*args), "K6"))
            ms = time_ms(lambda: quant_matmul.matmul_int8(*args))
            lib = time_ms(lambda: torch.matmul(x, wd))
            # M = 1 runs on the CUDA cores (f32), M > 1 on the tensor cores
            b6 = bound_ms(M * K * 2 + K * N + N * 4 + M * N * 2, 2 * M * K * N, f32_peak if M == 1 else tc_peak)
            k6_shapes[f"{lname} {K}->{N} M={M}"] = dict(ms=ms, bound_ms=b6[0], bound_by=b6[1], library_ms=lib)
            log(f"K6 M={M} {lname} {K}->{N}: {ms * 1e3:.1f} us, bound {b6[0] * 1e3:.1f} us ({b6[1]}), "
                f"torch.matmul on the dequantized bf16 weight {lib * 1e3:.1f} us")
            if M == 1 and lname == "c_fc12":
                k6 = dict(shape=f"M={M} K={K} N={N} (c_fc12, one decode token)", ms=ms, library_ms=lib,
                          plain_ms=time_ms(lambda: quant_matmul.matmul_int8_ref(*args), 3),
                          bound_ms=b6[0], bound_by=b6[1])
        del wd
    results["K6"] = dict(k6, max_abs_err=max(errs))
    del odd8, linears8

    # ---- 10. K5 vs plain: bf16 cache and int8 cache ------------------------------
    k5_shapes = {}
    errs5 = {"K5": 0.0, "K5q": 0.0}
    for B, S5 in ((1, 2048), (1, 256), (1, 72), (8, 2048)):  # S = 72: the short request's cache
        q5 = randn(B, 1, H, hs).transpose(1, 2)  # (B, H, 1, hs) as the model hands it over
        kf, vf = randn(B, H, S5, hs, scale=0.5), randn(B, H, S5, hs, scale=0.5)
        (kq, ksc), (vq, vsc) = llama._quantize_kv(kf), llama._quantize_kv(vf)
        # limits: row 0 only, the middle of a 64-row block, S - 1, past S (every row)
        limit_sets = ([[0], [S5 // 2 + 7], [S5 - 1], [S5 + 5]] if B == 1 else
                      [[0, S5 // 2 + 7, S5 - 1, S5, 5000, 63, 64, 1000]])
        every_row = torch.full((B,), S5 - 1, dtype=torch.int32, device=dev)
        vis5 = (torch.arange(S5, device=dev)[None, :] <= every_row[:, None])[:, None, None, :]
        for key, (k5, v5, ks5, vs5) in (("K5", (kf, vf, None, None)), ("K5q", (kq, vq, ksc, vsc))):
            for lims in limit_sets:
                lim = torch.tensor(lims, dtype=torch.int32, device=dev)
                errs5[key] = max(errs5[key], max_err(da.decode_attention(q5, k5, v5, ks5, vs5, lim),
                                                     da.decode_attention_ref(q5, k5, v5, ks5, vs5, lim), "K5"))
            quant = ks5 is not None
            nbytes = (2 * B * H * S5 * hs * (1 if quant else 2) + (2 * B * H * S5 * 4 if quant else 0)
                      + 2 * B * H * hs * 2 + B * 4)
            b5 = bound_ms(nbytes, 4 * B * H * S5 * hs, f32_peak)
            ms5 = time_ms(lambda: da.decode_attention(q5, k5, v5, ks5, vs5, every_row))
            y_max = float(da.decode_attention_ref(q5, k5, v5, ks5, vs5, every_row).float().abs().max())
            # the library call works on a cache that is already dequantized to bf16
            kd, vd = ((kq.float() * ksc).to(torch.bfloat16), (vq.float() * vsc).to(torch.bfloat16)) if quant else (kf, vf)
            lib5 = time_ms(lambda: F.scaled_dot_product_attention(q5, kd, vd, attn_mask=vis5))
            cache_name = "int8" if quant else "bf16"
            k5_shapes[f"{cache_name} B={B} S={S5}"] = dict(ms=ms5, bound_ms=b5[0], bound_by=b5[1], library_ms=lib5)
            log(f"K5 {cache_name} cache B={B} S={S5}, every row visible: {ms5 * 1e3:.1f} us, bound "
                f"{b5[0] * 1e3:.1f} us ({b5[1]}), SDPA with the mask {lib5 * 1e3:.1f} us; max |y| {y_max:.3g}, "
                f"max |kernel - plain| over the limits so far {errs5[key]:.3g} (atol {TOL['K5'][0]})")
            if (B, S5) == (1, 2048):
                results[key] = dict(
                    shape=f"B={B} H={H} S={S5} hs={hs}, {cache_name} cache, every row visible", ms=ms5,
                    plain_ms=time_ms(lambda: da.decode_attention_ref(q5, k5, v5, ks5, vs5, every_row), 3),
                    library_ms=lib5, bound_ms=b5[0], bound_by=b5[1])
            del kd, vd
        del kf, vf, kq, vq, ksc, vsc, k5, v5, ks5, vs5
    for key in errs5:
        results[key]["max_abs_err"] = errs5[key]

    # ---- 11. full width, 2 blocks, per-op path: kernel path vs plain path --------
    p2 = dict(params8, h=params8["h"][:2])
    # 4 chunks of 64 rows, so K5 merges chunks inside the model; the 197-token
    # prompt and 8 steps pass S: the last 5 steps roll the cache left
    S2 = 200
    prompt = torch.randint(0, cfg8.vocab_size, (1, 197), generator=gcpu).to(dev)
    for kvd in (None, "int8"):
        c2 = cfg8.replace(n_layer=2, kv_cache_dtype=kvd)
        caches = {plain: llama.init_kv_cache(c2, 1, S2, device=dev) for plain in (False, True)}
        logits = {plain: llama.forward(p2, prompt, c2, rope_cache=rope, kv_cache=caches[plain],
                                       prefill_from_zero=True, plain=plain)[0] for plain in (False, True)}
        errs = [model_err(logits[False], logits[True], f"2-layer int8 prefill, {kvd or 'bf16'} cache")]
        tok = logits[False][:, -1].float().argmax(-1)  # (1,)
        for step in range(8):
            pos = prompt.shape[1] + step
            lg = {plain: llama.forward(p2, tok[None], c2, rope_cache=rope, input_pos=[pos],
                                       kv_cache=caches[plain], plain=plain)[0][:, -1] for plain in (False, True)}
            errs.append(model_err(lg[False], lg[True], f"2-layer int8 decode step {step}, {kvd or 'bf16'} cache"))
            tok = lg[False].float().argmax(-1)
        log(f"2-layer 7B-width int8 model, per-op path (K4, K5, K6), {kvd or 'bf16'} KV cache, S={S2}, kernel vs "
            f"plain path: prefill max |dlogit| {errs[0]:.4g}, 8 decode steps (5 past S) max {max(errs[1:]):.4g}")
    del caches, logits, lg, p2

    # ---- 12. the per-op path on the full model: three greedy requests -------------
    ref_prompt = torch.randint(0, cfg8.vocab_size, (8,), generator=gcpu)
    both = [llama.forward(params8, ref_prompt[None].to(dev), cfg8, rope_cache=rope,
                          kv_cache=llama.init_kv_cache(cfg8, 1, 16, device=dev), prefill_from_zero=True,
                          plain=plain)[0].float() for plain in (False, True)]
    assert torch.isfinite(both[0]).all(), "32-layer int8 prefill: non-finite logits"
    rel = float((both[0] - both[1]).abs().max() / both[1].abs().max())
    log(f"32-layer int8 prefill (8 tokens), kernel vs plain path: max |dlogit| / max |logit| = {rel:.4g}")
    assert rel < 0.1, "32-layer int8 prefill: kernel path far from the plain path"
    del both

    new = 64
    gen.generate(params8, ref_prompt, 4, config=cfg8, temperature=0.0)  # warm-up, not counted
    torch.cuda.synchronize()
    full8 = {}
    totals.update({"K5": 0, "K5q": 0, "K6": 0})
    for T, s, kvd in ((8, None, None), (128, 2048, None), (128, 2048, "int8")):
        c8 = cfg8.replace(kv_cache_dtype=kvd)
        prompt = torch.randint(0, cfg8.vocab_size, (T,), generator=gcpu)
        for fn in counters.values():
            fn.launches = 0
        out = gen.generate(params8, prompt, new, config=c8, max_seq_length=s, temperature=0.0)
        got = {k: fn.launches for k, fn in counters.items()}
        prefill_s, total_s = wall_s(params8, c8, prompt, 1, s), wall_s(params8, c8, prompt, new, s)
        want = dict.fromkeys(counters, 0)
        want.update({"K4": L, "K5": L * (new - 1), "K6": (4 * L + 1) * new})
        assert got == want, f"int8 request T={T} S={s} kv={kvd}: launches {got}, expected {want}"
        assert out.shape == (T + new,) and int(out.min()) >= 0 and int(out.max()) < V, "bad tokens"
        totals["K4"] += got["K4"]
        totals["K6"] += got["K6"]
        totals["K5q" if kvd else "K5"] += got["K5"]
        S_used = gen.plan_seq_length(c8, T + new, s)
        tok_s = (new - 1) / (total_s - prefill_s)
        full8[f"T={T},S={S_used},kv={kvd or 'bf16'}"] = dict(prefill_ms=prefill_s * 1e3, decode_tok_s=tok_s)
        log(f"int8 request prompt {T} S={S_used} {kvd or 'bf16'} KV cache: prefill {prefill_s * 1e3:.1f} ms, "
            f"decode {tok_s:.1f} tok/s ({new} new tokens, launches K4 {got['K4']}, K5 {got['K5']}, K6 {got['K6']})")

    del params8, lp8
    gc.collect()
    torch.cuda.empty_cache()
    log(f"int8 model freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated")

    from lit_llama_tpu_torch.ops import attention as attn_mod
    from lit_llama_tpu_torch.training import loop as loop_lib
    from lit_llama_tpu_torch.training import step as step_lib

    def k10_err(got, want, what, tol=TOL_K10):
        """Holds got to want by tol (TOL_K10's form). Returns max |got - want|,
        max |want| and the row part this pair needed: the largest (|err| -
        rel * |want|) / rowmax, which tol["row"] bounds."""
        got, want = got.float(), want.float()
        assert torch.isfinite(got).all(), f"{what}: non-finite kernel output"
        err, mag = (got - want).abs(), want.abs()
        top = float(mag.max())
        rowmax = mag.amax(-1, keepdim=True).clamp_min(tol["floor"] * top)
        need = float(((err - tol["rel"] * mag).clamp_min(0) / rowmax).max())
        assert need <= tol["row"], (f"{what}: row part {need:.3g} needed, {tol['row']} allowed; max err "
                                    f"{float(err.max()):.3g}, max |plain| {top:.3g}")
        return float(err.max()), top, need

    # ---- 13. K10 vs plain, and the K4 + K10 Function end to end -------------------
    cfgt = LLaMAConfig.from_name("7B", param_dtype="float32", compute_dtype="bfloat16")
    H, hs = cfgt.n_head, cfgt.head_size
    errs10 = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    for B, Hh, T in ((1, H, 2048), (2, H, 200), (1, 4, 64), (1, 2, 65)):
        q, k, v, do = (randn(B, Hh, T, hs) for _ in range(4))
        o, lse = fa.flash_attention(q, k, v)
        got = fa.flash_attention_backward(q, k, v, o, lse, do)
        want = fa.flash_attention_bwd_ref(q, k, v, o, lse, do)
        again = fa.flash_attention_backward(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        line = []
        for name, g, w, a in zip(("dq", "dk", "dv"), got, want, again):
            err, top, need = k10_err(g, w, f"K10 {name} (B, H, T) = {(B, Hh, T)}")
            assert torch.equal(g, a), f"K10 {name}: two runs differ (the kernels use no atomics)"
            errs10[name] = max(errs10[name], err)
            line.append(f"{name} max err {err:.3g} (max |plain| {top:.3g}, row part needed {need:.3g})")
        log(f"K10 (B, H, T) = {(B, Hh, T)}: " + ", ".join(line) + "; a second run identical")
        if T == 2048:
            nrow = B * Hh * T
            pairs = B * Hh * T * (T + 1) // 2  # causal (query, key) pairs
            b_dq = bound_ms(5 * nrow * hs * 2 + nrow * 4 + nrow * hs * 2 + nrow * 4, 3 * 2 * hs * pairs, tc_peak)
            b_dkv = bound_ms(4 * nrow * hs * 2 + 2 * nrow * 4 + 2 * nrow * hs * 2, 4 * 2 * hs * pairs, tc_peak)
            dq, dd = fa.flash_backward_dq(q, k, v, o, lse, do)
            ms_dq = time_ms(lambda: fa.flash_backward_dq(q, k, v, o, lse, do))
            ms_dkv = time_ms(lambda: fa.flash_backward_dkv(q, k, v, do, lse, dd))
            plain10 = time_ms(lambda: fa.flash_attention_bwd_ref(q, k, v, o, lse, do), 3)
            qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
            sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
            lib10 = time_ms(lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), do, retain_graph=True))
            ms_k4 = time_ms(lambda: fa.flash_attention(q, k, v))
            log(f"K10 at (B, H, T, hs) = {(B, Hh, T, hs)}: dq {ms_dq * 1e3:.1f} us (bound {b_dq[0] * 1e3:.1f}, "
                f"{b_dq[1]}), dkv {ms_dkv * 1e3:.1f} us (bound {b_dkv[0] * 1e3:.1f}, {b_dkv[1]}); plain version "
                f"(dq, dk, dv) {plain10 * 1e3:.1f} us; SDPA causal backward (dq, dk, dv) {lib10 * 1e3:.1f} us; "
                f"K4 forward at this shape {ms_k4 * 1e3:.1f} us")
            shape = f"B={B} H={Hh} T={T} hs={hs}"
            results["K10dq"] = dict(shape=shape, ms=ms_dq, plain_ms=plain10, library_ms=lib10,
                                    bound_ms=b_dq[0], bound_by=b_dq[1])
            results["K10dkv"] = dict(shape=shape, ms=ms_dkv, plain_ms=plain10, library_ms=lib10,
                                     bound_ms=b_dkv[0], bound_by=b_dkv[1])
            # the Function: K4 + K10 grads against autograd of the plain attention
            mask = torch.ones(T, T, dtype=torch.bool, device=dev).tril()
            xs = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            attn_mod.attention(*xs, mask, causal=True).backward(do)
            refs = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            attn_mod.attention_ref(*refs, mask).backward(do)
            fn_errs = [k10_err(x.grad, r.grad, f"Function grad of {n}", TOL_FUNCTION)
                       for n, x, r in zip("qkv", xs, refs)]
            log(f"K4 + K10 through the autograd Function vs autograd of attention_ref at {(B, Hh, T)}: "
                + ", ".join(f"{n} max |dgrad| {e[0]:.3g} ({e[2]:.3g} of max |grad| beyond 2e-2 |grad|)"
                            for n, e in zip("qkv", fn_errs)))
            del qs, ks, vs, sdpa_out, xs, refs, dq, dd
        del q, k, v, do, o, lse, got, want, again
    results["K10dq"]["max_abs_err"] = errs10["dq"]
    results["K10dkv"]["max_abs_err"] = max(errs10["dk"], errs10["dv"])

    # ---- 14. 2 layers at full width, one training step: kernel path vs plain path --
    c14 = cfgt.replace(n_layer=2)
    p14 = llama.init_params(c14, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    init14 = {n: t.clone() for n, t in step_lib.tree_leaves(p14).items()}
    toks14 = torch.randint(0, c14.vocab_size, (1, 1, 2049), generator=gcpu).to(dev)
    ids14, tgt14 = toks14[..., :-1], toks14[..., 1:]
    grads14, after14, losses14 = {}, {}, {}
    for plain in (False, True):
        leaves = step_lib.tree_leaves(p14)
        for n, t in leaves.items():
            t.data.copy_(init14[n])
            t.requires_grad_(True)
        for fn in counters.values():
            fn.launches = 0
        fa.flash_backward_dq.launches = fa.flash_backward_dkv.launches = 0
        loss = step_lib.loss_fn(p14, ids14[0], tgt14[0], c14, remat=True, remat_policy="dots", plain=plain)
        got = torch.autograd.grad(loss, list(leaves.values()))
        torch.cuda.synchronize()
        n_k4, n_dq, n_dkv = fa.flash_attention.launches, fa.flash_backward_dq.launches, fa.flash_backward_dkv.launches
        want = (0, 0, 0) if plain else (2 * c14.n_layer, c14.n_layer, c14.n_layer)
        assert (n_k4, n_dq, n_dkv) == want, f"2-layer grads, plain={plain}: K4/K10 launches {(n_k4, n_dq, n_dkv)}, expected {want}"
        grads14[plain] = dict(zip(leaves, got))
        losses14[plain] = float(loss.detach())
        for t in leaves.values():
            t.requires_grad_(False)
        del loss, got
    gerrs, gabs = {}, {}
    for n, g in grads14[False].items():
        w = grads14[True][n]
        assert torch.isfinite(g).all(), f"2-layer grads: non-finite grad of {n}"
        top = float(w.abs().max())
        assert top > 0, f"2-layer grads: the plain path gives {n} no grad"
        gabs[n] = float((g - w).abs().max())
        gerrs[n] = (gabs[n] / top, float((g - w).norm() / w.norm()))
        assert gerrs[n][0] <= TOL_TRAIN_GRAD["max"] and gerrs[n][1] <= TOL_TRAIN_GRAD["rms"], \
            f"2-layer grads: {n} off by {gerrs[n][0]:.3g} of its max |grad|, {gerrs[n][1]:.3g} of its RMS"
    assert abs(losses14[False] - losses14[True]) <= 1e-2 * abs(losses14[True]), f"2-layer loss {losses14}"
    log(f"2-layer 7B-width training forward + backward (B=1, T=2048, remat dots), kernel vs plain path: loss "
        f"{losses14[False]:.5f} vs {losses14[True]:.5f}; every leaf has a finite grad (c_attn included); "
        f"per leaf max |dgrad| / max |grad| and RMS(dgrad) / RMS(grad): "
        + ", ".join(f"{n} {a:.3g} / {b:.3g}" for n, (a, b) in gerrs.items()))
    lr14 = 6e-4
    for plain in (False, True):
        for n, t in step_lib.tree_leaves(p14).items():
            t.copy_(init14[n])
        opt14 = step_lib.make_optimizer(step_lib.TrainConfig(learning_rate=lr14, warmup_iters=0, max_iters=10))
        st14 = step_lib.init_train_state(p14, opt14)
        st14, _ = step_lib.train_step(st14, ids14, tgt14, c14, opt14, True, "dots", plain)
        after14[plain] = {n: t.clone() for n, t in step_lib.tree_leaves(st14.params).items()}
        del st14, opt14
    uerrs = {}
    for n, w in after14[True].items():
        diff = ((after14[False][n] - init14[n]) - (w - init14[n])).abs()
        may_flip = grads14[True][n].abs() <= 2 * gabs[n]
        bad = diff > lr14 * (TOL_TRAIN_UPDATE + 2 * may_flip)
        assert not bad.any(), f"2-layer train_step: {int(bad.sum())} elements of {n} off, max {float(diff.max()):.3g}"
        steady = diff[~may_flip]
        uerrs[n] = (float(steady.max()) / lr14 if steady.numel() else 0.0, float(may_flip.float().mean()),
                    float((diff > lr14).float().mean()))
    log("2-layer train_step, kernel vs plain path: per leaf max |dupdate| / lr where the grad is clear of 0, "
        "share of elements near 0, share that stepped the other way: "
        + ", ".join(f"{n} {a:.3g} / {b:.3g} / {c:.3g}" for n, (a, b, c) in uerrs.items()))
    del p14, init14, after14, grads14
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 15. 8 layers at full width: pretraining through the library path --------
    import tempfile

    from lit_llama_tpu_torch.data.packed_dataset import PackedDatasetBuilder
    from lit_llama_tpu_torch.pretrain.redpajama import create_dataloader
    from lit_llama_tpu_torch.utils.checkpoint import load_checkpoint

    c15 = cfgt.replace(n_layer=8)
    L15, T15, mb15, acc15 = c15.n_layer, c15.block_size, 2, 2
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    builder = PackedDatasetBuilder(str(work / "data"), "cc", chunk_size=(T15 + 1) * 4, sep_token=0,
                                   dtype="auto", vocab_size=c15.vocab_size)
    (work / "data").mkdir()
    block = np.random.default_rng(SEED).integers(1, c15.vocab_size, size=T15 + 1).astype(builder.dtype)
    for _ in range(16):  # 4 chunks of 4 copies of one block: the model can memorize it
        builder.add_array(block)
    builder.write_reminder()
    batches = create_dataloader(work / "data", T15 + 1, acc15, mb15, seed=1338)()
    tc15 = step_lib.TrainConfig(learning_rate=6e-4, min_lr=6e-5, warmup_iters=1, max_iters=7)
    opt15 = step_lib.make_optimizer(tc15)
    st15 = step_lib.init_train_state(llama.init_params(c15, torch.Generator(device=dev).manual_seed(SEED),
                                                       device=dev), opt15)
    n_params = sum(t.numel() for t in step_lib.tree_leaves(st15.params).values())
    recs = []
    st15 = loop_lib.train(st15, batches, c15, opt15, loop_lib.LoopConfig(out_dir=work / "out", max_iters=1,
                                                                         save_interval=0), log_fn=recs.append)
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    fa.flash_backward_dq.launches = fa.flash_backward_dkv.launches = 0
    torch.cuda.reset_peak_memory_stats()
    recs = []
    t0 = time.perf_counter()
    st15 = loop_lib.train(st15, batches, c15, opt15, loop_lib.LoopConfig(out_dir=work / "out", max_iters=7,
                                                                         save_interval=0), log_fn=recs.append)
    torch.cuda.synchronize()
    wall15 = time.perf_counter() - t0
    peak15 = torch.cuda.max_memory_allocated()
    n_steps = len(recs)
    got = {k: fn.launches for k, fn in counters.items()}
    got.update({"K10dq": fa.flash_backward_dq.launches, "K10dkv": fa.flash_backward_dkv.launches})
    want = dict.fromkeys(counters, 0)
    want.update({"K4": 2 * L15 * acc15 * n_steps, "K10dq": L15 * acc15 * n_steps, "K10dkv": L15 * acc15 * n_steps})
    assert n_steps == 6 and st15.step == 7, f"pretraining ran {n_steps} steps to step {st15.step}, expected 6 to 7"
    assert got == want, f"pretraining: launches {got}, expected {want}"
    losses = [r["loss"] for r in recs]
    assert all(np.isfinite(losses)), f"pretraining: losses {losses}"
    assert losses[-1] < losses[0], f"pretraining: the loss did not fall: {losses}"
    flops_tok, n_mfu = step_lib.flops_per_token(c15)
    tokens15 = acc15 * mb15 * T15
    step_s = sorted(r["dt_ms"] for r in recs)[n_steps // 2] / 1e3
    mfu = flops_tok * tokens15 / step_s / tc_peak
    training = dict(n_layer=L15, n_embd=c15.n_embd, T=T15, micro_batch=mb15, accum=acc15, params=n_params,
                    steps=n_steps, losses=losses, step_ms=step_s * 1e3, wall_ms_per_step=wall15 / n_steps * 1e3,
                    tokens_per_s=tokens15 / step_s, mfu=mfu, peak_gib=peak15 / 2**30, launches=got)
    log(f"pretraining, 7B width, {L15} layers ({n_params / 1e9:.3f} B params, f32 weights + f32 Adam moments), "
        f"T={T15}, micro-batch {mb15} x {acc15} accumulation, remat dots: 6 steps after 1 warm-up, losses "
        f"{losses}; median step {step_s * 1e3:.1f} ms (host clock, ends in the loss's copy to the host; "
        f"{wall15 / n_steps * 1e3:.1f} ms/step over the whole run), {tokens15 / step_s:.0f} tokens/s, "
        f"MFU {100 * mfu:.1f} % = (6 N + 6 L T D) * tokens / step time / {tc_peak / 1e12:.0f} TF/s with "
        f"N = {n_mfu / 1e9:.3f} B (non-embedding + lm_head), recompute not counted; peak memory "
        f"{peak15 / 2**30:.2f} GiB (max_memory_allocated); launches {got}")
    totals["K4"] += got["K4"]
    totals["K10dq"], totals["K10dkv"] = got["K10dq"], got["K10dkv"]
    del st15, opt15, batches
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 16. the entry point: save, then resume, in a subprocess ----------------
    data16 = work / "data16"
    data16.mkdir()
    b16 = PackedDatasetBuilder(str(data16), "cc", chunk_size=257 * 4, sep_token=0, dtype="auto", vocab_size=512)
    for _ in range(20):
        b16.add_array(np.random.default_rng(SEED + 1).integers(1, 512, size=257).astype(b16.dtype))
    b16.write_reminder()
    cmd = [sys.executable, "-m", "lit_llama_tpu_torch.pretrain.redpajama", "--train_data_dir", str(data16),
           "--n_layer", "2", "--n_embd", "256", "--n_head", "2", "--block_size", "256", "--vocab_size", "512",
           "--batch_size", "2", "--micro_batch_size", "1", "--max_iters", "3", "--save_interval", "2",
           "--warmup_iters", "1"]
    t0 = time.perf_counter()
    for out, extra in (("run", []), ("resumed", ["--resume", str(work / "run" / "iter-000002")])):
        proc = subprocess.run(cmd + ["--out_dir", str(work / out)] + extra, cwd=ROOT, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode == 0, f"pretrain.redpajama ({out}) exited {proc.returncode}:\n{proc.stderr[-3000:]}"
    recs16 = {out: [json.loads(x) for x in (work / out / "metrics.jsonl").read_text().splitlines()]
              for out in ("run", "resumed")}
    assert [r["iter"] for r in recs16["run"]] == [0, 1, 2], recs16["run"]
    assert [r["iter"] for r in recs16["resumed"]] == [2], recs16["resumed"]
    assert all(np.isfinite(r["loss"]) for rs in recs16.values() for r in rs)
    for out in ("run", "resumed"):
        final = load_checkpoint(work / out / "final")
        assert "wte" in final["params"] and "count" in final["opt_state"], sorted(final)
        assert int(final["step"]) == 3, f"{out}: final step {int(final['step'])}"
    assert int(load_checkpoint(work / "run" / "iter-000002")["step"]) == 2
    log(f"pretrain.redpajama entry point (2 layers, n_embd 256, T 256): 3 steps saving iter-000002 and final, "
        f"then --resume iter-000002 to step 3: metrics {recs16}, final step 3 in both; "
        f"{time.perf_counter() - t0:.1f} s for the two processes")
    import shutil

    shutil.rmtree(work)

    kernels = []
    sources = {
        "K1": ("decode_layers_fused", "lit_llama_tpu/ops/fused_layer.py:446"),
        "K1 LoRA": ("decode_layers_fused with the LoRA operand (lora_down + lora_up)",
                    "lit_llama_tpu/ops/fused_layer.py:567"),
        "K2": ("lm_head_fused", "lit_llama_tpu/ops/fused_layer.py:894"),
        "K3": ("matmul_int4", "lit_llama_tpu/ops/quant_matmul_pallas.py:172"),
        "K4": ("flash_attention", "lit_llama_tpu/ops/flash_attention.py:52"),
        "K5": ("decode_attention (bf16 cache)", "lit_llama_tpu/ops/decode_attention.py:44"),
        "K5q": ("decode_attention (int8 cache)", "lit_llama_tpu/ops/decode_attention.py:44"),
        "K6": ("matmul_int8", "lit_llama_tpu/ops/quant_matmul_pallas.py:48"),
        "K7": ("block_head_fused", "lit_llama_tpu/ops/fused_layer.py:956"),
        "K7 LoRA": ("block_head_fused with the LoRA operand (ax in the prologue, the update in the epilogue)",
                    "lit_llama_tpu/ops/fused_layer.py:970"),
        "K8": ("decode_attention_write_pipelined", "lit_llama_tpu/ops/decode_attention.py:473"),
        "K8b": ("decode_attention_write_pallas", "lit_llama_tpu/ops/decode_attention.py:226"),
        "K9": ("block_tail_fused", "lit_llama_tpu/ops/fused_layer.py:981"),
        "K10dq": ("flash_backward_dq (flash-attention backward, dQ)", "lit_llama_tpu/ops/flash_attention.py:182"),
        "K10dkv": ("flash_backward_dkv (flash-attention backward, dK and dV)",
                   "lit_llama_tpu/ops/flash_attention.py:216"),
        "P1": ("probe dot_nt", "scripts/probe_mosaic.py:39"),
        "P2": ("probe iota_mask_dots", "scripts/probe_mosaic.py:57"),
        "P3": ("probe reshape3", "scripts/probe_mosaic.py:86"),
        "P4": ("probe mv_small_n (K1's int4 matvec at N = 256)", "scripts/probe_mosaic.py:105"),
        "P5": ("probe concat", "scripts/probe_mosaic.py:139"),
    }
    files = {"K1": "fused_layer.cu", "K2": "fused_layer.cu", "K3": "quant_matmul.cu", "K4": "flash_attention.cu",
             "K5": "decode_attention.cu", "K5q": "decode_attention.cu", "K6": "quant_matmul_int8.cu",
             "K7": "serve_layer.cu", "K8": "decode_attention.cu", "K8b": "decode_attention.cu",
             "K9": "serve_layer.cu", "K10dq": "flash_attention.cu", "K10dkv": "flash_attention.cu",
             "K1 LoRA": "fused_layer.cu", "K7 LoRA": "serve_layer.cu", "P1": "probe.cu", "P2": "probe.cu",
             "P3": "probe.cu", "P4": "probe.cu", "P5": "probe.cu"}
    labels = {"K10dq": "K10 dq", "K10dkv": "K10 dkv"}
    totals["K8b"] = totals["K8"]  # one CUDA kernel and one counter stand behind both entries
    for key in sources:
        r = results[key]
        kernels.append({
            "name": f"{labels.get(key, key)} {sources[key][0]}", "route": "cuda",
            "source": f"lit_llama_tpu_torch/csrc/{files[key]}", "replaces": sources[key][1],
            "launches": totals[key], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
            **({"ms_without_operand": r["ms_without_operand"]} if "ms_without_operand" in r else {}),
        })
    assert all(k["launches"] > 0 for k in kernels), "a kernel of the main paths was never launched"
    print(json.dumps({"requests": full, "serving": serving, "requests_lora": full_lora, "serving_lora": serving_lora,
                      "entry_points": entry_runs, "requests_int8": full8,
                      "k6_shapes": k6_shapes, "k5_shapes": k5_shapes, "training": training}))
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.0f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
