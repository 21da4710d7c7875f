#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one GPU.

    python3 chip_smoke.py

Builds the hand-written kernels of lit_llama_tpu_torch (K1-K4 of int4
single-stream generation, K7, K8/K8b and K9 of the batched serving step, K5
and K6 of the per-op int8 decode path) with nvcc, holds each against its plain
PyTorch version at 7B shapes and times both, checks the kernel path of a
2-layer full-width model against the plain path (fused step, serving step and
per-op step with the bf16 and the int8 KV cache), then drives the main paths
on full 32-layer 7B models (random weights from a seed): on int4 weights a few
greedy single-stream requests through ``generate`` and 64 requests through a
32-slot ``DecodeEngine``; then, the int4 model freed, three greedy requests
through ``generate`` on int8 weights, which decodes per op (short context,
S = 2048, and S = 2048 on the int8 KV cache). The launch counters, set to 0
before each path and read after it, prove that the path ran through the
kernels. Any failure raises and exits nonzero.

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

# (name substring, memory bytes/s, dense bf16 tensor FLOP/s, f32 FLOP/s):
# NVIDIA's data sheets; first match wins
PEAKS = (
    ("H100 PCIe", 2.0e12, 756e12, 51e12),
    ("H100 NVL", 3.9e12, 835e12, 60e12),
    ("H200", 4.8e12, 989e12, 67e12),
    ("H100", 3.35e12, 989e12, 67e12),
)

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

    from lit_llama_tpu_torch import LLaMAConfig
    from lit_llama_tpu_torch.models import generate as gen
    from lit_llama_tpu_torch.models import llama
    from lit_llama_tpu_torch.ops import _build, fused_layer, quant_matmul
    from lit_llama_tpu_torch.ops import decode_attention as da
    from lit_llama_tpu_torch.ops import flash_attention as fa
    from lit_llama_tpu_torch.ops.linear import dequantize_int4, dequantize_int8
    from lit_llama_tpu_torch.ops.rope import build_rope_cache, rope_half_row, slot_rope_rows
    from lit_llama_tpu_torch.serve import DecodeEngine
    from lit_llama_tpu_torch.utils.random_params import random_int4_params, random_int8_params

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # ---- 1. set-up ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    bw, tc_peak, f32_peak = next((p[1:] for p in PEAKS if p[0] in kind), PEAKS[-1][1:])
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
                "K8": da.decode_attention_write, "K9": fused_layer.block_tail_fused}

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
        del kc0, vc0, kv, rkv

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

        # ---- 6. full width, depth cut to 2 blocks: kernel path vs plain path ------
        p2 = dict(params, h=params["h"][:2])
        c2 = cfg.replace(n_layer=2)
        prompt = torch.randint(0, cfg.vocab_size, (1, 37), generator=gcpu).to(dev)
        caches = {plain: llama.init_kv_cache(c2, 1, 64, device=dev) for plain in (False, True)}
        logits = {plain: llama.forward(p2, prompt, c2, rope_cache=rope, kv_cache=caches[plain],
                                       prefill_from_zero=True, plain=plain)[0] for plain in (False, True)}

        errs = [model_err(logits[False], logits[True], "2-layer prefill")]
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
            errs.append(model_err(step_logits[False], step_logits[True], f"2-layer decode step {step}"))
            tok = step_logits[False].float().argmax(-1)
        log(f"2-layer 7B-width model, kernel vs plain path: prefill max |dlogit| {errs[0]:.4g}, "
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
            errs.append(model_err(lg[False], lg[True], f"2-layer serving step {step}"))
            tok6, pos6 = lg[False].float().argmax(-1), pos6 + 1
        log(f"2-layer 7B-width serving step (K7, K8, K9, K3), kernel vs plain path, slots at {lens6} "
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
            want = {"K1": cfg.n_layer * (new - 1), "K2": new - 1, "K3": 4 * cfg.n_layer + 1, "K4": cfg.n_layer,
                    "K5": 0, "K6": 0, "K7": 0, "K8": 0, "K9": 0}
            assert got == want, f"request T={T} S={s}: launches {got}, expected {want}"
            assert out.shape == (T + new,) and int(out.min()) >= 0 and int(out.max()) < V, "bad tokens"
            for k in totals:
                totals[k] += got[k]
            S_used = gen.plan_seq_length(cfg, T + new, s)
            tok_s = (new - 1) / (total_s - prefill_s)
            full[f"T={T},S={S_used}"] = dict(prefill_ms=prefill_s * 1e3, decode_tok_s=tok_s)
            log(f"request prompt {T} S={S_used}: prefill {prefill_s * 1e3:.1f} ms, "
                f"decode {tok_s:.1f} tok/s ({new} new tokens, launches {got})")

        # ---- 8. the serving path: 64 requests through a 32-slot engine ---------------
        L = cfg.n_layer
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
        want = {"K1": 0, "K2": 0, "K3": prefills * (4 * L + 1) + steps, "K4": L * prefills, "K5": 0, "K6": 0,
                "K7": L * steps, "K8": L * steps, "K9": L * steps}
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

        return results, totals, full, serving

    results, totals, full, serving = int4_paths()


    gc.collect()
    torch.cuda.empty_cache()
    log(f"int4 model and caches freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated")

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

    kernels = []
    sources = {
        "K1": ("decode_layers_fused", "lit_llama_tpu/ops/fused_layer.py:446"),
        "K2": ("lm_head_fused", "lit_llama_tpu/ops/fused_layer.py:894"),
        "K3": ("matmul_int4", "lit_llama_tpu/ops/quant_matmul_pallas.py:172"),
        "K4": ("flash_attention", "lit_llama_tpu/ops/flash_attention.py:52"),
        "K5": ("decode_attention (bf16 cache)", "lit_llama_tpu/ops/decode_attention.py:44"),
        "K5q": ("decode_attention (int8 cache)", "lit_llama_tpu/ops/decode_attention.py:44"),
        "K6": ("matmul_int8", "lit_llama_tpu/ops/quant_matmul_pallas.py:48"),
        "K7": ("block_head_fused", "lit_llama_tpu/ops/fused_layer.py:956"),
        "K8": ("decode_attention_write_pipelined", "lit_llama_tpu/ops/decode_attention.py:473"),
        "K8b": ("decode_attention_write_pallas", "lit_llama_tpu/ops/decode_attention.py:226"),
        "K9": ("block_tail_fused", "lit_llama_tpu/ops/fused_layer.py:981"),
    }
    files = {"K1": "fused_layer.cu", "K2": "fused_layer.cu", "K3": "quant_matmul.cu", "K4": "flash_attention.cu",
             "K5": "decode_attention.cu", "K5q": "decode_attention.cu", "K6": "quant_matmul_int8.cu",
             "K7": "serve_layer.cu", "K8": "decode_attention.cu", "K8b": "decode_attention.cu",
             "K9": "serve_layer.cu"}
    totals["K8b"] = totals["K8"]  # one CUDA kernel and one counter stand behind both entries
    for key in sources:
        r = results[key]
        kernels.append({
            "name": f"{key} {sources[key][0]}", "route": "cuda",
            "source": f"lit_llama_tpu_torch/csrc/{files[key]}", "replaces": sources[key][1],
            "launches": totals[key], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
        })
    assert all(k["launches"] > 0 for k in kernels), "a kernel of the main paths was never launched"
    print(json.dumps({"requests": full, "serving": serving, "requests_int8": full8,
                      "k6_shapes": k6_shapes, "k5_shapes": k5_shapes}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
