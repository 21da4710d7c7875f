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
Then every input the Pallas entries take beyond bf16 at head size 128: K7/K9
past 64 slots and 128 requests through a 128-slot engine (each request's
tokens equal to a 32-slot engine's); a LoRA operand of 128 columns in bf16
and f32; f32 norm weights through ``generate.base`` on an f32 native
directory; f32 compute in every kernel and through whole paths (the 32-layer
int4 model, the serving engine, int8 per op, a training step), each against
its plain path; head sizes 256, 384 and 512 in K4, K5 and K10 (kernels and
2-layer models); and the routing of shapes the JAX package's gates leave to
XLA (head size 64, widths that are no multiple of 256) to the plain
versions. K3 and K6 at M > 1 (prefill) run on one Hopper mainloop (wgmma,
TMA); each is timed at M = 8, 128 and 200 on the five 7B linears beside
torch.matmul on the dequantized bf16 weight, and a row's output must be the
same bits at M = 8 and M = 200 and on a rerun. K6 at M = 1 (one kernel a
call, its K split merged in the kernel, launched under programmatic
dependent launch) is summed over a decoded token's 4 L + 1 launches beside
its bound (phase 9b), must give the same bits on a second launch and on two
streams at once, and must read the x that the kernel launched just before it
wrote (a copy into its buffer, a chain of K6). K3 at M = 1 runs a body of
its own (one kernel a call, mma.sync on the nibbles, its K split merged in
the kernel, programmatic dependent launch): phase 2b times the five 7B
linears and a decoded token's 4 L + 1 launches beside the bound and
torch.matmul, holds it to its plain version in bf16 and f32 at gs 128, 32,
gs = K, N = 1040 and 1032, and checks its bits across launches and streams
and that it reads the x written just before it; phase 7c drives the per-op
int4 path (the 32-layer int4 model on the int8 KV cache) through
``generate`` with its launches asserted, and phase 7d holds that path's
2-layer model to the plain path. K4 and K10 in bf16 at head
size 128 run on Hopper kernels too (wgmma, TMA, an mbarrier ring); K4 is
also timed at the training shape (B = 1 and 2, T = 2048) beside SDPA's
causal forward, K10 at B = 2 beside B = 1. In bf16, K5 and K1's attention run
one split body (cp.async rings, the splits merged in the same launch by the
last block to arrive) and K1's and K2's int4 matvec runs on the tensor cores;
K5 is timed at B = 8 beside B = 1 and each of its rows must be the same bits
alone as among 8, K1 is held at positions on both sides of a split boundary
and past S. In bf16, K7 and K9 run a chain of a row prologue and one int4
product kernel a linear on the tensor cores (K splits merged in split order
by the last block to arrive); phase 5b'' holds each row of K7 and K9 at 7B
width to the same bits at B = 1, 32 and 128 and times K9's kernels at
B = 32. Phase 6c reads phase 6b's serving step on eight prompt seeds,
without and with LoRA (with LoRA also on the prompts that once failed 6b):
each kernel against its plain version on the plain path's inputs, layer by
layer, and both bf16 paths against the plain path in f32 compute. The launch
counters, set to 0 before each path and read after it, prove that the path
ran through the kernels. Phases 19-21 finetune: one step of a 3-layer
full-width model in LoRA, Adapter v1 and v2, kernel path against plain path;
K4 and K10 at the finetuning shape (4, 32, 256, 128) beside SDPA; the
finetuning body (``training.finetune.finetune``) on SFT samples of 30-250
tokens, micro-batch 4 x 2, in LoRA, Adapter v1 and v2 on 16 layers of the
7B model and full finetuning on 8 (step ms, tokens/s, peak memory;
frozen leaves unchanged); and ``finetune.lora`` / ``finetune.adapter`` then
``generate.lora`` / ``generate.adapter`` in subprocesses, greedy tokens
equal to the in-process ``generate``'s. Phases 22-24 quantize and evaluate:
GPTQ on 2 layers of 7B width in f32 (calibration 8 x 2048, batch 4, group
size 128, with and without actorder, spilling to the host without it) on
the kernel path, where K3 and K4 run in f32, against the plain path (stage
B's Hessian, each linear's objective ||X(W - What)||, which must also stay
below round-to-nearest's; a K3 that drops a quarter of its reduction must
fail both), timed per layer with the walk's launches; the
perplexity of the 32-layer 7B model in bf16 over four 2048-token windows,
dense, int4 and int8 (tokens/s, peak memory; one window on 2 layers kernel
path against plain path); and ``quantize.gptq``, ``evaluate.full``,
``generate.full``, ``evaluate.lora`` / ``.adapter`` / ``.adapter_v2`` and
``evaluate.eval_quality`` in subprocesses on phase 21's 3-layer checkpoint
and directories (the ladder on its first layer), each printed perplexity
equal to the in-process value. Phases 25-28 run the entry points that read
published checkpoints, serve over HTTP and prepare data: seeded 4-layer
7B-width weights written as Meta's two tensor-parallel shards and as two HF
``.bin`` files, converted by ``scripts.convert_checkpoint`` and
``scripts.convert_hf_checkpoint`` in subprocesses, each output equal to the
seeded weights tensor for tensor; that checkpoint, int4 at load, behind
``serve.http`` in this process (32 slots, S = 1024): 64 concurrent greedy
requests of 16-512 prompt tokens and 32-128 new ones, whose tokens equal an
in-process engine run of the same requests, with K3, K4, K7, K8 and K9's
launches counted over the HTTP run (tokens/s, TTFT p50 / p99 beside the
in-process engine's), then ``python -m lit_llama_tpu_torch.serve.http`` as a
subprocess on the same file (/health, four requests, tokens equal); a
tokenizer trained by ``scripts.prepare_shakespeare`` (a subprocess) on the
repo's reference Markdown, the native encoder built and equal to the Python one on the
whole corpus (both timed), and ``pretrain.shakespeare`` at the 7B width,
block 1024, 4 layers, batch 2, lr 2e-5: 6 steps in process (the loss falls; K4 and
K10 launch 2 L and L times a step; ms a step, peak memory), then
``--resume`` for 2 more in a subprocess; ``scripts.convert_lora_weights`` on
phase 21's LoRA directory, the merged ``.pth``'s logits within
``TOL_MODEL`` of the base with the overlay, ``generate.base`` on it in a
subprocess (greedy tokens equal), and ``scripts.prepare_alpaca`` on a local
JSON with one ``finetune.lora`` step on its output. The f32 bodies rebuilt
for the card (K3's f32 tile, shared with K6 at M > 1 and K7 / K9 in f32, and
K4's FFMA forward) are held and timed where they were: phases 8h (K3 f32 at
M = 8 and 128, K4 f32 at T = 128 and 200, K7 / K9 f32), 12b (K6 f32 at M >
1), 14b (K4 f32 at (1, 32, 2048, 128)), 17 (K4 f32 at head size 256, also
timed) and 22 (the calibration shapes, with ``allow_tf32`` and the kernels
SDPA's f32 call runs logged beside the yardsticks). Phases 29-31 run
tensor- and data-parallel inference in two ranks on the one card (see their
constants). Phases 32-34 train across two ranks on the one card, DP, FSDP
and TP at the 7B width (4, 8 and 8 layers): three f32 steps at 2 layers
against the single-process step, one bf16 step at depth read beside the
single card's kernel vs plain departure, a second step's collectives counted
(``tools/comm_anatomy.py``), K4 and K10 held and timed at each rank's local
shapes; then ``finetune.lora`` and ``pretrain.shakespeare`` with
``--data_parallel 2`` under ``torchrun``, whose final checkpoints choose the
one-process runs' greedy tokens wherever no near-tie decides them.
Any failure raises and exits nonzero.

Output: findings on earlier lines; one line with the card's name and power
limit; one JSON line {"kernels": [...]} with each kernel's launches on the
main path, error, time, plain time, bound and library yardstick; and last
{"ok": true, "device": {...}}. Without a CUDA device, or run from a directory
that lacks the package, it exits nonzero and prints no result.
"""

from __future__ import annotations

import inspect
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
    # softmax weight relative to another maximum before rounding it (the split
    # body: the running maximum of a warp's tiles of 16 or 32 rows, as the
    # Pallas kernel's running maximum over its blocks; the first port's bodies,
    # f32 and head sizes past 256: the 64-row chunk's), not the row's.
    # With every row of a long cache visible the outputs are small means
    # (|y| <= 0.05 at S = 2048, 0.3 at S = 72), so the absolute part is set from
    # the errors seen there (2.4e-4 to 9.8e-4): a chunk left out of the merge or
    # a scale not applied moves most values by more
    "K5": (1e-3, 2e-2),
}
# f32 compute: the kernels and their plain versions take the same f32 inputs
# and round nowhere else; their f32 sums run in another order, so outputs of
# size ~1-10 differ in the last few f32 bits (the card runs: up to ~6e-5 on
# K6's O(20) sums at K = 4096)
TOL_F32 = (1e-4, 1e-4)
# head sizes 256, 384 and 512: the bf16 tolerances of head size 128 (the same
# rounding points; past 256 the scores are summed a 128-column chunk at a time)
for _hs in (256, 384, 512):
    TOL[f"K4 hs{_hs}"], TOL[f"K5 hs{_hs}"] = TOL["K4"], TOL["K5"]
# 2-layer full-width model, kernel path vs plain path: per-op errors of the
# table above compound through 2 blocks and the lm_head
TOL_MODEL = (5e-2, 5e-2)
# f32 compute through whole models, kernel path vs plain path (the same
# tokens fed to both): max |dlogit| <= TOL_MODEL_F32 * max |logit|. f32 sums
# in another order compound through the layers; a kernel that dropped a
# group, a chunk or a row moves the logits by orders more
TOL_MODEL_F32 = 1e-3
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


_T0 = time.perf_counter()


def log(*a):
    """A finding, after the seconds since the script started."""
    print(f"[{time.perf_counter() - _T0:7.1f} s]", *a, flush=True)


SEEDS_6C = tuple(range(1000, 1008))  # phase 6c: the prompt seeds phase 6b was read at


def write_tokenizer(path: Path) -> Path:
    """A BPE tokenizer of 128 pieces (letters, a few marks, word starts and
    vowel pairs), written by the port's ``serialize_model``."""
    from lit_llama_tpu_torch.data import sp_model

    letters = "abcdefghijklmnopqrstuvwxyz"
    pieces = [sp_model.Piece("<unk>", 0.0, sp_model.UNKNOWN), sp_model.Piece("<s>", 0.0, sp_model.CONTROL),
              sp_model.Piece("</s>", 0.0, sp_model.CONTROL), sp_model.Piece(sp_model.WS, -1.0)]
    pieces += [sp_model.Piece(c, -2.0 - i) for i, c in enumerate(letters + "?.,'")]
    merges = [sp_model.WS + c for c in letters] + [a + b for a in "aeiou" for b in letters]
    pieces += [sp_model.Piece(m, -100.0 - i) for i, m in enumerate(merges[: 128 - len(pieces)])]
    assert len(pieces) == 128
    path.write_bytes(sp_model.serialize_model(sp_model.SPModel(pieces=pieces, model_type=2)))
    return path


def kernel_name(signature: str) -> str:
    """A kernel's name from the profiler's signature of it."""
    return signature.split("<")[0].split("(anonymous namespace)::")[-1].split("(")[0].split("::")[-1]


def serving_layer_check(p2, c2, rope, dev, prompts_from, tol, lens=(10, 37, 60), S=64, steps=8):
    """Phase 6c for one prompt seed: phase 6b's 2-layer serving step (3 slots
    at their own positions of a 64-row cache, 8 steps), read three ways.

    ``reading_6b``: the kernel path against the plain path, each from its own
    prefill, max |dlogit| over the steps (phase 6b's reading). ``per_kernel``:
    on the plain path's inputs, at each of the 2 layers and 8 steps, each
    kernel against its plain version (K7, or K7 LoRA with the LoRA operand
    when ``c2.lora``; K8 with its cache write; K9; K3 for the lm_head), the
    largest error by kernel and the share of its tolerance ``tol[key]``
    (atol + rtol * |plain|) it used; the caches must be equal.
    ``distance_to_f32``: both bf16 paths and the plain path in f32 compute on
    the same weights, prompts and tokens (the bf16 plain path's choice): the
    max |dlogit| of each bf16 path from the f32 one. The prompts are drawn as
    phases 6 and 6b draw them, phase 6's 37-token prompt first, then one per
    slot, from ``prompts_from``: a seed, or a CPU generator in the state
    phase 6 would find."""
    import torch

    from lit_llama_tpu_torch.models import llama
    from lit_llama_tpu_torch.ops import decode_attention as da
    from lit_llama_tpu_torch.ops import fused_layer, quant_matmul
    from lit_llama_tpu_torch.ops.norm import rms_norm
    from lit_llama_tpu_torch.ops.rope import slot_rope_rows

    seed = prompts_from if isinstance(prompts_from, int) else "of the shifted generator"
    g = torch.Generator().manual_seed(seed) if isinstance(prompts_from, int) else prompts_from
    V, D, H, hs = c2.vocab_size, c2.n_embd, c2.n_head, c2.head_size
    k7 = "K7 LoRA" if c2.lora is not None else "K7"
    torch.randint(0, V, (1, 37), generator=g)  # phase 6's prompt
    prompts = [torch.randint(0, V, (1, n), generator=g).to(dev) for n in lens]
    c32 = c2.replace(compute_dtype="float32")
    paths = {"kernel": (c2, False), "plain": (c2, True), "f32": (c32, True)}
    caches = {}
    first = []
    for name, (c, plain) in paths.items():
        caches[name] = llama.init_kv_cache(c, len(lens), S, getattr(torch, c.compute_dtype), device=dev)
        for b, p in enumerate(prompts):
            view = [{n: t[b : b + 1] for n, t in kv.items()} for kv in caches[name]]
            lg = llama.forward(p2, p, c, rope_cache=rope, kv_cache=view, prefill_from_zero=True, plain=plain)[0]
            if name == "plain":
                first.append(lg[0, -1].float().argmax())
    tok = torch.stack(first)
    pos = torch.tensor(lens, dtype=torch.int32, device=dev)
    errs = {k: 0.0 for k in (k7, "K8", "K9", "K3")}
    share = dict.fromkeys(errs, 0.0)
    reading, to_f32 = 0.0, {"kernel": 0.0, "plain": 0.0}

    def held(got, want, key):
        got, want = got.float(), want.float()
        assert torch.isfinite(got).all(), f"6c seed {seed}: {key} non-finite"
        err = (got - want).abs()
        atol, rtol = tol[key]
        errs[key] = max(errs[key], float(err.max()))
        share[key] = max(share[key], float((err / (atol + rtol * want.abs())).max()))

    for _ in range(steps):
        lg = {name: llama.forward(p2, tok[:, None], c, rope_cache=rope, slot_pos=pos, kv_cache=caches[name],
                                  plain=plain)[0][:, -1].float() for name, (c, plain) in paths.items()}
        reading = max(reading, float((lg["kernel"] - lg["plain"]).abs().max()))
        for name in to_f32:
            to_f32[name] = max(to_f32[name], float((lg[name] - lg["f32"]).abs().max()))
        tok, pos = lg["plain"].argmax(-1), pos + 1
    # per kernel, on the plain path's inputs: a fresh plain run of the same steps
    cache = llama.init_kv_cache(c2, len(lens), S, device=dev)
    for b, p in enumerate(prompts):
        view = [{n: t[b : b + 1] for n, t in kv.items()} for kv in cache]
        llama.forward(p2, p, c2, rope_cache=rope, kv_cache=view, prefill_from_zero=True, plain=True)
    tok = torch.stack(first)
    pos = torch.tensor(lens, dtype=torch.int32, device=dev)
    for _ in range(steps):
        cos, sin = slot_rope_rows(rope, pos)
        x2d = p2["wte"][tok].to(torch.bfloat16)
        for lp, kv in zip(p2["h"], cache):
            ha = (x2d, lp["rms_1"], cos, sin, lp["attn"]["c_attn"], c2)
            qkv = fused_layer.block_head_fused_ref(*ha)
            held(fused_layer.block_head_fused(*ha), qkv, k7)
            q, k, v = (qkv[:, i * D : (i + 1) * D].reshape(len(lens), H, 1, hs) for i in range(3))
            kc, vc = kv["k"].clone(), kv["v"].clone()
            y_k, _, _ = da.decode_attention_write(q, k, v, kc, vc, pos)
            y, _, _ = da.decode_attention_write_ref(q, k, v, kv["k"], kv["v"], pos)
            held(y_k, y, "K8")
            assert torch.equal(kc, kv["k"]) and torch.equal(vc, kv["v"]), f"6c seed {seed}: K8 caches differ"
            ta = (x2d, y.reshape(len(lens), D), lp["rms_2"], lp["attn"]["c_proj"], lp["mlp"]["c_fc12"],
                  lp["mlp"]["c_proj"], c2)
            x2d = fused_layer.block_tail_fused_ref(*ta)
            held(fused_layer.block_tail_fused(*ta), x2d, "K9")
        xn = rms_norm(x2d[:, None], p2["ln_f"])[:, 0]
        head = (xn, p2["lm_head"]["qw"], p2["lm_head"]["qscale"], p2["lm_head"]["qzero"])
        logits = quant_matmul.matmul_int4_ref(*head)
        held(quant_matmul.matmul_int4(*head), logits, "K3")
        tok, pos = logits.float().argmax(-1), pos + 1
    return dict(seed=seed, reading_6b=reading, per_kernel=errs, tolerance_share=share, distance_to_f32=to_f32)


def sft_samples(tok, n: int, seed: int, lo: int = 30, hi: int = 250):
    """``n`` SFT samples whose lengths are log-uniform in [lo, hi] tokens:
    random words encoded by ``tok`` (bos first, eos last), the first 40 % of
    each the prompt, masked out of the labels, as ``data.sft.prepare_sample``
    lays a sample out."""
    import numpy as np

    rng = np.random.default_rng(seed)
    letters = list("abcdefghijklmnopqrstuvwxyz")
    out = []
    for _ in range(n):
        length = int(round(np.exp(rng.uniform(np.log(lo), np.log(hi)))))
        text = " ".join("".join(rng.choice(letters, size=int(rng.integers(1, 8)))) for _ in range(length))
        ids = np.concatenate([np.asarray(tok.encode(text, bos=True, eos=False))[: length - 1], [tok.eos_id]])
        n_prompt = max(1, int(0.4 * length))
        labels = ids.copy()
        labels[:n_prompt] = -1
        out.append({"input_ids": ids.astype(np.int32), "input_ids_no_response": ids[:n_prompt].astype(np.int32),
                    "labels": labels.astype(np.int32)})
    return out


def k10_layers(mode: str, n_layer: int) -> int:
    """Attention backwards (K10) a microbatch runs: autograd skips the first
    layer's in Adapter v1, where no trainable leaf lies before that layer's
    attention (its gate and prompt enter after it), and runs every other."""
    return n_layer - 1 if mode == "adapter" else n_layer


def finetune_step_check(dev, counters, cfg, seed: int, lr: float = 1e-3):
    """Phase 19: one finetuning step of a 3-layer full-width model in LoRA (B
    drawn, not zero), Adapter v1 and v2 (``gating`` drawn non-zero, so the
    prompt has a gradient), kernel path against plain path: the loss, each
    trainable leaf's grad (``TOL_TRAIN_GRAD``) and its update after one AdamW
    step from zero moments (``TOL_TRAIN_UPDATE`` of lr where the plain grad is
    clear of 0, as phase 14, plus a bf16 ulp of the value); K4 2 L times
    (remat recomputes the forward) and K10 ``k10_layers`` times on the kernel
    path, none on the plain path; frozen leaves unchanged. Inputs come from
    generators of their own."""
    import torch

    from lit_llama_tpu_torch.models import llama
    from lit_llama_tpu_torch.ops import flash_attention as fa
    from lit_llama_tpu_torch.training import finetune
    from lit_llama_tpu_torch.training import step as step_lib
    from lit_llama_tpu_torch.utils.checkpoint import tree_leaves, tree_unflatten

    on_card = dev.type == "cuda"
    L = cfg.n_layer
    base = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    frozen0 = {n: t.clone() for n, t in tree_leaves(base).items()}
    g = torch.Generator().manual_seed(seed + 1)
    toks = torch.randint(0, cfg.vocab_size, (1, 4, 257), generator=g)
    ids, tgt = toks[..., :-1].to(dev), toks[..., 1:].clone()
    tgt[..., :100] = -1  # the prompt, masked out of the loss
    tgt = tgt.to(dev)
    readings = {}
    for mode in ("lora", "adapter", "adapter_v2"):
        params, mcfg, mask, _ = finetune.prepare(mode, tree_unflatten(tree_leaves(base)), cfg, seed=seed)
        if mode == "lora":
            b = params["h"]["attn"]["c_attn"]["lora_b"]
            b.copy_(torch.randn(b.shape, generator=g).to(b) * 0.02)
        else:
            gate = params["h"]["gating"]
            gate.copy_(torch.randn(gate.shape, generator=g).to(gate) * 0.5)
        leaves = tree_leaves(params)
        opt = step_lib.make_optimizer(step_lib.TrainConfig(learning_rate=lr, warmup_iters=0, max_iters=10), mask)
        names = opt.trainable_names(params)
        init = {n: leaves[n].clone() for n in names}
        grads, losses, after = {}, {}, {}
        for plain in (False, True):
            for n in names:
                leaves[n].requires_grad_(True)
            for fn in counters.values():
                fn.launches = 0
            fa.flash_backward_dq.launches = fa.flash_backward_dkv.launches = 0
            loss = step_lib.loss_fn(params, ids[0], tgt[0], mcfg, remat=True, remat_policy="dots", plain=plain)
            got = torch.autograd.grad(loss, [leaves[n] for n in names])
            if on_card:
                torch.cuda.synchronize()
            n3 = (fa.flash_attention.launches, fa.flash_backward_dq.launches, fa.flash_backward_dkv.launches)
            want = (0, 0, 0) if plain or not on_card else (2 * L, k10_layers(mode, L), k10_layers(mode, L))
            assert n3 == want, f"{mode} step, plain={plain}: K4/K10 launches {n3}, expected {want}"
            grads[plain] = dict(zip(names, got))
            losses[plain] = float(loss.detach())
            for n in names:
                leaves[n].requires_grad_(False)
            del loss, got
        gerrs, gabs = {}, {}
        for n, gk in grads[False].items():
            w = grads[True][n]
            assert torch.isfinite(gk).all(), f"{mode}: non-finite grad of {n}"
            top = float(w.abs().max())
            assert top > 0, f"{mode}: the plain path gives {n} no grad"
            gabs[n] = float((gk - w).abs().max())
            gerrs[n] = (gabs[n] / top, float((gk - w).norm() / w.norm()))
            assert gerrs[n][0] <= TOL_TRAIN_GRAD["max"] and gerrs[n][1] <= TOL_TRAIN_GRAD["rms"], \
                f"{mode} grads: {n} off by {gerrs[n][0]:.3g} of its max |grad|, {gerrs[n][1]:.3g} of its RMS"
        assert abs(losses[False] - losses[True]) <= 1e-2 * abs(losses[True]), f"{mode} loss {losses}"
        for plain in (False, True):
            for n in names:
                leaves[n].copy_(init[n])
            st = step_lib.init_train_state(params, opt)
            st, _ = step_lib.train_step(st, ids, tgt, mcfg, opt, True, "dots", plain)
            after[plain] = {n: leaves[n].clone() for n in names}
        uerrs = {}
        for n, w in after[True].items():
            diff = ((after[False][n] - init[n]) - (w - init[n])).float().abs()
            may_flip = grads[True][n].abs() <= 2 * gabs[n]
            # the PEFT leaves keep the base's dtype (bf16): each side's new value
            # is rounded to bf16, so an ulp of the value (2^-8 of it) comes on top
            ulp = torch.maximum(w.abs(), init[n].abs()).float() * 2.0**-8
            bad = diff > lr * (TOL_TRAIN_UPDATE + 2 * may_flip) + ulp
            assert not bad.any(), f"{mode} train_step: {int(bad.sum())} elements of {n} off, max {float(diff.max()):.3g}"
            steady = diff[~may_flip]
            uerrs[n] = float(steady.max()) / lr if steady.numel() else 0.0
        for n, t in tree_leaves(params).items():
            if n in frozen0 and n not in names:
                assert torch.equal(t, frozen0[n]), f"{mode}: frozen leaf {n} changed"
        readings[mode] = dict(losses=losses, grad_err=gerrs, update_err_over_lr=uerrs)
        log(f"phase 19, {mode}: one finetuning step of {L} layers at width {cfg.n_embd}, B = 4, T = 256, kernel vs "
            f"plain path: loss {losses[False]:.5f} vs {losses[True]:.5f}; per trainable leaf max |dgrad| / max |grad| "
            f"and RMS(dgrad) / RMS(grad): " + ", ".join(f"{n} {a:.3g} / {b:.3g}" for n, (a, b) in gerrs.items())
            + "; max |dupdate| / lr where the grad is clear of 0: "
            + ", ".join(f"{n} {v:.3g}" for n, v in uerrs.items()) + "; frozen leaves unchanged")
        del params, leaves, grads, after, init, opt
    del base, frozen0
    return readings


def finetune_runs(dev, counters, tok, work: Path, cfg, seed: int, modes, steps: int = 5, accum: int = 2,
                  micro_batch: int = 4, max_seq_length: int = 256, eval_iters: int = 2):
    """Phase 20: ``training.finetune.finetune`` on SFT samples of 30-250
    tokens (``sft_samples``), micro-batch ``micro_batch`` x ``accum``, in each
    (mode, n_layer) of ``modes`` on the width of ``cfg`` from random weights:
    ``steps`` steps (the first a warm-up), one validation with its sampled
    answer. Each run's counters start at 0: K4 and K10 must launch (K10
    ``k10_layers`` A times a step), and K5 in the sample; losses finite,
    frozen leaves unchanged bit for bit. Returns per mode: step ms (the
    median of the steps after the first, host clock ending in the loss's
    copy), tokens/s of all and of the non-pad tokens, peak memory (less the
    check's copy of the base), trainable parameters, launches. A full run
    saves no final checkpoint here (tens of GB of f32 state): the save call
    is recorded instead."""
    import gc

    import numpy as np
    import torch

    from lit_llama_tpu_torch.models import llama
    from lit_llama_tpu_torch.ops import flash_attention as fa
    from lit_llama_tpu_torch.training import finetune
    from lit_llama_tpu_torch.training import loop as loop_lib
    from lit_llama_tpu_torch.utils.checkpoint import tree_leaves

    on_card = dev.type == "cuda"
    train, test = sft_samples(tok, 64, seed), sft_samples(tok, 16, seed + 1)
    out = {}
    for mode, n_layer in modes:
        mcfg = cfg.replace(n_layer=n_layer, param_dtype="float32" if mode == "full" else cfg.param_dtype)
        params = llama.init_params(mcfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
        before = {n: t.clone() for n, t in tree_leaves(params).items()} if mode != "full" else {}
        copy_bytes = sum(t.numel() * t.element_size() for t in before.values())
        recs, saved = [], []
        save = loop_lib.save_train_checkpoint
        if mode == "full":
            loop_lib.save_train_checkpoint = lambda *a, **k: saved.append(a[1])
        for fn in counters.values():
            fn.launches = 0
        fa.flash_backward_dq.launches = fa.flash_backward_dkv.launches = 0
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            state = finetune.finetune(
                mode, params, mcfg, train, test, tok, work / mode, learning_rate=3e-4 if mode != "full" else 3e-5,
                weight_decay=0.02 if mode.startswith("adapter") else 0.0, batch_size=micro_batch * accum,
                micro_batch_size=micro_batch, max_iters=steps, warmup_iters=1, eval_interval=steps,
                eval_iters=eval_iters, save_interval=0, log_interval=1, max_seq_length=max_seq_length, log_fn=recs.append)
        finally:
            loop_lib.save_train_checkpoint = save
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - copy_bytes if on_card else 0  # without the check's copy
        got = {k: fn.launches for k, fn in counters.items()}
        got.update({"K10dq": fa.flash_backward_dq.launches, "K10dkv": fa.flash_backward_dkv.launches})
        losses = [r["loss"] for r in recs if "loss" in r]
        vals = [r["val_loss"] for r in recs if "val_loss" in r]
        assert len(losses) == steps and len(vals) == 1 and all(np.isfinite(losses + vals)), f"{mode}: {recs}"
        if on_card:
            assert got["K4"] > 0 and got["K5"] > 0 and got["K5"] % n_layer == 0, f"{mode}: launches {got}"
            assert got["K10dq"] == got["K10dkv"] == k10_layers(mode, n_layer) * accum * steps, f"{mode}: launches {got}"
            assert all(got[k] == 0 for k in ("K1", "K2", "K3", "K6", "K7", "K8", "K9")), f"{mode}: launches {got}"
        if mode == "full":
            assert saved == [finetune.CHECKPOINT_NAMES[mode]], saved
        else:
            assert (work / mode / finetune.CHECKPOINT_NAMES[mode]).is_dir()
        trainable = set(tree_leaves(state.opt_state["mu"]))
        n_train = sum(t.numel() for n, t in tree_leaves(state.params).items() if n in trainable)
        for n, t in tree_leaves(state.params).items():
            if n not in trainable and n in before:  # adapter_active is added frozen, after `before`
                assert torch.equal(t, before[n]), f"{mode}: frozen leaf {n} changed"
        # the batches again (finetune draws each with one rng.integers from default_rng(1337))
        rng = np.random.default_rng(1337)
        Ts, nonpad = [], []
        for _ in range(steps):
            lens = [len(train[i]["input_ids"]) - 1 for i in rng.integers(len(train), size=micro_batch * accum)]
            T = min(-(-max(lens) // 64) * 64, max_seq_length)
            Ts.append(T)
            nonpad.append(sum(min(n_, T) for n_ in lens))
        dts = [r["dt_ms"] for r in recs if "loss" in r][1:]
        step_ms = float(np.median(dts))
        tok_s = float(np.median([micro_batch * accum * T / dt * 1e3 for T, dt in zip(Ts[1:], dts)]))
        tok_s_real = float(np.median([n_ / dt * 1e3 for n_, dt in zip(nonpad[1:], dts)]))
        out[mode] = dict(n_layer=n_layer, n_embd=mcfg.n_embd, trainable_params=n_train, steps=steps, T=Ts,
                         losses=losses, val_loss=vals[0], step_ms=step_ms, step_ms_each=dts, tokens_per_s=tok_s,
                         nonpad_tokens_per_s=tok_s_real, peak_gib=peak / 2**30, wall_s=wall, launches=got)
        log(f"phase 20, {mode} finetuning, {n_layer} layers at width {mcfg.n_embd} ({mcfg.param_dtype} weights, "
            f"{mcfg.compute_dtype} compute), micro-batch {micro_batch} x {accum}, T per step {Ts}: losses {losses}, "
            f"val {vals[0]}; {n_train} trainable parameters; median step {step_ms:.1f} ms over steps 2-{steps} "
            f"(host clock, ends in the loss's copy to the host), {tok_s:.0f} tokens/s ({tok_s_real:.0f} non-pad), "
            f"peak memory {peak / 2**30:.2f} GiB (max_memory_allocated less this phase's {copy_bytes / 2**30:.2f} GiB "
            f"copy of the base for the frozen-leaf check); {wall:.1f} s with the validation and its sample; "
            f"launches {got}; frozen leaves unchanged")
        del state, params, before
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    return out


def finetune_kernel_times(dev, time_ms, bound_ms, tc_peak, seed: int, B: int = 4, H: int = 32, T: int = 256,
                          hs: int = 128):
    """K4 and K10 at the finetuning shape (B, H, T, hs) against their plain
    versions (K10 row by row, as phase 13), timed beside SDPA's causal forward
    and backward, with their bounds; inputs from a generator of their own.
    Returns the three ``results`` rows."""
    import torch
    import torch.nn.functional as F

    from lit_llama_tpu_torch.ops import flash_attention as fa

    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn((B, H, T, hs), generator=g).to(dev, torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_attention(q, k, v)
    ro, rlse = fa.flash_attention_ref(q, k, v)
    err4 = max(float((o.float() - ro.float()).abs().max()), 0.0)
    bad = (o.float() - ro.float()).abs() > TOL["K4"][0] + TOL["K4"][1] * ro.float().abs()
    assert not bad.any(), f"K4 at {(B, H, T, hs)}: {int(bad.sum())} values beyond tolerance"
    got = fa.flash_attention_backward(q, k, v, o, lse, do)
    want = fa.flash_attention_bwd_ref(q, k, v, o, lse, do)
    errs = []
    for name, gk, w in zip(("dq", "dk", "dv"), got, want):
        gk, w = gk.float(), w.float()
        assert torch.isfinite(gk).all(), f"K10 {name} at {(B, H, T, hs)}: non-finite"
        err, mag = (gk - w).abs(), w.abs()
        rowmax = mag.amax(-1, keepdim=True).clamp_min(TOL_K10["floor"] * float(mag.max()))
        need = float(((err - TOL_K10["rel"] * mag).clamp_min(0) / rowmax).max())
        assert need <= TOL_K10["row"], f"K10 {name} at {(B, H, T, hs)}: row part {need:.3g} needed"
        errs.append(float(err.max()))
    nrow, pairs = B * H * T, B * H * T * (T + 1) // 2
    b4 = bound_ms(4 * nrow * hs * 2 + nrow * 4, 4 * hs * pairs, tc_peak)
    b_dq = bound_ms(5 * nrow * hs * 2 + nrow * 4 + nrow * hs * 2 + nrow * 4, 3 * 2 * hs * pairs, tc_peak)
    b_dkv = bound_ms(4 * nrow * hs * 2 + 2 * nrow * 4 + 2 * nrow * hs * 2, 4 * 2 * hs * pairs, tc_peak)
    dq, dd = fa.flash_backward_dq(q, k, v, o, lse, do)
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    lib10 = time_ms(lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), do, retain_graph=True))
    plain10 = time_ms(lambda: fa.flash_attention_bwd_ref(q, k, v, o, lse, do), 3)
    shape = f"B={B} H={H} T={T} hs={hs}"
    rows = {
        "K4 T256": dict(shape=shape, ms=time_ms(lambda: fa.flash_attention(q, k, v)), max_abs_err=err4,
                        plain_ms=time_ms(lambda: fa.flash_attention_ref(q, k, v), 3),
                        library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)),
                        bound_ms=b4[0], bound_by=b4[1]),
        "K10dq T256": dict(shape=shape, ms=time_ms(lambda: fa.flash_backward_dq(q, k, v, o, lse, do)),
                           max_abs_err=errs[0], plain_ms=plain10, library_ms=lib10, bound_ms=b_dq[0], bound_by=b_dq[1]),
        "K10dkv T256": dict(shape=shape, ms=time_ms(lambda: fa.flash_backward_dkv(q, k, v, do, lse, dd)),
                            max_abs_err=max(errs[1:]), plain_ms=plain10, library_ms=lib10, bound_ms=b_dkv[0],
                            bound_by=b_dkv[1]),
    }
    log(f"finetuning shape {(B, H, T, hs)}: " + "; ".join(
        f"{k} {r['ms'] * 1e3:.1f} us (bound {r['bound_ms'] * 1e3:.1f} {r['bound_by']}, plain {r['plain_ms'] * 1e3:.1f}, "
        f"SDPA {'causal forward' if k.startswith('K4') else 'causal backward (dq, dk, dv)'} {r['library_ms'] * 1e3:.1f}), "
        f"max err {r['max_abs_err']:.3g}" for k, r in rows.items()))
    return rows


def finetune_entry_points(dev, tok_path: Path, work: Path, seed: int, cfg, new_tokens: int = 24):
    """Phase 21: ``python -m lit_llama_tpu_torch.finetune.lora`` and
    ``.adapter`` in subprocesses on a lit-llama ``.pth`` of ``cfg`` (random
    weights) with its ``config.json`` and alpaca samples prepared by
    ``data.sft`` into ``train.pt`` / ``test.pt``, three steps each; then
    ``generate.lora`` / ``generate.adapter`` on what they saved, whose greedy
    tokens must equal the in-process ``generate``'s with the same overlay."""
    import numpy as np
    import torch

    from lit_llama_tpu_torch.data import sft
    from lit_llama_tpu_torch.data.tokenizer import Tokenizer
    from lit_llama_tpu_torch.models import generate as gen
    from lit_llama_tpu_torch.models import llama
    from lit_llama_tpu_torch.models.config import AdapterConfig, LoRAConfig
    from lit_llama_tpu_torch.peft import adapter as adapter_mod
    from lit_llama_tpu_torch.peft import lora as lora_mod
    from lit_llama_tpu_torch.training.finetune import CHECKPOINT_NAMES
    from lit_llama_tpu_torch.utils.convert import pytree_to_lit
    from lit_llama_tpu_torch.utils.loader import load_model, load_peft_checkpoint

    work.mkdir(parents=True, exist_ok=True)
    dense = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    torch.save(pytree_to_lit(dense, cfg), work / "lit-llama.pth")
    del dense
    (work / "config.json").write_text(json.dumps(dict(n_layer=cfg.n_layer, n_head=cfg.n_head, n_embd=cfg.n_embd,
                                                      vocab_size=cfg.vocab_size)))
    tok = Tokenizer(tok_path)
    rng = np.random.default_rng(seed)
    letters = list("abcdefghijklmnopqrstuvwxyz")

    def words(k):
        return " ".join("".join(rng.choice(letters, size=int(rng.integers(1, 8)))) for _ in range(k))

    examples = [{"instruction": words(int(rng.integers(3, 30))), "input": words(5) if i % 3 == 0 else "",
                 "output": " " + words(int(rng.integers(3, 40)))} for i in range(40)]
    samples = [sft.prepare_sample(ex, tok, 256) for ex in examples]
    (work / "data").mkdir(exist_ok=True)
    sft.save_samples(samples[:32], work / "data" / "train.pt")
    sft.save_samples(samples[32:], work / "data" / "test.pt")
    enc = tok.encode(sft.generate_prompt({"instruction": "What food do lamas eat?", "input": ""}))
    runs = {}
    for mode, flag in (("lora", "--lora_path"), ("adapter", "--adapter_path")):
        out = work / f"out_{mode}"
        cmd = [sys.executable, "-m", f"lit_llama_tpu_torch.finetune.{mode}", "--data_dir", str(work / "data"),
               "--checkpoint_path", str(work / "lit-llama.pth"), "--tokenizer_path", str(tok_path), "--out_dir",
               str(out), "--max_iters", "3", "--batch_size", "8", "--micro_batch_size", "4", "--warmup_iters", "1",
               "--eval_interval", "3", "--eval_iters", "1", "--save_interval", "100", "--log_interval", "1",
               "--max_seq_length", "256"]
        if dev.type == "cpu":
            cmd += ["--device", "cpu"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        took_ft = time.perf_counter() - t0
        assert proc.returncode == 0, f"finetune.{mode} exited {proc.returncode}:\n{proc.stderr[-3000:]}"
        recs = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
        losses = [r["loss"] for r in recs if "loss" in r]
        assert len(losses) == 3 and all(np.isfinite(losses)) and any("val_loss" in r for r in recs), recs
        ckpt = out / CHECKPOINT_NAMES[mode]
        params, mcfg = load_model(work / "lit-llama.pth", device=dev)
        kind, overlay, info = load_peft_checkpoint(ckpt, mcfg, device=dev)
        assert kind == mode, (kind, info)
        if kind == "lora":
            mcfg = mcfg.replace(lora=LoRAConfig(r=info["r"], alpha=16.0, dropout=0.0))
            params = lora_mod.load_lora_state(params, overlay)
        else:
            mcfg = mcfg.replace(adapter=AdapterConfig(v2=info["v2"], prompt_length=info["prompt_length"],
                                                      start_layer=info["start_layer"]))
            params = adapter_mod.load_adapter_state(adapter_mod.add_adapter_params(params, mcfg), overlay)
        want = gen.generate(llama.unstack_layers(params), enc, new_tokens, config=mcfg, temperature=0.0,
                            eos_id=tok.eos_id, device=dev).tolist()
        del params, overlay
        cmd = [sys.executable, "-m", f"lit_llama_tpu_torch.generate.{mode}", flag, str(ckpt), "--checkpoint_path",
               str(work / "lit-llama.pth"), "--tokenizer_path", str(tok_path), "--temperature", "0",
               "--max_new_tokens", str(new_tokens)]
        if dev.type == "cpu":
            cmd += ["--device", "cpu"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
        took_gen = time.perf_counter() - t0
        assert proc.returncode == 0, f"generate.{mode} exited {proc.returncode}:\n{proc.stderr[-3000:]}"
        got = json.loads(proc.stderr.split("Token ids: ")[-1].splitlines()[0])
        assert got == want, f"generate.{mode}: tokens {got} differ from the in-process generate's {want}"
        runs[mode] = dict(finetune_s=took_ft, generate_s=took_gen, losses=losses, new_tokens=len(got) - len(enc),
                          checkpoint=str(ckpt))
        log(f"phase 21: python -m lit_llama_tpu_torch.finetune.{mode} ({cfg.n_layer} layers at width {cfg.n_embd}, "
            f"3 steps): exit 0 in {took_ft:.1f} s, losses {losses}; generate.{mode} on its checkpoint: exit 0 in "
            f"{took_gen:.1f} s, {len(got) - len(enc)} greedy tokens equal to the in-process generate's")
    return runs


# phase 20's depth for LoRA and Adapter v1 / v2: 16 layers of the 32 (the
# three runs took ~25 s at 32 layers on an H100), cut when phases 32-34
# brought the whole script near its time limit; a step's work and launches
# scale with the depth, and the phase still runs every layer kind
FINETUNE_PEFT_LAYERS = 16


def finetune_phases(dev, counters, time_ms, bound_ms, tc_peak, results, totals, cfg=None, modes=None,
                    entry_cfg=None, work=None):
    """Phases 19-21 on the 7B width (``cfg``: the 7B preset in bf16 unless
    given): the kernel path against the plain path for one step of each PEFT
    mode (3 layers), K4 and K10 at the finetuning shape, the finetuning body
    in each of ``modes`` ((mode, n_layer): LoRA and both adapters at 32
    layers, full at 8), and the entry points in subprocesses (3 layers).
    Adds the finetuning-shape rows to ``results`` and their launches on the
    LoRA run to ``totals``; returns the readings. Works in ``work`` (kept,
    with the tokenizer and phase 21's ``entry/`` directory) when given, else
    in a temporary directory it removes."""
    import gc
    import shutil
    import tempfile

    import torch

    from lit_llama_tpu_torch import LLaMAConfig
    from lit_llama_tpu_torch.data.tokenizer import Tokenizer

    on_card = dev.type == "cuda"
    cfg = cfg or LLaMAConfig.from_name("7B", param_dtype="bfloat16", compute_dtype="bfloat16")
    modes = modes or (("lora", FINETUNE_PEFT_LAYERS), ("adapter", FINETUNE_PEFT_LAYERS),
                      ("adapter_v2", FINETUNE_PEFT_LAYERS), ("full", 8))
    keep = work is not None
    work = Path(work) if keep else Path(tempfile.mkdtemp(prefix="chip_smoke_finetune_"))
    t0 = time.perf_counter()
    readings = {"step_check": finetune_step_check(dev, counters, cfg.replace(n_layer=3), SEED + 19)}
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        rows = finetune_kernel_times(dev, time_ms, bound_ms, tc_peak, SEED + 20, H=cfg.n_head, hs=cfg.head_size)
        results.update(rows)
    tok_path = write_tokenizer(work / "tokenizer.model")
    readings["runs"] = finetune_runs(dev, counters, Tokenizer(tok_path), work / "runs", cfg, SEED + 21, modes)
    if on_card:
        lora = readings["runs"]["lora"]["launches"]
        totals["K4 T256"], totals["K10dq T256"], totals["K10dkv T256"] = lora["K4"], lora["K10dq"], lora["K10dkv"]
    readings["entry_points"] = finetune_entry_points(dev, tok_path, work / "entry", SEED + 22,
                                                     entry_cfg or cfg.replace(n_layer=3))
    if not keep:
        shutil.rmtree(work)
    readings["seconds"] = time.perf_counter() - t0
    log(f"phases 19-21 (finetuning): {readings['seconds']:.1f} s")
    return readings


# GPTQ (phase 22): kernel path against plain path. Stage B's Hessian (the first
# one a kernel feeds: K3 for c_attn, K4 for the attention) relative to its
# largest entry, both paths resident (actorder): f32 sums in another order.
# (Spilling accumulates stage A's Hessian a batch at a time, as the reference
# does, which tips a few of c_attn's levels, so the spilled run's stage B
# inputs differ beyond rounding: its reading is logged.) Each linear's objective
# ||X(W - What)||, each path's What on its own calibration inputs X (after the
# first linear they differ: a level that rounding tips feeds another error to
# every later row and moves the next stage's inputs; under actorder a near-tie
# in diag(H) reorders the walk): the kernel path's over the plain path's within
# 1 +- `objective`, and below round-to-nearest's on the same X. Phase 22 also
# runs a K3 that loses the last quarter of its reduction (a dropped K split)
# on the first layer, and asserts that both checks refuse it
TOL_GPTQ = dict(hessian=1e-4, objective=2e-2)
# phase 22's sizes: the 7B width in f32 at GPTQ_LAYERS layers, calibrated on
# GPTQ_SAMPLES x GPTQ_T random tokens in batches of GPTQ_BATCH, group size
# GPTQ_GROUPSIZE
GPTQ_LAYERS, GPTQ_SAMPLES, GPTQ_T, GPTQ_BATCH, GPTQ_GROUPSIZE = 2, 8, 2048, 4, 128
# perplexity (phase 23), kernel path against plain path on one 2048-token
# window: the sum of the NLL, relative (bf16 logits through 2 blocks; the NLL
# of a near-uniform softmax moves little, so the logits are held as well, to
# TOL_MODEL)
TOL_NLL = 1e-3
# phase 23's sizes: EVAL_WINDOWS windows of EVAL_T tokens on the 32-layer 7B
# model; kernel against plain path on one window at EVAL_PLAIN_LAYERS layers
EVAL_WINDOWS, EVAL_T, EVAL_PLAIN_LAYERS = 4, 2048, 2
# phase 24's sizes: quantize.gptq on ENTRY_SAMPLES x ENTRY_T calibration
# windows, the evaluations in windows of ENTRY_EVAL_T, ENTRY_NEW_TOKENS greedy
# tokens from generate.full
ENTRY_SAMPLES, ENTRY_T, ENTRY_EVAL_T, ENTRY_NEW_TOKENS = 4, 512, 1024, 16


def _held(got, want, tol, what: str) -> float:
    """max |got - want|, asserting |got - want| <= atol + rtol * |want|."""
    import torch

    got, want = got.float(), want.float()
    assert torch.isfinite(got).all(), f"{what}: non-finite kernel output"
    err = (got - want).abs()
    bad = err > tol[0] + tol[1] * want.abs()
    assert not bad.any(), f"{what}: {int(bad.sum())} values beyond tolerance, max err {float(err.max()):.3g}"
    return float(err.max())


def _first_layer(node):
    """A stacked parameter tree (layers on a leading axis) cut to its first layer."""
    return {k: _first_layer(v) for k, v in node.items()} if isinstance(node, dict) else node[:1]


def int4_bytes(K: int, N: int, gs: int = 128) -> int:
    """Bytes of an int4 linear: the packed nibbles and f32 scale/zero planes."""
    return K // 2 * N + 2 * (K // gs) * N * 4


def gptq_check(dev, counters, time_ms, bound_ms, f32_peak, results, totals, seed: int):
    """Phase 22: ``quant.gptq.quantize_model_gptq`` on GPTQ_LAYERS layers of
    the 7B preset in f32 from random weights, calibrated on GPTQ_SAMPLES x
    GPTQ_T random tokens, with and without actorder, on the kernel path (K3
    and K4 in f32 feed stages B-E; spilling to the host without actorder, as
    the full protocol does) and on the plain path; then the first layer once
    more through a K3 that drops the last quarter of its reduction. Holds
    stage B's Hessian and each linear's objective between the paths
    (``TOL_GPTQ``), every kernel-path objective below round-to-nearest's, and
    asserts that the wrong K3 fails both; counts the calibration launches;
    times the walk and the rest per layer; counts a walk's launches a row
    with torch.profiler; on the card, adds the "K3 f32 M8192" and "K4 f32 B4
    T2048" rows. Returns the readings."""
    import gc

    import numpy as np
    import torch
    import torch.nn.functional as F

    from lit_llama_tpu_torch import LLaMAConfig
    from lit_llama_tpu_torch.models import llama
    from lit_llama_tpu_torch.ops import flash_attention as fa
    from lit_llama_tpu_torch.ops import quant_matmul
    from lit_llama_tpu_torch.ops.linear import dequantize_int4, quantize_int4, unpack_int4
    from lit_llama_tpu_torch.quant import gptq
    from lit_llama_tpu_torch.utils.checkpoint import tree_leaves

    on_card = dev.type == "cuda"
    cfg = LLaMAConfig.from_name("7B", n_layer=GPTQ_LAYERS)  # f32 weights and compute
    L, D, I = cfg.n_layer, cfg.n_embd, cfg.intermediate_size
    n_samples, T, batch, groupsize = GPTQ_SAMPLES, GPTQ_T, GPTQ_BATCH, GPTQ_GROUPSIZE
    names = [f"h.{l}.{t}" for l in range(L) for t in gptq._BLOCK_TARGETS] + ["lm_head"]
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    calib = np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(n_samples, T))
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    matrix, linear = gptq.gptq_quantize_matrix, gptq.linear
    rec = {}

    def recorded(w, H, **kw):  # each walk's Hessian and seconds, in quantize_model_gptq's call order
        sync()
        t0 = time.perf_counter()
        out = matrix(w, H, **kw)
        sync()
        rec["H"].append(H)
        rec["walk_s"].append(time.perf_counter() - t0)
        return out

    def dropped_split(node, x, **kw):
        """A wrong K3 in the stages: the kernel with the last quarter of K's partial sums lost."""
        x = x.clone()
        x[..., 3 * x.shape[-1] // 4:] = 0
        return linear(node, x, **kw)

    def weight(tree, name):  # on the card, from a spilled tree too
        if name == "lm_head":
            return {k: v.to(dev) for k, v in tree["lm_head"].items()}
        _, l, t = name.split(".", 2)
        return {k: v[int(l)].to(dev) for k, v in gptq._get(tree["h"], t).items()}

    def run(p, c, actorder, plain, spill):
        rec.update(H=[], walk_s=[])
        for fn in counters.values():
            fn.launches = 0
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held_before = torch.cuda.memory_allocated()  # the params and the earlier runs' readings
        sync()
        t0 = time.perf_counter()
        out = gptq.quantize_model_gptq(p, c, calib, groupsize=groupsize, batch=batch, actorder=actorder,
                                       host_spill=spill, plain=plain)
        sync()
        total = time.perf_counter() - t0
        got = {k: fn.launches for k, fn in counters.items()}
        forwards = c.n_layer * -(-n_samples // batch)  # stage B's attention, once a batch and layer
        if on_card:
            want = dict.fromkeys(counters, 0)
            if not plain:
                want.update({"K3": 5 * forwards, "K4": forwards})
            assert got == want, f"GPTQ actorder={actorder} plain={plain} spill={spill}: launches {got}, want {want}"
        log(f"phase 22, GPTQ {c.n_layer} layers actorder={actorder} plain={plain} spill={spill}: {total:.1f} s, "
            f"launches {got}")
        return dict(out=out, H=rec["H"], total_s=total, launches=got,
                    layer_s=(total - rec["walk_s"][-1]) / c.n_layer,
                    walk_s_per_layer=sum(rec["walk_s"][:-1]) / c.n_layer,
                    rest_s_per_layer=(total - sum(rec["walk_s"])) / c.n_layer, lm_head_walk_s=rec["walk_s"][-1],
                    peak_gib=(torch.cuda.max_memory_allocated() - held_before) / 2**30 if on_card else None)

    def objective(w, What, H):
        d = (w - What).double()
        return float((0.5 * (d * (H.double() @ d)).sum()).sqrt())

    def h_err(a, b):  # stage B's Hessian (layer 0's attn.c_proj; both paths quantized c_attn from one Hessian)
        return float((a["H"][1] - b["H"][1]).abs().max() / b["H"][1].abs().max())

    def compare(kern, plain, lins):
        out = {}
        for i, name in enumerate(lins):
            w = weight(params, name)["w"].float()
            qk, qp = weight(kern["out"], name), weight(plain["out"], name)
            wk, wp, Hk, Hp = dequantize_int4(qk), dequantize_int4(qp), kern["H"][i], plain["H"][i]
            out[name] = dict(
                levels_differing=float((unpack_int4(qk["qw"]) != unpack_int4(qp["qw"])).float().mean()),
                objective_kernel=objective(w, wk, Hk), objective_plain=objective(w, wp, Hp),
                objective_rtn=objective(w, dequantize_int4(quantize_int4(w, groupsize)), Hk),
                objective_kernel_on_plain_inputs=objective(w, wk, Hp),
                objective_plain_on_kernel_inputs=objective(w, wp, Hk))
            out[name]["ratio"] = out[name]["objective_kernel"] / out[name]["objective_plain"]
        return out

    runs = {}  # (actorder, plain): the kernel path without actorder spills to the host
    gptq.gptq_quantize_matrix = recorded
    try:
        for actorder, plain in ((False, False), (False, True), (True, False), (True, True)):
            runs[(actorder, plain)] = run(params, cfg, actorder, plain, spill=(actorder, plain) == (False, False))
        gptq.linear = dropped_split
        wrong = run(dict(params, h=_first_layer(params["h"])), cfg.replace(n_layer=1), False, False, False)
    finally:
        gptq.gptq_quantize_matrix, gptq.linear = matrix, linear
    spilled = runs[(False, False)]
    assert all(spilled["out"]["h"]["attn"]["c_attn"][k].device.type == "cpu" for k in ("qw", "qscale", "qzero"))
    assert spilled["out"]["lm_head"]["qw"].device.type == "cpu"
    h_errs = {a: h_err(runs[(a, False)], runs[(a, True)]) for a in (False, True)}
    linears = {f"{n} actorder={a}": r for a in (False, True)
               for n, r in compare(runs[(a, False)], runs[(a, True)], names).items()}
    # the wrong K3 on the first layer against the plain path's first layer (the same inputs up to there)
    wrong_h_err = h_err(wrong, runs[(False, True)])
    wrong_linears = compare(wrong, runs[(False, True)], names[:len(gptq._BLOCK_TARGETS)])
    readings = dict(
        shape=f"{L} layers of width {D}, I {I}, V {cfg.padded_vocab_size}, f32; calibration {n_samples} x {T}, "
              f"batch {batch}, group size {groupsize}",
        params_gib=sum(t.numel() * t.element_size() for t in tree_leaves(params).values()) / 2**30,
        stage_b_hessian_err=h_errs, linears=linears,
        wrong_k3=dict(stage_b_hessian_err=wrong_h_err, linears=wrong_linears),
        runs={f"actorder={a} plain={p} spill={(a, p) == (False, False)}":
              {k: v for k, v in r.items() if k not in ("out", "H")} for (a, p), r in runs.items()})
    readings["runs"]["wrong K3, first layer"] = {k: v for k, v in wrong.items() if k not in ("out", "H")}
    del wrong

    if on_card:
        # a walk's launches a row: one 512-row walk (4 blocks) under torch.profiler
        from torch.profiler import ProfilerActivity, profile

        g = torch.Generator().manual_seed(seed + 1)
        x = torch.randn(1024, 512, generator=g).to(dev)
        w = (torch.randn(512, D, generator=g) * 0.02).to(dev)
        H = gptq.accumulate_hessian(torch.zeros(512, 512, device=dev), x)
        matrix(w, H, groupsize=groupsize)
        sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            matrix(w, H, groupsize=groupsize)
            sync()
        n_kernels = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
        rows = 4 * D + I  # a layer's rows: c_attn, c_proj, c_fc1, c_fc2 (D each), mlp.c_proj (I)
        readings["walk_launches_per_row"] = n_kernels / 512
        readings["walk_launches_per_layer"] = round(n_kernels / 512 * rows)

        # the kernels at the calibration shapes: K3 f32 at M = batch x T, K4 f32 at (batch, H, T, hs)
        M = batch * T
        k3 = {}
        for t in gptq._BLOCK_TARGETS:
            q = weight(spilled["out"], f"h.0.{t}")
            K, N = 2 * q["qw"].shape[0], q["qw"].shape[1]
            x = torch.randn(M, K, generator=g).to(dev)
            args = (x, q["qw"], q["qscale"], q["qzero"], torch.float32)
            err = _held(quant_matmul.matmul_int4(*args), quant_matmul.matmul_int4_ref(*args), TOL_F32,
                        f"K3 f32 M={M} {t}")
            wd = dequantize_int4(q, torch.float32)
            b = bound_ms(M * K * 4 + int4_bytes(K, N, groupsize) + M * N * 4, 2 * M * K * N, f32_peak)
            k3[t] = dict(shape=f"M={M} K={K} N={N} ({t}), f32", max_abs_err=err,
                         ms=time_ms(lambda: quant_matmul.matmul_int4(*args), 5),
                         plain_ms=time_ms(lambda: quant_matmul.matmul_int4_ref(*args), 3),
                         library_ms=time_ms(lambda: torch.matmul(x, wd), 5), bound_ms=b[0], bound_by=b[1])
            del x, args, wd
        results["K3 f32 M8192"] = k3["attn.c_attn"]
        totals["K3 f32 M8192"] = spilled["launches"]["K3"]
        # the yardsticks' arithmetic: torch.matmul in f32 without TF32, and the kernels SDPA's f32 call runs
        readings["allow_tf32"] = dict(cuda_matmul=torch.backends.cuda.matmul.allow_tf32,
                                      cudnn=torch.backends.cudnn.allow_tf32,
                                      float32_matmul_precision=torch.get_float32_matmul_precision())
        assert not torch.backends.cuda.matmul.allow_tf32, "torch.matmul is timed with TF32 allowed"
        H_, hs = cfg.n_head, cfg.head_size
        q, k, v = (torch.randn((batch, H_, T, hs), generator=g).to(dev) for _ in range(3))
        o, lse = fa.flash_attention(q, k, v)
        ro, rlse = fa.flash_attention_ref(q, k, v)
        err4 = max(_held(o, ro, TOL_F32, "K4 f32"), _held(lse, rlse, TOL_F32, "K4 f32 lse"))
        del ro, rlse
        nrow, pairs = batch * H_ * T, batch * H_ * T * (T + 1) // 2
        b4 = bound_ms(4 * nrow * hs * 4 + nrow * 4, 4 * hs * pairs, f32_peak)
        results["K4 f32 B4 T2048"] = dict(
            shape=f"B={batch} H={H_} T={T} hs={hs}, f32", max_abs_err=err4,
            ms=time_ms(lambda: fa.flash_attention(q, k, v), 5), plain_ms=time_ms(lambda: fa.flash_attention_ref(q, k, v), 2),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 5),
            bound_ms=b4[0], bound_by=b4[1])
        totals["K4 f32 B4 T2048"] = spilled["launches"]["K4"]
        readings["k3_f32_shapes"] = k3
        readings["sdpa_f32_kernels"] = []
        for _ in range(3):  # a trace may come back empty (tools/devtime.py kernel_sequence)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                F.scaled_dot_product_attention(q, k, v, is_causal=True)
                sync()
            readings["sdpa_f32_kernels"] = sorted({e.name for e in prof.events()
                                                   if e.device_type == torch.autograd.DeviceType.CUDA})
            if readings["sdpa_f32_kernels"]:
                break
        del q, k, v, o, lse
        log("phase 22, K3 f32 at the calibration shapes: " + "; ".join(
            f"{t} {r['ms']:.2f} ms (bound {r['bound_ms']:.2f} {r['bound_by']}, plain {r['plain_ms']:.2f}, "
            f"torch.matmul {r['library_ms']:.2f}), max err {r['max_abs_err']:.3g}" for t, r in k3.items())
            + "; K4 f32 at ({}, {}, {}, {}) {:.2f} ms (bound {:.2f}, plain {:.2f}, SDPA {:.2f}), max err {:.3g}".format(
                batch, H_, T, hs, *(results["K4 f32 B4 T2048"][k] for k in ("ms", "bound_ms", "plain_ms",
                                                                            "library_ms", "max_abs_err")))
            + f"; torch.matmul timed with allow_tf32 {readings['allow_tf32']}; SDPA's f32 call ran "
            f"{readings['sdpa_f32_kernels']}")
    def worst(lins):
        return max(abs(r["ratio"] - 1) for r in lins.values())

    log(f"phase 22, GPTQ ({readings['shape']}): stage B Hessian kernel vs plain "
        f"{h_errs[True]:.3g} of its largest entry (actorder; spilling, without it, {h_errs[False]:.3g}); per "
        f"linear: levels differing kernel vs plain up to {max(r['levels_differing'] for r in linears.values()):.4f}, "
        f"|objective kernel / plain - 1| up to {worst(linears):.5f}, kernel / round-to-nearest up to "
        f"{max(r['objective_kernel'] / r['objective_rtn'] for r in linears.values()):.4f}; the wrong K3 on the first "
        f"layer: stage B Hessian {wrong_h_err:.3g}, |objective / plain - 1| up to {worst(wrong_linears):.5f}; walk "
        f"launches {readings.get('walk_launches_per_row', 'not measured')} a row, "
        f"{readings.get('walk_launches_per_layer', 'not measured')} a layer; " + "; ".join(
            f"{k}: {r['total_s']:.1f} s, {r['layer_s']:.2f} s a layer (walk {r['walk_s_per_layer']:.2f}, the rest "
            f"{r['rest_s_per_layer']:.2f}), lm_head walk {r['lm_head_walk_s']:.2f} s, peak "
            f"{r['peak_gib'] if r['peak_gib'] is None else round(r['peak_gib'], 2)} GiB over the params' "
            f"{readings['params_gib']:.2f} and what earlier runs hold"
            for k, r in readings["runs"].items()))
    log("phase 22, per linear (levels differing kernel vs plain; objective kernel / plain / round-to-nearest; the "
        "kernel path's on the plain path's inputs, the plain path's on the kernel path's): " + "; ".join(
            f"{n} {r['levels_differing']:.4f}; {r['objective_kernel']:.4g} / {r['objective_plain']:.4g} / "
            f"{r['objective_rtn']:.4g}; {r['objective_kernel_on_plain_inputs']:.4g}, "
            f"{r['objective_plain_on_kernel_inputs']:.4g}"
            for n, r in list(linears.items()) + [(f"wrong K3 {n}", r) for n, r in wrong_linears.items()]))
    assert h_errs[True] <= TOL_GPTQ["hessian"], f"GPTQ stage B Hessian: kernel vs plain {h_errs[True]:.3g}"
    for name, r in linears.items():
        assert abs(r["ratio"] - 1) <= TOL_GPTQ["objective"], f"GPTQ {name}: {r}"
        assert r["objective_kernel"] < r["objective_rtn"], f"GPTQ {name}: not below round-to-nearest, {r}"
    assert wrong_h_err > TOL_GPTQ["hessian"], f"the wrong K3 passes the Hessian check: {wrong_h_err:.3g}"
    assert worst(wrong_linears) > TOL_GPTQ["objective"], f"the wrong K3 passes the objective check: {wrong_linears}"
    del runs, params
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return readings


def perplexity_check(dev, counters, time_ms, bound_ms, tc_peak, results, totals, seed: int):
    """Phase 23: ``eval.perplexity`` on the 7B model in bf16 from random
    weights, over EVAL_WINDOWS windows of EVAL_T random tokens: dense, int4
    and int8 (round to nearest at load, as ``load_model``
    quantizes). Tokens/s (host clock around the windows, after one warm-up
    window) and peak memory each, the launches (K4 a window and layer; K3 or
    K6 for every quantized linear). On one window the kernel path against
    the plain path at EVAL_PLAIN_LAYERS layers: the NLL sum (``TOL_NLL``) and
    the logits (``TOL_MODEL``). On the card, adds the "K3 M2048" and "K6
    M2048" rows. Returns the readings."""
    import gc

    import numpy as np
    import torch

    from lit_llama_tpu_torch import LLaMAConfig
    from lit_llama_tpu_torch.eval.perplexity import _window_nll, perplexity
    from lit_llama_tpu_torch.models import llama
    from lit_llama_tpu_torch.ops import quant_matmul
    from lit_llama_tpu_torch.ops.linear import dequantize_int4, dequantize_int8
    from lit_llama_tpu_torch.utils.checkpoint import tree_leaves

    on_card = dev.type == "cuda"
    cfg = LLaMAConfig.from_name("7B", param_dtype="bfloat16", compute_dtype="bfloat16")
    L, windows, T, plain_layers = cfg.n_layer, EVAL_WINDOWS, EVAL_T, EVAL_PLAIN_LAYERS
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, size=windows * T).astype(np.int32)
    window = torch.from_numpy(tokens[:T][None]).long().to(dev)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    readings, g = {}, torch.Generator().manual_seed(seed + 1)
    for name, mode in (("dense", None), ("int4", "int4"), ("int8", "int8")):
        qcfg = cfg if mode is None else cfg.replace(quantize=mode)
        params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
        if mode is not None:
            params = llama.quantize_params(params, qcfg)
        params = llama.unstack_layers(params)
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        with torch.inference_mode():
            _window_nll(params, window, qcfg)  # warm-up
        for fn in counters.values():
            fn.launches = 0
        params_gib = sum(t.numel() * t.element_size() for t in tree_leaves(params).values()) / 2**30
        if on_card:
            torch.cuda.reset_peak_memory_stats()
            held_before = torch.cuda.memory_allocated()  # the params and what earlier phases hold
        sync()
        t0 = time.perf_counter()
        ppl = perplexity(params, tokens, qcfg, block_size=T)
        sync()
        dt = time.perf_counter() - t0
        got = {k: fn.launches for k, fn in counters.items()}
        assert np.isfinite(ppl), f"perplexity {name}: {ppl}"
        if on_card:
            linears = windows * (4 * L + 1)  # c_attn, c_proj, c_fc12, mlp.c_proj a layer, then lm_head
            want = dict.fromkeys(counters, 0)
            want.update({"K4": windows * L, "K3": linears if mode == "int4" else 0, "K6": linears if mode == "int8" else 0})
            assert got == want, f"perplexity {name}: launches {got}, want {want}"
        p2, c2 = dict(params, h=params["h"][:plain_layers]), qcfg.replace(n_layer=plain_layers)
        with torch.inference_mode():
            lk = llama.forward(p2, window, c2)[0].float()
            lp = llama.forward(p2, window, c2, plain=True)[0].float()
            nk, np_ = float(_window_nll(p2, window, c2)[0]), float(_window_nll(p2, window, c2, plain=True)[0])
        assert torch.isfinite(lk).all(), f"perplexity {name}: non-finite logits"
        logit_err = float((lk - lp).abs().max() / lp.abs().max())
        nll_err = abs(nk - np_) / abs(np_)
        assert nll_err <= TOL_NLL, f"perplexity {name}: NLL sum kernel {nk} vs plain {np_}"
        assert logit_err <= TOL_MODEL[1], f"perplexity {name}: max |dlogit| / max |logit| {logit_err:.3g}"
        # peak memory: the params and the evaluation's own working memory
        readings[name] = dict(perplexity=ppl, seconds=dt, tokens_per_s=windows * T / dt, launches=got,
                              params_gib=params_gib,
                              peak_gib=(params_gib + (torch.cuda.max_memory_allocated() - held_before) / 2**30
                                        if on_card else None),
                              nll_rel_err_kernel_vs_plain=nll_err, logit_rel_err_kernel_vs_plain=logit_err)
        if on_card and mode is not None:
            # the kernel at M = T on each of the four linears of a layer
            shapes = {}
            for lin, node in (("c_attn", params["h"][0]["attn"]["c_attn"]), ("c_proj", params["h"][0]["attn"]["c_proj"]),
                              ("c_fc12", params["h"][0]["mlp"]["c_fc12"]), ("mlp.c_proj", params["h"][0]["mlp"]["c_proj"])):
                K = node["qw"].shape[0] * (2 if mode == "int4" else 1)
                N = node["qw"].shape[1]
                x = torch.randn(T, K, generator=g).to(dev, torch.bfloat16)
                if mode == "int4":
                    args = (x, node["qw"], node["qscale"], node["qzero"], torch.bfloat16)
                    fn, ref, key = quant_matmul.matmul_int4, quant_matmul.matmul_int4_ref, "K3"
                    wd, nbytes = dequantize_int4(node, torch.bfloat16), int4_bytes(K, N, qcfg.quant_groupsize)
                else:
                    args = (x, node["qw"], node["qscale"], torch.bfloat16)
                    fn, ref, key = quant_matmul.matmul_int8, quant_matmul.matmul_int8_ref, "K6"
                    wd, nbytes = dequantize_int8(node, torch.bfloat16), K * N + N * 4
                err = _held(fn(*args), ref(*args), TOL[key], f"{key} M={T} {lin}")
                b = bound_ms(T * K * 2 + nbytes + T * N * 2, 2 * T * K * N, tc_peak)
                shapes[lin] = dict(shape=f"M={T} K={K} N={N} ({lin}), bf16", max_abs_err=err,
                                   ms=time_ms(lambda: fn(*args), 10), plain_ms=time_ms(lambda: ref(*args), 3),
                                   library_ms=time_ms(lambda: torch.matmul(x, wd), 10), bound_ms=b[0], bound_by=b[1])
                del x, args, wd
            key = "K3 M2048" if mode == "int4" else "K6 M2048"
            results[key] = shapes["c_attn"]
            totals[key] = got["K3" if mode == "int4" else "K6"]
            readings[name]["kernel_shapes"] = shapes
        log(f"phase 23, perplexity {name} ({L} layers at width {cfg.n_embd}, {cfg.compute_dtype}, {windows} windows "
            f"of {T}): {ppl:.4f} in {dt:.3f} s, {windows * T / dt:.0f} tokens/s (host clock after a warm-up "
            f"window), peak {readings[name]['peak_gib']} GiB (params {params_gib:.2f}), launches {got}; "
            f"{plain_layers} layers kernel vs plain "
            f"on one window: NLL sum {nk:.3f} vs {np_:.3f} ({nll_err:.3g}), max |dlogit| / max |logit| "
            f"{logit_err:.3g}" + ("; " + "; ".join(
                f"{k} {r['ms'] * 1e3:.1f} us (bound {r['bound_ms'] * 1e3:.1f} {r['bound_by']}, plain "
                f"{r['plain_ms'] * 1e3:.1f}, torch.matmul {r['library_ms'] * 1e3:.1f}), max err {r['max_abs_err']:.3g}"
                for k, r in readings[name].get("kernel_shapes", {}).items()) if "kernel_shapes" in readings[name]
                else ""))
        del params, p2, lk, lp
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    return readings


def _run(cmd, dev, timeout=600):
    """A port entry point in a subprocess (``--device cpu`` off the card);
    returns (stdout, stderr, seconds)."""
    cmd = [sys.executable, "-m"] + cmd + (["--device", "cpu"] if dev.type == "cpu" else [])
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, f"{cmd[2]} exited {proc.returncode}:\n{proc.stderr[-3000:]}"
    return proc.stdout, proc.stderr, time.perf_counter() - t0


def gptq_entry_points(dev, tok_path: Path, entry: Path, peft_dirs, seed: int):
    """Phase 24, on phase 21's 3-layer 7B-width ``.pth`` in ``entry`` and its
    tokenizer: ``python -m lit_llama_tpu_torch.quantize.gptq`` (ENTRY_SAMPLES
    x ENTRY_T calibration windows of a text file), then ``evaluate.full`` and
    ``generate.full`` (greedy) on its output; ``evaluate.lora`` and
    ``evaluate.adapter`` on phase 21's saved directories (``peft_dirs``),
    ``evaluate.adapter_v2`` on a v2 directory written here as finetuning
    saves one (the trainable leaves; gates drawn from layer 2 on);
    ``evaluate.eval_quality`` on a native copy of the base's first layer
    with ``train.bin`` / ``val.bin`` written here. Each printed perplexity equals the in-process
    ``perplexity`` on the same loaded params (relative 1e-4: 4 decimals),
    the greedy tokens the in-process ``generate``'s. Returns the readings."""
    import numpy as np
    import torch

    from lit_llama_tpu_torch.data import sft
    from lit_llama_tpu_torch.data.tokenizer import Tokenizer
    from lit_llama_tpu_torch.eval.perplexity import perplexity
    from lit_llama_tpu_torch.models import generate as gen
    from lit_llama_tpu_torch.models import llama
    from lit_llama_tpu_torch.models.config import AdapterConfig, LoRAConfig
    from lit_llama_tpu_torch.ops.fused_layer import maybe_prepare_fused
    from lit_llama_tpu_torch.peft import adapter as adapter_mod
    from lit_llama_tpu_torch.peft import lora as lora_mod
    from lit_llama_tpu_torch.training.loop import config_meta
    from lit_llama_tpu_torch.utils import checkpoint as ckpt
    from lit_llama_tpu_torch.utils.loader import load_model, load_peft_checkpoint

    pth, rng = entry / "lit-llama.pth", np.random.default_rng(seed)
    n_samples, T, eval_T, new_tokens = ENTRY_SAMPLES, ENTRY_T, ENTRY_EVAL_T, ENTRY_NEW_TOKENS
    letters = list("abcdefghijklmnopqrstuvwxyz")
    (entry / "calib.txt").write_text(" ".join("".join(rng.choice(letters, size=int(rng.integers(1, 8))))
                                              for _ in range(6000)))
    V = json.loads((entry / "config.json").read_text())["vocab_size"]
    val = rng.integers(0, V, size=2 * eval_T).astype(np.uint16)
    val.tofile(entry / "val.bin")
    evals = ["--tokenizer_path", str(tok_path), "--data_file", str(entry / "val.bin"), "--block_size", str(eval_T)]
    readings = {}

    def held(what: str, out: str, params, config) -> float:
        printed = float(out.split("perplexity:")[1].split()[0])
        want = perplexity(params, val.astype(np.int32), config, block_size=eval_T)
        assert abs(printed - want) <= 1e-4 * want, f"{what}: printed perplexity {printed}, in process {want}"
        return printed

    # quantize -> evaluate -> generate
    gdir = entry / "gptq"
    out, err, took = _run(["lit_llama_tpu_torch.quantize.gptq", "--checkpoint_path", str(pth), "--tokenizer_path",
                           str(tok_path), "--output_path", str(gdir), "--n_samples", str(n_samples), "--block_size",
                           str(T), "--data_file", str(entry / "calib.txt")], dev)
    assert f"quantized checkpoint written to {gdir}" in out and ckpt.load_metadata(gdir)["config"]["quantize"] == "int4"
    readings["quantize.gptq"] = dict(seconds=took, log=[ln for ln in err.splitlines() if "GPTQ done" in ln])
    params, config = load_model(gdir, device=dev)
    params = llama.unstack_layers(params)
    out, _, took = _run(["lit_llama_tpu_torch.evaluate.full", "--checkpoint_path", str(gdir)] + evals, dev)
    readings["evaluate.full"] = dict(seconds=took, perplexity=held("evaluate.full", out, params, config))
    tok = Tokenizer(tok_path)
    prompt = "What food do lamas eat?"
    enc = tok.encode(sft.generate_prompt({"instruction": prompt, "input": ""}))
    params, config = maybe_prepare_fused(params, config)
    want = gen.generate(params, enc, new_tokens, config=config, temperature=0.0, eos_id=tok.eos_id,
                        device=dev).tolist()
    del params
    _, err, took = _run(["lit_llama_tpu_torch.generate.full", "--checkpoint_path", str(gdir), "--tokenizer_path",
                         str(tok_path), "--prompt", prompt, "--temperature", "0", "--max_new_tokens", str(new_tokens)],
                        dev)
    got = json.loads(err.split("Token ids 1: ")[-1].splitlines()[0])
    assert got == want, f"generate.full: tokens {got} differ from the in-process generate's {want}"
    readings["generate.full"] = dict(seconds=took, new_tokens=len(got) - len(enc), fused=config.rope_layout == "half")

    # the PEFT evaluations: phase 21's LoRA and Adapter v1 directories, and a v2 directory
    params, config = load_model(pth, device=dev)
    v2cfg = config.replace(adapter=AdapterConfig(v2=True))
    params = adapter_mod.add_adapter_params(params, v2cfg, torch.Generator(device=dev).manual_seed(seed))
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    h = params["h"]
    h["gating"][2:] = torch.randn(h["gating"][2:].shape, generator=g, device=dev).to(h["gating"].dtype)
    for node in (h["attn"]["c_attn"], h["attn"]["c_proj"], h["mlp"]["c_fc1"], h["mlp"]["c_fc2"],
                 h["mlp"]["c_proj"], params["lm_head"]):
        for k, base in (("av2_bias", 0.0), ("av2_scale", 1.0)):
            node[k] = (base + 0.05 * torch.randn(node[k].shape, generator=g, device=dev)).to(node[k].dtype)
    ckpt.save_checkpoint(entry / "adapter_v2", {"params": adapter_mod.adapter_state(params, v2=True)})
    del params
    for mode, flag, path in (("lora", "--lora_path", peft_dirs["lora"]), ("adapter", "--adapter_path",
                                                                          peft_dirs["adapter"]),
                             ("adapter_v2", "--adapter_path", entry / "adapter_v2")):
        params, config = load_model(pth, device=dev)
        kind, overlay, info = load_peft_checkpoint(path, config, device=dev)
        if kind == "lora":
            config = config.replace(lora=LoRAConfig(r=info["r"], alpha=16.0, dropout=0.0))
            params = lora_mod.load_lora_state(params, overlay)
        else:
            config = config.replace(adapter=AdapterConfig(v2=mode == "adapter_v2" or info["v2"],
                                                          prompt_length=info["prompt_length"],
                                                          start_layer=info["start_layer"]))
            params = adapter_mod.load_adapter_state(adapter_mod.add_adapter_params(params, config), overlay)
        out, _, took = _run([f"lit_llama_tpu_torch.evaluate.{mode}", flag, str(path), "--checkpoint_path", str(pth)]
                            + evals, dev)
        readings[f"evaluate.{mode}"] = dict(seconds=took, perplexity=held(f"evaluate.{mode}", out,
                                                                         llama.unstack_layers(params), config))
        del params, overlay

    # the quality ladder (GPTQ and four evaluations) on a native copy of the base's first layer
    params, config = load_model(pth, device=dev)
    params, config = dict(params, h=_first_layer(params["h"])), config.replace(n_layer=1)
    ckpt.save_checkpoint(entry / "native", {"params": params}, metadata={"config": config_meta(config)})
    del params
    (entry / "quality").mkdir(exist_ok=True)
    rng.integers(0, V, size=8 * T).astype(np.uint16).tofile(entry / "quality" / "train.bin")
    rng.integers(0, V, size=2 * config.block_size).astype(np.uint16).tofile(entry / "quality" / "val.bin")
    out, _, took = _run(["lit_llama_tpu_torch.evaluate.eval_quality", "--ckpt_dir", str(entry / "native"),
                         "--data_dir", str(entry / "quality"), "--groupsize", "128", "--n_calib", "4",
                         "--calib_block", str(T), "--max_windows", "2"], dev)
    summary = json.loads(out.strip().splitlines()[-1])
    assert sorted(summary["ppl"]) == ["bf16", "gptq-int4", "int8", "rtn-int4"], summary
    assert all(np.isfinite(v) for v in summary["ppl"].values()), summary
    readings["evaluate.eval_quality"] = dict(seconds=took, summary=summary)
    log(f"phase 24, the entry points in subprocesses on {entry / 'lit-llama.pth'} ({json.loads((entry / 'config.json').read_text())}): " + "; ".join(
        f"{k} exit 0 in {r['seconds']:.1f} s" + (f", perplexity {r['perplexity']} equal to the in-process value"
                                                   if "perplexity" in r else "")
        for k, r in readings.items()) + f"; generate.full's {readings['generate.full']['new_tokens']} greedy tokens "
        f"(fused step: {readings['generate.full']['fused']}) equal to the in-process generate's; eval_quality "
        f"{summary}")
    return readings


def gptq_phases(dev, counters, time_ms, bound_ms, tc_peak, f32_peak, results, totals, tok_path: Path, entry: Path,
                peft_dirs):
    """Phases 22-24 (GPTQ, perplexity, the entry points); each draws from a
    generator of its own. Returns the readings."""
    t0 = time.perf_counter()
    readings = dict(gptq=gptq_check(dev, counters, time_ms, bound_ms, f32_peak, results, totals, SEED + 23))
    readings["perplexity"] = perplexity_check(dev, counters, time_ms, bound_ms, tc_peak, results, totals, SEED + 24)
    readings["entry_points"] = gptq_entry_points(dev, tok_path, entry, peft_dirs, SEED + 25)
    readings["seconds"] = time.perf_counter() - t0
    log(f"phases 22-24 (GPTQ and evaluation): {readings['seconds']:.1f} s")
    return readings


# phases 25-28: the entry points that read published checkpoints, serve over
# HTTP, train a tokenizer and pretrain on it, and merge a LoRA. Their sizes:
# phase 25 converts CONVERT_LAYERS layers of the 7B width (~2.1 GB in bf16);
# phase 26 serves that checkpoint (int4 at load) from HTTP_SLOTS slots, S =
# HTTP_S, HTTP_REQUESTS requests of HTTP_PROMPT tokens each way, HTTP_NEW new
# tokens; phase 27 pretrains SHAKESPEARE_LAYERS layers at block SHAKESPEARE_T
# for SHAKESPEARE_STEPS steps, then resumes for 2 more
CONVERT_LAYERS = 4
HTTP_SLOTS, HTTP_S, HTTP_REQUESTS, HTTP_PROMPT, HTTP_NEW = 32, 1024, 64, (16, 512), (32, 128)
SHAKESPEARE_LAYERS, SHAKESPEARE_T, SHAKESPEARE_STEPS, SHAKESPEARE_WIDTH = 4, 1024, 6, (4096, 32)  # (n_embd, n_head)
# the script's constant 6e-4 without warmup moves every weight by ~lr in Adam's
# first steps, which at width 4096 moves each product by several times its
# initial scale, and the loss spikes; a step of 2e-5 moves a 4096-wide product
# by about half what 6e-4 moves the 256-wide one of the CPU tests
SHAKESPEARE_LR = 2e-5
TIMEOUT_S = 600  # any subprocess of phases 25-28
HTTP_TIMEOUT_S = 300  # any HTTP call of phase 26


def _host_run(module: str, args, timeout=TIMEOUT_S):
    """A host-only entry point (no ``--device``) in a subprocess; returns
    (stdout, seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *map(str, args)], cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, f"{module} exited {proc.returncode}:\n{proc.stderr[-3000:]}"
    return proc.stdout, time.perf_counter() - t0


def conversion_check(dev, work: Path, seed: int):
    """Phase 25: seeded lit-llama weights of CONVERT_LAYERS layers at the 7B
    width in bf16, written as Meta's two tensor-parallel shards
    (``consolidated.00.pth`` / ``.01.pth``, each tensor split along Meta's
    dim) and as two HF ``.bin`` files (q and k in HF's rotary layout), are
    converted by the port's CLIs in subprocesses; each output equals the
    seeded weights tensor for tensor. Returns the readings and the Meta
    conversion's ``.pth`` (with a ``config.json`` beside it)."""
    import shutil

    import torch

    from lit_llama_tpu_torch import LLaMAConfig

    cfg = LLaMAConfig.from_name("7B", n_layer=CONVERT_LAYERS)
    D, V, I, H = cfg.n_embd, cfg.vocab_size, cfg.intermediate_size, cfg.n_head
    gen = torch.Generator(device=dev).manual_seed(seed)

    def w(*shape, base=0.0):
        return (base + 0.02 * torch.randn(shape, generator=gen, device=dev)).to(torch.bfloat16).cpu()

    sd = {"transformer.wte.weight": w(V, D), "transformer.ln_f.scale": w(D, base=1.0), "lm_head.weight": w(V, D)}
    for i in range(cfg.n_layer):
        p = f"transformer.h.{i}."
        sd.update({p + "rms_1.scale": w(D, base=1.0), p + "rms_2.scale": w(D, base=1.0),
                   p + "attn.c_attn.weight": w(3 * D, D), p + "attn.c_proj.weight": w(D, D),
                   p + "mlp.c_fc1.weight": w(I, D), p + "mlp.c_fc2.weight": w(I, D), p + "mlp.c_proj.weight": w(D, I)})
    n_bytes = sum(t.numel() * t.element_size() for t in sd.values())

    # Meta: two shards, each tensor split along the dim Meta's ranks split it
    # (norms replicated); HF: q and k in the half-split rotary layout
    meta = [{}, {}]
    hf = {}

    def shard(name, t, dim):
        for s, part in zip(meta, (t, t) if dim is None else t.chunk(2, dim)):
            s[name] = part.contiguous().clone()

    def hf_layout(t):
        return t.reshape(H, D // H // 2, 2, D).transpose(1, 2).reshape(D, D).contiguous()

    shard("tok_embeddings.weight", sd["transformer.wte.weight"], 1)
    shard("output.weight", sd["lm_head.weight"], 0)
    shard("norm.weight", sd["transformer.ln_f.scale"], None)
    hf.update({"model.embed_tokens.weight": sd["transformer.wte.weight"], "lm_head.weight": sd["lm_head.weight"],
               "model.norm.weight": sd["transformer.ln_f.scale"]})
    for i in range(cfg.n_layer):
        p = f"transformer.h.{i}."
        q, k, v = sd[p + "attn.c_attn.weight"].chunk(3)
        for name, t, dim in (("attention.wq", q, 0), ("attention.wk", k, 0), ("attention.wv", v, 0),
                             ("attention.wo", sd[p + "attn.c_proj.weight"], 1),
                             ("feed_forward.w1", sd[p + "mlp.c_fc1.weight"], 0),
                             ("feed_forward.w2", sd[p + "mlp.c_proj.weight"], 1),
                             ("feed_forward.w3", sd[p + "mlp.c_fc2.weight"], 0),
                             ("attention_norm", sd[p + "rms_1.scale"], None), ("ffn_norm", sd[p + "rms_2.scale"], None)):
            shard(f"layers.{i}.{name}.weight", t, dim)
        h = f"model.layers.{i}."
        hf.update({h + "self_attn.q_proj.weight": hf_layout(q), h + "self_attn.k_proj.weight": hf_layout(k),
                   h + "self_attn.v_proj.weight": v.clone(), h + "self_attn.o_proj.weight": sd[p + "attn.c_proj.weight"],
                   h + "mlp.gate_proj.weight": sd[p + "mlp.c_fc1.weight"], h + "mlp.up_proj.weight": sd[p + "mlp.c_fc2.weight"],
                   h + "mlp.down_proj.weight": sd[p + "mlp.c_proj.weight"], h + "input_layernorm.weight": sd[p + "rms_1.scale"],
                   h + "post_attention_layernorm.weight": sd[p + "rms_2.scale"]})
    readings = dict(weights_bytes=n_bytes, layers=cfg.n_layer)
    t0 = time.perf_counter()
    (work / "meta").mkdir(parents=True)
    (work / "hf").mkdir()
    for rank, s in enumerate(meta):
        torch.save(s, work / "meta" / f"consolidated.{rank:02d}.pth")
    names = list(hf)
    for j, part in enumerate((names[: len(names) // 2], names[len(names) // 2 :])):
        torch.save({n: hf[n] for n in part}, work / "hf" / f"pytorch_model-0000{j + 1}-of-00002.bin")
    readings["write_inputs_s"] = time.perf_counter() - t0
    del meta, hf

    outs = {}
    for kind, module, args in (
            ("meta", "lit_llama_tpu_torch.scripts.convert_checkpoint",
             ["--input_dir", work / "meta", "--output_dir", work / "lit_meta", "--dtype", "bfloat16"]),
            ("hf", "lit_llama_tpu_torch.scripts.convert_hf_checkpoint",
             ["--checkpoint_dir", work / "hf", "--output_dir", work / "lit_hf"])):
        _, took = _host_run(module, args)
        out = work / f"lit_{kind}" / "lit-llama.pth"
        t0 = time.perf_counter()
        got = torch.load(out, mmap=True, weights_only=True)
        assert set(got) == set(sd), f"{kind}: keys {sorted(set(got) ^ set(sd))[:6]} differ"
        for name, t in sd.items():
            assert got[name].dtype == t.dtype and torch.equal(got[name], t), f"{kind} conversion: {name} differs"
        readings[kind] = dict(convert_s=took, check_s=time.perf_counter() - t0,
                              input_bytes=sum(f.stat().st_size for f in (work / kind).iterdir()),
                              output_bytes=out.stat().st_size)
        outs[kind] = out
        del got
    shutil.rmtree(work / "meta")
    shutil.rmtree(work / "hf")
    shutil.rmtree(work / "lit_hf")
    (work / "lit_meta" / "config.json").write_text(json.dumps(dict(n_layer=cfg.n_layer, n_head=cfg.n_head,
                                                                   n_embd=cfg.n_embd, vocab_size=cfg.vocab_size)))
    log(f"phase 25, conversion of {cfg.n_layer} layers at the 7B width ({n_bytes / 1e9:.2f} GB in bf16; inputs "
        f"written in {readings['write_inputs_s']:.1f} s): Meta's 2 shards ({readings['meta']['input_bytes'] / 1e9:.2f} "
        f"GB) -> {readings['meta']['output_bytes'] / 1e9:.2f} GB in {readings['meta']['convert_s']:.1f} s, HF's 2 .bin "
        f"({readings['hf']['input_bytes'] / 1e9:.2f} GB) -> {readings['hf']['output_bytes'] / 1e9:.2f} GB in "
        f"{readings['hf']['convert_s']:.1f} s (subprocesses); every tensor equal to the seeded weights")
    return readings, outs["meta"]


def _http_prompts(tok, rng, n: int):
    """``n`` texts of random words whose token counts (bos included) are
    log-uniform in HTTP_PROMPT."""
    import numpy as np

    lo, hi = HTTP_PROMPT
    letters = list("abcdefghijklmnopqrstuvwxyz")
    texts = []
    for target in np.exp(rng.uniform(np.log(lo), np.log(hi), n)).astype(int):
        words = []
        while len(tok.encode(" ".join(words))) < target:
            words.append("".join(rng.choice(letters, size=int(rng.integers(2, 9)))))
        while len(tok.encode(" ".join(words))) > hi:
            words.pop()
        texts.append(" ".join(words))
    return texts


def _post(url: str, body=None, timeout=HTTP_TIMEOUT_S):
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    with urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=timeout) as r:
        return json.loads(r.read())


def _serving_reading(tokens, ttft_ms, wall: float, steps: int) -> dict:
    """Tokens/s, TTFT p50 / p99 and the useful slots a decode step (tokens
    from decode steps over the steps: a request's first token comes from its
    prefill)."""
    n_tok = sum(len(t) for t in tokens)
    return dict(tokens=n_tok, wall_s=wall, tok_s=n_tok / wall, ttft_p50_ms=ttft_ms[len(ttft_ms) // 2],
                ttft_p99_ms=ttft_ms[int(len(ttft_ms) * 0.99)], decode_steps=steps,
                slots_per_step=(n_tok - len(tokens)) / max(steps, 1))


def http_serving_check(dev, counters, totals, ckpt: Path, tok_path: Path, seed: int):
    """Phase 26: phase 25's ``.pth`` loaded int4 (round to nearest) into a
    HTTP_SLOTS-slot engine. The same HTTP_REQUESTS greedy requests run in
    this process (all queued at once), then through the HTTP server on a
    loopback port (concurrent), then in this process again: the HTTP tokens
    must equal the in-process ones (a row's bits do not depend on the slot
    mix, phase 5b''); K3, K4, K7, K8 and K9 launch over the HTTP run. The
    loop thread's ``step_once`` calls are timed, and each run's useful slots
    a decode step counted, to show where the HTTP path's time goes. Then
    ``python -m lit_llama_tpu_torch.serve.http`` in a subprocess on the same
    file: /health and four requests, tokens equal. Every HTTP call and
    subprocess has a timeout."""
    import gc
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from lit_llama_tpu_torch.data.tokenizer import Tokenizer
    from lit_llama_tpu_torch.serve import DecodeEngine
    from lit_llama_tpu_torch.serve.http import HTTPService
    from lit_llama_tpu_torch.utils.loader import load_model

    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    params, cfg = load_model(ckpt, "gptq.int4", device=dev)
    load_s = time.perf_counter() - t0
    tok = Tokenizer(tok_path)
    rng = np.random.default_rng(seed)
    texts = _http_prompts(tok, rng, HTTP_REQUESTS)
    news = rng.integers(HTTP_NEW[0], HTTP_NEW[1] + 1, HTTP_REQUESTS).tolist()
    lens = [len(tok.encode(t)) for t in texts]
    engine = DecodeEngine(params, cfg, max_batch=HTTP_SLOTS, max_seq_length=HTTP_S, steps_per_sync=8, device=dev)
    engine.warmup()

    def in_process():
        steps0 = engine.decode_steps
        ids = [engine.submit(tok.encode(t, bos=True), n, eos_id=tok.eos_id) for t, n in zip(texts, news)]
        t0 = time.perf_counter()
        done = engine.run()
        wall = time.perf_counter() - t0
        toks = [done[i].generated for i in ids]
        ttft = sorted(done[i].ttft * 1e3 for i in ids)
        return toks, _serving_reading(toks, ttft, wall, engine.decode_steps - steps0)

    want, before = in_process()
    svc = HTTPService(engine, tok, "127.0.0.1", 0).start()
    spans, arrivals = [], []
    step_once, submit = engine.step_once, engine.submit

    def timed_step_once():
        t = time.perf_counter()
        out = step_once()
        spans.append(time.perf_counter() - t)
        return out

    def timed_submit(*a, **kw):
        arrivals.append(time.perf_counter())
        return submit(*a, **kw)

    engine.step_once, engine.submit = timed_step_once, timed_submit
    try:
        # the first urlopen builds urllib's opener (an SSL context: ~40 ms of
        # held interpreter), which 64 threads at once would each build in turn
        assert _post(svc.url + "/health") == {"active": 0, "queued": 0}
        steps0, prefills0 = engine.decode_steps, engine.prefills
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(HTTP_REQUESTS) as pool:
            futs = [pool.submit(_post, svc.url + "/generate", {"prompt": t, "max_new_tokens": n, "temperature": 0})
                    for t, n in zip(texts, news)]
            replies = [f.result(timeout=HTTP_TIMEOUT_S) for f in futs]
        wall = time.perf_counter() - t0
        got = {k: fn.launches for k, fn in counters.items()}
        assert svc.loop_thread.is_alive(), "the server's loop thread died"
        health = _post(svc.url + "/health")
        assert health == {"active": 0, "queued": 0}, health
    finally:
        svc.shutdown()
        del engine.step_once, engine.submit
    steps, prefills = engine.decode_steps - steps0, engine.prefills - prefills0
    if on_card:
        L = cfg.n_layer
        expect = dict.fromkeys(counters, 0)
        expect.update({"K3": prefills * (4 * L + 1) + steps, "K4": L * prefills, "K7": L * steps, "K8": L * steps,
                       "K9": L * steps})
        assert got == expect, f"HTTP serving: launches {got}, expected {expect}"
        for k in ("K3", "K4", "K7", "K8", "K9"):
            totals[k] += got[k]
    for j, (reply, toks) in enumerate(zip(replies, want)):
        assert reply["tokens"] == toks, f"request {j}: HTTP tokens differ from the in-process engine's"
        assert reply["text"] == tok.decode(reply["tokens"])
    again, after = in_process()
    assert again == want, "the second in-process run's tokens differ from the first's"
    http = _serving_reading([r["tokens"] for r in replies], sorted(r["ttft_ms"] for r in replies), wall, steps)
    http.update(loop_busy_share=sum(spans) / wall, step_once_calls=len(spans), prefills=prefills, launches=got,
                arrivals_s=[arrivals[0] - t0, arrivals[-1] - t0])
    readings = dict(load_s=load_s, requests=HTTP_REQUESTS, slots=HTTP_SLOTS, S=HTTP_S,
                    prompt_tokens=[min(lens), max(lens)], http=http, in_process_before=before,
                    in_process_after=after)
    del engine, params
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # the entry point in a subprocess on the same file
    log_path = ckpt.parent / "serve.log"
    cmd = [sys.executable, "-m", "lit_llama_tpu_torch.serve.http", "--checkpoint_path", str(ckpt), "--tokenizer_path",
           str(tok_path), "--quantize", "gptq.int4", "--port", "0", "--max_batch", str(HTTP_SLOTS),
           "--max_seq_length", str(HTTP_S), "--steps_per_sync", "8"] + ([] if on_card else ["--device", "cpu"])
    t0 = time.perf_counter()
    with open(log_path, "w") as f:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT)
    try:
        url = None
        while url is None and time.perf_counter() - t0 < TIMEOUT_S and proc.poll() is None:
            time.sleep(0.5)
            up = [ln for ln in log_path.read_text().splitlines() if ln.startswith("serving on ")]
            url = up[0].split()[-1] if up else None
        assert url, f"serve.http did not come up:\n{log_path.read_text()[-3000:]}"
        start_s = time.perf_counter() - t0
        assert _post(url + "/health") == {"active": 0, "queued": 0}
        with ThreadPoolExecutor(4) as pool:
            futs = [pool.submit(_post, url + "/generate", {"prompt": t, "max_new_tokens": n, "temperature": 0})
                    for t, n in zip(texts[:4], news[:4])]
            sub = [f.result(timeout=HTTP_TIMEOUT_S) for f in futs]
        for j, reply in enumerate(sub):
            assert reply["tokens"] == replies[j]["tokens"], f"serve.http request {j}: tokens differ"
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    readings["subprocess"] = dict(start_s=start_s, requests=4)

    def line(r):
        return (f"{r['tok_s']:.1f} tok/s ({r['tokens']} tokens in {r['wall_s']:.2f} s, {r['decode_steps']} decode steps, "
                f"{r['slots_per_step']:.1f} useful slots a step), TTFT p50 {r['ttft_p50_ms']:.0f} ms, p99 "
                f"{r['ttft_p99_ms']:.0f} ms")

    log(f"phase 26, HTTP serving of phase 25's checkpoint (int4 at load in {load_s:.1f} s; {HTTP_SLOTS} slots, S="
        f"{HTTP_S}; {HTTP_REQUESTS} greedy requests, prompts {min(lens)}..{max(lens)} tokens, {HTTP_NEW[0]}.."
        f"{HTTP_NEW[1]} new): in process {line(before)}; over HTTP {line(http)}, the loop thread in step_once "
        f"{http['loop_busy_share']:.1%} of the wall over {http['step_once_calls']} calls, the requests reaching the "
        f"engine from {http['arrivals_s'][0] * 1e3:.0f} to {http['arrivals_s'][1] * 1e3:.0f} ms; in process again "
        f"{line(after)}; tokens equal; launches {got}; python -m lit_llama_tpu_torch.serve.http up in "
        f"{start_s:.1f} s, 4 requests' tokens equal")
    return readings


def shakespeare_check(dev, totals, work: Path, seed: int):
    """Phase 27: a corpus of the repo's reference Markdown (letters, digits
    and a few marks) goes through
    ``scripts.prepare_shakespeare`` in a subprocess (vocabulary 100); the
    native encoder must have built and give ``encode_py``'s ids on the whole
    corpus (both timed); then ``pretrain.shakespeare`` at the 7B width,
    block SHAKESPEARE_T, SHAKESPEARE_LAYERS layers, batch 2, learning rate
    SHAKESPEARE_LR, for SHAKESPEARE_STEPS steps in this process (the loss must fall, K4 and K10
    launch L · 2 and L times a step) and ``--resume`` for 2 more in a
    subprocess."""
    import gc

    import numpy as np
    import torch

    from lit_llama_tpu_torch.data.tokenizer import Tokenizer
    from lit_llama_tpu_torch.native import tokenizer as native_tok
    from lit_llama_tpu_torch.ops import flash_attention as fa
    from lit_llama_tpu_torch.pretrain import shakespeare

    on_card = dev.type == "cuda"
    # the reference documents, which the port's PRs do not edit, so the corpus
    # (and the run) stays the same from one PR to the next; letters, digits,
    # space and a few marks, as tiny-shakespeare's character set: a
    # vocabulary of 100 has room for ~25 merges above them
    docs = [ROOT / f"{name}.md" for name in ("PAPER", "PAPERS", "SNIPPETS", "SURVEY")]
    docs += sorted((ROOT / "howto").glob("*.md"))
    keep = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 \n.,;:!?'-()")
    corpus = "".join(c for c in "\n".join(p.read_text(encoding="utf-8") for p in docs) if c in keep)
    assert len(corpus) > 10_000, f"only {len(corpus)} characters of Markdown beside chip_smoke.py"
    work.mkdir(parents=True, exist_ok=True)
    (work / "corpus.txt").write_text(corpus, encoding="utf-8")
    data = work / "shakespeare"
    _, prep_s = _host_run("lit_llama_tpu_torch.scripts.prepare_shakespeare",
                          ["--input_file", work / "corpus.txt", "--destination_path", data, "--vocab_size", 100])
    assert native_tok.available(), "the native encoder did not build"
    sp = Tokenizer(data / "tokenizer.model").processor
    assert sp._native() is not None, "the tokenizer did not take the native encoder"
    t0 = time.perf_counter()
    ids = sp.encode(corpus)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ids_py = sp.encode_py(corpus)
    py_s = time.perf_counter() - t0
    assert ids == ids_py, "the native encoder's ids differ from encode_py's"
    text = (data / "input.txt").read_text()
    train_ids = np.fromfile(data / "train.bin", np.uint16)
    assert train_ids.tolist() == sp.encode(text[: int(len(text) * 0.9)]), "train.bin is not the encoded train text"

    fns = {"K4": fa.flash_attention, "K10dq": fa.flash_backward_dq, "K10dkv": fa.flash_backward_dkv}
    for fn in fns.values():
        fn.launches = 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    kw = dict(data_dir=data, n_layer=SHAKESPEARE_LAYERS, n_embd=SHAKESPEARE_WIDTH[0], n_head=SHAKESPEARE_WIDTH[1],
              block_size=SHAKESPEARE_T, batch_size=2, micro_batch_size=2, learning_rate=SHAKESPEARE_LR, log_interval=1)
    t0 = time.perf_counter()
    state = shakespeare.main(out_dir=work / "run", max_iters=SHAKESPEARE_STEPS, device=None if on_card else "cpu", **kw)
    train_s = time.perf_counter() - t0
    got = {k: fn.launches for k, fn in fns.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
    L, steps = SHAKESPEARE_LAYERS, SHAKESPEARE_STEPS
    if on_card:
        want = {"K4": 2 * L * steps, "K10dq": L * steps, "K10dkv": L * steps}
        assert got == want, f"shakespeare pretraining: K4 / K10 launches {got}, expected {want}"
        for k in want:
            totals[k] += got[k]
    recs = [json.loads(x) for x in (work / "run" / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in recs if "loss" in r]
    step_ms = sorted(r["dt_ms"] for r in recs[1:] if "dt_ms" in r)
    assert len(losses) == steps and np.isfinite(losses).all() and losses[-1] < losses[0], f"losses {losses}"
    assert int(state.step) == steps and (work / "run" / "final" / "manifest.json").exists()
    del state
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    args = ["--data_dir", data, "--out_dir", work / "resumed", "--resume", work / "run" / "final", "--max_iters",
            steps + 2] + [a for k, v in kw.items() if k != "data_dir" for a in (f"--{k}", v)]
    _, _, resume_s = _run(["lit_llama_tpu_torch.pretrain.shakespeare", *map(str, args)], dev, TIMEOUT_S)
    resumed = [json.loads(x) for x in (work / "resumed" / "metrics.jsonl").read_text().splitlines()]
    assert [r["iter"] for r in resumed] == [steps, steps + 1], resumed
    readings = dict(corpus_chars=len(corpus), documents=len(docs), tokens=len(ids), prepare_s=prep_s,
                    encode_native_s=native_s, encode_py_s=py_s, train_s=train_s, losses=losses,
                    step_ms_median=step_ms[len(step_ms) // 2], peak_gib=peak_gib, launches=got, resume_s=resume_s,
                    resumed_losses=[r["loss"] for r in resumed])
    log(f"phase 27, tokenizer and shakespeare: {len(docs)} Markdown files, {len(corpus)} characters -> {len(ids)} "
        f"tokens (vocabulary 100; prepare_shakespeare {prep_s:.1f} s in a subprocess); encode native {native_s:.3f} s, "
        f"Python {py_s:.2f} s, ids equal; pretrain.shakespeare {L} layers at width {SHAKESPEARE_WIDTH[0]}, T={SHAKESPEARE_T}, batch 2: "
        f"{steps} steps in {train_s:.1f} s, median {readings['step_ms_median']:.1f} ms a step after the first, "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, peak {peak_gib and round(peak_gib, 2)} GiB, launches K4 "
        f"{got['K4']}, K10 {got['K10dq']} + {got['K10dkv']}; --resume for 2 more in {resume_s:.1f} s (subprocess), "
        f"losses {readings['resumed_losses']}")
    return readings


def merge_and_data_check(dev, work: Path, entry: Path, lora_dir: Path, tok_path: Path, seed: int):
    """Phase 28: ``scripts.convert_lora_weights`` in a subprocess on phase
    21's base ``.pth`` and LoRA directory; the merged ``.pth`` loads with
    ``load_model`` and its logits stand within TOL_MODEL of the base weights
    with the LoRA overlay (not equal: the merge rounds to bf16 once, the
    overlay adds its update in the forward); ``generate.base`` on it in a
    subprocess gives the in-process ``generate``'s greedy tokens. Then
    ``scripts.prepare_alpaca`` on a local JSON written here, and one step of
    ``finetune.lora`` on its output in a subprocess."""
    import gc
    import shutil

    import numpy as np
    import torch

    from lit_llama_tpu_torch.data import sft
    from lit_llama_tpu_torch.data.tokenizer import Tokenizer
    from lit_llama_tpu_torch.models import generate as gen
    from lit_llama_tpu_torch.models import llama
    from lit_llama_tpu_torch.models.config import LoRAConfig
    from lit_llama_tpu_torch.peft import lora as lora_mod
    from lit_llama_tpu_torch.scripts import prepare_alpaca
    from lit_llama_tpu_torch.utils.loader import load_model, load_peft_checkpoint

    on_card = dev.type == "cuda"
    merged = work / "merged" / "lit-llama.pth"
    _, _, merge_s = _run(["lit_llama_tpu_torch.scripts.convert_lora_weights", "--lora_path", str(lora_dir),
                          "--checkpoint_path", str(entry / "lit-llama.pth"), "--output_path", str(merged)], dev,
                         TIMEOUT_S)
    shutil.copy(entry / "config.json", merged.parent / "config.json")

    mparams, mcfg = load_model(merged, device=dev)
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(0, mcfg.vocab_size, (1, 64))).to(dev)
    with torch.no_grad():
        got = llama.forward(mparams, tokens, mcfg)[0].float()
        bparams, bcfg = load_model(entry / "lit-llama.pth", device=dev)
        base = llama.forward(bparams, tokens, bcfg)[0].float()
        kind, overlay, info = load_peft_checkpoint(lora_dir, bcfg, device=dev)
        assert kind == "lora", kind
        lcfg = bcfg.replace(lora=LoRAConfig(r=info["r"], alpha=16.0, dropout=0.0))
        want = llama.forward(lora_mod.load_lora_state(bparams, overlay), tokens, lcfg)[0].float()
    assert torch.isfinite(got).all()
    err = float((got - want).abs().max())
    limit = TOL_MODEL[0] + TOL_MODEL[1] * float(want.abs().max())
    assert err <= limit, f"merged LoRA: max |dlogit| {err:.3g} > {limit:.3g} against the overlay"
    moved = float((want - base).abs().max())
    del bparams, overlay, base, want, got

    tok = Tokenizer(tok_path)
    enc = tok.encode("the lamas eat grass", bos=True)
    want_ids = gen.generate(llama.unstack_layers(mparams), enc, 16, config=mcfg, temperature=0.0, device=dev).tolist()
    del mparams
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    _, stderr, gen_s = _run(["lit_llama_tpu_torch.generate.base", "--checkpoint_path", str(merged), "--tokenizer_path",
                             str(tok_path), "--prompt", "the lamas eat grass", "--temperature", "0",
                             "--max_new_tokens", "16"], dev, TIMEOUT_S)
    got_ids = json.loads(stderr.split("Token ids 1: ")[-1].splitlines()[0])
    assert got_ids == want_ids, f"generate.base (merged): tokens {got_ids} differ from the in-process {want_ids}"

    rng = np.random.default_rng(seed)
    letters = list("abcdefghijklmnopqrstuvwxyz")

    def words(k):
        return " ".join("".join(rng.choice(letters, size=int(rng.integers(1, 8)))) for _ in range(k))

    examples = [{"instruction": words(int(rng.integers(3, 20))), "input": words(4) if i % 3 == 0 else "",
                 "output": words(int(rng.integers(3, 30)))} for i in range(24)]
    (work / "alpaca.json").write_text(json.dumps(examples))
    t0 = time.perf_counter()
    prepare_alpaca.prepare(destination_path=work / "alpaca", tokenizer_path=tok_path, test_split_size=4,
                           max_seq_length=256, data_file=work / "alpaca.json")
    prep_s = time.perf_counter() - t0
    assert len(sft.load_samples(work / "alpaca" / "train.pt")) == 20
    _, _, ft_s = _run(["lit_llama_tpu_torch.finetune.lora", "--data_dir", str(work / "alpaca"), "--checkpoint_path",
                       str(merged), "--tokenizer_path", str(tok_path), "--out_dir", str(work / "ft"), "--max_iters", "1",
                       "--batch_size", "4", "--micro_batch_size", "4", "--warmup_iters", "1", "--eval_interval", "100",
                       "--save_interval", "100", "--max_seq_length", "256"], dev, TIMEOUT_S)
    losses = [json.loads(x)["loss"] for x in (work / "ft" / "metrics.jsonl").read_text().splitlines() if '"loss"' in x]
    assert len(losses) == 1 and np.isfinite(losses[0]), losses
    readings = dict(merge_s=merge_s, max_dlogit=err, limit=limit, lora_moved_logits=moved, generate_s=gen_s,
                    prepare_alpaca_s=prep_s, finetune_s=ft_s, finetune_loss=losses[0])
    log(f"phase 28: convert_lora_weights on phase 21's LoRA in {merge_s:.1f} s (subprocess); merged logits within "
        f"{err:.3g} of the overlay's (limit {limit:.3g}; the overlay moves them {moved:.3g} from the base); "
        f"generate.base on the merged .pth in {gen_s:.1f} s, 16 greedy tokens equal to the in-process generate's; "
        f"prepare_alpaca {prep_s:.1f} s (in process), finetune.lora 1 step on its output in {ft_s:.1f} s, loss {losses[0]:.4f}")
    return readings


def entry_point_phases(dev, counters, totals, work: Path, entry: Path, lora_dir: Path, tok_path: Path):
    """Phases 25-28 in ``work``; each draws from a generator of its own.
    Returns the readings and phase 25's 4-layer ``.pth`` (phase 31 serves it;
    the caller removes ``work``)."""
    import gc
    import shutil

    import torch

    t0 = time.perf_counter()
    work.mkdir(parents=True, exist_ok=True)
    readings = {}
    readings["conversion"], pth = conversion_check(dev, work / "convert", SEED + 26)
    gc.collect()
    readings["http"] = http_serving_check(dev, counters, totals, pth, tok_path, SEED + 27)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings["shakespeare"] = shakespeare_check(dev, totals, work / "shakespeare", SEED + 28)
    shutil.rmtree(work / "shakespeare")
    readings["merge_and_data"] = merge_and_data_check(dev, work / "merge", entry, lora_dir, tok_path, SEED + 29)
    shutil.rmtree(work / "merge")
    readings["seconds"] = time.perf_counter() - t0
    log(f"phases 25-28 (conversion, HTTP serving, tokenizer and shakespeare, merge and data): "
        f"{readings['seconds']:.1f} s")
    return readings, pth


# ---- phases 29-31 (slice 17): tensor- and data-parallel inference. PAR_RANKS
# ranks run as processes on the one card over gloo (NCCL refuses two ranks on
# one card), so these phases check that every rank's kernels take their local
# shapes and that the sharded model computes the single-card model; they give
# no scaling figure. Phase 29: TP at mp = 2 on the 7B int4 model, a
# TP_PROMPT-token prefill and TP_STEPS teacher-forced decode steps held against
# the single-card per-op path on the same tokens, and the TP kernel path
# against the TP plain path (TP_PLAIN_STEPS steps): through all 32 blocks in
# f32 compute (TOL_MODEL_F32: only the order of f32 sums differs), and in bf16
# at two blocks (TOL_MODEL, the depth it is set for). In bf16 through 32 blocks
# the rounding compounds: on an H100 the single card's own kernel and plain
# paths part by 6.0 % of max |logit| on this prompt and TP by 7.7 % (phase 29's
# readings, PERF.md), so the main path's departure is read beside the single
# card's, not held to TOL_MODEL. Then every kernel of the main path (K3, K4, K5; K6 on a
# TP_INT8_LAYERS-layer int8 model) against its plain version on the inputs the
# path gave it (TOL), and a free-running greedy generate_tp of TP_GEN tokens.
# Phase 30: DP at dp = 2, phase 8's 64 requests through 32
# slots, 16 a rank: the tokens equal phase 8's request for request (K7-K9 give
# a row the same bits at any slot count), K7, K8, K9 and K3 held likewise.
# Phase 31: generate.lora and serve.http with --model_parallel 2 under torchrun
# on phase 25's 4-layer checkpoint, each against the same path in the ranks.
PAR_RANKS = 2
TP_PROMPT, TP_STEPS, TP_GEN, TP_S, TP_PLAIN_STEPS, TP_INT8_LAYERS = 128, 32, 32, 256, 2, 2
PAR_HTTP_SLOTS, PAR_HTTP_S, PAR_HTTP_REQUESTS, PAR_HTTP_NEW, PAR_LORA_NEW = 4, 512, 4, 16, 16
PAR_TIMEOUT_S = 900  # the spawn of phases 29-30 and each torchrun of phase 31
# the ranks' gloo binds to the loopback device and their store to 127.0.0.1
PAR_ENV = {"GLOO_SOCKET_IFNAME": "lo", "OMP_NUM_THREADS": "4"}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _model_held(got, want, what: str, tol=TOL_MODEL) -> float:
    """max |dlogit| / max |logit|, asserting max |dlogit| <= tol[0] + tol[1]
    * max |logit| (TOL_MODEL; (0, TOL_MODEL_F32) in f32)."""
    import torch

    got, want = got.float(), want.float()
    assert torch.isfinite(got).all(), f"{what}: non-finite logits"
    err, top = float((got - want).abs().max()), float(want.abs().max())
    assert err <= tol[0] + tol[1] * top, f"{what}: max |dlogit| {err:.3g} > {tol[0]} + {tol[1]} * {top:.3g}"
    return err / top


# the kernels of the multi-rank paths: (module, attribute the path calls, plain
# version, the arguments that change between calls: copied when recorded)
def _par_kernels():
    from lit_llama_tpu_torch.models import llama
    from lit_llama_tpu_torch.ops import decode_attention as da
    from lit_llama_tpu_torch.ops import flash_attention as fa
    from lit_llama_tpu_torch.ops import fused_layer, quant_matmul

    return {"K3": (quant_matmul, "matmul_int4", quant_matmul.matmul_int4_ref, (0,)),
            "K6": (quant_matmul, "matmul_int8", quant_matmul.matmul_int8_ref, (0,)),
            "K4": (fa, "flash_attention", fa.flash_attention_ref, (0, 1, 2)),
            "K5": (llama, "decode_attention", da.decode_attention_ref, (0, 1, 2, 3, 4, 5)),
            "K7": (fused_layer, "block_head_fused", fused_layer.block_head_fused_ref, (0, 2, 3)),
            "K8": (llama, "decode_attention_write", da.decode_attention_write_ref, (0, 1, 2, 3, 4, 5)),
            "K9": (fused_layer, "block_tail_fused", fused_layer.block_tail_fused_ref, (0, 1))}


def _recording(keys, run, keep=lambda key, args: True):
    """``run()`` with the kernels ``keys`` recording the inputs of their first
    call at each shape (``keep`` filters); returns {(key, shapes...): args}."""
    import torch

    table, seen, saved = _par_kernels(), {}, {}
    for key in keys:
        mod, name, _, changing = table[key]
        orig = saved[key] = getattr(mod, name)

        def wrapper(*args, _key=key, _orig=orig, _changing=changing):
            sig = (_key,) + tuple(tuple(a.shape) for a in args if torch.is_tensor(a))
            if sig not in seen and keep(_key, args):
                seen[sig] = tuple(a.clone() if i in _changing and torch.is_tensor(a) else a
                                  for i, a in enumerate(args))
            return _orig(*args)

        wrapper.__dict__ = orig.__dict__  # the wrapper's own launch count (name.launches += 1) lands on orig's
        setattr(mod, name, wrapper)
    try:
        run()
    finally:
        for key, orig in saved.items():
            setattr(table[key][0], table[key][1], orig)
    return seen


def _hold_recorded(seen) -> dict:
    """Each recorded call's kernel against its plain version on the same
    inputs, TOL[key] (K4's o; K8's y, and its caches identical): {key: max
    abs err}. K5 and K8 average cache rows, and the absolute part of their
    TOL is set for rows of N(0, 0.5^2) entries (phases 5c, 10): they are held
    on such q, k, v and caches, at the shapes and positions the path gave
    them. The path's own rows are larger, and there one bf16 ulp of a
    softmax weight moves a small mean by more (on an H100, layer 0's cache
    at the 7B width gave 0.0039 where |y| < 0.15)."""
    import torch

    table, errs = _par_kernels(), {}
    gen = torch.Generator().manual_seed(SEED + 30)
    for sig, args in seen.items():
        key = sig[0]
        mod, name, ref, changing = table[key]
        if key in ("K5", "K8"):
            args = tuple((torch.randn(a.shape, generator=gen) * 0.5).to(a.device, a.dtype)
                         if torch.is_tensor(a) and a.is_floating_point() else a for a in args)
        a_k, a_p = ([a.clone() if i in changing and torch.is_tensor(a) else a for i, a in enumerate(args)]
                    for _ in range(2))
        got, want = getattr(mod, name)(*a_k), ref(*a_p)
        if key == "K8":
            assert torch.equal(a_k[3], a_p[3]) and torch.equal(a_k[4], a_p[4]), f"K8 {sig[1:]}: caches differ"
        if isinstance(got, tuple):
            got, want = got[0], want[0]
        errs[key] = max(errs.get(key, 0.0), _held(got, want, TOL[key], f"{key} {sig[1:]}"))
    return errs


def _time_recorded(seen, time_us, peaks) -> dict:
    """Each recorded call of K3 / K6 / K4 / K5 / K7 / K8 / K9 timed (device
    µs, writing L2 flush) beside its plain version and the PyTorch call that
    computes the same function, with its bound: {"key shape": reading}."""
    import torch
    import torch.nn.functional as F

    from lit_llama_tpu_torch.ops.linear import dequantize_int4, dequantize_int8

    bw, tc_peak, f32_peak = peaks
    table, out = _par_kernels(), {}

    def bound(nbytes, ops, peak):
        t_b, t_o = nbytes / bw, ops / peak
        return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")

    for sig, args in seen.items():
        key = sig[0]
        mod, name, ref, _ = table[key]
        kern = getattr(mod, name)
        library = None
        if key in ("K3", "K6"):
            x, qw = args[0], args[1]
            M, K, N = x.numel() // x.shape[-1], x.shape[-1], qw.shape[-1]
            if key == "K3":
                w = dequantize_int4({"qw": qw, "qscale": args[2], "qzero": args[3]}, torch.bfloat16)
                wbytes = int4_bytes(K, N, K // args[2].shape[0])
            else:
                w = dequantize_int8({"qw": qw, "qscale": args[2]}, torch.bfloat16)
                wbytes = K * N + N * 4
            x2 = x.reshape(M, K)
            library = (lambda x2=x2, w=w: torch.matmul(x2, w))
            shape, b = f"M={M} {K}->{N}", bound(M * K * 2 + wbytes + M * N * 2, 2 * M * K * N, tc_peak)
        elif key == "K4":
            q = args[0]
            B, H, T, hs = q.shape
            library = (lambda q=q, k=args[1], v=args[2]: F.scaled_dot_product_attention(q, k, v, is_causal=True))
            shape = f"B={B} H={H} T={T} hs={hs}"
            b = bound(4 * B * H * T * hs * 2 + B * H * T * 4, 2 * B * H * T * T * hs, tc_peak)
        elif key == "K5":
            q, kc, vc, limit = args[0], args[1], args[2], args[5]
            B, H, S, hs = kc.shape
            vis = (torch.arange(S, device=q.device)[None, :] <= limit[:, None].long())[:, None, None, :]
            rows = int(vis.sum())  # the rows this call's data makes visible, over the batch
            library = (lambda q=q, k=kc, v=vc, m=vis: F.scaled_dot_product_attention(q, k, v, attn_mask=m))
            shape = f"B={B} H={H} S={S} hs={hs}, {rows // B} rows visible"
            b = bound(2 * H * rows * hs * 2 + 2 * B * H * hs * 2, 4 * H * rows * hs, f32_peak)
        elif key == "K8":
            q, kn, vn, kc, vc, pos = args
            B, H, S, hs = kc.shape
            rows_b = torch.arange(B, device=q.device)
            wp = (pos % S).long()
            vis = (torch.arange(S, device=q.device)[None, :] <= pos[:, None].long())[:, None, None, :]
            rows = int(vis.sum())

            def library(q=q, kn=kn, vn=vn, kc=kc.clone(), vc=vc.clone(), rows_b=rows_b, wp=wp, vis=vis):
                kc[rows_b, :, wp] = kn[:, :, 0]  # index_put_
                vc[rows_b, :, wp] = vn[:, :, 0]
                return F.scaled_dot_product_attention(q, kc, vc, attn_mask=vis)

            shape = f"B={B} H={H} S={S} hs={hs}, {rows // B} rows visible on average"
            D = H * hs
            b = bound(2 * H * rows * hs * 2 + 4 * B * D * 2 + 2 * B * D * 2 + B * 4, 4 * H * rows * hs, f32_peak)
        elif key == "K7":
            x, ca, config = args[0], args[4], args[5]
            B, D = x.shape
            gs = config.quant_groupsize
            shape = f"B={B} D={D} -> 3D (c_attn)"
            b = bound(B * D * 2 + D * 2 + int4_bytes(D, 3 * D, gs) + 2 * B * config.head_size * 4 + B * 3 * D * 2,
                      2 * B * D * 3 * D, tc_peak)
        else:  # K9
            x, config = args[0], args[6]
            B, D = x.shape
            I, gs = config.intermediate_size, config.quant_groupsize
            shape = f"B={B} D={D} I={I}"
            b = bound(2 * B * D * 2 + D * 2 + int4_bytes(D, D, gs) + int4_bytes(D, 2 * I, gs) + int4_bytes(I, D, gs)
                      + B * D * 2, 2 * B * (D * D + 2 * I * D + I * D), tc_peak)
        # K8 writes each slot's row again with the same values: a rerun changes nothing
        out[f"{key} {shape}"] = dict(
            key=key, shape=shape, ms=time_us(lambda args=args: kern(*args)) / 1e3,
            plain_ms=time_us(lambda args=args: ref(*args), 3) / 1e3,
            library_ms=None if library is None else time_us(library) / 1e3, bound_ms=b[0], bound_by=b[1])
    return out


def _par_job(rank: int, payload) -> dict:
    """Phases 29-30 on one rank (and the references phase 31 is held to)."""
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist

    from lit_llama_tpu_torch import LLaMAConfig, LoRAConfig
    from lit_llama_tpu_torch.models import llama
    from lit_llama_tpu_torch.ops import decode_attention as da
    from lit_llama_tpu_torch.ops import flash_attention as fa
    from lit_llama_tpu_torch.ops import fused_layer, quant_matmul
    from lit_llama_tpu_torch.ops.rope import build_rope_cache
    from lit_llama_tpu_torch.parallel import comm, launch, mesh as mesh_lib, tp
    from lit_llama_tpu_torch.peft import lora as lora_mod
    from lit_llama_tpu_torch.serve import DecodeEngine
    from lit_llama_tpu_torch.tools import devtime
    from lit_llama_tpu_torch.utils.device import device_peaks
    from lit_llama_tpu_torch.utils.loader import load_model, load_peft_checkpoint
    from lit_llama_tpu_torch.utils.random_params import random_int4_params, random_int8_params

    dev = launch.current_device()
    on_card = dev.type == "cuda"  # off the card (a rehearsal at small widths) nothing launches or is timed
    assert dist.get_backend() == "gloo" and (dev == torch.device("cuda", 0) or not on_card), (dev, dist.get_backend())
    lead = rank == 0

    def sync(empty=False):
        if on_card:
            torch.cuda.synchronize()
            if empty:
                torch.cuda.empty_cache()

    counters = {"K1": fused_layer.decode_layers_fused, "K2": fused_layer.lm_head_fused,
                "K3": quant_matmul.matmul_int4, "K4": fa.flash_attention, "K5": da.decode_attention,
                "K6": quant_matmul.matmul_int8, "K7": fused_layer.block_head_fused,
                "K8": da.decode_attention_write, "K9": fused_layer.block_tail_fused,
                "K1 LoRA": fused_layer.k1_lora, "K7 LoRA": fused_layer.k7_lora}

    def zero():
        for fn in counters.values():
            fn.launches = 0
        comm.reset_stats()
        sync()

    def launches():
        sync()
        return {k: fn.launches for k, fn in counters.items()}

    time_us = devtime.make_timer(dev) if on_card else None
    peaks = device_peaks(torch.cuda.get_device_name(0)) if on_card else None
    out = {"device": str(dev), "backend": dist.get_backend()}
    widths = payload.get("widths", {})  # the 7B preset, or a rehearsal's small widths
    cfg7 = LLaMAConfig.from_name("7B", param_dtype="bfloat16", compute_dtype="bfloat16", quantize="int4", **widths)
    L, V = cfg7.n_layer, cfg7.padded_vocab_size
    out["layers"] = L
    toks = torch.randint(1, cfg7.vocab_size, (TP_PROMPT + TP_STEPS,), generator=torch.Generator().manual_seed(
        SEED + 29)).to(dev)
    rope = build_rope_cache(cfg7.block_size, cfg7.head_size, device=dev)

    # ---- 29. TP at mp = 2 on the 7B int4 model ------------------------------
    mesh = mesh_lib.make_mesh(data=1, model=PAR_RANKS)

    def single_card(cfg, params, n_steps, plain=False):
        """The single-card per-op path on ``toks``: the prefill's logits, then
        each teacher-forced step's (f32, on the host)."""
        cache = llama.init_kv_cache(cfg, 1, TP_S, device=dev)
        with torch.no_grad():
            got = [llama.forward(params, toks[None, :TP_PROMPT], cfg, rope_cache=rope, kv_cache=cache,
                                 prefill_from_zero=True, plain=plain)[0].float().cpu()]
            for i in range(n_steps):
                p = TP_PROMPT + i
                got.append(llama.forward(params, toks[None, p : p + 1], cfg, rope_cache=rope, input_pos=[p],
                                         kv_cache=cache, plain=plain)[0].float().cpu())
        return got

    def tp_logits(cfg, sp, n_steps, plain=False):
        """The same through the TP forward: the prefill, then ``slot_pos`` steps."""
        prefill, decode = tp.make_sharded_forwards(cfg, mesh, rope)
        cache = tp.init_tp_cache(cfg, mesh, 1, TP_S, device=dev)
        with torch.no_grad():
            got = [prefill(sp, toks[None, :TP_PROMPT], cache, plain=plain)[0].float()]
            for i in range(n_steps):
                p = TP_PROMPT + i
                got.append(decode(sp, toks[None, p : p + 1], torch.tensor([p], dtype=torch.int32, device=dev),
                                  cache, plain=plain)[0].float())
        return got

    def against_single_card(cfg, tol, what):
        """TP against the single card on the same tokens (rank 0), and the TP
        kernel path against the TP plain path, each held to ``tol``: max
        |dlogit| / max |logit| over the prefill and the steps."""
        full = llama.unstack_layers(random_int4_params(cfg, seed=SEED, device=dev))
        ref = single_card(cfg, full, TP_STEPS) if lead else None
        sp = tp.shard_params_tp(full, mesh, cfg)
        del full
        got = tp_logits(cfg, sp, TP_STEPS)
        r = {"kernel_vs_plain": max(_model_held(g, q, f"{what}, TP kernel vs plain path, {i}", tol) for i, (g, q)
                                    in enumerate(zip(got, tp_logits(cfg, sp, TP_PLAIN_STEPS, plain=True))))}
        if lead:
            r["vs_single_card"] = max(_model_held(g.cpu(), w, f"{what}, TP vs the single card, {i}", tol)
                                      for i, (g, w) in enumerate(zip(got, ref)))
        return r

    # 29a. the whole depth in f32 compute, where only the order of f32 sums differs
    out["tp_f32"] = against_single_card(cfg7.replace(param_dtype="float32", compute_dtype="float32"),
                                        (0.0, TOL_MODEL_F32), f"f32, {L} layers")
    # 29b. bf16 at TOL_MODEL's depth: two blocks, as phases 6, 7d and 11 hold their paths
    out["tp_2_layers"] = against_single_card(cfg7.replace(n_layer=min(2, L)), TOL_MODEL, "bf16, 2 layers")
    sync(empty=True)
    # 29c. the main path: bf16 through all 32 blocks, its launches counted. bf16
    # rounding compounds with depth: the single card's own kernel and plain
    # paths part by as much here, so the departure is read beside theirs
    full = llama.unstack_layers(random_int4_params(cfg7, seed=SEED, device=dev))
    if lead:
        ref = single_card(cfg7, full, TP_STEPS)
        ref_plain = single_card(cfg7, full, 0, plain=True)
    t0 = time.perf_counter()
    sp = tp.shard_params_tp(full, mesh, cfg7)
    del full
    gc.collect()
    sync()
    out["tp_shard_s"] = time.perf_counter() - t0
    out["tp_local_gib"] = sum(t.numel() * t.element_size() for t in _tensors(sp)) / 2**30

    def tp_run(n_steps):
        return tp_logits(cfg7, sp, n_steps)

    zero()
    t0 = time.perf_counter()
    got = tp_run(TP_STEPS)
    wall = time.perf_counter() - t0
    tp_launch = launches()
    comm_calls, comm_s = comm.stats["calls"], comm.stats["seconds"]
    want = dict.fromkeys(counters, 0)
    want.update(K3=5 * L * (1 + TP_STEPS), K4=L, K5=L * TP_STEPS)  # the local lm_head (V/2 = 16000) runs plain
    assert tp_launch == want or not on_card, f"rank {rank}, TP: launches {tp_launch}, expected {want}"
    assert comm_calls == (2 * L + 1) * (1 + TP_STEPS), f"rank {rank}, TP: {comm_calls} collectives"
    assert all(torch.isfinite(g).all() and g.shape[-1] == V for g in got), "TP: non-finite or misshapen logits"
    out["tp"] = dict(launches=tp_launch, wall_s=wall, steps=TP_STEPS, prompt=TP_PROMPT, collectives=comm_calls,
                     collective_s=comm_s)
    if lead:
        rel = [float((g.cpu() - w).abs().max() / w.abs().max()) for g, w in zip(got, ref)]
        out["tp"].update(vs_single_card=max(rel), vs_single_card_prefill=rel[0],
                         single_card_kernel_vs_plain_prefill=float((ref[0] - ref_plain[0]).abs().max()
                                                                   / ref_plain[0].abs().max()),
                         argmax_agree=float(np.mean([bool((g.cpu().argmax(-1) == w.argmax(-1)).all())
                                                     for g, w in zip(got[1:], ref[1:])])))
        del ref, ref_plain
    del got
    seen = _recording(("K3", "K4", "K5"), lambda: tp_run(1))
    out["tp"]["kernel_errs"] = _hold_recorded(seen)
    dist.barrier()
    if lead and on_card:  # one rank times while the other waits
        out["tp"]["kernel_times"] = _time_recorded(seen, time_us, peaks)
    dist.barrier()
    del seen
    # a free-running greedy generation of TP_GEN tokens
    zero()
    t0 = time.perf_counter()
    y = tp.generate_tp(sp, toks[:TP_PROMPT].cpu(), TP_GEN, config=cfg7, mesh=mesh, max_seq_length=TP_S,
                       temperature=0.0)
    gen_wall = time.perf_counter() - t0
    out["generate_tp"] = dict(tokens=y[TP_PROMPT:].tolist(), wall_s=gen_wall, tok_s=TP_GEN / gen_wall,
                              collective_share=comm.stats["seconds"] / gen_wall, launches=launches())
    del sp
    gc.collect()
    sync(empty=True)

    # ---- 29b. K6 on the TP path: a TP_INT8_LAYERS-layer 7B-width int8 model ---
    cfg8 = LLaMAConfig.from_name("7B", param_dtype="bfloat16", compute_dtype="bfloat16", quantize="int8",
                                 **{**widths, "n_layer": TP_INT8_LAYERS})
    sp8 = tp.shard_params_tp(random_int8_params(cfg8, seed=SEED + 3, device=dev), mesh, cfg8)
    prefill8, decode8 = tp.make_sharded_forwards(cfg8, mesh, rope)

    def int8_run(n_steps, plain=False):
        cache = tp.init_tp_cache(cfg8, mesh, 1, TP_S, device=dev)
        with torch.no_grad():
            got = [prefill8(sp8, toks[None, :16], cache, plain=plain)[0].float()]
            for i in range(n_steps):
                got.append(decode8(sp8, toks[None, 16 + i : 17 + i], torch.tensor([16 + i], dtype=torch.int32,
                                                                               device=dev), cache, plain=plain)[0].float())
        return got

    zero()
    got8 = int8_run(4)
    l8 = launches()
    assert (l8["K6"] == 5 * TP_INT8_LAYERS * 5 and l8["K5"] == TP_INT8_LAYERS * 4) or not on_card, \
        f"rank {rank}, TP int8: {l8}"
    out["tp_int8"] = dict(launches=l8, kernel_vs_plain=max(
        _model_held(g, p, f"TP int8 kernel vs plain, {i}") for i, (g, p) in enumerate(zip(got8, int8_run(4, True)))))
    seen = _recording(("K6",), lambda: int8_run(1))
    out["tp_int8"]["kernel_errs"] = _hold_recorded(seen)
    dist.barrier()
    if lead and on_card:
        out["tp_int8"]["kernel_times"] = _time_recorded(seen, time_us, peaks)
    dist.barrier()
    del sp8, seen, got8
    gc.collect()
    sync(empty=True)

    # ---- 30. DP at dp = 2: phase 8's 64 requests through 32 slots, 16 a rank ---
    mesh_dp = mesh_lib.make_mesh(data=PAR_RANKS, model=1)
    engine = DecodeEngine(random_int4_params(cfg7, seed=SEED, device=dev), cfg7, max_batch=payload["slots"],
                          max_seq_length=payload["S"], steps_per_sync=8, mesh=mesh_dp, device=dev)
    assert engine.serve_fused and engine.local_b == payload["slots"] // PAR_RANKS
    if lead:
        engine.warmup()
        engine.stop()
    else:
        engine.follow()
    steps0, prefills0 = engine.decode_steps, engine.prefills
    finished = {}

    def dp_run():
        if lead:
            ids = [engine.submit(p, payload["new"]) for p in payload["prompts"]]
            finished.update(ids=ids, done=engine.run())
            engine.stop()
        else:
            engine.follow()

    zero()
    t0 = time.perf_counter()
    # the kernels' inputs recorded on the way (a copy of each at its first call;
    # K3 at the logits' 16 rows, not the prefills' widths)
    seen = _recording(("K3", "K7", "K8", "K9"), dp_run,
                      keep=lambda key, args: key != "K3" or args[0].shape[:-1] == (engine.local_b, 1))
    wall = time.perf_counter() - t0
    dp_launch = launches()
    steps, prefills = engine.decode_steps - steps0, engine.prefills - prefills0
    want = dict.fromkeys(counters, 0)
    want.update(K3=prefills * (4 * L + 1) + steps, K4=L * prefills, K7=L * steps, K8=L * steps, K9=L * steps)
    assert dp_launch == want or not on_card, f"rank {rank}, DP: launches {dp_launch}, expected {want}"
    out["dp"] = dict(launches=dp_launch, wall_s=wall, decode_steps=steps, prefills=prefills,
                     collectives=comm.stats["calls"], collective_s=comm.stats["seconds"])
    if lead:
        ids, done = finished["ids"], finished["done"]
        out["dp"]["tokens"] = [done[i].generated for i in ids]
        out["dp"]["ttft_ms"] = sorted(done[i].ttft * 1e3 for i in ids)
    assert {sig[0] for sig in seen} == {"K3", "K7", "K8", "K9"}, sorted(seen)
    out["dp"]["kernel_errs"] = _hold_recorded(seen)
    dist.barrier()
    if lead and on_card:
        out["dp"]["kernel_times"] = _time_recorded(seen, time_us, peaks)
    dist.barrier()
    del engine, seen
    gc.collect()
    sync(empty=True)

    # ---- 31 (references): phase 25's checkpoint as the entry points load it ---
    mesh_tp = mesh_lib.make_mesh(data=1, model=PAR_RANKS)
    host_dtype = "bfloat16" if on_card else None  # as the entry points load it
    params, cfg = load_model(Path(payload["pth"]), "gptq.int4", dtype=host_dtype, device="cpu")
    engine = DecodeEngine(params, cfg, max_batch=PAR_HTTP_SLOTS, max_seq_length=PAR_HTTP_S, steps_per_sync=8,
                          mesh=mesh_tp, device=dev)
    del params
    if lead:
        ids = [engine.submit(p, PAR_HTTP_NEW, eos_id=payload["eos_id"]) for p in payload["http_prompts"]]
        done = engine.run()
        engine.stop()
        out["http_tokens"] = [done[i].generated for i in ids]
    else:
        engine.follow()
    del engine
    params, cfg = load_model(Path(payload["pth"]), None, dtype=host_dtype, device="cpu")
    kind, lora_params, info = load_peft_checkpoint(Path(payload["lora_pth"]), cfg, device="cpu")
    cfg = cfg.replace(lora=LoRAConfig(r=info["r"], alpha=16.0, dropout=0.0))
    sp = tp.shard_params_tp(lora_mod.load_lora_state(params, lora_params), mesh_tp, cfg, device=dev)
    del params, lora_params
    y = tp.generate_tp(sp, payload["lora_prompt"], PAR_LORA_NEW, config=cfg, mesh=mesh_tp, temperature=0.0,
                       top_k=200, eos_id=payload["eos_id"])
    out["lora_tokens"] = y.tolist()
    return out


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree]


def _par_entry(rank: int, world: int, port: int, payload, out: str) -> None:
    """One rank of phases 29-30 (or 32-34: ``payload["job"] == "train"``):
    the environment torchrun would give it, the port's own launch (one card
    for both ranks: gloo), the job, its result."""
    import os

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), **PAR_ENV)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    from lit_llama_tpu_torch.parallel import launch

    torch.set_num_threads(int(PAR_ENV["OMP_NUM_THREADS"]))
    assert launch.maybe_initialize_distributed(payload["device"])
    try:
        result = (_train_par_job if payload.get("job") == "train" else _par_job)(rank, payload)
    finally:
        dist.destroy_process_group()
    torch.save(result, Path(out) / f"rank{rank}.pt")


def _torchrun(module: str, args, log_path: Path, dev):
    """``torchrun --nproc_per_node PAR_RANKS -m module args`` (static
    rendezvous on 127.0.0.1; ``--device cpu`` off the card), output to
    ``log_path``; returns the Popen."""
    import os

    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(PAR_RANKS), "--nnodes", "1",
           "--master_addr", "127.0.0.1", "--master_port", str(_free_port()), "-m", module, *map(str, args)]
    cmd += ["--device", "cpu"] if dev.type == "cpu" else []
    with open(log_path, "w") as f:
        return subprocess.Popen(cmd, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT, env={**os.environ, **PAR_ENV})


def parallel_phases(dev, smi: str, serving_tokens, serving_prompts, pth: Path, tok_path: Path, work: Path,
                    widths=None):
    """Phases 29-31 (see the constants above). ``serving_tokens`` and
    ``serving_prompts``: phase 8's requests and their tokens; ``pth``: phase
    25's 4-layer checkpoint (config.json beside it). Returns the readings and
    the kernel readings for the ``kernels`` line, keyed "K3 TP", ... (none
    off the card). ``widths`` overrides the 7B preset's (a rehearsal on the
    CPU at small widths, where launches are not checked and nothing is
    timed)."""
    import signal
    import urllib.request  # noqa: F401 (the HTTP calls of _post)
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from lit_llama_tpu_torch import LLaMAConfig, LoRAConfig
    from lit_llama_tpu_torch.data import sft
    from lit_llama_tpu_torch.data.tokenizer import Tokenizer
    from lit_llama_tpu_torch.utils.convert import lora_overlay_to_sd
    from lit_llama_tpu_torch.utils.random_params import random_lora_overlay

    t_all = time.perf_counter()
    work.mkdir(parents=True, exist_ok=True)
    tok = Tokenizer(tok_path)
    cfg4 = LLaMAConfig(**{k: v for k, v in json.loads((pth.parent / "config.json").read_text()).items()
                          if k in ("block_size", "vocab_size", "n_layer", "n_head", "n_embd")})
    lora_cfg = cfg4.replace(lora=LoRAConfig(r=8, alpha=16.0, dropout=0.0))
    lora_pth = work / "lora.pth"
    torch.save(lora_overlay_to_sd(random_lora_overlay(lora_cfg, seed=SEED + 31, device="cpu"), lora_cfg), lora_pth)
    rng = np.random.default_rng(SEED + 31)
    texts = _http_prompts(tok, rng, PAR_HTTP_REQUESTS)
    lora_instruction = "Name three colours of the rainbow."
    lora_prompt = tok.encode(sft.generate_prompt({"instruction": lora_instruction, "input": ""}), bos=True, eos=False)
    payload = dict(device=dev.type, widths=widths or {}, prompts=serving_prompts, slots=32, S=256,
                   new=len(serving_tokens[0]), pth=str(pth),
                   lora_pth=str(lora_pth), eos_id=tok.eos_id, lora_prompt=np.asarray(lora_prompt),
                   http_prompts=[np.asarray(tok.encode(t, bos=True, eos=False)) for t in texts])
    # ---- 29-30 in PAR_RANKS spawned ranks (the parent built the kernels: they load)
    t0 = time.perf_counter()
    ctx = mp.spawn(_par_entry, args=(PAR_RANKS, _free_port(), payload, str(work)), nprocs=PAR_RANKS, join=False)
    deadline = time.monotonic() + PAR_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "phases 29-30: the ranks did not finish in time"
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
    spawn_s = time.perf_counter() - t0
    res = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(PAR_RANKS)]
    lead = res[0]
    on_card = dev.type == "cuda"
    for r, o in enumerate(res):
        assert o["device"] == ("cuda:0" if on_card else "cpu") and o["backend"] == "gloo", (r, o["device"])
        for what in ("tp", "tp_int8", "dp"):
            assert o[what]["launches"] == lead[what]["launches"], f"{what}: rank {r}'s launches differ from rank 0's"
    assert lead["dp"]["tokens"] == serving_tokens, "DP: the tokens differ from phase 8's single-process engine's"
    tp, dp = lead["tp"], lead["dp"]
    f32, two = lead["tp_f32"], lead["tp_2_layers"]
    log(f"phase 29, TP at mp = {PAR_RANKS} (ranks as processes on one card over gloo: no scaling figure; {smi}), "
        f"a {TP_PROMPT}-token prefill and {TP_STEPS} teacher-forced decode steps, max |dlogit| / max |logit|: "
        f"{lead['layers']} layers in f32 compute, TP vs the single-card per-op path {f32['vs_single_card']:.3g}, TP kernel vs "
        f"plain path {f32['kernel_vs_plain']:.3g} (limit {TOL_MODEL_F32}); 2 layers in bf16 {two['vs_single_card']:.4f}"
        f" and {two['kernel_vs_plain']:.4f} (TOL_MODEL {TOL_MODEL[1]}); {lead['layers']} layers in bf16 (the main path) "
        f"{tp['vs_single_card']:.4f} ({tp['vs_single_card_prefill']:.4f} on the prefill, where the single card's "
        f"own kernel and plain paths part by {tp['single_card_kernel_vs_plain_prefill']:.4f}), the greedy token the "
        f"same at {tp['argmax_agree']:.0%} of the steps; {tp['launches']['K3']} K3 / {tp['launches']['K4']} K4 / "
        f"{tp['launches']['K5']} K5 launches and {tp['collectives']} collectives a rank; per kernel on the inputs the "
        f"path gave it {tp['kernel_errs']}; {TP_STEPS + 1} forwards in {tp['wall_s']:.2f} s, collectives "
        f"{tp['collective_s'] / tp['wall_s']:.1%} of it (host clock); {lead['tp_local_gib']:.2f} GiB of weights a "
        f"rank")
    times = {**tp.get("kernel_times", {}), **lead["tp_int8"].get("kernel_times", {}), **dp.get("kernel_times", {})}
    for k, r in times.items():
        log(f"  {k}: {r['ms'] * 1e3:.1f} us, plain {r['plain_ms'] * 1e3:.1f} us, library "
            f"{'none' if r['library_ms'] is None else f'{r['library_ms'] * 1e3:.1f} us'}, bound "
            f"{r['bound_ms'] * 1e3:.1f} us ({r['bound_by']})")
    g = lead["generate_tp"]
    log(f"phase 29, generate_tp greedy, {TP_GEN} tokens free-running: {g['tok_s']:.1f} tok/s wall "
        f"({g['wall_s']:.2f} s), collectives {g['collective_share']:.1%} of the wall (two ranks on one card over "
        f"gloo: no scaling figure; {smi}); tokens {g['tokens']}")
    log(f"phase 29b, TP int8 ({TP_INT8_LAYERS} layers at 7B width): K6 {lead['tp_int8']['launches']['K6']} launches "
        f"a rank, kernel vs plain path {lead['tp_int8']['kernel_vs_plain']:.4f}, per kernel "
        f"{lead['tp_int8']['kernel_errs']}")
    n_tok = sum(len(t) for t in dp["tokens"])
    log(f"phase 30, DP at dp = {PAR_RANKS}: phase 8's {len(serving_prompts)} requests through 32 slots (16 a rank): "
        f"tokens equal to phase 8's request for request; {n_tok} tokens in {dp['wall_s']:.2f} s = "
        f"{n_tok / dp['wall_s']:.1f} tok/s wall, TTFT p50 {dp['ttft_ms'][len(dp['ttft_ms']) // 2]:.0f} ms, "
        f"collectives {dp['collective_s'] / dp['wall_s']:.1%} of the wall (two ranks on one card over gloo: no "
        f"scaling figure; {smi}); launches a rank {dp['launches']}; per kernel at 16 slots {dp['kernel_errs']}")

    # ---- 31. the entry points under torchrun ---------------------------------
    t0 = time.perf_counter()
    log_path = work / "generate_lora.log"
    proc = _torchrun("lit_llama_tpu_torch.generate.lora",
                     ["--model_parallel", PAR_RANKS, "--checkpoint_path", pth, "--lora_path", lora_pth,
                      "--tokenizer_path", tok_path, "--prompt", lora_instruction, "--max_new_tokens", PAR_LORA_NEW,
                      "--temperature", 0], log_path, dev)
    rc = proc.wait(timeout=PAR_TIMEOUT_S)
    text = log_path.read_text()
    assert rc == 0, f"generate.lora --model_parallel {PAR_RANKS} exited {rc}:\n{text[-3000:]}"
    ids_lines = [ln for ln in text.splitlines() if "Token ids: " in ln]
    assert len(ids_lines) == 1, f"generate.lora: {len(ids_lines)} 'Token ids' lines (rank 0 alone prints)"
    got_ids = json.loads(ids_lines[0].split("Token ids: ", 1)[1])
    assert got_ids == lead["lora_tokens"], "generate.lora --model_parallel: tokens differ from the ranks' generate_tp"
    lora_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    log_path = work / "serve.log"
    proc = _torchrun("lit_llama_tpu_torch.serve.http",
                     ["--model_parallel", PAR_RANKS, "--checkpoint_path", pth, "--tokenizer_path", tok_path,
                      "--quantize", "gptq.int4", "--port", 0, "--max_batch", PAR_HTTP_SLOTS, "--max_seq_length",
                      PAR_HTTP_S, "--steps_per_sync", 8], log_path, dev)
    try:
        url = None
        while url is None and time.perf_counter() - t0 < PAR_TIMEOUT_S and proc.poll() is None:
            time.sleep(0.5)
            up = [ln for ln in log_path.read_text().splitlines() if ln.startswith("serving on ")]
            url = up[0].split()[-1] if up else None
        assert url, f"serve.http --model_parallel {PAR_RANKS} did not come up:\n{log_path.read_text()[-3000:]}"
        up_s = time.perf_counter() - t0
        assert _post(url + "/health") == {"active": 0, "queued": 0}
        with ThreadPoolExecutor(len(texts)) as pool:
            replies = list(pool.map(lambda t: _post(url + "/generate", {"prompt": t, "max_new_tokens": PAR_HTTP_NEW,
                                                                       "temperature": 0}), texts))
        assert [r["tokens"] for r in replies] == lead["http_tokens"], \
            "serve.http --model_parallel: tokens differ from the ranks' TP engine's"
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
        text = log_path.read_text()
        assert "[serve] rank 0: stopped" in text and "[serve] rank 1: stopped by rank 0" in text, text[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    http_s = time.perf_counter() - t0
    log(f"phase 31: torchrun --nproc_per_node {PAR_RANKS} -m lit_llama_tpu_torch.generate.lora --model_parallel "
        f"{PAR_RANKS} on phase 25's {cfg4.n_layer}-layer checkpoint with a LoRA overlay: exit 0 in {lora_s:.1f} s, "
        f"{PAR_LORA_NEW} greedy tokens equal to the ranks' generate_tp; serve.http --model_parallel {PAR_RANKS} "
        f"(int4 at load on the host) up in {up_s:.1f} s, {len(texts)} requests' tokens equal to the ranks' TP "
        f"engine's, stopped cleanly by SIGTERM on every rank ({http_s:.1f} s); phases 29-31 "
        f"{time.perf_counter() - t_all:.1f} s (the spawn {spawn_s:.1f} s)")

    # the kernels line: one shape a kernel and path (K3 / K6 the decode step's
    # c_fc1 shard under TP, K3 the logits at 16 slots under DP), launches a rank
    pick = {"K3 TP": "M=1 4096->5632", "K6 TP": "M=1 4096->5632", "K3 DP": "M=16 4096->32000"}
    kernels = {}
    for tag, block in (("TP", tp), ("TP", lead["tp_int8"]), ("DP", dp)):
        for r in block.get("kernel_times", {}).values():
            name = f"{r['key']} {tag}"
            if r["shape"] == pick.get(name, r["shape"]) and name not in kernels:
                kernels[name] = dict(r, max_abs_err=block["kernel_errs"][r["key"]],
                                     launches=block["launches"][r["key"]])
    assert sorted(kernels) == (["K3 DP", "K3 TP", "K4 TP", "K5 TP", "K6 TP", "K7 DP", "K8 DP", "K9 DP"] if on_card
                               else []), sorted(kernels)
    readings = dict(tp={k: v for k, v in tp.items() if k != "kernel_times"}, tp_f32=f32, tp_2_layers=two,
                    generate_tp=g,
                    tp_int8={k: v for k, v in lead["tp_int8"].items() if k != "kernel_times"},
                    dp={k: v for k, v in dp.items() if k not in ("kernel_times", "tokens")},
                    kernel_times=times,
                    entry_points=dict(generate_lora_s=lora_s, serve_http_up_s=up_s, serve_http_s=http_s),
                    spawn_s=spawn_s, seconds=time.perf_counter() - t_all)
    return readings, kernels


# ---- phases 32-34: training across ranks. TRAIN_PAR's meshes, each
# with PAR_RANKS ranks as processes on the one card over gloo, as phases 29-31
# run them: they check that a step over the mesh computes the single-process
# step on the global batch and that each rank's kernels take their local
# shapes; they give no scaling figure. The 7B width (n_embd 4096, 32 heads, I
# 11008, V 32000, T 2048), f32 params, a global micro-batch of TRAIN_PAR_B
# rows (one a data rank), one microbatch a step. For each mesh: TRAIN_PAR_F32
# steps at 2 layers in f32 compute against the single-process step on the
# same batches (TOL_PAR_STEP); one step in bf16 at the mesh's depth, whose
# departure from the single card's step is read beside the single card's own
# kernel path against its plain path (bf16 rounding; one AdamW step from zero
# moments moves an element by about lr times its grad's sign, so the reading
# is the share of elements that stepped the other way); a second step timed
# with its collectives counted (tools/comm_anatomy.py); K4 and K10 held to
# their plain versions on the inputs the path gave them, and timed. 32 layers
# need 108 GB of f32 state even in one process: the depth is cut, the width is
# not. Then finetune.lora and pretrain.shakespeare with --data_parallel 2
# under torchrun, each held to the same entry point run in one process
# (TOL_PAR_ENTRY): every logged loss; the trained leaves of the final
# checkpoints, elements stepped apart; and the checkpoints loaded and
# generated from: their logits, teacher-forced on the one-process run's
# greedy tokens, within a limit, and their choices equal to that run's
# model's wherever its top-two gap exceeds twice that limit (two bf16 runs
# may take a near-tie either way: a model trained two steps from random
# weights has many).
TRAIN_PAR = (("32", "DP", 2, 1, False, 4), ("33", "FSDP", 2, 1, True, 8), ("34", "TP-train", 1, 2, False, 8))
TRAIN_PAR_B, TRAIN_PAR_F32, TRAIN_PAR_LR = 2, 3, 1e-3
# f32, mesh step vs single-process step: the loss to `loss` (relative); every
# param within atol_lr * lr + rtol * |p|, but for a share `flips` of a leaf's
# elements (each within flip_lr * lr), whose grad sits within f32 rounding of
# zero, where Adam's step of about lr times the sign may go the other way.
# From the card's readings (PERF.md §6, PR 18): wte 1.8e-5 of its elements
# (every other leaf under 3e-8), at most 0.19 lr. A fault in one vocab row
# (3.1e-5 of wte) steps about half of its elements a whole lr or more apart,
# which flip_lr catches whatever their share
TOL_PAR_STEP = dict(loss=1e-5, rtol=1e-5, atol_lr=1e-2, flips=5e-5, flip_lr=0.5)
# the entry points: finetune.lora on phase 25's checkpoint, pretrain.shakespeare
# at (layers, n_embd, n_head, T, vocabulary) on random tokens
TRAIN_PAR_ENTRY = dict(steps=2, new_tokens=16, shakespeare=(2, 1024, 8, 1024, 100))
# --data_parallel 2 against one process, set from the card's readings
# (PERF.md §6, PR 18), each limit about twice to four times its reading:
# each logged loss (4 places) to loss_rtol + loss_atol (the train losses read
# equal, lora's validation after its two bf16 steps 4.9e-4 apart); a run's
# share of trained elements stepped apart by more than 0.1 lr (read 0.071 %
# lora, 0.137 % shakespeare), none beyond two sign flips of an Adam step (4
# lr; read 1.36, 2.5); the largest logit difference on the one-process run's
# greedy tokens (read 0.0801 lora, beside its checkpoint's own kernel vs
# plain 0.0719; 0.0078 shakespeare)
TOL_PAR_ENTRY = dict(loss_rtol=1e-3, loss_atol=1e-4,
                     lora=dict(apart=3e-3, apart_lr=4.0, logit=0.16),
                     shakespeare=dict(apart=5e-3, apart_lr=4.0, logit=0.016))


def _stepped_apart(got, want, lr: float):
    """(share of elements that stepped apart by more than 0.1 lr, max |d| /
    lr, elements) over the leaves of two stepped flat trees, compared where
    ``got``'s leaves lie."""
    apart, top, n = 0, 0.0, 0
    for name, g in got.items():
        d = (g.float() - want[name].to(g.device).float()).abs()
        apart += int((d > 0.1 * lr).sum())
        top = max(top, float(d.max()) / lr)
        n += d.numel()
        del d
    return apart / n, top, n


def _entry_held(ref, cfg_ref, got, cfg_got, prompt, n: int, dev, what: str, limit: float) -> dict:
    """The one-process run's model (``ref``) against the multi-rank run's
    (``got``): both models' free-running greedy tokens (read); teacher-forced
    on ``ref``'s, the largest logit difference (within ``limit``, read beside
    ``ref``'s own kernel path against its plain path) and each model's choice
    at every new position (equal wherever ``ref``'s top-two logit gap exceeds
    2 * ``limit``). The readings, with what broke those two under "faults"."""
    import torch

    from lit_llama_tpu_torch.models import generate as gen
    from lit_llama_tpu_torch.models import llama

    seq = gen.generate(ref, prompt, n, config=cfg_ref, temperature=0.0, device=dev)
    other = gen.generate(got, prompt, n, config=cfg_got, temperature=0.0, device=dev)
    ids = seq[None, :-1].to(dev)
    with torch.no_grad():
        a = llama.forward(ref, ids, cfg_ref)[0][0, len(prompt) - 1 :].float()
        b = llama.forward(got, ids, cfg_got)[0][0, len(prompt) - 1 :].float()
        c = llama.forward(ref, ids, cfg_ref, plain=True)[0][0, len(prompt) - 1 :].float()
    top2 = a.topk(2, dim=-1).values
    gap, diff = top2[:, 0] - top2[:, 1], (a - b).abs().amax(-1)
    same = a.argmax(-1) == b.argmax(-1)
    out = dict(tokens=seq[len(prompt):].tolist(), free_running_equal=other.tolist() == seq.tolist(),
               teacher_forced_equal=int(same.sum()), ties=int((~same).sum()), max_logit_diff=float(diff.max()),
               kernel_vs_plain_logit_diff=float((a - c).abs().max()), max_gap_apart=float(gap[~same].max())
               if bool((~same).any()) else None)
    out["faults"] = ([f"{what}: logits {out['max_logit_diff']:.3g} from the one-process run's (limit {limit})"]
                     if out["max_logit_diff"] > limit else [])
    if not bool((same | (gap <= 2 * limit)).all()):
        out["faults"].append(f"{what}: other tokens at decided positions (gaps {gap[~same].tolist()})")
    return out


def _k10_recorded(seen, time_us, peaks, timed: bool):
    """Each recorded call of the flash backward (q, k, v, o, lse, do): K10
    held row by row to its plain version (TOL_K10, as phase 13), and on
    ``timed`` its two kernels timed beside the plain version and SDPA's
    causal backward, with their bounds: {"errs": (dq, dk, dv), "times": {...}}."""
    import torch
    import torch.nn.functional as F

    from lit_llama_tpu_torch.ops import flash_attention as fa

    out = {"errs": [0.0, 0.0, 0.0], "times": {}}
    for sig, (q, k, v, o, lse, do) in seen.items():
        B, H, T, hs = q.shape
        got = fa.flash_attention_backward(q, k, v, o, lse, do)
        want = fa.flash_attention_bwd_ref(q, k, v, o, lse, do)
        for i, (name, gk, w) in enumerate(zip(("dq", "dk", "dv"), got, want)):
            gk, w = gk.float(), w.float()
            assert torch.isfinite(gk).all(), f"K10 {name} at {(B, H, T, hs)}: non-finite"
            err, mag = (gk - w).abs(), w.abs()
            rowmax = mag.amax(-1, keepdim=True).clamp_min(TOL_K10["floor"] * float(mag.max()))
            need = float(((err - TOL_K10["rel"] * mag).clamp_min(0) / rowmax).max())
            assert need <= TOL_K10["row"], f"K10 {name} at {(B, H, T, hs)}: row part {need:.3g} needed"
            out["errs"][i] = max(out["errs"][i], float(err.max()))
        del got, want
        if not timed:
            continue
        bw, tc_peak, _ = peaks

        def bound(nbytes, ops):
            return max(nbytes / bw, ops / tc_peak) * 1e3, ("bytes" if nbytes / bw >= ops / tc_peak else "operations")

        nrow, pairs = B * H * T, B * H * T * (T + 1) // 2
        dq, dd = fa.flash_backward_dq(q, k, v, o, lse, do)
        qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        lib = time_us(lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), do, retain_graph=True)) / 1e3
        plain = time_us(lambda: fa.flash_attention_bwd_ref(q, k, v, o, lse, do), 3) / 1e3
        shape = f"B={B} H={H} T={T} hs={hs}"
        for key, fn, b in (("K10dq", lambda: fa.flash_backward_dq(q, k, v, o, lse, do),
                            bound(5 * nrow * hs * 2 + nrow * 4 + nrow * hs * 2 + nrow * 4, 3 * 2 * hs * pairs)),
                           ("K10dkv", lambda: fa.flash_backward_dkv(q, k, v, do, lse, dd),
                            bound(4 * nrow * hs * 2 + 2 * nrow * 4 + 2 * nrow * hs * 2, 4 * 2 * hs * pairs))):
            out["times"][key] = dict(key=key, shape=shape, ms=time_us(fn) / 1e3, plain_ms=plain, library_ms=lib,
                                     bound_ms=b[0], bound_by=b[1])
        del dq, dd, qs, ks, vs, sdpa_out
    return out


def _train_par_job(rank: int, payload) -> dict:
    """Phases 32-34 on one rank."""
    import gc
    import math

    import torch
    import torch.distributed as dist

    from lit_llama_tpu_torch import LLaMAConfig
    from lit_llama_tpu_torch.models import llama
    from lit_llama_tpu_torch.ops import flash_attention as fa
    from lit_llama_tpu_torch.parallel import comm, launch, mesh as mesh_lib, sharding
    from lit_llama_tpu_torch.tools import comm_anatomy, devtime
    from lit_llama_tpu_torch.training import step as step_lib
    from lit_llama_tpu_torch.utils.checkpoint import tree_leaves
    from lit_llama_tpu_torch.utils.device import device_peaks

    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 products in full f32, as the parent's
    torch.backends.cudnn.allow_tf32 = False
    dev = launch.current_device()
    on_card = dev.type == "cuda"
    assert dist.get_backend() == "gloo" and (dev == torch.device("cuda", 0) or not on_card), (dev, dist.get_backend())
    lead = rank == 0
    counters = {"K4": fa.flash_attention, "K10dq": fa.flash_backward_dq, "K10dkv": fa.flash_backward_dkv}

    def sync(empty=False):
        if empty:
            gc.collect()
        if on_card:
            torch.cuda.synchronize()
            if empty:
                torch.cuda.empty_cache()

    def launches():
        sync()
        return {k: fn.launches for k, fn in counters.items()}

    time_us = devtime.make_timer(dev) if on_card else None
    peaks = device_peaks(torch.cuda.get_device_name(0)) if on_card else None
    base = LLaMAConfig.from_name("7B", param_dtype="float32", compute_dtype="bfloat16", **payload.get("widths", {}))
    T, B = base.block_size, TRAIN_PAR_B

    def tc(warmup):
        return step_lib.TrainConfig(learning_rate=TRAIN_PAR_LR, min_lr=TRAIN_PAR_LR / 10, warmup_iters=warmup,
                                    max_iters=10)

    def tokens(steps, seed):
        g = torch.Generator().manual_seed(seed)
        return torch.randint(0, base.vocab_size, (steps, 1, B, T + 1), generator=g).to(dev)

    def params_of(cfg):
        return llama.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)

    def single(cfg, toks, tcfg, plain=False):
        """The single-process steps on the global batches: (losses, the
        stepped params, flat, on the card)."""
        opt = step_lib.make_optimizer(tcfg)
        state = step_lib.init_train_state(params_of(cfg), opt)
        losses = []
        for t in toks:
            state, loss = step_lib.train_step(state, t[..., :-1], t[..., 1:], cfg, opt, True, "dots", plain)
            losses.append(float(loss))
        params = tree_leaves(state.params)
        del state, opt
        sync(empty=True)
        return losses, params

    # both ranks load the kernels and start the card's libraries at once,
    # before the phases have one wait on the other
    t0 = time.perf_counter()
    warm = base.replace(n_layer=1, n_embd=2 * base.head_size, n_head=2, vocab_size=256)
    toks = torch.randint(0, 256, (1, 1, T + 1), generator=torch.Generator().manual_seed(SEED)).to(dev)
    opt = step_lib.make_optimizer(tc(0))
    state = step_lib.init_train_state(params_of(warm), opt)
    step_lib.train_step(state, toks[..., :-1], toks[..., 1:], warm, opt)
    comm.all_reduce(torch.ones(1 << 20, device=dev))
    del state, toks, opt
    sync(empty=True)
    dist.barrier()
    out = {"device": str(dev), "backend": dist.get_backend(), "warm_up_s": time.perf_counter() - t0}
    for tag, name, dp, mp, fsdp, depth in TRAIN_PAR:
        t_phase = time.perf_counter()
        mesh = mesh_lib.make_mesh(data=dp, model=mp)
        res = dict(mesh=[dp, mp], fsdp=fsdp, layers=depth, seconds_by_part={})
        # (a) 2 layers in f32 compute: TRAIN_PAR_F32 steps against the single process
        t0 = time.perf_counter()
        c2 = base.replace(n_layer=min(2, depth), compute_dtype="float32")
        toks = tokens(TRAIN_PAR_F32, SEED + int(tag))
        if lead:
            one_losses, one = single(c2, toks, tc(1))
        dist.barrier()
        res["seconds_by_part"]["f32 single"] = time.perf_counter() - t0
        opt = step_lib.make_optimizer(tc(1))
        local, layout = sharding.shard_params(params_of(c2), mesh, c2, fsdp=fsdp)
        state = step_lib.init_train_state(local, opt)
        del local
        losses, f32_walls = [], []
        for t in toks:
            t1 = time.perf_counter()
            state, loss = step_lib.train_step(state, t[..., :-1], t[..., 1:], c2, opt, layout=layout)
            losses.append(float(loss))
            f32_walls.append(time.perf_counter() - t1)
        res["f32_step_s"] = f32_walls
        t1 = time.perf_counter()
        whole = layout.gather(state.params, lead)
        res["seconds_by_part"]["f32 gather"] = time.perf_counter() - t1
        del state, opt
        sync(empty=True)
        if lead:
            for a, b in zip(losses, one_losses):
                assert abs(a - b) <= TOL_PAR_STEP["loss"] * abs(b), f"phase {tag}, f32: losses {losses} vs {one_losses}"
            worst = {}
            for n, g in tree_leaves(whole).items():
                w = one[n]
                d = (g.to(dev) - w).abs()
                off = d > TOL_PAR_STEP["atol_lr"] * TRAIN_PAR_LR + TOL_PAR_STEP["rtol"] * w.abs()
                worst[n] = (float(off.float().mean()), float(d.max()) / TRAIN_PAR_LR, int(off.sum()), d.numel())
            beyond = {n: v for n, v in worst.items() if v[2]}
            res["f32"] = dict(losses=losses, single_losses=one_losses,
                              max_loss_rel=max(abs(a - b) / abs(b) for a, b in zip(losses, one_losses)),
                              max_lr=max(v[1] for v in worst.values()), leaves_beyond=len(beyond),
                              max_share=max((v[0] for v in beyond.values()), default=0.0), beyond=beyond)
            assert all(v[0] <= TOL_PAR_STEP["flips"] and v[1] <= TOL_PAR_STEP["flip_lr"] for v in worst.values()), \
                f"phase {tag}, f32: leaves off the single process (share, max lr, elements off, elements): {beyond}"
            del one
        del whole
        sync(empty=True)
        res["seconds_by_part"]["f32"] = time.perf_counter() - t0
        # (b) bf16 at the phase's depth: one step against the single card's,
        # whose own kernel and plain paths are read beside
        t0 = time.perf_counter()
        cd = base.replace(n_layer=depth)
        toks = tokens(1, SEED + 100 + int(tag))
        if lead:
            (k_loss,), one = single(cd, toks, tc(0))
            (p_loss,), plain = single(cd, toks, tc(0), plain=True)
            single_apart = _stepped_apart(plain, one, TRAIN_PAR_LR)
            del plain
            sync(empty=True)
        dist.barrier()
        res["seconds_by_part"]["single"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        opt = step_lib.make_optimizer(tc(0))
        local, layout = sharding.shard_params(params_of(cd), mesh, cd, fsdp=fsdp)
        box = {"state": step_lib.init_train_state(local, opt)}
        del local
        sync(empty=True)
        if on_card:  # the step's peak: the whole params each rank drew before sharding are gone
            torch.cuda.reset_peak_memory_stats()
        state_bytes = sum(t.numel() * t.element_size() for k in ("mu", "nu") for t in
                          tree_leaves(box["state"].opt_state[k]).values())
        state_bytes += sum(t.numel() * t.element_size() for t in tree_leaves(box["state"].params).values())
        seen10 = {}
        orig10 = fa.flash_attention_backward

        def recording10(*args):
            sig = tuple(tuple(a.shape) for a in args)
            if sig not in seen10:
                seen10[sig] = tuple(a.clone() for a in args)
            return orig10(*args)

        def step():
            t = toks[0]
            box["state"], loss = step_lib.train_step(box["state"], t[..., :-1], t[..., 1:], cd, opt, layout=layout)
            box["loss"] = float(loss)

        # the main path: one step, its launches counted, its wall and its
        # collectives read, K4's and K10's inputs recorded
        sync()
        for fn in counters.values():
            fn.launches = 0
        fa.flash_attention_backward = recording10
        try:
            seen4 = _recording(("K4",), lambda: box.update(census=comm_anatomy.census(step, sync)))
        finally:
            fa.flash_attention_backward = orig10
        got = launches()
        L = cd.n_layer
        want = {"K4": 2 * L, "K10dq": L, "K10dkv": L} if on_card else dict.fromkeys(counters, 0)
        assert got == want, f"rank {rank}, phase {tag}: launches {got}, expected {want}"
        assert math.isfinite(box["loss"]), box["loss"]
        res.update(launches=got, loss=box["loss"], census=box["census"], state_gib=state_bytes / 2**30,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30 if on_card else None,
                   local_shapes=sorted({str(k[1]) for k in seen4}))
        # rank 0's peak also holds the single card's stepped params, kept for the comparison below
        res["reference_gib"] = sum(t.numel() * t.element_size() for t in one.values()) / 2**30 if lead else 0.0
        if lead:  # rank 0's shards against the same shards of the single card's step
            mine = tree_leaves(layout.shard(one))
            del one
            apart = _stepped_apart(tree_leaves(box["state"].params), mine, TRAIN_PAR_LR)
            del mine
            res.update(single_loss=k_loss, single_plain_loss=p_loss, loss_rel=abs(box["loss"] - k_loss) / abs(k_loss),
                       single_loss_rel=abs(p_loss - k_loss) / abs(k_loss), apart=apart[:2], elements=apart[2],
                       single_apart=single_apart[:2], single_elements=single_apart[2])
        box.clear()
        del opt, layout
        sync(empty=True)
        res["seconds_by_part"]["mesh"] = time.perf_counter() - t0
        # K4 and K10 against their plain versions on the path's inputs (every
        # rank its own); one rank times while the other waits
        t0 = time.perf_counter()
        res["kernel_errs"] = _hold_recorded(seen4) if on_card else {}
        k10 = _k10_recorded(seen10, time_us, peaks, False) if on_card else {"errs": [0.0] * 3}
        res["kernel_errs"].update(K10dq=k10["errs"][0], K10dkv=max(k10["errs"][1:]))
        dist.barrier()
        if lead and on_card:
            res["kernel_times"] = {**_time_recorded(seen4, time_us, peaks),
                                   **_k10_recorded(seen10, time_us, peaks, True)["times"]}
        dist.barrier()
        del seen4, seen10
        sync(empty=True)
        res["seconds_by_part"]["kernels"] = time.perf_counter() - t0
        res["seconds"] = time.perf_counter() - t_phase
        out[name] = res
    return out


def train_parallel_phases(dev, smi: str, pth: Path, tok_path: Path, work: Path, widths=None, entry_cfg=None):
    """Phases 32-34 (see the constants above). ``pth``: phase 25's 4-layer
    checkpoint (config.json beside it), which finetune.lora trains;
    ``tok_path``: a tokenizer for its SFT samples. Returns the readings and
    the kernel readings for the ``kernels`` line, keyed "K4 DP", ... (none off
    the card). ``widths`` overrides the 7B preset's and ``entry_cfg``
    pretrain.shakespeare's (layers, n_embd, n_head, T, vocabulary) (a
    rehearsal on the CPU at small widths, where launches are not checked and
    nothing is timed)."""
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from lit_llama_tpu_torch.data import sft
    from lit_llama_tpu_torch.data.tokenizer import Tokenizer
    from lit_llama_tpu_torch.finetune import lora as lora_entry
    from lit_llama_tpu_torch.models import generate as gen
    from lit_llama_tpu_torch.models.config import LoRAConfig
    from lit_llama_tpu_torch.peft import lora as lora_mod
    from lit_llama_tpu_torch.pretrain import shakespeare
    from lit_llama_tpu_torch.training.finetune import CHECKPOINT_NAMES
    from lit_llama_tpu_torch.utils.checkpoint import load_checkpoint, tree_leaves
    from lit_llama_tpu_torch.utils.loader import load_model, load_peft_checkpoint

    t_all = time.perf_counter()
    on_card = dev.type == "cuda"
    work.mkdir(parents=True, exist_ok=True)
    payload = dict(job="train", device=dev.type, widths=widths or {})
    t0 = time.perf_counter()
    ctx = mp.spawn(_par_entry, args=(PAR_RANKS, _free_port(), payload, str(work)), nprocs=PAR_RANKS, join=False)
    deadline = time.monotonic() + PAR_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "phases 32-34: the ranks did not finish in time"
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
    spawn_s = time.perf_counter() - t0
    res = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(PAR_RANKS)]
    lead = res[0]
    for r, o in enumerate(res):
        assert o["device"] == ("cuda:0" if on_card else "cpu") and o["backend"] == "gloo", (r, o["device"])
        for _, name, *_ in TRAIN_PAR:
            assert o[name]["launches"] == lead[name]["launches"], f"{name}: rank {r}'s launches differ from rank 0's"
            assert o[name]["loss"] == lead[name]["loss"], f"{name}: rank {r}'s loss differs from rank 0's"
    kernels = {}

    def fmt(gib):
        return "not measured" if gib is None else f"{gib:.2f}"

    for tag, name, dp, mp_, fsdp, depth in TRAIN_PAR:
        p = lead[name]
        f32, c = p["f32"], p["census"]
        kinds = ", ".join(f"{k['kind']} {k['calls']} ({k['bytes'] / 2**20:.0f} MiB)" for k in c["rows"])
        log(f"phase {tag}, {name} training at (data, model) = ({dp}, {mp_}) (two ranks as processes on one card over "
            f"gloo: no scaling figure; {smi}): f32 at 2 layers, {TRAIN_PAR_F32} steps against the single process, "
            f"losses {f32['losses']} (max rel diff {f32['max_loss_rel']:.3g}), params within "
            f"{TOL_PAR_STEP['atol_lr']} lr + {TOL_PAR_STEP['rtol']} |p| but in {f32['leaves_beyond']} leaves (a "
            f"share of at most {f32['max_share']:.3g} of each, limit {TOL_PAR_STEP['flips']}: "
            + ", ".join(f"{n} {v[2]} of {v[3]}" for n, v in f32["beyond"].items())
            + f"), max {f32['max_lr']:.3g} lr (limit {TOL_PAR_STEP['flip_lr']}); bf16 at {depth} layers, one step: loss {p['loss']:.5f} vs the single card's "
            f"{p['single_loss']:.5f} (rel {p['loss_rel']:.3g}; the single card's plain path {p['single_plain_loss']:.5f}, "
            f"rel {p['single_loss_rel']:.3g}), elements stepped apart by > 0.1 lr: {p['apart'][0]:.4%} (max "
            f"{p['apart'][1]:.3g} lr; rank 0's {p['elements']} elements) against the single card's kernel vs plain "
            f"{p['single_apart'][0]:.4%} (max {p['single_apart'][1]:.3g} lr); a rank: params + moments "
            f"{p['state_gib']:.2f} GiB, peak (max_memory_allocated) rank 1 {fmt(res[1][name]['peak_gib'])} GiB, "
            f"rank 0 {fmt(p['peak_gib'])} GiB with the single card's {p['reference_gib']:.2f} GiB of stepped "
            f"params beside; the step {c['wall_s'] * 1e3:.1f} ms wall, collectives {c['share']:.1%} of it (host clock; "
            f"{c['calls']} calls: {kinds}); launches a rank {p['launches']} at {p['local_shapes']}; per kernel on "
            f"the path's inputs {p['kernel_errs']}; {p['seconds']:.1f} s ("
            + ", ".join(f"{k} {v:.1f}" for k, v in p["seconds_by_part"].items()) + ")")
        for r in p.get("kernel_times", {}).values():
            log(f"  {r['key']} {r['shape']}: {r['ms'] * 1e3:.1f} us, plain {r['plain_ms'] * 1e3:.1f} us, library "
                f"{r['library_ms'] * 1e3:.1f} us, bound {r['bound_ms'] * 1e3:.1f} us ({r['bound_by']})")
        if name in ("DP", "TP-train") and on_card:
            for r in p["kernel_times"].values():
                kernels[f"{r['key']} {name}"] = dict(r, max_abs_err=p["kernel_errs"][r["key"]],
                                                      launches=p["launches"][r["key"]])
    # one process's f32 params + moments at 8 layers, against FSDP's and TP's a rank
    one_gib = 3 * 4 * sum(t.numel() for t in tree_leaves(_meta_params(widths, 8)).values()) / 2**30
    for name in ("FSDP", "TP-train"):
        share = lead[name]["state_gib"] / one_gib
        assert 0.45 <= share <= 0.6, f"{name}: a rank holds {share:.2f} of one process's params + moments"

    # ---- the entry points under torchrun, both at once, while the one-process
    # runs they are held to go in this process
    tok = Tokenizer(tok_path)
    data = work / "sft"
    data.mkdir(exist_ok=True)
    sft.save_samples(sft_samples(tok, 32, SEED + 32), data / "train.pt")
    sft.save_samples(sft_samples(tok, 8, SEED + 33), data / "test.pt")
    steps = TRAIN_PAR_ENTRY["steps"]
    flags = dict(data_dir=data, checkpoint_path=pth, tokenizer_path=tok_path, max_iters=steps, batch_size=4,
                 micro_batch_size=2, warmup_iters=1, eval_interval=steps, eval_iters=1, save_interval=100,
                 log_interval=1, max_seq_length=256)
    layers, width, heads, T_sh, vocab = entry_cfg or TRAIN_PAR_ENTRY["shakespeare"]
    sh = work / "shakespeare_data"
    sh.mkdir(exist_ok=True)
    rng = np.random.default_rng(SEED + 34)
    for split, n in (("train", 64 * T_sh), ("val", 8 * T_sh)):
        rng.integers(0, vocab, size=n).astype(np.uint16).tofile(sh / f"{split}.bin")
    sflags = dict(data_dir=sh, n_layer=layers, n_embd=width, n_head=heads, block_size=T_sh, vocab_size=vocab,
                  batch_size=2, micro_batch_size=2, max_iters=steps, eval_interval=steps, eval_iters=1,
                  learning_rate=SHAKESPEARE_LR)
    t0 = time.perf_counter()
    procs = {run: _torchrun(module, [a for k, v in f.items() for a in (f"--{k}", v)]
                            + ["--out_dir", work / run, "--data_parallel", PAR_RANKS], work / f"{run}.log", dev)
             for run, module, f in (("lora_two", "lit_llama_tpu_torch.finetune.lora", flags),
                                    ("sh_two", "lit_llama_tpu_torch.pretrain.shakespeare", sflags))}
    try:
        t1 = time.perf_counter()
        lora_entry.main(out_dir=work / "lora_one", device=None if on_card else "cpu", **flags)
        lora_one_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        shakespeare.main(out_dir=work / "sh_one", device=None if on_card else "cpu", **sflags)
        sh_one_s = time.perf_counter() - t1
        for run, proc in procs.items():
            rc = proc.wait(timeout=PAR_TIMEOUT_S)
            assert rc == 0, f"{run} (--data_parallel {PAR_RANKS}) exited {rc}:\n{(work / f'{run}.log').read_text()[-3000:]}"
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    entry_s = time.perf_counter() - t0
    recs = {run: [json.loads(x) for x in (work / run / "metrics.jsonl").read_text().splitlines()]
            for run in ("lora_one", "lora_two", "sh_one", "sh_two")}
    faults = []  # checked after the readings are logged
    for one, two in (("lora_one", "lora_two"), ("sh_one", "sh_two")):
        assert [(r["iter"], sorted(r)) for r in recs[two]] == [(r["iter"], sorted(r)) for r in recs[one]], recs
        faults += [f"{two}: {k} {a[k]} at iter {a['iter']}, one process {b[k]}" for a, b in zip(recs[two], recs[one])
                   for k in ("loss", "val_loss") if k in b
                   and abs(a[k] - b[k]) > TOL_PAR_ENTRY["loss_atol"] + TOL_PAR_ENTRY["loss_rtol"] * abs(b[k])]
    base, cfg = load_model(pth, device=dev)
    enc = tok.encode(sft.generate_prompt({"instruction": "Name three colours of the rainbow.", "input": ""}),
                     bos=True, eos=False)
    models, trained = {}, {}
    for run in ("lora_one", "lora_two"):
        kind, lp, info = load_peft_checkpoint(work / run / CHECKPOINT_NAMES["lora"], cfg, device=dev)
        trained[run] = tree_leaves(lp)
        models[run] = (lora_mod.load_lora_state(base, lp),
                       cfg.replace(lora=LoRAConfig(r=info["r"], alpha=16.0, dropout=0.0)))
    lora_lr = inspect.signature(lora_entry.main).parameters["learning_rate"].default
    apart = {"lora": _stepped_apart(trained["lora_two"], trained["lora_one"], lora_lr)}
    held = {"lora": _entry_held(*models["lora_one"], *models["lora_two"], enc, TRAIN_PAR_ENTRY["new_tokens"], dev,
                                "finetune.lora --data_parallel", TOL_PAR_ENTRY["lora"]["logit"])}
    del base, models, trained
    models = {}
    for run in ("sh_one", "sh_two"):
        final = work / run / "final"
        assert int(load_checkpoint(final)["step"]) == steps, run
        models[run] = load_model(final, device=dev)
    apart["shakespeare"] = _stepped_apart(tree_leaves(models["sh_two"][0]), tree_leaves(models["sh_one"][0]),
                                          SHAKESPEARE_LR)
    held["shakespeare"] = _entry_held(*models["sh_one"], *models["sh_two"], [1, 2, 3, 4],
                                      TRAIN_PAR_ENTRY["new_tokens"], dev, "pretrain.shakespeare --data_parallel",
                                      TOL_PAR_ENTRY["shakespeare"]["logit"])
    del models
    entry = dict(seconds=entry_s, lora_one_s=lora_one_s, shakespeare_one_s=sh_one_s,
                 losses={k: [r.get("loss", r.get("val_loss")) for r in v] for k, v in recs.items()}, greedy=held,
                 apart={k: dict(share=v[0], max_lr=v[1], elements=v[2]) for k, v in apart.items()})
    log(f"phases 32-34, entry points: finetune.lora on phase 25's checkpoint and pretrain.shakespeare ({layers} "
        f"layers at width {width}, T {T_sh}), {steps} steps each, both under torchrun --data_parallel {PAR_RANKS} "
        f"at once beside the one-process runs (finetune.lora {lora_one_s:.1f} s, shakespeare {sh_one_s:.1f} s): "
        f"{entry_s:.1f} s; losses (the last validation) {entry['losses']}; " + "; ".join(
            f"{k}: trained elements stepped apart by > 0.1 lr {a['share']:.4%} (max {a['max_lr']:.3g} lr, "
            f"{a['elements']} elements), logits teacher-forced on the one-process run's greedy tokens max "
            f"{h['max_logit_diff']:.3g} apart (limit {TOL_PAR_ENTRY[k]['logit']}; that checkpoint's kernel vs plain "
            f"path {h['kernel_vs_plain_logit_diff']:.3g}), the same choice at {h['teacher_forced_equal']} of "
            f"{h['teacher_forced_equal'] + h['ties']} positions (the others' top-two gaps at most "
            f"{h['max_gap_apart']}), free-running greedy tokens "
            f"{'equal to' if h['free_running_equal'] else 'apart from'} the one-process run's"
            for (k, h), a in zip(held.items(), entry["apart"].values()))
        + f"; phases 32-34 {time.perf_counter() - t_all:.1f} s (the spawn {spawn_s:.1f} s)")
    faults += [f"{k}: trained elements apart {a}" for k, a in entry["apart"].items()
               if a["share"] > TOL_PAR_ENTRY[k]["apart"] or a["max_lr"] > TOL_PAR_ENTRY[k]["apart_lr"]]
    faults += [f for h in held.values() for f in h["faults"]]
    assert not faults, "phases 32-34, entry points under --data_parallel: " + "; ".join(faults)
    readings = {name: {**{k: v for k, v in lead[name].items() if k != "kernel_times"},
                       "peak_gib_by_rank": [o[name]["peak_gib"] for o in res]} for _, name, *_ in TRAIN_PAR}
    readings.update(entry_points=entry, spawn_s=spawn_s, seconds=time.perf_counter() - t_all,
                    kernel_times={name: lead[name].get("kernel_times", {}) for _, name, *_ in TRAIN_PAR})
    assert sorted(kernels) == (["K10dkv DP", "K10dkv TP-train", "K10dq DP", "K10dq TP-train", "K4 DP", "K4 TP-train"]
                               if on_card else []), sorted(kernels)
    return readings, kernels


def _meta_params(widths, n_layer: int):
    """The 7B-width (or ``widths``) training tree at ``n_layer`` layers, on
    the meta device: its shapes."""
    from lit_llama_tpu_torch import LLaMAConfig
    from lit_llama_tpu_torch.models import llama

    cfg = LLaMAConfig.from_name("7B", param_dtype="float32", **{**(widths or {}), "n_layer": n_layer})
    return llama.init_params(cfg, device="meta")


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
    from lit_llama_tpu_torch.ops.linear import dequantize_int4, dequantize_int8, quantize_int4
    from lit_llama_tpu_torch.ops.rope import build_rope_cache, rope_half_row, slot_rope_rows
    from lit_llama_tpu_torch.serve import DecodeEngine
    from lit_llama_tpu_torch.tools import devtime, probe_kernels
    from lit_llama_tpu_torch.utils.device import device_peaks
    from lit_llama_tpu_torch.utils.random_params import random_int4_params, random_int8_params, random_lora_overlay

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()

    # ---- 1. set-up ---------------------------------------------------------
    smi = devtime.card_name_and_power_limit()
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

    time_us = devtime.make_timer(dev)

    def time_ms(fn, iters=20):
        """Median device time of fn over iters runs, L2 flushed before each
        (tools/devtime.py)."""
        return time_us(fn, iters) / 1e3

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

    def max_err32(got, want, what):
        """f32 kernel output against its plain version, TOL_F32."""
        got, want = got.float(), want.float()
        assert torch.isfinite(got).all(), f"{what}: non-finite kernel output"
        err = (got - want).abs()
        bad = err > TOL_F32[0] + TOL_F32[1] * want.abs()
        assert not bad.any(), f"{what}: {int(bad.sum())} values beyond the f32 tolerance, max err {err.max():.3g}"
        return float(err.max())

    def side_by_side(params, config, prompt, n_new, S, fused):
        """Greedy decoding on the kernel path and the plain path with the same
        tokens fed to both (the plain path's choice), so the logits stay
        comparable after a flip. Returns (max |dlogit| / max |logit| over the
        prefill and every step, kernel-path launches by counter, the steps
        where the two argmaxes differ with the plain top-2 gap there). The
        fused path decodes through K1/K2 (their plain versions), the per-op
        path through forward(input_pos)."""
        cd = getattr(torch, config.compute_dtype)
        rope_c = build_rope_cache(config.block_size, config.head_size, device=dev)
        caches = {plain: llama.init_kv_cache(config, 1, S, cd, device=dev) for plain in (False, True)}
        for fn in counters.values():
            fn.launches = 0
        lg = {plain: llama.forward(params, prompt[None], config, rope_cache=rope_c, kv_cache=caches[plain],
                                   prefill_from_zero=True, plain=plain)[0][0, -1:].float() for plain in (False, True)}
        worst, flips = 0.0, []
        T = prompt.shape[0]
        for i in range(n_new):
            assert torch.isfinite(lg[False]).all(), f"step {i}: non-finite logits"
            worst = max(worst, float((lg[False] - lg[True]).abs().max() / lg[True].abs().max()))
            top2 = lg[True][0].topk(2)
            if int(lg[False].argmax()) != int(top2.indices[0]):
                flips.append((i, float(top2.values[0] - top2.values[1])))
            if i == n_new - 1:
                break
            tok, pos = lg[True].argmax(-1), T + i
            for plain in (False, True):
                if fused:
                    layer = fused_layer.decode_layers_fused_ref if plain else fused_layer.decode_layers_fused
                    head = fused_layer.lm_head_fused_ref if plain else fused_layer.lm_head_fused
                    cos, sin = rope_half_row(rope_c, min(pos, config.block_size - 1), config.head_size)
                    x = params["wte"][tok].to(cd)
                    for lp, kv in zip(params["h"], caches[plain]):
                        x, _ = layer(x, [lp], [kv], cos, sin, pos % S, pos, config)
                    lg[plain] = head(x, params["ln_f"], params["lm_head"], config).float()
                else:
                    lg[plain] = llama.forward(params, tok[None], config, rope_cache=rope_c, input_pos=[pos],
                                              kv_cache=caches[plain], plain=plain)[0][0].float()
        got = {k: fn.launches for k, fn in counters.items()}
        del caches
        return worst, got, flips

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
    phase8 = {}  # phase 8's prompts and tokens, for phase 30
    entry_inputs = {}  # readings of the paths that take every input the Pallas entries take
    k3_shapes = {}

    def rows_equal(fn, x, w_args, what):
        """A row's output is the same bits at M = 200 and at M = 8 (the K split
        comes from N and K alone), and a rerun repeats every bit."""
        full_out = fn(x, *w_args)
        assert torch.equal(full_out, fn(x, *w_args)), f"{what}: a rerun at M = {x.shape[0]} differs"
        assert torch.equal(full_out[:8], fn(x[:8].contiguous(), *w_args)), f"{what}: rows at M = 8 differ from M = 200"
        entry_inputs.setdefault("rows_equal_across_m", []).append(what)

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

        # ---- 2. K3 vs plain, at M = 8, 128 and 200 (the Hopper mainloop of
        # gemm_sm90.cuh), each shape timed beside torch.matmul on the dequantized
        # bf16 weight; a row's output the same bits at M = 8 and M = 200 and on a rerun
        linears = [("c_attn", lp0["attn"]["c_attn"], D), ("attn.c_proj", lp0["attn"]["c_proj"], D),
                   ("c_fc12", lp0["mlp"]["c_fc12"], D), ("mlp.c_proj", lp0["mlp"]["c_proj"], I),
                   ("lm_head", params["lm_head"], D)]
        errs = []
        for lname, w, K in linears:
            N = w["qw"].shape[1]
            wd = dequantize_int4(w, torch.bfloat16)
            for M in (8, 128, 200):
                x = randn(M, K)
                args = (x, w["qw"], w["qscale"], w["qzero"])
                errs.append(max_err(quant_matmul.matmul_int4(*args), quant_matmul.matmul_int4_ref(*args), "K3"))
                ms = time_ms(lambda: quant_matmul.matmul_int4(*args))
                lib = time_ms(lambda: torch.matmul(x, wd))
                b3 = bound_ms(M * K * 2 + q4_bytes(K, N) + M * N * 2, 2 * M * K * N, tc_peak)
                k3_shapes[f"{lname} {K}->{N} M={M}"] = dict(ms=ms, bound_ms=b3[0], bound_by=b3[1], library_ms=lib)
                log(f"K3 M={M} {lname} {K}->{N}: {ms * 1e3:.1f} us, bound {b3[0] * 1e3:.1f} us ({b3[1]}), "
                    f"torch.matmul on the dequantized bf16 weight {lib * 1e3:.1f} us")
                if M == 128 and lname == "c_fc12":
                    k3 = dict(shape=f"M={M} K={K} N={N} (c_fc12)", ms=ms, library_ms=lib,
                              plain_ms=time_ms(lambda: quant_matmul.matmul_int4_ref(*args), 3),
                              bound_ms=b3[0], bound_by=b3[1])
                if M == 200 and lname in ("c_attn", "c_fc12"):
                    rows_equal(quant_matmul.matmul_int4, x, args[1:], f"K3 {lname}")
            del wd
        results["K3"] = dict(k3, max_abs_err=max(errs))

        # ---- 2b. K3 at M = 1 (gemv4_sm90.cuh): the five linears timed beside their
        # bound and torch.matmul, a decoded token's 4 L + 1 launches summed; each held
        # to its plain version in bf16 and f32 at gs 128 (the model's), gs 32, gs = K
        # and N = 1040; equal bits across two launches and two streams (each has its
        # own workspace and counters); and programmatic dependent launch: each K3
        # reads the x that the kernel launched just before it wrote (a copy into the
        # same buffer, or the K3 before it in a chain of 4 on attn.c_proj's shape),
        # with no synchronisation between. Inputs from a generator of their own.
        g2b = torch.Generator(device=dev).manual_seed(SEED + 16)
        L = cfg.n_layer
        m1, errs1 = {}, []
        for lname, w, K in linears:
            N = w["qw"].shape[1]
            wd = dequantize_int4(w, torch.bfloat16)
            x = torch.randn(1, K, generator=g2b, device=dev).to(torch.bfloat16)
            args = (x, w["qw"], w["qscale"], w["qzero"])
            errs1.append(max_err(quant_matmul.matmul_int4(*args), quant_matmul.matmul_int4_ref(*args), "K3"))
            xf = x.float()
            max_err32(quant_matmul.matmul_int4(xf, *args[1:], torch.float32),
                      quant_matmul.matmul_int4_ref(xf, *args[1:], torch.float32), f"K3 f32 M=1 {lname}")
            ms = time_ms(lambda: quant_matmul.matmul_int4(*args))
            lib = time_ms(lambda: torch.matmul(x, wd))
            b1 = bound_ms(K * 2 + q4_bytes(K, N) + N * 2, 2 * K * N, tc_peak)
            m1[lname] = dict(ms=ms, bound_ms=b1[0], bound_by=b1[1], library_ms=lib)
            k3_shapes[f"{lname} {K}->{N} M=1"] = m1[lname]
            log(f"K3 M=1 {lname} {K}->{N}: {ms * 1e3:.1f} us, bound {b1[0] * 1e3:.1f} us ({b1[1]}), "
                f"torch.matmul on the dequantized bf16 weight {lib * 1e3:.1f} us")
            if lname == "c_fc12":
                k3m1 = dict(shape=f"M=1 K={K} N={N} (c_fc12, one decode token)", ms=ms, library_ms=lib,
                            plain_ms=time_ms(lambda: quant_matmul.matmul_int4_ref(*args), 3),
                            bound_ms=b1[0], bound_by=b1[1])
            del wd
        block4 = ("c_attn", "attn.c_proj", "c_fc12", "mlp.c_proj")
        token = {k: L * sum(m1[n][k] for n in block4) + m1["lm_head"][k] for k in ("ms", "bound_ms", "library_ms")}
        entry_inputs["k3_m1_token"] = dict(token, launches=4 * L + 1, share_of_bound=token["bound_ms"] / token["ms"])
        log(f"K3 at M = 1, a decoded token's {4 * L + 1} launches: {token['ms']:.3f} ms, bound "
            f"{token['bound_ms']:.3f} ms ({100 * token['bound_ms'] / token['ms']:.1f} % of it), torch.matmul on the "
            f"dequantized bf16 weights {token['library_ms']:.3f} ms")
        odd_w = {}
        for K, N, g_ in ((D, 3 * D, 32), (I, D, 32), (D, D, D), (D, 1040, gs), (I, 1040, gs), (D, 1032, 8)):
            wq = quantize_int4(torch.randn(K, N, generator=g2b, device=dev) * 0.02, -1 if g_ == K else g_)
            odd_w[(K, N, g_)] = wq
            for cdt in (torch.bfloat16, torch.float32):
                x = torch.randn(1, K, generator=g2b, device=dev).to(cdt)
                args = (x, wq["qw"], wq["qscale"], wq["qzero"], cdt)
                got, want = quant_matmul.matmul_int4(*args), quant_matmul.matmul_int4_ref(*args)
                if cdt == torch.bfloat16:
                    errs1.append(max_err(got, want, "K3"))
                else:
                    max_err32(got, want, f"K3 f32 M=1 K={K} N={N} gs={g_}")
        results["K3 M=1"] = dict(k3m1, max_abs_err=max(errs1))
        for cdt in (torch.bfloat16, torch.float32):
            for lname, w in (("attn.c_proj", lp0["attn"]["c_proj"]), ("mlp.c_proj", lp0["mlp"]["c_proj"]),
                             ("N=1040", odd_w[(D, 1040, gs)]), ("gs 32", odd_w[(I, D, 32)])):
                x = torch.randn(1, 2 * w["qw"].shape[0], generator=g2b, device=dev).to(cdt)
                wargs = (w["qw"], w["qscale"], w["qzero"], cdt)
                first = quant_matmul.matmul_int4(x, *wargs)
                assert torch.equal(first, quant_matmul.matmul_int4(x, *wargs)), \
                    f"K3 M=1 {lname} {cdt}: a second launch differs"
                streams, outs = [torch.cuda.Stream(dev) for _ in range(2)], [[], []]
                torch.cuda.synchronize()
                for _ in range(4):
                    for st, o in zip(streams, outs):
                        with torch.cuda.stream(st):
                            o.append(quant_matmul.matmul_int4(x, *wargs))
                torch.cuda.synchronize()
                assert all(torch.equal(first, y) for o in outs for y in o), f"K3 M=1 {lname} {cdt}: the streams differ"
            # a square weight whose outputs keep their inputs' scale (std 1 / sqrt(D)), so a
            # chain's inputs stay O(1) as a model's normalised rows are
            w = quantize_int4(torch.randn(D, D, generator=g2b, device=dev) * D ** -0.5, gs)
            wargs = (w["qw"], w["qscale"], w["qzero"], cdt)
            xbuf = torch.empty(1, D, dtype=cdt, device=dev)
            news = [torch.randn(1, D, generator=g2b, device=dev).to(cdt) for _ in range(4)]
            torch.cuda.synchronize()
            outs = []
            for nx in news:
                xbuf.copy_(nx)
                outs.append(quant_matmul.matmul_int4(xbuf, *wargs))
            chain = [news[0]]
            for _ in range(4):
                chain.append(quant_matmul.matmul_int4(chain[-1], *wargs))
            torch.cuda.synchronize()
            for a, y in list(zip(news, outs)) + list(zip(chain, chain[1:])):
                want = quant_matmul.matmul_int4_ref(a, *wargs)
                if cdt == torch.bfloat16:
                    max_err(y, want, "K3")
                else:
                    max_err32(y, want, "K3 f32 M=1 after the kernel that wrote its x")
        del odd_w, w, xbuf, news, outs, chain
        entry_inputs["k3_m1_bits_equal"] = "two launches and two streams, attn.c_proj, mlp.c_proj, N=1040, gs 32; bf16 and f32"
        entry_inputs["k3_m1_sees_x_written_just_before"] = "a copy into x, and a chain of 4 K3 (4096 -> 4096); bf16 and f32"
        log(f"K3 at M = 1: within TOL['K3'] / TOL_F32 of its plain version at the five linears, gs 32, gs = K, "
            f"N = 1040 and 1032 (bf16 max err {max(errs1):.3g}); equal bits across two launches and two streams; "
            f"each launch reads the x the kernel just before it wrote (copies, a chain of 4), bf16 and f32")

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
        # K4 at the training shape (phase 15's micro-batch 2, and 1), where
        # it launches 2 L A times a step, beside SDPA's causal forward; its
        # inputs come from a generator of their own, so that the phases after
        # this one draw what they drew before it was added
        k4t = {}
        g4 = torch.Generator().manual_seed(SEED + 1)
        for B in (1, 2):
            q, k, v = (torch.randn((B, H, 2048, hs), generator=g4).to(dev, torch.bfloat16) for _ in range(3))
            o, lse = fa.flash_attention(q, k, v)
            ro, rlse = fa.flash_attention_ref(q, k, v)
            err = max_err(o, ro, "K4")
            max_err(lse, rlse, "K4 lse")
            nbytes, ops = 4 * B * H * 2048 * hs * 2 + B * H * 2048 * 4, 4 * hs * B * H * 2048 * 2049 // 2
            b4 = bound_ms(nbytes, ops, tc_peak)
            ms, lib = time_ms(lambda: fa.flash_attention(q, k, v)), time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
            log(f"K4 (B, H, T) = {(B, H, 2048)}: {ms * 1e3:.1f} us, SDPA causal {lib * 1e3:.1f} us, bound "
                f"{b4[0] * 1e3:.1f} us ({b4[1]}); max err {err:.3g}")
            if B == 1:
                k4t = dict(shape=f"B=1 H={H} T=2048 hs={hs}", ms=ms, library_ms=lib, bound_ms=b4[0], bound_by=b4[1],
                           plain_ms=time_ms(lambda: fa.flash_attention_ref(q, k, v), 3), max_abs_err=err)
            else:
                k4t.update(ms_at_b2=ms, library_ms_at_b2=lib, bound_ms_at_b2=b4[0],
                           max_abs_err=max(k4t["max_abs_err"], err))
            del q, k, v, o, lse, ro, rlse
        results["K4 T2048"] = k4t

        # ---- 4. K1 vs plain: one 7B block, S = 2048 ------------------------------
        S = 2048
        rope = build_rope_cache(cfg.block_size, hs, device=dev)
        kc0, vc0 = randn(1, H, S, hs, scale=0.3), randn(1, H, S, hs, scale=0.3)
        layer_bytes = (q4_bytes(D, 3 * D) + q4_bytes(D, D) + q4_bytes(D, 2 * I) + q4_bytes(I, D)
                       + 2 * D * 2 + 2 * hs * 4 + 2 * D * 2 + 2 * H * hs * 2)
        layer_ops = 2 * (3 * D * D + D * D + 2 * I * D + I * D)
        errs = []
        # 2053: past S, the ring wrapped; then 255 and 256: both sides of a split
        # boundary (256 rows a split at S = 2048, decode_attention.decode_plan),
        # their rows from a generator of their own, so that the phases after this
        # one draw what they drew before these were added
        split = da.decode_plan(S, hs).split_rows
        g_split = torch.Generator().manual_seed(SEED + 4)
        for pos in (0, 1000, 2047, 2053, split - 1, split):
            x = randn(1, D) if pos in (0, 1000, 2047, 2053) else torch.randn(
                (1, D), generator=g_split).to(dev, torch.bfloat16)
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
            log(f"K1 S={S} pos={pos}: {ms * 1e3:.1f} us, bound {bound_ms(nbytes, ops, f32_peak)[0] * 1e3:.1f} us, "
                f"max err {errs[-1]:.3g}")
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

        # ---- 5b''. a row's K7 / K9 bits at B = 1, 32 and 128 (7B width); K9's
        # kernels at B = 32. Its inputs leave the shared generator where they
        # found it, so the later phases draw the data they always drew.
        state = gcpu.get_state()
        ha, ta = halves_args(lp0, cfg, 128)
        gcpu.set_state(state)
        outs = {}
        for B in (1, 32, 128):
            outs[B] = (fused_layer.block_head_fused(ha[0][:B], ha[1], ha[2][:B], ha[3][:B], *ha[4:]),
                       fused_layer.block_tail_fused(ta[0][:B], ta[1][:B], *ta[2:]))
        for B in (1, 32):
            for name, got, ref in zip(("K7", "K9"), outs[B], outs[128]):
                assert torch.equal(got, ref[:B]), f"{name}: a row's bits at B={B} differ from the 128-slot call's"
        del outs
        log("K7 and K9 at 7B width: each row the same bits at B = 1, 32 and 128")
        try:
            k9_kernels = devtime.kernel_sequence(
                lambda: fused_layer.block_tail_fused(ta[0][:32], ta[1][:32], *ta[2:]), time_us)
            log("K9 at B=32 by kernel (device us from the previous one's end, programmatic dependent launch "
                "starts each early): " + "; ".join(
                    f"{kernel_name(k['kernel'])} {k['us'] + min(0.0, k['start_after_previous_end_us']):.1f}"
                    for k in k9_kernels["sequence"])
                + f"; first start to last end {k9_kernels['first_start_to_last_end_us']:.1f}")
        except RuntimeError as e:  # a profiler that keeps dropping records is no fault of the kernels
            k9_kernels = dict(error=str(e))
            log(f"K9 at B=32 by kernel: not read ({e})")
        entry_inputs["k9_kernels_b32"] = k9_kernels

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
            if tag:
                # for phase 6c: the prompts phases 6 and 6b drew here when phase 4
                # drew two more rows from this generator (their failure on the
                # LoRA step, 0.398 > 0.341, is read again below). Each draw takes
                # a fixed count of the generator's stream, so that state is this
                # one advanced by the two rows
                g_shifted = torch.Generator()
                g_shifted.set_state(gcpu.get_state())
                for _ in range(2):
                    torch.randn((1, D), generator=g_shifted)
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

        # ---- 6c. phase 6b's serving step on the prompt seeds it was read at, without
        # and with LoRA (and with LoRA on the prompts that failed it once): the
        # reading, each kernel against its plain version on the plain path's inputs
        # (layer by layer, step by step, each within its own TOL), and both bf16
        # paths' distance from the plain path in f32 compute -------------------------
        six_c = {}
        for tag, pp, cc, draws in (("", params, cfg, SEEDS_6C), (" with LoRA", params_l, lcfg, SEEDS_6C + (g_shifted,))):
            p2, c2 = dict(pp, h=pp["h"][:2]), cc.replace(n_layer=2)
            six_c[tag.strip() or "without LoRA"] = rs = [serving_layer_check(p2, c2, rope, dev, d, TOL) for d in draws]
            for r in rs:
                log(f"6c{tag} seed {r['seed']}: 6b reading {r['reading_6b']:.4g}; per kernel max err "
                    + ", ".join(f"{k} {v:.3g} ({r['tolerance_share'][k]:.2f} of TOL)"
                                for k, v in r["per_kernel"].items())
                    + f"; from the f32 plain path: kernel {r['distance_to_f32']['kernel']:.4g}, "
                    f"plain {r['distance_to_f32']['plain']:.4g}")
                bad = [k for k, v in r["tolerance_share"].items() if v > 1.0]
                assert not bad, f"6c{tag} seed {r['seed']}: {bad} beyond their tolerance on the plain path's inputs"
        entry_inputs["serving_6c"] = six_c
        del p2, c2

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

        # ---- 7c. the per-op int4 path: the same model on an int8 KV cache decodes per
        # op (K3 at M = 1 for every linear, K5 on the int8 cache), as generate takes
        # an int4 model with --kv_cache_dtype int8: greedy requests, launches asserted,
        # decode tok/s beside the fused step's (phase 7). Prompts from a generator of
        # their own ----------------------------------------------------------------
        g7c = torch.Generator().manual_seed(SEED + 17)
        qcfg = cfg.replace(kv_cache_dtype="int8")
        full_perop = {}
        gen.generate(params, ref_prompt, 4, config=qcfg, temperature=0.0)  # warm-up, not counted
        torch.cuda.synchronize()
        k3m1_launches = 0
        for T, s in ((8, 72), (128, 2048)):
            prompt = torch.randint(0, cfg.vocab_size, (T,), generator=g7c)
            for fn in counters.values():
                fn.launches = 0
            quant_matmul.matmul_int4.gemv_launches = 0
            out = gen.generate(params, prompt, new, config=qcfg, max_seq_length=s, temperature=0.0)
            got = {k: fn.launches for k, fn in counters.items()}
            m1n = quant_matmul.matmul_int4.gemv_launches
            want = dict.fromkeys(counters, 0)
            want.update({"K3": (4 * L + 1) * new, "K4": L, "K5": L * (new - 1)})
            assert got == want, f"per-op int4 request T={T} S={s}: launches {got}, expected {want}"
            assert m1n == (4 * L + 1) * (new - 1), f"per-op int4 request T={T}: {m1n} K3 launches at M = 1"
            assert out.shape == (T + new,) and int(out.min()) >= 0 and int(out.max()) < V, "bad tokens"
            k3m1_launches += m1n
            prefill_s, total_s = wall_s(params, qcfg, prompt, 1, s), wall_s(params, qcfg, prompt, new, s)
            S_used = gen.plan_seq_length(qcfg, T + new, s)
            tok_s = (new - 1) / (total_s - prefill_s)
            fused_key = f"T={T},S={S_used}" if f"T={T},S={S_used}" in full else next(k for k in full
                                                                                  if k.startswith(f"T={T},"))
            fused_tok_s = full[fused_key]["decode_tok_s"]
            full_perop[f"T={T},S={S_used},kv=int8"] = dict(prefill_ms=prefill_s * 1e3, decode_tok_s=tok_s,
                                                           fused_step_decode_tok_s=fused_tok_s)
            log(f"per-op int4 request prompt {T} S={S_used} int8 KV cache: prefill {prefill_s * 1e3:.1f} ms, decode "
                f"{tok_s:.1f} tok/s (the fused step, phase 7 {fused_key}: {fused_tok_s:.1f} tok/s; {new} new tokens, launches "
                f"K3 {got['K3']} of which {m1n} at M = 1, K4 {got['K4']}, K5 {got['K5']})")
        entry_inputs["requests_int4_per_op"] = full_perop

        # ---- 7d. full width, 2 blocks, the per-op int4 path on the int8 cache: kernel
        # path vs plain path, a 197-token prompt and 8 steps past S = 200 -----------
        p2, c2 = dict(params, h=params["h"][:2]), qcfg.replace(n_layer=2)
        S2 = 200
        prompt = torch.randint(0, cfg.vocab_size, (1, 197), generator=g7c).to(dev)
        caches = {plain: llama.init_kv_cache(c2, 1, S2, device=dev) for plain in (False, True)}
        logits = {plain: llama.forward(p2, prompt, c2, rope_cache=rope, kv_cache=caches[plain],
                                       prefill_from_zero=True, plain=plain)[0] for plain in (False, True)}
        errs = [model_err(logits[False], logits[True], "2-layer per-op int4 prefill, int8 cache")]
        tok = logits[False][:, -1].float().argmax(-1)
        quant_matmul.matmul_int4.gemv_launches = 0
        for step in range(8):
            pos = prompt.shape[1] + step
            lg = {plain: llama.forward(p2, tok[None], c2, rope_cache=rope, input_pos=[pos],
                                       kv_cache=caches[plain], plain=plain)[0][:, -1] for plain in (False, True)}
            errs.append(model_err(lg[False], lg[True], f"2-layer per-op int4 decode step {step}, int8 cache"))
            tok = lg[False].float().argmax(-1)
        assert quant_matmul.matmul_int4.gemv_launches == 8 * (4 * 2 + 1), "2-layer per-op int4: K3 M=1 launches"
        entry_inputs["per_op_int4_2_layers"] = dict(prefill=errs[0], decode=max(errs[1:]))
        log(f"2-layer 7B-width int4 model, per-op path (K3 at M = 1, K4, K5), int8 KV cache, S={S2}, kernel vs "
            f"plain path: prefill max |dlogit| {errs[0]:.4g}, 8 decode steps (5 past S) max {max(errs[1:]):.4g}")
        del caches, logits, lg, p2

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
        phase8.update(prompts=prompts, tokens=[done[i].generated for i in ids])  # phase 30's reference
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

        # ---- 8e. past 64 slots: K7 and K9 at B = 65, 96, 128 vs plain ---------
        errs7w, errs9w = [], []
        for B in (65, 96, 128):
            ha, ta = halves_args(lp0, cfg, B)
            errs7w.append(max_err(fused_layer.block_head_fused(*ha), fused_layer.block_head_fused_ref(*ha), "K7"))
            errs9w.append(max_err(fused_layer.block_tail_fused(*ta), fused_layer.block_tail_fused_ref(*ta), "K9"))
        ha64, ta64 = halves_args(lp0, cfg, 64)
        # timed 64, 128, 128, 64 in one call
        ms7 = [time_ms(lambda: fused_layer.block_head_fused(*h_)) for h_ in (ha64, ha, ha, ha64)]
        ms9 = [time_ms(lambda: fused_layer.block_tail_fused(*t_)) for t_ in (ta64, ta, ta, ta64)]
        for key, msx, args_, ref_fn, nbytes, ops in (
                ("K7 B>64", ms7, ha, fused_layer.block_head_fused_ref,
                 128 * D * 2 + D * 2 + q4_bytes(D, 3 * D) + 2 * 128 * hs * 4 + 128 * 3 * D * 2, 2 * 128 * D * 3 * D),
                ("K9 B>64", ms9, ta, fused_layer.block_tail_fused_ref,
                 2 * 128 * D * 2 + D * 2 + q4_bytes(D, D) + q4_bytes(D, 2 * I) + q4_bytes(I, D) + 128 * D * 2,
                 2 * 128 * (D * D + 2 * I * D + I * D))):
            b_ = bound_ms(nbytes, ops, tc_peak)
            results[key] = dict(shape=f"B=128 D={D}" + (" -> 3D (c_attn)" if key.startswith("K7") else f" I={I}"),
                                ms=(msx[1] + msx[2]) / 2, ms_at_b64=(msx[0] + msx[3]) / 2, library_ms=None,
                                plain_ms=time_ms(lambda: ref_fn(*args_), 3), bound_ms=b_[0], bound_by=b_[1],
                                max_abs_err=max(errs7w if key.startswith("K7") else errs9w))
            log(f"{key[:2]} at B=128: {msx[1] * 1e3:.1f} / {msx[2] * 1e3:.1f} us, at B=64 {msx[0] * 1e3:.1f} / "
                f"{msx[3] * 1e3:.1f} us (timed 64, 128, 128, 64); bound at 128 {b_[0] * 1e3:.1f} us ({b_[1]}); "
                f"B = 65, 96, 128 vs plain max err {results[key]['max_abs_err']:.3g}")

        # ---- 8f. 128 requests at once through a 128-slot engine, each request's
        # tokens against the same request's in a 32-slot engine ------------------------
        n_a, new_a, S_a = 128, 16, 256
        rng_a = np.random.default_rng(SEED + 10)
        lens_a = np.exp(rng_a.uniform(np.log(8), np.log(128), n_a)).astype(int)  # log-uniform in [8, 128]
        prompts_a = [rng_a.integers(1, cfg.vocab_size, size=int(n)).astype(np.int64) for n in lens_a]
        toks_a = {}
        for slots in (128, 32):
            engine = DecodeEngine(params, cfg, max_batch=slots, max_seq_length=S_a, steps_per_sync=8)
            assert engine.serve_fused, f"a {slots}-slot engine should take K7-K9"
            engine.warmup()
            torch.cuda.synchronize()
            steps0, prefills0 = engine.decode_steps, engine.prefills
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            ids = [engine.submit(p, new_a) for p in prompts_a]
            done = engine.run()
            wall = time.perf_counter() - t0
            got = {k: fn.launches for k, fn in counters.items()}
            steps, prefills = engine.decode_steps - steps0, engine.prefills - prefills0
            want = dict.fromkeys(counters, 0)
            want.update({"K3": prefills * (4 * L + 1) + steps, "K4": L * prefills, "K7": L * steps,
                         "K8": L * steps, "K9": L * steps})
            assert got == want, f"{slots}-slot engine: launches {got}, expected {want}"
            assert prefills == n_a and sorted(done) == ids and not engine.has_work()
            toks_a[slots] = [done[i].generated for i in ids]
            assert all(len(t) == new_a and min(t) >= 0 and max(t) < V for t in toks_a[slots])
            n_tok = sum(len(t) for t in toks_a[slots])
            ttfts = sorted(done[i].ttft for i in ids)
            entry_inputs[f"serving_{slots}_slots"] = dict(
                requests=n_a, slots=slots, S=S_a, new_tokens=new_a, prompt_tokens=int(lens_a.sum()),
                decode_steps=steps, prefills=prefills, wall_s=wall, tok_s=n_tok / wall,
                ttft_p50_ms=ttfts[len(ttfts) // 2] * 1e3, cache_gib=2 * L * slots * H * S_a * hs * 2 / 2**30)
            log(f"engine, {slots} slots, S={S_a}, {n_a} requests at once (prompts {lens_a.min()}..{lens_a.max()}, "
                f"{new_a} new tokens): {n_tok} tokens in {wall:.2f} s = {n_tok / wall:.1f} tok/s aggregate, TTFT p50 "
                f"{entry_inputs[f'serving_{slots}_slots']['ttft_p50_ms']:.0f} ms (host clock); {steps} decode steps; "
                f"launches {got}")
            if slots == 128:
                totals["K7 B>64"], totals["K9 B>64"] = got["K7"], got["K9"]
            del engine
            gc.collect()
            torch.cuda.empty_cache()
        differ = [i for i in range(n_a) if toks_a[128][i] != toks_a[32][i]]
        assert not differ, f"requests {differ[:10]} got other tokens in the 128-slot engine than in the 32-slot one"
        log(f"each of the {n_a} requests got the same {new_a} tokens in the 128-slot and the 32-slot engine")

        # ---- 8g. LoRA at r = 64 on q and v (R8 = 128), the operand bf16 and f32 --
        lcfg64 = cfg.replace(lora=LoRAConfig(r=64, alpha=16.0, dropout=0.0))
        ov64 = random_lora_overlay(cfg7.replace(param_dtype="float32", lora=lcfg64.lora), seed=SEED + 5,
                                   device=dev)["h"]["attn"]["c_attn"]
        params_w = {}
        for odt in ("float32", "bfloat16"):
            lay = []
            for j, lp in enumerate(params["h"]):
                ca = fused_layer.prepare_lora_operands(
                    {**lp["attn"]["c_attn"], "lora_a": ov64["lora_a"][j], "lora_b": ov64["lora_b"][j]},
                    lcfg64.lora, D, hs)
                ca["lora_af"], ca["lora_bf"] = (ca[k].to(getattr(torch, odt)) for k in ("lora_af", "lora_bf"))
                lay.append({**lp, "attn": {**lp["attn"], "c_attn": ca}})
            params_w[odt] = dict(params, h=lay)
        del ov64
        kc1, vc1 = randn(1, H, S, hs, scale=0.3), randn(1, H, S, hs, scale=0.3)
        R8w = params_w["bfloat16"]["h"][0]["attn"]["c_attn"]["lora_af"].shape[1]
        assert R8w == 128, R8w
        wbytes = {odt: (D * R8w + R8w * 3 * D) * (4 if odt == "float32" else 2) for odt in params_w}
        wops = 2 * (D * R8w + R8w * 3 * D)
        for odt, pw in params_w.items():
            tag = "" if odt == "bfloat16" else " f32"
            lpw = pw["h"][0]
            errs = []
            for pos in (0, 2047, 2053):
                x = randn(1, D)
                cos, sin = rope_half_row(rope, min(pos, cfg.block_size - 1), hs)
                kv, rkv = ({"k": kc1.clone(), "v": vc1.clone()} for _ in range(2))
                out, _ = fused_layer.decode_layers_fused(x, [lpw], [kv], cos, sin, pos % S, pos, lcfg64)
                ref, _ = fused_layer.decode_layers_fused_ref(x, [lpw], [rkv], cos, sin, pos % S, pos, lcfg64)
                errs.append(max_err(out, ref, "K1 LoRA"))
                max_err(kv["v"], rkv["v"], "K1 cache")
                bare = {"k": kc1.clone(), "v": vc1.clone()}
                fused_layer.decode_layers_fused_ref(x, [lp0], [bare], cos, sin, pos % S, pos, cfg)
                moved = float((bare["v"][0, :, pos % S] - rkv["v"][0, :, pos % S]).float().abs().max())
                assert moved > 10 * TOL["K1 cache"][0], f"K1 LoRA R8=128{tag}: the operand moves v by {moved:.3g} only"
            visible = S
            b1 = bound_ms(layer_bytes + wbytes[odt] + 2 * H * visible * hs * 2, layer_ops + wops + 4 * H * visible * hs,
                          f32_peak)
            results[f"K1 LoRA R8=128{tag}"] = dict(
                shape=f"one 7B block, S={S}, pos=2053, R8={R8w}, {odt} operand", max_abs_err=max(errs),
                ms=time_ms(lambda: fused_layer.decode_layers_fused(x, [lpw], [kv], cos, sin, pos % S, pos, lcfg64)),
                plain_ms=time_ms(lambda: fused_layer.decode_layers_fused_ref(x, [lpw], [rkv], cos, sin, pos % S, pos,
                                                                             lcfg64), 3),
                library_ms=None, bound_ms=b1[0], bound_by=b1[1])
            errs = []
            for B in (8, 32, 128):
                ha, _ = halves_args(lpw, lcfg64, B)
                errs.append(max_err(fused_layer.block_head_fused(*ha), fused_layer.block_head_fused_ref(*ha),
                                    "K7 LoRA"))
                if B == 32:
                    ha32 = ha
            b7w = bound_ms(32 * D * 2 + D * 2 + q4_bytes(D, 3 * D) + wbytes[odt] + 2 * 32 * hs * 4 + 32 * 3 * D * 2,
                           2 * 32 * D * 3 * D + 32 * wops, tc_peak)
            results[f"K7 LoRA R8=128{tag}"] = dict(
                shape=f"B=32 D={D} -> 3D (c_attn), R8={R8w}, {odt} operand", max_abs_err=max(errs),
                ms=time_ms(lambda: fused_layer.block_head_fused(*ha32)),
                plain_ms=time_ms(lambda: fused_layer.block_head_fused_ref(*ha32), 3), library_ms=None,
                bound_ms=b7w[0], bound_by=b7w[1])
            # one generation request (prompt 8, S = 80, 32 tokens) and the LoRA engine
            # on phase 8's 64 requests
            prompt_w = torch.randint(0, cfg.vocab_size, (8,), generator=gcpu)
            for fn in counters.values():
                fn.launches = 0
            out_w = gen.generate(pw, prompt_w, 32, config=lcfg64, max_seq_length=80, temperature=0.0)
            got = {k: fn.launches for k, fn in counters.items()}
            want = dict.fromkeys(counters, 0)
            want.update({"K1": L * 31, "K1 LoRA": L * 31, "K2": 31, "K3": 4 * L + 1, "K4": L})
            assert got == want, f"LoRA R8=128{tag} request: launches {got}, expected {want}"
            assert out_w.shape == (40,) and int(out_w.min()) >= 0 and int(out_w.max()) < V
            totals[f"K1 LoRA R8=128{tag}"] = got["K1 LoRA"]
            engine = DecodeEngine(pw, lcfg64, max_batch=slots, max_seq_length=S_e, steps_per_sync=8)
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            ids = [engine.submit(p, new_e) for p in prompts]
            done = engine.run()
            wall = time.perf_counter() - t0
            got = {k: fn.launches for k, fn in counters.items()}
            steps = engine.decode_steps
            assert got["K7 LoRA"] == got["K7"] == L * steps and engine.prefills == n_req, f"LoRA R8=128 engine: {got}"
            totals[f"K7 LoRA R8=128{tag}"] = got["K7 LoRA"]
            n_tok = sum(len(done[i].generated) for i in ids)
            entry_inputs[f"lora_r64_{odt}"] = dict(request_tokens=out_w.tolist()[8:], engine_tok_s=n_tok / wall,
                                             engine_steps=steps)
            log(f"LoRA r = 64 on q and v (R8 = {R8w}), {odt} operand: K1 vs plain max err "
                f"{results[f'K1 LoRA R8=128{tag}']['max_abs_err']:.3g}, {results[f'K1 LoRA R8=128{tag}']['ms'] * 1e3:.1f}"
                f" us at S={S} (bound {b1[0] * 1e3:.1f}); K7 max err {results[f'K7 LoRA R8=128{tag}']['max_abs_err']:.3g}, "
                f"{results[f'K7 LoRA R8=128{tag}']['ms'] * 1e3:.1f} us at B=32 (bound {b7w[0] * 1e3:.1f}); a request "
                f"(prompt 8, S=80, 32 tokens) with launches {want}; the LoRA engine on phase 8's {n_req} requests: "
                f"{n_tok} tokens in {wall:.2f} s = {n_tok / wall:.1f} tok/s, {steps} steps, K7 LoRA launches "
                f"{got['K7 LoRA']}")
            del engine
        del params_w, pw, lpw, kc1, vc1
        gc.collect()
        torch.cuda.empty_cache()

        # ---- 8h. f32 compute on the int4 model: K3, K4, K1, K2, K7, K8, K9 vs plain
        cfg32 = cfg.replace(compute_dtype="float32")

        def randf(*shape, scale=1.0):
            return (torch.randn(shape, generator=gcpu) * scale).to(dev)

        errs = []
        for M in (8, 128):
            for lname, w, K in linears:
                x = randf(M, K)
                args = (x, w["qw"], w["qscale"], w["qzero"], torch.float32)
                errs.append(max_err32(quant_matmul.matmul_int4(*args), quant_matmul.matmul_int4_ref(*args),
                                      f"K3 f32 M={M} {lname}"))
                if M == 128 and lname == "c_fc12":
                    N = w["qw"].shape[1]
                    wd = dequantize_int4(w, torch.float32)
                    b3 = bound_ms(M * K * 4 + q4_bytes(K, N) + M * N * 4, 2 * M * K * N, f32_peak)
                    results["K3 f32"] = dict(shape=f"M={M} K={K} N={N} (c_fc12), f32", ms=time_ms(
                        lambda: quant_matmul.matmul_int4(*args)), plain_ms=time_ms(
                        lambda: quant_matmul.matmul_int4_ref(*args), 3), library_ms=time_ms(lambda: torch.matmul(x, wd)),
                        bound_ms=b3[0], bound_by=b3[1])
                    del wd
        results["K3 f32"]["max_abs_err"] = max(errs)
        errs = []
        for T in (128, 200):
            q, k, v = (randf(1, H, T, hs) for _ in range(3))
            o, lse = fa.flash_attention(q, k, v)
            ro, rlse = fa.flash_attention_ref(q, k, v)
            errs.append(max_err32(o, ro, f"K4 f32 T={T}"))
            max_err32(lse, rlse, f"K4 f32 lse T={T}")
        k4f32_err = entry_inputs["k4_f32_err_t128_t200"] = max(errs)
        errs = []
        kcf, vcf = randf(1, H, S, hs, scale=0.3), randf(1, H, S, hs, scale=0.3)
        for pos in (0, 1000, 2047, 2053):
            x = randf(1, D)
            cos, sin = rope_half_row(rope, min(pos, cfg.block_size - 1), hs)
            kv, rkv = ({"k": kcf.clone(), "v": vcf.clone()} for _ in range(2))
            out, _ = fused_layer.decode_layers_fused(x, [lp0], [kv], cos, sin, pos % S, pos, cfg32)
            ref, _ = fused_layer.decode_layers_fused_ref(x, [lp0], [rkv], cos, sin, pos % S, pos, cfg32)
            errs.append(max_err32(out, ref, f"K1 f32 pos={pos}"))
            max_err32(kv["k"], rkv["k"], "K1 f32 cache")
            max_err32(kv["v"], rkv["v"], "K1 f32 cache")
        b1 = bound_ms(layer_bytes + 2 * H * S * hs * 4, layer_ops + 4 * H * S * hs, f32_peak)
        results["K1 f32"] = dict(
            shape=f"one 7B block, S={S}, pos=2053, f32 row and cache", max_abs_err=max(errs), library_ms=None,
            ms=time_ms(lambda: fused_layer.decode_layers_fused(x, [lp0], [kv], cos, sin, pos % S, pos, cfg32)),
            plain_ms=time_ms(lambda: fused_layer.decode_layers_fused_ref(x, [lp0], [rkv], cos, sin, pos % S, pos,
                                                                         cfg32), 3),
            bound_ms=b1[0], bound_by=b1[1])
        del kcf, vcf, kv, rkv
        x = randf(1, D)
        head_args = (x, params["ln_f"], params["lm_head"], cfg32)
        b2 = bound_ms(D * 4 + D * 2 + q4_bytes(D, V) + V * 4, 2 * D * V, f32_peak)
        results["K2 f32"] = dict(
            shape=f"D={D} V={V}, f32", library_ms=None, bound_ms=b2[0], bound_by=b2[1],
            max_abs_err=max_err32(fused_layer.lm_head_fused(*head_args), fused_layer.lm_head_fused_ref(*head_args),
                                  "K2 f32"),
            ms=time_ms(lambda: fused_layer.lm_head_fused(*head_args)),
            plain_ms=time_ms(lambda: fused_layer.lm_head_fused_ref(*head_args), 3))
        # K2 with an f32 ln_f (bf16 compute) at the 7B vocabulary: phase 8d' runs
        # it at V = 128 on the f32 checkpoint
        x = randn(1, D)
        ln32 = (1.0 + 0.3 * torch.randn(D, generator=gcpu)).to(dev)
        head_args = (x, ln32, params["lm_head"], cfg)
        b2 = bound_ms(D * 2 + D * 4 + q4_bytes(D, V) + V * 2, 2 * D * V, f32_peak)
        results["K2 f32 norms"] = dict(
            shape=f"D={D} V={V}, f32 ln_f, bf16 compute", library_ms=None, bound_ms=b2[0], bound_by=b2[1],
            max_abs_err=max_err(fused_layer.lm_head_fused(*head_args), fused_layer.lm_head_fused_ref(*head_args), "K2"),
            ms=time_ms(lambda: fused_layer.lm_head_fused(*head_args)),
            plain_ms=time_ms(lambda: fused_layer.lm_head_fused_ref(*head_args), 3))
        errs7f, errs9f = [], []
        for B in (1, 8, 32, 65):
            x, y = randf(B, D), randf(B, D)
            pos = torch.randint(0, cfg.block_size + 100, (B,), generator=gcpu).to(dev, torch.int32)
            cos, sin = slot_rope_rows(rope, pos)
            ha = (x, lp0["rms_1"], cos, sin, lp0["attn"]["c_attn"], cfg32)
            ta = (x, y, lp0["rms_2"], lp0["attn"]["c_proj"], lp0["mlp"]["c_fc12"], lp0["mlp"]["c_proj"], cfg32)
            errs7f.append(max_err32(fused_layer.block_head_fused(*ha), fused_layer.block_head_fused_ref(*ha),
                                    f"K7 f32 B={B}"))
            errs9f.append(max_err32(fused_layer.block_tail_fused(*ta), fused_layer.block_tail_fused_ref(*ta),
                                    f"K9 f32 B={B}"))
            if B == 32:
                b7 = bound_ms(B * D * 4 + D * 2 + q4_bytes(D, 3 * D) + 2 * B * hs * 4 + B * 3 * D * 4,
                              2 * B * D * 3 * D, f32_peak)
                b9 = bound_ms(2 * B * D * 4 + D * 2 + q4_bytes(D, D) + q4_bytes(D, 2 * I) + q4_bytes(I, D) + B * D * 4,
                              2 * B * (D * D + 2 * I * D + I * D), f32_peak)
                results["K7 f32"] = dict(shape=f"B={B} D={D} -> 3D (c_attn), f32", library_ms=None,
                                         ms=time_ms(lambda: fused_layer.block_head_fused(*ha)),
                                         plain_ms=time_ms(lambda: fused_layer.block_head_fused_ref(*ha), 3),
                                         bound_ms=b7[0], bound_by=b7[1])
                results["K9 f32"] = dict(shape=f"B={B} D={D} I={I}, f32", library_ms=None,
                                         ms=time_ms(lambda: fused_layer.block_tail_fused(*ta)),
                                         plain_ms=time_ms(lambda: fused_layer.block_tail_fused_ref(*ta), 3),
                                         bound_ms=b9[0], bound_by=b9[1])
        results["K7 f32"]["max_abs_err"], results["K9 f32"]["max_abs_err"] = max(errs7f), max(errs9f)
        errs8 = []
        for B, S8 in ((32, 256), (8, 2048)):
            qkv = randf(B, 3 * D)
            q8, kn8, vn8 = (qkv[:, i * D : (i + 1) * D].reshape(B, H, 1, hs) for i in range(3))
            kc0, vc0 = randf(B, H, S8, hs, scale=0.5), randf(B, H, S8, hs, scale=0.5)
            full_pos = torch.randint(S8 - 1, 2 * S8, (B,), generator=gcpu).to(dev, torch.int32)
            mixed = torch.randint(0, 3 * S8, (B,), generator=gcpu)
            mixed[:4] = torch.tensor([0, S8 - 1, S8, 64])
            for pos8 in (mixed.to(dev, torch.int32), full_pos):
                kc, vc, rk, rv = kc0.clone(), vc0.clone(), kc0.clone(), vc0.clone()
                y8, _, _ = da.decode_attention_write(q8, kn8, vn8, kc, vc, pos8)
                ry8, _, _ = da.decode_attention_write_ref(q8, kn8, vn8, rk, rv, pos8)
                errs8.append(max_err32(y8, ry8, f"K8 f32 B={B} S={S8}"))
                assert torch.equal(kc, rk) and torch.equal(vc, rv), f"K8 f32 B={B} S={S8}: caches differ"
            if B == 32:
                b8 = bound_ms(2 * B * H * S8 * hs * 4 + 4 * B * D * 4 + 2 * B * D * 4 + B * 4, 4 * B * H * S8 * hs,
                              f32_peak)
                rows8 = torch.arange(B, device=dev)
                wp8 = (full_pos % S8).long()
                vis8 = (torch.arange(S8, device=dev)[None, :] <= full_pos[:, None])[:, None, None, :]

                def library_call():
                    kc[rows8, :, wp8] = kn8[:, :, 0]
                    vc[rows8, :, wp8] = vn8[:, :, 0]
                    return F.scaled_dot_product_attention(q8, kc, vc, attn_mask=vis8)

                results["K8 f32"] = dict(
                    shape=f"B={B} H={H} S={S8} hs={hs}, every row visible, f32",
                    ms=time_ms(lambda: da.decode_attention_write(q8, kn8, vn8, kc, vc, full_pos)),
                    plain_ms=time_ms(lambda: da.decode_attention_write_ref(q8, kn8, vn8, rk, rv, full_pos), 3),
                    library_ms=time_ms(library_call), bound_ms=b8[0], bound_by=b8[1])
            del kc0, vc0, kc, vc, rk, rv
        results["K8 f32"]["max_abs_err"] = max(errs8)
        log("f32 compute vs plain, 7B shapes (tolerance |err| <= 1e-4 + 1e-4 |plain|): "
            + ", ".join(f"{k} max err {results[k]['max_abs_err']:.3g}, {results[k]['ms'] * 1e3:.1f} us (plain "
                        f"{results[k]['plain_ms'] * 1e3:.1f}, bound {results[k]['bound_ms'] * 1e3:.1f} {results[k]['bound_by']})"
                        for k in ("K3 f32", "K1 f32", "K2 f32", "K7 f32", "K9 f32", "K8 f32"))
            + f"; K4 f32 at T = 128, 200 max err {k4f32_err:.3g}")

        # ---- 8i. the whole model in f32 compute: a single stream with an f32 cache
        # at S = 2048, kernel path vs plain path; then the 32-slot engine --------------
        prompt_f = torch.randint(0, cfg.vocab_size, (64,), generator=gcpu).to(dev)
        worst, got, flips = side_by_side(params, cfg32, prompt_f, 16, 2048, fused=True)
        want = dict.fromkeys(counters, 0)
        want.update({"K1": L * 15, "K2": 15, "K3": 4 * L + 1, "K4": L})
        assert got == want, f"f32 single stream: launches {got}, expected {want}"
        assert worst <= TOL_MODEL_F32, f"f32 single stream: max |dlogit| / max |logit| = {worst:.3g}"
        for key in ("K1", "K2", "K3", "K4"):
            totals[f"{key} f32"] = got[key]
        entry_inputs["f32_single_stream"] = dict(layers=L, prompt=64, new_tokens=16, S=2048, rel_logit_err=worst,
                                           argmax_flips=flips, launches=got)
        log(f"32-layer 7B int4 model, f32 compute, f32 cache S=2048 ({2 * L * H * 2048 * hs * 4 / 2**30:.2f} GiB), "
            f"prompt 64 + 16 greedy tokens, kernel vs plain path (same tokens fed): max |dlogit| / max |logit| "
            f"{worst:.3g} (limit {TOL_MODEL_F32}); argmax differs at {flips or 'no step'}; launches {got}")
        assert not flips or all(gap <= 2 * TOL_MODEL_F32 for _, gap in flips), f"f32 greedy tokens differ: {flips}"
        # the serving step in f32: 4 layers, 32 slots at their own positions, vs plain
        p4 = dict(params, h=params["h"][:4])
        c4 = cfg32.replace(n_layer=4)
        caches = {plain: llama.init_kv_cache(c4, 32, S_e, device=dev) for plain in (False, True)}
        pos32 = torch.randint(0, 2 * S_e, (32,), generator=gcpu).to(dev, torch.int32)
        tok32 = torch.randint(0, cfg.vocab_size, (32,), generator=gcpu).to(dev)
        worst = 0.0
        for step in range(4):
            lg = {plain: llama.forward(p4, tok32[:, None], c4, rope_cache=rope, slot_pos=pos32, kv_cache=caches[plain],
                                       plain=plain)[0][:, -1].float() for plain in (False, True)}
            worst = max(worst, float((lg[False] - lg[True]).abs().max() / lg[True].abs().max()))
            tok32, pos32 = lg[True].argmax(-1), pos32 + 1
        assert worst <= TOL_MODEL_F32, f"f32 serving step: max |dlogit| / max |logit| = {worst:.3g}"
        del caches, lg, p4
        engine = DecodeEngine(params, cfg32, max_batch=32, max_seq_length=S_e, steps_per_sync=8)
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        ids = [engine.submit(p, 16) for p in prompts[:32]]
        done = engine.run()
        wall = time.perf_counter() - t0
        got = {k: fn.launches for k, fn in counters.items()}
        steps = engine.decode_steps
        assert got["K7"] == got["K8"] == got["K9"] == L * steps > 0, f"f32 engine: launches {got}"
        for key in ("K7", "K8", "K9"):
            totals[f"{key} f32"] = got[key]
        n_tok = sum(len(done[i].generated) for i in ids)
        entry_inputs["f32_serving"] = dict(slots=32, requests=32, new_tokens=16, tok_s=n_tok / wall, steps=steps,
                                     step_rel_logit_err=worst)
        log(f"f32 serving: 4 layers at 32 slots kernel vs plain, 4 steps max |dlogit| / max |logit| {worst:.3g}; "
            f"the 32-layer engine (32 slots, S={S_e}, 32 requests x 16 tokens): {n_tok / wall:.1f} tok/s, launches {got}")
        del engine
        gc.collect()
        torch.cuda.empty_cache()

        totals["K3 M=1"] = k3m1_launches  # phase 7c's requests: the per-op int4 path
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
    from lit_llama_tpu_torch.data.tokenizer import Tokenizer
    from lit_llama_tpu_torch.peft import lora as lora_mod
    from lit_llama_tpu_torch.utils.convert import lora_overlay_to_sd, pytree_to_lit
    from lit_llama_tpu_torch.utils.loader import load_model

    work_e = Path(tempfile.mkdtemp(prefix="chip_smoke_entry_"))
    # a BPE tokenizer of 128 pieces; the model's vocabulary is the same 128, so
    # every id it generates decodes
    write_tokenizer(work_e / "tokenizer.model")
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

    # ---- 8d'. f32 norm weights: an f32 native checkpoint directory at 7B width
    # (2 layers; norm weights drawn, not ones, as a trained f32 checkpoint holds
    # them) through generate.base --quantize gptq.int4, which keeps the stored f32
    # norms beside bf16 compute; then K7 and K9 on them through an engine ------------
    from lit_llama_tpu_torch.utils.checkpoint import save_checkpoint

    meta_n = dict(n_layer=2, n_head=32, n_embd=4096, vocab_size=128)
    dense_n = llama.init_params(LLaMAConfig(**meta_n), torch.Generator(device=dev).manual_seed(SEED + 6), device=dev)
    gn = torch.Generator(device=dev).manual_seed(SEED + 7)
    for tree_, name in ((dense_n["h"], "rms_1"), (dense_n["h"], "rms_2"), (dense_n, "ln_f")):
        tree_[name] = 1.0 + 0.3 * torch.randn(tree_[name].shape, generator=gn, device=dev)
    save_checkpoint(work_e / "native", {"params": dense_n}, metadata={"config": meta_n})
    del dense_n
    params_n, cfg_n = load_model(work_e / "native", "gptq.int4", device=dev)
    assert params_n["h"]["rms_1"].dtype == torch.float32 and cfg_n.compute_dtype == "bfloat16"
    params_n, cfg_n = fused_layer.maybe_prepare_fused(llama.unstack_layers(params_n), cfg_n)
    assert cfg_n.rope_layout == "half", "the f32-norm model should take the fused step"
    enc = tok_e.encode("Hello, my name is")
    for fn in counters.values():
        fn.launches = 0
    want_n = gen.generate(params_n, enc, new_e4, config=cfg_n, temperature=0.0, top_k=200).tolist()
    got = {k: fn.launches for k, fn in counters.items()}
    want = dict.fromkeys(counters, 0)
    # the lm_head (4096 -> 128) is no width a multiple of 256: its plain version runs
    want.update({"K1": 2 * (new_e4 - 1), "K2": new_e4 - 1, "K3": 4 * 2, "K4": 2})
    assert got == want, f"f32-norm request: launches {got}, expected {want}"
    totals["K1 f32 norms"], totals["K2 f32 norms"] = got["K1"], got["K2"]
    cmd = [sys.executable, "-m", "lit_llama_tpu_torch.generate.base", "--checkpoint_path", str(work_e / "native"),
           "--tokenizer_path", str(work_e / "tokenizer.model"), "--quantize", "gptq.int4", "--temperature", "0",
           "--max_new_tokens", str(new_e4)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    took = time.perf_counter() - t0
    assert proc.returncode == 0, f"generate.base on the f32 native directory exited {proc.returncode}:\n{proc.stderr[-3000:]}"
    got_n = json.loads(proc.stderr.split("Token ids 1: ")[-1].splitlines()[0])
    assert got_n == want_n, f"generate.base (f32 norms): tokens {got_n} differ from the in-process generate's {want_n}"
    entry_runs["base_f32_norms"] = dict(seconds=took, new_tokens=len(got_n) - len(enc))
    # K1, K2, K7 and K9 on the f32 norm weights vs plain, at 7B shapes
    Dn, In, Hn = 4096, cfg_n.intermediate_size, 32
    lpn = params_n["h"][0]
    Sn = 2048
    rope_n = build_rope_cache(cfg_n.block_size, 128, device=dev)
    kcn, vcn = randn(1, Hn, Sn, 128, scale=0.3), randn(1, Hn, Sn, 128, scale=0.3)
    errs = []
    for pos in (0, 2047):
        x = randn(1, Dn)
        cos, sin = rope_half_row(rope_n, pos, 128)
        kv, rkv = ({"k": kcn.clone(), "v": vcn.clone()} for _ in range(2))
        out, _ = fused_layer.decode_layers_fused(x, [lpn], [kv], cos, sin, pos, pos, cfg_n)
        ref, _ = fused_layer.decode_layers_fused_ref(x, [lpn], [rkv], cos, sin, pos, pos, cfg_n)
        errs.append(max_err(out, ref, "K1"))
        max_err(kv["v"], rkv["v"], "K1 cache")
    wn = int4_bytes(Dn, 3 * Dn) + int4_bytes(Dn, Dn) + int4_bytes(Dn, 2 * In) + int4_bytes(In, Dn)
    on = 2 * (3 * Dn * Dn + Dn * Dn + 2 * In * Dn + In * Dn)
    b1 = bound_ms(wn + 2 * Dn * 4 + 2 * Dn * 2 + 2 * Hn * Sn * 128 * 2, on + 4 * Hn * Sn * 128, f32_peak)
    results["K1 f32 norms"] = dict(
        shape=f"one 7B block, S={Sn}, pos=2047, f32 rms_1/rms_2, bf16 compute", max_abs_err=max(errs),
        ms=time_ms(lambda: fused_layer.decode_layers_fused(x, [lpn], [kv], cos, sin, pos, pos, cfg_n)),
        plain_ms=time_ms(lambda: fused_layer.decode_layers_fused_ref(x, [lpn], [rkv], cos, sin, pos, pos, cfg_n), 3),
        library_ms=None, bound_ms=b1[0], bound_by=b1[1])
    del kcn, vcn, kv, rkv
    head_args = (randn(1, Dn), params_n["ln_f"], params_n["lm_head"], cfg_n)
    results["K2 f32 norms"]["max_abs_err"] = max(
        results["K2 f32 norms"]["max_abs_err"],
        max_err(fused_layer.lm_head_fused(*head_args), fused_layer.lm_head_fused_ref(*head_args), "K2"))
    Bn = 32
    xn, yn = randn(Bn, Dn), randn(Bn, Dn)
    cos, sin = slot_rope_rows(rope_n, torch.randint(0, 2048, (Bn,), generator=gcpu).to(dev, torch.int32))
    ha = (xn, lpn["rms_1"], cos, sin, lpn["attn"]["c_attn"], cfg_n)
    ta = (xn, yn, lpn["rms_2"], lpn["attn"]["c_proj"], lpn["mlp"]["c_fc12"], lpn["mlp"]["c_proj"], cfg_n)
    for key, fn_, ref_, args_, nb, ops in (
            ("K7 f32 norms", fused_layer.block_head_fused, fused_layer.block_head_fused_ref, ha,
             Bn * Dn * 2 + Dn * 4 + int4_bytes(Dn, 3 * Dn) + 2 * Bn * 128 * 4 + Bn * 3 * Dn * 2, 2 * Bn * Dn * 3 * Dn),
            ("K9 f32 norms", fused_layer.block_tail_fused, fused_layer.block_tail_fused_ref, ta,
             2 * Bn * Dn * 2 + Dn * 4 + int4_bytes(Dn, Dn) + int4_bytes(Dn, 2 * In) + int4_bytes(In, Dn) + Bn * Dn * 2,
             2 * Bn * (Dn * Dn + 2 * In * Dn + In * Dn))):
        b_ = bound_ms(nb, ops, tc_peak)
        results[key] = dict(shape=f"B={Bn} D={Dn}, f32 norm weight, bf16 compute", library_ms=None,
                            max_abs_err=max_err(fn_(*args_), ref_(*args_), key[:2]), ms=time_ms(lambda: fn_(*args_)),
                            plain_ms=time_ms(lambda: ref_(*args_), 3), bound_ms=b_[0], bound_by=b_[1])
    engine = DecodeEngine(params_n, cfg_n, max_batch=8, max_seq_length=64, steps_per_sync=4)
    for fn in counters.values():
        fn.launches = 0
    ids = [engine.submit(np.asarray(enc, np.int64)[: 3 + i], 8) for i in range(8)]
    done = engine.run()
    got = {k: fn.launches for k, fn in counters.items()}
    assert got["K7"] == got["K9"] == 2 * engine.decode_steps > 0, f"f32-norm engine: launches {got}"
    totals["K7 f32 norms"], totals["K9 f32 norms"] = got["K7"], got["K9"]
    log(f"f32 norm weights (drawn, not ones) under bf16 compute: python -m lit_llama_tpu_torch.generate.base on a "
        f"2-layer 7B-width f32 native directory with --quantize gptq.int4 exits 0 in {took:.1f} s with "
        f"{len(got_n) - len(enc)} greedy tokens equal to the in-process generate's (K1 {totals['K1 f32 norms']}, "
        f"K2 {totals['K2 f32 norms']} launches); vs plain: "
        + ", ".join(f"{k} max err {results[k]['max_abs_err']:.3g}, {results[k]['ms'] * 1e3:.1f} us"
                    for k in ("K1 f32 norms", "K2 f32 norms", "K7 f32 norms", "K9 f32 norms"))
        + f"; an 8-slot engine on them: K7 {got['K7']}, K9 {got['K9']} launches")
    del engine, params_n, lpn, ha, ta, xn, yn
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
            if M == 128 and lname == "c_fc12":
                k6m = dict(shape=f"M={M} K={K} N={N} (c_fc12, prefill)", ms=ms, library_ms=lib,
                           plain_ms=time_ms(lambda: quant_matmul.matmul_int8_ref(*args), 3),
                           bound_ms=b6[0], bound_by=b6[1], max_abs_err=errs[-1])
            if M == 200 and lname in ("c_attn", "c_fc12", "odd"):
                rows_equal(quant_matmul.matmul_int8, x, args[1:], f"K6 {lname}")
        del wd
    results["K6"] = dict(k6, max_abs_err=max(errs))
    results["K6 M>1"] = k6m

    # ---- 9b. K6 at M = 1 (gemv_int8_sm90.cuh): a decoded token's 4 L + 1 launches
    # summed beside their bound; equal bits across launches and across two streams
    # (each has its own workspace and counters); and programmatic dependent launch:
    # each K6 reads the x that the kernel launched just before it wrote (a copy into
    # the same buffer, or the K6 before it in a chain), with no synchronisation
    # between. Inputs from a generator of their own.
    m1 = {lname: k6_shapes[f"{lname} {w['qw'].shape[0]}->{w['qw'].shape[1]} M=1"] for lname, w in linears8[:5]}
    block = ("c_attn", "attn.c_proj", "c_fc12", "mlp.c_proj")
    token = {k: L * sum(m1[n][k] for n in block) + m1["lm_head"][k] for k in ("ms", "bound_ms", "library_ms")}
    entry_inputs["k6_m1_token"] = dict(token, launches=4 * L + 1, share_of_bound=token["bound_ms"] / token["ms"])
    log(f"K6 at M = 1, a decoded token's {4 * L + 1} launches: {token['ms']:.3f} ms, bound {token['bound_ms']:.3f} ms "
        f"({100 * token['bound_ms'] / token['ms']:.1f} % of it), torch.matmul on the dequantized bf16 weights "
        f"{token['library_ms']:.3f} ms")
    g9 = torch.Generator(device=dev).manual_seed(SEED + 9)
    for cdt in (torch.bfloat16, torch.float32):
        for lname, w in (("attn.c_proj", lp8["attn"]["c_proj"]), ("mlp.c_proj", lp8["mlp"]["c_proj"]), ("odd", odd8)):
            K = w["qw"].shape[0]
            x = torch.randn(1, K, generator=g9, device=dev).to(cdt)
            first = quant_matmul.matmul_int8(x, w["qw"], w["qscale"], cdt)
            assert torch.equal(first, quant_matmul.matmul_int8(x, w["qw"], w["qscale"], cdt)), \
                f"K6 M=1 {lname} {cdt}: a second launch differs"
            streams, outs = [torch.cuda.Stream(dev) for _ in range(2)], [[], []]
            torch.cuda.synchronize()
            for _ in range(4):
                for st, o in zip(streams, outs):
                    with torch.cuda.stream(st):
                        o.append(quant_matmul.matmul_int8(x, w["qw"], w["qscale"], cdt))
            torch.cuda.synchronize()
            assert all(torch.equal(first, y) for o in outs for y in o), f"K6 M=1 {lname} {cdt}: the streams differ"
        w = lp8["attn"]["c_proj"]  # square: each output can be the next input
        xbuf = torch.empty(1, D, dtype=cdt, device=dev)
        news = [torch.randn(1, D, generator=g9, device=dev).to(cdt) for _ in range(4)]
        torch.cuda.synchronize()
        outs = []
        for nx in news:
            xbuf.copy_(nx)
            outs.append(quant_matmul.matmul_int8(xbuf, w["qw"], w["qscale"], cdt))
        chain = [news[0]]
        for _ in range(4):
            chain.append(quant_matmul.matmul_int8(chain[-1], w["qw"], w["qscale"], cdt))
        torch.cuda.synchronize()
        check = max_err if cdt == torch.bfloat16 else max_err32
        for a, y in list(zip(news, outs)) + list(zip(chain, chain[1:])):
            check(y, quant_matmul.matmul_int8_ref(a, w["qw"], w["qscale"], cdt), "K6" if cdt == torch.bfloat16 else
                  "K6 f32 M=1 after the kernel that wrote its x")
    entry_inputs["k6_m1_bits_equal"] = "two launches and two streams, attn.c_proj, mlp.c_proj, odd; bf16 and f32"
    entry_inputs["k6_m1_sees_x_written_just_before"] = "a copy into x, and a chain of 4 K6 (attn.c_proj); bf16 and f32"
    log("K6 at M = 1: equal bits across two launches and two streams (attn.c_proj, mlp.c_proj, odd; bf16 and f32); "
        "each launch reads the x the kernel just before it wrote (copies, a chain of 4), within TOL['K6'] / TOL_F32")
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
            if B == 8:
                results[key].update(ms_at_b8=ms5, library_ms_at_b8=lib5, bound_ms_at_b8=b5[0])
                # a row's output is the same bits alone (B = 1) as among 8 rows: the
                # splits depend on S and hs alone
                lim = torch.tensor(limit_sets[0], dtype=torch.int32, device=dev)
                y8 = da.decode_attention(q5, k5, v5, ks5, vs5, lim)
                for b in range(B):
                    one = [t if t is None else t[b : b + 1].contiguous() for t in (q5, k5, v5, ks5, vs5)]
                    assert torch.equal(da.decode_attention(*one, lim[b : b + 1]), y8[b : b + 1]), \
                        f"K5 {cache_name}: row {b} (limit {limit_sets[0][b]}) differs at B = 1 and B = 8"
                entry_inputs.setdefault("k5_rows_equal_at_b1_and_b8", []).append(cache_name)
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
    quant_matmul.matmul_int8.launches = 0
    both = [llama.forward(params8, ref_prompt[None].to(dev), cfg8, rope_cache=rope,
                          kv_cache=llama.init_kv_cache(cfg8, 1, 16, device=dev), prefill_from_zero=True,
                          plain=plain)[0].float() for plain in (False, True)]
    k6_prefill = quant_matmul.matmul_int8.launches  # the kernel path's prefill: every K6 launch at M = 8
    assert k6_prefill == 4 * L + 1, f"int8 prefill: {k6_prefill} K6 launches, expected {4 * L + 1}"
    assert torch.isfinite(both[0]).all(), "32-layer int8 prefill: non-finite logits"
    rel = float((both[0] - both[1]).abs().max() / both[1].abs().max())
    log(f"32-layer int8 prefill (8 tokens), kernel vs plain path: max |dlogit| / max |logit| = {rel:.4g}")
    assert rel < 0.1, "32-layer int8 prefill: kernel path far from the plain path"
    del both

    new = 64
    gen.generate(params8, ref_prompt, 4, config=cfg8, temperature=0.0)  # warm-up, not counted
    torch.cuda.synchronize()
    full8 = {}
    totals.update({"K5": 0, "K5q": 0, "K6": 0, "K6 M>1": k6_prefill})
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


    # ---- 12b. f32 compute on the int8 model: K6 and K5 vs plain, then 8 layers
    # per op on an f32 cache and on an int8 cache, kernel path vs plain path --------
    cfg8f = cfg8.replace(compute_dtype="float32")

    def randf(*shape, scale=1.0):
        return (torch.randn(shape, generator=gcpu) * scale).to(dev)

    errs = []
    for lname, w in (("c_attn", lp8["attn"]["c_attn"]), ("attn.c_proj", lp8["attn"]["c_proj"]),
                     ("c_fc12", lp8["mlp"]["c_fc12"]), ("mlp.c_proj", lp8["mlp"]["c_proj"]),
                     ("lm_head", params8["lm_head"])):
        K, N = w["qw"].shape
        for M in (1, 8, 200):
            x = randf(M, K)
            args = (x, w["qw"], w["qscale"], torch.float32)
            errs.append(max_err32(quant_matmul.matmul_int8(*args), quant_matmul.matmul_int8_ref(*args),
                                  f"K6 f32 M={M} {lname}"))
        if lname == "c_fc12":
            wd = dequantize_int8(w, torch.float32)
            for M in (1, 128):
                x = randf(M, K)
                args = (x, w["qw"], w["qscale"], torch.float32)
                b6 = bound_ms(M * K * 4 + K * N + N * 4 + M * N * 4, 2 * M * K * N, f32_peak)
                row = dict(shape=f"M={M} K={K} N={N} (c_fc12), f32", ms=time_ms(lambda: quant_matmul.matmul_int8(*args)),
                           plain_ms=time_ms(lambda: quant_matmul.matmul_int8_ref(*args), 3),
                           library_ms=time_ms(lambda: torch.matmul(x, wd)), bound_ms=b6[0], bound_by=b6[1])
                if M == 1:
                    results["K6 f32"] = row
                entry_inputs[f"k6_f32_c_fc12_M{M}"] = row
            del wd
    results["K6 f32"]["max_abs_err"] = max(errs)
    errs5 = {"K5 f32": 0.0, "K5q f32": 0.0}
    S5 = 2048
    q5 = randf(1, 1, H, hs).transpose(1, 2)
    kf, vf = randf(1, H, S5, hs, scale=0.5), randf(1, H, S5, hs, scale=0.5)
    (kq, ksc), (vq, vsc) = llama._quantize_kv(kf), llama._quantize_kv(vf)
    every_row = torch.full((1,), S5 - 1, dtype=torch.int32, device=dev)
    vis5 = (torch.arange(S5, device=dev)[None, :] <= every_row[:, None])[:, None, None, :]
    for key, (k5, v5, ks5, vs5) in (("K5 f32", (kf, vf, None, None)), ("K5q f32", (kq, vq, ksc, vsc))):
        for lims in ([0], [S5 // 2 + 7], [S5 - 1], [S5 + 5]):
            lim = torch.tensor(lims, dtype=torch.int32, device=dev)
            errs5[key] = max(errs5[key], max_err32(da.decode_attention(q5, k5, v5, ks5, vs5, lim),
                                                   da.decode_attention_ref(q5, k5, v5, ks5, vs5, lim), key))
        quant = ks5 is not None
        nbytes = 2 * H * S5 * hs * (1 if quant else 4) + (2 * H * S5 * 4 if quant else 0) + 2 * H * hs * 4 + 4
        b5 = bound_ms(nbytes, 4 * H * S5 * hs, f32_peak)
        kd, vd = ((kq.float() * ksc), (vq.float() * vsc)) if quant else (kf, vf)
        results[key] = dict(
            shape=f"B=1 H={H} S={S5} hs={hs}, f32 q, {'int8' if quant else 'f32'} cache, every row visible",
            ms=time_ms(lambda: da.decode_attention(q5, k5, v5, ks5, vs5, every_row)),
            plain_ms=time_ms(lambda: da.decode_attention_ref(q5, k5, v5, ks5, vs5, every_row), 3),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(q5, kd, vd, attn_mask=vis5)),
            bound_ms=b5[0], bound_by=b5[1], max_abs_err=errs5[key])
        del kd, vd
    del kf, vf, kq, vq, ksc, vsc, k5, v5, ks5, vs5
    p8l = dict(params8, h=params8["h"][:8])
    runs8 = {}
    for kvd in (None, "int8"):
        c8l = cfg8f.replace(n_layer=8, kv_cache_dtype=kvd)
        prompt_f = torch.randint(0, cfg8.vocab_size, (64,), generator=gcpu).to(dev)
        worst, got, flips = side_by_side(p8l, c8l, prompt_f, 16, 2048, fused=False)
        want = dict.fromkeys(counters, 0)
        want.update({"K4": 8, "K5": 8 * 15, "K6": (4 * 8 + 1) * 16})
        assert got == want, f"f32 int8 per-op, {kvd or 'f32'} cache: launches {got}, expected {want}"
        # on the int8 cache each path quantizes its own new k/v rows: f32 sums in
        # another order move a value across a rounding midpoint now and then, and
        # that entry then differs by one int8 step (1/127 of its row's largest),
        # so this run is held to the bf16 model tolerance, the f32 cache to f32's
        tol = TOL_MODEL[1] if kvd else TOL_MODEL_F32
        assert worst <= tol, f"f32 int8 per-op, {kvd or 'f32'} cache: rel logit err {worst:.3g} > {tol}"
        assert not flips or all(gap <= 2 * tol for _, gap in flips), f"f32 int8 tokens differ: {flips}"
        totals["K5q f32" if kvd else "K5 f32"] = got["K5"]
        totals["K6 f32"] = totals.get("K6 f32", 0) + got["K6"]
        runs8[kvd or "f32"] = dict(rel_logit_err=worst, argmax_flips=flips, launches=got)
    entry_inputs["f32_int8_per_op"] = runs8
    del p8l
    log("f32 compute on the int8 model vs plain: "
        + ", ".join(f"{k} max err {results[k]['max_abs_err']:.3g}, {results[k]['ms'] * 1e3:.1f} us (plain "
                    f"{results[k]['plain_ms'] * 1e3:.1f}, library {results[k]['library_ms'] * 1e3:.1f}, bound "
                    f"{results[k]['bound_ms'] * 1e3:.1f} {results[k]['bound_by']})" for k in ("K6 f32", "K5 f32", "K5q f32"))
        + f"; K6 f32 at M=128 (c_fc12) {entry_inputs['k6_f32_c_fc12_M128']['ms'] * 1e3:.1f} us, torch.matmul f32 "
        f"{entry_inputs['k6_f32_c_fc12_M128']['library_ms'] * 1e3:.1f} us; 8 layers per op, prompt 64 + 16 tokens, S=2048: "
        + ", ".join(f"{k} cache max |dlogit| / max |logit| {r['rel_logit_err']:.3g}, flips {r['argmax_flips'] or 'none'}"
                    for k, r in runs8.items()))

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
    # the training micro-batch, (2, 32, 2048): held and timed beside B = 1
    # (inputs from a generator of their own, as K4's at T = 2048 in phase 3)
    g10 = torch.Generator().manual_seed(SEED + 2)
    q, k, v, do = (torch.randn((2, H, 2048, hs), generator=g10).to(dev, torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_attention(q, k, v)
    got = fa.flash_attention_backward(q, k, v, o, lse, do)
    want = fa.flash_attention_bwd_ref(q, k, v, o, lse, do)
    again = fa.flash_attention_backward(q, k, v, o, lse, do)
    for name, g, w, a in zip(("dq", "dk", "dv"), got, want, again):
        errs10[name] = max(errs10[name], k10_err(g, w, f"K10 {name} (B, H, T) = {(2, H, 2048)}")[0])
        assert torch.equal(g, a), f"K10 {name} at B = 2: two runs differ (the kernels use no atomics)"
    nrow, pairs = 2 * H * 2048, 2 * H * 2048 * 2049 // 2
    b_dq = bound_ms(5 * nrow * hs * 2 + nrow * 4 + nrow * hs * 2 + nrow * 4, 3 * 2 * hs * pairs, tc_peak)
    b_dkv = bound_ms(4 * nrow * hs * 2 + 2 * nrow * 4 + 2 * nrow * hs * 2, 4 * 2 * hs * pairs, tc_peak)
    dq, dd = fa.flash_backward_dq(q, k, v, o, lse, do)
    ms_dq = time_ms(lambda: fa.flash_backward_dq(q, k, v, o, lse, do))
    ms_dkv = time_ms(lambda: fa.flash_backward_dkv(q, k, v, do, lse, dd))
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    lib10 = time_ms(lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), do, retain_graph=True))
    log(f"K10 at (B, H, T, hs) = {(2, H, 2048, hs)}: dq {ms_dq * 1e3:.1f} us (bound {b_dq[0] * 1e3:.1f}), dkv "
        f"{ms_dkv * 1e3:.1f} us (bound {b_dkv[0] * 1e3:.1f}); SDPA causal backward {lib10 * 1e3:.1f} us; held "
        f"row by row, a second run identical")
    results["K10dq"].update(ms_at_b2=ms_dq, bound_ms_at_b2=b_dq[0], library_ms_at_b2=lib10)
    results["K10dkv"].update(ms_at_b2=ms_dkv, bound_ms_at_b2=b_dkv[0], library_ms_at_b2=lib10)
    del q, k, v, do, o, lse, got, want, again, dq, dd, qs, ks, vs, sdpa_out
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

    # ---- 14b. f32 compute: K4 and K10 vs plain at (1, 32, 2048, 128), then one
    # training step at the phase-15 width, 2 layers, kernel path vs plain path ------
    T = 2048
    q, k, v, do = (randf(1, H, T, hs) for _ in range(4))
    o, lse = fa.flash_attention(q, k, v)
    ro, rlse = fa.flash_attention_ref(q, k, v)
    err4 = max_err32(o, ro, "K4 f32")
    max_err32(lse, rlse, "K4 f32 lse")
    got = fa.flash_attention_backward(q, k, v, ro, rlse, do)
    want = fa.flash_attention_bwd_ref(q, k, v, ro, rlse, do)
    errs = [max_err32(g, w, f"K10 {n} f32") for n, g, w in zip(("dq", "dk", "dv"), got, want)]
    nrow, pairs = H * T, H * T * (T + 1) // 2
    b4 = bound_ms(4 * nrow * hs * 4 + nrow * 4, 4 * hs * pairs, f32_peak)
    b_dq = bound_ms(5 * nrow * hs * 4 + nrow * 4 + nrow * hs * 4 + nrow * 4, 3 * 2 * hs * pairs, f32_peak)
    b_dkv = bound_ms(4 * nrow * hs * 4 + 2 * nrow * 4 + 2 * nrow * hs * 4, 4 * 2 * hs * pairs, f32_peak)
    dq, dd = fa.flash_backward_dq(q, k, v, ro, rlse, do)
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    lib10 = time_ms(lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), do, retain_graph=True), 5)
    plain10 = time_ms(lambda: fa.flash_attention_bwd_ref(q, k, v, ro, rlse, do), 3)
    shape = f"B=1 H={H} T={T} hs={hs}, f32"
    results["K4 f32"] = dict(shape=shape, ms=time_ms(lambda: fa.flash_attention(q, k, v), 5),
                             plain_ms=time_ms(lambda: fa.flash_attention_ref(q, k, v), 3),
                             library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 5),
                             bound_ms=b4[0], bound_by=b4[1], max_abs_err=max(err4, entry_inputs["k4_f32_err_t128_t200"]))
    results["K10dq f32"] = dict(shape=shape, ms=time_ms(lambda: fa.flash_backward_dq(q, k, v, ro, rlse, do), 5),
                                plain_ms=plain10, library_ms=lib10, bound_ms=b_dq[0], bound_by=b_dq[1],
                                max_abs_err=errs[0])
    results["K10dkv f32"] = dict(shape=shape, ms=time_ms(lambda: fa.flash_backward_dkv(q, k, v, do, rlse, dd), 5),
                                 plain_ms=plain10, library_ms=lib10, bound_ms=b_dkv[0], bound_by=b_dkv[1],
                                 max_abs_err=max(errs[1:]))
    del q, k, v, do, o, lse, ro, rlse, got, want, dq, dd, qs, ks, vs, sdpa_out
    c14f = cfgt.replace(n_layer=2, compute_dtype="float32")
    p14 = llama.init_params(c14f, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    leaves = step_lib.tree_leaves(p14)
    for t in leaves.values():
        t.requires_grad_(True)
    grads, losses = {}, {}
    for plain in (False, True):
        for fn in counters.values():
            fn.launches = 0
        fa.flash_backward_dq.launches = fa.flash_backward_dkv.launches = 0
        loss = step_lib.loss_fn(p14, ids14[0], tgt14[0], c14f, remat=True, remat_policy="dots", plain=plain)
        grads[plain] = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        torch.cuda.synchronize()
        losses[plain] = float(loss.detach())
        if not plain:
            n3 = (fa.flash_attention.launches, fa.flash_backward_dq.launches, fa.flash_backward_dkv.launches)
            assert n3 == (4, 2, 2), f"f32 training step: K4/K10 launches {n3}, expected (4, 2, 2)"
        del loss
    gerr = {n: float((g - grads[True][n]).abs().max() / grads[True][n].abs().max()) for n, g in grads[False].items()}
    assert all(e <= TOL_MODEL_F32 for e in gerr.values()), f"f32 training grads: {gerr}"
    assert abs(losses[False] - losses[True]) <= 1e-5 * abs(losses[True]), f"f32 training loss {losses}"
    totals["K4 f32"] += 4
    totals["K10dq f32"], totals["K10dkv f32"] = 2, 2
    entry_inputs["f32_training_step"] = dict(losses=losses, grad_rel_err=gerr)
    log("f32 compute, K4 and K10 at (1, 32, 2048, 128) vs plain: "
        + ", ".join(f"{k} max err {results[k]['max_abs_err']:.3g}, {results[k]['ms'] * 1e3:.1f} us (plain "
                    f"{results[k]['plain_ms'] * 1e3:.1f}, SDPA f32 {results[k]['library_ms'] * 1e3:.1f}, bound "
                    f"{results[k]['bound_ms'] * 1e3:.1f} {results[k]['bound_by']})"
                    for k in ("K4 f32", "K10dq f32", "K10dkv f32"))
        + f"; 2-layer 7B-width training forward + backward in f32 (T=2048, remat dots), kernel vs plain: loss "
        f"{losses[False]:.6f} vs {losses[True]:.6f}, per leaf max |dgrad| / max |grad| up to {max(gerr.values()):.3g}")
    for t in leaves.values():
        t.requires_grad_(False)
    del p14, leaves, grads
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
    totals["K4 T2048"] = got["K4"]  # every K4 launch of training is at T = 2048
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

    # ---- 17. head sizes past 128: K4, K5 and K10 vs plain at (1, 16, 2048, 256) and,
    # on the chunked kernels, (1, 8, 1024, 384) and (1, 8, 1024, 512), then for each a
    # 2-layer model (16 heads of 256, 8 of 384 or 512): prefill, per-op decode and a
    # training step through the kernels --------------------------------------------
    for hse, He, Te, D_e in ((256, 16, 2048, 4096), (384, 8, 1024, 3072), (512, 8, 1024, 4096)):
        Be, hk = 1, f"hs{hse}"
        nrow, pairs = Be * He * Te, Be * He * Te * (Te + 1) // 2
        for dt in (torch.bfloat16, torch.float32):
            f32 = dt == torch.float32
            q, k, v, do = ((torch.randn((Be, He, Te, hse), generator=gcpu)).to(dev, dt) for _ in range(4))
            o, lse = fa.flash_attention(q, k, v)
            ro, rlse = fa.flash_attention_ref(q, k, v)
            e4 = max_err32(o, ro, f"K4 {hk} f32") if f32 else max_err(o, ro, f"K4 {hk}")
            max_err32(lse, rlse, f"K4 {hk} lse")
            got = fa.flash_attention_backward(q, k, v, o, lse, do)
            want = fa.flash_attention_bwd_ref(q, k, v, o, lse, do)
            e10 = [max_err32(g, w, f"K10 {n} {hk} f32") if f32 else k10_err(g, w, f"K10 {n} {hk}")[0]
                   for n, g, w in zip(("dq", "dk", "dv"), got, want)]
            q5 = q[:, :, -1:].contiguous()
            kc5, vc5 = k * 0.5, v * 0.5
            e5 = 0.0
            for lims in ([0], [Te // 2 + 7], [Te - 1], [Te + 5]):
                lim = torch.tensor(lims, dtype=torch.int32, device=dev)
                g5 = da.decode_attention(q5, kc5, vc5, None, None, lim)
                w5 = da.decode_attention_ref(q5, kc5, vc5, None, None, lim)
                e5 = max(e5, max_err32(g5, w5, f"K5 {hk} f32") if f32 else max_err(g5, w5, f"K5 {hk}"))
            log(f"head size {hse}, {'f32' if f32 else 'bf16'}, at ({Be}, {He}, {Te}, {hse}) vs plain: K4 max err "
                f"{e4:.3g}, K10 dq/dk/dv {e10[0]:.3g}/{e10[1]:.3g}/{e10[2]:.3g}, K5 {e5:.3g}")
            if f32 and hse == 256:  # K4's FFMA body at its second head size
                b4 = bound_ms(4 * nrow * hse * 4 + nrow * 4, 4 * hse * pairs, f32_peak)
                k4f = entry_inputs["k4_f32_hs256"] = dict(
                    shape=f"B={Be} H={He} T={Te} hs={hse}, f32", max_abs_err=e4,
                    ms=time_ms(lambda: fa.flash_attention(q, k, v), 5),
                    plain_ms=time_ms(lambda: fa.flash_attention_ref(q, k, v), 3),
                    library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 5),
                    bound_ms=b4[0], bound_by=b4[1])
                log(f"head size 256, f32, K4 timed: {k4f['ms'] * 1e3:.1f} us (plain {k4f['plain_ms'] * 1e3:.1f}, "
                    f"SDPA f32 {k4f['library_ms'] * 1e3:.1f}, bound {k4f['bound_ms'] * 1e3:.1f} {k4f['bound_by']})")
            if f32:
                continue
            es = 2  # bytes of an element
            peak = tc_peak  # bf16 products on the tensor cores
            b4 = bound_ms(4 * nrow * hse * es + nrow * 4, 4 * hse * pairs, peak)
            b_dq = bound_ms(5 * nrow * hse * es + nrow * 4 + nrow * hse * es + nrow * 4, 3 * 2 * hse * pairs, peak)
            b_dkv = bound_ms(4 * nrow * hse * es + 2 * nrow * 4 + 2 * nrow * hse * es, 4 * 2 * hse * pairs, peak)
            b5 = bound_ms(2 * He * Te * hse * es + 2 * He * hse * es + 4, 4 * He * Te * hse, f32_peak)
            dq, dd = fa.flash_backward_dq(q, k, v, o, lse, do)
            qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
            sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
            lib10 = time_ms(lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), do, retain_graph=True), 5)
            plain10 = time_ms(lambda: fa.flash_attention_bwd_ref(q, k, v, o, lse, do), 3)
            shape = f"B={Be} H={He} T={Te} hs={hse}"
            all_rows = torch.full((1,), Te - 1, dtype=torch.int32, device=dev)
            results[f"K4 {hk}"] = dict(
                shape=shape, ms=time_ms(lambda: fa.flash_attention(q, k, v), 5),
                plain_ms=time_ms(lambda: fa.flash_attention_ref(q, k, v), 3),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 5),
                bound_ms=b4[0], bound_by=b4[1], max_abs_err=e4)
            results[f"K10dq {hk}"] = dict(shape=shape, ms=time_ms(lambda: fa.flash_backward_dq(q, k, v, o, lse, do), 5),
                                          plain_ms=plain10, library_ms=lib10, bound_ms=b_dq[0], bound_by=b_dq[1],
                                          max_abs_err=e10[0])
            results[f"K10dkv {hk}"] = dict(shape=shape,
                                           ms=time_ms(lambda: fa.flash_backward_dkv(q, k, v, do, lse, dd), 5),
                                           plain_ms=plain10, library_ms=lib10, bound_ms=b_dkv[0], bound_by=b_dkv[1],
                                           max_abs_err=max(e10[1:]))
            results[f"K5 {hk}"] = dict(
                shape=f"B=1 H={He} S={Te} hs={hse}, bf16 cache, every row visible",
                ms=time_ms(lambda: da.decode_attention(q5, kc5, vc5, None, None, all_rows)),
                plain_ms=time_ms(lambda: da.decode_attention_ref(q5, kc5, vc5, None, None, all_rows), 3),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(q5, kc5, vc5)),
                bound_ms=b5[0], bound_by=b5[1], max_abs_err=e5)
            log(f"head size {hse}, bf16, timed: " + ", ".join(
                f"{key} {results[key]['ms'] * 1e3:.1f} us (plain {results[key]['plain_ms'] * 1e3:.1f}, library "
                f"{results[key]['library_ms'] * 1e3:.1f}, bound {results[key]['bound_ms'] * 1e3:.1f} "
                f"{results[key]['bound_by']})" for key in (f"K4 {hk}", f"K10dq {hk}", f"K10dkv {hk}", f"K5 {hk}")))
            del dq, dd, qs, ks, vs, sdpa_out
        del q, k, v, do, o, lse, ro, rlse, got, want, q5, kc5, vc5
        ce = LLaMAConfig(n_layer=2, n_head=D_e // hse, n_embd=D_e, param_dtype="bfloat16", compute_dtype="bfloat16")
        assert ce.head_size == hse
        pe = llama.unstack_layers(llama.init_params(ce, torch.Generator(device=dev).manual_seed(SEED + 8), device=dev))
        worst, got, flips = side_by_side(pe, ce, torch.randint(0, ce.vocab_size, (64,), generator=gcpu).to(dev),
                                         8, 128, fused=False)
        want = dict.fromkeys(counters, 0)
        want.update({"K4": 2, "K5": 2 * 7})
        assert got == want, f"head size {hse} model: launches {got}, expected {want}"
        assert worst <= TOL_MODEL[1], f"head size {hse} model: max |dlogit| / max |logit| {worst:.3g}"
        totals[f"K4 {hk}"], totals[f"K5 {hk}"] = got["K4"], got["K5"]
        pes = llama.init_params(ce, torch.Generator(device=dev).manual_seed(SEED + 8), device=dev)
        toks_e = torch.randint(0, ce.vocab_size, (1, 513), generator=gcpu).to(dev)
        leaves = step_lib.tree_leaves(pes)
        for t in leaves.values():
            t.requires_grad_(True)
        grads = {}
        for plain in (False, True):
            fa.flash_attention.launches = fa.flash_backward_dq.launches = fa.flash_backward_dkv.launches = 0
            loss = step_lib.loss_fn(pes, toks_e[:, :-1], toks_e[:, 1:], ce, remat=True, remat_policy="dots",
                                    plain=plain)
            grads[plain] = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            torch.cuda.synchronize()
            if not plain:
                n3 = (fa.flash_attention.launches, fa.flash_backward_dq.launches, fa.flash_backward_dkv.launches)
                assert n3 == (4, 2, 2), f"head size {hse} training step: K4/K10 launches {n3}, expected (4, 2, 2)"
            del loss
        gerr = {n: float((g - grads[True][n]).norm() / grads[True][n].norm()) for n, g in grads[False].items()}
        assert all(e <= TOL_TRAIN_GRAD["rms"] for e in gerr.values()), f"head size {hse} grads: {gerr}"
        totals[f"K4 {hk}"] += 4
        totals[f"K10dq {hk}"], totals[f"K10dkv {hk}"] = 2, 2
        entry_inputs[f"head_size_{hse}_model"] = dict(rel_logit_err=worst, argmax_flips=flips, launches=got,
                                                      grad_rms_err=gerr)
        log(f"2-layer model with {ce.n_head} heads of {hse} (n_embd {D_e}), bf16: prompt 64 + 8 greedy tokens per "
            f"op, kernel vs plain path max |dlogit| / max |logit| {worst:.3g}, flips {flips or 'none'}, launches "
            f"{got}; a training forward + backward at T=512: per leaf RMS(dgrad) / RMS(grad) up to "
            f"{max(gerr.values()):.3g}")
        for t in leaves.values():
            t.requires_grad_(False)
        del pe, pes, leaves, grads
        gc.collect()
        torch.cuda.empty_cache()

    # ---- 18. routing: where the JAX package's shape gate leaves Pallas, the plain
    # version runs, decided before any launch ----------------------------------------
    from lit_llama_tpu_torch.ops.attention import flash_route
    from lit_llama_tpu_torch.ops.decode_attention import decode_route
    from lit_llama_tpu_torch.ops.quant_matmul import quant_route

    routing = {}
    # f1: 4 layers, 16 heads of 64 (n_embd 1024), bf16 dense: no attention kernel
    cf1 = LLaMAConfig(n_layer=4, n_head=16, n_embd=1024, param_dtype="bfloat16", compute_dtype="bfloat16")
    assert not flash_route(64, 64, cf1.head_size, True) and not decode_route(cf1.head_size)
    pf1 = llama.unstack_layers(llama.init_params(cf1, torch.Generator(device=dev).manual_seed(SEED + 9), device=dev))
    prompt = torch.randint(0, cf1.vocab_size, (1, 64), generator=gcpu).to(dev)
    caches = {plain: llama.init_kv_cache(cf1, 1, 128, device=dev) for plain in (False, True)}
    for fn in counters.values():
        fn.launches = 0
    lg = {plain: llama.forward(pf1, prompt, cf1, kv_cache=caches[plain], prefill_from_zero=True, plain=plain)[0]
          for plain in (False, True)}
    equal = torch.equal(lg[False], lg[True])
    tok = lg[False][:, -1].argmax(-1)
    for step in range(4):
        lg = {plain: llama.forward(pf1, tok[None], cf1, input_pos=[64 + step], kv_cache=caches[plain],
                                   plain=plain)[0] for plain in (False, True)}
        equal = equal and torch.equal(lg[False], lg[True])
        tok = lg[False][:, -1].argmax(-1)
    got = {k: fn.launches for k, fn in counters.items()}
    assert equal, "head size 64: the kernel path's logits differ from the plain path's"
    assert all(v == 0 for v in got.values()), f"head size 64: launches {got}, expected none"
    routing["hs64_dense"] = dict(logits_equal=True, launches=got)
    del pf1, caches, lg
    # f2: int4, 3 heads of 128 (n_embd 384, gs 64): no width a multiple of 256
    cf2 = LLaMAConfig(n_layer=4, n_head=3, n_embd=384, vocab_size=1000, param_dtype="bfloat16",
                      compute_dtype="bfloat16", quantize="int4", quant_groupsize=64)
    assert not quant_route(cf2.n_embd, 3 * cf2.n_embd) and not quant_route(cf2.intermediate_size, cf2.n_embd)
    pf2, cf2p = fused_layer.maybe_prepare_fused(
        llama.unstack_layers(random_int4_params(cf2, seed=SEED + 11, device=dev)), cf2)
    prompt = torch.randint(0, cf2.vocab_size, (64,), generator=gcpu).to(dev)
    worst, got, flips = side_by_side(pf2, cf2p, prompt, 16, 128, fused=cf2p.rope_layout == "half")
    assert got["K3"] == got["K5"] == got["K6"] == 0 and got["K4"] == cf2.n_layer, f"widths 384/1152: launches {got}"
    assert worst <= TOL_MODEL[1], f"widths 384/1152: max |dlogit| / max |logit| {worst:.3g}"
    routing["int4_width_384"] = dict(rel_logit_err=worst, flips=flips, launches=got)
    del pf2
    # f3: int4 at 7B width, 2 layers, gs 32: K3 takes groups that split its 64-row k-step
    cf3 = LLaMAConfig.from_name("7B", n_layer=2, param_dtype="bfloat16", compute_dtype="bfloat16", quantize="int4",
                                quant_groupsize=32)
    pf3 = llama.unstack_layers(random_int4_params(cf3, seed=SEED + 12, device=dev))
    assert not fused_layer.fused_layer_supported(cf3, pf3)  # K1 takes gs 64, 128, 256: decode per op
    worst, got, flips = side_by_side(pf3, cf3, torch.randint(0, cf3.vocab_size, (64,), generator=gcpu).to(dev), 8,
                                     128, fused=False)
    want = dict.fromkeys(counters, 0)
    want.update({"K3": (4 * 2 + 1) * 8, "K4": 2, "K5": 2 * 7})
    assert got == want, f"gs 32: launches {got}, expected {want}"
    assert worst <= TOL_MODEL[1], f"gs 32: max |dlogit| / max |logit| {worst:.3g}"
    totals["K3 gs=32"] = got["K3"]
    routing["int4_gs32"] = dict(rel_logit_err=worst, flips=flips, launches=got)
    w3 = pf3["h"][0]["mlp"]["c_fc12"]
    K3_, N3_ = 2 * w3["qw"].shape[0], w3["qw"].shape[1]
    x3 = randn(128, K3_)
    args3 = (x3, w3["qw"], w3["qscale"], w3["qzero"])
    wd3 = dequantize_int4(w3, torch.bfloat16)
    b3 = bound_ms(128 * K3_ * 2 + int4_bytes(K3_, N3_, 32) + 128 * N3_ * 2, 2 * 128 * K3_ * N3_, tc_peak)
    results["K3 gs=32"] = dict(shape=f"M=128 K={K3_} N={N3_} (c_fc12), gs 32",
                               max_abs_err=max_err(quant_matmul.matmul_int4(*args3), quant_matmul.matmul_int4_ref(*args3), "K3"),
                               ms=time_ms(lambda: quant_matmul.matmul_int4(*args3)),
                               plain_ms=time_ms(lambda: quant_matmul.matmul_int4_ref(*args3), 3),
                               library_ms=time_ms(lambda: torch.matmul(x3, wd3)), bound_ms=b3[0], bound_by=b3[1])
    x3 = randn(200, K3_)  # M = 200: every row of a 200-token tile, each scale row of a k-step its own
    args3 = (x3, w3["qw"], w3["qscale"], w3["qzero"])
    e200 = max_err(quant_matmul.matmul_int4(*args3), quant_matmul.matmul_int4_ref(*args3), "K3")
    rows_equal(quant_matmul.matmul_int4, x3, args3[1:], "K3 c_fc12 gs 32")
    b200 = bound_ms(200 * K3_ * 2 + int4_bytes(K3_, N3_, 32) + 200 * N3_ * 2, 2 * 200 * K3_ * N3_, tc_peak)
    k3_shapes[f"c_fc12 gs 32 {K3_}->{N3_} M=200"] = dict(
        ms=time_ms(lambda: quant_matmul.matmul_int4(*args3)), bound_ms=b200[0], bound_by=b200[1],
        library_ms=time_ms(lambda: torch.matmul(x3, wd3)), max_abs_err=e200)
    log("K3 gs 32, M=200 c_fc12: " + ", ".join(f"{k} {v * 1e3:.1f} us" for k, v in
                                             k3_shapes[f"c_fc12 gs 32 {K3_}->{N3_} M=200"].items()
                                             if k.endswith("ms")))
    del pf3, wd3, x3, args3, w3
    entry_inputs["routing"] = routing
    log(f"routing: head size 64 (dense, 4 layers): logits equal to the plain path's bit for bit, launches "
        f"{routing['hs64_dense']['launches']}; int4 at widths 384/1152/1024 (4 layers): K3 {routing['int4_width_384']['launches']['K3']}, "
        f"K4 {routing['int4_width_384']['launches']['K4']}, K1 {routing['int4_width_384']['launches']['K1']} launches, "
        f"max |dlogit| / max |logit| {routing['int4_width_384']['rel_logit_err']:.3g}; int4 gs 32 at 7B width: K3 "
        f"{totals['K3 gs=32']} launches, K3 at M=128 {results['K3 gs=32']['ms'] * 1e3:.1f} us vs plain max err "
        f"{results['K3 gs=32']['max_abs_err']:.3g}")
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 19-21. instruction finetuning: one step per PEFT mode kernel vs plain path,
    # K4/K10 at the finetuning shape, the finetuning body at 7B width (LoRA, Adapter
    # v1 and v2 at 16 layers, full at 8), the entry points in subprocesses ----------
    import tempfile

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_finetune_"))
    finetuning = finetune_phases(dev, counters, time_ms, bound_ms, tc_peak, results, totals, work=work)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 22-24. GPTQ at 7B width (kernel path against plain path, with and without
    # actorder, then spilling), perplexity of the 7B model dense / int4 / int8, and
    # quantize -> evaluate -> generate with the evaluate.* entry points in subprocesses
    entries = finetuning["entry_points"]
    gptq_eval = gptq_phases(dev, counters, time_ms, bound_ms, tc_peak, f32_peak, results, totals,
                            work / "tokenizer.model", work / "entry",
                            {m: Path(entries[m]["checkpoint"]) for m in ("lora", "adapter")})

    # ---- 25-28. the entry points that read published checkpoints, serve over HTTP,
    # train a tokenizer and pretrain on it, merge a LoRA and prepare data: Meta and
    # HF conversions at 7B width, 64 requests through the HTTP server (in process and
    # as a subprocess), prepare_shakespeare and pretrain.shakespeare, the LoRA merge
    entry_points, pth25 = entry_point_phases(dev, counters, totals, work / "entry_points", work / "entry",
                                             Path(entries["lora"]["checkpoint"]), work / "tokenizer.model")
    # ---- 29-31. tensor- and data-parallel inference: two ranks as processes on
    # the one card over gloo (TP at mp = 2, DP at dp = 2, the entry points under torchrun)
    parallel, par_kernels = parallel_phases(dev, smi, phase8["tokens"], phase8["prompts"], pth25,
                                            work / "tokenizer.model", work / "parallel")
    gc.collect()
    torch.cuda.empty_cache()
    # ---- 32-34. training across ranks: DP, FSDP and TP steps of two ranks on the
    # one card over gloo, then finetune.lora and pretrain.shakespeare under torchrun
    train_parallel, train_par_kernels = train_parallel_phases(dev, smi, pth25, work / "tokenizer.model",
                                                              work / "train_parallel")
    par_kernels.update(train_par_kernels)
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
        "K7": ("block_head_fused (rows_prep_kernel, rows_sm90_kernel)", "lit_llama_tpu/ops/fused_layer.py:956"),
        "K7 LoRA": ("block_head_fused with the LoRA operand (lora_down_kernel on every SM, the update in "
                    "rows_sm90_kernel's epilogue)", "lit_llama_tpu/ops/fused_layer.py:970"),
        "K8": ("decode_attention_write_pipelined", "lit_llama_tpu/ops/decode_attention.py:473"),
        "K8b": ("decode_attention_write_pallas", "lit_llama_tpu/ops/decode_attention.py:226"),
        "K9": ("block_tail_fused (rows_prep_kernel x 2, rows_sm90_kernel x 3, chained by programmatic dependent "
               "launch)", "lit_llama_tpu/ops/fused_layer.py:981"),
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
    # bf16 at head size 128 runs on the Hopper kernels flash_attention.cu includes
    hopper = {"K4": "flash_sm90.cuh", "K4 T2048": "flash_sm90.cuh", "K10dq": "flash_sm90.cuh",
              "K10dkv": "flash_sm90.cuh", "K5": "decode_sm90.cuh", "K5q": "decode_sm90.cuh", "K2": "gemv_sm90.cuh",
              "K4 T256": "flash_sm90.cuh", "K10dq T256": "flash_sm90.cuh", "K10dkv T256": "flash_sm90.cuh",
              "K3 M2048": "gemm_sm90.cuh", "K6 M2048": "gemm_sm90.cuh", "K3 f32 M8192": "gemm_f32.cuh",
              "K3 f32": "gemm_f32.cuh", "K6": "gemv_int8_sm90.cuh", "K6 f32": "gemv_int8_sm90.cuh",
              "K3 M=1": "gemv4_sm90.cuh"}
    totals["K8b"] = totals["K8"]  # one CUDA kernel and one counter stand behind both entries
    # the inputs each entry takes beyond the bf16, head size 128, 64-slot, 64-column
    # case: each variant's launches are its wrapper's count on a path that runs only
    # that variant (the 128-slot engine, the f32 paths, the head size 256 model, ...)
    variants = ["K4 T2048", "K7 B>64", "K9 B>64", "K1 LoRA R8=128", "K1 LoRA R8=128 f32", "K7 LoRA R8=128",
                "K7 LoRA R8=128 f32", "K1 f32 norms", "K2 f32 norms", "K7 f32 norms", "K9 f32 norms", "K1 f32",
                "K2 f32", "K3 f32", "K4 f32", "K5 f32", "K5q f32", "K6 f32", "K7 f32", "K8 f32", "K9 f32",
                "K10dq f32", "K10dkv f32", "K4 hs256", "K5 hs256", "K10dq hs256", "K10dkv hs256", "K4 hs384",
                "K5 hs384", "K10dq hs384", "K10dkv hs384", "K4 hs512", "K5 hs512", "K10dq hs512", "K10dkv hs512",
                "K3 gs=32", "K3 M=1", "K6 M>1", "K4 T256", "K10dq T256", "K10dkv T256", "K3 f32 M8192", "K4 f32 B4 T2048",
                "K3 M2048", "K6 M2048"]
    for key in list(sources) + variants:
        base = next(b for b in ("K1 LoRA", "K7 LoRA", key.split()[0]) if key.startswith(b))
        r = results[key]
        kernels.append({
            "name": f"{labels.get(base, base)}{key[len(base):]} "
                    + (sources[base][0] if key == base else sources[base][0].split(" (")[0]), "route": "cuda",
            "source": f"lit_llama_tpu_torch/csrc/{hopper.get(key, files[base])}", "replaces": sources[base][1],
            "launches": totals[key], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
            **{k: r[k] for k in ("ms_without_operand", "ms_at_b64", "ms_at_b2", "library_ms_at_b2", "bound_ms_at_b2",
                                 "ms_at_b8", "library_ms_at_b8", "bound_ms_at_b8")
               if k in r},
        })
    # phases 29-31: each kernel at the local shapes a rank gives it
    par_sources = {"K3 TP": "gemv4_sm90.cuh", "K6 TP": "gemv_int8_sm90.cuh", "K4 TP": "flash_sm90.cuh",
                   "K5 TP": "decode_sm90.cuh", "K3 DP": "gemm_sm90.cuh", "K7 DP": "serve_layer.cu",
                   "K8 DP": "decode_attention.cu", "K9 DP": "serve_layer.cu", "K4 DP": "flash_sm90.cuh",
                   "K10dq DP": "flash_sm90.cuh", "K10dkv DP": "flash_sm90.cuh", "K4 TP-train": "flash_sm90.cuh",
                   "K10dq TP-train": "flash_sm90.cuh", "K10dkv TP-train": "flash_sm90.cuh"}
    for name, r in par_kernels.items():
        base = name.split()[0]
        kernels.append({
            "name": f"{labels.get(base, base)}{name[len(base):]} {sources[base][0].split(' (')[0]} (a rank's local "
                    "shapes, two ranks on one card)",
            "route": "cuda", "source": f"lit_llama_tpu_torch/csrc/{par_sources[name]}", "replaces": sources[base][1],
            **{k: r[k] for k in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                 "shape")}})
    assert all(k["launches"] > 0 for k in kernels), "a kernel of the main paths was never launched"
    print(json.dumps({"requests": full, "serving": serving, "requests_lora": full_lora, "serving_lora": serving_lora,
                      "entry_points": entry_runs, "requests_int8": full8,
                      "k3_shapes": k3_shapes, "k6_shapes": k6_shapes, "k5_shapes": k5_shapes, "training": training,
                      "finetuning": finetuning, "gptq_evaluation": gptq_eval, "conversion_http_data": entry_points,
                      "parallel": parallel, "train_parallel": train_parallel, "entry_inputs": entry_inputs}))
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.0f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
