"""Where the warps of the hand-written Hopper kernels spend their cycles:
clock64 spans in an instrumented copy of the package.

    python lit_llama_tpu_torch/tools/spans.py flash|gemv|rows|int8|int4 [--root DIR] [--out DIR]

Copies the package (that of the checkout at ``--root``, by default this one)
to DIR (default ``build/spans_<target>``, which the copy's kernels build
beside), adds spans to the copy's kernel sources from a table
of anchors (lines of the kernel's own code, after or before which a reading
is taken), runs the kernels and prints one JSON line per kernel and shape.
One thread per warp or warpgroup takes the readings and adds them atomically
into a ``__device__`` table the tool reads back, so the instrumented kernels
run slower than the real ones: the shares, not the cycles, are the finding.
The repo's own sources are left as they are. Needs a CUDA card.

``flash``: K4, K10 dq and dK/dV (``csrc/flash_sm90.cuh``) in bf16 at head
size 128, at (1, 32, 2048), (2, 32, 2048) and (1, 32, 200): the cycles a
consumer warpgroup takes, the cycles a tile step takes, and the share of its
time between each wait and issue: the own tile's copy, the ring's copies,
the turn on the tensor cores, the wgmma issue, the waits for the scores and
for the products, the softmax or elementwise work, and the epilogue.

``gemv``: the int4 matvec of K1 (one 7B block, S = 2048, pos 2047, random
weights from seed 0) in bf16 compute (``csrc/gemv_sm90.cuh``: prologue,
ring wait, nibble unpacking, mma.sync, scales, epilogue) and in f32 compute
(``csrc/gemv_int4.cuh``: prologue, loads, the wait for the loads, unpacking
with the products and scales, epilogue), for each of the block's four
linears: the cycles a warp takes and the share of each span.

``rows``: the int4 products of K7 and K9 (``csrc/serve_layer.cu``) at B = 32
on one 7B block (random weights from seed 0): for c_attn, attn.c_proj,
c_fc12 and mlp.c_proj, the cycles a warp takes and the share of the token-row
loads, the weight loads (or the ring's wait), the nibble conversion, the mma,
the scales and zero-point term, the cross-warp reduction or split merge and
the epilogue. Each kernel the source holds is read (``ROWS_SOURCES``: the
product kernel of the earlier design, ``rows_int4_kernel``, and its
successor), so ``--root`` may name a checkout of either.

``int8``: K6 at M = 1 on the five 7B int8 linears and an odd shape (1000 ->
1040), bf16 and f32 compute (random int8 weights from seed 0): the cycles a
block takes (one reader, thread 0) and the share of each span. Of the
later body (``gemv8_kernel`` in ``csrc/gemv_int8_sm90.cuh``): issuing the
first steps, the wait for the kernel before (programmatic dependent launch),
loading x for the first steps, the ring's waits, the products, the copies'
issue, the block's sum over its row lanes and warps, its partial and arrival
count, the last arrival's merge, and the output.
Of the first body
(``int8_gemv_kernel`` in ``csrc/quant_matmul_int8.cu``, at the ``--root``
of an earlier checkout): the loads' issue, their wait, the products, the
block's sum and its output; its second kernel (the split sum) has no spans.
Beside the spans, the kernel's own time by CUDA events, so the cycles a
block spends can be set against the call.

``int4``: K3 at M = 1 (``gemv4_kernel`` in ``csrc/gemv4_sm90.cuh``) on the
five 7B int4 linears (gs 128) and an odd shape (1024 -> 1040), bf16 and f32
compute (random nibbles, scales and zeros from seed 0): the cycles a block
takes (one reader, thread 0) and the share of each span: issuing the first
steps and scales, the wait for the kernel before, x's parts and octet sums,
the group sums, the wait for a step's loads (its registers stored to the
warp's tile), the fragments' ldmatrix, the next loads' issue, the products (x words, nibbles, mma), the group flushes, the
partial and arrival count (or the output of an unsplit block), the last
arrival's merge, and the end; and the kernel's own time by CUDA events.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, NamedTuple, Tuple

HEAD = """
#ifndef LLT_SPANS
#define LLT_SPANS
// row k of the table: spans 0-12, then the cycles in all, the tile steps and
// the readers that added into it
__device__ unsigned long long g_spans[8][16];
__device__ __forceinline__ unsigned long long span_clk() {
  unsigned long long c;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c));
  return c;
}
#define SPAN_BEGIN(ROW, ON) const int span_row = (ROW); const bool span_on = (ON); \\
  unsigned long long t_mark = span_clk(), t_start = t_mark;
#define SPAN(i) if (span_on) { const unsigned long long _c = span_clk(); \\
  atomicAdd(&g_spans[span_row][i], _c - t_mark); t_mark = _c; }
#define SPAN_END(STEPS) if (span_on) { atomicAdd(&g_spans[span_row][13], span_clk() - t_start); \\
  atomicAdd(&g_spans[span_row][14], (unsigned long long)(STEPS)); atomicAdd(&g_spans[span_row][15], 1ull); }
// a move that depends on x: the reading after it waits for x's load
#define SPAN_WAIT(x) { unsigned _d; asm volatile("mov.b32 %0, %1;" : "=r"(_d) : "r"(x)); }
#endif
"""
READ = """
LLT_EXPORT int read_spans(unsigned long long* out) {
  int err = (int)cudaMemcpyFromSymbol(out, g_spans, sizeof(g_spans));
  unsigned long long zero[8 * 16] = {0};
  if (!err) err = (int)cudaMemcpyToSymbol(g_spans, zero, sizeof(zero));
  return err;
}
"""
ROWS, COLS = 8, 16


class Kernel(NamedTuple):
    name: str  # a text of the kernel's declaration
    begin: str  # the line of its code after which the readings start
    on: str  # the thread that takes them (a C++ condition)
    row: str  # the table row they go to (a C++ expression)
    steps: str  # its tile steps (a C++ expression)


class Source(NamedTuple):
    file: str  # under csrc/
    kernels: Tuple[Kernel, ...]
    # (text on a line of a kernel's code, what is put in, "after" or "before"
    # that line): the first rule a line matches wins; "after" takes only a
    # statement (a line that ends in ";" and declares no lambda)
    rules: Tuple[Tuple[str, str, str], ...]
    end: str  # put in before each kernel's closing brace, ahead of its totals


def instrument(src: str, source: Source) -> str:
    """The source with its readings; raises if a kernel or a rule's anchor
    is not found."""
    out, kern, on, closed, hit = [], None, False, set(), set()
    for line in src.split("\n"):
        code = line.split("//")[0].rstrip()
        if kern is None:
            kern = next((k for k in source.kernels if k.name in code), None)
        elif on and line == "}":
            out += [f"  {source.end}"] if source.end else []
            out.append(f"  SPAN_END({kern.steps})")
            closed.add(kern.name)
            kern, on = None, False
        rule = next((r for r in source.rules if r[0] in line), None) if on and code.strip() else None
        indent = line[: len(line) - len(line.lstrip())]
        if rule and rule[2] == "before":
            out.append(f"{indent}{rule[1]}")
            hit.add(rule[0])
        out.append(line)
        if kern is not None and not on and kern.begin in code:
            out.append(f"  SPAN_BEGIN({kern.row}, {kern.on})")
            on = True
        elif rule and rule[2] == "after" and line.rstrip().endswith(";") and "auto " not in line:
            out.append(f"{indent}{rule[1]}")
            hit.add(rule[0])
    missing = [k.name for k in source.kernels if k.name not in closed] + [r[0] for r in source.rules
                                                                          if r[0] not in hit]
    if missing:
        raise ValueError(f"spans: {source.file}: anchors not found: {missing}")
    text = "\n".join(out)
    if "#pragma once\n" in text:  # a header: the table once, after its guard
        return text.replace("#pragma once\n", "#pragma once\n" + HEAD, 1)
    return HEAD + text


FLASH = Source(
    "flash_sm90.cuh",
    tuple(Kernel(name, "t128 = tid % 128", "t128 == 0", str(i), steps)
          for i, (name, steps) in enumerate((("fwd_kernel(", "n_kv"), ("dq_kernel(", "n_kv"),
                                              ("dkv_kernel(", "(n_q - i0)")))),
    tuple((p, f"SPAN({i});", "after") for p, i in (
        ("mbar_wait(qbar", 1), ("mbar_wait(kvbar", 1), ("mbar_wait(rk.full", 2), ("mbar_wait(rq.full", 2),
        ("mbar_wait(rv.full", 3), ("turn_wait(wg);", 10), ("wgmma_commit();", 4), ("turn_pass(wg);", 4),
        ("fence_regs(s);", 5), ("softmax(", 6), ("ds_tile(", 6), ("pack_a<DKV_BQ>(sa, dp);", 6),
        ("fence_regs(o);", 7), ("fence_regs(dv);", 7), ("fence_regs(acc);", 7), ("pack_a<FWD_BKV>(pa, s);", 8))),
    "SPAN(9);")
FLASH_SPANS = {1: "own tile copy", 2: "ring copy (K or Q tile)", 3: "ring copy (V tile)",
               10: "turn on the tensor cores", 4: "wgmma issue", 5: "wait for the scores",
               6: "softmax / elementwise", 7: "wait for the products", 8: "rescale + pack", 9: "epilogue"}
FLASH_KERNELS = ("K4", "K10 dq", "K10 dkv")

ROLES = ("c_attn", "attn.c_proj", "c_fc12", "mlp.c_proj")
ROLE = "(epi == EPI_SWIGLU ? 2 : epi == EPI_RESIDUAL ? (K == N ? 1 : 3) : 0)"
LANE0 = "(threadIdx.x % 32) == 0"
GEMV = (  # rows 0-3: the FFMA body by role; rows 4-7: the tensor-core body
    Source("gemv_int4.cuh",
           (Kernel("gemv_int4_kernel(", "const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;", LANE0,
                   ROLE, "1"),),
           (("const int nvec = Kh / 16;", "SPAN(0)", "before"),
            ("int col[CPW];", "SPAN(4)", "before"),  # the task before this one: its epilogue
            ("make_uint4(0, 0, 0, 0);", "SPAN(1) SPAN_WAIT(w[0].x) SPAN(2)", "after"),
            ("for (int g = lane; g < G; g += 32) {", "SPAN(3)", "before")),
           "SPAN(4)"),
    Source("gemv_sm90.cuh",
           (Kernel("gemv_sm90_kernel(", "float* hsum = zer + COLS * G;", LANE0, "4 + " + ROLE, "my_steps"),),
           (("float acc_a = 0.f, acc_b = 0.f;", "SPAN(0)", "before"),
            ("const uint4* stg = ring + (j % STAGES) * 64;", "SPAN(1)", "before"),
            ("const uint32_t ah[4] = ", "SPAN(2)", "after"),
            ("mma_bf16(dh, ah, ", "SPAN(3)", "after"),
            ("acc_b += dl[2] * sc.z", "SPAN(4)", "after"),
            ("if (epi == EPI_SWIGLU) {", "SPAN(5)", "before")),
           ""),
)
ROWS_SOURCES = (
    Source("serve_layer.cu",
           (Kernel("rows_int4_kernel(", "const int s_begin = warp * per, s_end = min(nsteps, s_begin + per);",
                   LANE0, ROLE, "(s_end - s_begin)"),),
           (("const __nv_bfloat16* xbt = xb + (size_t)rt * K;", "SPAN(6)", "before"),  # the previous tile's tail
            ("ahi[m][rr][4] = h1.x", "SPAN(6) SPAN_WAIT(alo[0][0][0]) SPAN(0)", "after"),
            ("w[j] = __ldg(reinterpret_cast<const uint4*>(wt", "SPAN_WAIT(w[j].x) SPAN(1)", "after"),
            ("const uint32_t bh0 = nibbles_bf16x2(hi, 0x4140)", "SPAN(2)", "after"),
            ("mma_bf16(phi[m], ah, bh0, bh1);", "SPAN(3)", "after"),
            ("acc[j][m][i] += plo[m][i] * sl[i & 1] + phi[m][i] * sh[i & 1];", "SPAN(4)", "after"),
            ("float* mine = red + (size_t)warp * ROWS * BN;", "SPAN(6)", "before"),
            ("const int nout = epi == EPI_SWIGLU ? BN / 2 : BN;", "SPAN(5)", "before")),
           "SPAN(7)"),
    Source("serve_layer.cu",
           (Kernel("rows_sm90_kernel(", "const int s0 = sp * nsteps / a.splits, n = (sp + 1) * nsteps / a.splits - s0;",
                   LANE0, "(a.epi == EPI_SWIGLU ? 2 : a.epi == EPI_RESIDUAL ? (a.K == a.N ? 1 : 3) : 0)", "n"),),
           (("cp_async_wait<S - 2>();", "SPAN(6)", "before"),
            ("if (j + S - 1 < n) {", "SPAN(0)", "before"),
            ("const uint8_t* stg = smem + (j % S) * SB;", "SPAN(1)", "before"),
            ("for (int jt = 0; jt < NT; ++jt) {", "SPAN(2)", "before"),
            ("const uint4 h0 = reinterpret_cast<const uint4*>(tr + 128)[0]", "SPAN_WAIT(h1.w) SPAN(3)", "after"),
            ("const float4 q = ", "SPAN_WAIT(__float_as_uint(dh[3])) SPAN(4)", "before"),
            ("c[3] = fmaf(q.z, z4.z, c[3]), c[3] = fmaf(q.w, z4.w, c[3]);", "SPAN(5)", "after"),
            ("cp_async_wait<0>();", "SPAN(6)", "before"),
            ("if (a.splits == 1) {", "SPAN(7)", "before"),
            ("__syncthreads();  // T is the next tile's ring", "SPAN(8)", "before"),
            ("if (a.splits == 1) return;", "if (a.splits == 1) { SPAN_END(n) }", "before"),
            ("if (!last) return;", "SPAN(7) if (!last) { SPAN_END(n) }", "before")),
           "SPAN(8)"),
)
ROWS_SPANS = {"rows_int4_kernel(": ("token rows", "weights", "nibble conversion", "mma", "scales + zero term",
                                    "reduction / merge", "other", "epilogue"),
              "rows_sm90_kernel(": ("ring wait + barrier", "copy issue", "scales + nibble conversion",
                                    "token fragments", "mma", "scales + zero term", "other", "tile out / merge",
                                    "epilogue")}
GEMV_SPANS = {0: ("prologue", "loads", "load wait", "unpack + products + scales", "epilogue"),
              1: ("prologue", "ring wait", "unpack", "products (mma.sync)", "scales", "epilogue")}
# K6 at M = 1: one reader a block (thread 0), a table row a shape
INT8_SHAPES = (("c_attn", 4096, 12288), ("attn.c_proj", 4096, 4096), ("c_fc12", 4096, 22016),
               ("mlp.c_proj", 11008, 4096), ("lm_head", 4096, 32000), ("odd", 1000, 1040))
INT8_ROW = "(N == 12288 ? 0 : N == 4096 ? (K == 4096 ? 1 : 3) : N == 22016 ? 2 : N == 32000 ? 4 : 5)"
INT8_SOURCES = (
    Source("gemv_int8_sm90.cuh",
           (Kernel("gemv8_kernel(", "const bool ok0 = wcol < N, ok1 = wcol + COLS / 2 < N;", "threadIdx.x == 0",
                   INT8_ROW, "n"),),
           (("pdl_wait();", "SPAN(0)", "before"),
            ("pdl_trigger();", "SPAN(1)", "before"),
            ("float acc[32];", "SPAN(2)", "before"),
            ("cp_async_wait<STAGES - 1>();", "SPAN(3)", "after"),
            ("fma_s8x16(acc + 16, w1, xv);", "SPAN(4)", "after"),
            ("stage = stage == STAGES - 1 ? 0 : stage + 1;", "SPAN(5)", "before"),
            ("float part = red[tid];", "SPAN(6)", "before"),
            ("if (splits == 1) {", "SPAN(7)", "before"),
            ("if (tid == 0) last_block = atomicAdd(", "SPAN(8)", "after"),
            ("if (tid == 0) counter[strip] = 0;", "SPAN(9)", "after")),
           "SPAN(10)"),
    Source("quant_matmul_int8.cu",
           (Kernel("int8_gemv_kernel(", "const int k_end = min(K, k_begin + rows_per_split);", "threadIdx.x == 0",
                   INT8_ROW, "(k_end - k_begin)"),),
           (("fma_s8x4(acc + 0, w[u].x, xv[u]);", "SPAN_WAIT(w[u].x) SPAN(0)", "before"),
            ("fma_s8x4(acc + 12, w[u].w, xv[u]);", "SPAN(1)", "after")),
           "SPAN(2)"),
)
INT8_SPANS = {"gemv8_kernel(": ("first steps' issue", "wait for the kernel before", "x of the first steps",
                                "ring wait", "products", "copy issue", "row lanes (shuffles, barrier)", "warp sum",
                                "partial, fence, arrival count", "merge (last arrival)", "output"),
              "int8_gemv_kernel(": ("loads (issue and wait)", "products", "block sum and output")}
# K3 at M = 1: one reader a block (thread 0), a table row a shape (INT8_ROW's)
INT4_SHAPES = INT8_SHAPES[:5] + (("odd", 1024, 1040),)
INT4_SOURCES = (
    Source("gemv4_sm90.cuh",
           (Kernel("gemv4_kernel(", "const int wc = strip * COLS + warp * WCOLS;", "threadIdx.x == 0", INT8_ROW,
                   "n"),),
           (("pdl_wait();", "SPAN(0)", "before"),
            ("pdl_trigger();", "SPAN(1)", "before"),
            ("for (int i = tid; i < 2 * GMAX; i += THREADS) {", "SPAN(2)", "before"),
            ("const bool feeds = g < 2 * NB;", "SPAN(3)", "before"),
            ("*reinterpret_cast<V*>(tile + piece_dst(i)) = regs[u][i];", "SPAN(4)", "after"),
            ("ldsm_x4_trans(w[1], tile + swz(lane, 1));", "SPAN(5)", "after"),
            ("if (j + STAGES < n) fetch(j + STAGES, u);", "SPAN(6)", "after"),
            ("if constexpr (STEPG) {", "SPAN(7)", "before"),
            ("check(ROWS, (j + 1) * ROWS);", "SPAN(8)", "after"),
            ("return;", "SPAN(9) SPAN_END(n)", "before"),
            ("if (tid == 0) last_block = atomicAdd(", "SPAN(9)", "after"),
            ("if (tid == 0) counter[strip] = 0;", "SPAN(10)", "after")),
           "SPAN(11)"),
)
INT4_SPANS = ("first steps' and scales' issue", "wait for the kernel before", "x parts and octet sums",
              "group sums of x", "loads' wait (the step to the warp's tile)", "fragments (ldmatrix)", "load issue",
              "products (x words, nibbles, mma)", "group flushes", "output, or partial, fence, arrival count",
              "merge (last arrival)", "end")
TARGETS: Dict[str, Tuple[Tuple[Source, ...], str]] = {"flash": ((FLASH,), "flash_attention"),
                                                       "gemv": (GEMV, "fused_layer"),
                                                       "rows": (ROWS_SOURCES, "serve_layer"),
                                                       "int8": (INT8_SOURCES, "quant_matmul_int8"),
                                                       "int4": (INT4_SOURCES, "quant_matmul")}


def read(lib, table) -> list:
    """The table's rows (cleared on the card as they are read)."""
    if lib.read_spans(table) != 0:
        raise RuntimeError("spans: reading the table failed")
    return [[table[r * COLS + j] for j in range(COLS)] for r in range(ROWS)]


def run_flash(torch, lib, table, smi) -> None:
    from lit_llama_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    for B, T in ((1, 2048), (2, 2048), (1, 200)):
        q, k, v, do = (torch.randn(B, 32, T, 128, generator=g).to(dev, torch.bfloat16) for _ in range(4))
        o, lse = fa.flash_attention(q, k, v)
        dq, dd = fa.flash_backward_dq(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        read(lib, table)  # clears the table
        fa.flash_attention(q, k, v)
        fa.flash_backward_dq(q, k, v, o, lse, do)
        fa.flash_backward_dkv(q, k, v, do, lse, dd)
        torch.cuda.synchronize()
        for name, row in zip(FLASH_KERNELS, read(lib, table)):
            cycles, steps, wgs = row[13], row[14], row[15]
            print(json.dumps({"kernel": name, "shape": [B, 32, T, 128], "nvidia_smi": smi, "warpgroups": wgs,
                              "cycles_a_warpgroup": cycles / wgs, "cycles_a_tile_step": cycles / steps,
                              "share": {FLASH_SPANS[j]: row[j] / cycles for j in FLASH_SPANS if row[j]}}))


def run_gemv(torch, lib, table, smi) -> None:
    from lit_llama_tpu_torch import LLaMAConfig
    from lit_llama_tpu_torch.models import llama
    from lit_llama_tpu_torch.ops import fused_layer
    from lit_llama_tpu_torch.ops.rope import build_rope_cache, rope_half_row
    from lit_llama_tpu_torch.utils.random_params import random_int4_params

    dev = torch.device("cuda")
    cfg7 = LLaMAConfig.from_name("7B", n_layer=1, param_dtype="bfloat16", compute_dtype="bfloat16", quantize="int4")
    params, cfg = fused_layer.prepare_fused_params(
        llama.unstack_layers(random_int4_params(cfg7, seed=0, device=dev)), cfg7)
    g = torch.Generator().manual_seed(0)
    S, pos, H, hs = 2048, 2047, cfg.n_head, cfg.head_size
    cos, sin = rope_half_row(build_rope_cache(cfg.block_size, hs, device=dev), min(pos, cfg.block_size - 1), hs)
    for dtype in (torch.bfloat16, torch.float32):
        c = cfg.replace(compute_dtype="bfloat16" if dtype == torch.bfloat16 else "float32")
        kv = {n: (torch.randn(1, H, S, hs, generator=g) * 0.3).to(dev, dtype) for n in "kv"}
        x = torch.randn(1, cfg.n_embd, generator=g).to(dev, dtype)
        fused_layer.decode_layers_fused(x, params["h"], [kv], cos, sin, pos % S, pos, c)
        torch.cuda.synchronize()
        read(lib, table)  # clears the table
        for _ in range(10):
            fused_layer.decode_layers_fused(x, params["h"], [kv], cos, sin, pos % S, pos, c)
        torch.cuda.synchronize()
        rows = read(lib, table)
        for body, source in enumerate(GEMV):
            names = GEMV_SPANS[body]
            for r, role in enumerate(ROLES):
                row = rows[4 * body + r]
                cycles, warps = row[13], row[15]
                if warps:
                    print(json.dumps({"body": source.file, "compute": str(dtype), "linear": role, "nvidia_smi": smi,
                                      "warps": warps, "cycles_a_warp": cycles / warps,
                                      "share": {names[j]: row[j] / cycles for j in range(len(names)) if row[j]}}))


def run_rows(torch, lib, table, smi) -> None:
    from lit_llama_tpu_torch import LLaMAConfig
    from lit_llama_tpu_torch.models import llama
    from lit_llama_tpu_torch.ops import fused_layer
    from lit_llama_tpu_torch.ops.rope import build_rope_cache, slot_rope_rows
    from lit_llama_tpu_torch.utils.random_params import random_int4_params

    dev = torch.device("cuda")
    cfg7 = LLaMAConfig.from_name("7B", n_layer=1, param_dtype="bfloat16", compute_dtype="bfloat16", quantize="int4")
    params, cfg = fused_layer.prepare_fused_params(
        llama.unstack_layers(random_int4_params(cfg7, seed=0, device=dev)), cfg7)
    lp = params["h"][0]
    g = torch.Generator().manual_seed(0)
    B = 32
    x, y = (torch.randn(B, cfg.n_embd, generator=g).to(dev, torch.bfloat16) for _ in range(2))
    pos = torch.randint(0, cfg.block_size, (B,), generator=g).to(dev, torch.int32)
    cos, sin = slot_rope_rows(build_rope_cache(cfg.block_size, cfg.head_size, device=dev), pos)

    def step():
        fused_layer.block_head_fused(x, lp["rms_1"], cos, sin, lp["attn"]["c_attn"], cfg)
        fused_layer.block_tail_fused(x, y, lp["rms_2"], lp["attn"]["c_proj"], lp["mlp"]["c_fc12"],
                                     lp["mlp"]["c_proj"], cfg)

    step()
    torch.cuda.synchronize()
    read(lib, table)  # clears the table
    for _ in range(10):
        step()
    torch.cuda.synchronize()
    text = (Path(fused_layer.__file__).resolve().parent.parent / "csrc" / "serve_layer.cu").read_text()
    kernel = next(k for k in ROWS_SPANS if k in text)
    for role, row in zip(ROLES, read(lib, table)):
        cycles, warps = row[13], row[15]
        if warps:
            print(json.dumps({"kernel": kernel[:-1], "linear": role, "B": B, "nvidia_smi": smi, "warps": warps,
                              "cycles_a_warp": cycles / warps, "steps_a_warp": row[14] / warps,
                              "share": {n: row[j] / cycles for j, n in enumerate(ROWS_SPANS[kernel]) if row[j]}}))


def run_matvec(torch, lib, table, smi, target: str) -> None:
    """K6 ("int8") or K3 ("int4") at M = 1: a table row a shape, one reader a
    block."""
    import devtime  # beside this file
    from lit_llama_tpu_torch.ops import quant_matmul as qm

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    time_us = devtime.make_timer(dev)
    if target == "int8":
        csrc = Path(qm.__file__).resolve().parent.parent / "csrc"
        text = "".join(f.read_text() for f in csrc.glob("*.cu*"))
        kernel = next(k for k in INT8_SPANS if k in text)
        names, shapes = INT8_SPANS[kernel], INT8_SHAPES
    else:
        kernel, names, shapes = "gemv4_kernel(", INT4_SPANS, INT4_SHAPES
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip()
    for dtype in (torch.bfloat16, torch.float32):
        for row, (name, K, N) in enumerate(shapes):
            if target == "int8":
                w = (torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8),
                     torch.empty(1, N, device=dev).uniform_(0.0002, 0.0004, generator=g))
            else:
                w = (torch.randint(0, 256, (K // 2, N), generator=g, device=dev, dtype=torch.uint8),
                     torch.empty(K // 128, N, device=dev).uniform_(0.0005, 0.0015, generator=g),
                     torch.empty(K // 128, N, device=dev).uniform_(-0.012, -0.006, generator=g))
            x = torch.randn(1, K, generator=g, device=dev).to(dtype)
            fn = qm.matmul_int8 if target == "int8" else qm.matmul_int4
            call = lambda: fn(x, *w, dtype)
            call()
            torch.cuda.synchronize()
            read(lib, table)  # clears the table
            for _ in range(10):
                call()
            torch.cuda.synchronize()
            r = read(lib, table)[row]
            us = time_us(call)
            cycles, blocks = r[13], r[15]
            print(json.dumps({"kernel": kernel[:-1], "linear": f"{name} {K}->{N}", "compute": str(dtype),
                              "nvidia_smi": smi, "clocks_sm": clock, "instrumented_us": us,
                              "blocks": blocks / 10, "cycles_a_block": cycles / blocks, "steps_a_block": r[14] / blocks,
                              "share": {n: r[j] / cycles for j, n in enumerate(names) if r[j]}}))
            del w


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("target", choices=sorted(TARGETS))
    ap.add_argument("--root", default=None, help="the checkout whose package is instrumented (default: this one)")
    ap.add_argument("--out", default=None, help="the directory for the instrumented copy of the package")
    args = ap.parse_args()
    here = Path(__file__).resolve().parents[1]
    package = Path(args.root).resolve() / here.name if args.root else here
    out = Path(args.out or here.parent / "build" / f"spans_{args.target}")
    shutil.rmtree(out / package.name, ignore_errors=True)
    shutil.copytree(package, out / package.name, ignore=shutil.ignore_patterns("__pycache__"))
    csrc = out / package.name / "csrc"
    sources, library = TARGETS[args.target]
    for source in sources:
        if not (csrc / source.file).exists():  # int8: the header of the later body
            continue
        text = (csrc / source.file).read_text()
        if any(k.name in text for k in source.kernels):  # rows: the kernel this checkout has
            (csrc / source.file).write_text(instrument(text, source))
    (csrc / f"{library}.cu").write_text((csrc / f"{library}.cu").read_text() + READ)
    sys.path.insert(0, str(out))
    import torch

    if not torch.cuda.is_available():
        print("spans: no CUDA device", file=sys.stderr)
        return 1
    from lit_llama_tpu_torch.ops import _build

    assert Path(_build.__file__).resolve().is_relative_to(out.resolve()), "imported the package from elsewhere"
    _build.build([library])
    lib = ctypes.CDLL(str(_build.lib_path(library)))
    lib.read_spans.argtypes, lib.read_spans.restype = [ctypes.c_void_p], ctypes.c_int
    table = (ctypes.c_ulonglong * (ROWS * COLS))()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    if args.target in ("int8", "int4"):
        run_matvec(torch, lib, table, smi, args.target)
    else:
        {"flash": run_flash, "gemv": run_gemv, "rows": run_rows}[args.target](torch, lib, table, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
