"""Fused decode kernels with their plain versions (counterpart of
lit_llama_tpu/ops/fused_layer.py): K1 and K2 for one stream, K7 and K9 for
the batched serving step.

``decode_layers_fused`` replaces the Pallas ``_layer_kernel``
(lit_llama_tpu/ops/fused_layer.py, entry ``decode_layers_fused``): one decode
token through whole blocks, launching the fixed sequence of CUDA kernels in
``csrc/fused_layer.cu`` per block; in bf16 the int4 matvecs run on the
tensor cores (``csrc/gemv_sm90.cuh``, its constants mirrored by ``GEMV_*``)
and the attention on the split body of
``csrc/decode_sm90.cuh`` (``decode_attention.decode_plan``, ``k1_scratch``). ``lm_head_fused`` replaces ``_head_kernel``
(entry ``lm_head_fused``): the final RMSNorm and the int4 lm_head matvec.
What bounds them and how their design answers that is noted in the source.

``block_head_fused`` replaces ``_block_head_kernel`` (entry
``block_head_fused``): rms_1, the int4 QKV product and the half-basis RoPE
for B serving slots, each at its own position. ``block_tail_fused`` replaces
``_block_tail_kernel`` (entry ``block_tail_fused``): everything of the block
after its attention. Both are in ``csrc/serve_layer.cu``; between them runs
``ops.decode_attention.decode_attention_write``. They take any B (no padding
to 8 rows; ``use_serve_fused`` caps the engine's slots at
``SERVE_KERNEL_MAX_B``, as the JAX package does), per-slot (B, hs) cos/sin
rows in place of the (B, 3D) lane tables, and keep f32 intermediates at every
B: the Pallas kernel's switch to the compute dtype at 48 rows is a VMEM
limit. On the serving path q, k and v leave the head in the compute dtype, so
q is rounded before the attention (K1 keeps it f32).

Compute dtypes: bf16 or f32 (the Pallas kernels' ``cdtype``), in every entry;
the row, the cache and the outputs are in it. Norm weights are bf16 or f32
and are applied in f32 (``_rms_norm_rows``), never cast at load. In f32, K7
and K9 read the shared (K/2, N) layout of each linear (their f32 body is an
FFMA GEMM), K1 and K2 the decode layout as in bf16.

The k/v cache is a plain (1, H, S, hs) tensor updated IN PLACE at
``write_pos`` (ring slot, pos % S); slot s is visible iff s <= ``limit``
(pos). The packed u32 pair cache, ``blocked_scales`` and the 8-row work
vectors of the Pallas kernel worked around the TPU toolchain and are not
carried over. In their place ``prepare_fused_params`` adds, once at load, a
column-major decode copy of each int4 linear the kernels read (``qw_t``
(N, K/2), ``qscale_t``/``qzero_t`` (N, G)), so a warp streams whole columns;
the plain versions and the prefill read the shared (K/2, N) layout.

Rounding points, which the plain versions follow: the residual stream is f32
inside an entry and cast to the compute dtype at its end; each matvec
multiplies the input rounded to the compute dtype by the exact nibbles with
f32 accumulation, and takes the zero-point term from f32 group sums of the
unrounded input; q stays f32; k and v are rounded only when stored; scores
and the softmax are f32.

LoRA: ``prepare_fused_params`` folds a layer's overlay into two dense
operands of c_attn (``prepare_lora_operands``): ``lora_af`` (D, R8) and
``lora_bf`` (R8, 3D), scaling folded in, q/k columns in the half basis. K1
and K7 add ``(h @ lora_af) @ lora_bf`` in f32 to the QKV product before RoPE,
h the unrounded normed row, as the Pallas kernels' ``_add_lora_delta``; the
kernels that do it count their launches apart (``k1_lora``, ``k7_lora``). The
operand may have any multiple of 8 columns and be bf16 or f32, as the Pallas
kernels read it (``astype(f32)``).

Each wrapper's checks of dtypes, shapes and layouts are pure functions
(``check_decode_layers``, ``check_lm_head``, ``check_block_head``,
``check_block_tail``) that raise on what the kernels do not take, on any
device; the wrapper adds the checks of the card (device, alignment).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from lit_llama_tpu_torch.ops import _build, decode_attention, quant_matmul

Params = Dict[str, Any]

NEG_INF = -1e30
CHUNK = 64  # cache slots per attention block (csrc/fused_layer.cu)

_P, _I = _build.PTR, _build.INT
_SIGS = {
    "k1_decode_layer": [_P, _I, _P, _P, _I, _I] + [_P] * 12 + [_P] * 4 + [_P] * 7 + [_P] * 3 + [_I] * 9 + [_P],
    "k2_lm_head": [_P, _P, _I, _I] + [_P] * 4 + [_I] * 3 + [_P],
}
_SERVE_SIGS = {
    "k7_block_head": [_P, _P, _I, _I] + [_P] * 10 + [_I] + [_P] * 5 + [_I] * 2 + [_P] + [_I] * 3 + [_P],
    "k9_block_tail": [_P] * 3 + [_I] * 2 + [_P] * 20 + [_I] * 7 + [_P],
}
SERVE_KERNEL_MAX_B = 4096  # slots the engine gives K7-K9 (the JAX package's cap)
LORA_THREADS = 256  # rows of lora_af per block of K1's lora_down (csrc/fused_layer.cu)
DTYPES = (torch.bfloat16, torch.float32)  # compute dtypes, norm weights, LoRA operands


class LaunchCounter:
    """Launch count of kernels that run inside another wrapper's entry, kept
    apart from that wrapper's own count."""

    def __init__(self):
        self.launches = 0


k1_lora = LaunchCounter()  # K1's LoRA operand: one per block that has it
k7_lora = LaunchCounter()  # K7's LoRA operand: one per block-head call that has it


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _rms_rows(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    ss = (x * x).mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(ss + eps) * w.float()


def mv_int4_ref(src: torch.Tensor, w: Params, cdtype: torch.dtype) -> torch.Tensor:
    """(B, K) f32 @ dequant(w) -> (B, N) f32, with the Pallas matvec's rounding
    for every row: bf16(src) times exact nibbles, f32 sums, scale per group,
    plus the zero-point term from f32 group sums of ``src``."""
    qw, qs, qz = w["qw"], w["qscale"], w["qzero"]
    Kh, N = qw.shape
    B, G = src.shape[0], qs.shape[0]
    Gh, gs = G // 2, 2 * Kh // G
    acc = src.reshape(B, G, gs).sum(dim=-1) @ qz
    xb = src.to(cdtype).float().reshape(B, 2, Gh, gs).permute(1, 2, 0, 3)  # (2, Gh, B, gs)
    lo = torch.bmm(xb[0], (qw & 0xF).float().reshape(Gh, gs, N))  # (Gh, B, N)
    hi = torch.bmm(xb[1], (qw >> 4).float().reshape(Gh, gs, N))
    return acc + (lo * qs[:Gh, None]).sum(dim=0) + (hi * qs[Gh:, None]).sum(dim=0)


def _decode_attention_ref(q, kc, vc, limit: int) -> torch.Tensor:
    """q (H, hs) f32 against caches (H, S, hs); slot s visible iff s <= limit."""
    S, hs = kc.shape[-2], kc.shape[-1]
    s = (kc.float() * q[:, None, :]).sum(dim=-1) * (1.0 / math.sqrt(hs))
    visible = torch.arange(S, device=q.device) <= limit
    s = torch.where(visible, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return (p[:, :, None] * vc.float()).sum(dim=1) / l


def _lora_ref(h: torch.Tensor, qkv: torch.Tensor, ca: Params) -> torch.Tensor:
    """qkv + (h @ lora_af) @ lora_bf in f32 where c_attn carries the folded
    LoRA operand (the Pallas kernels' ``_add_lora_delta``), else qkv."""
    _lora_operand(ca, "LoRA")
    if "lora_af" not in ca:
        return qkv
    return qkv + (h @ ca["lora_af"].float()) @ ca["lora_bf"].float()


def decode_layers_fused_ref(x, lps, kvs, cosf, sinf, write_pos: int, limit: int, config):
    """Plain version of :func:`decode_layers_fused` (same in-place cache update)."""
    D, H, hs = config.n_embd, config.n_head, config.head_size
    I = config.intermediate_size
    cd = x.dtype
    xs = x.float()
    for lp, kv in zip(lps, kvs):
        attn, mlp = lp["attn"], lp["mlp"]
        h = _rms_rows(xs, lp["rms_1"])
        qkv = _lora_ref(h, mv_int4_ref(h, attn["c_attn"], cd), attn["c_attn"])
        q, k, v = qkv.reshape(3, H, hs)
        q = q * cosf + torch.roll(q, hs // 2, dims=-1) * sinf
        k = k * cosf + torch.roll(k, hs // 2, dims=-1) * sinf
        kv["k"][0, :, write_pos] = k.to(kv["k"].dtype)
        kv["v"][0, :, write_pos] = v.to(kv["v"].dtype)
        y = _decode_attention_ref(q, kv["k"][0], kv["v"][0], limit)
        xs = mv_int4_ref(y.reshape(1, D), attn["c_proj"], cd) + xs
        fg = mv_int4_ref(_rms_rows(xs, lp["rms_2"]), mlp["c_fc12"], cd)
        gg = F.silu(fg[:, :I]) * fg[:, I:]
        xs = mv_int4_ref(gg, mlp["c_proj"], cd) + xs
    return xs.to(cd), list(kvs)


def lm_head_fused_ref(x, ln_w, head: Params, config):
    """Plain version of :func:`lm_head_fused`."""
    return mv_int4_ref(_rms_rows(x.float(), ln_w), head, x.dtype).to(x.dtype)


def block_head_fused_ref(x, rms1, cos, sin, ca: Params, config):
    """Plain version of :func:`block_head_fused`."""
    D, hs = config.n_embd, config.head_size
    B = x.shape[0]
    h = _rms_rows(x.float(), rms1)
    qkv = _lora_ref(h, mv_int4_ref(h, ca, x.dtype), ca)
    qk = qkv[:, : 2 * D].reshape(B, -1, hs)
    qk = qk * cos[:, None] + torch.roll(qk, hs // 2, dims=-1) * sin[:, None]
    return torch.cat([qk.reshape(B, 2 * D), qkv[:, 2 * D :]], dim=-1).to(x.dtype)


def block_tail_fused_ref(x, y, rms2, cp: Params, f12: Params, mp: Params, config):
    """Plain version of :func:`block_tail_fused`."""
    I, cd = config.intermediate_size, x.dtype
    xs = mv_int4_ref(y.float(), cp, cd) + x.float()
    fg = mv_int4_ref(_rms_rows(xs, rms2), f12, cd)
    gg = F.silu(fg[:, :I]) * fg[:, I:]
    return (mv_int4_ref(gg, mp, cd) + xs).to(cd)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


_DECODE_KEYS = ("qw_t", "qscale_t", "qzero_t")
_SHARED_KEYS = ("qw", "qscale", "qzero")


# the bf16 matvec of K1 and K2 (csrc/gemv_sm90.cuh): a block of GEMV_WARPS
# warps owns GEMV_COLS output columns (8 gate and their 8 up columns under
# SiLU(gate) * up); warp w takes the GEMV_STEP-byte steps w, w + GEMV_WARPS,
# ... of each column's K/2 packed bytes through a ring of GEMV_STAGES steps
GEMV_WARPS, GEMV_COLS, GEMV_STEP, GEMV_STAGES = 4, 16, 64, 3
SM90_MAX_SMEM = 227 * 1024


def gemv_smem(K: int, gs: int) -> int:
    """Dynamic shared memory of the bf16 matvec: the rings of weights and of
    scales, the bf16 input, its group sums, the block's zero plane and the
    input's sums over 64 elements."""
    G = K // gs
    return (GEMV_WARPS * GEMV_STAGES * (2 * 32 * 16 + 32 * 4) + 2 * K + 4 * (-(-G // 4) * 4) + GEMV_COLS * G * 4
            + 4 * (K // 64))


def _check_gemv_smem(K: int, gs: int, what: str):
    if gemv_smem(K, gs) > SM90_MAX_SMEM:
        raise ValueError(f"{what}: the bf16 matvec stages K = {K} in shared memory; at most "
                         f"{SM90_MAX_SMEM} bytes, needs {gemv_smem(K, gs)}")


def k1_scratch(H: int, S: int, hs: int, dtype: torch.dtype) -> Tuple[int, int]:
    """(floats of the attention's partial scratch, int32 arrival counters) K1
    takes: in bf16 the split body's (``decode_attention.decode_plan``), in
    f32 one partial per 64-slot chunk."""
    if decode_attention.uses_split_body(hs, dtype):
        return H * decode_attention.decode_plan(S, hs).n_splits * (hs + 2), H
    return H * (-(-S // CHUNK)) * (hs + 2), 0


_Q4_SHAPES = {"qw_t": lambda K, N, G: (N, K // 2), "qw": lambda K, N, G: (K // 2, N),
              "qscale_t": lambda K, N, G: (N, G), "qzero_t": lambda K, N, G: (N, G),
              "qscale": lambda K, N, G: (G, N), "qzero": lambda K, N, G: (G, N)}


def _check_q4(w: Params, K: int, N: int, gs: int, what: str, keys=_DECODE_KEYS):
    """The kernels read the decode layout added by prepare_fused_params (the
    products of K7 and K9 its nibbles with the shared layout's scale and zero
    planes, their f32 bodies the shared (K/2, N) layout: ``keys``)."""
    if gs not in (64, 128, 256) or K % gs or (K // gs) % 2:
        raise ValueError(f"{what}: needs gs in (64, 128, 256) and an even group count (K={K} gs={gs})")
    if keys[0] not in w:
        raise ValueError(f"{what}: no {keys[0]}; prepare the params with prepare_fused_params")
    for k in keys:
        t, shape = w[k], _Q4_SHAPES[k](K, N, K // gs)
        dtype = torch.uint8 if k.startswith("qw") else torch.float32
        if t.dtype != dtype or t.shape != shape:
            raise ValueError(f"{what}: {k} must be {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")


def _on_card(what: str, *ts):
    """The card's part of a wrapper's checks: CUDA, contiguous, 16-byte aligned."""
    for t in ts:
        if t is not None and (not t.is_cuda or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{what}: tensors must be contiguous, 16-byte aligned CUDA tensors")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _scratch(dev, *nbytes: int):
    """A call's scratch in one allocation: the buffer (kept by the caller
    until the launch is enqueued) and a pointer into it for each size, 16-byte
    aligned (None for 0). One allocation, not one a tensor, keeps the host's
    time a serving step below the device's."""
    offs, total = [], 0
    for n in nbytes:
        offs.append(total if n else None)
        total += -(-n // 16) * 16
    buf = torch.empty(max(total, 16), dtype=torch.uint8, device=dev)
    return buf, [None if o is None else buf.data_ptr() + o for o in offs]


def _w_keys(ws, keys=_DECODE_KEYS):
    return [w[k] for w in ws for k in keys]


def _lora_operand(ca: Params, what: str, D: int = 0):
    """The folded LoRA operand of c_attn as (lora_af, lora_bf, R8), or (None,
    None, 0) without one. A raw overlay (lora_a) that was not folded raises:
    the kernels would leave its update out. With ``D`` the operand is checked
    as the kernels take it: any positive multiple of 8 columns, bf16 or f32,
    both of one dtype."""
    if "lora_af" not in ca:
        if "lora_a" in ca:
            raise ValueError(f"{what}: c_attn holds a LoRA overlay that prepare_fused_params did not fold "
                             "(set config.lora before preparing)")
        return None, None, 0
    la, lb = ca["lora_af"], ca["lora_bf"]
    R8 = la.shape[-1]
    if D:
        if R8 % 8 or R8 <= 0:
            raise ValueError(f"{what}: the LoRA operand needs a positive multiple of 8 columns, got {R8}")
        for t, shape in ((la, (D, R8)), (lb, (R8, 3 * D))):
            if t.dtype not in DTYPES or t.dtype != la.dtype or t.shape != shape:
                raise ValueError(f"{what}: the LoRA operand must be bf16 or f32 tensors of one dtype "
                                 f"{(D, R8)} and {(R8, 3 * D)}, got {t.dtype} {tuple(t.shape)}")
    return la, lb, R8


def _check_norm(w, D: int, what: str):
    if w.dtype not in DTYPES or w.shape != (D,):
        raise ValueError(f"{what} takes a bf16 or f32 ({D},) norm weight, got {w.dtype} {tuple(w.shape)}")


def _check_row(x, B: int, D: int, what: str, dtype=None):
    if x.dtype not in DTYPES or (dtype is not None and x.dtype != dtype) or x.shape != (B, D) \
            or not x.is_contiguous():
        raise ValueError(f"{what} takes contiguous bf16 or f32 ({B}, {D}) rows in the compute dtype, "
                         f"got {x.dtype} {tuple(x.shape)}")


def _check_layout(config):
    if config.head_size != 128:
        raise ValueError(f"K1 takes head size 128, got {config.head_size}")
    if config.intermediate_size % 4:
        raise ValueError("K1 needs the intermediate size divisible by 4")


def check_decode_layers(x, lps, kvs, cosf, sinf, write_pos: int, limit: int, config):
    """What K1 takes, on any device. x (1, D) bf16 or f32 (the compute
    dtype); caches (1, H, S, 128) in x's dtype; norm weights bf16 or f32,
    rms_1 and rms_2 of one dtype; the prepared decode layout; a LoRA operand
    of any multiple of 8 columns, bf16 or f32. Raises ValueError otherwise."""
    _check_layout(config)
    D, H, hs = config.n_embd, config.n_head, config.head_size
    I, gs = config.intermediate_size, config.quant_groupsize
    S = kvs[0]["k"].shape[-2]
    _check_row(x, 1, D, "K1")
    for t in (cosf, sinf):
        if t.dtype != torch.float32 or t.shape != (1, hs) or not t.is_contiguous():
            raise ValueError("K1 takes contiguous f32 (1, hs) cos/sin rows")
    if not 0 <= write_pos < S or limit < write_pos:
        raise ValueError(f"K1: write_pos {write_pos} outside [0, {S}) or above limit {limit}")
    for lp, kv in zip(lps, kvs):
        for name in ("k", "v"):
            c = kv[name]
            if c.dtype != x.dtype or c.shape != (1, H, S, hs) or not c.is_contiguous():
                raise ValueError(f"K1 takes contiguous {x.dtype} (1, {H}, {S}, {hs}) caches")
        for name in ("rms_1", "rms_2"):
            _check_norm(lp[name], D, "K1")
        if lp["rms_1"].dtype != lp["rms_2"].dtype:
            raise ValueError("K1 takes rms_1 and rms_2 of one dtype")
        _check_q4(lp["attn"]["c_attn"], D, 3 * D, gs, "K1 c_attn")
        _check_q4(lp["attn"]["c_proj"], D, D, gs, "K1 attn.c_proj")
        _check_q4(lp["mlp"]["c_fc12"], D, 2 * I, gs, "K1 c_fc12")
        _check_q4(lp["mlp"]["c_proj"], I, D, gs, "K1 mlp.c_proj")
        _lora_operand(lp["attn"]["c_attn"], "K1 c_attn", D)
    if x.dtype == torch.bfloat16:
        _check_gemv_smem(max(D, I), gs, "K1")


def decode_layers_fused(
    x: torch.Tensor,  # (1, D) compute dtype
    lps: Sequence[Params],  # prepared layer params (prepare_fused_params)
    kvs: Sequence[Dict[str, torch.Tensor]],  # {"k", "v"}: (1, H, S, hs), updated in place
    cosf: torch.Tensor,  # (1, hs) f32 half-basis cos row at this position
    sinf: torch.Tensor,  # (1, hs) f32 signed sin row (rope.rope_half_row)
    write_pos: int,  # ring write slot (pos % S)
    limit: int,  # visibility bound (pos)
    config,
) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """``len(lps)`` blocks for one decode token. Returns (x_out (1, D), caches);
    the caches are the given tensors, written in place. A CPU tensor takes
    the plain version; a CUDA tensor launches K1 or raises."""
    if not x.is_cuda:
        return decode_layers_fused_ref(x, lps, kvs, cosf, sinf, write_pos, limit, config)
    check_decode_layers(x, lps, kvs, cosf, sinf, write_pos, limit, config)
    D, H, hs = config.n_embd, config.n_head, config.head_size
    I, gs = config.intermediate_size, config.quant_groupsize
    S = kvs[0]["k"].shape[-2]
    loras = [_lora_operand(lp["attn"]["c_attn"], "K1 c_attn", D) for lp in lps]
    for lp, kv, (la, lb, _) in zip(lps, kvs, loras):
        ws = [lp["attn"]["c_attn"], lp["attn"]["c_proj"], lp["mlp"]["c_fc12"], lp["mlp"]["c_proj"]]
        _on_card("K1", x, kv["k"], kv["v"], lp["rms_1"], lp["rms_2"], la, lb, *_w_keys(ws))
    if not (cosf.is_cuda and sinf.is_cuda):
        raise ValueError("K1 takes cos/sin rows on the card")

    dev = x.device
    cbf16 = int(x.dtype == torch.bfloat16)
    f32 = dict(dtype=torch.float32, device=dev)
    qkv = torch.empty(3 * D, **f32)
    n_part, n_count = k1_scratch(H, S, hs, x.dtype)
    part = torch.empty(n_part, **f32)
    counter = decode_attention.arrival_counters(n_count, dev) if n_count else None
    y = torch.empty(D, **f32)
    xs = torch.empty(D, **f32)
    gg = torch.empty(I, **f32)
    x_out = torch.empty_like(x)
    R8max = max(r for _, _, r in loras)
    lora_part = torch.empty((-(-D // LORA_THREADS)) * R8max, **f32) if R8max else None
    lib = _build.library("fused_layer", _SIGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    n = len(lps)
    for j, (lp, kv, (la, lb, R8)) in enumerate(zip(lps, kvs, loras)):
        a, m = lp["attn"], lp["mlp"]
        ws = [a["c_attn"], a["c_proj"], m["c_fc12"], m["c_proj"]]
        err = lib.k1_decode_layer(
            (x if j == 0 else xs).data_ptr(), int(j == 0 and cbf16),
            lp["rms_1"].data_ptr(), lp["rms_2"].data_ptr(), int(lp["rms_1"].dtype == torch.bfloat16), cbf16,
            *[t.data_ptr() for t in _w_keys(ws)],
            kv["k"].data_ptr(), kv["v"].data_ptr(), cosf.data_ptr(), sinf.data_ptr(),
            qkv.data_ptr(), part.data_ptr(), counter.data_ptr() if n_count else None, y.data_ptr(),
            xs.data_ptr(), gg.data_ptr(),
            x_out.data_ptr() if j == n - 1 else None,
            la.data_ptr() if R8 else None, lb.data_ptr() if R8 else None,
            lora_part.data_ptr() if R8 else None, R8, int(R8 == 0 or la.dtype == torch.bfloat16),
            D, I, H, S, gs, int(write_pos), int(limit), stream,
        )
        _build.check(err, "K1 decode_layers_fused")
        k1_lora.launches += bool(R8)
    decode_layers_fused.launches += 1
    return x_out, list(kvs)


decode_layers_fused.launches = 0


def decode_layer_fused(x, lp, kv, cosf, sinf, write_pos, limit, config):
    """One block: returns (x_out (1, D), the cache dict, written in place)."""
    xo, kvs = decode_layers_fused(x, (lp,), (kv,), cosf, sinf, write_pos, limit, config)
    return xo, kvs[0]


def check_lm_head(x, ln_w, head: Params, config):
    """What K2 takes, on any device: x (1, D) bf16 or f32, ln_f bf16 or f32,
    the prepared decode layout. Raises ValueError otherwise."""
    D, gs = config.n_embd, config.quant_groupsize
    _check_row(x, 1, D, "K2")
    _check_norm(ln_w, D, "K2")
    _check_q4(head, D, head["qw"].shape[-1], gs, "K2 lm_head")
    if x.dtype == torch.bfloat16:
        _check_gemv_smem(D, gs, "K2")


def lm_head_fused(x, ln_w, head: Params, config):
    """Final RMSNorm + int4 lm_head for one decode token: (1, D) -> (1, V) in
    x.dtype. A CPU tensor takes the plain version; a CUDA tensor launches K2
    or raises."""
    if not x.is_cuda:
        return lm_head_fused_ref(x, ln_w, head, config)
    check_lm_head(x, ln_w, head, config)
    _on_card("K2", x, ln_w, *_w_keys([head]))
    D, gs = config.n_embd, config.quant_groupsize
    V = head["qw"].shape[-1]
    logits = torch.empty((1, V), dtype=x.dtype, device=x.device)
    lib = _build.library("fused_layer", _SIGS)
    err = lib.k2_lm_head(
        x.data_ptr(), ln_w.data_ptr(), int(ln_w.dtype == torch.bfloat16), int(x.dtype == torch.bfloat16),
        *[t.data_ptr() for t in _w_keys([head])], logits.data_ptr(), D, V, gs,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "K2 lm_head_fused")
    lm_head_fused.launches += 1
    return logits


lm_head_fused.launches = 0


# The bf16 products of K7 and K9 (csrc/serve_layer.cu, namespace rs): a block
# of SERVE_WARPS warps owns SERVE_COLS output columns (under SiLU(gate) * up
# 64 gate columns and their 64 up columns), a warp 16 of them, for the
# SERVE_STEP-byte k-steps of its K split, and walks the slots in token tiles
# (``serve_token_tile``) through a ring of ``serve_stages`` steps. The K
# splits come from N and K alone (``serve_plan``), so a row's sums depend
# neither on B nor on the tile. The rows' prologue takes SERVE_PREP_K
# elements of a row a block; K7's lora_down SERVE_LORA_K rows and
# SERVE_LORA_C columns of lora_af a block.
SERVE_WARPS, SERVE_COLS, SERVE_STEP = 8, 128, 64
SERVE_SPLIT_TARGET, SERVE_MAX_SPLITS, SERVE_MIN_SPLIT_STEPS = 128, 4, 8
SERVE_PREP_K, SERVE_LORA_K, SERVE_LORA_C = 512, 256, 8


class ServePlan(NamedTuple):
    blocks: int  # column blocks (gridDim.x)
    splits: int  # K splits (gridDim.y)
    steps: int  # SERVE_STEP-byte k-steps of a column

    def split_steps(self, sp: int) -> range:
        """The k-steps split ``sp`` takes."""
        return range(sp * self.steps // self.splits, (sp + 1) * self.steps // self.splits)


def serve_plan(N: int, K: int) -> ServePlan:
    """How a bf16 product of K7 or K9 cuts its work at K -> N (N = 2I under
    SiLU(gate) * up): the splits double while the column blocks fall short of
    SERVE_SPLIT_TARGET and each split keeps SERVE_MIN_SPLIT_STEPS steps, at
    most SERVE_MAX_SPLITS; the last block of a column block to arrive merges
    the splits in split order (csrc/serve_layer.cu plan_splits)."""
    blocks, steps = N // SERVE_COLS, K // 2 // SERVE_STEP
    splits = 1
    while blocks * splits < SERVE_SPLIT_TARGET and splits < SERVE_MAX_SPLITS and \
            steps // (2 * splits) >= SERVE_MIN_SPLIT_STEPS:
        splits *= 2
    return ServePlan(blocks, splits, steps)


def serve_columns(block: int, N: int, swiglu: bool) -> List[int]:
    """The columns of a block in its local order (csrc/serve_layer.cu
    col_of): SERVE_COLS adjacent ones, or under SiLU(gate) * up the gate
    columns 64 b .. 64 b + 63 then their up columns N/2 + the same."""
    if swiglu:
        gate = list(range(64 * block, 64 * block + 64))
        return gate + [N // 2 + j for j in gate]
    return list(range(SERVE_COLS * block, SERVE_COLS * (block + 1)))


def serve_token_tile(B: int) -> int:
    """Slots of the products' token tile at B slots: the fewest of 8, 16, 32,
    64, 128 that hold B, at most 128 (more slots go in tiles of 128)."""
    return next((t for t in (8, 16, 32, 64) if B <= t), 128)


SERVE_ONE_WAVE = 132  # blocks of a product's grid that takes the deep ring (an SM each)


def serve_stages(tile: int, deep: bool = False) -> int:
    """Steps in the products' ring at a token tile (csrc/serve_layer.cu
    stages): two blocks an SM up to 64 slots, or ``deep`` (a grid of at most
    SERVE_ONE_WAVE blocks, ``blocks * splits`` of its plan) one block an SM
    with a deeper ring."""
    nt = tile // 8
    if deep:
        return 8 if nt <= 8 else 4
    return 5 if nt <= 4 else 4 if nt == 8 else 3


def _check_serve_layout(config, B: int, what: str):
    D, I, gs = config.n_embd, config.intermediate_size, config.quant_groupsize
    if config.head_size != 128:
        raise ValueError(f"{what} takes head size 128, got {config.head_size}")
    if B < 1:
        raise ValueError(f"{what} takes at least one slot, got {B}")
    if D % 128 or I % 128:
        raise ValueError(f"{what} needs n_embd and the intermediate size divisible by 128 (got {D}, {I})")
    return D, I, gs


def _serve_keys(x):
    """What each body of K7 and K9 reads: in bf16 the decode layout's nibbles
    and the shared layout's (G, N) scale and zero planes (a block's columns
    of a group are one run), in f32 the shared layout."""
    return ("qw_t", "qscale", "qzero") if x.dtype == torch.bfloat16 else _SHARED_KEYS


def check_block_head(x, rms1, cos, sin, ca: Params, config):
    """What K7 takes, on any device: x (B, D) bf16 or f32 (the compute dtype)
    at any B >= 1, rms_1 bf16 or f32, (B, 128) f32 cos/sin rows, c_attn's
    layout for the dtype and a LoRA operand of any multiple of 8 columns,
    bf16 or f32. Raises ValueError otherwise."""
    B = x.shape[0]
    D, _, gs = _check_serve_layout(config, B, "K7")
    _check_row(x, B, D, "K7")
    _check_norm(rms1, D, "K7")
    for t in (cos, sin):
        if t.dtype != torch.float32 or t.shape != (B, 128) or not t.is_contiguous():
            raise ValueError(f"K7 takes contiguous f32 ({B}, 128) cos/sin rows")
    _check_q4(ca, D, 3 * D, gs, "K7 c_attn", _serve_keys(x))
    _lora_operand(ca, "K7 c_attn", D)


def block_head_fused(x, rms1, cos, sin, ca: Params, config):
    """rms_1 + int4 QKV product + half-basis RoPE for B serving slots.

    x (B, D) compute dtype; rms1 (D,); cos/sin (B, hs) f32 rows at each
    slot's position (``rope.slot_rope_rows``, sin signed); ca the prepared
    c_attn. Returns the rotated fused qkv (B, 3D) in x.dtype: q and k rotated,
    v as it is. With the folded LoRA operand in ``ca`` (``lora_af``,
    ``lora_bf``) the update is added before the rotation. A CPU tensor takes
    the plain version; a CUDA tensor launches K7 or raises."""
    if not x.is_cuda:
        return block_head_fused_ref(x, rms1, cos, sin, ca, config)
    check_block_head(x, rms1, cos, sin, ca, config)
    B = x.shape[0]
    D, gs = config.n_embd, config.quant_groupsize
    keys = _serve_keys(x)
    la, lb, R8 = _lora_operand(ca, "K7 c_attn", D)
    _on_card("K7", x, rms1, cos, sin, la, lb, *_w_keys([ca], keys))
    cbf16 = x.dtype == torch.bfloat16
    dev = x.device
    splits = serve_plan(3 * D, D).splits if cbf16 else quant_matmul.f32_splits(3 * D, D, dev)
    buf, (xb, hsum, h32, acc, ws, ax, axpart) = _scratch(
        dev, B * D * 2 * cbf16, B * (D // 64) * 4 * cbf16, B * D * 4 * bool(R8 or not cbf16),
        B * 3 * D * 4 * (not cbf16), splits * B * 3 * D * 4 * (splits > 1), B * R8 * 4,
        -(-D // SERVE_LORA_K) * B * R8 * 4)
    counter = decode_attention.arrival_counters(max(3 * D // SERVE_COLS, R8 // SERVE_LORA_C), dev)
    qkv = torch.empty((B, 3 * D), dtype=x.dtype, device=dev)
    lib = _build.library("serve_layer", _SERVE_SIGS)
    err = lib.k7_block_head(
        x.data_ptr(), rms1.data_ptr(), int(rms1.dtype == torch.bfloat16), int(cbf16),
        *[t.data_ptr() for t in _w_keys([ca], keys)],
        cos.data_ptr(), sin.data_ptr(), xb, hsum, h32, acc, ws, splits, counter.data_ptr(),
        _ptr(la), _ptr(lb), ax, axpart, R8, int(R8 == 0 or la.dtype == torch.bfloat16), qkv.data_ptr(),
        B, D, gs, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "K7 block_head_fused")
    k7_lora.launches += bool(R8)
    block_head_fused.launches += 1
    return qkv


block_head_fused.launches = 0


def check_block_tail(x, y, rms2, cp: Params, f12: Params, mp: Params, config):
    """What K9 takes, on any device: x and y (B, D) in one compute dtype, bf16
    or f32, at any B >= 1, rms_2 bf16 or f32, and the layout of the three
    linears for the dtype. Raises ValueError otherwise."""
    B = x.shape[0]
    D, I, gs = _check_serve_layout(config, B, "K9")
    _check_row(x, B, D, "K9 x")
    _check_row(y, B, D, "K9 y", x.dtype)
    _check_norm(rms2, D, "K9")
    keys = _serve_keys(x)
    _check_q4(cp, D, D, gs, "K9 attn.c_proj", keys)
    _check_q4(f12, D, 2 * I, gs, "K9 c_fc12", keys)
    _check_q4(mp, I, D, gs, "K9 mlp.c_proj", keys)


def block_tail_fused(x, y, rms2, cp: Params, f12: Params, mp: Params, config):
    """Everything of a block after its attention, for B serving slots:
    x + c_proj(y), rms_2, c_fc12, SiLU(gate) * up, mlp c_proj + residual.

    x (the residual stream) and y (the attention output), both (B, D) in the
    compute dtype; cp, f12, mp the prepared attn c_proj, c_fc12 and mlp c_proj.
    Returns the new x (B, D). The residual and the MLP intermediates are f32
    inside at every B. A CPU tensor takes the plain version; a CUDA tensor
    launches K9 or raises."""
    if not x.is_cuda:
        return block_tail_fused_ref(x, y, rms2, cp, f12, mp, config)
    check_block_tail(x, y, rms2, cp, f12, mp, config)
    B = x.shape[0]
    D, I, gs = config.n_embd, config.intermediate_size, config.quant_groupsize
    keys = _serve_keys(x)
    _on_card("K9", x, y, rms2, *_w_keys([cp, f12, mp], keys))
    cbf16 = x.dtype == torch.bfloat16
    dev = x.device
    shapes = ((D, D), (D, 2 * I), (I, D))  # (K, N) of attn c_proj, c_fc12, mlp c_proj
    if cbf16:
        splits = [serve_plan(N, K).splits for K, N in shapes]
    else:
        splits = [quant_matmul.f32_splits(N, K, dev) for K, N in shapes]
    ws = max(s * N for s, (_, N) in zip(splits, shapes)) * B * 4 if max(splits) > 1 else 0
    # bf16: xb, hsum, xb2, hsum2, ssq; f32: xb (the normed row), gg, acc
    buf, (xs, xb, hsum, xb2, hsum2, ssq, gg, acc, ws) = _scratch(
        dev, B * D * 4, B * D * (2 if cbf16 else 4), B * (D // 64) * 4 * cbf16, B * I * 2 * cbf16,
        B * (I // 64) * 4 * cbf16, B * (D // 64) * 4 * cbf16, B * I * 4 * (not cbf16),
        B * max(D, 2 * I) * 4 * (not cbf16), ws)
    counter = decode_attention.arrival_counters(max(N // SERVE_COLS for _, N in shapes), dev)
    out = torch.empty_like(x)
    lib = _build.library("serve_layer", _SERVE_SIGS)
    err = lib.k9_block_tail(
        x.data_ptr(), y.data_ptr(), rms2.data_ptr(), int(rms2.dtype == torch.bfloat16), int(cbf16),
        *[t.data_ptr() for t in _w_keys([cp, f12, mp], keys)],
        xb, hsum, xb2, hsum2, ssq, xs, gg, acc, out.data_ptr(), ws, counter.data_ptr(),
        *splits, B, D, I, gs, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "K9 block_tail_fused")
    block_tail_fused.launches += 1
    return out


block_tail_fused.launches = 0


def use_serve_fused(config, layer_params: Params, batch: Optional[int] = None) -> bool:
    """Whether the batched serving step takes the fused block halves (K7, K8,
    K9): int4 weights with c_fc12 fused, in the half-rotation basis, head size
    128, a LoRA overlay folded into K7's operand, and at most
    ``SERVE_KERNEL_MAX_B`` slots (``batch``, when known). The JAX package also
    asks its backend and three environment switches; the card always takes
    the kernels."""
    if batch is not None and batch > SERVE_KERNEL_MAX_B:
        return False
    if config.rope_layout != "half" or config.head_size != 128:
        return False
    c_attn = layer_params.get("attn", {}).get("c_attn", {})
    if config.lora is not None and "lora_af" not in c_attn:
        return False
    return "qzero" in c_attn and "c_fc12" in layer_params.get("mlp", {})


# ---------------------------------------------------------------------------
# Parameter preparation (once, at load)
# ---------------------------------------------------------------------------


def half_basis_perm(hs: int) -> torch.Tensor:
    """Per-head column permutation interleaved -> half-rotation basis: new
    column j < hs/2 holds old 2j, new j >= hs/2 holds old 2(j - hs/2) + 1."""
    half = hs // 2
    return torch.cat([torch.arange(half) * 2, torch.arange(half) * 2 + 1])


def _head_perm(D: int, hs: int) -> torch.Tensor:
    H = D // hs
    return (torch.arange(H)[:, None] * hs + half_basis_perm(hs)[None, :]).reshape(-1)


def permute_qk_columns(c_attn: Params, D: int, hs: int) -> Params:
    """Permute the q and k head columns of the fused QKV linear to the
    half-rotation basis (v untouched), on every (..., 3D)-trailing leaf."""
    head_perm = _head_perm(D, hs)
    full = torch.cat([head_perm, D + head_perm, 2 * D + torch.arange(D)])
    out = {}
    for k, v in c_attn.items():
        out[k] = v.index_select(-1, full.to(v.device)) if v.shape[-1] == 3 * D else v
    return out


def fused_layer_supported(config, params) -> bool:
    """Whether the fused decode path (K1/K2 on the card) takes this model. A
    LoRA model qualifies once its overlay is loaded (prepare_fused_params
    folds it into the kernels' operand); an adapter model does not."""
    if config.quantize != "int4" or config.kv_cache_dtype is not None:
        return False
    if config.adapter is not None:
        return False
    h = params.get("h")
    if config.lora is not None:
        lp0 = h[0] if isinstance(h, (list, tuple)) else h
        if "lora_a" not in (lp0 or {}).get("attn", {}).get("c_attn", {}):
            return False
    if config.head_size != 128:
        return False
    D, I, gs = config.n_embd, config.intermediate_size, config.quant_groupsize
    if gs not in (64, 128, 256):
        return False
    for K in (D, I):
        if K % gs or (K // gs) % 2:
            return False
    if D % 4 or I % 4:
        return False
    if not isinstance(h, (list, tuple)):
        return False
    lp = h[0]
    return "qw" in lp.get("attn", {}).get("c_attn", {}) and "c_fc12" in lp.get("mlp", {})


def _with_decode_layout(w: Params) -> Params:
    if "qzero" not in w:
        return w
    return {**w, **{k: w[src].t().contiguous() for k, src in zip(_DECODE_KEYS, ("qw", "qscale", "qzero"))}}


def add_decode_layout(params: Params) -> Params:
    """Add the kernels' column-major copy (qw_t, qscale_t, qzero_t) to every
    int4 linear of unstacked layers and to the lm_head. Costs one more copy
    of the int4 weights on the device."""
    out = dict(params)
    out["h"] = [
        {**lp, "attn": {k: _with_decode_layout(v) for k, v in lp["attn"].items()},
         "mlp": {k: _with_decode_layout(v) for k, v in lp["mlp"].items()}}
        for lp in params["h"]
    ]
    out["lm_head"] = _with_decode_layout(params["lm_head"])
    return out


def prepare_lora_operands(c_attn: Params, lora_cfg, D: int, hs: int) -> Params:
    """The folded LoRA operand of K1 and K7, added to a c_attn whose q/k
    columns are already in the half basis.

    The update qkv += scaling * zero_pad((x @ A) grouped by B)
    (``peft.lora.lora_delta``) becomes two dense matrices:
    ``lora_af`` (D, R8), A zero-padded to a multiple of 8 columns, and
    ``lora_bf`` (R8, 3D), each enabled group's B block in its q/k/v output
    slot with ``scaling`` folded in and the q/k sections permuted to the half
    basis, both in A's dtype. The stored ``lora_b`` q/k groups are permuted
    the same way, so the per-op prefill gives the same rotated update."""
    a, b = c_attn["lora_a"], c_attn["lora_b"]  # (D, n_en * r), (n_en, r, D)
    n_en, r = b.shape[0], b.shape[1]
    R = n_en * r
    R8 = -(-R // 8) * 8
    head_perm = _head_perm(D, hs).to(b.device)
    bf = torch.zeros((R, 3 * D), dtype=torch.float32, device=b.device)
    b_perm = []
    g = 0
    for i, enabled in enumerate(lora_cfg.enable):  # groups are (q, k, v)
        if not enabled:
            continue
        bg = b[g].float()
        if i < 2:  # q and k columns live in the half-rotation basis
            bg = bg[..., head_perm]
        b_perm.append(bg)
        bf[g * r : (g + 1) * r, i * D : (i + 1) * D] = bg * lora_cfg.scaling
        g += 1
    out = dict(c_attn)
    out["lora_b"] = torch.stack(b_perm).to(b.dtype)
    out["lora_af"] = F.pad(a.float(), (0, R8 - R)).to(a.dtype)
    out["lora_bf"] = F.pad(bf, (0, 0, 0, R8 - R)).to(a.dtype)
    return out


def prepare_fused_params(params: Params, config) -> Tuple[Params, Any]:
    """Unstacked int4 params -> the fused decode layout: c_attn q/k columns
    permuted to the half-rotation basis, a LoRA overlay (with ``config.lora``)
    folded into the kernels' operand (prepare_lora_operands), and the
    kernels' decode copy of every int4 linear (add_decode_layout). Returns
    (params, config with ``rope_layout="half"``), so the prefill forward
    applies the matching rotation."""
    D, hs = config.n_embd, config.head_size
    out = dict(params)
    layers = []
    for lp in params["h"]:
        lp = dict(lp)
        attn = dict(lp["attn"])
        attn["c_attn"] = permute_qk_columns(dict(attn["c_attn"]), D, hs)
        if "lora_a" in attn["c_attn"] and config.lora is not None:
            attn["c_attn"] = prepare_lora_operands(attn["c_attn"], config.lora, D, hs)
        lp["attn"] = attn
        layers.append(lp)
    out["h"] = layers
    return add_decode_layout(out), config.replace(rope_layout="half")


def maybe_prepare_fused(params: Params, config) -> Tuple[Params, Any]:
    """The entry points' dispatch: unstacked params that the fused path takes
    (fused_layer_supported) are prepared once; anything else, and params
    already prepared, come back as they are."""
    if config.rope_layout == "half" or not fused_layer_supported(config, params):
        return params, config
    return prepare_fused_params(params, config)
