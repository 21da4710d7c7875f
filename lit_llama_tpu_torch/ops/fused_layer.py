"""Fused decode kernels with their plain versions (counterpart of
lit_llama_tpu/ops/fused_layer.py): K1 and K2 for one stream, K7 and K9 for
the batched serving step.

``decode_layers_fused`` replaces the Pallas ``_layer_kernel``
(lit_llama_tpu/ops/fused_layer.py, entry ``decode_layers_fused``): one decode
token through whole blocks, launching the fixed sequence of CUDA kernels in
``csrc/fused_layer.cu`` per block. ``lm_head_fused`` replaces ``_head_kernel``
(entry ``lm_head_fused``): the final RMSNorm and the int4 lm_head matvec.
What bounds them and how their design answers that is noted in the source.

``block_head_fused`` replaces ``_block_head_kernel`` (entry
``block_head_fused``): rms_1, the int4 QKV product and the half-basis RoPE
for B serving slots, each at its own position. ``block_tail_fused`` replaces
``_block_tail_kernel`` (entry ``block_tail_fused``): everything of the block
after its attention. Both are in ``csrc/serve_layer.cu``; between them runs
``ops.decode_attention.decode_attention_write``. They take any B from 1 to
64 (no padding to 8 rows), per-slot (B, hs) cos/sin rows in place of the
(B, 3D) lane tables, and keep f32 intermediates at every B: the Pallas
kernel's switch to the compute dtype at 48 rows is a VMEM limit. On the
serving path q, k and v leave the head in the compute dtype, so q is rounded
before the attention (K1 keeps it f32).

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
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from lit_llama_tpu_torch.ops import _build

Params = Dict[str, Any]

NEG_INF = -1e30
CHUNK = 64  # cache slots per attention block (csrc/fused_layer.cu)

_P, _I = _build.PTR, _build.INT
_SIGS = {
    "k1_decode_layer": [_P, _I, _P, _P] + [_P] * 12 + [_P] * 4 + [_P] * 6 + [_I] * 7 + [_P],
    "k2_lm_head": [_P] * 6 + [_I] * 3 + [_P],
}
_SERVE_SIGS = {
    "k7_block_head": [_P] * 10 + [_I] * 3 + [_P],
    "k9_block_tail": [_P] * 17 + [_I] * 4 + [_P],
}
MAX_SLOTS = 64  # rows a serving kernel takes (csrc/serve_layer.cu)


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


def decode_layers_fused_ref(x, lps, kvs, cosf, sinf, write_pos: int, limit: int, config):
    """Plain version of :func:`decode_layers_fused` (same in-place cache update)."""
    D, H, hs = config.n_embd, config.n_head, config.head_size
    I = config.intermediate_size
    cd = x.dtype
    xs = x.float()
    for lp, kv in zip(lps, kvs):
        attn, mlp = lp["attn"], lp["mlp"]
        qkv = mv_int4_ref(_rms_rows(xs, lp["rms_1"]), attn["c_attn"], cd)
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
    qkv = mv_int4_ref(_rms_rows(x.float(), rms1), ca, x.dtype)
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


def _check_q4(w: Params, K: int, N: int, gs: int, what: str):
    """The kernels read the decode layout added by prepare_fused_params."""
    if "lora_a" in w:
        raise NotImplementedError(f"{what}: the LoRA operands of K1 are a later slice")
    if gs not in (64, 128, 256) or K % gs or (K // gs) % 2:
        raise ValueError(f"{what}: needs gs in (64, 128, 256) and an even group count (K={K} gs={gs})")
    if "qw_t" not in w:
        raise ValueError(f"{what}: no decode layout (qw_t); prepare the params with prepare_fused_params")
    qw, qs, qz = (w[k] for k in _DECODE_KEYS)
    G = K // gs
    if qw.dtype != torch.uint8 or qw.shape != (N, K // 2):
        raise ValueError(f"{what}: qw_t must be uint8 {(N, K // 2)}, got {qw.dtype} {tuple(qw.shape)}")
    for t in (qs, qz):
        if t.dtype != torch.float32 or t.shape != (N, G):
            raise ValueError(f"{what}: qscale_t/qzero_t must be float32 {(N, G)}")
    for t in (qw, qs, qz):
        if not t.is_cuda or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: weights must be contiguous, 16-byte aligned CUDA tensors")


def _check_layout(config):
    if config.head_size != 128:
        raise ValueError(f"K1 takes head size 128, got {config.head_size}")
    if config.intermediate_size % 4:
        raise ValueError("K1 needs the intermediate size divisible by 4")


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
    _check_layout(config)
    D, H, hs = config.n_embd, config.n_head, config.head_size
    I, gs = config.intermediate_size, config.quant_groupsize
    S = kvs[0]["k"].shape[-2]
    if x.dtype != torch.bfloat16 or x.shape != (1, D) or not x.is_contiguous():
        raise ValueError(f"K1 takes a contiguous bf16 (1, {D}) row, got {x.dtype} {tuple(x.shape)}")
    for t in (cosf, sinf):
        if t.dtype != torch.float32 or t.shape != (1, hs) or not t.is_contiguous():
            raise ValueError("K1 takes contiguous f32 (1, hs) cos/sin rows")
    if not 0 <= write_pos < S or limit < write_pos:
        raise ValueError(f"K1: write_pos {write_pos} outside [0, {S}) or above limit {limit}")
    for lp, kv in zip(lps, kvs):
        for name in ("k", "v"):
            c = kv[name]
            if c.dtype != torch.bfloat16 or c.shape != (1, H, S, hs) or not c.is_contiguous():
                raise ValueError(f"K1 takes contiguous bf16 (1, {H}, {S}, {hs}) caches")
        for name in ("rms_1", "rms_2"):
            if lp[name].dtype != torch.bfloat16 or lp[name].shape != (D,):
                raise ValueError(f"K1 takes bf16 ({D},) norm weights")
        _check_q4(lp["attn"]["c_attn"], D, 3 * D, gs, "K1 c_attn")
        _check_q4(lp["attn"]["c_proj"], D, D, gs, "K1 attn.c_proj")
        _check_q4(lp["mlp"]["c_fc12"], D, 2 * I, gs, "K1 c_fc12")
        _check_q4(lp["mlp"]["c_proj"], I, D, gs, "K1 mlp.c_proj")

    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    qkv = torch.empty(3 * D, **f32)
    part = torch.empty(H * (-(-S // CHUNK)) * (hs + 2), **f32)
    y = torch.empty(D, **f32)
    xs = torch.empty(D, **f32)
    gg = torch.empty(I, **f32)
    x_out = torch.empty_like(x)
    lib = _build.library("fused_layer", _SIGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    n = len(lps)
    for j, (lp, kv) in enumerate(zip(lps, kvs)):
        a, m = lp["attn"], lp["mlp"]
        ws = [a["c_attn"], a["c_proj"], m["c_fc12"], m["c_proj"]]
        err = lib.k1_decode_layer(
            (x if j == 0 else xs).data_ptr(), int(j == 0),
            lp["rms_1"].data_ptr(), lp["rms_2"].data_ptr(),
            *[w[key].data_ptr() for w in ws for key in _DECODE_KEYS],
            kv["k"].data_ptr(), kv["v"].data_ptr(), cosf.data_ptr(), sinf.data_ptr(),
            qkv.data_ptr(), part.data_ptr(), y.data_ptr(), xs.data_ptr(), gg.data_ptr(),
            x_out.data_ptr() if j == n - 1 else None,
            D, I, H, S, gs, int(write_pos), int(limit), stream,
        )
        _build.check(err, "K1 decode_layers_fused")
    decode_layers_fused.launches += 1
    return x_out, list(kvs)


decode_layers_fused.launches = 0


def decode_layer_fused(x, lp, kv, cosf, sinf, write_pos, limit, config):
    """One block: returns (x_out (1, D), the cache dict, written in place)."""
    xo, kvs = decode_layers_fused(x, (lp,), (kv,), cosf, sinf, write_pos, limit, config)
    return xo, kvs[0]


def lm_head_fused(x, ln_w, head: Params, config):
    """Final RMSNorm + int4 lm_head for one decode token: (1, D) -> (1, V) in
    x.dtype. A CPU tensor takes the plain version; a CUDA tensor launches K2
    or raises."""
    if not x.is_cuda:
        return lm_head_fused_ref(x, ln_w, head, config)
    D, gs = config.n_embd, config.quant_groupsize
    V = head["qw"].shape[-1]
    if x.dtype != torch.bfloat16 or x.shape != (1, D) or not x.is_contiguous():
        raise ValueError(f"K2 takes a contiguous bf16 (1, {D}) row")
    if ln_w.dtype != torch.bfloat16 or ln_w.shape != (D,):
        raise ValueError(f"K2 takes a bf16 ({D},) norm weight")
    _check_q4(head, D, V, gs, "K2 lm_head")
    logits = torch.empty((1, V), dtype=torch.bfloat16, device=x.device)
    lib = _build.library("fused_layer", _SIGS)
    err = lib.k2_lm_head(
        x.data_ptr(), ln_w.data_ptr(), *[head[key].data_ptr() for key in _DECODE_KEYS],
        logits.data_ptr(), D, V, gs, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "K2 lm_head_fused")
    lm_head_fused.launches += 1
    return logits


lm_head_fused.launches = 0


def _check_rows(x, B, D, what: str):
    if x.dtype != torch.bfloat16 or x.shape != (B, D) or not x.is_contiguous() or not x.is_cuda:
        raise ValueError(f"{what} takes contiguous bf16 ({B}, {D}) CUDA rows, got {x.dtype} {tuple(x.shape)}")


def _check_serve_layout(config, B: int, what: str):
    D, I, gs = config.n_embd, config.intermediate_size, config.quant_groupsize
    if config.head_size != 128:
        raise ValueError(f"{what} takes head size 128, got {config.head_size}")
    if not 1 <= B <= MAX_SLOTS:
        raise ValueError(f"{what} takes 1 to {MAX_SLOTS} slots, got {B}")
    if D % 128 or I % 128:
        raise ValueError(f"{what} needs n_embd and the intermediate size divisible by 128 (got {D}, {I})")
    return D, I, gs


def block_head_fused(x, rms1, cos, sin, ca: Params, config):
    """rms_1 + int4 QKV product + half-basis RoPE for B serving slots.

    x (B, D) compute dtype; rms1 (D,); cos/sin (B, hs) f32 rows at each
    slot's position (``rope.slot_rope_rows``, sin signed); ca the prepared
    c_attn. Returns the rotated fused qkv (B, 3D) in x.dtype: q and k rotated,
    v as it is. A CPU tensor takes the plain version; a CUDA tensor launches
    K7 or raises."""
    if "lora_af" in ca or "lora_a" in ca:
        raise NotImplementedError("K7: the LoRA operands of the block head are a later slice")
    if not x.is_cuda:
        return block_head_fused_ref(x, rms1, cos, sin, ca, config)
    B = x.shape[0]
    D, _, gs = _check_serve_layout(config, B, "K7")
    _check_rows(x, B, D, "K7")
    if rms1.dtype != torch.bfloat16 or rms1.shape != (D,):
        raise ValueError(f"K7 takes a bf16 ({D},) norm weight")
    for t in (cos, sin):
        if t.dtype != torch.float32 or t.shape != (B, 128) or not t.is_contiguous() or not t.is_cuda:
            raise ValueError(f"K7 takes contiguous f32 ({B}, 128) cos/sin rows on the card")
    _check_q4(ca, D, 3 * D, gs, "K7 c_attn")
    xb = torch.empty((B, D), dtype=torch.bfloat16, device=x.device)
    gx = torch.empty((B, D // gs), dtype=torch.float32, device=x.device)
    qkv = torch.empty((B, 3 * D), dtype=torch.bfloat16, device=x.device)
    lib = _build.library("serve_layer", _SERVE_SIGS)
    err = lib.k7_block_head(
        x.data_ptr(), rms1.data_ptr(), *[ca[key].data_ptr() for key in _DECODE_KEYS],
        cos.data_ptr(), sin.data_ptr(), xb.data_ptr(), gx.data_ptr(), qkv.data_ptr(),
        B, D, gs, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "K7 block_head_fused")
    block_head_fused.launches += 1
    return qkv


block_head_fused.launches = 0


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
    B = x.shape[0]
    D, I, gs = _check_serve_layout(config, B, "K9")
    _check_rows(x, B, D, "K9 x")
    _check_rows(y, B, D, "K9 y")
    if rms2.dtype != torch.bfloat16 or rms2.shape != (D,):
        raise ValueError(f"K9 takes a bf16 ({D},) norm weight")
    _check_q4(cp, D, D, gs, "K9 attn.c_proj")
    _check_q4(f12, D, 2 * I, gs, "K9 c_fc12")
    _check_q4(mp, I, D, gs, "K9 mlp.c_proj")
    dev, W = x.device, max(D, I)
    xb = torch.empty((B, W), dtype=torch.bfloat16, device=dev)
    gx = torch.empty((B, W // gs), dtype=torch.float32, device=dev)
    xs = torch.empty((B, D), dtype=torch.float32, device=dev)
    gg = torch.empty((B, I), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    lib = _build.library("serve_layer", _SERVE_SIGS)
    err = lib.k9_block_tail(
        x.data_ptr(), y.data_ptr(), rms2.data_ptr(),
        *[w[key].data_ptr() for w in (cp, f12, mp) for key in _DECODE_KEYS],
        xb.data_ptr(), gx.data_ptr(), xs.data_ptr(), gg.data_ptr(), out.data_ptr(),
        B, D, I, gs, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "K9 block_tail_fused")
    block_tail_fused.launches += 1
    return out


block_tail_fused.launches = 0


def use_serve_fused(config, layer_params: Params) -> bool:
    """Whether the batched serving step takes the fused block halves (K7, K8,
    K9): int4 weights with c_fc12 fused, in the half-rotation basis, head size
    128. The JAX package also asks its backend, a slot-count cap and three
    environment switches; the card always takes the kernels."""
    if config.rope_layout != "half" or config.head_size != 128:
        return False
    c_attn = layer_params.get("attn", {}).get("c_attn", {})
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
    """Whether the fused decode path (K1/K2 on the card) takes this model."""
    if config.quantize != "int4" or config.kv_cache_dtype is not None:
        return False
    if config.adapter is not None or config.lora is not None:
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
    h = params.get("h")
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


def prepare_fused_params(params: Params, config) -> Tuple[Params, Any]:
    """Unstacked int4 params -> the fused decode layout: c_attn q/k columns
    permuted to the half-rotation basis, and the kernels' decode copy of every
    int4 linear (add_decode_layout). Returns (params, config with
    ``rope_layout="half"``), so the prefill forward applies the matching
    rotation."""
    D, hs = config.n_embd, config.head_size
    out = dict(params)
    layers = []
    for lp in params["h"]:
        lp = dict(lp)
        attn = dict(lp["attn"])
        attn["c_attn"] = permute_qk_columns(dict(attn["c_attn"]), D, hs)
        lp["attn"] = attn
        layers.append(lp)
    out["h"] = layers
    return add_decode_layout(out), config.replace(rope_layout="half")
