"""Single-query attention against the KV cache: kernels K5 and K8 and their
plain versions (counterpart of lit_llama_tpu/ops/decode_attention.py).

``decode_attention`` (K5; ``decode_attention_pallas`` is the JAX package's
name for it and is kept as an alias) replaces the Pallas ``_kernel``: one
query per (batch row, head) against a cache that is already written, a bf16
cache or an int8 cache with one f32 scale per row, whose scales are folded
into the score (k) and into the softmax weight (v). Row ``s`` is visible to
batch row ``b`` iff ``s <= limit[b]``; ``limit`` stays on the device. On the
card it takes every cached single-token step of the per-op decode path, at
any B and S, bf16 and int8 cache alike: the TPU's measured gates (S >= 1024,
S % 128 == 0, B == 1, int8 left to the dequantizing path) are not carried
over. It takes head sizes that are multiples of 128 (``decode_route``, the
shape condition of JAX's ``use_decode_attention``); the model sends other
head sizes to the plain version, as JAX runs ``attention_xla`` there. The
kernel takes bf16 or f32 compute and every head size that is a multiple of
128 (``check_decode``); in bf16 at head size 128 or 256 it runs the split body
of csrc/decode_sm90.cuh, whose splits ``decode_plan`` gives from S and hs
alone (a row's bits do not depend on the batch), with a scratch and arrival
counters the wrapper owns (``k5_scratch``, ``arrival_counters``);
the plain version takes any float dtype and head size. Products are rounded
to the cache's compute dtype (``q.dtype``) and summed in f32, as in the Pallas
kernel.

``decode_attention_write`` replaces both Pallas kernels that compute this
function, ``_pipe_kernel`` (entry ``decode_attention_write_pipelined``, the
JAX default) and ``_write_attn_kernel`` (entry
``decode_attention_write_pallas``), with the one CUDA kernel in
``csrc/decode_attention.cu``; the two named entries are kept and lead to it.
What bounds it and how its design answers that is noted in the source.

Each of the B slots is an independent sequence at position ``slot_pos[b]``:
its new k/v row is written at ``slot_pos[b] % S`` (a ring past the cache),
and row ``s`` is visible iff ``s <= slot_pos[b]``, so a slot at or past
``S - 1`` sees every row. The cache is a plain (B, H, S, hs) tensor updated IN
PLACE; the packed u32 pair cache of the TPU toolchain is not carried over.
The new rows are cast to ``q.dtype`` before they are stored; scores and the
softmax are f32, and the probabilities stay f32 for the weighted sum.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from lit_llama_tpu_torch.ops import _build

NEG_INF = -1e30
CHUNK = 64  # cache rows per attention block of the first port's bodies (csrc/attention_chunk.cuh)
# the split body (csrc/decode_sm90.cuh): a split is a multiple of SPLIT_QUANTUM
# rows, at most MAX_SPLITS a (batch row, head); a block of SPLIT_WARPS warps,
# each streaming tiles of SPLIT_LOADS 16-byte pieces a lane through a ring of
# SPLIT_STAGES tiles
SPLIT_QUANTUM, MAX_SPLITS = 64, 8
SPLIT_WARPS, SPLIT_LOADS, SPLIT_STAGES = 4, 8, 2
SPLIT_HEAD_SIZES = (128, 256)

_P, _I = _build.PTR, _build.INT
_SIGS = {  # both entries of csrc/decode_attention.cu
    "k8_decode_attention_write": [_P] * 3 + [_I] * 3 + [_P] * 5 + [_I] * 4 + [_P],
    "k5_decode_attention": [_P, _I] + [_P] * 8 + [_I] * 6 + [_P],
}
HEAD_SIZE_STEP = 128  # K5 takes every head size that is a multiple; K8 takes 128
DTYPES = (torch.bfloat16, torch.float32)


class DecodePlan(NamedTuple):
    """How the split body cuts a (batch row, head)'s cache: ``split_rows``
    rows a split (a block), ``n_splits`` splits."""

    split_rows: int
    n_splits: int


def decode_plan(S: int, hs: int) -> DecodePlan:
    """The splits of the single-query attention of K5 and K1 on the card
    (``split_rows`` / ``n_splits`` in csrc/decode_sm90.cuh): a pure function
    of the cache length and the head size, never of the batch or the limit,
    so a row's output has the same bits at any B. At most ``MAX_SPLITS``
    splits, each a multiple of ``SPLIT_QUANTUM`` rows."""
    if S < 1 or hs not in SPLIT_HEAD_SIZES:
        raise ValueError(f"the split body takes S >= 1 and a head size in {SPLIT_HEAD_SIZES}, got S={S} hs={hs}")
    rows = -(-(-(-S // MAX_SPLITS)) // SPLIT_QUANTUM) * SPLIT_QUANTUM
    return DecodePlan(rows, -(-S // rows))


def uses_split_body(hs: int, dtype: torch.dtype) -> bool:
    """Whether K5 (and K1's attention) run the split body: bf16 compute at
    head size 128 or 256; f32 and wider heads keep the first port's bodies."""
    return dtype == torch.bfloat16 and hs in SPLIT_HEAD_SIZES


def k5_scratch(B: int, H: int, S: int, hs: int, dtype: torch.dtype) -> Tuple[int, int]:
    """(floats of the partial scratch, int32 arrival counters) K5 takes."""
    if uses_split_body(hs, dtype):
        return B * H * decode_plan(S, hs).n_splits * (hs + 2), B * H
    return B * H * (-(-S // CHUNK)) * (hs + 2), 0


_buffers: Dict[Tuple[str, int, int, torch.dtype], torch.Tensor] = {}


def stream_buffer(n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """A persistent buffer of at least ``n`` zeros of ``dtype`` on ``device``,
    for the current stream: scratch that a kernel keeps across launches (the
    split bodies' arrival counters, K6's partials at M = 1). The launches of
    one stream run in order and share a buffer; launches on two streams would
    write into each other's, so each stream has its own. It grows (a new
    zeroed buffer) when a launch needs more."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.current_stream(device).cuda_stream if device.type == "cuda" else 0
    key = (device.type, device.index, stream, dtype)
    buf = _buffers.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 64), dtype=dtype, device=device)
        _buffers[key] = buf
    return buf


def arrival_counters(n: int, device) -> torch.Tensor:
    """The current stream's int32 ``stream_buffer`` of at least ``n`` zeros:
    the split bodies' arrival counters. Each launch leaves them at zero (the
    last block of a (batch row, head), a tile or a strip resets its own), so
    every kernel of a stream counts in the same buffer."""
    return stream_buffer(n, torch.int32, device)


def decode_route(hs: int) -> bool:
    """Whether a cached single-token step attends through K5 on the card: a
    static predicate on the head size, decided before any launch."""
    return hs % 128 == 0


def decode_attention_write_ref(q, k_new, v_new, kc, vc, slot_pos):
    """Plain version of :func:`decode_attention_write` (same in-place cache
    update)."""
    B, H, S, hs = kc.shape
    pos = slot_pos.long()
    rows = torch.arange(B, device=q.device)
    kc[rows, :, pos % S] = k_new[:, :, 0].to(q.dtype).to(kc.dtype)
    vc[rows, :, pos % S] = v_new[:, :, 0].to(q.dtype).to(vc.dtype)
    s = (kc.float() * q.float()).sum(dim=-1) * (1.0 / math.sqrt(hs))  # (B, H, S)
    visible = torch.arange(S, device=q.device)[None, None, :] <= pos[:, None, None]
    s = torch.where(visible, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    y = (p[..., None] * vc.float()).sum(dim=2) / l
    return y[:, :, None, :].to(q.dtype), kc, vc


def _slot_stride(t, B, H, hs, dtype, what: str) -> int:
    """Elements between two slots of a (B, H, 1, hs) operand whose heads lie
    side by side (a view into the fused qkv rows is taken as it is)."""
    if (t.dtype != dtype or t.shape != (B, H, 1, hs) or t.stride(3) != 1 or (H > 1 and t.stride(1) != hs)):
        raise ValueError(f"{what}: expected {dtype} (B, H, 1, {hs}) with its heads adjoining, "
                         f"got {t.dtype} {tuple(t.shape)} strides {t.stride()}")
    return t.stride(0) if B > 1 else H * hs


def check_decode(q, k, v, ks, vs, limit) -> int:
    """What K5 takes, on any device; returns q's slot stride. q bf16 or f32
    (the compute dtype); k and v contiguous (B, H, S, hs) in q's dtype, or
    int8 with ks and vs (B, H, S, 1) f32; hs a multiple of 128 (the head
    sizes ``decode_route`` sends); limit (B,) int32. Raises ValueError
    otherwise."""
    B, H, S, hs = k.shape
    if hs <= 0 or hs % HEAD_SIZE_STEP:
        raise ValueError(f"K5 takes a head size that is a multiple of {HEAD_SIZE_STEP}, got {hs}")
    if q.dtype not in DTYPES:
        raise ValueError(f"K5 takes bf16 or f32 compute, got {q.dtype}")
    q_stride = _slot_stride(q, B, H, hs, q.dtype, "K5 q")
    quantized = ks is not None
    cache_dtype = torch.int8 if quantized else q.dtype
    for c in (k, v):
        if c.dtype != cache_dtype or c.shape != (B, H, S, hs) or not c.is_contiguous():
            raise ValueError(f"K5 takes contiguous {cache_dtype} ({B}, {H}, {S}, {hs}) caches "
                             f"(int8 with ks and vs, q's dtype without)")
    if quantized:
        for c in (ks, vs):
            if c is None or c.dtype != torch.float32 or c.shape != (B, H, S, 1) or not c.is_contiguous():
                raise ValueError(f"K5 takes ks and vs as contiguous float32 ({B}, {H}, {S}, 1) tensors")
    elif vs is not None:
        raise ValueError("K5 takes ks and vs together")
    if limit.dtype != torch.int32 or limit.shape != (B,) or not limit.is_contiguous():
        raise ValueError(f"K5 takes limit as a contiguous int32 ({B},) tensor")
    return q_stride


def check_decode_write(q, k_new, v_new, kc, vc, slot_pos):
    """What K8 takes, on any device; returns the slot strides of q, k_new and
    v_new. bf16 or f32 (the compute dtype), head size 128; caches contiguous
    (B, H, S, 128) in q's dtype; slot_pos (B,) int32. Raises ValueError
    otherwise."""
    B, H, S, hs = kc.shape
    if hs != 128:
        raise ValueError(f"K8 takes head size 128, got {hs}")
    if q.dtype not in DTYPES:
        raise ValueError(f"K8 takes bf16 or f32 compute, got {q.dtype}")
    strides = [_slot_stride(t, B, H, hs, q.dtype, n) for t, n in ((q, "K8 q"), (k_new, "K8 k_new"),
                                                                  (v_new, "K8 v_new"))]
    for c in (kc, vc):
        if c.dtype != q.dtype or c.shape != (B, H, S, hs) or not c.is_contiguous():
            raise ValueError(f"K8 takes contiguous {q.dtype} ({B}, {H}, {S}, {hs}) caches")
    if slot_pos.dtype != torch.int32 or slot_pos.shape != (B,) or not slot_pos.is_contiguous():
        raise ValueError(f"K8 takes slot_pos as a contiguous int32 ({B},) tensor")
    return strides


def _on_card(what: str, *ts) -> None:
    if not all(t is None or t.is_cuda for t in ts):
        raise ValueError(f"{what} takes CUDA tensors")


def decode_attention_ref(q, k, v, ks, vs, limit):
    """Plain version of :func:`decode_attention`, in the Pallas kernel's
    arithmetic: k and v in ``q.dtype`` (int8 -> float is exact), every
    product rounded to ``q.dtype`` and summed in f32; the k scale multiplies
    the f32 score and the v scale the f32 softmax weight before that is
    rounded; the normaliser is floored at 1e-30."""
    B, H, S, hs = k.shape
    pdt = q.dtype
    s = (k.to(pdt) * q.to(pdt)).float().sum(dim=-1)  # (B, H, S); q broadcasts over S
    if ks is not None:
        s = s * ks.reshape(B, H, S)
    s = s * (1.0 / math.sqrt(hs))
    visible = torch.arange(S, device=q.device)[None, None, :] <= limit.long()[:, None, None]
    s = torch.where(visible, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(visible, torch.exp(s - m), torch.zeros_like(s))
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    w = p if vs is None else p * vs.reshape(B, H, S)
    acc = (w.to(pdt)[..., None] * v.to(pdt)).float().sum(dim=2)  # (B, H, hs)
    return (acc / l)[:, :, None, :].to(pdt)


def decode_attention(q, k, v, ks, vs, limit):
    """One query per (batch row, head) against the whole cache.

    q (B, H, 1, hs); k, v (B, H, S, hs) in ``q.dtype``, or int8 with ``ks``,
    ``vs`` (B, H, S, 1) f32 (else None); limit (B,) int32 on the device of
    the rest: row ``s`` is visible to batch row ``b`` iff ``s <= limit[b]``,
    so a limit at or past S - 1 sees every row. Returns (B, H, 1, hs) in
    ``q.dtype``. A CPU tensor takes the plain version; a CUDA tensor launches
    K5 or raises."""
    if not q.is_cuda:
        return decode_attention_ref(q, k, v, ks, vs, limit)
    q_stride = check_decode(q, k, v, ks, vs, limit)
    _on_card("K5", q, k, v, ks, vs, limit)
    B, H, S, hs = k.shape
    quantized = ks is not None
    if uses_split_body(hs, q.dtype) and (q.data_ptr() % 16 or q_stride % 8):
        raise ValueError("K5 takes q 16-byte aligned, each batch row's at a multiple of 8 elements")
    n_part, n_count = k5_scratch(B, H, S, hs, q.dtype)
    part = torch.empty(n_part, dtype=torch.float32, device=q.device)
    counter = arrival_counters(n_count, q.device) if n_count else None
    y = torch.empty((B, H, 1, hs), dtype=q.dtype, device=q.device)
    lib = _build.library("decode_attention", _SIGS)
    err = lib.k5_decode_attention(
        q.data_ptr(), q_stride, k.data_ptr(), v.data_ptr(),
        ks.data_ptr() if quantized else None, vs.data_ptr() if quantized else None,
        limit.data_ptr(), part.data_ptr(), counter.data_ptr() if n_count else None, y.data_ptr(), B, H, S,
        int(quantized), int(q.dtype == torch.bfloat16), hs, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "K5 decode_attention")
    decode_attention.launches += 1
    return y


decode_attention.launches = 0
decode_attention_pallas = decode_attention  # the JAX package's name for this entry


def decode_attention_write(q, k_new, v_new, kc, vc, slot_pos):
    """Write each slot's new k/v row into its cache and attend over the rows
    visible to it.

    q, k_new, v_new (B, H, 1, hs), k already rotated; kc, vc (B, H, S, hs),
    written in place; slot_pos (B,) int32, on the device of the rest. Returns
    (y (B, H, 1, hs) in q.dtype, kc, vc), the caches being the given tensors.
    A CPU tensor takes the plain version; a CUDA tensor launches K8 or raises.
    """
    if not q.is_cuda:
        return decode_attention_write_ref(q, k_new, v_new, kc, vc, slot_pos)
    strides = check_decode_write(q, k_new, v_new, kc, vc, slot_pos)
    _on_card("K8", q, k_new, v_new, kc, vc, slot_pos)
    B, H, S, hs = kc.shape
    part = torch.empty(B * H * (-(-S // CHUNK)) * (hs + 2), dtype=torch.float32, device=q.device)
    y = torch.empty((B, H, 1, hs), dtype=q.dtype, device=q.device)
    lib = _build.library("decode_attention", _SIGS)
    err = lib.k8_decode_attention_write(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), *strides, kc.data_ptr(), vc.data_ptr(),
        slot_pos.data_ptr(), part.data_ptr(), y.data_ptr(), B, H, S, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "K8 decode_attention_write")
    decode_attention_write.launches += 1
    return y, kc, vc


decode_attention_write.launches = 0


def decode_attention_write_pipelined(q, k_new, v_new, kc, vc, slot_pos, mxu: bool = True):
    """The JAX package's default serving entry (``_pipe_kernel``). ``mxu``
    chose between two formulations of the TPU kernel that compute the same
    values; both lead to the one CUDA kernel."""
    return decode_attention_write(q, k_new, v_new, kc, vc, slot_pos)


def decode_attention_write_pallas(q, k_new, v_new, kc, vc, slot_pos):
    """The JAX package's manual-DMA serving entry (``_write_attn_kernel``):
    the same function, the same CUDA kernel."""
    return decode_attention_write(q, k_new, v_new, kc, vc, slot_pos)
