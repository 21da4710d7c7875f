"""How the split decode attention of K5 and K1 and the bf16 int4 matvec of K1
and K2 cut their work on the card (``ops.decode_attention.decode_plan``, and
the matvec's tiling from the ``GEMV_*`` constants of ``ops.fused_layer``):
pure functions of the shapes, mirrors of what ``csrc/decode_sm90.cuh`` and
``csrc/gemv_sm90.cuh`` compute, so what each
kernel is asked to do is testable here, where the kernels cannot run; and
the plain versions of K5's and K1's attention merged over the plan's splits
in split order, against their one-pass plain versions."""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lit_llama_tpu_torch.ops import decode_attention as tda
from lit_llama_tpu_torch.ops import fused_layer as tfl

CSRC = Path(tda.__file__).resolve().parent.parent / "csrc"
SEQS = [1, 63, 64, 65, 72, 100, 256, 511, 512, 513, 2047, 2048, 2053, 4096, 32768]


def _const(text: str, name: str) -> int:
    return int(re.search(rf"\b{name} = (\d+)", text).group(1))


def _tile_rows(hs: int, int8: bool) -> int:
    """Cache rows of one warp's tile in the split body: SPLIT_LOADS 16-byte
    pieces a lane, a row taking hs * (1 or 2) / 16 lanes."""
    return tda.SPLIT_LOADS * 32 // (hs * (1 if int8 else 2) // 16)


def _gemv_blocks(N: int, swiglu: bool) -> int:
    """Blocks of the bf16 matvec at N output columns (N = 2I under SwiGLU)."""
    return -(-(N // 2) // 8) if swiglu else -(-N // tfl.GEMV_COLS)


def _gemv_columns(block: int, N: int, swiglu: bool):
    """The columns of a block of the bf16 matvec in mma row order (None past
    N), as its tile_col: 16 adjacent ones, or gate j .. j + 7 then up I + j .."""
    if swiglu:
        I = N // 2
        gate = [j if j < I else None for j in range(8 * block, 8 * block + 8)]
        return gate + [None if j is None else I + j for j in gate]
    return [c if c < N else None for c in range(tfl.GEMV_COLS * block, tfl.GEMV_COLS * (block + 1))]


def _gemv_steps(K: int, warp: int):
    """The GEMV_STEP-byte steps of every column one warp takes at width K."""
    return list(range(warp, K // 2 // tfl.GEMV_STEP, tfl.GEMV_WARPS))


def test_constants_mirror_the_sources():
    """The Python mirrors and the CUDA sources name the same splits, tiles,
    rings and blocks."""
    dec = (CSRC / "decode_sm90.cuh").read_text()
    assert (_const(dec, "SPLIT_QUANTUM"), _const(dec, "MAX_SPLITS")) == (tda.SPLIT_QUANTUM, tda.MAX_SPLITS)
    assert (_const(dec, "WARPS"), _const(dec, "LOADS"), _const(dec, "STAGES")) == (
        tda.SPLIT_WARPS, tda.SPLIT_LOADS, tda.SPLIT_STAGES)
    gemv = (CSRC / "gemv_sm90.cuh").read_text()
    assert (_const(gemv, "WARPS"), _const(gemv, "COLS"), _const(gemv, "STEP"), _const(gemv, "STAGES")) == (
        tfl.GEMV_WARPS, tfl.GEMV_COLS, tfl.GEMV_STEP, tfl.GEMV_STAGES)


@pytest.mark.parametrize("S", SEQS)
@pytest.mark.parametrize("hs", [128, 256])
def test_splits_cover_the_cache_once(S, hs):
    """At most MAX_SPLITS splits, each a multiple of SPLIT_QUANTUM rows; they
    cover rows [0, S) once, and a warp's tile never crosses a split."""
    plan = tda.decode_plan(S, hs)
    assert plan.split_rows % tda.SPLIT_QUANTUM == 0 and 1 <= plan.n_splits <= tda.MAX_SPLITS
    assert (plan.n_splits - 1) * plan.split_rows < S <= plan.n_splits * plan.split_rows
    for int8 in (False, True):
        assert plan.split_rows % _tile_rows(hs, int8) == 0


@pytest.mark.parametrize("S", [72, 256, 2048, 2053])
def test_plan_depends_on_the_cache_length_and_head_size_alone(S):
    """The plan of a row is the same at every batch size and limit: the
    wrappers' scratch grows with B by whole rows' plans, so a K5 row takes the
    same splits at B = 1 and B = 8."""
    for hs in (128, 256):
        plan = tda.decode_plan(S, hs)
        one = tda.k5_scratch(1, 32, S, hs, torch.bfloat16)
        assert one == (32 * plan.n_splits * (hs + 2), 32)
        for B in (2, 8, 64):
            assert tda.k5_scratch(B, 32, S, hs, torch.bfloat16) == (B * one[0], B * one[1])
    assert tda.decode_plan(2048, 128) == (256, 8)
    assert tda.decode_plan(72, 128) == (64, 2)


@pytest.mark.parametrize("hs,dtype,split", [(128, torch.bfloat16, True), (256, torch.bfloat16, True),
                                            (128, torch.float32, False), (384, torch.bfloat16, False)])
def test_scratch_the_wrappers_allocate_follows_the_body(hs, dtype, split):
    """K5 and K1 allocate the split body's partials and counters in bf16 at
    head size 128 and 256; elsewhere the first port's chunk partials and no
    counter."""
    B, H, S = 3, 4, 300
    assert tda.uses_split_body(hs, dtype) is split
    if split:
        n = tda.decode_plan(S, hs).n_splits
        assert tda.k5_scratch(B, H, S, hs, dtype) == (B * H * n * (hs + 2), B * H)
        assert tfl.k1_scratch(H, S, hs, dtype) == (H * n * (hs + 2), H)
    else:
        assert tda.k5_scratch(B, H, S, hs, dtype) == (B * H * math.ceil(S / 64) * (hs + 2), 0)
        if hs == 128:
            assert tfl.k1_scratch(H, S, hs, dtype) == (H * math.ceil(S / 64) * (hs + 2), 0)


def test_arrival_counters_are_zeros_that_persist():
    a = tda.arrival_counters(10, "cpu")
    assert a.dtype == torch.int32 and a.numel() >= 10 and int(a.abs().sum()) == 0
    assert tda.arrival_counters(5, "cpu") is a
    b = tda.arrival_counters(a.numel() + 1, "cpu")
    assert b.numel() > a.numel() and int(b.abs().sum()) == 0


def test_plan_refuses_what_the_split_body_does_not_take():
    with pytest.raises(ValueError):
        tda.decode_plan(0, 128)
    with pytest.raises(ValueError):
        tda.decode_plan(2048, 384)


@pytest.mark.parametrize("N,swiglu", [(12288, False), (4096, False), (22016, True), (32000, False), (256, False),
                                      (1000, False), (9728, True), (2 * 4860, True)])
def test_matvec_blocks_cover_every_column_once(N, swiglu):
    """Every output column sits in one block's 16 mma rows; under SwiGLU a
    block's rows g and g + 8 are gate j and up I + j."""
    seen = []
    for b in range(_gemv_blocks(N, swiglu)):
        cols = _gemv_columns(b, N, swiglu)
        assert len(cols) == tfl.GEMV_COLS
        if swiglu:
            assert all(u is None or u == g + N // 2 for g, u in zip(cols[:8], cols[8:]))
        seen += [c for c in cols if c is not None]
    assert sorted(seen) == list(range(N))


@pytest.mark.parametrize("K,gs", [(4096, 128), (11008, 128), (1792, 128), (512, 128), (4096, 64), (11008, 64),
                                  (4096, 256), (4864, 128)])
def test_matvec_steps_and_groups(K, gs):
    """The warps take every 64-byte step of a column once; a step's low
    nibbles lie in one group (and its high nibbles in that group + G/2); the
    shared memory of the 7B widths fits."""
    steps = sorted(s for w in range(tfl.GEMV_WARPS) for s in _gemv_steps(K, w))
    assert steps == list(range(K // 2 // tfl.GEMV_STEP)) and (K // 2) % tfl.GEMV_STEP == 0
    for s in steps:
        lo = range(s * tfl.GEMV_STEP, (s + 1) * tfl.GEMV_STEP)
        assert len({k // gs for k in lo}) == 1
        assert len({(k + K // 2) // gs for k in lo}) == 1 and (lo[0] + K // 2) // gs == lo[0] // gs + K // gs // 2
    assert tfl.gemv_smem(K, gs) <= tfl.SM90_MAX_SMEM


def test_matvec_refuses_an_input_too_wide_for_shared_memory():
    with pytest.raises(ValueError):
        tfl._check_gemv_smem(128 * 1024, 128, "K1")
    tfl._check_gemv_smem(11008, 64, "K1")


def _split_merge(s, vw, S, split_rows):
    """The split body's arithmetic in f32: per split in order, (m, l, acc) of
    its visible rows, then the merge; s (..., S) scores with -1e30 where a row
    is not visible, vw (..., S, hs) the weighted rows' values (the v scale
    folded in)."""
    parts = []
    for s0 in range(0, S, split_rows):
        sc = s[..., s0 : s0 + split_rows]
        m = sc.amax(dim=-1, keepdim=True)
        p = torch.where(sc > -1e29, torch.exp(sc - m), torch.zeros_like(sc))
        parts.append((m, p.sum(-1, keepdim=True), (p[..., None] * vw[..., s0 : s0 + split_rows, :]).sum(-2)))
    M = torch.stack([m for m, _, _ in parts]).amax(0)  # a split with no visible row: m = -1e30, l = 0
    L = sum(torch.exp(m - M) * l for m, l, _ in parts)
    A = sum(torch.exp(m - M) * a for m, _, a in parts)
    return A / torch.clamp(L, min=1e-30)


@pytest.mark.parametrize("S", [72, 300, 2048])
@pytest.mark.parametrize("quantized", [False, True])
def test_k5_merged_over_splits_equals_one_pass(S, quantized):
    """The plain K5 (f32: no product rounding), merged over the plan's splits
    in split order, equals its one-pass plain version to f32 rounding, at
    limits 0, the middle of a split and past S."""
    rng = np.random.default_rng(S + quantized)
    H, hs = 4, 128
    plan = tda.decode_plan(S, hs)
    limits = [0, plan.split_rows // 2 + 3, S + 7]
    B = len(limits)
    q = torch.from_numpy(rng.normal(size=(B, H, 1, hs)).astype(np.float32))
    if quantized:
        k = torch.from_numpy(rng.integers(-127, 128, size=(B, H, S, hs)).astype(np.int8))
        v = torch.from_numpy(rng.integers(-127, 128, size=(B, H, S, hs)).astype(np.int8))
        ks, vs = (torch.from_numpy(rng.uniform(0.002, 0.01, size=(B, H, S, 1)).astype(np.float32)) for _ in "kv")
    else:
        k, v = (torch.from_numpy(rng.normal(size=(B, H, S, hs)).astype(np.float32)) for _ in "kv")
        ks = vs = None
    limit = torch.tensor(limits, dtype=torch.int32)
    want = tda.decode_attention_ref(q, k, v, ks, vs, limit)[:, :, 0]
    s = (k.float() * q).sum(-1)
    if quantized:
        s = s * ks[..., 0]
    s = s / math.sqrt(hs)
    s = torch.where(torch.arange(S)[None, None, :] <= limit[:, None, None], s, torch.full_like(s, -1e30))
    vw = v.float() * (vs if quantized else 1.0)
    got = _split_merge(s, vw, S, plan.split_rows)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("S", [72, 300, 2048])
def test_k1_attention_merged_over_splits_equals_one_pass(S):
    """K1's plain attention (f32 q and products), merged over the plan's
    splits in split order, equals its one-pass plain version to f32 rounding,
    at limits 0, the middle of a split and past S."""
    rng = np.random.default_rng(S)
    H, hs = 4, 128
    plan = tda.decode_plan(S, hs)
    k, v = (torch.from_numpy((rng.normal(size=(H, S, hs)) * 0.3).astype(np.float32)).to(torch.bfloat16)
            for _ in "kv")
    q = torch.from_numpy(rng.normal(size=(H, hs)).astype(np.float32))
    for limit in (0, plan.split_rows // 2 + 3, S + 7):
        want = tfl._decode_attention_ref(q, k, v, limit)
        s = (k.float() * q[:, None, :]).sum(-1) / math.sqrt(hs)
        s = torch.where(torch.arange(S)[None, :] <= limit, s, torch.full_like(s, -1e30))
        got = _split_merge(s, v.float(), S, plan.split_rows)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))


def test_span_tool_instruments_both_matvec_bodies():
    """tools/spans.py finds its anchors in both matvec sources."""
    from lit_llama_tpu_torch.tools import spans

    for body, source in enumerate(spans.GEMV):
        text = spans.instrument((CSRC / source.file).read_text(), source).replace(spans.HEAD, "")
        assert text.count("SPAN(") >= len(spans.GEMV_SPANS[body]) and text.count("SPAN_END(") == 1
        assert text.count("SPAN_BEGIN(") == 1
