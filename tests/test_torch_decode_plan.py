"""How the split decode attention of K5 and K1 and the int4 matvec of K1 and
K2 cut their work on the card (``ops.decode_attention.decode_plan``, and
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


def _geometry(hs: int, elem_bytes: int):
    """How a warp of the split body lays a cache row on its lanes (``Geo`` in
    csrc/decode_sm90.cuh), for int8, bf16 or f32 elements: a row of hs *
    elem_bytes / 16 pieces lies on the largest power of two of lanes, at most
    32, that divides it, each lane taking the same number of its pieces; a
    lane copies as many rows' pieces as fit SPLIT_LOADS, a power of two of
    rows, one at least. Returns (lanes a row, pieces a lane, rows a lane,
    pieces a lane copies of k, the tile's rows): tiles of 32 rows (int8), 16
    (bf16), 8 (f32) at hs 128, half as many at hs 256, and 8 / 4 / 2 at hs
    384 (three pieces of a row a lane, two rows)."""
    pieces = hs * elem_bytes // 16
    lanes = max(n for n in (8, 16, 32) if pieces % n == 0)
    per_lane = pieces // lanes
    rows_a_lane = max([1] + [r for r in (2, 4, 8) if r * per_lane <= tda.SPLIT_LOADS])
    return lanes, per_lane, rows_a_lane, rows_a_lane * per_lane, rows_a_lane * (32 // lanes)


def _tile_rows(hs: int, elem_bytes: int) -> int:
    return _geometry(hs, elem_bytes)[-1]


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


def _gemv_steps(K: int, warp: int, warps: int = tfl.GEMV_WARPS):
    """The GEMV_STEP-byte steps of every column one warp of ``warps`` takes
    at width K."""
    return list(range(warp, K // 2 // tfl.GEMV_STEP, warps))


def test_constants_mirror_the_sources():
    """The Python mirrors and the CUDA sources name the same splits, tiles,
    rings and blocks."""
    dec = (CSRC / "decode_sm90.cuh").read_text()
    assert (_const(dec, "SPLIT_QUANTUM"), _const(dec, "MAX_SPLITS")) == (tda.SPLIT_QUANTUM, tda.MAX_SPLITS)
    assert (_const(dec, "WARPS"), _const(dec, "LOADS"), _const(dec, "STAGES")) == (
        tda.SPLIT_WARPS, tda.SPLIT_LOADS, tda.SPLIT_STAGES)
    assert _const(dec, "MAX_HS") == tda.SPLIT_MAX_HEAD_SIZE == max(tda.SPLIT_HEAD_SIZES)
    # the lanes of a row, the passes of a tile and the splits past 256, as _geometry and tda.max_splits take them
    assert "LPR = CPR % 32 == 0 ? 32 : CPR % 16 == 0 ? 16 : 8;" in dec
    assert "PASSES = PPL == 1 ? 8 : PPL == 2 ? 4 : PPL <= 4 ? 2 : 1;" in dec
    assert "return hs <= 256 ? MAX_SPLITS : MAX_SPLITS * hs / 128;" in dec
    att = (CSRC / "decode_attention.cu").read_text()  # a split body for every head size up to MAX_HS
    assert [int(h) for h in re.findall(r"LLT_K5_HS\((\d+)\)", att)] == list(tda.SPLIT_HEAD_SIZES)
    gemv = (CSRC / "gemv_sm90.cuh").read_text()
    assert (_const(gemv, "WARPS"), _const(gemv, "COLS"), _const(gemv, "STEP"), _const(gemv, "STAGES")) == (
        tfl.GEMV_WARPS, tfl.GEMV_COLS, tfl.GEMV_STEP, tfl.GEMV_STAGES)
    assert (_const(gemv, "PLANES_F32"), _const(gemv, "ZERO_BF16")) == (tfl.GEMV_PLANES_F32, tfl.GEMV_ZERO_BF16)
    assert (_const(gemv, "WARPS_F32"), _const(gemv, "STAGES_F32")) == (tfl.GEMV_WARPS_F32, tfl.GEMV_STAGES_F32)


@pytest.mark.parametrize("S", SEQS)
@pytest.mark.parametrize("hs", [128, 256, 384, 512, 640])
def test_splits_cover_the_cache_once(S, hs):
    """At most MAX_SPLITS splits at head size 128 and 256 (MAX_SPLITS * hs /
    128 past it, so a split holds about the bytes it holds at 128), each the
    fewest multiple of SPLIT_QUANTUM rows that fits the cache in that many;
    they cover rows [0, S) once, and a warp's tile never crosses a split."""
    plan = tda.decode_plan(S, hs)
    most = tda.MAX_SPLITS * (hs // 128 if hs > 256 else 1)
    assert plan.split_rows % tda.SPLIT_QUANTUM == 0 and 1 <= plan.n_splits <= most
    assert plan.split_rows < -(-S // most) + tda.SPLIT_QUANTUM
    assert (plan.n_splits - 1) * plan.split_rows < S <= plan.n_splits * plan.split_rows
    for elem_bytes in (1, 2, 4):
        assert plan.split_rows % _tile_rows(hs, elem_bytes) == 0


@pytest.mark.parametrize("S", [72, 256, 2048, 2053])
def test_plan_depends_on_the_cache_length_and_head_size_alone(S):
    """The plan of a row is the same at every batch size and limit: the
    wrappers' scratch grows with B by whole rows' plans, so a K5 row takes the
    same splits at B = 1 and B = 8."""
    for hs in (128, 256, 384, 512, 640):
        plan = tda.decode_plan(S, hs)
        for dtype in (torch.bfloat16, torch.float32):
            one = tda.k5_scratch(1, 32, S, hs, dtype)
            assert one == (32 * plan.n_splits * (hs + 2), 32)
            for B in (2, 8, 64):
                assert tda.k5_scratch(B, 32, S, hs, dtype) == (B * one[0], B * one[1])
    assert tda.decode_plan(2048, 128) == (256, 8)
    assert tda.decode_plan(72, 128) == (64, 2)
    assert tda.decode_plan(1024, 384) == tda.decode_plan(1024, 512) == (64, 16)
    assert tda.decode_plan(2048, 384) == (128, 16)


@pytest.mark.parametrize("hs,dtype,split", [(128, torch.bfloat16, True), (256, torch.bfloat16, True),
                                            (128, torch.float32, True), (256, torch.float32, True),
                                            (384, torch.bfloat16, True), (384, torch.float32, True),
                                            (1152, torch.bfloat16, False), (1152, torch.float32, False)])
def test_scratch_the_wrappers_allocate_follows_the_body(hs, dtype, split):
    """K5 and K1 allocate the split body's partials and counters in bf16 and
    in f32 at every head size up to 1024; past it K5's wide kernels take the
    chunk partials and no counter. K1 (head size 128) takes the split body's
    in either compute dtype."""
    B, H, S = 3, 4, 300
    assert tda.uses_split_body(hs, dtype) is split
    if split:
        n = tda.decode_plan(S, hs).n_splits
        assert tda.k5_scratch(B, H, S, hs, dtype) == (B * H * n * (hs + 2), B * H)
        if hs == 128:
            assert tfl.k1_scratch(H, S, hs) == (H * n * (hs + 2), H)
    else:
        assert tda.k5_scratch(B, H, S, hs, dtype) == (B * H * math.ceil(S / 64) * (hs + 2), 0)


def test_arrival_counters_are_zeros_that_persist():
    a = tda.arrival_counters(10, "cpu")
    assert a.dtype == torch.int32 and a.numel() >= 10 and int(a.abs().sum()) == 0
    assert tda.arrival_counters(5, "cpu") is a
    b = tda.arrival_counters(a.numel() + 1, "cpu")
    assert b.numel() > a.numel() and int(b.abs().sum()) == 0


def test_plan_refuses_what_the_split_body_does_not_take():
    """The split body takes every multiple of 128 up to 1024: past it (and off
    the multiples) the plan refuses, and K5 takes its wide kernels."""
    with pytest.raises(ValueError):
        tda.decode_plan(0, 128)
    with pytest.raises(ValueError):
        tda.decode_plan(2048, 1152)
    with pytest.raises(ValueError):
        tda.decode_plan(2048, 320)
    assert tda.decode_plan(2048, 1024).n_splits == 32


@pytest.mark.parametrize("hs", [128, 256, 384, 512, 640])
@pytest.mark.parametrize("elem_bytes", [1, 2, 4])
def test_split_geometry_lays_each_row_on_its_lanes(hs, elem_bytes):
    """A warp's tile: each of its rows lies on `lanes` lanes, which together
    copy each of the row's 16-byte pieces once (lane c takes pieces c, c +
    lanes, ...); the warp's 32 lanes take 32 / lanes rows a pass; a lane
    copies at most SPLIT_LOADS pieces of k (of v); a lane's row count is a
    power of two, so the tile's rows divide SPLIT_QUANTUM; and at head size
    128 and 256 the layout is the one those sizes had before wider heads."""
    lanes, pieces, passes, loads, rows = _geometry(hs, elem_bytes)
    cpr = hs * elem_bytes // 16
    assert lanes in (8, 16, 32) and loads <= tda.SPLIT_LOADS and rows <= 32
    assert tda.SPLIT_QUANTUM % rows == 0 and passes & (passes - 1) == 0
    covered = sorted(c + p * lanes for c in range(lanes) for p in range(pieces))
    assert covered == list(range(cpr))
    if hs <= 256:  # LPR = min(CPR, 32) and LOADS / PPL passes, as before
        assert (lanes, loads) == (min(cpr, 32), tda.SPLIT_LOADS)


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
    shared memory of the 7B widths fits in both compute dtypes (f32: three
    bf16 planes of the input and the zero block)."""
    for warps in (tfl.GEMV_WARPS, tfl.GEMV_WARPS_F32):
        steps = sorted(s for w in range(warps) for s in _gemv_steps(K, w, warps))
        assert steps == list(range(K // 2 // tfl.GEMV_STEP)) and (K // 2) % tfl.GEMV_STEP == 0
    for s in steps:
        lo = range(s * tfl.GEMV_STEP, (s + 1) * tfl.GEMV_STEP)
        assert len({k // gs for k in lo}) == 1
        assert len({(k + K // 2) // gs for k in lo}) == 1 and (lo[0] + K // 2) // gs == lo[0] // gs + K // gs // 2
    assert tfl.gemv_smem(K, gs) <= tfl.SM90_MAX_SMEM
    ring = lambda warps, stages: warps * stages * (2 * 32 * 16 + 32 * 4)
    assert tfl.gemv_smem(K, gs, torch.float32) - tfl.gemv_smem(K, gs) == (
        2 * (2 * K + tfl.GEMV_ZERO_BF16) + ring(tfl.GEMV_WARPS_F32, tfl.GEMV_STAGES_F32)
        - ring(tfl.GEMV_WARPS, tfl.GEMV_STAGES))
    assert tfl.gemv_smem(K, gs, torch.float32) <= tfl.SM90_MAX_SMEM


def test_matvec_refuses_an_input_too_wide_for_shared_memory():
    with pytest.raises(ValueError):
        tfl._check_gemv_smem(128 * 1024, 128, torch.bfloat16, "K1")
    with pytest.raises(ValueError):  # fits one bf16 plane, not three
        tfl._check_gemv_smem(64 * 1024, 128, torch.float32, "K1")
    tfl._check_gemv_smem(64 * 1024, 128, torch.bfloat16, "K1")
    tfl._check_gemv_smem(11008, 64, torch.bfloat16, "K1")
    tfl._check_gemv_smem(22016, 64, torch.float32, "K1")  # the 65B MLP width


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


@pytest.mark.parametrize("hs", [384, 512, 640])
@pytest.mark.parametrize("quantized", [False, True])
def test_k5_merged_over_splits_equals_one_pass_past_256(hs, quantized):
    """Past head size 256 the plan cuts the cache into more, shorter splits
    (16 of 128 rows at S = 2048 and hs 384, 32 of 64 at 512): the plain K5 in
    f32, merged over them in split order, equals its one-pass plain version
    to f32 rounding, at limits 0, a split boundary, the middle of a split and
    past S."""
    rng = np.random.default_rng(hs + quantized)
    H, S = 2, 2048
    plan = tda.decode_plan(S, hs)
    assert plan.n_splits > tda.MAX_SPLITS
    limits = [0, plan.split_rows - 1, 5 * plan.split_rows + 7, S + 7]
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
    """tools/spans.py finds its anchors in the matvec source, whose one
    kernel takes both compute dtypes (table rows 0-3 bf16, 4-7 f32)."""
    from lit_llama_tpu_torch.tools import spans

    (source,) = spans.GEMV
    text = spans.instrument((CSRC / source.file).read_text(), source).replace(spans.HEAD, "")
    assert text.count("SPAN(") >= len(spans.GEMV_SPANS) and text.count("SPAN_END(") == 1
    assert text.count("SPAN_BEGIN((F32 ? 4 : 0) + ") == 1


# ---- the f32 matvec's input: an exact three-term bf16 split (csrc/gemv_sm90.cuh F32)


def split_bf16x3(x: np.ndarray):
    """The kernel's split of f32 values into three bf16 terms, by truncation:
    hi = x with its low 16 bits cleared, mid the same of x - hi, lo the same
    of x - hi - mid (each term's f32 value, low 16 bits zero)."""
    def trunc(v):
        return (v.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)

    hi = trunc(x)
    r = x - hi  # exact
    mid = trunc(r)
    return hi, mid, trunc(r - mid)


def _exponent_sweep(rng, lo: int, hi: int, n: int) -> np.ndarray:
    """n f32 values of random sign and mantissa, exponents uniform in [lo, hi]."""
    m = rng.uniform(1.0, 2.0, n) * rng.choice([-1.0, 1.0], n)
    return np.ldexp(m, rng.integers(lo, hi + 1, n)).astype(np.float32)


def test_three_term_split_is_exact():
    """hi + mid + lo == x bit for bit for every finite f32 from 2^-110 up to
    FLT_MAX (normal draws, huge ones up to FLT_MAX, tiny ones down to 2^-110,
    and +-0); each term is a bf16 (its low 16 bits zero), so each term times a
    nibble is exact in f32. Rounding instead of truncating would overflow:
    bf16(FLT_MAX) is inf."""
    rng = np.random.default_rng(22)
    fmax = np.finfo(np.float32).max
    x = np.concatenate([rng.normal(size=4096).astype(np.float32), _exponent_sweep(rng, -110, 127, 8192),
                        np.array([0.0, -0.0, fmax, -fmax, np.float32(2.0 ** -110)], np.float32),
                        np.nextafter(np.float32(fmax), np.float32(0), dtype=np.float32)[None]])
    terms = split_bf16x3(x)
    for t in terms:
        assert not (t.view(np.uint32) & 0xFFFF).any()
        assert np.isfinite(t).all()
    total = (terms[0].astype(np.float64) + terms[1]) + terms[2]
    np.testing.assert_array_equal(total, x.astype(np.float64))
    np.testing.assert_array_equal((terms[0] + terms[1]) + terms[2], x)  # in f32 too (-0 sums to +0)
    assert torch.isinf(torch.tensor(fmax).to(torch.bfloat16))


def test_three_term_split_below_2_to_the_minus_110_loses_under_2_to_the_minus_133():
    """Below 2^-110 (the small normals and the subnormals) x's last bits fall
    under bf16's smallest subnormal, 2^-133: lo keeps what bf16 holds and the
    loss is |x - (hi + mid + lo)| < 2^-133 (a relative 2^-23 at 2^-110), of
    x's sign; the split never grows x."""
    rng = np.random.default_rng(23)
    tiny = np.finfo(np.float32).smallest_subnormal
    x = np.concatenate([_exponent_sweep(rng, -126, -111, 4096),
                        (rng.integers(1, 2 ** 23, 4096) * rng.choice([-1, 1], 4096) * np.float64(tiny)).astype(
                            np.float32), np.array([tiny, -tiny], np.float32)])
    assert (np.abs(x) < 2.0 ** -110).all() and (x != 0).all()
    terms = split_bf16x3(x)
    total = (terms[0].astype(np.float64) + terms[1]) + terms[2]
    loss = x.astype(np.float64) - total
    assert (np.abs(loss) < 2.0 ** -133).all()
    assert ((loss == 0) | (np.sign(loss) == np.sign(x))).all()
    assert (loss != 0).any()  # the range does lose bits
