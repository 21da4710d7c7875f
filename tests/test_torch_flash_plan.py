"""The tiling of the flash-attention kernels on the card (K4 and K10,
``ops.flash_attention.flash_plan``, ``sm90_blocks``, ``k10_plan`` and
``k10_blocks``): pure functions of the shapes, mirrors of what the kernels
in ``csrc/`` compute, so what each kernel is asked to do is testable here,
where the kernels cannot run."""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lit_llama_tpu_torch.ops import flash_attention as tflash

SOURCE = Path(tflash.__file__).resolve().parent.parent / "csrc" / "flash_sm90.cuh"
SHAPES = [(1, 32, 128), (1, 32, 200), (1, 32, 512), (1, 32, 2048), (2, 32, 2048), (1, 4, 64), (2, 3, 2047),
          (4, 32, 128), (1, 1, 1)]


@pytest.mark.parametrize("B,H,T", SHAPES)
def test_k4_tile_per_shape(B, H, T):
    """64 query rows a block where the blocks of 64 rows fit on the 132 SMs
    at once, else 128; the KV tile is 128 keys under either plan."""
    plan = tflash.flash_plan(B, H, T)
    assert plan.body == "sm90"
    want = 64 if B * H * -(-T // 64) <= tflash.H100_SMS else 128
    assert plan.q_rows == want and plan.kv_rows == tflash.FWD_KV_ROWS == 128
    assert plan.smem == tflash.sm90_smem("fwd", plan.q_rows)


def test_k4_tiles_at_the_main_paths_shapes():
    assert tflash.flash_plan(1, 32, 200).q_rows == 64  # a prefill of 200 tokens: 128 blocks, not 64
    assert tflash.flash_plan(1, 32, 128).q_rows == 64
    assert tflash.flash_plan(1, 32, 512).q_rows == 128  # 256 blocks of 64 rows would take two waves
    assert tflash.flash_plan(1, 32, 2048).q_rows == 128  # training: 512 blocks
    assert tflash.flash_plan(2, 32, 2048).q_rows == 128


@pytest.mark.parametrize("kernel,q_rows", [("fwd", 64), ("fwd", 128), ("dq", 128), ("dkv", 128)])
def test_shared_memory_of_each_plan_fits(kernel, q_rows):
    smem = tflash.sm90_smem(kernel, q_rows)
    assert 0 < smem <= tflash.SM90_MAX_SMEM == 227 * 1024
    # one block an SM: the rings are sized to the space, not to two blocks
    assert smem > tflash.SM90_MAX_SMEM // 2


def _blocks(kernel, T, q_rows):
    """K4's schedule from ``sm90_blocks``, K10's at head size 128 from ``k10_blocks``."""
    if kernel in ("dq", "dkv"):
        return tflash.k10_blocks(tflash.k10_plan(1, 1, T), kernel, T)
    return tflash.sm90_blocks(kernel, T, q_rows)


@pytest.mark.parametrize("kernel,q_rows", [("fwd", 64), ("fwd", 128), ("dq", 128), ("dkv", 128), ("ffma", 64)])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 127, 128, 129, 200, 2047, 2048])
def test_blocks_are_issued_heaviest_first(kernel, q_rows, T):
    """The grid's row index walks the tiles from the one with the most work:
    K4 and dq the last Q tile first, dK/dV the first KV tile first."""
    blocks = _blocks(kernel, T, q_rows)
    work = [len(visits) for _, visits in blocks]
    assert work == sorted(work, reverse=True) and work[-1] >= 1
    own = [tile for tile, _ in blocks]
    assert own[0] == (0 if kernel == "dkv" else len(blocks) - 1)


@pytest.mark.parametrize("kernel,q_rows", [("fwd", 64), ("fwd", 128), ("dq", 128), ("dkv", 128), ("ffma", 64)])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 127, 128, 129, 200, 383, 2047, 2048])
def test_every_tile_is_visited_once(kernel, q_rows, T):
    """Every block owns one tile, and the tiles own each row once; each
    causal (query, key) pair below T is covered by exactly one visit, and a
    block visits no tile twice and none wholly above its diagonal."""
    rows, kv = {"fwd": (q_rows, tflash.FWD_KV_ROWS), "dq": (tflash.DQ_Q_ROWS, tflash.DQ_KV_ROWS),
                "dkv": (tflash.DKV_Q_ROWS, tflash.DKV_KV_ROWS),
                "ffma": (tflash.FFMA_Q_ROWS, tflash.FFMA_KV_ROWS)}[kernel]
    blocks = _blocks(kernel, T, q_rows)
    own = sorted(tile for tile, _ in blocks)
    own_rows = kv if kernel == "dkv" else rows  # the block's own tile: KV in dK/dV, Q otherwise
    assert own == list(range(-(-T // own_rows)))
    seen = torch.zeros(T, T, dtype=torch.int32)  # (query, key)
    for tile, visits in blocks:
        assert len(set(visits)) == len(visits)
        for other in visits:
            if kernel == "dkv":  # own: keys; visits: query tiles
                keys, queries = range(tile * kv, min((tile + 1) * kv, T)), range(other * rows, min((other + 1) * rows, T))
            else:
                queries, keys = range(tile * rows, min((tile + 1) * rows, T)), range(other * kv, min((other + 1) * kv, T))
            assert len(queries) and len(keys) and min(keys) <= max(queries), "a tile wholly above the diagonal"
            q = torch.tensor(list(queries))[:, None]
            k = torch.tensor(list(keys))[None, :]
            seen[q, k] += 1
    causal = torch.ones(T, T, dtype=torch.bool).tril()
    assert bool((seen[causal] == 1).all())


def test_k4_kv_tile_is_the_same_under_every_plan():
    """A query row's online softmax runs over the same KV tiles, so its bits
    do not depend on the plan its shape picks: under 64 and 128 query rows a
    block, every row visits the same KV tiles in the same order."""
    kv_rows = {tflash.flash_plan(B, H, T).kv_rows for B, H, T in SHAPES}
    assert kv_rows == {tflash.FWD_KV_ROWS}
    for T in (65, 129, 200, 2047, 2048):
        tiles = {}
        for q_rows in (64, 128):
            for tile, visits in tflash.sm90_blocks("fwd", T, q_rows):
                for row in range(tile * q_rows, min((tile + 1) * q_rows, T)):
                    tiles.setdefault(row, []).append(list(visits))
        assert all(a == b for a, b in tiles.values())


@pytest.mark.parametrize("hs,dtype,body", [(128, torch.float32, "ffma"), (256, torch.float32, "ffma"),
                                           (256, torch.bfloat16, "sm90_hs256"), (384, torch.bfloat16, "sm90_wide"),
                                           (512, torch.float32, "chunked")])
def test_other_head_sizes_and_f32_take_the_present_bodies(hs, dtype, body):
    """bf16 at head size 256 and past it takes the Hopper bodies of
    csrc/flash_sm90_hs256.cuh and csrc/flash_sm90_wide.cuh; f32 the FFMA
    bodies; only the chunked FFMA kernels (f32 past 256) carry no tiling in
    the plan."""
    plan = tflash.flash_plan(1, 32, 2048, hs, dtype)
    assert plan.body == body
    if body == "ffma":
        assert (plan.q_rows, plan.kv_rows, plan.smem) == (64, 64, tflash.ffma_smem(hs))
    elif body == "sm90_hs256":
        assert (plan.q_rows, plan.kv_rows, plan.smem) == (128, 64, tflash.hs256_smem(128))
    elif body == "sm90_wide":
        assert (plan.q_rows, plan.kv_rows, plan.smem) == (128, 64, tflash.wide_smem())
    else:
        assert plan.q_rows == 0


# K4 at head size 256 (csrc/flash_sm90_hs256.cuh) and past it
# (csrc/flash_sm90_wide.cuh): the plan, the shared memory, the constants and
# each consumer warpgroup's schedule
HS256_SOURCE = SOURCE.parent / "flash_sm90_hs256.cuh"
WIDE_SOURCE = SOURCE.parent / "flash_sm90_wide.cuh"


@pytest.mark.parametrize("hs", [256, 384, 512, 640])
@pytest.mark.parametrize("B,H,T", SHAPES)
def test_k4_tile_per_shape_at_head_size_256_and_past(hs, B, H, T):
    """At 256, 64 query rows a block where the blocks of 64 rows fit on the
    132 SMs at once, else 128, as at 128; past 256, 128 rows at every shape.
    Both take KV tiles of 64 keys under every plan."""
    plan = tflash.flash_plan(B, H, T, hs)
    if hs == 256:
        want = 64 if B * H * -(-T // 64) <= tflash.H100_SMS else 128
        assert plan == tflash.FlashPlan("sm90_hs256", want, 64, tflash.hs256_smem(want))
    else:
        assert plan == tflash.FlashPlan("sm90_wide", 128, 64, tflash.wide_smem())
    assert plan.kv_rows == tflash.HS256_FWD_KV_ROWS == tflash.WIDE_KV_ROWS


@pytest.mark.parametrize("smem", [tflash.hs256_smem(64), tflash.hs256_smem(128), tflash.wide_smem()])
def test_k4_shared_memory_at_head_size_256_and_past_fits(smem):
    """One block an SM, within the 227 KB a block may take; past 256 the
    same at every head size (Q and K stream as 64-column panels)."""
    assert tflash.SM90_MAX_SMEM // 2 < smem <= tflash.SM90_MAX_SMEM


def test_k4_constants_at_head_size_256_and_past_mirror_the_sources():
    """The Python mirror and csrc/flash_sm90_hs256.cuh / flash_sm90_wide.cuh
    name the same tiles, chunk, rings and shared memory."""
    hs256, wide = HS256_SOURCE.read_text(), WIDE_SOURCE.read_text()

    def const(text, name):
        return int(re.search(rf"\b{name} = (\d+)", text).group(1))

    assert [const(hs256, n) for n in ("FWD_BKV", "FWD_KSTAGES", "FWD_VSTAGES")] == [
        tflash.HS256_FWD_KV_ROWS, tflash.HS256_FWD_K_STAGES, tflash.HS256_FWD_V_STAGES]
    assert [const(wide, n) for n in ("BQ", "BKV", "CHUNK", "QK_STAGES", "V_STAGES")] == [
        tflash.WIDE_Q_ROWS, tflash.WIDE_KV_ROWS, tflash.WIDE_CHUNK, tflash.WIDE_QK_STAGES, tflash.WIDE_V_STAGES]
    assert f"constexpr int QK_STAGE = (BQ + BKV) * {tflash.PANEL * 2};" in wide  # a panel row: 64 bf16
    # the shared memory sums, term for term
    assert ("return 1024 + tile_bytes(bq) + (FWD_KSTAGES + FWD_VSTAGES) * tile_bytes(FWD_BKV) +\n"
            "         (2 * (FWD_KSTAGES + FWD_VSTAGES) + 1) * 8;") in hs256
    assert "return 1024 + QK_STAGES * QK_STAGE + V_STAGES * V_TILE + 2 * (QK_STAGES + V_STAGES) * 8;" in wide
    assert "constexpr int V_TILE = BKV * CHUNK * 2;" in wide
    # heaviest first: the grid's y walks the Q tiles from the last; the
    # per-warpgroup tile count of k4_warpgroups
    for text in (hs256, wide):
        assert "qt = p.n_tiles - 1 - blockIdx.y" in text
        assert "const int n_own = min(n_kv, wg_first / " in text


K4_WG_PLANS = [("sm90_hs256", 64), ("sm90_hs256", 128), ("sm90_wide", 128)]


def _plan(body, q_rows):
    if body == "sm90_hs256":
        return tflash.FlashPlan(body, q_rows, 64, tflash.hs256_smem(q_rows))
    return tflash.FlashPlan(body, q_rows, 64, tflash.wide_smem())


@pytest.mark.parametrize("body,q_rows", K4_WG_PLANS)
@pytest.mark.parametrize("T", [1, 63, 64, 65, 127, 128, 129, 200, 383, 2047, 2048])
def test_k4_warpgroups_visit_each_causal_pair_once(body, q_rows, T):
    """Each consumer warpgroup owns 64 rows and the warpgroups own each row
    once; each causal (query, key) pair below T is covered by exactly one
    visit; no warpgroup with rows below T visits a tile twice or one wholly
    above its diagonal; blocks are issued heaviest first."""
    plan = _plan(body, q_rows)
    wgs = tflash.k4_warpgroups(plan, T)
    rows = sorted(r for own, _ in wgs for r in own)
    assert rows[:T] == list(range(T)) and len(rows) == len(set(rows))
    per_block = q_rows // 64
    work = [sum(len(v) for _, v in wgs[i:i + per_block]) for i in range(0, len(wgs), per_block)]
    assert work == sorted(work, reverse=True)
    seen = np.zeros((T, T), np.int32)  # (query, key); queries and keys of a visit are contiguous
    kv = plan.kv_rows
    for own, visits in wgs:
        q0, q1 = own.start, min(own.stop, T)
        if q0 >= q1:
            continue
        assert len(set(visits)) == len(visits) and len(visits) >= 1
        for tile in visits:
            k0, k1 = tile * kv, min((tile + 1) * kv, T)
            assert k0 < k1 and k0 <= q1 - 1, "a tile wholly above the diagonal"
            seen[q0:q1, k0:k1] += 1
    assert bool((seen[np.tril_indices(T)] == 1).all())


@pytest.mark.parametrize("T", [65, 129, 200, 2047, 2048])
def test_k4_kv_tile_at_head_size_256_is_the_same_under_every_plan(T):
    """A query row's online softmax runs over the same KV tiles in the same
    order under 64 and 128 query rows a block, so its bits do not depend on
    the plan its shape picks."""
    assert {tflash.flash_plan(B, H, T, 256).kv_rows for B, H, T in SHAPES} == {tflash.HS256_FWD_KV_ROWS}
    tiles = {}
    for q_rows in (64, 128):
        for own, visits in tflash.k4_warpgroups(_plan("sm90_hs256", q_rows), T):
            for row in range(own.start, min(own.stop, T)):
                tiles.setdefault(row, []).append(list(visits))
    assert len(tiles) == T and all(a == b for a, b in tiles.values())


def warpgroup_model(q, k, v, plan):
    """K4 at head size 256 and past it in plain PyTorch, in the kernels'
    order: each consumer warpgroup's 64 rows against the KV tiles of
    ``k4_warpgroups``, the online softmax merged tile by tile with the
    unnormalised P rounded to the input dtype for P V, O divided by the row
    sum at the end."""
    B, H, T, hs = q.shape
    scale = 1.0 / math.sqrt(hs)
    o = torch.empty_like(q)
    lse = torch.empty(B, H, T, 1)
    for own, visits in tflash.k4_warpgroups(plan, T):
        if own.start >= T:  # a warpgroup past T: its rows are not stored
            continue
        rows = torch.arange(own.start, min(own.stop, T))
        m = torch.full((B, H, len(rows), 1), tflash.NEG_INF)
        l = torch.zeros(B, H, len(rows), 1)
        acc = torch.zeros(B, H, len(rows), hs)
        for tile in visits:
            keys = torch.arange(tile * plan.kv_rows, min((tile + 1) * plan.kv_rows, T))
            s = q[:, :, rows].float() @ k[:, :, keys].float().transpose(-1, -2) * scale
            s = torch.where(keys[None, :] <= rows[:, None], s, torch.full_like(s, tflash.NEG_INF))
            mn = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - mn)
            p = torch.exp(s - mn)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p.to(q.dtype).float() @ v[:, :, keys].float()
            m = mn
        o[:, :, rows] = (acc / l.clamp_min(1e-30)).to(q.dtype)
        lse[:, :, rows] = m + torch.log(l.clamp_min(1e-30))
    return o, lse


@pytest.mark.parametrize("body,q_rows", K4_WG_PLANS)
@pytest.mark.parametrize("T", [1, 65, 129])
def test_k4_warpgroup_order_matches_the_plain_version(body, q_rows, T):
    """The online softmax over each warpgroup's own KV tiles of 64 keys
    (warpgroup 0 of a 128-row block leaving out the block's last tile) gives
    flash_attention_ref's (o, lse) within the f32 tolerance the card holds
    K4's f32 body to (chip_smoke.py TOL_F32: 1e-4 + 1e-4 |plain|)."""
    hs = 256 if body == "sm90_hs256" else 384
    g = torch.Generator().manual_seed(T + q_rows + hs)
    q, k, v = (torch.randn(1, 2, T, hs, generator=g) for _ in range(3))
    o, lse = warpgroup_model(q, k, v, _plan(body, q_rows))
    ro, rlse = tflash.flash_attention_ref(q, k, v)
    for got, want in ((o, ro), (lse, rlse)):
        assert bool(((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all())


@pytest.mark.parametrize("hs", [128, 256])
@pytest.mark.parametrize("B,H,T", SHAPES)
def test_ffma_tile_is_the_same_at_every_shape(hs, B, H, T):
    """f32 compute at head size 128 and 256: 64 query rows against KV tiles
    of 64 keys at every shape, so a row's online softmax takes the same steps
    everywhere; one block an SM, within the 227 KB a block may take."""
    plan = tflash.flash_plan(B, H, T, hs, torch.float32)
    assert plan == tflash.FlashPlan("ffma", tflash.FFMA_Q_ROWS, tflash.FFMA_KV_ROWS, tflash.ffma_smem(hs))
    assert tflash.SM90_MAX_SMEM // 2 < plan.smem <= tflash.SM90_MAX_SMEM
    assert tflash.ffma_stages(hs) >= 2
    # the ring's slots are the most that fit, up to 4
    assert tflash.ffma_stages(hs) == 4 or plan.smem + tflash.FFMA_Q_ROWS * (hs + tflash.FFMA_PAD) * 4 > tflash.SM90_MAX_SMEM


def test_ffma_constants_mirror_the_source():
    """The Python mirror and csrc/flash_attention.cu name the same tiles, ring
    and padding of K4's FFMA body."""
    text = (SOURCE.parent / "flash_attention.cu").read_text()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", text).group(1))

    assert (const("FF_BQ"), const("FF_BKV"), const("FF_THREADS")) == (
        tflash.FFMA_Q_ROWS, tflash.FFMA_KV_ROWS, tflash.FFMA_THREADS)
    assert re.search(r"constexpr int FF_LDP = FF_BKV \+ (\d+);", text).group(1) == str(tflash.FFMA_P_PAD)
    assert re.search(r"constexpr int ff_ld\(\) \{ return HS \+ (\d+); \}", text).group(1) == str(tflash.FFMA_PAD)
    assert re.search(r"ff_stages\(\) \{ return HS <= 128 \? (\d+) : (\d+); \}", text).groups() == (
        str(tflash.ffma_stages(128)), str(tflash.ffma_stages(256)))
    assert "simt_fwd_kernel" not in text  # the FFMA body takes both head sizes
    # heaviest first: the grid's y walks the query tiles from the last
    assert "const int qt = gridDim.y - 1 - blockIdx.y" in text


def ffma_model(q, k, v):
    """K4's FFMA body in plain PyTorch, in its order: query tiles of 64 rows,
    KV tiles of 64 keys up to the diagonal, each tile's row max and sum
    taken over its two halves of 32 keys (the row's two warps) and merged
    into the running max, sum and output."""
    B, H, T, hs = q.shape
    bq, bk = tflash.FFMA_Q_ROWS, tflash.FFMA_KV_ROWS
    scale = 1.0 / math.sqrt(hs)
    o = torch.empty_like(q)
    lse = torch.empty(B, H, T, 1)
    for q0 in range(0, T, bq):
        rows = torch.arange(q0, min(q0 + bq, T))
        m = torch.full((B, H, len(rows), 1), tflash.NEG_INF)
        l = torch.zeros(B, H, len(rows), 1)
        acc = torch.zeros(B, H, len(rows), hs)
        for k0 in range(0, q0 + bq, bk):
            keys = torch.arange(k0, min(k0 + bk, T))
            s = q[:, :, rows] @ k[:, :, keys].transpose(-1, -2) * scale
            s = torch.where(keys[None, :] <= rows[:, None], s, torch.full_like(s, tflash.NEG_INF))
            halves = [s[..., :32], s[..., 32:]] if len(keys) > 32 else [s]
            mt = torch.stack([h.amax(-1, keepdim=True) for h in halves]).amax(0)
            mn = torch.maximum(m, mt)
            alpha = torch.exp(m - mn)
            p = torch.exp(s - mn)
            tile_sum = sum(h.sum(-1, keepdim=True) for h in (p[..., :32], p[..., 32:]) if h.shape[-1])
            l = l * alpha + tile_sum
            acc = acc * alpha + p @ v[:, :, keys]
            m = mn
        o[:, :, rows] = acc / l.clamp_min(1e-30)
        lse[:, :, rows] = m + torch.log(l.clamp_min(1e-30))
    return o, lse


@pytest.mark.parametrize("B,H,T,hs", [(1, 2, 200, 128), (2, 1, 64, 128), (1, 1, 129, 256), (1, 2, 1, 128)])
def test_ffma_tile_order_matches_the_plain_version(B, H, T, hs):
    """The online softmax merged over KV tiles of 64, in halves of 32, gives
    flash_attention_ref's (o, lse) within the f32 tolerance the card holds
    the kernel to (chip_smoke.py TOL_F32: 1e-4 + 1e-4 |plain|)."""
    g = torch.Generator().manual_seed(B * 1000 + T + hs)
    q, k, v = (torch.randn(B, H, T, hs, generator=g) for _ in range(3))
    o, lse = ffma_model(q, k, v)
    ro, rlse = tflash.flash_attention_ref(q, k, v)
    for got, want in ((o, ro), (lse, rlse)):
        assert bool(((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all())


def test_constants_mirror_the_source():
    """The Python mirror and csrc/flash_sm90.cuh name the same tiles and rings."""
    text = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", text).group(1))

    assert const("FWD_BKV") == tflash.FWD_KV_ROWS
    assert (const("DQ_BQ"), const("DQ_BKV")) == (tflash.DQ_Q_ROWS, tflash.DQ_KV_ROWS)
    assert (const("DKV_BKV"), const("DKV_BQ")) == (tflash.DKV_KV_ROWS, tflash.DKV_Q_ROWS)
    assert (const("FWD_STAGES"), const("DQ_STAGES"), const("DKV_STAGES")) == (
        tflash.FWD_STAGES, tflash.DQ_STAGES, tflash.DKV_STAGES)
    assert const("MAX_SMEM") == tflash.SM90_MAX_SMEM


def test_plan_refuses_empty_shapes():
    with pytest.raises(ValueError):
        tflash.flash_plan(0, 32, 2048)
    with pytest.raises(ValueError):
        tflash.flash_plan(1, 32, 2048, 64)
    with pytest.raises(ValueError):
        tflash.sm90_blocks("bwd", 2048)
    with pytest.raises(ValueError):
        tflash.k4_warpgroups(tflash.flash_plan(1, 32, 2048), 2048)


def test_span_tool_instruments_each_kernel():
    """tools/spans.py finds each kernel's consumer code in the source it
    instruments: spans in all three kernels, the totals at each one's end."""
    from lit_llama_tpu_torch.tools import spans

    text = spans.instrument(SOURCE.read_text(), spans.FLASH).replace(spans.HEAD, "")
    for k in range(3):
        body = text.split(f"SPAN_BEGIN({k}, t128 == 0)")[1].split("SPAN_END(")[0]
        assert body.count("SPAN(") >= 8, k
    assert text.count("SPAN_BEGIN(") == 3 and text.count("SPAN_END(") == 3
    with pytest.raises(ValueError):  # an anchor the source no longer has
        spans.instrument(SOURCE.read_text(), spans.FLASH._replace(rules=(("no_such_call(", "SPAN(1);", "after"),)))


# K10's tilings (``k10_plan``): the Hopper kernels at head size 128, 256 and
# past it (bf16) and the 3xTF32 kernels (f32), mirrors of their sources
K10_CASES = [(128, torch.bfloat16, "sm90"), (256, torch.bfloat16, "sm90_hs256"), (128, torch.float32, "tf32"),
             (256, torch.float32, "tf32"), (384, torch.bfloat16, "sm90_wide"), (512, torch.bfloat16, "sm90_wide"),
             (640, torch.bfloat16, "sm90_wide")]
# the blocks of "sm90_wide" are the same at every head size past 256 (its plan
# is, test_k10_plan_past_256_keeps_each_chunk_in_registers): one case of it
K10_BLOCK_CASES = K10_CASES[:5]
HS256_SOURCE = SOURCE.parent / "flash_sm90_hs256.cuh"
TF32_SOURCE = SOURCE.parent / "flash_tf32.cuh"


@pytest.mark.parametrize("hs,dtype,body", K10_CASES)
def test_k10_plan_fits_the_card(hs, dtype, body):
    """Each kernel's shared memory fits a block's 227 KB; a consumer
    thread's f32 accumulators (outputs and score tiles) fit its register
    allotment, and the allotments fit the SM's register file; the tiling is
    the same at every shape, so a row's sums run in the same order."""
    plan = tflash.k10_plan(1, 32, 2048, hs, dtype)
    assert plan.body == body
    for kern in (plan.dq, plan.dkv):
        assert 0 < kern.smem <= tflash.SM90_MAX_SMEM
        assert kern.acc_regs <= kern.reg_limit <= tflash.MAX_THREAD_REGS
        if body == "tf32":
            assert kern.threads * kern.reg_limit <= tflash.SM_REGS
        else:  # a producer warpgroup at 24 registers, two consumers at the allotment
            assert kern.threads == 384 and 24 * 128 + 2 * 128 * kern.reg_limit <= tflash.SM_REGS
    for B, H, T in SHAPES:
        assert tflash.k10_plan(B, H, T, hs, dtype) == plan


def test_k10_plan_at_head_size_256_keeps_dq_and_dkv_in_registers():
    """What the hs-256 design is for: dQ (a 64 x 256 f32 tile, 128 registers)
    beside S and dP in one warpgroup; dK and dV (256 registers together) on
    two warpgroups, each beside one score tile; in f32, the column halves."""
    bf = tflash.k10_plan(1, 16, 2048, 256)
    assert (bf.dq.acc_regs, bf.dkv.acc_regs) == (128 + 64, 128 + 32)
    f32 = tflash.k10_plan(1, 16, 2048, 256, torch.float32)
    assert f32.dkv.acc_regs == 2 * 16 * 128 // 32 + 32  # dK and dV over 128 of the 256 columns


@pytest.mark.parametrize("hs,dtype,body", K10_BLOCK_CASES)
@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("T", [1, 65, 129, 2047, 2048])
def test_k10_blocks_visit_each_causal_pair_once(hs, dtype, body, kernel, T):
    """Every block owns one tile and the tiles own each row once; each
    causal (query, key) pair below T is covered by exactly one visit, no
    block visits a tile twice or one wholly above its diagonal, and blocks
    are issued heaviest first."""
    plan = tflash.k10_plan(1, 1, T, hs, dtype)
    tiling = getattr(plan, kernel)
    own, tile = tiling.own_rows, tiling.tile_rows
    blocks = tflash.k10_blocks(plan, kernel, T)
    assert sorted(t for t, _ in blocks) == list(range(-(-T // own)))
    work = [len(visits) for _, visits in blocks]
    assert work == sorted(work, reverse=True) and work[-1] >= 1
    seen = torch.zeros(T, T, dtype=torch.int32)  # (query, key)
    for mine, visits in blocks:
        assert len(set(visits)) == len(visits)
        rows = range(mine * own, min((mine + 1) * own, T))
        for other in visits:
            others = range(other * tile, min((other + 1) * tile, T))
            queries, keys = (rows, others) if kernel == "dq" else (others, rows)
            assert len(queries) and len(keys) and min(keys) <= max(queries), "a tile wholly above the diagonal"
            seen[torch.tensor(list(queries))[:, None], torch.tensor(list(keys))[None, :]] += 1
    causal = torch.ones(T, T, dtype=torch.bool).tril()
    assert bool((seen[causal] == 1).all())


def test_k10_plan_past_256_keeps_each_chunk_in_registers():
    """What the wide design is for: at every head size past 256 a block owns
    a chunk of 256 output columns, so a consumer thread holds dQ's chunk
    beside S and dP, or dK's / dV's chunk beside one score tile, as at 256;
    shared memory is the same at every head size (the scores' operands stream
    as 64-column panels) and holds one block an SM."""
    at256 = tflash.k10_plan(1, 16, 2048, 256)
    for hs in (384, 512, 640, 1024):
        plan = tflash.k10_plan(1, 8, 1024, hs)
        assert plan.body == "sm90_wide"
        assert (plan.dq.acc_regs, plan.dkv.acc_regs) == (at256.dq.acc_regs, at256.dkv.acc_regs) == (128 + 64, 128 + 32)
        assert plan == tflash.k10_plan(3, 5, 77, 640)
        for kern in (plan.dq, plan.dkv):
            assert tflash.SM90_MAX_SMEM // 2 < kern.smem <= tflash.SM90_MAX_SMEM


def test_k10_constants_mirror_the_sources():
    """The Python mirror and csrc/flash_sm90_hs256.cuh / flash_tf32.cuh /
    flash_sm90.cuh name the same tiles, rings, threads and registers."""
    hs256, tf32, sm90 = (p.read_text() for p in (HS256_SOURCE, TF32_SOURCE, SOURCE))

    def const(text, name):
        return int(re.search(rf"\b{name} = (\d+)", text).group(1))

    assert [const(hs256, n) for n in ("DQ_BQ", "DQ_BKV", "DQ_KSTAGES", "DQ_VSTAGES")] == [
        tflash.HS256_DQ_Q_ROWS, tflash.HS256_DQ_KV_ROWS, tflash.HS256_DQ_K_STAGES, tflash.HS256_DQ_V_STAGES]
    assert [const(hs256, n) for n in ("DKV_BKV", "DKV_BQ", "DKV_STAGES", "DKV_PBUFS")] == [
        tflash.HS256_DKV_KV_ROWS, tflash.HS256_DKV_Q_ROWS, tflash.HS256_DKV_STAGES, tflash.HS256_DKV_PBUFS]
    assert hs256.count("__launch_bounds__(384, 1)") == 2 and tflash.SM90_THREADS == 384
    wide = WIDE_SOURCE.read_text()
    assert [const(wide, n) for n in ("DQ_BQ", "DQ_BKV", "DQ_STAGES", "DQ_KC_STAGES", "CHUNK")] == [
        tflash.WIDE_DQ_Q_ROWS, tflash.WIDE_DQ_KV_ROWS, tflash.WIDE_DQ_STAGES, tflash.WIDE_DQ_KC_STAGES,
        tflash.WIDE_CHUNK]
    assert [const(wide, n) for n in ("DKV_BKV", "DKV_BQ", "DKV_STAGES", "DKV_PBUFS")] == [
        tflash.WIDE_DKV_KV_ROWS, tflash.WIDE_DKV_Q_ROWS, tflash.WIDE_DKV_STAGES, tflash.WIDE_DKV_PBUFS]
    assert wide.count("__launch_bounds__(384, 1)") == 3  # K4, dq, dK/dV
    # the shared memory sums, term for term (the stage and chunk sizes they take)
    assert "constexpr int DQ_STAGE = (2 * DQ_BQ + 2 * DQ_BKV) * PANEL_ROW;" in wide
    assert "constexpr int KC_TILE = DQ_BKV * CHUNK * 2;" in wide
    assert "constexpr int DKV_STAGE = (2 * DKV_BKV + 2 * DKV_BQ) * PANEL_ROW;" in wide
    assert "constexpr int DKV_CHUNK = 2 * DKV_BQ * CHUNK * 2 + 2 * DKV_BQ * 4;" in wide
    assert "return 1024 + DQ_STAGES * DQ_STAGE + DQ_KC_STAGES * KC_TILE + 2 * (DQ_STAGES + DQ_KC_STAGES) * 8;" in wide
    assert ("return 1024 + DKV_STAGES * DKV_STAGE + DKV_CHUNK + DKV_PBUFS * DKV_BKV * DKV_BQ * 4 +\n"
            "         2 * (DKV_STAGES + 1 + DKV_PBUFS) * 8;") in wide
    # heaviest first: dq the last Q tile, dK/dV the first KV tile; k10_blocks' tile counts
    assert "const int qt = p.n_tiles - 1 - blockIdx.y, q_first = qt * DQ_BQ;" in wide
    assert "const int k_first = blockIdx.y * DKV_BKV;" in wide
    assert "const int i0 = k_first / DKV_BQ, n_q = (p.T + DKV_BQ - 1) / DKV_BQ;" in wide
    assert const(sm90, "CONSUMER_REGS") == tflash.SM90_CONSUMER_REGS
    assert (const(tf32, "TILE"), const(tf32, "PAD")) == (tflash.TF32_TILE, tflash.TF32_PAD)
    for hs, tiling in tflash.TF32_TILING.items():
        got = re.search(rf"struct Tiling<{hs}> \{{ static constexpr int ROWS = (\d+), CS = (\d+), STAGES = (\d+); \}};",
                        tf32).groups()
        assert tuple(map(int, got)) == tiling
    assert const(tf32, "MAX_SMEM") == tflash.SM90_MAX_SMEM
    # heaviest first in the f32 kernels: the last Q tile, the first KV tile
    assert "(gridDim.y - 1 - blockIdx.y) * ROWS" in tf32 and "const int k_first = blockIdx.y * ROWS;" in tf32


def test_k10_plan_refuses_what_it_does_not_tile():
    """Only f32 past 256 (the chunked FFMA kernels) carries no tiling; bf16
    past 256 takes the wide Hopper kernels."""
    assert tflash.k10_plan(1, 8, 1024, 384, torch.float32).body == "chunked"
    assert tflash.k10_plan(1, 8, 1024, 384).body == "sm90_wide"
    with pytest.raises(ValueError):
        tflash.k10_plan(0, 32, 2048)
    with pytest.raises(ValueError):
        tflash.k10_plan(1, 32, 2048, 64)
    with pytest.raises(ValueError):
        tflash.k10_blocks(tflash.k10_plan(1, 8, 1024, 512, torch.float32), "dq", 1024)
    with pytest.raises(ValueError):
        tflash.k10_blocks(tflash.k10_plan(1, 8, 1024), "bwd", 1024)
