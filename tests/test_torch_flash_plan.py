"""The tiling of the flash-attention kernels on the card (K4 and K10,
``ops.flash_attention.flash_plan`` and ``sm90_blocks``): pure functions of
the shapes, mirrors of what ``csrc/flash_sm90.cuh`` computes, so what each
kernel is asked to do is testable here, where the kernels cannot run."""

import re
from pathlib import Path

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


@pytest.mark.parametrize("kernel,q_rows", [("fwd", 64), ("fwd", 128), ("dq", 128), ("dkv", 128)])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 127, 128, 129, 200, 2047, 2048])
def test_blocks_are_issued_heaviest_first(kernel, q_rows, T):
    """The grid's row index walks the tiles from the one with the most work:
    K4 and dq the last Q tile first, dK/dV the first KV tile first."""
    blocks = tflash.sm90_blocks(kernel, T, q_rows)
    work = [len(visits) for _, visits in blocks]
    assert work == sorted(work, reverse=True) and work[-1] >= 1
    own = [tile for tile, _ in blocks]
    assert own[0] == (0 if kernel == "dkv" else len(blocks) - 1)


@pytest.mark.parametrize("kernel,q_rows", [("fwd", 64), ("fwd", 128), ("dq", 128), ("dkv", 128)])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 127, 128, 129, 200, 383, 2047, 2048])
def test_every_tile_is_visited_once(kernel, q_rows, T):
    """Every block owns one tile, and the tiles own each row once; each
    causal (query, key) pair below T is covered by exactly one visit, and a
    block visits no tile twice and none wholly above its diagonal."""
    rows, kv = {"fwd": (q_rows, tflash.FWD_KV_ROWS), "dq": (tflash.DQ_Q_ROWS, tflash.DQ_KV_ROWS),
                "dkv": (tflash.DKV_Q_ROWS, tflash.DKV_KV_ROWS)}[kernel]
    blocks = tflash.sm90_blocks(kernel, T, q_rows)
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
                                           (256, torch.bfloat16, "mma"), (384, torch.bfloat16, "chunked"),
                                           (512, torch.float32, "chunked")])
def test_other_head_sizes_and_f32_take_the_present_bodies(hs, dtype, body):
    plan = tflash.flash_plan(1, 32, 2048, hs, dtype)
    assert plan.body == body and plan.q_rows == 0


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
        tflash.sm90_blocks("bwd", 2048)


def test_span_tool_instruments_each_kernel():
    """tools/flash_spans.py finds each kernel's consumer code in the source it
    instruments: spans in all three kernels, the totals at each one's end."""
    from lit_llama_tpu_torch.tools import flash_spans

    text = flash_spans.instrument(SOURCE.read_text())
    for k in range(3):
        assert text.count(f"SPAN({k}, ") >= 8, k
        assert text.count(f"g_spans[{k}][13]") == 1, k
    assert text.count("unsigned long long t_mark = clk()") == 3
