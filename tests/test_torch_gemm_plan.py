"""The launch plans of the prefill GEMMs: the Hopper mainloop (K3 and K6 at
M > 1 in bf16, ``ops.quant_matmul.gemm_plan``) and the f32 tile (K3 and K6
at M > 1 in f32, K7 / K9 in f32, ``f32_plan``): pure functions of the
shapes, so what the kernels are asked to do is testable here, where the
kernels cannot run."""

import re
from pathlib import Path

import pytest
import torch

from lit_llama_tpu_torch.ops import quant_matmul as tqm

# (name, K, N) of the five 7B linears
LINEARS_7B = [("c_attn", 4096, 12288), ("attn.c_proj", 4096, 4096), ("c_fc12", 4096, 22016),
              ("mlp.c_proj", 11008, 4096), ("lm_head", 4096, 32000)]


def _check(plan, M, N, K, gs):
    assert plan.nt in tqm.SM90_TILES
    assert plan.token_tiles == -(-M // plan.nt) and plan.nt * plan.token_tiles >= M
    assert 2 <= plan.stages <= 8 and plan.smem <= tqm.SM90_MAX_SMEM
    assert plan.smem == tqm._sm90_smem(gs > 0, plan.nt, plan.stages, plan.gr)
    steps = -(-K // tqm.SM90_STEP)
    # every split has work, and the splits cover K's k-steps once
    assert plan.per * (plan.splits - 1) < steps <= plan.per * plan.splits
    if gs > 0:  # the scale rows a 32-row plane of a step spans
        assert 1 <= plan.gr <= K // gs
        assert plan.gr == 1 if gs % 32 == 0 else plan.gr >= 2


@pytest.mark.parametrize("gs", [128, 0], ids=["int4", "int8"])
@pytest.mark.parametrize("name,K,N", LINEARS_7B, ids=[n for n, _, _ in LINEARS_7B])
def test_k_split_does_not_depend_on_m(name, K, N, gs):
    """A row's sums are added in the same order at any M: the K split (the
    count and the k-steps of each part) comes from N and K alone."""
    plans = {M: tqm.gemm_plan(M, N, K, gs) for M in range(1, 513)}
    assert len({(p.splits, p.per) for p in plans.values()}) == 1
    for M, plan in plans.items():
        _check(plan, M, N, K, gs)
    # a prefill of up to 256 tokens is one token tile, multiplying at most 31 rows
    # of zeros (the rounding up to a width wgmma takes); past 256, tiles of even size
    for M, plan in plans.items():
        if M <= 256:
            assert plan.token_tiles == 1 and plan.nt - M < 32
        else:
            assert plan.token_tiles == -(-M // 256)


@pytest.mark.parametrize("K", [768, 1024, 4096])
def test_every_group_size_gets_a_plan(K):
    """K3 takes every group size that divides K (check_int4), down to one row
    a group: each gets a plan at every M up to 512."""
    for gs in [d for d in range(1, K + 1) if K % d == 0]:
        for M in range(1, 513, 7):
            _check(tqm.gemm_plan(M, 1040, K, gs), M, 1040, K, gs)


def test_plan_refuses_empty_shapes():
    with pytest.raises(ValueError):
        tqm.gemm_plan(0, 4096, 4096)


# ---- the f32 tile (csrc/gemm_f32.cuh): K3 and K6 at M > 1 in f32, K7 / K9 in f32 ----

F32_SOURCE = Path(tqm.__file__).resolve().parent.parent / "csrc" / "gemm_f32.cuh"
TOL_F32 = (1e-4, 1e-4)  # chip_smoke.py's f32 tolerance


def _divisors(K):
    return [d for d in range(1, K + 1) if K % d == 0]


@pytest.mark.parametrize("name,K,N", LINEARS_7B, ids=[n for n, _, _ in LINEARS_7B])
def test_f32_split_does_not_depend_on_m(name, K, N):
    """The f32 tile's K split (the count and the k-steps of each part) comes
    from N and K alone, at every M from 1 to 8192 (GPTQ's calibration
    forwards) and every group size dividing K; a block takes the fewest of
    32, 64 or 128 rows that hold M, and two blocks fit on an SM."""
    split = None
    for gs in _divisors(K):
        for M in (range(1, 8193) if gs == 128 else range(1, 8193, 97)):
            plan = tqm.f32_plan(M, N, K, gs)
            assert split in (None, (plan.splits, plan.per))
            split = (plan.splits, plan.per)
            assert plan.bm == (32 if M <= 32 else 64 if M <= 64 else 128)
            assert plan.row_tiles == -(-M // plan.bm) and plan.col_tiles == -(-N // tqm.F32_BN)
            assert plan.smem == tqm.f32_smem(plan.bm) and 2 * plan.smem <= tqm.SM90_MAX_SMEM
            assert plan.step_groups == (gs % tqm.F32_BK == 0)
    splits, per = split
    steps = -(-K // tqm.F32_BK)
    assert per * (splits - 1) < steps <= per * splits  # every split has work; together they cover K once
    assert splits == 1 or per * tqm.F32_BK >= tqm.F32_SPLIT_MIN_K
    # the card's SM count moves the split; the shapes alone decide it for a given card
    assert tqm.f32_plan(8192, N, K, 128, 66).splits >= 1


def test_f32_constants_mirror_the_source():
    """The Python mirror and csrc/gemm_f32.cuh name the same tile, ring and rows."""
    text = F32_SOURCE.read_text()
    got = dict(re.findall(r"\b([A-Z_]+) = (\d+)", text.split("namespace gemm_f32 {")[1].split("template")[0]))
    assert (int(got["BN"]), int(got["BK"]), int(got["THREADS"]), int(got["STAGES"])) == (
        tqm.F32_BN, tqm.F32_BK, tqm.F32_THREADS, tqm.F32_STAGES)
    assert (int(got["ROWS_SMALL"]), int(got["ROWS_MID"]), int(got["ROWS_FULL"])) == tqm.F32_ROWS
    assert "constexpr int LDA = BK + 4;" in text
    assert "return (STAGES * 16 * RT * LDA + 2 * BK * BN + STAGES * 2 * BN) * 4;" in text
    assert "__launch_bounds__(THREADS, 2)" in text  # two blocks an SM, as f32_plan's smem check assumes
    assert "workspace" not in text.split("#pragma once")[1]  # the splits add in the kernel


def f32_tile_model(x, w, plan, colscale=None):
    """The f32 tile's sums in plain PyTorch, in its order: K in the plan's
    splits, each split's partial added into the output in split order, the
    column scale on the last."""
    K = x.shape[-1]
    step = plan.per * tqm.F32_BK
    out = None
    for z in range(plan.splits):
        part = x[:, z * step:min(K, (z + 1) * step)] @ w[z * step:min(K, (z + 1) * step)]
        out = part if out is None else out + part
    return out if colscale is None else out * colscale


def _held(got, want):
    return bool(((got - want).abs() <= TOL_F32[0] + TOL_F32[1] * want.abs()).all())


@pytest.mark.parametrize("M,K,N,gs", [(8, 4096, 256, 128), (200, 4096, 128, 32), (65, 1536, 512, 24),
                                      (33, 11008 // 4, 256, 86)])
def test_f32_split_order_matches_the_plain_int4_version(M, K, N, gs):
    """The K split summed in its fixed order equals matmul_int4_ref in f32
    within the tolerance the card holds K3 f32 to, at group sizes that 32
    divides and that it does not."""
    from lit_llama_tpu_torch.ops.linear import dequantize_int4, quantize_int4

    g = torch.Generator().manual_seed(M + K + gs)
    q = quantize_int4(torch.randn(K, N, generator=g) * 0.02, gs)
    x = torch.randn(M, K, generator=g)
    plan = tqm.f32_plan(M, N, K, gs)
    assert plan.splits > 1 or K < 2 * tqm.F32_SPLIT_MIN_K
    got = f32_tile_model(x, dequantize_int4(q, torch.float32), plan)
    assert _held(got, tqm.matmul_int4_ref(x, q["qw"], q["qscale"], q["qzero"], torch.float32))


@pytest.mark.parametrize("M,K,N", [(8, 4096, 4096), (128, 1032, 272)])
def test_f32_split_order_matches_the_plain_int8_version(M, K, N):
    """The same for K6 at M > 1 in f32: the split sums in order, the column
    scale once at the end, against matmul_int8_ref."""
    from lit_llama_tpu_torch.ops.linear import quantize_int8

    g = torch.Generator().manual_seed(M + K)
    q = quantize_int8(torch.randn(K, N, generator=g) * 0.02)
    x = torch.randn(M, K, generator=g)
    got = f32_tile_model(x, q["qw"].float(), tqm.f32_plan(M, N, K), q["qscale"].float().reshape(-1))
    assert _held(got, tqm.matmul_int8_ref(x, q["qw"], q["qscale"], torch.float32))


def test_f32_plan_refuses_empty_shapes():
    with pytest.raises(ValueError):
        tqm.f32_plan(0, 4096, 4096)
