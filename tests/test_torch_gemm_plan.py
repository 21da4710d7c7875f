"""The launch plan of the prefill GEMMs' Hopper mainloop (K3 and K6 at M > 1,
``ops.quant_matmul.gemm_plan``): a pure function of the shapes, so what the
kernel is asked to do is testable here, where the kernel cannot run."""

import pytest

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
