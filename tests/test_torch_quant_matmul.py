"""K3, the int4 matmul: the port's plain version against the JAX Pallas kernel
in interpret mode on the CPU (f32), and the CUDA kernel against the plain
version on the card (skipped without one)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lit_llama_tpu.ops import quant_matmul_pallas as qmp
from lit_llama_tpu_torch.ops import linear as tlin
from lit_llama_tpu_torch.ops import quant_matmul as tqm


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _quantized(rng, K, N, gs=128):
    w = rng.normal(size=(K, N)).astype(np.float32) * 0.02
    return tlin.quantize_int4(torch.from_numpy(w), groupsize=gs)


# K = 768: 6 groups, 3 per nibble plane (odd, like 7B mlp.c_proj's 43)
@pytest.mark.parametrize("M", [1, 8, 128])
@pytest.mark.parametrize("K,N", [(512, 256), (768, 384)])
def test_matmul_int4_ref_matches_pallas(rng, M, K, N):
    q = _quantized(rng, K, N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    want = qmp.matmul_int4(
        jnp.asarray(x), *(jnp.asarray(q[k].numpy()) for k in ("qw", "qscale", "qzero")),
        jnp.float32, interpret=True,
    )
    got = tqm.matmul_int4_ref(torch.from_numpy(x), q["qw"], q["qscale"], q["qzero"], torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    # the dispatching wrapper takes the plain version for a CPU tensor
    out = tqm.matmul_int4(torch.from_numpy(x), q["qw"], q["qscale"], q["qzero"], torch.float32)
    assert torch.equal(out, got)


# N = 1040 is not a multiple of the tile; K = 1536 has 6 groups per nibble
# plane, K = 768 has 3 and K = 11008 (7B mlp.c_proj) 43, both odd
@pytest.mark.parametrize("M", [8, 128, 200])
@pytest.mark.parametrize("K,N", [(1536, 1040), (768, 1040), (11008, 1040)])
def test_matmul_int4_kernel_matches_plain(rng, cuda, M, K, N):
    q = {k: v.to(cuda) for k, v in _quantized(rng, K, N).items()}
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(cuda, torch.bfloat16)
    before = tqm.matmul_int4.launches
    got = tqm.matmul_int4(x, q["qw"], q["qscale"], q["qzero"])
    want = tqm.matmul_int4_ref(x, q["qw"], q["qscale"], q["qzero"])
    torch.cuda.synchronize()
    assert tqm.matmul_int4.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    with pytest.raises(TypeError):  # x not in the compute dtype
        tqm.matmul_int4(x.float(), q["qw"], q["qscale"], q["qzero"], torch.bfloat16)


# f32 compute (the FFMA tile) at 7B's c_attn K and odd shapes; bf16 and f32
# at group sizes whose groups split the 64-row k-step (16, 32) and at one
# group for all of K (gs = -1), which the JAX package's shape gate admits
@pytest.mark.parametrize("dtype,gs", [("float32", 128), ("float32", 32), ("bfloat16", 32), ("bfloat16", 16),
                                      ("bfloat16", -1), ("float32", -1)])
@pytest.mark.parametrize("M", [1, 8, 200])
def test_matmul_int4_kernel_f32_and_any_group_size(rng, cuda, dtype, gs, M):
    from lit_llama_tpu_torch.ops.linear import quantize_int4

    K, N = 1024, 1040
    q = {k: v.to(cuda) for k, v in quantize_int4(torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32)) * 0.02,
                                                 gs).items()}
    cd = getattr(torch, dtype)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(cuda, cd)
    before = tqm.matmul_int4.launches
    got = tqm.matmul_int4(x, q["qw"], q["qscale"], q["qzero"], cd)
    want = tqm.matmul_int4_ref(x, q["qw"], q["qscale"], q["qzero"], cd)
    torch.cuda.synchronize()
    assert tqm.matmul_int4.launches == before + 1 and got.dtype == cd
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)


MS = [2, 7, 8, 9, 127, 128, 129, 200, 256, 257, 512]


# the Hopper mainloop (csrc/gemm_sm90.cuh) at every token tile it picks and
# across token tiles (M > 256), at 7B widths and odd ones (N = 1040: the last
# 128-column tile has 16 columns; N = 1032, rows of N bytes that TMA cannot
# describe, takes the cp.async copies), group sizes that split (8, 32) or fill
# (64, 128) a 32-row plane of a k-step
@pytest.mark.parametrize("K,N,gs", [(4096, 12288, 128), (11008, 4096, 128), (1024, 1040, 32), (1024, 1040, 64),
                                    (1536, 1040, 128), (1024, 1032, 8)])
def test_matmul_int4_kernel_every_token_tile(rng, cuda, K, N, gs):
    q = {k: v.to(cuda) for k, v in _quantized(rng, K, N, gs).items()}
    x = torch.from_numpy(rng.normal(size=(max(MS), K)).astype(np.float32)).to(cuda, torch.bfloat16)
    for M in MS:
        xm = x[:M].contiguous()
        before = tqm.matmul_int4.launches
        got = tqm.matmul_int4(xm, q["qw"], q["qscale"], q["qzero"])
        want = tqm.matmul_int4_ref(xm, q["qw"], q["qscale"], q["qzero"])
        torch.cuda.synchronize()
        assert tqm.matmul_int4.launches == before + 1
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2, msg=f"M={M}")


# a row's output is the same bits at any M (the K split comes from N and K
# alone, ops/quant_matmul.py gemm_plan) and on a rerun
@pytest.mark.parametrize("K,N,gs", [(4096, 4096, 128), (11008, 4096, 128), (1024, 1040, 32)])
def test_matmul_int4_kernel_rows_equal_across_m(rng, cuda, K, N, gs):
    q = {k: v.to(cuda) for k, v in _quantized(rng, K, N, gs).items()}
    x = torch.from_numpy(rng.normal(size=(512, K)).astype(np.float32)).to(cuda, torch.bfloat16)
    full = tqm.matmul_int4(x, q["qw"], q["qscale"], q["qzero"])
    assert torch.equal(full, tqm.matmul_int4(x, q["qw"], q["qscale"], q["qzero"]))
    for M in (8, 200):
        assert torch.equal(full[:M], tqm.matmul_int4(x[:M].contiguous(), q["qw"], q["qscale"], q["qzero"])), M
