"""K4, the causal flash forward, and the plain attention: the port's plain
versions against the JAX package on the CPU (f32; the Pallas kernel in
interpret mode), and the CUDA kernel against the plain version on the card
(skipped without one)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lit_llama_tpu.ops import attention as jattn
from lit_llama_tpu.ops import flash_attention as jflash
from lit_llama_tpu_torch.ops import attention as tattn
from lit_llama_tpu_torch.ops import flash_attention as tflash


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _qkv(rng, B, H, T, hs=128):
    return [rng.normal(size=(B, H, T, hs)).astype(np.float32) for _ in range(3)]


# head size 128, every preset's, and the head sizes the card's Hopper bodies
# take past it (256: csrc/flash_sm90_hs256.cuh; 384 and 512:
# csrc/flash_sm90_wide.cuh), which the JAX gate sends to the Pallas kernel as
# it does 128: the plain version holds
@pytest.mark.parametrize("T,hs", [(128, 128), (256, 128), (128, 256), (128, 384), (128, 512)])
def test_flash_ref_matches_pallas(rng, T, hs):
    q, k, v = _qkv(rng, 1, 2, T, hs)
    with pltpu.force_tpu_interpret_mode():
        jo, jlse = jflash._flash_forward(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 128, 128
        )
    to, tlse = tflash.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("T,S,causal", [(7, 7, True), (3, 12, False)])
def test_attention_ref_matches_xla(rng, T, S, causal):
    q = rng.normal(size=(2, 3, T, 128)).astype(np.float32)
    k = rng.normal(size=(2, 3, S, 128)).astype(np.float32)
    v = rng.normal(size=(2, 3, S, 128)).astype(np.float32)
    mask = np.tril(np.ones((T, S), bool)) if causal else rng.random((1, 1, T, S)) < 0.7
    mask = np.broadcast_to(mask, (1, 1, T, S)).copy()
    mask[..., 0] = True
    want = jattn.attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask))
    tq, tk, tv, tm = (torch.from_numpy(a) for a in (q, k, v, mask))
    got = tattn.attention_ref(tq, tk, tv, tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    # the dispatcher agrees on either path
    np.testing.assert_allclose(
        tattn.attention(tq, tk, tv, tm, causal=causal).numpy(), np.asarray(want), rtol=1e-4, atol=1e-4
    )


@pytest.mark.parametrize("T", [64, 200, 512])
def test_flash_kernel_matches_plain(rng, cuda, T):
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in _qkv(rng, 1, 4, T))
    before = tflash.flash_attention.launches
    o, lse = tflash.flash_attention(q, k, v)
    ro, rlse = tflash.flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert tflash.flash_attention.launches == before + 1
    torch.testing.assert_close(o.float(), ro.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lse, rlse, rtol=1e-3, atol=1e-3)
    with pytest.raises(ValueError):
        tflash.flash_attention(q[..., :64].contiguous(), k[..., :64].contiguous(), v[..., :64].contiguous())


# f32 compute takes the FFMA body; bf16 at 256 the Hopper kernel of
# csrc/flash_sm90_hs256.cuh (held at more lengths below)
@pytest.mark.parametrize("dtype,hs", [("float32", 128), ("bfloat16", 256), ("float32", 256)])
@pytest.mark.parametrize("T", [65, 200])
def test_flash_kernel_f32_and_head_size_256(rng, cuda, dtype, hs, T):
    cd = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 3, T, hs)).astype(np.float32)).to(cuda, cd) for _ in range(3))
    before = tflash.flash_attention.launches
    o, lse = tflash.flash_attention(q, k, v)
    ro, rlse = tflash.flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert tflash.flash_attention.launches == before + 1 and o.dtype == cd
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(o.float(), ro.float(), **tol)
    torch.testing.assert_close(lse, rlse, rtol=1e-4, atol=1e-4)


# past head size 256: bf16 on the Hopper kernel of csrc/flash_sm90_wide.cuh
# (chunks of 256 output columns a block; at 384 and 640 the last chunk holds
# 128), f32 on the chunked FFMA kernels (128 output columns a block)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("hs", [384, 512, 640])
@pytest.mark.parametrize("T", [65, 200, 1025])
def test_flash_kernel_head_sizes_past_256(rng, cuda, dtype, hs, T):
    cd = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 3, T, hs)).astype(np.float32)).to(cuda, cd) for _ in range(3))
    before = tflash.flash_attention.launches
    o, lse = tflash.flash_attention(q, k, v)
    ro, rlse = tflash.flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert tflash.flash_attention.launches == before + 1 and o.dtype == cd
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(o.float(), ro.float(), **tol)
    torch.testing.assert_close(lse, rlse, rtol=1e-4, atol=1e-4)


# bf16 at head size 128 runs on the Hopper kernel (csrc/flash_sm90.cuh): ragged
# T on either side of its 64- and 128-row tiles, B = 2, a rerun, and both tile
# plans, under which a query row runs the same steps and so gets the same bits
@pytest.mark.parametrize("T", [65, 127, 129, 200, 2047, 2048])
def test_flash_sm90_kernel_matches_plain(rng, cuda, T, monkeypatch):
    B, H = 2, 4
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in _qkv(rng, B, H, T))
    plan = tflash.flash_plan(B, H, T)
    assert plan.body == "sm90"
    before = tflash.flash_attention.launches
    o, lse = tflash.flash_attention(q, k, v)
    ro, rlse = tflash.flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert tflash.flash_attention.launches == before + 1
    torch.testing.assert_close(o.float(), ro.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lse, rlse, rtol=1e-3, atol=1e-3)
    again = tflash.flash_attention(q, k, v)
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    other = plan._replace(q_rows=192 - plan.q_rows, smem=tflash.sm90_smem("fwd", 192 - plan.q_rows))
    monkeypatch.setattr(tflash, "flash_plan", lambda *a, **kw: other)
    o2, lse2 = tflash.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2), f"plans {plan.q_rows} and {other.q_rows} rows differ"


# bf16 at head size 256 runs on the Hopper kernel of csrc/flash_sm90_hs256.cuh:
# ragged T on either side of its 64-key tiles and 64- and 128-row blocks, B =
# 2, a rerun, and both tile plans, under which a query row runs the same steps
# and so gets the same bits
@pytest.mark.parametrize("T", [65, 127, 129, 200, 2047, 2048])
def test_flash_sm90_hs256_kernel_matches_plain(rng, cuda, T, monkeypatch):
    B, H = 2, 4
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in _qkv(rng, B, H, T, 256))
    plan = tflash.flash_plan(B, H, T, 256)
    assert plan.body == "sm90_hs256"
    before = tflash.flash_attention.launches
    o, lse = tflash.flash_attention(q, k, v)
    ro, rlse = tflash.flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert tflash.flash_attention.launches == before + 1
    torch.testing.assert_close(o.float(), ro.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lse, rlse, rtol=1e-3, atol=1e-3)
    again = tflash.flash_attention(q, k, v)
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    other = plan._replace(q_rows=192 - plan.q_rows, smem=tflash.hs256_smem(192 - plan.q_rows))
    monkeypatch.setattr(tflash, "flash_plan", lambda *a, **kw: other)
    o2, lse2 = tflash.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2), f"plans {plan.q_rows} and {other.q_rows} rows differ"
