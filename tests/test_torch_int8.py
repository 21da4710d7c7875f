"""K6, the int8 matmul: the port's plain version against the JAX Pallas kernel
in interpret mode and against ``matmul_int8_xla`` on the CPU, the int8 pieces
around it (``linear``, the random int8 weights, the parameter carry-over), and
the CUDA kernel against the plain version on the card (skipped without one).

Tolerances. f32: both sides sum the same exact products in another order,
1e-4 relative and absolute (outputs are O(1)). bf16: both round the same f32
sum times the scale once, so they differ by at most one bf16 ulp of an O(1)
value, inside 2e-2 + 2e-2 * |want|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lit_llama_tpu.ops import quant_matmul as jqm
from lit_llama_tpu.ops import quant_matmul_pallas as qmp
from lit_llama_tpu_torch.models import llama as tllama
from lit_llama_tpu_torch.models.config import LLaMAConfig
from lit_llama_tpu_torch.ops import linear as tlin
from lit_llama_tpu_torch.ops import quant_matmul as tqm
from lit_llama_tpu_torch.utils.jax_params import params_from_numpy, tensor_from_numpy
from lit_llama_tpu_torch.utils.random_params import random_int8_params

TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _quantized(rng, K, N):
    """int8 weight whose per-column scales differ by up to 4x."""
    w = rng.normal(size=(K, N)).astype(np.float32) * 0.02 * rng.uniform(0.5, 2.0, size=(1, N)).astype(np.float32)
    return tlin.quantize_int8(torch.from_numpy(w))


def _jax_operands(x, q, dtype):
    return jnp.asarray(x).astype(dtype), jnp.asarray(q["qw"].numpy()), jnp.asarray(q["qscale"].numpy())


# K = 11008 is 7B's mlp.c_proj (512 does not divide it); K = 1000 has no
# lane-aligned divisor at all, so the Pallas kernel leaves it untiled
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 8, 200])
@pytest.mark.parametrize("K,N", [(512, 256), (11008, 256), (1000, 384)])
def test_matmul_int8_ref_matches_pallas(rng, M, K, N, dtype):
    q = _quantized(rng, K, N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    want = qmp.matmul_int8(*_jax_operands(x, q, dtype), jnp.dtype(dtype), interpret=True)
    tdt = getattr(torch, dtype)
    got = tqm.matmul_int8_ref(torch.from_numpy(x).to(tdt), q["qw"], q["qscale"], tdt)
    assert got.dtype == tdt and got.shape == (M, N)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **TOL[dtype])
    # the dispatching wrapper takes the plain version for a CPU tensor
    out = tqm.matmul_int8(torch.from_numpy(x).to(tdt), q["qw"], q["qscale"], tdt)
    assert torch.equal(out, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(1, 768, 256), (9, 512, 1088), (8, 11008, 256), (200, 1000, 384)])
def test_matmul_int8_both_plain_versions_match_xla(rng, M, K, N, dtype):
    """``matmul_int8_dequant`` is the counterpart of ``matmul_int8_xla`` (the
    same rounding of scale * weight); K6's plain version scales once at the
    end and stays inside the dtype's tolerance of it."""
    q = _quantized(rng, K, N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    want = np.asarray(jqm.matmul_int8_xla(*_jax_operands(x, q, dtype), jnp.dtype(dtype)).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt)
    dq = tlin.matmul_int8_dequant(xt, q["qw"], q["qscale"], tdt)
    # bf16 on the CPU: the two frameworks sum the bf16 product in another order
    np.testing.assert_allclose(dq.float().numpy(), want, **TOL[dtype])
    ref = tqm.matmul_int8_ref(xt, q["qw"], q["qscale"], tdt)
    np.testing.assert_allclose(ref.float().numpy(), want, **TOL[dtype])


def test_linear_int8_takes_k6_plain_version(rng):
    """(B, T, K) leading dims collapse; ``linear`` resolves int8 params to
    ``quant_matmul.matmul_int8`` and applies the adapter-v2 scale and bias."""
    K, N = 256, 320
    q = _quantized(rng, K, N)
    x = torch.from_numpy(rng.normal(size=(2, 3, K)).astype(np.float32))
    want = tqm.matmul_int8_ref(x, q["qw"], q["qscale"], torch.float32)
    assert want.shape == (2, 3, N)
    assert torch.equal(tlin.linear(q, x), want)
    assert torch.equal(tlin.linear(q, x, plain=True), want)
    from lit_llama_tpu.ops import linear as jlin

    jq = {k: jnp.asarray(v.numpy()) for k, v in q.items()}
    np.testing.assert_allclose(tlin.linear(q, x).numpy(), np.asarray(jlin.linear(jq, jnp.asarray(x.numpy()))),
                               **TOL["float32"])
    av2 = dict(q, av2_scale=torch.full((1, N), 2.0), av2_bias=torch.full((1, N), 0.5))
    torch.testing.assert_close(tlin.linear(av2, x), (want + 0.5) * 2.0)


def test_random_int8_params():
    cfg = LLaMAConfig(block_size=64, vocab_size=100, n_layer=3, n_head=2, n_embd=64, quantize="int8")
    p = random_int8_params(cfg, seed=3, device="cpu")
    D, I, V = 64, cfg.intermediate_size, 128
    want = {"c_attn": (D, 3 * D), "c_proj": (D, D)}
    for name, (k, n) in want.items():
        lin = p["h"]["attn"][name]
        assert lin["qw"].shape == (3, k, n) and lin["qw"].dtype == torch.int8
        assert lin["qscale"].shape == (3, 1, n) and lin["qscale"].dtype == torch.float32
    assert p["h"]["mlp"]["c_proj"]["qw"].shape == (3, I, D)
    assert p["lm_head"]["qw"].shape == (D, V) and p["lm_head"]["qscale"].shape == (1, V)
    qw = p["h"]["mlp"]["c_fc1"]["qw"]
    assert int(qw.min()) == -127 and int(qw.max()) == 127
    scale = p["lm_head"]["qscale"]
    assert float(scale.min()) >= 0.0002 and float(scale.max()) <= 0.0004
    assert scale.unique().numel() > V // 2, "the scale must vary per output column"
    again = random_int8_params(cfg, seed=3, device="cpu")
    assert torch.equal(again["lm_head"]["qw"], p["lm_head"]["qw"])
    other = random_int8_params(cfg, seed=4, device="cpu")
    assert not torch.equal(other["lm_head"]["qw"], p["lm_head"]["qw"])
    # the inference layout, and a forward through it
    up = tllama.unstack_layers(p)
    assert up["h"][0]["mlp"]["c_fc12"]["qw"].shape == (D, 2 * I)
    logits, _ = tllama.forward(up, torch.tensor([[1, 2, 3]]), cfg)
    assert logits.shape == (1, 3, V) and torch.isfinite(logits).all()


def test_params_from_numpy_carries_int8_tree():
    from lit_llama_tpu import LLaMAConfig as JConfig
    from lit_llama_tpu import init_params
    from lit_llama_tpu.models import llama as jllama

    jc = JConfig(block_size=32, vocab_size=64, n_layer=2, n_head=2, n_embd=64, quantize="int8")
    jp = jllama.unstack_layers(jllama.quantize_params(init_params(jc.replace(quantize=None), jax.random.PRNGKey(0)), jc))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    lin = tp["h"][1]["mlp"]["c_fc12"]
    assert lin["qw"].dtype == torch.int8 and lin["qscale"].dtype == torch.float32
    assert lin["qscale"].shape == (1, 2 * jc.intermediate_size)
    np.testing.assert_array_equal(lin["qw"].numpy(), np.asarray(jp["h"][1]["mlp"]["c_fc12"]["qw"]))


# N = 1040 is no multiple of the 128-column tile; K = 1000 no multiple of the
# 64-row k-step (nor of the 32-row step of the M = 1 body); K = 11008 is 7B's
# mlp.c_proj; (4096, 4096) splits K at M = 1
@pytest.mark.parametrize("M", [1, 8, 128, 200])
@pytest.mark.parametrize("K,N", [(1024, 1040), (1000, 1040), (11008, 1040), (4096, 4096)])
def test_matmul_int8_kernel_matches_plain(rng, cuda, M, K, N):
    q = {k: v.to(cuda) for k, v in _quantized(rng, K, N).items()}
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(cuda, torch.bfloat16)
    before = tqm.matmul_int8.launches
    got = tqm.matmul_int8(x, q["qw"], q["qscale"])
    want = tqm.matmul_int8_ref(x, q["qw"], q["qscale"])
    torch.cuda.synchronize()
    assert tqm.matmul_int8.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), **TOL["bfloat16"])


def test_matmul_int8_kernel_raises_on_what_it_does_not_take(rng, cuda):
    q = {k: v.to(cuda) for k, v in _quantized(rng, 256, 256).items()}
    x = torch.zeros((2, 256), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError):  # x not in the compute dtype
        tqm.matmul_int8(x.float(), q["qw"], q["qscale"], torch.bfloat16)
    with pytest.raises(ValueError):
        tqm.matmul_int8(x, q["qw"][:, :250].contiguous(), q["qscale"][:, :250].contiguous())
    with pytest.raises(ValueError):
        tqm.matmul_int8(x[:, :128].contiguous(), q["qw"], q["qscale"])
    assert tensor_from_numpy(np.zeros(3, np.int8), cuda).dtype == torch.int8


# f32 compute: the weight stream at M = 1 (split K at (4096, 4096)) and the
# FFMA tile at M > 1; the f32 sums differ in order only
@pytest.mark.parametrize("M", [1, 8, 200])
@pytest.mark.parametrize("K,N", [(1000, 1040), (4096, 4096)])
def test_matmul_int8_kernel_f32(rng, cuda, M, K, N):
    q = {k: v.to(cuda) for k, v in _quantized(rng, K, N).items()}
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(cuda)
    before = tqm.matmul_int8.launches
    got = tqm.matmul_int8(x, q["qw"], q["qscale"], torch.float32)
    want = tqm.matmul_int8_ref(x, q["qw"], q["qscale"], torch.float32)
    torch.cuda.synchronize()
    assert tqm.matmul_int8.launches == before + 1 and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


MS = [2, 7, 8, 9, 127, 128, 129, 200, 256, 257, 512]


# the Hopper mainloop (csrc/gemm_sm90.cuh) at every token tile it picks and
# across token tiles (M > 256), at 7B widths and an odd one (K = 1000: the
# last k-step is short; N = 1040: the last 128-column tile has 16 columns)
@pytest.mark.parametrize("K,N", [(4096, 12288), (11008, 4096), (1000, 1040)])
def test_matmul_int8_kernel_every_token_tile(rng, cuda, K, N):
    q = {k: v.to(cuda) for k, v in _quantized(rng, K, N).items()}
    x = torch.from_numpy(rng.normal(size=(max(MS), K)).astype(np.float32)).to(cuda, torch.bfloat16)
    for M in MS:
        xm = x[:M].contiguous()
        before = tqm.matmul_int8.launches
        got = tqm.matmul_int8(xm, q["qw"], q["qscale"])
        want = tqm.matmul_int8_ref(xm, q["qw"], q["qscale"])
        torch.cuda.synchronize()
        assert tqm.matmul_int8.launches == before + 1
        torch.testing.assert_close(got.float(), want.float(), **TOL["bfloat16"], msg=f"M={M}")


# a row's output is the same bits at any M > 1 (the K split comes from N and
# K alone) and on a rerun
@pytest.mark.parametrize("K,N", [(4096, 4096), (11008, 4096), (1000, 1040)])
def test_matmul_int8_kernel_rows_equal_across_m(rng, cuda, K, N):
    q = {k: v.to(cuda) for k, v in _quantized(rng, K, N).items()}
    x = torch.from_numpy(rng.normal(size=(512, K)).astype(np.float32)).to(cuda, torch.bfloat16)
    full = tqm.matmul_int8(x, q["qw"], q["qscale"])
    assert torch.equal(full, tqm.matmul_int8(x, q["qw"], q["qscale"]))
    for M in (8, 200):
        assert torch.equal(full[:M], tqm.matmul_int8(x[:M].contiguous(), q["qw"], q["qscale"])), M
