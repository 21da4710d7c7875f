"""K10, the causal flash-attention backward, and the autograd Function around
K4 + K10: the port's plain backward against the JAX package's Pallas backward
on the CPU (interpret mode, f32 and bf16; directly and through ``jax.grad``),
the Function against torch autograd of ``attention_ref``, and the CUDA kernels
against the plain version on the card (skipped without one)."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lit_llama_tpu.ops import flash_attention as jflash
from lit_llama_tpu_torch.ops import attention as tattn
from lit_llama_tpu_torch.ops import flash_attention as tflash

# f32: both sides sum the same f32 products in another order
TOL_F32 = dict(rtol=1e-4, atol=1e-4)
# bf16: both round P and dS to bf16 at the same places, but the f32 scores
# they round from differ in the last bits, so a rounded P or dS may differ by
# one bf16 ulp, and the outputs are rounded to bf16 (|grad| <= ~4 here)
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)
# card, kernel vs plain in bf16, chip_smoke.py's TOL_K10, held row by row (a
# query's dq, a key's dk or dv): |err| <= row * rowmax + rel * |plain|, rowmax
# the row's largest |plain| and at least floor * the output's largest. rel
# covers an ulp or two of each value (the reasons of TOL_BF16); the absolute
# part follows each row's own size, since a late row sums ~T/64 tiles and one
# tile left out moves it by ~1/sqrt(T/64) of its size; the floor is for the
# first query's dq, which is 0 up to f32 rounding
TOL_CARD = dict(row=1e-2, rel=2e-2, floor=1e-3)
# card, the Function against autograd of attention_ref, chip_smoke.py's
# TOL_FUNCTION: that reference rounds elsewhere, and the flash backward's D
# comes from the bf16 O, so a row whose softmax is nearly one-hot (dq near 0)
# is all rounding; floor 1 holds every row to the output's largest value
TOL_CARD_FUNCTION = dict(row=1e-2, rel=2e-2, floor=1.0)
# card, model grads kernel vs plain, chip_smoke.py's TOL_TRAIN_GRAD: per leaf,
# max |dgrad| / max |grad| and RMS(dgrad) / RMS(grad)
TOL_CARD_GRAD = dict(max=2e-2, rms=2e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(seed, B, H, T, hs=128, n=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, H, T, hs)).astype(np.float32) for _ in range(n)]


def _to_torch(arrays, dtype=torch.float32, device="cpu"):
    return [torch.from_numpy(a.copy()).to(device, dtype) for a in arrays]


def _jax_backward(q, k, v, do, dtype=jnp.float32):
    """The Pallas forward and backward in interpret mode, at the blocks the
    JAX package picks (T = 384 is three 128-row blocks)."""
    q, k, v, do = (jnp.asarray(a, dtype) for a in (q, k, v, do))
    with pltpu.force_tpu_interpret_mode():
        o, lse = jflash._flash_forward(q, k, v, jflash.DEFAULT_BLOCK_Q, jflash.DEFAULT_BLOCK_K)
        dq, dk, dv = jflash._flash_backward(q, k, v, o, lse, do, jflash.DEFAULT_BLOCK_Q, jflash.DEFAULT_BLOCK_K)
    return o, lse, (dq, dk, dv)


def _np32(a):
    return np.array(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("T", [128, 384])
def test_bwd_ref_matches_pallas_f32(T):
    q, k, v, do = _inputs(T, 1, 2, T)
    o, lse, want = _jax_backward(q, k, v, do)
    tq, tk, tv, tdo = _to_torch([q, k, v, do])
    got = tflash.flash_attention_bwd_ref(tq, tk, tv, torch.from_numpy(_np32(o)), torch.from_numpy(_np32(lse)), tdo)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np32(w), **TOL_F32)


@pytest.mark.parametrize("T", [128, 384])
def test_bwd_ref_matches_pallas_bf16(T):
    q, k, v, do = _inputs(T + 1, 1, 2, T)
    o, lse, want = _jax_backward(q, k, v, do, jnp.bfloat16)
    tq, tk, tv, tdo = _to_torch([q, k, v, do], torch.bfloat16)
    to = torch.from_numpy(np.asarray(o).view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    assert np.asarray(o).dtype == ml_dtypes.bfloat16
    got = tflash.flash_attention_bwd_ref(tq, tk, tv, to, torch.from_numpy(_np32(lse)), tdo)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), _np32(w), **TOL_BF16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_ref_matches_pallas_head_size_384(dtype):
    """Head size 384, which the JAX gate sends to the Pallas pair: the plain
    backward holds, at the tolerances of head size 128."""
    q, k, v, do = _inputs(7, 1, 2, 128, hs=384)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    o, lse, want = _jax_backward(q, k, v, do, jdt)
    tq, tk, tv, tdo = _to_torch([q, k, v, do], tdt)
    to = torch.from_numpy(_np32(o)).to(tdt)  # bf16 values are exact in f32 and back
    got = tflash.flash_attention_bwd_ref(tq, tk, tv, to, torch.from_numpy(_np32(lse)), tdo)
    for g, w in zip(got, want):
        assert g.dtype == tdt
        np.testing.assert_allclose(g.float().numpy(), _np32(w), **(TOL_F32 if dtype == "float32" else TOL_BF16))


@pytest.mark.parametrize("T", [128, 384])
def test_function_grads_match_jax_grad(T):
    """jax.grad through the custom_vjp of flash_attention (Pallas forward and
    backward in interpret mode) against loss.backward() through the port's
    Function, as tests/test_pallas_kernels.py holds the JAX pair to XLA."""
    q, k, v = _inputs(T + 2, 1, 1, T, n=3)

    def f_flash(q, k, v):
        return (jflash.flash_attention(q, k, v, True, True) ** 2).sum()

    want = jax.grad(f_flash, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    xs = [t.requires_grad_() for t in _to_torch([q, k, v])]
    (tflash.FlashAttention.apply(*xs, False) ** 2).sum().backward()
    for x, w in zip(xs, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), **TOL_F32)


@pytest.mark.parametrize("B,H,T", [(1, 2, 64), (2, 3, 37), (1, 1, 130)])
def test_function_matches_autograd_of_attention_ref(B, H, T):
    """The Function's structure on the CPU: its plain forward and backward
    against torch autograd of the plain attention, ragged T included; also
    through ``attention`` (the model's dispatch)."""
    q, k, v, do = _to_torch(_inputs(B * 100 + T, B, H, T))
    mask = torch.ones(T, T, dtype=torch.bool).tril()
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    tattn.attention_ref(*ref, mask).backward(do)
    for fn in (lambda *a: tflash.FlashAttention.apply(*a, False),
               lambda *a: tattn.attention(*a, mask, causal=True)):
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        o = fn(*xs)
        assert o.grad_fn is not None
        o.backward(do)
        for x, r in zip(xs, ref):
            np.testing.assert_allclose(x.grad.numpy(), r.grad.numpy(), rtol=1e-5, atol=1e-5)


def test_backward_on_cpu_launches_nothing():
    q, k, v, do = _to_torch(_inputs(5, 1, 2, 64))
    before = (tflash.flash_backward_dq.launches, tflash.flash_backward_dkv.launches)
    o, lse = tflash.flash_attention(q, k, v)
    got = tflash.flash_attention_backward(q, k, v, o, lse, do)
    want = tflash.flash_attention_bwd_ref(q, k, v, o, lse, do)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (tflash.flash_backward_dq.launches, tflash.flash_backward_dkv.launches) == before


def _card_err(got, want, tol=TOL_CARD):
    """(max |err|, the row part needed: the largest (|err| - rel * |want|) /
    rowmax, which tol["row"] bounds)."""
    got, want = got.float(), want.float()
    err, mag = (got - want).abs(), want.abs()
    rowmax = mag.amax(-1, keepdim=True).clamp_min(tol["floor"] * float(mag.max()))
    return float(err.max()), float(((err - tol["rel"] * mag).clamp_min(0) / rowmax).max())


@pytest.mark.parametrize("B,H,T", [(1, 4, 64), (1, 2, 65), (2, 4, 200), (1, 8, 1024), (1, 32, 2048)])
def test_k10_kernel_matches_plain(cuda, B, H, T):
    q, k, v, do = _to_torch(_inputs(T, B, H, T), torch.bfloat16, cuda)
    o, lse = tflash.flash_attention(q, k, v)
    before = (tflash.flash_backward_dq.launches, tflash.flash_backward_dkv.launches)
    got = tflash.flash_attention_backward(q, k, v, o, lse, do)
    want = tflash.flash_attention_bwd_ref(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert (tflash.flash_backward_dq.launches, tflash.flash_backward_dkv.launches) == (before[0] + 1, before[1] + 1)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g).all()
        err, need = _card_err(g, w)
        print(f"K10 {name} at {(B, H, T)}: max err {err:.3g}, row part needed {need:.3g}")
        assert need <= TOL_CARD["row"], (f"{name}: row part {need:.3g} needed, max err {err:.3g}, "
                                         f"max |plain| {float(w.float().abs().max()):.3g}")
    # no atomics: a second run gives the same bits
    again = tflash.flash_attention_backward(q, k, v, o, lse, do)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


def test_k10_kernel_function_matches_autograd_of_attention_ref(cuda):
    """K4 + K10 through the Function against autograd of the plain attention
    on the card, in bf16, at the pretraining shape."""
    B, H, T = 1, 32, 2048
    q, k, v, do = _to_torch(_inputs(3, B, H, T), torch.bfloat16, cuda)
    mask = torch.ones(T, T, dtype=torch.bool, device=cuda).tril()
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    tattn.attention_ref(*ref, mask).backward(do)
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    tattn.attention(*xs, mask, causal=True).backward(do)
    for name, x, r in zip("qkv", xs, ref):
        err, need = _card_err(x.grad, r.grad, TOL_CARD_FUNCTION)
        print(f"Function grad of {name} at {(B, H, T)}: max err {err:.3g}, part of max |grad| needed {need:.3g}")
        assert need <= TOL_CARD_FUNCTION["row"], f"{name}: {need:.3g} of max |grad| needed, max err {err:.3g}"


def test_k10_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v, do = _to_torch(_inputs(4, 1, 2, 64), torch.bfloat16, cuda)
    o, lse = tflash.flash_attention(q, k, v)
    with pytest.raises(ValueError):  # head size 64
        tflash.flash_attention_backward(*(t[..., :64].contiguous() for t in (q, k, v, o)), lse, do[..., :64].contiguous())
    with pytest.raises(ValueError):  # q in another dtype than the rest
        tflash.flash_attention_backward(q.float(), k, v, o, lse, do)
    with pytest.raises(ValueError):  # not contiguous
        tflash.flash_attention_backward(q, k, v, o, lse, do.transpose(-1, -2).contiguous().transpose(-1, -2))


def test_k10_kernel_model_grads_match_plain(cuda):
    """The repair of the detached K4 output: after one backward through a
    2-layer model on the card every leaf has a finite grad, c_attn included,
    and the K4 + K10 grads match the plain path's by TOL_CARD_GRAD. The model
    is chip_smoke.py's phase 14: the 7B width, B = 1, T = 2048."""
    from lit_llama_tpu_torch import LLaMAConfig
    from lit_llama_tpu_torch.models import llama
    from lit_llama_tpu_torch.training import step as tstep

    cfg = LLaMAConfig.from_name("7B", n_layer=2, param_dtype="float32", compute_dtype="bfloat16")
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = llama.init_params(cfg, gen, device=cuda)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, cfg.block_size + 1))).to(cuda)
    grads = {}
    for plain in (False, True):
        leaves = tstep.tree_leaves(params)
        for t in leaves.values():
            t.requires_grad_(True)
            t.grad = None
        loss = tstep.loss_fn(params, toks[:, :-1], toks[:, 1:], cfg, remat=True, plain=plain)
        loss.backward()
        grads[plain] = {n: t.grad.clone() for n, t in leaves.items() if t.grad is not None}
        assert set(grads[plain]) == set(leaves), f"leaves without a grad: {set(leaves) - set(grads[plain])}"
    readings = {}
    for name, g in grads[False].items():
        want = grads[True][name]
        assert torch.isfinite(g).all(), name
        scale = float(want.abs().max())
        assert scale > 0, name
        readings[name] = (float((g - want).abs().max()) / scale, float((g - want).norm() / want.norm()))
    print("grads, max |dgrad| / max |grad| and RMS(dgrad) / RMS(grad): "
          + ", ".join(f"{n} {a:.3g} / {b:.3g}" for n, (a, b) in readings.items()))
    for name, (by_max, by_rms) in readings.items():
        assert by_max <= TOL_CARD_GRAD["max"] and by_rms <= TOL_CARD_GRAD["rms"], (name, readings)


# f32 compute and head size 256: the FFMA bodies of K4 and K10 against their
# plain versions, row by row as above (bf16), or to 1e-4 of the output's
# largest value (f32: the sums differ in order only)
@pytest.mark.parametrize("dtype,hs", [("float32", 128), ("bfloat16", 256), ("float32", 256)])
@pytest.mark.parametrize("B,H,T", [(1, 2, 65), (2, 3, 200)])
def test_k10_kernel_f32_and_head_size_256(cuda, dtype, hs, B, H, T):
    cd = getattr(torch, dtype)
    g = torch.Generator().manual_seed(T)
    q, k, v, do = (torch.randn(B, H, T, hs, generator=g).to(cuda, cd) for _ in range(4))
    o, lse = tflash.flash_attention(q, k, v)
    before = (tflash.flash_backward_dq.launches, tflash.flash_backward_dkv.launches)
    got = tflash.flash_attention_backward(q, k, v, o, lse, do)
    want = tflash.flash_attention_bwd_ref(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert (tflash.flash_backward_dq.launches, tflash.flash_backward_dkv.launches) == (before[0] + 1, before[1] + 1)
    for name, gt, w in zip(("dq", "dk", "dv"), got, want):
        assert gt.dtype == cd and torch.isfinite(gt).all()
        if dtype == "float32":
            err = float((gt - w).abs().max())
            assert err <= 1e-4 * max(1.0, float(w.abs().max())), f"{name}: max err {err:.3g}"
        else:
            err, need = _card_err(gt, w)
            assert need <= TOL_CARD["row"], f"{name}: row part {need:.3g} needed, max err {err:.3g}"
    again = tflash.flash_attention_backward(q, k, v, o, lse, do)
    for gt, a in zip(got, again):
        assert torch.equal(gt, a)


# past head size 256: the chunked kernels (128 output columns a block, the
# scores and dP summed a 128-column chunk at a time), held as above
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("hs", [384, 512])
@pytest.mark.parametrize("B,H,T", [(1, 2, 65), (2, 3, 200)])
def test_k10_kernel_head_sizes_past_256(cuda, dtype, hs, B, H, T):
    test_k10_kernel_f32_and_head_size_256(cuda, dtype, hs, B, H, T)
