"""Which inputs the port's kernels take, and where the card routes.

The card's route is a static predicate on shapes (``attention.flash_route``,
``decode_attention.decode_route``, ``quant_matmul.quant_route``) that mirrors
the shape conditions of the JAX package's gates (``_use_flash``,
``use_decode_attention``, ``_use_pallas``) without the TPU's measured speed
gates. Where it sends a shape to a kernel, the kernel's pure check (the part
of the wrapper's checks that does not need the card) takes it, in bf16 and
f32 compute. The serving kernels take any slot count up to the engine's cap,
a LoRA operand of any multiple of 8 columns in bf16 or f32, and f32 norm
weights; a model with an adapter runs its prefix term and takes no fused
path.

Everything here runs on the CPU: the checks look at dtypes, shapes and
layouts, not at the device."""

import jax
import numpy as np
import pytest
import torch

from lit_llama_tpu.ops import attention as jattention
from lit_llama_tpu.ops import decode_attention as jda
from lit_llama_tpu.ops import quant_matmul as jqm
from lit_llama_tpu_torch.models import llama as tllama
from lit_llama_tpu_torch.models.config import AdapterConfig, LLaMAConfig, LoRAConfig
from lit_llama_tpu_torch.ops import attention as tattention
from lit_llama_tpu_torch.ops import decode_attention as tda
from lit_llama_tpu_torch.ops import flash_attention as tfa
from lit_llama_tpu_torch.ops import fused_layer as tfl
from lit_llama_tpu_torch.ops import quant_matmul as tqm
from lit_llama_tpu_torch.ops.linear import quantize_int4, quantize_int8

DTYPES = [torch.bfloat16, torch.float32]
HEAD_SIZES = [64, 96, 128, 256]


@pytest.fixture
def jax_on_tpu(monkeypatch):
    """The JAX gates ask their backend first; answer "tpu" so that their shape
    conditions decide."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jqm, "_pallas_enabled", lambda: True)
    monkeypatch.delenv("LIT_LLAMA_TPU_NO_PALLAS", raising=False)


# ---------------------------------------------------------------------------
# The route against the JAX gates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hs", HEAD_SIZES)
def test_flash_route_is_jax_shape_gate(jax_on_tpu, hs):
    """Where JAX's speed gates hold (T >= 128, T % 128 == 0) the route equals
    ``_use_flash``; at every T it is JAX's shape condition, hs % 128 == 0,
    for causal self-attention over T > 1 positions."""
    for T in (128, 256):
        q = jax.ShapeDtypeStruct((1, 2, T, hs), np.float32)
        for causal in (True, False):
            assert tattention.flash_route(T, T, hs, causal) == jattention._use_flash(q, q, causal)
    for T in (1, 2, 65, 200, 2048):
        assert tattention.flash_route(T, T, hs, True) == (hs % 128 == 0 and T > 1)
        assert not tattention.flash_route(T, T + 1, hs, True)


@pytest.mark.parametrize("hs", HEAD_SIZES)
def test_decode_route_is_jax_shape_gate(jax_on_tpu, hs):
    """At B == 1, S >= 1024, S % 128 == 0 (JAX's speed gates) the route equals
    ``use_decode_attention``."""
    q = jax.ShapeDtypeStruct((1, 2, 1, hs), np.float32)
    assert tda.decode_route(hs) == jda.use_decode_attention(q, q, 2048) == (hs % 128 == 0)


@pytest.mark.parametrize("K,N", [(256, 256), (512, 768), (4096, 11008), (384, 1152), (1024, 384),
                                 (1000, 256), (256, 1040)])
def test_quant_route_is_jax_shape_gate(jax_on_tpu, K, N):
    """At M <= 128 (JAX's speed gate) the route equals ``_use_pallas``, int4
    (packed) and int8 alike."""
    for M in (1, 8, 128):
        x = jax.ShapeDtypeStruct((M, K), np.float32)
        assert tqm.quant_route(K, N) == jqm._use_pallas(x, jax.ShapeDtypeStruct((K // 2, N), np.uint8), packed=True)
        assert tqm.quant_route(K, N) == jqm._use_pallas(x, jax.ShapeDtypeStruct((K, N), np.int8))


# ---------------------------------------------------------------------------
# The kernels' checks take what the route sends them
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_checks_take_what_the_route_sends(dtype):
    """K4/K10 and K5 take every head size the route sends them, 384 and 512
    among them, in bf16 and f32; a head size that is no multiple of 128,
    which the route never sends, is refused."""
    for hs in HEAD_SIZES + [384, 512]:
        for T in (2, 65, 200):
            if not tattention.flash_route(T, T, hs, True):
                continue
            t = torch.zeros(2, 3, T, hs, dtype=dtype)
            tfa.check_flash("K4", t, t, t)
            tfa.check_flash("K10", t, t, t, t, t)
        if not tda.decode_route(hs):
            continue
        B, H, S = 3, 2, 100
        q = torch.zeros(B, H, 1, hs, dtype=dtype)
        lim = torch.zeros(B, dtype=torch.int32)
        tda.check_decode(q, torch.zeros(B, H, S, hs, dtype=dtype), torch.zeros(B, H, S, hs, dtype=dtype),
                         None, None, lim)
        i8, sc = torch.zeros(B, H, S, hs, dtype=torch.int8), torch.zeros(B, H, S, 1)
        tda.check_decode(q, i8, i8, sc, sc, lim)
    for hs in (64, 96, 192, 320):
        assert not tattention.flash_route(8, 8, hs, True) and not tda.decode_route(hs)
        t = torch.zeros(1, 2, 8, hs, dtype=dtype)
        with pytest.raises(ValueError, match="head size"):
            tfa.check_flash("K4", t, t, t)
        with pytest.raises(ValueError, match="head size"):
            tda.check_decode(torch.zeros(1, 2, 1, hs, dtype=dtype), t, t, None, None, torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError):  # q and the cache disagree
        tfa.check_flash("K4", torch.zeros(1, 1, 4, 128), torch.zeros(1, 1, 4, 128, dtype=torch.bfloat16),
                        torch.zeros(1, 1, 4, 128))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("gs", [16, 32, 64, 128, -1])
def test_quant_checks_take_what_the_route_sends(dtype, gs):
    """K3 takes every group size (gs 16 and 32 split a 64-row k-step, -1 is one
    group for all of K) and K6 every width the route sends it, in bf16 and
    f32; at widths the route refuses the plain version runs."""
    for K, N in ((256, 256), (512, 768), (1024, 512), (384, 256), (256, 1040)):
        if not tqm.quant_route(K, N):
            continue
        w4 = quantize_int4(torch.randn(K, N) * 0.02, gs)
        w8 = quantize_int8(torch.randn(K, N) * 0.02)
        for M in (1, 8, 200):
            x = torch.zeros(M, K, dtype=dtype)
            assert tqm.check_int4(x, w4["qw"], w4["qscale"], w4["qzero"], dtype) == (K, N, K if gs == -1 else gs)
            assert tqm.check_int8(x, w8["qw"], w8["qscale"], dtype) == (K, N)


def test_linear_routes_refused_widths_to_the_plain_version():
    """An int4 or int8 linear whose widths are not multiples of 256 takes the
    plain version on any device; the route is decided before any launch."""
    from lit_llama_tpu_torch.ops.linear import linear

    x = torch.randn(3, 384)
    for params in (quantize_int4(torch.randn(384, 256) * 0.02, 64), quantize_int8(torch.randn(384, 256) * 0.02)):
        before = tqm.matmul_int4.launches, tqm.matmul_int8.launches
        plain = (tqm.matmul_int4_ref(x, params["qw"], params["qscale"], params["qzero"], torch.float32)
                 if "qzero" in params else tqm.matmul_int8_ref(x, params["qw"], params["qscale"], torch.float32))
        torch.testing.assert_close(linear(params, x), plain, rtol=0, atol=0)
        assert (tqm.matmul_int4.launches, tqm.matmul_int8.launches) == before


# ---------------------------------------------------------------------------
# The fused kernels: slots, LoRA operand, norm weights, compute dtype
# ---------------------------------------------------------------------------


def _prepared(lora=None, n_layer=1):
    cfg = LLaMAConfig(block_size=256, vocab_size=128, n_layer=n_layer, n_head=4, n_embd=512, quantize="int4",
                      quant_groupsize=128, lora=lora)
    dense = tllama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return tfl.prepare_fused_params(tllama.unstack_layers(tllama.quantize_params(dense, cfg)), cfg)


@pytest.fixture(scope="module")
def fused():
    """One prepared int4 layer without and with a LoRA operand of r = 64 on q
    and v (R8 = 128), f32 weights and norms."""
    params, cfg = _prepared()
    lparams, lcfg = _prepared(LoRAConfig(r=64, alpha=16.0, dropout=0.0))
    assert lparams["h"][0]["attn"]["c_attn"]["lora_af"].shape == (512, 128)
    return params, cfg, lparams, lcfg


def test_use_serve_fused_takes_the_slot_count(fused):
    """The serving step takes K7-K9 up to SERVE_KERNEL_MAX_B = 4096 slots, as
    the JAX package's cap (its ``use_serve_fused(..., batch=)``)."""
    from lit_llama_tpu.ops import fused_layer as jfl

    params, cfg, _, _ = fused
    lp = params["h"][0]
    assert tfl.SERVE_KERNEL_MAX_B == jfl.SERVE_KERNEL_MAX_B == 4096
    assert tfl.use_serve_fused(cfg, lp) and tfl.use_serve_fused(cfg, lp, batch=128)
    assert tfl.use_serve_fused(cfg, lp, batch=4096)
    assert not tfl.use_serve_fused(cfg, lp, batch=4097)


def _rows(B, D, dtype):
    return torch.zeros(B, D, dtype=dtype)


@pytest.mark.parametrize("B", [1, 64, 65, 96, 128, 4096])
def test_serving_checks_take_every_slot_count(fused, B):
    """K7 and K9 take any slot count the engine gives them (K7-K9 took 1 to 64
    before)."""
    params, cfg, _, _ = fused
    lp = params["h"][0]
    for dtype in DTYPES:
        x = _rows(B, 512, dtype)
        cs = torch.zeros(B, 128)
        tfl.check_block_head(x, lp["rms_1"], cs, cs, lp["attn"]["c_attn"], cfg)
        tfl.check_block_tail(x, x, lp["rms_2"], lp["attn"]["c_proj"], lp["mlp"]["c_fc12"], lp["mlp"]["c_proj"], cfg)


@pytest.mark.parametrize("operand", DTYPES)
def test_fused_checks_take_a_wide_lora_operand(fused, operand):
    """K1 and K7 take a LoRA operand of 128 columns (r = 64 on q and v), bf16
    or f32, as the Pallas kernels read any R8 in any dtype."""
    _, _, lparams, lcfg = fused
    lp = lparams["h"][0]
    ca = {**lp["attn"]["c_attn"], "lora_af": lp["attn"]["c_attn"]["lora_af"].to(operand),
          "lora_bf": lp["attn"]["c_attn"]["lora_bf"].to(operand)}
    lp = {**lp, "attn": {**lp["attn"], "c_attn": ca}}
    cs = torch.zeros(8, 128)
    tfl.check_block_head(_rows(8, 512, torch.bfloat16), lp["rms_1"], cs, cs, ca, lcfg)
    kv = {"k": torch.zeros(1, 4, 64, 128, dtype=torch.bfloat16), "v": torch.zeros(1, 4, 64, 128, dtype=torch.bfloat16)}
    tfl.check_decode_layers(_rows(1, 512, torch.bfloat16), [lp], [kv], torch.zeros(1, 128), torch.zeros(1, 128),
                            3, 3, lcfg)
    bad = {**ca, "lora_bf": ca["lora_bf"].to(torch.bfloat16 if operand == torch.float32 else torch.float32)}
    with pytest.raises(ValueError, match="one dtype"):
        tfl.check_block_head(_rows(8, 512, torch.bfloat16), lp["rms_1"], cs, cs, bad, lcfg)


@pytest.mark.parametrize("compute", DTYPES)
@pytest.mark.parametrize("norm", DTYPES)
def test_fused_checks_take_f32_norms_and_f32_compute(fused, compute, norm):
    """K1, K2, K7 and K9 take bf16 or f32 norm weights (applied in f32, as
    ``_rms_norm_rows``) in bf16 or f32 compute; the cache is in the compute
    dtype."""
    params, cfg, _, _ = fused
    lp = {**params["h"][0], "rms_1": params["h"][0]["rms_1"].to(norm), "rms_2": params["h"][0]["rms_2"].to(norm)}
    kv = {"k": torch.zeros(1, 4, 64, 128, dtype=compute), "v": torch.zeros(1, 4, 64, 128, dtype=compute)}
    tfl.check_decode_layers(_rows(1, 512, compute), [lp], [kv], torch.zeros(1, 128), torch.zeros(1, 128), 0, 0, cfg)
    tfl.check_lm_head(_rows(1, 512, compute), params["ln_f"].to(norm), params["lm_head"], cfg)
    cs = torch.zeros(4, 128)
    x = _rows(4, 512, compute)
    tfl.check_block_head(x, lp["rms_1"], cs, cs, lp["attn"]["c_attn"], cfg)
    tfl.check_block_tail(x, x, lp["rms_2"], lp["attn"]["c_proj"], lp["mlp"]["c_fc12"], lp["mlp"]["c_proj"], cfg)
    other = torch.float32 if compute == torch.bfloat16 else torch.bfloat16
    with pytest.raises(ValueError):  # the cache must be in the compute dtype
        tfl.check_decode_layers(_rows(1, 512, compute), [lp], [{n: c.to(other) for n, c in kv.items()}],
                                torch.zeros(1, 128), torch.zeros(1, 128), 0, 0, cfg)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_write_check_takes_f32(dtype):
    B, H, S, hs = 3, 4, 64, 128
    q = torch.zeros(B, H, 1, hs, dtype=dtype)
    c = torch.zeros(B, H, S, hs, dtype=dtype)
    assert tda.check_decode_write(q, q, q, c, c, torch.zeros(B, dtype=torch.int32)) == [H * hs] * 3


def test_engine_reports_the_fused_step(fused):
    from lit_llama_tpu_torch.serve import DecodeEngine

    params, cfg, _, _ = fused
    assert DecodeEngine(params, cfg, max_batch=65, max_seq_length=32, device="cpu").serve_fused
    assert not DecodeEngine(params, cfg, max_batch=4097, max_seq_length=2, device="cpu").serve_fused


# ---------------------------------------------------------------------------
# Adapters
# ---------------------------------------------------------------------------


def test_adapter_config_raises():
    """A model with ``config.adapter`` runs its prefix attention (it once
    raised, when the port had none): once ``gating`` is non-zero its logits
    are not the base model's, and the fused paths' predicates refuse it."""
    cfg = LLaMAConfig(block_size=16, vocab_size=64, n_layer=3, n_head=2, n_embd=32, adapter=AdapterConfig())
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.tensor([[1, 5, 9, 3]])
    base, _ = tllama.forward(params, toks, cfg.replace(adapter=None))
    zero_gate, _ = tllama.forward(params, toks, cfg)
    torch.testing.assert_close(zero_gate, base)  # gating starts at zero: the base model's logits
    g = torch.Generator().manual_seed(1)
    params["h"]["gating"].normal_(generator=g)  # as trained: gates and prompt away from their init
    params["h"]["adapter_wte"].normal_(generator=g)
    got, _ = tllama.forward(params, toks, cfg)
    assert float((got - base).abs().max()) > 1e-2 * float(base.abs().max())
    assert not tfl.use_serve_fused(cfg, {"attn": {"c_attn": {"qzero": None}}, "mlp": {"c_fc12": None}})
    assert not tfl.fused_layer_supported(cfg.replace(quantize="int4"), params)
