"""LoRA in the port: ``peft.lora``, the LoRA update inside ``forward``, the
folded operand of K1 and K7 (``fused_layer.prepare_lora_operands``), greedy
generation and the serving engine, each against the JAX package on the CPU
(its Pallas kernels in interpret mode); then K1 and K7 with the operand
against their plain versions on the card (skipped without one).

The tiny fused geometry of tests/test_fused_layer.py (n_embd 512, 4 heads of
128, 2 layers, int4 group size 128). LoRA B is drawn at random, never left
at its zero init: with B = 0 the update vanishes and every check would pass
without it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lit_llama_tpu import LLaMAConfig, init_params
from lit_llama_tpu.models import llama as jllama
from lit_llama_tpu.models.config import LoRAConfig
from lit_llama_tpu.models.generate import generate as jgenerate
from lit_llama_tpu.ops import fused_layer as jfl
from lit_llama_tpu.ops.rope import apply_rope_half
from lit_llama_tpu.ops.rope import build_rope_cache as j_rope_cache
from lit_llama_tpu.ops.rope import rope_half_row as j_rope_row
from lit_llama_tpu.peft import lora as jlora
from lit_llama_tpu.serve.engine import DecodeEngine as JaxEngine
from lit_llama_tpu_torch.models import config as tcfg
from lit_llama_tpu_torch.models import generate as tgen
from lit_llama_tpu_torch.models import llama as tllama
from lit_llama_tpu_torch.ops import fused_layer as tfl
from lit_llama_tpu_torch.ops.rope import build_rope_cache, rope_half_row, slot_rope_rows
from lit_llama_tpu_torch.peft import lora as tlora
from lit_llama_tpu_torch.serve import DecodeEngine
from lit_llama_tpu_torch.utils.jax_params import params_from_numpy

S = 128


def port_config(cfg):
    """The JAX config as the port's, LoRA included."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name not in ("lora", "adapter")}
    if cfg.lora is not None:
        kw["lora"] = tcfg.LoRAConfig(**dataclasses.asdict(cfg.lora))
    return tcfg.LLaMAConfig(**kw)


def to_port(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def _lora_dense(cfg, seed=0, b_seed=9):
    """Dense stacked JAX params with a LoRA overlay whose B is random."""
    dense = init_params(cfg.replace(quantize=None), jax.random.PRNGKey(seed))
    c_attn = dense["h"]["attn"]["c_attn"]
    c_attn["lora_b"] = (jax.random.normal(jax.random.PRNGKey(b_seed), c_attn["lora_b"].shape) * 0.1).astype(
        c_attn["lora_b"].dtype)
    return dense


@pytest.fixture(scope="module")
def lora_model():
    """(JAX config, JAX dense, JAX unprepared int4, JAX prepared, JAX
    prepared config) and the port's counterparts, carried across."""
    cfg = LLaMAConfig(block_size=256, vocab_size=128, n_layer=2, n_head=4, n_embd=512, quantize="int4",
                      quant_groupsize=128, lora=LoRAConfig(r=4, alpha=8.0, dropout=0.0))
    dense = _lora_dense(cfg)
    qparams = jllama.unstack_layers(jllama.quantize_params(dense, cfg))
    fparams, fcfg = jfl.prepare_fused_params(qparams, cfg)
    assert "lora_af" in fparams["h"][0]["attn"]["c_attn"]
    jax_side = dict(cfg=cfg, dense=dense, q=qparams, f=fparams, fcfg=fcfg)
    port = dict(cfg=port_config(cfg), dense=to_port(dense), q=to_port(qparams), f=to_port(fparams),
                fcfg=port_config(fcfg))
    return jax_side, port


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# peft.lora
# ---------------------------------------------------------------------------


def test_lora_delta_and_merge_match_jax(lora_model):
    """f32: the update of one layer and the merged weight of every layer,
    each to 1e-5 (the same f32 products in another order)."""
    j, t = lora_model
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 5, 512))).astype(np.float32)
    jc, tc_attn = j["dense"]["h"]["attn"]["c_attn"], t["dense"]["h"]["attn"]["c_attn"]
    want = jlora.lora_delta({"lora_a": jc["lora_a"][0], "lora_b": jc["lora_b"][0]}, jnp.asarray(x), j["cfg"].lora)
    got = tlora.lora_delta({"lora_a": tc_attn["lora_a"][0], "lora_b": tc_attn["lora_b"][0]}, torch.from_numpy(x),
                           t["cfg"].lora)
    assert got.shape == (2, 5, 3 * 512) and float(got.abs().max()) > 0.1
    assert float(got[..., 512:1024].abs().max()) == 0.0  # k is not enabled
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    jm, tm = jlora.merge_lora(j["dense"], j["cfg"]), tlora.merge_lora(t["dense"], t["cfg"])
    assert "lora_a" not in tm["h"]["attn"]["c_attn"] and "lora_a" in t["dense"]["h"]["attn"]["c_attn"]
    np.testing.assert_allclose(tm["h"]["attn"]["c_attn"]["w"].numpy(), np.asarray(jm["h"]["attn"]["c_attn"]["w"]),
                               rtol=1e-6, atol=1e-6)


def test_lora_zero_b_is_the_identity(lora_model):
    """B as initialised (zero): no update, the merge leaves the weight as it
    is, and the forward equals the model without the overlay, exactly."""
    _, t = lora_model
    cfg = t["cfg"].replace(quantize=None)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    c_attn = params["h"]["attn"]["c_attn"]
    assert float(c_attn["lora_b"].abs().max()) == 0.0 and float(c_attn["lora_a"].abs().max()) > 0
    assert float(c_attn["lora_a"].abs().max()) <= 512 ** -0.5  # kaiming-uniform bound 1/sqrt(D)
    x = torch.randn(1, 3, 512, generator=torch.Generator().manual_seed(2))
    layer0 = {"lora_a": c_attn["lora_a"][0], "lora_b": c_attn["lora_b"][0]}
    assert torch.equal(tlora.lora_delta(layer0, x, cfg.lora), torch.zeros(1, 3, 3 * 512))
    merged = tlora.merge_lora(params, cfg)
    assert torch.equal(merged["h"]["attn"]["c_attn"]["w"], c_attn["w"])
    toks = torch.tensor([[3, 17, 42, 99]])
    bare = {**params, "h": {**params["h"], "attn": {**params["h"]["attn"], "c_attn": {"w": c_attn["w"]}}}}
    assert torch.equal(tllama.forward(params, toks, cfg)[0], tllama.forward(bare, toks, cfg.replace(lora=None))[0])
    # the state filters: only the lora_* leaves are trainable and saved, and
    # an overlay lands on a base tree without changing it
    mask = tlora.trainable_mask(params)
    assert mask["h"]["attn"]["c_attn"] == {"w": False, "lora_a": True, "lora_b": True} and not mask["wte"]
    state = tlora.lora_state(params)
    again = tlora.load_lora_state(bare, state)
    assert set(again["h"]["attn"]["c_attn"]) == {"w", "lora_a", "lora_b"}
    assert set(bare["h"]["attn"]["c_attn"]) == {"w"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_lora_matches_jax(lora_model, dtype):
    """The LoRA update inside forward (no cache, then a cached prefill and one
    per-op decode step) on dense weights. f32 to 2e-4 as the model tests;
    bf16: both packages round the update and the product to bf16 at the same
    points, the logits (|v| < 3) to 3e-2, about two bf16 ulps."""
    j, t = lora_model
    jcfg = j["cfg"].replace(quantize=None, param_dtype=dtype, compute_dtype=dtype)
    tc = port_config(jcfg)
    jdense = jax.tree_util.tree_map(lambda a: a.astype(dtype), j["dense"])
    tdense = to_port(jdense)
    tol = dict(rtol=2e-4, atol=2e-4) if dtype == "float32" else dict(rtol=3e-2, atol=3e-2)
    toks = np.asarray([[3, 17, 42, 99, 7, 64]], np.int32)
    want, _ = jllama.forward(jdense, jnp.asarray(toks), jcfg)
    got, _ = tllama.forward(tdense, torch.from_numpy(toks).long(), tc)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    # the update is there: without it the logits move by far more than the tolerance
    bare = tllama.forward({**tdense, "h": {**tdense["h"], "attn": {**tdense["h"]["attn"], "c_attn": {
        "w": tdense["h"]["attn"]["c_attn"]["w"]}}}}, torch.from_numpy(toks).long(), tc.replace(lora=None))[0]
    assert float((bare.float() - got.float()).abs().max()) > 10 * tol["atol"]

    jcache = jllama.init_kv_cache(jcfg, 1, 16)
    tcache = tllama.init_kv_cache(tc, 1, 16, device="cpu")
    _, jcache = jllama.forward(jdense, jnp.asarray(toks), jcfg, input_pos=jnp.arange(6), kv_cache=jcache,
                               prefill_from_zero=True)
    tllama.forward(tdense, torch.from_numpy(toks).long(), tc, kv_cache=tcache, prefill_from_zero=True)
    step = np.asarray([[11]], np.int32)
    want, _ = jllama.forward(jdense, jnp.asarray(step), jcfg, input_pos=jnp.asarray([6]), kv_cache=jcache)
    got, _ = tllama.forward(tdense, torch.from_numpy(step).long(), tc, input_pos=[6], kv_cache=tcache)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# The folded operand and the plain K1 / K7 with it
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("r,enable", [(4, (True, False, True)), (3, (True, True, True))])
def test_prepare_lora_operands_matches_jax(r, enable):
    """lora_af, lora_bf and the permuted lora_b equal the JAX package's bit for
    bit, in f32 and bf16; r = 3 on all three groups pads 9 columns to 16."""
    for dtype in ("float32", "bfloat16"):
        lcfg = LoRAConfig(r=r, alpha=8.0, dropout=0.0, enable_q=enable[0], enable_k=enable[1], enable_v=enable[2])
        cfg = LLaMAConfig(block_size=64, vocab_size=128, n_layer=1, n_head=4, n_embd=512, quantize="int4",
                          quant_groupsize=128, param_dtype=dtype, compute_dtype=dtype, lora=lcfg)
        q = jllama.unstack_layers(jllama.quantize_params(_lora_dense(cfg, seed=r), cfg))
        want, _ = jfl.prepare_fused_params(q, cfg)
        got, gcfg = tfl.prepare_fused_params(to_port(q), port_config(cfg))
        assert gcfg.rope_layout == "half"
        jc, tc_attn = want["h"][0]["attn"]["c_attn"], got["h"][0]["attn"]["c_attn"]
        R8 = -(-sum(enable) * r // 8) * 8
        assert tuple(tc_attn["lora_af"].shape) == (512, R8) and tuple(tc_attn["lora_bf"].shape) == (R8, 3 * 512)
        for key in ("lora_af", "lora_bf", "lora_b", "lora_a"):
            np.testing.assert_array_equal(to_port({key: jc[key]})[key].float().numpy(), tc_attn[key].float().numpy())


def test_fused_layer_supported_and_serve_predicate(lora_model):
    j, t = lora_model
    assert tfl.fused_layer_supported(t["cfg"], t["q"])
    bare_layers = [{**lp, "attn": {**lp["attn"], "c_attn": {k: v for k, v in lp["attn"]["c_attn"].items()
                                                            if not k.startswith("lora")}}} for lp in t["q"]["h"]]
    assert not tfl.fused_layer_supported(t["cfg"], {**t["q"], "h": bare_layers})  # config.lora, no overlay loaded
    assert tfl.use_serve_fused(t["fcfg"], t["f"]["h"][0])
    assert not tfl.use_serve_fused(t["fcfg"], {**t["f"]["h"][0], "attn": {
        **t["f"]["h"][0]["attn"], "c_attn": {k: v for k, v in t["f"]["h"][0]["attn"]["c_attn"].items()
                                             if k not in ("lora_af", "lora_bf")}}})
    params, cfg = tfl.maybe_prepare_fused(t["q"], t["cfg"])
    assert cfg.rope_layout == "half" and "lora_af" in params["h"][1]["attn"]["c_attn"]
    assert tfl.maybe_prepare_fused(params, cfg)[0] is params  # already prepared


@pytest.mark.parametrize("pos", [0, 37, 200])
def test_decode_layer_lora_ref_matches_pallas(lora_model, pos):
    """The plain K1 with the LoRA operand against the interpret-mode Pallas
    kernel, f32 (the tolerances of tests/test_torch_fused_layer.py: caches
    1e-4, output 2e-3); pos 200 writes the ring at 72."""
    j, t = lora_model
    fparams, fcfg, tparams, tc = j["f"], j["fcfg"], t["f"], t["fcfg"]
    D, H, hs = 512, 4, 128
    rng = np.random.default_rng(pos + 11)
    k = (rng.normal(size=(1, H, S, hs)) * 0.3).astype(np.float32)
    v = (rng.normal(size=(1, H, S, hs)) * 0.3).astype(np.float32)
    x = (rng.normal(size=(1, D)) * 0.5).astype(np.float32)
    cosj, sinj = j_rope_row(j_rope_cache(fcfg.block_size, hs), jnp.int32(pos), hs)
    with pltpu.force_tpu_interpret_mode():
        jout, jkv = jfl.decode_layer_fused(jnp.asarray(x), fparams["h"][0], {"k": jnp.asarray(k), "v": jnp.asarray(v)},
                                           cosj, sinj, jnp.int32(pos % S), jnp.int32(pos), fcfg)
    cos, sin = rope_half_row(build_rope_cache(tc.block_size, hs), pos, hs)
    kv = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    out, _ = tfl.decode_layer_fused(torch.from_numpy(x), tparams["h"][0], kv, cos, sin, pos % S, pos, tc)
    np.testing.assert_allclose(kv["k"].numpy(), np.asarray(jkv["k"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(kv["v"].numpy(), np.asarray(jkv["v"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=2e-3, atol=2e-3)
    # the operand is live: without it the v row written (v has an update) moves
    # by far more than the cache tolerance
    ca = tparams["h"][0]["attn"]["c_attn"]
    bare = {**tparams["h"][0], "attn": {**tparams["h"][0]["attn"], "c_attn": {
        key: val for key, val in ca.items() if not key.startswith("lora")}}}
    bare_kv = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    tfl.decode_layer_fused(torch.from_numpy(x), bare, bare_kv, cos, sin, pos % S, pos, tc)
    assert float((bare_kv["v"] - kv["v"]).abs().max()) > 1e-2


@pytest.mark.parametrize("B", [1, 8, 32])
def test_block_head_lora_ref_matches_pallas(lora_model, B):
    """The plain K7 with the LoRA operand against the interpret-mode Pallas
    kernel, f32 to 1e-4. As in tests/test_torch_serve_kernels.py the Pallas
    q/k columns are taken with identity tables and rotated by the JAX
    package's apply_rope_half (interpret mode pairs the wrong lanes)."""
    j, t = lora_model
    jlp, cfg, tlp, tc = j["f"]["h"][0], j["fcfg"], t["f"]["h"][0], t["fcfg"]
    D, H, hs = 512, 4, 128
    rng = np.random.default_rng(B)
    x = (rng.normal(size=(B, D)) * 0.5).astype(np.float32)
    pos = rng.integers(0, 300, size=B).astype(np.int32)
    rope = jnp.take(j_rope_cache(cfg.block_size, hs), jnp.clip(pos, 0, cfg.block_size - 1), axis=0)
    cos3, sin3 = jllama._slot_rope_tables(rope[:, None], cfg)
    run = lambda c3, s3: np.asarray(jfl.block_head_fused(
        jnp.asarray(x), jlp["rms_1"], c3, s3, jlp["attn"]["c_attn"], B=B, D=D, gs=128, cdtype="float32",
        interpret=True), np.float32)
    rotated, raw = run(cos3, sin3), run(jnp.ones_like(cos3), jnp.zeros_like(sin3))
    qk = apply_rope_half(jnp.asarray(raw[:, : 2 * D]).reshape(B, 1, 2 * H, hs), rope[:, None])
    want = np.concatenate([np.asarray(qk).reshape(B, 2 * D), rotated[:, 2 * D :]], axis=-1)
    cos, sin = slot_rope_rows(build_rope_cache(tc.block_size, hs), torch.from_numpy(pos))
    got = tfl.block_head_fused(torch.from_numpy(x), tlp["rms_1"], cos, sin, tlp["attn"]["c_attn"], tc)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def wide_lora_model():
    """One prepared layer with r = 64 on q and v: a 128-column operand (R8 =
    128, past the 64 the kernels took before), f32 as stored."""
    cfg = LLaMAConfig(block_size=256, vocab_size=128, n_layer=1, n_head=4, n_embd=512, quantize="int4",
                      quant_groupsize=128, lora=LoRAConfig(r=64, alpha=16.0, dropout=0.0))
    fparams, fcfg = jfl.prepare_fused_params(jllama.unstack_layers(jllama.quantize_params(_lora_dense(cfg), cfg)),
                                             cfg)
    assert fparams["h"][0]["attn"]["c_attn"]["lora_af"].shape == (512, 128)
    return fparams["h"][0], fcfg, to_port(fparams)["h"][0], port_config(fcfg)


def _operand_as(lp, dtype, jax_side):
    """The layer with its LoRA operand stored in ``dtype`` (both packages read
    it as f32)."""
    ca = dict(lp["attn"]["c_attn"])
    for key in ("lora_af", "lora_bf"):
        ca[key] = ca[key].astype(dtype) if jax_side else ca[key].to(getattr(torch, dtype))
    return {**lp, "attn": {**lp["attn"], "c_attn": ca}}


@pytest.mark.parametrize("operand", ["float32", "bfloat16"])
def test_decode_layer_wide_lora_ref_matches_pallas(wide_lora_model, operand):
    """The plain K1 with a 128-column operand, f32 or bf16, against the
    interpret-mode Pallas kernel (f32 compute, the tolerances above); the
    port's check takes the operand as K1 on the card takes it."""
    jlp, fcfg, tlp, tc = wide_lora_model
    jlp, tlp = _operand_as(jlp, operand, True), _operand_as(tlp, operand, False)
    D, H, hs, pos = 512, 4, 128, 37
    rng = np.random.default_rng(23)
    k = (rng.normal(size=(1, H, S, hs)) * 0.3).astype(np.float32)
    v = (rng.normal(size=(1, H, S, hs)) * 0.3).astype(np.float32)
    x = (rng.normal(size=(1, D)) * 0.5).astype(np.float32)
    cosj, sinj = j_rope_row(j_rope_cache(fcfg.block_size, hs), jnp.int32(pos), hs)
    with pltpu.force_tpu_interpret_mode():
        jout, jkv = jfl.decode_layer_fused(jnp.asarray(x), jlp, {"k": jnp.asarray(k), "v": jnp.asarray(v)},
                                           cosj, sinj, jnp.int32(pos), jnp.int32(pos), fcfg)
    cos, sin = rope_half_row(build_rope_cache(tc.block_size, hs), pos, hs)
    kv = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    out, _ = tfl.decode_layer_fused(torch.from_numpy(x), tlp, kv, cos, sin, pos, pos, tc)
    np.testing.assert_allclose(kv["v"].numpy(), np.asarray(jkv["v"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(kv["k"].numpy(), np.asarray(jkv["k"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=2e-3, atol=2e-3)
    tfl.check_decode_layers(torch.from_numpy(x), tfl.add_decode_layout({"h": [tlp], "lm_head": {}})["h"], [kv],
                            cos, sin, pos, pos, tc)


@pytest.mark.parametrize("operand", ["float32", "bfloat16"])
def test_block_head_wide_lora_ref_matches_pallas(wide_lora_model, operand):
    """The plain K7 with a 128-column operand, f32 or bf16, against the
    interpret-mode Pallas kernel at 8 slots, f32 to 1e-4 (q/k columns as in
    test_block_head_lora_ref_matches_pallas)."""
    jlp, cfg, tlp, tc = wide_lora_model
    jlp, tlp = _operand_as(jlp, operand, True), _operand_as(tlp, operand, False)
    B, D, H, hs = 8, 512, 4, 128
    rng = np.random.default_rng(29)
    x = (rng.normal(size=(B, D)) * 0.5).astype(np.float32)
    pos = rng.integers(0, 300, size=B).astype(np.int32)
    rope = jnp.take(j_rope_cache(cfg.block_size, hs), jnp.clip(pos, 0, cfg.block_size - 1), axis=0)
    cos3, sin3 = jllama._slot_rope_tables(rope[:, None], cfg)
    run = lambda c3, s3: np.asarray(jfl.block_head_fused(
        jnp.asarray(x), jlp["rms_1"], c3, s3, jlp["attn"]["c_attn"], B=B, D=D, gs=128, cdtype="float32",
        interpret=True), np.float32)
    rotated, raw = run(cos3, sin3), run(jnp.ones_like(cos3), jnp.zeros_like(sin3))
    qk = apply_rope_half(jnp.asarray(raw[:, : 2 * D]).reshape(B, 1, 2 * H, hs), rope[:, None])
    want = np.concatenate([np.asarray(qk).reshape(B, 2 * D), rotated[:, 2 * D :]], axis=-1)
    cos, sin = slot_rope_rows(build_rope_cache(tc.block_size, hs), torch.from_numpy(pos))
    got = tfl.block_head_fused(torch.from_numpy(x), tlp["rms_1"], cos, sin, tlp["attn"]["c_attn"], tc)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    tfl.check_block_head(torch.from_numpy(x), tlp["rms_1"], cos, sin,
                         tfl.add_decode_layout({"h": [tlp], "lm_head": {}})["h"][0]["attn"]["c_attn"], tc)


# ---------------------------------------------------------------------------
# Generation and serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", ["fused", "per_op"])
def test_generate_lora_matches_jax(lora_model, path):
    """Greedy tokens identical to JAX generate on the same overlaid int4
    weights: through the fused step (K1 and K2 with the LoRA operand; JAX in
    interpret mode) and per op (the update inside forward), 18 tokens into a
    cache of 16, so the last ones are past S."""
    j, t = lora_model
    jp, jc, tp, tc = (j["f"], j["fcfg"], t["f"], t["fcfg"]) if path == "fused" else (j["q"], j["cfg"], t["q"], t["cfg"])
    prompt = np.asarray([5, 23, 81, 2, 40], np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = jgenerate(jp, prompt, 13, config=jc, max_seq_length=16, temperature=0.0)
    got = tgen.generate(tp, prompt, 13, config=tc, max_seq_length=16, temperature=0.0, device="cpu")
    assert len(got) == 18 and got.tolist() == np.asarray(want).tolist()


def test_engine_lora_matches_jax_engine(lora_model, monkeypatch):
    """The port's engine with LoRA (K7 with the operand, K8, K9 per block;
    handed the prepared params, and the unprepared ones it prepares itself)
    gives the JAX engine's greedy tokens (its batched kernels in interpret
    mode)."""
    j, t = lora_model
    monkeypatch.setattr(jfl, "use_serve_fused", lambda config, lp, batch=None: config.rope_layout == "half"
                        and "qzero" in lp["attn"]["c_attn"] and "c_fc12" in lp["mlp"])
    rng = np.random.default_rng(23)
    prompts = [rng.integers(1, 128, size=n).astype(np.int32) for n in (5, 9)]
    with pltpu.force_tpu_interpret_mode():
        eng = JaxEngine(j["f"], j["fcfg"], max_batch=2, max_seq_length=64)
        ids = [eng.submit(p, 5) for p in prompts]
        done = eng.run()
    want = [done[i].generated for i in ids]
    for params, cfg in ((t["f"], t["fcfg"]), (t["q"], t["cfg"])):
        eng = DecodeEngine(params, cfg, max_batch=2, max_seq_length=64, device="cpu")
        assert eng.config.rope_layout == "half" and "lora_af" in eng.params["h"][0]["attn"]["c_attn"]
        ids = [eng.submit(p, 5) for p in prompts]
        done = eng.run()
        assert [done[i].generated for i in ids] == want


# ---------------------------------------------------------------------------
# On the card: K1 and K7 with the LoRA operand against their plain versions
# ---------------------------------------------------------------------------


def _card_lora_layers(n_embd, n_head, n_layer, device, seed=3, r=8, operand="bfloat16"):
    """Prepared int4 layers with a LoRA operand on the card: dense init (std
    0.02 / sqrt(2 L), as the other K1 card tests) quantized at load, the
    overlay's A at its init and B drawn, bf16 norms and compute; the operand
    (R8 = 2 r columns for r on q and v) in ``operand``."""
    cfg = tcfg.LLaMAConfig(block_size=512, vocab_size=1000, n_layer=n_layer, n_head=n_head, n_embd=n_embd,
                           quantize="int4", quant_groupsize=128, param_dtype=operand, compute_dtype="bfloat16",
                           lora=tcfg.LoRAConfig(r=r, alpha=16.0, dropout=0.0))
    from lit_llama_tpu_torch.utils.random_params import random_lora_overlay

    dense = tllama.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    dense["h"]["attn"]["c_attn"]["lora_b"] = random_lora_overlay(cfg, seed=seed + 1, device="cpu")["h"]["attn"][
        "c_attn"]["lora_b"]
    params, tc = tfl.prepare_fused_params(tllama.unstack_layers(tllama.quantize_params(dense, cfg)), cfg)
    layers = [_to(lp, device) for lp in params["h"]]
    for lp in layers:
        lp["rms_1"], lp["rms_2"] = lp["rms_1"].to(torch.bfloat16), lp["rms_2"].to(torch.bfloat16)
        assert lp["attn"]["c_attn"]["lora_af"].dtype == getattr(torch, operand)
    return layers, tc.replace(param_dtype="bfloat16")


def _to(tree, device):
    return {k: _to(v, device) for k, v in tree.items()} if isinstance(tree, dict) else tree.to(device)


def _without_operand(lp):
    ca = {k: v for k, v in lp["attn"]["c_attn"].items() if not k.startswith("lora")}
    return {**lp, "attn": {**lp["attn"], "c_attn": ca}}


@pytest.mark.parametrize("n_embd,n_head", [(512, 4), (1792, 14)])
def test_k1_lora_kernel_matches_plain(cuda, n_embd, n_head):
    """K1 with the operand on the card against its plain version (bf16, the
    tolerances of the K1 card tests), two blocks in one entry, positions in
    the first chunk and past S. The update moves the v row written (v has
    one) by more than ten times the cache tolerance, so a kernel that left it
    out would fail."""
    layers, tc = _card_lora_layers(n_embd, n_head, 2, cuda)
    rng = np.random.default_rng(5)
    Sg, H, hs = 256, n_head, 128
    rope = build_rope_cache(tc.block_size, hs, device=cuda)
    bf = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda, torch.bfloat16)
    for pos in (5, 300):
        kvs = [{"k": bf(1, H, Sg, hs), "v": bf(1, H, Sg, hs)} for _ in layers]
        ref_kvs = [{n: c.clone() for n, c in kv.items()} for kv in kvs]
        x = bf(1, n_embd)
        cos, sin = rope_half_row(rope, pos, hs)
        before = tfl.k1_lora.launches
        out, _ = tfl.decode_layers_fused(x, layers, kvs, cos, sin, pos % Sg, pos, tc)
        ref, _ = tfl.decode_layers_fused_ref(x, layers, ref_kvs, cos, sin, pos % Sg, pos, tc)
        torch.cuda.synchronize()
        assert tfl.k1_lora.launches == before + len(layers)
        for j, (kv, rkv) in enumerate(zip(kvs, ref_kvs)):
            for name in ("k", "v"):
                torch.testing.assert_close(kv[name].float(), rkv[name].float(), rtol=1e-2, atol=1e-2,
                                           msg=lambda m, j=j, name=name: f"block {j} {name} cache: {m}")
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
        bare_kvs = [{n: c.clone() for n, c in kv.items()} for kv in kvs]
        tfl.decode_layers_fused_ref(x, [_without_operand(lp) for lp in layers], bare_kvs, cos, sin, pos % Sg, pos, tc)
        row = pos % Sg
        assert float((bare_kvs[0]["v"][0, :, row] - ref_kvs[0]["v"][0, :, row]).float().abs().max()) > 0.1


@pytest.mark.parametrize("n_embd,n_head", [(512, 4), (1792, 14)])
@pytest.mark.parametrize("B", [1, 8, 32, 64])
def test_k7_lora_kernel_matches_plain(cuda, n_embd, n_head, B):
    """K7 with the operand on the card against its plain version (bf16, 2e-2
    as the K7 card tests); the update moves the output by more than ten
    times the tolerance."""
    layers, tc = _card_lora_layers(n_embd, n_head, 1, cuda)
    lp = layers[0]
    rng = np.random.default_rng(B)
    x = torch.from_numpy(rng.normal(size=(B, n_embd)).astype(np.float32)).to(cuda, torch.bfloat16)
    pos = torch.from_numpy(rng.integers(0, 600, size=B).astype(np.int32)).to(cuda)
    cos, sin = slot_rope_rows(build_rope_cache(tc.block_size, 128, device=cuda), pos)
    args = (x, lp["rms_1"], cos, sin, lp["attn"]["c_attn"], tc)
    before = tfl.k7_lora.launches, tfl.block_head_fused.launches
    got = tfl.block_head_fused(*args)
    want = tfl.block_head_fused_ref(*args)
    torch.cuda.synchronize()
    assert (tfl.k7_lora.launches, tfl.block_head_fused.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    bare = tfl.block_head_fused_ref(x, lp["rms_1"], cos, sin, _without_operand(lp)["attn"]["c_attn"], tc)
    assert float((bare.float() - want.float()).abs().max()) > 0.2


@pytest.mark.parametrize("operand", ["bfloat16", "float32"])
@pytest.mark.parametrize("B", [8, 65])
def test_wide_lora_kernels_match_plain(cuda, operand, B):
    """K1 and K7 on the card with a 128-column operand (r = 64 on q and v),
    bf16 or f32, against their plain versions (the tolerances of the tests
    above); K7 past 64 slots as well. The update moves the outputs by more
    than ten times the tolerance, so a kernel that left columns out fails."""
    layers, tc = _card_lora_layers(512, 4, 1, cuda, r=64, operand=operand)
    lp = layers[0]
    assert lp["attn"]["c_attn"]["lora_af"].shape == (512, 128)
    rng = np.random.default_rng(B)
    bf = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda, torch.bfloat16)
    x = bf(B, 512)
    pos = torch.from_numpy(rng.integers(0, 600, size=B).astype(np.int32)).to(cuda)
    cos, sin = slot_rope_rows(build_rope_cache(tc.block_size, 128, device=cuda), pos)
    args = (x, lp["rms_1"], cos, sin, lp["attn"]["c_attn"], tc)
    before = tfl.k7_lora.launches, tfl.k1_lora.launches
    got, want = tfl.block_head_fused(*args), tfl.block_head_fused_ref(*args)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    bare = tfl.block_head_fused_ref(x, lp["rms_1"], cos, sin, _without_operand(lp)["attn"]["c_attn"], tc)
    assert float((bare.float() - want.float()).abs().max()) > 0.2
    Sg, p = 256, 300
    kv = {"k": bf(1, 4, Sg, 128), "v": bf(1, 4, Sg, 128)}
    rkv = {n: c.clone() for n, c in kv.items()}
    c1, s1 = rope_half_row(build_rope_cache(tc.block_size, 128, device=cuda), p, 128)
    out, _ = tfl.decode_layers_fused(x[:1], [lp], [kv], c1, s1, p % Sg, p, tc)
    ref, _ = tfl.decode_layers_fused_ref(x[:1], [lp], [rkv], c1, s1, p % Sg, p, tc)
    torch.cuda.synchronize()
    assert (tfl.k7_lora.launches, tfl.k1_lora.launches) == (before[0] + 1, before[1] + 1)
    for name in ("k", "v"):
        torch.testing.assert_close(kv[name].float(), rkv[name].float(), rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
