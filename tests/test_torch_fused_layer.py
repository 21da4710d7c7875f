"""K1 (decode_layers_fused) and K2 (lm_head_fused): the port's plain versions
against the JAX Pallas kernels in interpret mode on the CPU, and the CUDA
kernels against the plain versions on the card (skipped without one).

The tiny fused geometry of tests/test_fused_layer.py: n_embd 512, 4 heads of
128, 2 layers, group size 128."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lit_llama_tpu import LLaMAConfig, init_params
from lit_llama_tpu.models import llama as jllama
from lit_llama_tpu.ops import fused_layer as jfl
from lit_llama_tpu.ops.rope import build_rope_cache as j_rope_cache
from lit_llama_tpu.ops.rope import rope_half_row as j_rope_row
from lit_llama_tpu_torch.models import config as tcfg
from lit_llama_tpu_torch.ops import fused_layer as tfl
from lit_llama_tpu_torch.ops.rope import build_rope_cache, rope_half_row
from lit_llama_tpu_torch.utils.jax_params import params_from_numpy

S = 128


def _port_config(cfg):
    return tcfg.LLaMAConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                               if f.name not in ("lora", "adapter")})


@pytest.fixture(scope="module")
def prepared():
    cfg = LLaMAConfig(block_size=256, vocab_size=128, n_layer=2, n_head=4, n_embd=512,
                      quantize="int4", quant_groupsize=128)
    dense = init_params(cfg.replace(quantize=None), jax.random.PRNGKey(0))
    qparams = jllama.unstack_layers(jllama.quantize_params(dense, cfg))
    fparams, fcfg = jfl.prepare_fused_params(qparams, cfg)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, fparams), device="cpu")
    return fparams, fcfg, tparams, _port_config(fcfg)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(rng, cfg, S=S):
    D, H, hs = cfg.n_embd, cfg.n_head, cfg.head_size
    k = (rng.normal(size=(1, H, S, hs)) * 0.3).astype(np.float32)
    v = (rng.normal(size=(1, H, S, hs)) * 0.3).astype(np.float32)
    x = (rng.normal(size=(1, D)) * 0.5).astype(np.float32)
    return x, k, v


def test_prepare_fused_params_matches_jax(prepared):
    fparams, fcfg, tparams, tc = prepared
    cfg = _port_config(fcfg).replace(rope_layout="interleaved")
    raw = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jllama.unstack_layers(jllama.quantize_params(
            init_params(fcfg.replace(quantize=None, rope_layout="interleaved"),
                        jax.random.PRNGKey(0)), fcfg))), device="cpu")
    ours, ocfg = tfl.prepare_fused_params(raw, cfg)
    assert ocfg.rope_layout == "half" and tfl.fused_layer_supported(cfg, raw)
    for key in ("qw", "qscale", "qzero"):
        assert torch.equal(ours["h"][1]["attn"]["c_attn"][key], tparams["h"][1]["attn"]["c_attn"][key])
    np.testing.assert_array_equal(tfl.half_basis_perm(8).numpy(), np.asarray(jfl.half_basis_perm(8)))


@pytest.mark.parametrize("pos", [0, 37, 127, 259])
def test_decode_layer_ref_matches_pallas_f32(prepared, pos):
    fparams, fcfg, tparams, tc = prepared
    rng = np.random.default_rng(pos + 1)
    x, k, v = _inputs(rng, fcfg)
    hs = fcfg.head_size
    cosj, sinj = j_rope_row(j_rope_cache(fcfg.block_size, hs), jnp.int32(min(pos, 255)), hs)
    with pltpu.force_tpu_interpret_mode():
        jout, jkv = jfl.decode_layer_fused(
            jnp.asarray(x), fparams["h"][0], {"k": jnp.asarray(k), "v": jnp.asarray(v)},
            cosj, sinj, jnp.int32(pos % S), jnp.int32(pos), fcfg,
        )
    cost, sint = rope_half_row(build_rope_cache(tc.block_size, hs), min(pos, 255), hs)
    kv = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    tout, tkv = tfl.decode_layer_fused(
        torch.from_numpy(x), tparams["h"][0], kv, cost, sint, pos % S, pos, tc
    )
    assert tkv is kv  # written in place
    np.testing.assert_allclose(tkv["k"].numpy(), np.asarray(jkv["k"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tkv["v"].numpy(), np.asarray(jkv["v"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=2e-3, atol=2e-3)


def test_decode_layers_ref_matches_pallas_bf16_packed(prepared):
    """bf16 compute against the JAX packed u32 cache, compared through
    unpack_kv; two blocks in one entry (f32 residual between them). Both
    sides round at the same points, so the bound is one bf16 ulp of the
    values (|x| < 4: 2e-2) plus the f32 summation order."""
    fparams, fcfg, tparams, tc = prepared
    bcfg, tbcfg = fcfg.replace(compute_dtype="bfloat16"), tc.replace(compute_dtype="bfloat16")
    rng = np.random.default_rng(7)
    x, k, v = _inputs(rng, fcfg)
    pos, hs = 41, fcfg.head_size
    kb, vb = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    cosj, sinj = j_rope_row(j_rope_cache(fcfg.block_size, hs), jnp.int32(pos), hs)
    with pltpu.force_tpu_interpret_mode():
        jout, jkvs = jfl.decode_layers_fused(
            jnp.asarray(x, jnp.bfloat16), fparams["h"], [
                {"k": jfl.pack_kv(kb), "v": jfl.pack_kv(vb)},
                {"k": jfl.pack_kv(vb), "v": jfl.pack_kv(kb)},
            ], cosj, sinj, jnp.int32(pos), jnp.int32(pos), bcfg,
        )
    tk = torch.from_numpy(np.array(kb.astype(jnp.float32))).to(torch.bfloat16)
    tv = torch.from_numpy(np.array(vb.astype(jnp.float32))).to(torch.bfloat16)
    kvs = [{"k": tk.clone(), "v": tv.clone()}, {"k": tv.clone(), "v": tk.clone()}]
    cost, sint = rope_half_row(build_rope_cache(tc.block_size, hs), pos, hs)
    tout, tkvs = tfl.decode_layers_fused(
        torch.from_numpy(x).to(torch.bfloat16), tparams["h"], kvs, cost, sint, pos, pos, tbcfg
    )
    assert tout.dtype == torch.bfloat16
    for j in range(2):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                tkvs[j][name].float().numpy(),
                np.asarray(jfl.unpack_kv(jkvs[j][name]).astype(jnp.float32)), rtol=1e-2, atol=1e-2,
            )
    np.testing.assert_allclose(
        tout.float().numpy(), np.asarray(jout.astype(jnp.float32)), rtol=2e-2, atol=2e-2
    )


def test_decode_layer_ref_matches_pallas_odd_half_groups():
    """n_embd 768: 3 groups per nibble plane in c_attn, attn.c_proj, c_fc12
    and the lm_head (odd, like 7B's mlp.c_proj with 43)."""
    cfg = LLaMAConfig(block_size=64, vocab_size=128, n_layer=1, n_head=6, n_embd=768,
                      quantize="int4", quant_groupsize=128)
    dense = init_params(cfg.replace(quantize=None), jax.random.PRNGKey(2))
    fparams, fcfg = jfl.prepare_fused_params(jllama.unstack_layers(jllama.quantize_params(dense, cfg)), cfg)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, fparams), device="cpu")
    tc = _port_config(fcfg)
    Sg, pos, hs = 32, 40, fcfg.head_size  # pos past the cache: the write wraps to slot 8
    x, k, v = _inputs(np.random.default_rng(5), fcfg, Sg)
    cosj, sinj = j_rope_row(j_rope_cache(fcfg.block_size, hs), jnp.int32(pos), hs)
    with pltpu.force_tpu_interpret_mode():
        jout, jkv = jfl.decode_layer_fused(
            jnp.asarray(x), fparams["h"][0], {"k": jnp.asarray(k), "v": jnp.asarray(v)},
            cosj, sinj, jnp.int32(pos % Sg), jnp.int32(pos), fcfg,
        )
        jlog = jfl.lm_head_fused(jout, fparams["ln_f"], fparams["lm_head"], fcfg)
    cost, sint = rope_half_row(build_rope_cache(tc.block_size, hs), pos, hs)
    kv = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    tout, tkv = tfl.decode_layer_fused(torch.from_numpy(x), tparams["h"][0], kv, cost, sint, pos % Sg, pos, tc)
    np.testing.assert_allclose(tkv["k"].numpy(), np.asarray(jkv["k"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tkv["v"].numpy(), np.asarray(jkv["v"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=2e-3, atol=2e-3)
    tlog = tfl.lm_head_fused(tout, tparams["ln_f"], tparams["lm_head"], tc)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=2e-3, atol=2e-3)


def test_decode_layers_and_head_ref_f32_norm_weights_match_pallas_bf16(prepared):
    """bf16 compute with f32 norm weights that are not ones (as a trained f32
    checkpoint holds them): both packages apply the weight in f32 before the
    row is rounded (``_rms_norm_rows``), so K1's and K2's plain versions
    agree with the interpret-mode Pallas kernels to the bf16 bound of the
    test above. K1 and K2 on the card take these weights as they are."""
    fparams, fcfg, tparams, tc = prepared
    bcfg, tbcfg = fcfg.replace(compute_dtype="bfloat16"), tc.replace(compute_dtype="bfloat16")
    rng = np.random.default_rng(17)
    norms = [{n: (1.0 + 0.3 * rng.normal(size=(fcfg.n_embd,))).astype(np.float32) for n in ("rms_1", "rms_2")}
             for _ in range(2)]
    ln_f = (1.0 + 0.3 * rng.normal(size=(fcfg.n_embd,))).astype(np.float32)
    jlayers = [{**lp, **{n: jnp.asarray(w) for n, w in nw.items()}} for lp, nw in zip(fparams["h"], norms)]
    tlayers = [{**lp, **{n: torch.from_numpy(w) for n, w in nw.items()}} for lp, nw in zip(tparams["h"], norms)]
    x, k, v = _inputs(rng, fcfg)
    pos, hs = 70, fcfg.head_size
    kb, vb = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    cosj, sinj = j_rope_row(j_rope_cache(fcfg.block_size, hs), jnp.int32(pos), hs)
    with pltpu.force_tpu_interpret_mode():
        jout, jkvs = jfl.decode_layers_fused(
            jnp.asarray(x, jnp.bfloat16), jlayers, [{"k": jfl.pack_kv(kb), "v": jfl.pack_kv(vb)}] * 2,
            cosj, sinj, jnp.int32(pos), jnp.int32(pos), bcfg)
        jlog = jfl.lm_head_fused(jout, jnp.asarray(ln_f), fparams["lm_head"], bcfg)
    tk = torch.from_numpy(np.array(kb.astype(jnp.float32))).to(torch.bfloat16)
    tv = torch.from_numpy(np.array(vb.astype(jnp.float32))).to(torch.bfloat16)
    kvs = [{"k": tk.clone(), "v": tv.clone()} for _ in range(2)]
    cost, sint = rope_half_row(build_rope_cache(tc.block_size, hs), pos, hs)
    tout, tkvs = tfl.decode_layers_fused(torch.from_numpy(x).to(torch.bfloat16), tlayers, kvs, cost, sint, pos,
                                         pos, tbcfg)
    for j in range(2):
        for name in ("k", "v"):
            np.testing.assert_allclose(tkvs[j][name].float().numpy(),
                                       np.asarray(jfl.unpack_kv(jkvs[j][name]).astype(jnp.float32)),
                                       rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(tout.float().numpy(), np.asarray(jout.astype(jnp.float32)), rtol=2e-2, atol=2e-2)
    tlog = tfl.lm_head_fused(tout, torch.from_numpy(ln_f), tparams["lm_head"], tbcfg)
    assert tlog.dtype == torch.bfloat16
    np.testing.assert_allclose(tlog.float().numpy(), np.asarray(jlog.astype(jnp.float32)), rtol=2e-2, atol=2e-2)
    decode = tfl.add_decode_layout({**tparams, "h": tlayers})  # the layout the kernels read
    tfl.check_decode_layers(tout, decode["h"], kvs, cost, sint, pos, pos, tbcfg)
    tfl.check_lm_head(tout, torch.from_numpy(ln_f), decode["lm_head"], tbcfg)


def test_lm_head_ref_matches_pallas(prepared):
    fparams, fcfg, tparams, tc = prepared
    x = (np.random.default_rng(3).normal(size=(1, fcfg.n_embd))).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jfl.lm_head_fused(jnp.asarray(x), fparams["ln_f"], fparams["lm_head"], fcfg)
    got = tfl.lm_head_fused(torch.from_numpy(x), tparams["ln_f"], tparams["lm_head"], tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("pos", [0, 37, 130, 259])
def test_decode_layers_kernel_matches_plain(prepared, cuda, pos):
    """K1 on the card against its plain version at bf16, S = 256 (two
    attention chunks), both blocks in one entry."""
    _, fcfg, tparams, tc = prepared
    tc = tc.replace(compute_dtype="bfloat16")
    params = {**tparams, "h": [
        {**lp, "rms_1": lp["rms_1"].to(torch.bfloat16), "rms_2": lp["rms_2"].to(torch.bfloat16)}
        for lp in tparams["h"]]}
    params = _to(tfl.add_decode_layout(params), cuda)
    rng = np.random.default_rng(pos)
    Sg = 256
    H, hs = tc.n_head, tc.head_size
    mk = lambda: torch.from_numpy(rng.normal(size=(1, H, Sg, hs)).astype(np.float32)).to(cuda, torch.bfloat16)
    kvs = [{"k": mk(), "v": mk()} for _ in range(2)]
    ref_kvs = [{n: c.clone() for n, c in kv.items()} for kv in kvs]
    x = torch.from_numpy(rng.normal(size=(1, tc.n_embd)).astype(np.float32)).to(cuda, torch.bfloat16)
    cos, sin = rope_half_row(build_rope_cache(tc.block_size, hs, device=cuda), min(pos, 255), hs)
    before = tfl.decode_layers_fused.launches
    out, _ = tfl.decode_layers_fused(x, params["h"], kvs, cos, sin, pos % Sg, pos, tc)
    ref, _ = tfl.decode_layers_fused_ref(x, params["h"], ref_kvs, cos, sin, pos % Sg, pos, tc)
    torch.cuda.synchronize()
    assert tfl.decode_layers_fused.launches == before + 1
    for kv, rkv in zip(kvs, ref_kvs):
        torch.testing.assert_close(kv["k"].float(), rkv["k"].float(), rtol=1e-2, atol=1e-2)
        torch.testing.assert_close(kv["v"].float(), rkv["v"].float(), rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)


def test_lm_head_kernel_matches_plain(prepared, cuda):
    _, fcfg, tparams, tc = prepared
    params = _to(tfl.add_decode_layout(tparams), cuda)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(1, tc.n_embd)).astype(np.float32))
    x = x.to(cuda, torch.bfloat16)
    ln = params["ln_f"].to(torch.bfloat16)
    before = tfl.lm_head_fused.launches
    got = tfl.lm_head_fused(x, ln, params["lm_head"], tc)
    want = tfl.lm_head_fused_ref(x, ln, params["lm_head"], tc)
    torch.cuda.synchronize()
    assert tfl.lm_head_fused.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


def test_decode_layers_kernel_odd_half_groups(cuda):
    """K1 and K2 on the card against their plain versions where every int4
    linear has an odd group count per nibble plane: 14 heads of 128 give
    n_embd 1792 (7 per plane) and I = 4864 (19), as 7B's mlp.c_proj has 43.
    Quantized weights, so scales and zeros differ in every group and column."""
    from lit_llama_tpu_torch.models import llama as tllama

    cfg = tcfg.LLaMAConfig(block_size=512, vocab_size=1000, n_layer=2, n_head=14, n_embd=1792,
                           quantize="int4", quant_groupsize=128)
    assert (cfg.n_embd // 256) % 2 == 1 and (cfg.intermediate_size // 256) % 2 == 1
    dense = tllama.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    params, tc = tfl.prepare_fused_params(tllama.unstack_layers(tllama.quantize_params(dense, cfg)), cfg)
    tc = tc.replace(compute_dtype="bfloat16")
    bf = lambda t: t.to(cuda, torch.bfloat16)
    params = _to(params, cuda)
    params["h"] = [{**lp, "rms_1": bf(lp["rms_1"]), "rms_2": bf(lp["rms_2"])} for lp in params["h"]]
    rng = np.random.default_rng(11)
    Sg, H, hs = 256, tc.n_head, tc.head_size
    rope = build_rope_cache(tc.block_size, hs, device=cuda)
    for pos in (5, 300):  # 300 wraps to slot 44
        mk = lambda: bf(torch.from_numpy(rng.normal(size=(1, H, Sg, hs)).astype(np.float32)))
        kvs = [{"k": mk(), "v": mk()} for _ in range(2)]
        ref_kvs = [{n: c.clone() for n, c in kv.items()} for kv in kvs]
        x = bf(torch.from_numpy(rng.normal(size=(1, tc.n_embd)).astype(np.float32)))
        cos, sin = rope_half_row(rope, pos, hs)
        out, _ = tfl.decode_layers_fused(x, params["h"], kvs, cos, sin, pos % Sg, pos, tc)
        ref, _ = tfl.decode_layers_fused_ref(x, params["h"], ref_kvs, cos, sin, pos % Sg, pos, tc)
        for kv, rkv in zip(kvs, ref_kvs):
            torch.testing.assert_close(kv["k"].float(), rkv["k"].float(), rtol=1e-2, atol=1e-2)
            torch.testing.assert_close(kv["v"].float(), rkv["v"].float(), rtol=1e-2, atol=1e-2)
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
        ln = bf(params["ln_f"])
        got = tfl.lm_head_fused(out, ln, params["lm_head"], tc)
        want = tfl.lm_head_fused_ref(out, ln, params["lm_head"], tc)
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.parametrize("compute,norm", [("bfloat16", "float32"), ("float32", "float32"), ("float32", "bfloat16")])
@pytest.mark.parametrize("pos", [37, 259])
def test_decode_layers_kernel_f32_compute_and_norms(prepared, cuda, compute, norm, pos):
    """K1 and K2 on the card against their plain versions in f32 compute (f32
    row, cache and logits) and with f32 norm weights, S = 256. In f32 the
    kernel and its plain version differ only in the order of f32 sums: 1e-4.
    Random norm weights, so a weight read as the other dtype would fail."""
    _, fcfg, tparams, tc = prepared
    cd, nd = getattr(torch, compute), getattr(torch, norm)
    tc = tc.replace(compute_dtype=compute)
    g = torch.Generator().manual_seed(pos)
    rnd = lambda: (1.0 + 0.3 * torch.randn(tc.n_embd, generator=g)).to(cuda, nd)
    params = _to(tfl.add_decode_layout(tparams), cuda)
    params["h"] = [{**lp, "rms_1": rnd(), "rms_2": rnd()} for lp in params["h"]]
    rng = np.random.default_rng(pos)
    Sg, H, hs = 256, tc.n_head, tc.head_size
    mk = lambda: torch.from_numpy(rng.normal(size=(1, H, Sg, hs)).astype(np.float32)).to(cuda, cd)
    kvs = [{"k": mk(), "v": mk()} for _ in range(2)]
    ref_kvs = [{n: c.clone() for n, c in kv.items()} for kv in kvs]
    x = torch.from_numpy(rng.normal(size=(1, tc.n_embd)).astype(np.float32)).to(cuda, cd)
    cos, sin = rope_half_row(build_rope_cache(tc.block_size, hs, device=cuda), min(pos, 255), hs)
    tol = dict(rtol=1e-4, atol=1e-4) if compute == "float32" else dict(rtol=2e-2, atol=2e-2)
    before = tfl.decode_layers_fused.launches, tfl.lm_head_fused.launches
    out, _ = tfl.decode_layers_fused(x, params["h"], kvs, cos, sin, pos % Sg, pos, tc)
    ref, _ = tfl.decode_layers_fused_ref(x, params["h"], ref_kvs, cos, sin, pos % Sg, pos, tc)
    ln = rnd()
    logits = tfl.lm_head_fused(out, ln, params["lm_head"], tc)
    want = tfl.lm_head_fused_ref(out, ln, params["lm_head"], tc)
    torch.cuda.synchronize()
    assert (tfl.decode_layers_fused.launches, tfl.lm_head_fused.launches) == (before[0] + 1, before[1] + 1)
    assert out.dtype == cd and logits.dtype == cd
    for kv, rkv in zip(kvs, ref_kvs):
        torch.testing.assert_close(kv["k"].float(), rkv["k"].float(), **tol)
        torch.testing.assert_close(kv["v"].float(), rkv["v"].float(), **tol)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    torch.testing.assert_close(logits.float(), want.float(), **tol)


@pytest.mark.parametrize("pos", [255, 256, 2047, 2300])
def test_decode_layers_kernel_at_split_boundaries(prepared, cuda, pos):
    """K1 in bf16 (the tensor-core matvec and the split attention) against its
    plain version at S = 2048: positions on both sides of a split boundary
    (256 rows a split), the last row, and past S (the ring wrapped). Its
    arrival counters are zeros after the call."""
    from lit_llama_tpu_torch.ops import decode_attention as tda

    _, fcfg, tparams, tc = prepared
    tc = tc.replace(compute_dtype="bfloat16", block_size=4096)
    params = {**tparams, "h": [
        {**lp, "rms_1": lp["rms_1"].to(torch.bfloat16), "rms_2": lp["rms_2"].to(torch.bfloat16)}
        for lp in tparams["h"]]}
    params = _to(tfl.add_decode_layout(params), cuda)
    rng = np.random.default_rng(pos)
    Sg, H, hs = 2048, tc.n_head, tc.head_size
    assert tda.decode_plan(Sg, hs).split_rows == 256
    mk = lambda: torch.from_numpy((rng.normal(size=(1, H, Sg, hs)) * 0.3).astype(np.float32)).to(cuda, torch.bfloat16)
    kvs = [{"k": mk(), "v": mk()} for _ in range(2)]
    ref_kvs = [{n: c.clone() for n, c in kv.items()} for kv in kvs]
    x = torch.from_numpy(rng.normal(size=(1, tc.n_embd)).astype(np.float32)).to(cuda, torch.bfloat16)
    cos, sin = rope_half_row(build_rope_cache(tc.block_size, hs, device=cuda), pos, hs)
    out, _ = tfl.decode_layers_fused(x, params["h"], kvs, cos, sin, pos % Sg, pos, tc)
    ref, _ = tfl.decode_layers_fused_ref(x, params["h"], ref_kvs, cos, sin, pos % Sg, pos, tc)
    torch.cuda.synchronize()
    for kv, rkv in zip(kvs, ref_kvs):
        torch.testing.assert_close(kv["k"].float(), rkv["k"].float(), rtol=1e-2, atol=1e-2)
        torch.testing.assert_close(kv["v"].float(), rkv["v"].float(), rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
    assert int(tda.arrival_counters(H, cuda).abs().sum()) == 0
