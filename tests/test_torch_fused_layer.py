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
from tests.test_torch_decode_plan import split_bf16x3

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


# ---- the f32 matvec's arithmetic (csrc/gemv_sm90.cuh, F32), emulated in numpy


def _butterfly(parts: np.ndarray) -> np.ndarray:
    """Lane 0's value after an xor butterfly over the last axis (its length
    a power of 2), as the kernel's shuffles add, in f32."""
    n = parts.shape[-1]
    o = n // 2
    while o:
        parts = parts + parts[..., np.arange(n) ^ o]
        o //= 2
    return parts[..., 0]


def emulate_f32_matvec(h: np.ndarray, w, gs: int, terms: int = 3) -> np.ndarray:
    """The f32 matvec of K1 and K2 on one row h (K,) f32, in the kernel's
    order, from the decode layout (qw_t (N, K/2), qscale_t / qzero_t (N, G)):
    each warp w of four takes the 64-byte steps w, w + 4, ...; a step's four
    mma per nibble half add 16 exact products each into the f32 sums of the
    hi, mid and lo columns (an mma rounds once: its products are exact and
    the tensor cores add them before the one rounding, taken here as exact);
    lane t = 0 adds (hi + mid) times the step's group scale into its sum and
    lane t = 1 lo times the scale into its own; the warp's sum is the two
    added once at the end; the four warps and the zero-point term (f32 group
    sums of h over 64-element chunks, eight partial sums a column) add in warp
    order. ``terms`` < 3 drops the split's last terms (hi alone is the bf16
    body's input)."""
    f32 = np.float32
    wt, st, zt = (w[k].numpy() for k in ("qw_t", "qscale_t", "qzero_t"))
    N, Kh = wt.shape
    K, G = 2 * Kh, st.shape[1]
    Gh, nsteps = G // 2, Kh // 64
    parts = [t.astype(np.float64) for t in split_bf16x3(h.astype(f32))[:terms]]
    parts += [np.zeros(K)] * (3 - terms)
    lo_n, hi_n = (wt & 0xF).astype(np.float64), (wt >> 4).astype(np.float64)
    red = []
    for warp in range(4):
        acc0 = np.zeros(N, f32)  # lane t = 0: hi + mid
        acc1 = np.zeros(N, f32)  # lane t = 1: lo
        for s in range(warp, nsteps, 4):
            g = s * 64 // gs
            col = {}
            for half, nib, off in (("l", lo_n, 0), ("h", hi_n, Kh)):
                for p in range(3):
                    d = np.zeros(N, f32)
                    for m in range(4):  # mma m: k0 + 16 t + 4 m + {0, 1, 2, 3}, t = 0..3
                        ks = np.array([s * 64 + 16 * t + 4 * m + j for t in range(4) for j in range(4)])
                        d = (d.astype(np.float64) + nib[:, ks] @ parts[p][off + ks]).astype(f32)
                    col[half, p] = d
            acc0 = acc0 + ((col["l", 0] + col["l", 1]) * st[:, g] + (col["h", 0] + col["h", 1]) * st[:, Gh + g])
            acc1 = acc1 + (col["l", 2] * st[:, g] + col["h", 2] * st[:, Gh + g])
        red.append(acc0 + acc1)
    hsum = _butterfly((h.astype(f32).reshape(K // 64, 16, 4) @ np.ones(4, f32)).astype(f32))  # (K / 64,)
    gx = np.zeros(G, f32)
    for j in range(gs // 64):
        gx = gx + hsum.reshape(G, gs // 64)[:, j]
    z = _butterfly(np.stack([(zt[:, p8::8] * gx[p8::8]).sum(-1, dtype=f32) for p8 in range(8)], -1))
    return (((red[0] + red[1]) + red[2]) + red[3]) + z


def _emulated_mv(terms: int = 3):
    """An ``mv_int4_ref`` in f32 compute that runs the emulation on each row."""
    def mv(src, w, cdtype):
        assert cdtype == torch.float32
        wd = tfl._with_decode_layout(w)
        gs = 2 * w["qw"].shape[0] // w["qscale"].shape[0]
        return torch.from_numpy(np.stack([emulate_f32_matvec(r, wd, gs, terms) for r in src.numpy()]))
    return mv


def test_f32_matvec_emulation_matches_plain_and_pallas(prepared, monkeypatch):
    """The f32 matvec's arithmetic, emulated (``emulate_f32_matvec``): on
    each linear of a block it equals the port's plain f32 matvec to 4e-6 of
    the output's largest value (the same exact products summed in another
    order: 5-7e-7 seen), where the split without lo (1.2-2.7e-5) and the bf16
    body's input, hi alone (3-9e-3), stand farther off; K2 (final norm + lm_head) and one K1 block on it hold JAX's
    _head_kernel and _layer_kernel in f32 (interpret mode) to the tolerances
    the plain versions are held to (1e-4; the block's output 2e-3 as in
    test_decode_layer_ref_matches_pallas_f32)."""
    fparams, fcfg, tparams, tc = prepared
    rng = np.random.default_rng(22)
    lp = tparams["h"][0]
    for w in (lp["attn"]["c_attn"], lp["attn"]["c_proj"], lp["mlp"]["c_fc12"], lp["mlp"]["c_proj"]):
        h = torch.from_numpy(rng.normal(size=(1, 2 * w["qw"].shape[0])).astype(np.float32))
        want = tfl.mv_int4_ref(h, w, torch.float32)
        tol = 4e-6 * float(want.abs().max())
        assert float((_emulated_mv()(h, w, torch.float32) - want).abs().max()) <= tol
        for terms in (1, 2):
            assert float((_emulated_mv(terms)(h, w, torch.float32) - want).abs().max()) > tol
    monkeypatch.setattr(tfl, "mv_int4_ref", _emulated_mv())
    x = rng.normal(size=(1, fcfg.n_embd)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jfl.lm_head_fused(jnp.asarray(x), fparams["ln_f"], fparams["lm_head"], fcfg)
    got = tfl.lm_head_fused(torch.from_numpy(x), tparams["ln_f"], tparams["lm_head"], tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    pos = 37
    x, k, v = _inputs(rng, fcfg)
    hs = fcfg.head_size
    cosj, sinj = j_rope_row(j_rope_cache(fcfg.block_size, hs), jnp.int32(pos), hs)
    with pltpu.force_tpu_interpret_mode():
        jout, jkv = jfl.decode_layer_fused(jnp.asarray(x), fparams["h"][0], {"k": jnp.asarray(k), "v": jnp.asarray(v)},
                                           cosj, sinj, jnp.int32(pos), jnp.int32(pos), fcfg)
    cost, sint = rope_half_row(build_rope_cache(tc.block_size, hs), pos, hs)
    kv = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    tout, _ = tfl.decode_layer_fused(torch.from_numpy(x), tparams["h"][0], kv, cost, sint, pos, pos, tc)
    np.testing.assert_allclose(kv["k"].numpy(), np.asarray(jkv["k"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=2e-3, atol=2e-3)


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
    _split_boundary_case(prepared, cuda, pos, torch.bfloat16, dict(rtol=1e-2, atol=1e-2), dict(rtol=2e-2, atol=2e-2))


@pytest.mark.parametrize("pos", [0, 255, 256, 2047, 2300])
def test_decode_layers_kernel_f32_at_split_boundaries(prepared, cuda, pos):
    """K1 in f32 (the matvec through the three-term split, the split
    attention on the f32 cache) against its plain version at S = 2048, at the
    first row and the positions of the bf16 test: f32 sums in another order,
    1e-4 on the cache rows and the output."""
    tol = dict(rtol=1e-4, atol=1e-4)
    _split_boundary_case(prepared, cuda, pos, torch.float32, tol, tol)


def _split_boundary_case(prepared, cuda, pos, cd, cache_tol, out_tol):
    from lit_llama_tpu_torch.ops import decode_attention as tda

    _, fcfg, tparams, tc = prepared
    tc = tc.replace(compute_dtype=str(cd).split(".")[1], block_size=4096)
    params = {**tparams, "h": [
        {**lp, "rms_1": lp["rms_1"].to(cd), "rms_2": lp["rms_2"].to(cd)}
        for lp in tparams["h"]]}
    params = _to(tfl.add_decode_layout(params), cuda)
    rng = np.random.default_rng(pos)
    Sg, H, hs = 2048, tc.n_head, tc.head_size
    assert tda.decode_plan(Sg, hs).split_rows == 256
    mk = lambda: torch.from_numpy((rng.normal(size=(1, H, Sg, hs)) * 0.3).astype(np.float32)).to(cuda, cd)
    kvs = [{"k": mk(), "v": mk()} for _ in range(2)]
    ref_kvs = [{n: c.clone() for n, c in kv.items()} for kv in kvs]
    x = torch.from_numpy(rng.normal(size=(1, tc.n_embd)).astype(np.float32)).to(cuda, cd)
    cos, sin = rope_half_row(build_rope_cache(tc.block_size, hs, device=cuda), pos, hs)
    out, _ = tfl.decode_layers_fused(x, params["h"], kvs, cos, sin, pos % Sg, pos, tc)
    ref, _ = tfl.decode_layers_fused_ref(x, params["h"], ref_kvs, cos, sin, pos % Sg, pos, tc)
    torch.cuda.synchronize()
    for kv, rkv in zip(kvs, ref_kvs):
        torch.testing.assert_close(kv["k"].float(), rkv["k"].float(), **cache_tol)
        torch.testing.assert_close(kv["v"].float(), rkv["v"].float(), **cache_tol)
    torch.testing.assert_close(out.float(), ref.float(), **out_tol)
    assert int(tda.arrival_counters(H, cuda).abs().sum()) == 0
