"""The serving kernels K7 (block_head_fused), K8 (decode_attention_write,
behind both JAX entries) and K9 (block_tail_fused): the port's plain versions
against the JAX Pallas kernels in interpret mode on the CPU, and the CUDA
kernels against the plain versions on the card (skipped without one).

The tiny fused geometry of tests/test_fused_layer.py (n_embd 512, 4 heads of
128, group size 128) and one with an odd group count per nibble plane."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lit_llama_tpu import LLaMAConfig, init_params
from lit_llama_tpu.models import llama as jllama
from lit_llama_tpu.ops import decode_attention as jda
from lit_llama_tpu.ops import fused_layer as jfl
from lit_llama_tpu.ops.rope import build_rope_cache as j_rope_cache
from lit_llama_tpu_torch.models import config as tcfg
from lit_llama_tpu_torch.models import llama as tllama
from lit_llama_tpu_torch.ops import decode_attention as tda
from lit_llama_tpu_torch.ops import fused_layer as tfl
from lit_llama_tpu_torch.ops.rope import build_rope_cache, slot_rope_rows
from lit_llama_tpu_torch.utils.jax_params import params_from_numpy, tensor_from_numpy

TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _port_config(cfg):
    return tcfg.LLaMAConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                               if f.name not in ("lora", "adapter")})


def _prepare(n_embd, n_head, seed):
    cfg = LLaMAConfig(block_size=256, vocab_size=128, n_layer=1, n_head=n_head, n_embd=n_embd,
                      quantize="int4", quant_groupsize=128)
    dense = init_params(cfg.replace(quantize=None), jax.random.PRNGKey(seed))
    fparams, fcfg = jfl.prepare_fused_params(jllama.unstack_layers(jllama.quantize_params(dense, cfg)), cfg)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, fparams), device="cpu")
    return fparams["h"][0], fcfg, tparams["h"][0], _port_config(fcfg)


@pytest.fixture(scope="module")
def layers():
    """(JAX layer, JAX config, port layer, port config) by geometry: "even"
    has 2 groups per nibble plane, "odd" 3 (as 7B's mlp.c_proj has 43)."""
    return {"even": _prepare(512, 4, 0), "odd": _prepare(768, 6, 2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _as_torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _rope_rows(cfg, tc, positions):
    """The slots' rope rows for both sides: JAX (B, 3D) lane tables, the port's
    (B, hs) rows."""
    pos = np.asarray(positions, np.int32)
    rope = jnp.take(j_rope_cache(cfg.block_size, cfg.head_size), jnp.clip(pos, 0, cfg.block_size - 1),
                    axis=0)[:, None]
    cos3, sin3 = jllama._slot_rope_tables(rope, cfg)
    cos, sin = slot_rope_rows(build_rope_cache(tc.block_size, tc.head_size), torch.from_numpy(pos))
    return cos3, sin3, cos, sin


HEAD_CASES = [("even", 1, "float32"), ("even", 3, "float32"), ("even", 8, "float32"),
              ("even", 48, "float32"), ("odd", 3, "float32"), ("even", 3, "bfloat16"),
              ("even", 48, "bfloat16"),
              # past 64 slots: K7 and K9 walk the slots in tiles of 64 rows
              ("even", 65, "float32"), ("even", 96, "bfloat16"), ("even", 128, "float32")]


@pytest.mark.parametrize("geom,B,dtype", HEAD_CASES)
def test_block_head_ref_matches_pallas(layers, geom, B, dtype):
    """The Pallas entry is run twice. With the slots' tables its v columns are
    compared as they come. Its q and k columns are taken with identity tables
    (cos 1, sin 0: norm and product alone) and rotated by the JAX package's
    ``apply_rope_half``, the rotation its XLA path applies: on the CPU
    ``pltpu.roll`` moves lanes the other way than the kernel's lane select
    expects, so in interpret mode the kernel pairs lane l with l - 64 of the
    neighbouring head and its own rotation is not the reference."""
    from lit_llama_tpu.ops.rope import apply_rope_half

    jlp, cfg, tlp, tc = layers[geom]
    D, H, hs = cfg.n_embd, cfg.n_head, cfg.head_size
    rng = np.random.default_rng(B)
    x = (rng.normal(size=(B, D)) * 0.5).astype(np.float32)
    positions = rng.integers(0, 300, size=B)  # some past block_size: the rope row clips
    cos3, sin3, cos, sin = _rope_rows(cfg, tc, positions)
    run = lambda c3, s3: np.asarray(jfl.block_head_fused(
        jnp.asarray(x, dtype), jlp["rms_1"], c3, s3, jlp["attn"]["c_attn"],
        B=B, D=D, gs=cfg.quant_groupsize, cdtype=dtype, interpret=True), np.float32)
    rotated, raw = run(cos3, sin3), run(jnp.ones_like(cos3), jnp.zeros_like(sin3))
    rope = jnp.take(j_rope_cache(cfg.block_size, hs), jnp.clip(positions, 0, cfg.block_size - 1), axis=0)
    qk = apply_rope_half(jnp.asarray(raw[:, : 2 * D]).reshape(B, 1, 2 * H, hs), rope[:, None])
    want = np.concatenate([np.asarray(qk).reshape(B, 2 * D), rotated[:, 2 * D :]], axis=-1)
    np.testing.assert_array_equal(rotated[:, 2 * D :], raw[:, 2 * D :])
    tdt = getattr(torch, dtype)
    got = tfl.block_head_fused(_as_torch(x, tdt), tlp["rms_1"], cos, sin, tlp["attn"]["c_attn"], tc)
    assert got.dtype == tdt and got.shape == (B, 3 * D)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])


@pytest.mark.parametrize("geom,B,dtype", HEAD_CASES)
def test_block_tail_ref_matches_pallas(layers, geom, B, dtype):
    """At 48 rows and bf16 the Pallas kernel keeps its MLP intermediates in
    bf16 (a VMEM limit); the port keeps f32, inside the bf16 tolerance."""
    jlp, cfg, tlp, tc = layers[geom]
    rng = np.random.default_rng(100 + B)
    x = (rng.normal(size=(B, cfg.n_embd)) * 0.5).astype(np.float32)
    y = (rng.normal(size=(B, cfg.n_embd)) * 0.5).astype(np.float32)
    want = jfl.block_tail_fused(
        jnp.asarray(x, dtype), jnp.asarray(y, dtype), jlp["rms_2"], jlp["attn"]["c_proj"],
        jlp["mlp"]["c_fc12"], jlp["mlp"]["c_proj"], B=B, D=cfg.n_embd, I=cfg.intermediate_size,
        gs=cfg.quant_groupsize, cdtype=dtype, interpret=True)
    tdt = getattr(torch, dtype)
    got = tfl.block_tail_fused(_as_torch(x, tdt), _as_torch(y, tdt), tlp["rms_2"], tlp["attn"]["c_proj"],
                               tlp["mlp"]["c_fc12"], tlp["mlp"]["c_proj"], tc)
    assert got.dtype == tdt and got.shape == (B, cfg.n_embd)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("B", [8, 65])
def test_block_halves_ref_f32_norm_weights_match_pallas_bf16(layers, B):
    """bf16 compute with f32 norm weights that are not ones: K7's and K9's
    plain versions apply them in f32, as the Pallas kernels' _rms_norm_rows,
    to the bf16 tolerance. The Pallas head's q/k columns are taken with
    identity tables and rotated by apply_rope_half, as in the test above."""
    from lit_llama_tpu.ops.rope import apply_rope_half

    jlp, cfg, tlp, tc = layers["even"]
    D, H, hs = cfg.n_embd, cfg.n_head, cfg.head_size
    rng = np.random.default_rng(300 + B)
    r1, r2 = ((1.0 + 0.3 * rng.normal(size=(D,))).astype(np.float32) for _ in range(2))
    x = (rng.normal(size=(B, D)) * 0.5).astype(np.float32)
    y = (rng.normal(size=(B, D)) * 0.5).astype(np.float32)
    positions = rng.integers(0, 300, size=B)
    cos3, sin3, cos, sin = _rope_rows(cfg, tc, positions)
    raw = np.asarray(jfl.block_head_fused(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(r1), jnp.ones_like(cos3), jnp.zeros_like(sin3),
        jlp["attn"]["c_attn"], B=B, D=D, gs=cfg.quant_groupsize, cdtype="bfloat16", interpret=True), np.float32)
    rope = jnp.take(j_rope_cache(cfg.block_size, hs), jnp.clip(positions, 0, cfg.block_size - 1), axis=0)
    qk = apply_rope_half(jnp.asarray(raw[:, : 2 * D]).reshape(B, 1, 2 * H, hs), rope[:, None])
    want = np.concatenate([np.asarray(qk).reshape(B, 2 * D), raw[:, 2 * D :]], axis=-1)
    xb = _as_torch(x, torch.bfloat16)
    got = tfl.block_head_fused(xb, torch.from_numpy(r1), cos, sin, tlp["attn"]["c_attn"], tc)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL["bfloat16"])
    want = jfl.block_tail_fused(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16), jnp.asarray(r2), jlp["attn"]["c_proj"],
        jlp["mlp"]["c_fc12"], jlp["mlp"]["c_proj"], B=B, D=D, I=cfg.intermediate_size, gs=cfg.quant_groupsize,
        cdtype="bfloat16", interpret=True)
    got = tfl.block_tail_fused(xb, _as_torch(y, torch.bfloat16), torch.from_numpy(r2), tlp["attn"]["c_proj"],
                               tlp["mlp"]["c_fc12"], tlp["mlp"]["c_proj"], tc)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL["bfloat16"])


def test_block_head_refuses_lora(layers):
    """K7 takes a LoRA overlay only as the operand prepare_fused_params folds
    (lora_af, lora_bf): a raw overlay would have its update left out, so it
    is refused."""
    _, _, tlp, tc = layers["even"]
    ca = {**tlp["attn"]["c_attn"], "lora_a": torch.zeros(512, 8), "lora_b": torch.zeros(2, 4, 512)}
    with pytest.raises(ValueError, match="did not fold"):
        tfl.block_head_fused(torch.zeros(1, 512), tlp["rms_1"], torch.ones(1, 128), torch.zeros(1, 128), ca, tc)


# positions as tests/test_pallas_kernels.py takes them: the second set wraps the ring
POSITIONS = [[0, 5, 255], [256 + 7, 3, 511 + 256]]
ENTRIES = {
    "pipelined_mxu": lambda *a: jda.decode_attention_write_pipelined(*a, mxu=True, interpret=True),
    "pipelined_vpu": lambda *a: jda.decode_attention_write_pipelined(*a, mxu=False, interpret=True),
    "manual": lambda *a: jda.decode_attention_write_pallas(*a, interpret=True),
}
PORT_ENTRIES = {
    "pipelined_mxu": lambda *a: tda.decode_attention_write_pipelined(*a, mxu=True),
    "pipelined_vpu": lambda *a: tda.decode_attention_write_pipelined(*a, mxu=False),
    "manual": tda.decode_attention_write_pallas,
}


def _attn_inputs(positions, seed):
    rng = np.random.default_rng(seed)
    B, H, S, hs = len(positions), 4, 256, 128
    mk = lambda *shape: rng.normal(size=shape).astype(np.float32)
    return (mk(B, H, 1, hs), mk(B, H, 1, hs), mk(B, H, 1, hs), mk(B, H, S, hs), mk(B, H, S, hs),
            np.asarray(positions, np.int32))


@pytest.mark.parametrize("entry", sorted(ENTRIES))
@pytest.mark.parametrize("positions", POSITIONS)
def test_decode_attention_write_ref_matches_pallas_f32(positions, entry):
    q, kn, vn, kc, vc, pos = _attn_inputs(positions, 3)
    wy, wk, wv = ENTRIES[entry](*(jnp.asarray(a) for a in (q, kn, vn, kc, vc)), jnp.asarray(pos))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    gy, gk, gv = PORT_ENTRIES[entry](torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
                                     tk, tv, torch.from_numpy(pos))
    assert gk is tk and gv is tv  # written in place
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
@pytest.mark.parametrize("positions", POSITIONS)
def test_decode_attention_write_ref_matches_pallas_packed(positions, entry):
    """bf16 against the JAX packed u32 pair cache, compared through
    pack_kv/unpack_kv: the stored rows are identical, the outputs agree to a
    bf16 ulp."""
    q, kn, vn, kc, vc, pos = _attn_inputs(positions, 4)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    wy, wk, wv = ENTRIES[entry](bf(q), bf(kn), bf(vn), jfl.pack_kv(bf(kc)), jfl.pack_kv(bf(vc)),
                                jnp.asarray(pos))
    tb = lambda a: _as_torch(a, torch.bfloat16)
    gy, gk, gv = PORT_ENTRIES[entry](tb(q), tb(kn), tb(vn), tb(kc), tb(vc), torch.from_numpy(pos))
    assert gy.dtype == torch.bfloat16
    np.testing.assert_array_equal(gk.float().numpy(), np.asarray(jfl.unpack_kv(wk), np.float32))
    np.testing.assert_array_equal(gv.float().numpy(), np.asarray(jfl.unpack_kv(wv), np.float32))
    np.testing.assert_allclose(gy.float().numpy(), np.asarray(wy, np.float32), rtol=2e-2, atol=2e-2)


def test_decode_attention_write_unwritten_rows_are_zeros():
    """A slot whose visible rows were never written reads zeros, not NaNs."""
    B, H, S, hs = 2, 2, 64, 128
    q = torch.ones(B, H, 1, hs)
    kc, vc = torch.zeros(B, H, S, hs), torch.zeros(B, H, S, hs)
    y, _, _ = tda.decode_attention_write(q, q * 0.5, q * 2.0, kc, vc, torch.tensor([S - 1, 0], dtype=torch.int32))
    assert torch.isfinite(y).all()
    torch.testing.assert_close(y[1], torch.full((H, 1, hs), 2.0))  # slot at 0 sees its own row only


# ---------------------------------------------------------------------------
# On the card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _card_layer(n_embd, n_head, cuda, seed):
    cfg = tcfg.LLaMAConfig(block_size=512, vocab_size=1000, n_layer=1, n_head=n_head, n_embd=n_embd,
                           quantize="int4", quant_groupsize=128, compute_dtype="bfloat16")
    dense = tllama.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    params, tc = tfl.prepare_fused_params(tllama.unstack_layers(tllama.quantize_params(dense, cfg)), cfg)
    lp = _to(params["h"][0], cuda)
    lp["rms_1"], lp["rms_2"] = lp["rms_1"].to(torch.bfloat16), lp["rms_2"].to(torch.bfloat16)
    return lp, tc


@pytest.mark.parametrize("n_embd,n_head", [(512, 4), (1792, 14)])
@pytest.mark.parametrize("B", [1, 2, 8, 17, 32, 33, 64, 65, 96, 128])
def test_block_head_and_tail_kernels_match_plain(cuda, n_embd, n_head, B):
    """K7 and K9 on the card against their plain versions at bf16; 14 heads of
    128 give n_embd 1792 (7 groups per plane) and I = 4864 (19), odd as 7B's
    mlp.c_proj (43). Quantized weights, so scales and zeros differ in every
    group and column."""
    lp, tc = _card_layer(n_embd, n_head, cuda, 3)
    rng = np.random.default_rng(B)
    mk = lambda: torch.from_numpy(rng.normal(size=(B, n_embd)).astype(np.float32)).to(cuda, torch.bfloat16)
    x, y = mk(), mk()
    pos = torch.from_numpy(rng.integers(0, 600, size=B).astype(np.int32)).to(cuda)
    cos, sin = slot_rope_rows(build_rope_cache(tc.block_size, 128, device=cuda), pos)
    before = tfl.block_head_fused.launches, tfl.block_tail_fused.launches
    args = (x, lp["rms_1"], cos, sin, lp["attn"]["c_attn"], tc)
    torch.testing.assert_close(tfl.block_head_fused(*args).float(), tfl.block_head_fused_ref(*args).float(),
                               rtol=2e-2, atol=2e-2)
    args = (x, y, lp["rms_2"], lp["attn"]["c_proj"], lp["mlp"]["c_fc12"], lp["mlp"]["c_proj"], tc)
    torch.testing.assert_close(tfl.block_tail_fused(*args).float(), tfl.block_tail_fused_ref(*args).float(),
                               rtol=2e-2, atol=2e-2)
    torch.cuda.synchronize()
    assert (tfl.block_head_fused.launches, tfl.block_tail_fused.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("n_embd,n_head", [(512, 4), (2048, 16)])
def test_block_head_and_tail_kernel_rows_equal_at_any_slot_count(cuda, n_embd, n_head):
    """A row's K7 and K9 outputs are the same bits at B = 1, 32 and 128 (the
    products' token tiles of 8, 32 and 128 slots; at n_embd 2048 c_attn and
    both c_proj products split K), so a request's tokens do not depend on
    the engine's size."""
    lp, tc = _card_layer(n_embd, n_head, cuda, 5)
    rng = np.random.default_rng(11)
    mk = lambda: torch.from_numpy(rng.normal(size=(128, n_embd)).astype(np.float32)).to(cuda, torch.bfloat16)
    x, y = mk(), mk()
    pos = torch.from_numpy(rng.integers(0, 600, size=128).astype(np.int32)).to(cuda)
    cos, sin = slot_rope_rows(build_rope_cache(tc.block_size, 128, device=cuda), pos)
    outs = {}
    for B in (1, 32, 128):
        outs[B] = (tfl.block_head_fused(x[:B], lp["rms_1"], cos[:B], sin[:B], lp["attn"]["c_attn"], tc),
                   tfl.block_tail_fused(x[:B], y[:B], lp["rms_2"], lp["attn"]["c_proj"], lp["mlp"]["c_fc12"],
                                        lp["mlp"]["c_proj"], tc))
    for B in (1, 32):
        for got, ref in zip(outs[B], outs[128]):
            assert torch.equal(got, ref[:B]), f"B={B}: a row's bits differ from the 128-slot call's"


@pytest.mark.parametrize("entry", sorted(PORT_ENTRIES))
@pytest.mark.parametrize("S,positions", [(256, [0, 5, 255, 256 + 7, 3, 511 + 256, 64, 63]),
                                         (200, [0, 199, 200, 401, 77])])
def test_decode_attention_write_kernel_matches_plain(cuda, entry, S, positions):
    """K8 on the card through each entry: y and both caches, with slots at 0,
    at S - 1 and past S (wrapped); S = 200 leaves a ragged last chunk. q, k
    and v are views into one fused (B, 3D) row, as the block head leaves them."""
    rng = np.random.default_rng(S)
    B, H, hs = len(positions), 4, 128
    bf = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda, torch.bfloat16)
    qkv = bf(B, 3 * H * hs)
    q, kn, vn = (qkv[:, i * H * hs : (i + 1) * H * hs].reshape(B, H, 1, hs) for i in range(3))
    kc, vc = bf(B, H, S, hs), bf(B, H, S, hs)
    rk, rv = kc.clone(), vc.clone()
    pos = torch.tensor(positions, dtype=torch.int32, device=cuda)
    before = tda.decode_attention_write.launches
    y, gk, gv = PORT_ENTRIES[entry](q, kn, vn, kc, vc, pos)
    ry, _, _ = tda.decode_attention_write_ref(q, kn, vn, rk, rv, pos)
    torch.cuda.synchronize()
    assert tda.decode_attention_write.launches == before + 1 and gk is kc
    assert torch.equal(kc, rk) and torch.equal(vc, rv)
    torch.testing.assert_close(y.float(), ry.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("compute,norm", [("bfloat16", "float32"), ("float32", "float32"), ("float32", "bfloat16")])
@pytest.mark.parametrize("B", [8, 65])
def test_block_head_and_tail_kernels_f32_compute_and_norms(cuda, compute, norm, B):
    """K7 and K9 on the card against their plain versions in f32 compute (the
    FFMA body on the shared layout: the f32 sums differ in order only, 1e-4)
    and with f32 norm weights (random, applied in f32)."""
    lp, tc = _card_layer(1792, 14, cuda, 5)
    cd, nd = getattr(torch, compute), getattr(torch, norm)
    tc = tc.replace(compute_dtype=compute)
    g = torch.Generator().manual_seed(B)
    lp = {**lp, "rms_1": (1.0 + 0.3 * torch.randn(1792, generator=g)).to(cuda, nd),
          "rms_2": (1.0 + 0.3 * torch.randn(1792, generator=g)).to(cuda, nd)}
    rng = np.random.default_rng(B)
    mk = lambda: torch.from_numpy(rng.normal(size=(B, 1792)).astype(np.float32)).to(cuda, cd)
    x, y = mk(), mk()
    pos = torch.from_numpy(rng.integers(0, 600, size=B).astype(np.int32)).to(cuda)
    cos, sin = slot_rope_rows(build_rope_cache(tc.block_size, 128, device=cuda), pos)
    tol = dict(rtol=1e-4, atol=1e-4) if compute == "float32" else dict(rtol=2e-2, atol=2e-2)
    before = tfl.block_head_fused.launches, tfl.block_tail_fused.launches
    args = (x, lp["rms_1"], cos, sin, lp["attn"]["c_attn"], tc)
    got = tfl.block_head_fused(*args)
    assert got.dtype == cd
    torch.testing.assert_close(got.float(), tfl.block_head_fused_ref(*args).float(), **tol)
    args = (x, y, lp["rms_2"], lp["attn"]["c_proj"], lp["mlp"]["c_fc12"], lp["mlp"]["c_proj"], tc)
    torch.testing.assert_close(tfl.block_tail_fused(*args).float(), tfl.block_tail_fused_ref(*args).float(), **tol)
    torch.cuda.synchronize()
    assert (tfl.block_head_fused.launches, tfl.block_tail_fused.launches) == (before[0] + 1, before[1] + 1)


def test_decode_attention_write_kernel_f32(cuda):
    """K8 on the card in f32 compute (f32 q and cache) against its plain
    version: the caches equal, y to 1e-4 (f32 sums in another order)."""
    positions = [0, 5, 255, 256 + 7, 3, 511 + 256, 64, 63]
    rng = np.random.default_rng(9)
    B, H, hs, S = len(positions), 4, 128, 256
    f32 = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda)
    qkv = f32(B, 3 * H * hs)
    q, kn, vn = (qkv[:, i * H * hs : (i + 1) * H * hs].reshape(B, H, 1, hs) for i in range(3))
    kc, vc = f32(B, H, S, hs), f32(B, H, S, hs)
    rk, rv = kc.clone(), vc.clone()
    pos = torch.tensor(positions, dtype=torch.int32, device=cuda)
    before = tda.decode_attention_write.launches
    y, _, _ = tda.decode_attention_write(q, kn, vn, kc, vc, pos)
    ry, _, _ = tda.decode_attention_write_ref(q, kn, vn, rk, rv, pos)
    torch.cuda.synchronize()
    assert tda.decode_attention_write.launches == before + 1 and y.dtype == torch.float32
    assert torch.equal(kc, rk) and torch.equal(vc, rv)
    torch.testing.assert_close(y, ry, rtol=1e-4, atol=1e-4)
