"""GPTQ (``lit_llama_tpu_torch.quant.gptq``) against the JAX package's on the
CPU, from numpy-seeded inputs, and the calibration kernels (K3 and K4 in f32)
against their plain versions on the card (skipped without one).

Tolerances: the Hessian, its inverse factor, scales and zeros to f32
rounding (relative 1e-5 of the largest entry; the two packages sum in other
orders); levels equal, or, where a different sum order tips an error-fed row
across a rounding boundary, at most a share ``FLIP_SHARE`` of them flipped,
with ‖X(W − Ŵ)‖ within ``OBJ_SHARE`` of JAX's. Through a whole model the
Hessians' rounding reaches the scales of later groups (taken from rows the
error feedback moved) and the next layers: leaves relative ``MODEL_REL``. One flipped level feeds
another error to every later row, so a tipped rounding spreads (0.16 % of
the levels with one group of 256 rows). Across a whole model under
``actorder`` a level flipped in one layer moves the next layer's Hessian by
percents, and a near-tie in its diagonal then reorders the walk: the two
packages give different, equally good quantizations there, so the model is
held by its logits' distance from the dense model's, within
``QUALITY_SHARE`` of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lit_llama_tpu import LLaMAConfig as JaxConfig
from lit_llama_tpu import forward as jforward
from lit_llama_tpu import init_params as jinit
from lit_llama_tpu.ops.linear import pack_int4 as jpack_int4
from lit_llama_tpu.quant import gptq as jg
from lit_llama_tpu_torch.models import llama
from lit_llama_tpu_torch.models.config import LLaMAConfig
from lit_llama_tpu_torch.ops import flash_attention as fa
from lit_llama_tpu_torch.ops import quant_matmul as tqm
from lit_llama_tpu_torch.ops.linear import dequantize_int4, quantize_int4
from lit_llama_tpu_torch.ops.rope import build_rope_cache
from lit_llama_tpu_torch.quant import gptq as tg
from lit_llama_tpu_torch.utils.checkpoint import tree_leaves
from lit_llama_tpu_torch.utils.jax_params import params_from_numpy

REL = 1e-5
FLIP_SHARE = 1e-2
OBJ_SHARE = 1e-3
QUALITY_SHARE = 2e-2
MODEL_REL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _correlated(rng, n, in_f, out_f):
    mix = rng.normal(size=(in_f, in_f)) * 0.3 + np.eye(in_f)
    x = (rng.normal(size=(n, in_f)) @ mix).astype(np.float32)
    w = (rng.normal(size=(in_f, out_f)) * 0.1).astype(np.float32)
    return x, w


def _dequant(q, s, z):
    q = np.asarray(q, np.float32)
    in_f, out_f = q.shape
    G = np.asarray(s).shape[0]
    w = q.reshape(G, in_f // G, out_f) * np.asarray(s)[:, None] + np.asarray(z)[:, None]
    return w.reshape(in_f, out_f)


def _objective(x, w, q, s, z):
    """‖X(W − Ŵ)‖ on the calibration inputs."""
    return float(np.linalg.norm(x.astype(np.float64) @ (w - _dequant(q, s, z))))


def test_accumulate_hessian_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 40, 96)).astype(np.float32)
    H0 = rng.normal(size=(96, 96)).astype(np.float32)
    want = jg.accumulate_hessian(jnp.asarray(H0), jnp.asarray(x))
    got = tg.accumulate_hessian(torch.from_numpy(H0.copy()), torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (96, 96)
    assert _rel(got.numpy(), want) <= REL


def test_hinv_cholesky_matches_jax():
    """The device and the host (LAPACK) factor, with a dead column."""
    rng = np.random.default_rng(1)
    x, _ = _correlated(rng, 300, 128, 8)
    x[:, 5] = 0.0
    H = np.array(jg.accumulate_hessian(jnp.zeros((128, 128)), jnp.asarray(x)))
    want = np.asarray(jg._hinv_cholesky(jnp.asarray(H)))
    got = tg._hinv_cholesky(torch.from_numpy(H))
    assert np.allclose(np.tril(got.numpy(), -1), 0.0)  # upper triangular
    assert _rel(got.numpy(), want) <= 1e-4
    assert _rel(tg._hinv_cholesky_host(torch.from_numpy(H)).numpy(), jg._hinv_cholesky_host(H)) <= REL


def _matrix_case(case, rng):
    in_f, out_f = 256, 96
    x, w = _correlated(rng, 512, in_f, out_f)
    H = np.array(jg.accumulate_hessian(jnp.zeros((in_f, in_f)), jnp.asarray(x)))
    kw = {"plain": {}, "actorder": {"actorder": True}, "gs-1": {"groupsize": -1}, "gs32": {"groupsize": 32},
          "gs32_block64": {"groupsize": 32, "blocksize": 64}}.get(case)
    if case == "hinv":
        kw = {"hinv": np.asarray(jg._hinv_cholesky(jnp.asarray(H)))}
    if case == "hinv_actorder":  # the host factor of the permuted H, as quantize_model_gptq spills it
        perm = np.argsort(-np.diag(H), kind="stable")
        kw = {"actorder": True, "hinv": jg._hinv_cholesky_host(H[perm][:, perm])}
    if case == "diag_ties":  # a diagonal H with tied entries: actorder's order is the stable sort's
        H = np.diag(np.repeat(np.array([3.0, 1.0, 2.0, 1.0], np.float32), in_f // 4)).astype(np.float32)
        x = np.sqrt(np.diag(H) / 2.0)[None, :] * np.eye(in_f, dtype=np.float32)
        kw = {"actorder": True}
    return x, w, H, kw


@pytest.mark.parametrize("case", ["plain", "actorder", "gs-1", "gs32", "gs32_block64", "hinv", "hinv_actorder",
                                  "diag_ties"])
def test_gptq_quantize_matrix_matches_jax(case):
    x, w, H, kw = _matrix_case(case, np.random.default_rng(2))
    jkw = {k: (jnp.asarray(v) if k == "hinv" else v) for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(np.array(v)) if k == "hinv" else v) for k, v in kw.items()}
    qj, sj, zj = (np.asarray(a) for a in jg.gptq_quantize_matrix(jnp.asarray(w), jnp.asarray(H), **jkw))
    qt, st, zt = (a.numpy() for a in tg.gptq_quantize_matrix(torch.from_numpy(w), torch.from_numpy(H), **tkw))
    assert qt.dtype == np.uint8 and qt.shape == qj.shape and st.shape == sj.shape == zt.shape
    assert qt.max() <= 15
    flips = float((qt != qj).mean())
    assert flips <= FLIP_SHARE, f"{case}: {flips:.4%} of the levels differ from JAX's"
    assert _rel(st, sj) <= REL and _rel(zt, zj) <= REL
    ot, oj = _objective(x, w, qt, st, zt), _objective(x, w, qj, sj, zj)
    assert abs(ot - oj) <= OBJ_SHARE * oj, (ot, oj)


def test_gptq_beats_round_to_nearest():
    """The point of the algorithm: on correlated inputs the error feedback
    leaves ‖X(W − Ŵ)‖ below round-to-nearest's at the same group size."""
    x, w = _correlated(np.random.default_rng(3), 512, 256, 128)
    H = tg.accumulate_hessian(torch.zeros(256, 256), torch.from_numpy(x))
    for actorder in (False, True):
        q, s, z = tg.gptq_quantize_matrix(torch.from_numpy(w), H, groupsize=128, actorder=actorder)
        rtn = quantize_int4(torch.from_numpy(w), groupsize=128)
        err_rtn = float(np.linalg.norm(x @ (w - dequantize_int4(rtn).numpy())))
        assert _objective(x, w, q.numpy(), s.numpy(), z.numpy()) < 0.9 * err_rtn


def test_pack_q4_byte_equal():
    q = np.random.default_rng(4).integers(0, 16, size=(128, 40)).astype(np.uint8)
    got = tg.pack_q4(torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jg.pack_q4(jnp.asarray(q))))
    np.testing.assert_array_equal(got, np.asarray(jpack_int4(jnp.asarray(q))))
    # half-split: packed row i holds row i low and row i + in/2 high
    np.testing.assert_array_equal(got & 15, q[:64])
    np.testing.assert_array_equal(got >> 4, q[64:])


TINY = dict(block_size=64, vocab_size=128, n_layer=3, n_head=4, n_embd=64)


@pytest.fixture(scope="module")
def tiny_model():
    jc = JaxConfig(**TINY)
    jp = jinit(jc, jax.random.PRNGKey(0))
    calib = np.random.default_rng(5).integers(0, TINY["vocab_size"], size=(6, 32)).astype(np.int32)
    return jc, jp, calib


def _leaves_close(jtree, ttree, what, levels=True):
    jl = tree_leaves(jax.tree_util.tree_map(np.asarray, jtree))
    tl = tree_leaves(ttree)
    assert sorted(jl) == sorted(tl), what
    for name, a in jl.items():
        b = tl[name].cpu().numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, (what, name, a.dtype, b.dtype)
        if a.dtype == np.uint8:  # both nibbles of each byte
            flips = float(((a & 15) != (b & 15)).mean() + ((a >> 4) != (b >> 4)).mean()) / 2
            assert flips <= FLIP_SHARE or not levels, (what, name, flips)
        else:
            assert _rel(b, a) <= MODEL_REL, (what, name, _rel(b, a))


@pytest.mark.parametrize("host_spill", [False, True])
@pytest.mark.parametrize("actorder", [False, True])
def test_quantize_model_gptq_matches_jax(tiny_model, host_spill, actorder):
    """The whole model, three layers: every leaf against JAX's (levels,
    scales, zeros, and the dense leaves passed through); spilled leaves lie on
    the host. Under ``actorder`` the levels are held by the quantized model's
    logits (module docstring)."""
    jc, jp, calib = tiny_model
    want = jg.quantize_model_gptq(jp, jc, jnp.asarray(calib), groupsize=32, batch=4, actorder=actorder,
                                  host_spill=host_spill)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    before = {k: v.clone() for k, v in tree_leaves(params).items()}
    got = tg.quantize_model_gptq(params, LLaMAConfig(**TINY), calib, groupsize=32, batch=4, actorder=actorder,
                                 host_spill=host_spill)
    _leaves_close(want, got, f"host_spill={host_spill} actorder={actorder}", levels=not actorder)
    for k, v in tree_leaves(params).items():  # the input tree is left as it was
        assert torch.equal(v, before[k]), k
    if actorder:
        qcfg = dict(TINY, quantize="int4", quant_groupsize=32)
        dense = np.asarray(jforward(jp, jnp.asarray(calib), jc)[0])
        lj = np.asarray(jforward(want, jnp.asarray(calib), JaxConfig(**qcfg))[0])
        lt = llama.forward(got, torch.from_numpy(calib).long(), LLaMAConfig(**qcfg))[0].numpy()
        ratio = np.linalg.norm(lt - dense) / np.linalg.norm(lj - dense)
        assert abs(ratio - 1.0) <= QUALITY_SHARE, ratio


def test_gptq_tree_carries_across(tiny_model):
    """A JAX GPTQ tree, device leaves and the spilled numpy leaves alike,
    through ``params_from_numpy``: the port's forward gives JAX's logits."""
    jc, jp, calib = tiny_model
    tokens = np.random.default_rng(6).integers(0, TINY["vocab_size"], size=(2, 24)).astype(np.int32)
    qc = jc.replace(quantize="int4", quant_groupsize=32)
    for spill in (False, True):
        jq = jg.quantize_model_gptq(jp, jc, jnp.asarray(calib), groupsize=32, batch=4, host_spill=spill)
        tree = jax.tree_util.tree_map(np.asarray, jq)
        assert spill == isinstance(jq["lm_head"]["qw"], np.ndarray)
        want = np.asarray(jforward(jq, jnp.asarray(tokens), qc)[0])
        tp = params_from_numpy(tree, device="cpu")
        assert set(tp["h"]["attn"]["c_attn"]) == {"qw", "qscale", "qzero"}
        got = llama.forward(tp, torch.from_numpy(tokens).long(), LLaMAConfig(**TINY, quantize="int4",
                                                                            quant_groupsize=32))[0]
        assert _rel(got.numpy(), want) <= REL


def test_stages_match_jax(tiny_model):
    """The tapped block forward (every stage's input to its linear) against
    JAX's on one layer, dense and after quantization."""
    jc, jp, _ = tiny_model
    T = 16
    x = np.random.default_rng(7).normal(size=(2, T, TINY["n_embd"])).astype(np.float32)
    jlp = jax.tree_util.tree_map(lambda a: a[1], jp["h"])
    from lit_llama_tpu.ops.rope import build_rope_cache as jrope

    jmask = jnp.tril(jnp.ones((T, T), bool))[None, None]
    want_x, want_taps = jg._attn_forward_tapped(jlp, jnp.asarray(x), jrope(TINY["block_size"], 16)[:T], jmask, jc)
    lp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jlp), device="cpu")
    rope = build_rope_cache(TINY["block_size"], 16)[:T]
    mask = torch.ones(T, T, dtype=torch.bool).tril()
    got_x, got_taps = tg._attn_forward_tapped(lp, torch.from_numpy(x), rope, mask, LLaMAConfig(**TINY))
    assert _rel(got_x.numpy(), want_x) <= REL
    assert sorted(got_taps) == sorted(want_taps)
    for k in want_taps:
        assert _rel(got_taps[k].numpy(), want_taps[k]) <= REL, k
    y = tg._stage_attn(lp, got_taps["attn.c_attn"], rope, mask, LLaMAConfig(**TINY))
    assert _rel(y.numpy(), want_taps["attn.c_proj"]) <= REL


GPTQ_SHAPES = [(4096, 12288), (4096, 4096), (4096, 11008), (11008, 4096)]  # c_attn, c_proj, c_fc1/2, mlp.c_proj


@pytest.mark.parametrize("K,N", GPTQ_SHAPES)
def test_k3_f32_at_the_calibration_shapes(cuda, K, N):
    """K3 in f32 at M = 2048 (one calibration sample of 2048 tokens) on the
    five 7B linears, as GPTQ's stages B-E run it, against its plain version
    (f32 sums in another order: chip_smoke.py's TOL_F32)."""
    g = torch.Generator().manual_seed(K + N)
    w = quantize_int4(torch.randn(K, N, generator=g) * 0.02, groupsize=128)
    x = torch.randn(2048, K, generator=g).to(cuda)
    args = (x, w["qw"].to(cuda), w["qscale"].to(cuda), w["qzero"].to(cuda), torch.float32)
    before = tqm.matmul_int4.launches
    got = tqm.matmul_int4(*args)
    assert tqm.matmul_int4.launches == before + 1
    want = tqm.matmul_int4_ref(*args)
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all(), float((got - want).abs().max())


def test_k4_f32_at_the_calibration_shape(cuda):
    """K4 in f32 at (1, 32, 2048, 128), GPTQ's stage B on one sample, against
    its plain version."""
    g = torch.Generator().manual_seed(8)
    q, k, v = (torch.randn(1, 32, 2048, 128, generator=g).to(cuda) for _ in range(3))
    before = fa.flash_attention.launches
    o, lse = fa.flash_attention(q, k, v)
    assert fa.flash_attention.launches == before + 1
    ro, rlse = fa.flash_attention_ref(q, k, v)
    assert ((o - ro).abs() <= 1e-4 + 1e-4 * ro.abs()).all(), float((o - ro).abs().max())
    assert ((lse - rlse).abs() <= 1e-4 + 1e-4 * rlse.abs()).all()


@pytest.mark.parametrize("host_spill", [False, True])
def test_quantize_model_gptq_card_matches_plain(cuda, host_spill):
    """The 3-layer model at width 256 on the card, kernel path (K3 and K4 in
    f32) against plain path. The first linear's input passes no kernel, so
    its leaves are the same bits; after it, f32 sums in another order move
    the Hessians by rounding, which reorders levels (chip_smoke.py phase 22
    reads 0-26 % at 7B width with equal objectives), so the model is held as
    the actorder case of ``test_quantize_model_gptq_matches_jax`` holds it:
    its logits' distance from the dense model's within ``QUALITY_SHARE``.
    Spilling, the quantized leaves land on the host while the later stages
    run through their copies on the card."""
    cfg = LLaMAConfig(block_size=256, vocab_size=512, n_layer=3, n_head=2, n_embd=256)
    params = llama.init_params(cfg, torch.Generator(device=cuda).manual_seed(9), device=cuda)
    calib = np.random.default_rng(9).integers(0, 512, size=(4, 256))
    out = {plain: tg.quantize_model_gptq(params, cfg, calib, groupsize=128, batch=2, plain=plain,
                                         host_spill=host_spill) for plain in (False, True)}
    want_dev = "cpu" if host_spill else "cuda"
    assert all(out[False]["h"]["mlp"]["c_proj"][k].device.type == want_dev for k in ("qw", "qscale", "qzero"))
    assert out[False]["lm_head"]["qw"].device.type == want_dev
    for k in ("qw", "qscale", "qzero"):
        assert torch.equal(out[False]["h"]["attn"]["c_attn"][k][0], out[True]["h"]["attn"]["c_attn"][k][0]), k
    tokens = torch.from_numpy(calib).to(cuda)
    qcfg = cfg.replace(quantize="int4", quant_groupsize=128)
    dense = llama.forward(params, tokens, cfg, plain=True)[0]
    dist = {}
    for plain, tree in out.items():
        dist[plain] = float((llama.forward(_to(tree, cuda), tokens, qcfg, plain=True)[0] - dense).norm())
    assert abs(dist[False] / dist[True] - 1.0) <= QUALITY_SHARE, dist


def _to(node, dev):
    return {k: _to(v, dev) for k, v in node.items()} if isinstance(node, dict) else node.to(dev)
