"""The slice end to end on the CPU against the JAX package: forward logits
(no cache, prefill from zero, continuing chunks and the slot_pos serving step),
and greedy generate tokens identical to
JAX generate on the same prepared weights, past the cache."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lit_llama_tpu import LLaMAConfig, init_params
from lit_llama_tpu.models import generate as jgen
from lit_llama_tpu.models import llama as jllama
from lit_llama_tpu.ops import fused_layer as jfl
from lit_llama_tpu_torch.models import config as tcfg
from lit_llama_tpu_torch.models import generate as tgen
from lit_llama_tpu_torch.models import llama as tllama
from lit_llama_tpu_torch.utils.jax_params import params_from_numpy


def _port_config(cfg):
    return tcfg.LLaMAConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                               if f.name not in ("lora", "adapter")})


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def model():
    cfg = LLaMAConfig(block_size=256, vocab_size=128, n_layer=2, n_head=4, n_embd=512,
                      quantize="int4", quant_groupsize=128)
    dense = init_params(cfg.replace(quantize=None), jax.random.PRNGKey(0))
    stacked = jllama.quantize_params(dense, cfg)
    fparams, fcfg = jfl.prepare_fused_params(jllama.unstack_layers(stacked), cfg)
    return cfg, stacked, fparams, fcfg


def test_forward_no_cache_matches(model):
    """Stacked int4 layers, interleaved RoPE, causal over the tokens."""
    cfg, stacked, _, _ = model
    toks = np.asarray([[3, 17, 42, 99, 7, 1, 64]], np.int32)
    want, _ = jllama.forward(stacked, jnp.asarray(toks), cfg)
    got, cache = tllama.forward(
        params_from_numpy(_np(stacked), device="cpu"), torch.from_numpy(toks).long(), _port_config(cfg)
    )
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("T", [1, 6, 130])
def test_prefill_from_zero_matches(model, T):
    _, _, fparams, fcfg = model
    S = 160
    toks = np.random.default_rng(T).integers(0, 128, size=(1, T)).astype(np.int32)
    jcache = jllama.unstack_kv_cache(jllama.init_kv_cache(fcfg, 1, S, jnp.float32))
    want, jnew = jllama.forward(
        fparams, jnp.asarray(toks), fcfg, input_pos=jnp.arange(T), kv_cache=jcache,
        prefill_from_zero=True,
    )
    tc = _port_config(fcfg)
    tcache = tllama.init_kv_cache(tc, 1, S, device="cpu")
    got, tnew = tllama.forward(
        params_from_numpy(_np(fparams), device="cpu"), torch.from_numpy(toks).long(), tc,
        kv_cache=tcache, prefill_from_zero=True,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    for j in range(fcfg.n_layer):
        np.testing.assert_allclose(tnew[j]["k"].numpy(), np.asarray(jnew[j]["k"]), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tnew[j]["v"].numpy(), np.asarray(jnew[j]["v"]), rtol=1e-4, atol=1e-4)


def test_generate_greedy_identical_past_the_cache(model):
    """S = 16 and 32 new tokens: the ring cache wraps twice."""
    _, _, fparams, fcfg = model
    prompt = np.asarray([5, 23, 81, 2, 40], np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = jgen.generate(fparams, prompt, 32, config=fcfg, max_seq_length=16, temperature=0.0)
    got = tgen.generate(
        params_from_numpy(_np(fparams), device="cpu"), prompt, 32, config=_port_config(fcfg),
        max_seq_length=16, temperature=0.0, device="cpu",
    )
    assert got.tolist() == np.asarray(want).tolist()


def test_generate_eos_and_sampling(model):
    _, _, fparams, fcfg = model
    params = params_from_numpy(_np(fparams), device="cpu")
    tc = _port_config(fcfg)
    prompt = [5, 23, 81]
    full = tgen.generate(params, prompt, 6, config=tc, temperature=0.0, device="cpu")
    eos = int(full[-1])
    first = len(prompt) + full[len(prompt):].tolist().index(eos)
    stopped = tgen.generate(params, prompt, 6, config=tc, temperature=0.0, eos_id=eos, device="cpu")
    assert stopped.tolist() == full[: first + 1].tolist()
    g = torch.Generator().manual_seed(0)
    sampled = tgen.generate(params, prompt, 6, config=tc, temperature=0.8, top_k=5,
                            generator=g, device="cpu")
    assert sampled.shape == (9,) and int(sampled.max()) < tc.padded_vocab_size
    for cfg, t_new, s in ((fcfg, 72, None), (fcfg, 264, None), (fcfg, 80, 2048), (fcfg, 20, None)):
        assert tgen.plan_seq_length(_port_config(cfg), t_new, s) == jgen.plan_seq_length(cfg, t_new, s)


def _filled_caches(fcfg, B, S, seed):
    """The same random cache content for both sides (f32)."""
    rng = np.random.default_rng(seed)
    shape = (B, fcfg.n_head, S, fcfg.head_size)
    layers = [{n: (rng.normal(size=shape) * 0.3).astype(np.float32) for n in ("k", "v")}
              for _ in range(fcfg.n_layer)]
    jcache = tuple({n: jnp.asarray(a) for n, a in kv.items()} for kv in layers)
    from lit_llama_tpu_torch.utils.jax_params import cache_from_numpy

    return jcache, cache_from_numpy(layers, device="cpu")


def _assert_caches_close(tnew, jnew, n_layer):
    for j in range(n_layer):
        np.testing.assert_allclose(tnew[j]["k"].numpy(), np.asarray(jnew[j]["k"]), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tnew[j]["v"].numpy(), np.asarray(jnew[j]["v"]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("positions", [[0, 5, 31], [32 + 7, 3, 63 + 32, 300]])
def test_forward_slot_pos_matches(model, positions):
    """Continuous-batching step: each slot at its own position, one past the
    cache (ring write) and one past block_size (the rope row clips). The port
    runs its fused block halves' plain versions; the JAX side its XLA blocks,
    which compute the function the serving kernels are held to."""
    _, _, fparams, fcfg = model
    B, S = len(positions), 32
    jcache, tcache = _filled_caches(fcfg, B, S, B)
    toks = np.random.default_rng(B).integers(0, 128, size=(B, 1)).astype(np.int32)
    want, jnew = jllama.forward(fparams, jnp.asarray(toks), fcfg,
                                slot_pos=jnp.asarray(positions, jnp.int32), kv_cache=jcache)
    tc = _port_config(fcfg)
    tparams = params_from_numpy(_np(fparams), device="cpu")
    got, tnew = tllama.forward(tparams, torch.from_numpy(toks).long(), tc,
                               slot_pos=torch.tensor(positions, dtype=torch.int32), kv_cache=tcache)
    assert tnew is tcache  # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    _assert_caches_close(tnew, jnew, fcfg.n_layer)
    # layers the fused halves do not take (interleaved rope) go through the plain block
    plain_got, _ = tllama.forward(tparams, torch.from_numpy(toks).long(), tc,
                                  slot_pos=torch.tensor(positions), kv_cache=_filled_caches(fcfg, B, S, B)[1],
                                  plain=True)
    np.testing.assert_allclose(plain_got.numpy(), got.numpy(), rtol=1e-5, atol=1e-5)


def test_forward_slot_pos_plain_block_matches(model):
    """Stacked interleaved-rope int4 layers are not the fused layout: the
    slot_pos step takes the plain block, per-slot write and mask."""
    cfg, stacked, _, _ = model
    positions, S = [4, 0, 9 + 16], 16
    jcache, tcache = _filled_caches(cfg, 3, S, 9)
    toks = np.asarray([[3], [17], [42]], np.int32)
    want, jnew = jllama.forward(jllama.unstack_layers(stacked), jnp.asarray(toks), cfg,
                                slot_pos=jnp.asarray(positions, jnp.int32), kv_cache=jcache)
    got, tnew = tllama.forward(tllama.unstack_layers(params_from_numpy(_np(stacked), device="cpu")),
                               torch.from_numpy(toks).long(), _port_config(cfg),
                               slot_pos=torch.tensor(positions), kv_cache=tcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    _assert_caches_close(tnew, jnew, cfg.n_layer)


@pytest.mark.parametrize("start,T", [(6, 5), (27, 5), (9, 1), (32, 1), (40, 1)])
def test_forward_input_pos_matches(model, start, T):
    """A continuing chunk (T > 1, up to the cache's end) and single tokens:
    inside the cache, and at and past its length S = 32, where the cache rolls
    one row left and the token lands on the last row."""
    _, _, fparams, fcfg = model
    S = 32
    jcache, tcache = _filled_caches(fcfg, 1, S, start)
    toks = np.random.default_rng(start).integers(0, 128, size=(1, T)).astype(np.int32)
    want, jnew = jllama.forward(fparams, jnp.asarray(toks), fcfg,
                                input_pos=jnp.arange(start, start + T), kv_cache=jcache)
    got, tnew = tllama.forward(params_from_numpy(_np(fparams), device="cpu"), torch.from_numpy(toks).long(),
                               _port_config(fcfg), input_pos=torch.arange(start, start + T), kv_cache=tcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    _assert_caches_close(tnew, jnew, fcfg.n_layer)


def test_forward_with_cache_needs_a_mode(model):
    _, _, fparams, fcfg = model
    tc = _port_config(fcfg)
    params = params_from_numpy(_np(fparams), device="cpu")
    cache = tllama.init_kv_cache(tc, 1, 16, device="cpu")
    toks = torch.zeros((1, 3), dtype=torch.long)
    with pytest.raises(ValueError):
        tllama.forward(params, toks, tc, kv_cache=cache)
    with pytest.raises(ValueError):
        tllama.forward(params, toks, tc, kv_cache=cache, input_pos=[3, 5, 6])
    with pytest.raises(ValueError):
        tllama.forward(params, toks, tc, kv_cache=cache, input_pos=[14, 15, 16])
    with pytest.raises(ValueError):
        tllama.forward(params, toks, tc, kv_cache=cache, slot_pos=torch.zeros(1, dtype=torch.int32))


# ---- the per-op decode path: int8 weights, dense weights, the int8 KV cache ----


@pytest.fixture(scope="module")
def per_op_models():
    """{name: (JAX config, JAX params)}: int8 weights in the inference layout
    (unstacked, interleaved RoPE) and dense f32 weights, stacked."""
    cfg = LLaMAConfig(block_size=64, vocab_size=128, n_layer=2, n_head=4, n_embd=128)
    dense = init_params(cfg, jax.random.PRNGKey(1))
    c8 = cfg.replace(quantize="int8")
    return {"int8": (c8, jllama.unstack_layers(jllama.quantize_params(dense, c8))), "dense": (cfg, dense)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_byte_identical(rng, dtype):
    x = rng.normal(size=(2, 4, 5, 32)).astype(np.float32)
    x[0, 1, 2] = 0.0  # an all-zero row: the scale floor 1e-12
    x[1, 0, 3, 7] = 2.5 * 127  # a row whose scale is exact, with values on .5 boundaries
    x[1, 0, 3, :4] = [2.5 * 0.5, 2.5 * 1.5, -2.5 * 2.5, 2.5 * 126.5]
    jq, js = jllama._quantize_kv(jnp.asarray(x).astype(jnp.dtype(dtype)))
    tq, ts = tllama._quantize_kv(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == (2, 4, 5, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _assert_int8_caches_match(tcache, jcache):
    """Scales to f32 rounding; int8 rows equal but for a value that sits on a
    rounding boundary (x / scale within an f32 ulp of .5): off by one at most,
    in fewer than 1 in 1000."""
    for tkv, jkv in zip(tcache, jcache):
        for name in ("ks", "vs"):
            np.testing.assert_allclose(tkv[name].numpy(), np.asarray(jkv[name]), rtol=1e-5, atol=1e-9)
        for name in ("k", "v"):
            assert tkv[name].dtype == torch.int8
            diff = np.abs(tkv[name].numpy().astype(np.int32) - np.asarray(jkv[name]).astype(np.int32))
            assert diff.max() <= 1 and (diff != 0).mean() < 1e-3, (name, diff.max(), (diff != 0).mean())


@pytest.mark.parametrize("kind", ["int8", "dense"])
def test_forward_int8_cache_matches(per_op_models, kind):
    """Logits and cache contents against JAX ``forward`` with
    ``kv_cache_dtype="int8"``: a prefill from zero, a continuing chunk, single
    tokens inside the cache and three past its length S = 12 (roll-left of all
    four arrays). f32 compute; the JAX side dequantizes the whole cache and
    runs the masked attention, the port folds the scales (K5's plain version):
    logits to 5e-4 (the int8 rows may differ by one step in a rare entry)."""
    cfg, jparams = per_op_models[kind]
    cfg = cfg.replace(kv_cache_dtype="int8")
    tc = _port_config(cfg)
    tparams = params_from_numpy(_np(jparams), device="cpu")
    S = 12
    jcache = jllama.init_kv_cache(cfg, 1, S)
    if kind == "int8":
        jcache = jllama.unstack_kv_cache(jcache)
    tcache = tllama.init_kv_cache(tc, 1, S, device="cpu")
    assert set(tcache[0]) == {"k", "v", "ks", "vs"} and tcache[0]["ks"].shape == (1, 4, S, 1)
    toks = np.random.default_rng(7).integers(0, 128, size=(1, 18)).astype(np.int32)
    steps = [(0, 6, True), (6, 3, False)] + [(p, 1, False) for p in range(9, 15)]
    for start, T, from_zero in steps:
        chunk = toks[:, start : start + T]
        want, jcache = jllama.forward(jparams, jnp.asarray(chunk), cfg, input_pos=jnp.arange(start, start + T),
                                      kv_cache=jcache, prefill_from_zero=from_zero)
        mode = dict(prefill_from_zero=True) if from_zero else dict(input_pos=list(range(start, start + T)))
        got, tcache = tllama.forward(tparams, torch.from_numpy(chunk).long(), tc, kv_cache=tcache, **mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4, atol=5e-4, err_msg=f"start {start}")
        jlayers = jcache if kind == "int8" else jllama.unstack_kv_cache(jcache)
        _assert_int8_caches_match(tcache, jlayers)


def test_cache_from_numpy_carries_int8_cache(per_op_models):
    from lit_llama_tpu_torch.utils.jax_params import cache_from_numpy

    cfg = per_op_models["int8"][0].replace(kv_cache_dtype="int8")
    jcache = jllama.unstack_kv_cache(jllama.init_kv_cache(cfg, 2, 8))
    layers = cache_from_numpy(_np(jcache), device="cpu")
    assert len(layers) == cfg.n_layer and layers[0]["k"].dtype == torch.int8
    assert layers[0]["vs"].shape == (2, 4, 8, 1) and layers[0]["vs"].dtype == torch.float32
    with pytest.raises(ValueError):
        cache_from_numpy([{"k": np.zeros((1, 1, 2, 4), np.float32)}], device="cpu")
    with pytest.raises(ValueError):  # float rows beside scales
        cache_from_numpy([{n: np.zeros((1, 1, 2, 4), np.float32) for n in ("k", "v", "ks", "vs")}], device="cpu")


# (weights, KV cache dtype, new tokens, S): the default S, and S = 16 with 32
# new tokens, where the cache rolls left from the 17th position on
@pytest.mark.parametrize("kind,kv,new,S", [("int8", None, 12, None), ("dense", None, 12, None),
                                           ("int8", None, 32, 16), ("int8", "int8", 32, 16)])
def test_generate_per_op_greedy_identical(per_op_models, kind, kv, new, S):
    """Params that are not the prepared int4 layout decode per op, as in the
    JAX ``generate``: greedy tokens are identical."""
    cfg, jparams = per_op_models[kind]
    cfg = cfg.replace(kv_cache_dtype=kv)
    prompt = np.asarray([5, 23, 81, 2, 40], np.int32)
    want = jgen.generate(jparams, prompt, new, config=cfg, max_seq_length=S, temperature=0.0)
    got = tgen.generate(params_from_numpy(_np(jparams), device="cpu"), prompt, new, config=_port_config(cfg),
                        max_seq_length=S, temperature=0.0, device="cpu")
    assert got.tolist() == np.asarray(want).tolist()
