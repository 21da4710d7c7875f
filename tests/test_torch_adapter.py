"""LLaMA-Adapter v1 and v2 in the port against the JAX package on the CPU:
the prefix attention, ``forward`` with an adapter (no cache, prefill, the
per-op decode step, a continuing chunk and the slot path), the gates that
keep adapter models off the fused kernels, the trainable mask and the
checkpoint sub-tree, the reference-format state dict (new and old gates, v2)
and the leaves carried across by ``params_from_numpy``.

n_layer 3 with the default start layer 2, so one layer is active and two are
not; ``gating`` is drawn non-zero (at its zero init the prefix term vanishes
and every check would pass without it)."""

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
from lit_llama_tpu.models.config import AdapterConfig
from lit_llama_tpu.ops import fused_layer as jfl
from lit_llama_tpu.peft import adapter as jadapter
from lit_llama_tpu.utils import convert as jconvert
from lit_llama_tpu_torch.models import config as tcfg
from lit_llama_tpu_torch.models import generate as tgen
from lit_llama_tpu_torch.models import llama as tllama
from lit_llama_tpu_torch.ops import fused_layer as tfl
from lit_llama_tpu_torch.peft import adapter as tadapter
from lit_llama_tpu_torch.utils import convert as tconvert
from lit_llama_tpu_torch.utils.checkpoint import tree_leaves
from lit_llama_tpu_torch.utils.jax_params import params_from_numpy


def port_config(cfg):
    """The JAX config as the port's, the adapter included."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name not in ("lora", "adapter")}
    if cfg.adapter is not None:
        kw["adapter"] = tcfg.AdapterConfig(**dataclasses.asdict(cfg.adapter))
    return tcfg.LLaMAConfig(**kw)


def to_port(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def _adapter_params(cfg, seed=0):
    """JAX params with the adapter leaves, the gates and v2's bias and scale
    drawn away from their init so that every term shows."""
    params = init_params(cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)
    h = params["h"]
    h["gating"] = jnp.asarray(rng.normal(size=h["gating"].shape) * 2.0, h["gating"].dtype)
    h["adapter_wte"] = jnp.asarray(rng.normal(size=h["adapter_wte"].shape), h["adapter_wte"].dtype)
    if cfg.adapter.v2:
        nodes = [h["attn"]["c_attn"], h["attn"]["c_proj"], h["mlp"]["c_fc1"], h["mlp"]["c_fc2"], h["mlp"]["c_proj"],
                 params["lm_head"]]
        for node in nodes:
            node["av2_bias"] = jnp.asarray(rng.normal(size=node["av2_bias"].shape) * 0.02, node["av2_bias"].dtype)
            node["av2_scale"] = jnp.asarray(1 + rng.normal(size=node["av2_scale"].shape) * 0.05,
                                            node["av2_scale"].dtype)
    return params


def _cfg(v2, dtype="float32"):
    return LLaMAConfig(block_size=64, vocab_size=128, n_layer=3, n_head=2, n_embd=256, param_dtype=dtype,
                       compute_dtype=dtype, adapter=AdapterConfig(v2=v2))


@pytest.fixture(scope="module", params=[False, True], ids=["v1", "v2"])
def adapter_model(request):
    cfg = _cfg(request.param)
    return cfg, _adapter_params(cfg)


# JAX forward compiled once per shape: faster here than its eager ops
jforward = jax.jit(jllama.forward, static_argnums=(2,), static_argnames=("prefill_from_zero",))


def _rel_err(got, want):
    return float(np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32)).max() / np.abs(want).max())


def test_prefix_attention_matches_jax():
    """One layer's prefix term on random q and y, gate non-zero, active."""
    cfg = _cfg(False)
    params = _adapter_params(cfg, seed=3)
    jlp = jax.tree_util.tree_map(lambda a: a[2], params["h"])  # layer 2: the first active one
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, cfg.n_head, 5, cfg.head_size)).astype(np.float32)
    y = rng.normal(size=q.shape).astype(np.float32)
    want, _ = jadapter.prefix_attention(jlp, jnp.asarray(q), jnp.asarray(y), cfg, None, None)
    got = tadapter.prefix_attention(to_port(jlp), torch.from_numpy(q), torch.from_numpy(y), port_config(cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert float(np.abs(np.asarray(want) - y).max()) > 1e-2  # the term is there
    # layer 0 lies below the start layer: y comes back as it is
    lp0 = to_port(jax.tree_util.tree_map(lambda a: a[0], params["h"]))
    torch.testing.assert_close(tadapter.prefix_attention(lp0, torch.from_numpy(q), torch.from_numpy(y),
                                                         port_config(cfg)), torch.from_numpy(y))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(adapter_model, dtype):
    """No cache, stacked layers: f32 to 1e-5 of max |logit|; bf16 to 3e-2
    (the model tests' bf16 tolerance), here relative to max |logit|, since
    this model's logits are small (|v| < 0.3). Without the adapter leaves the
    logits move by a tenth of max |logit| (v1; more with v2)."""
    cfg, params = adapter_model
    cfg = cfg.replace(param_dtype=dtype, compute_dtype=dtype)
    params = jax.tree_util.tree_map(lambda a: a.astype(dtype), params)
    toks = np.asarray([[3, 17, 42, 99, 7, 1, 64], [5, 6, 7, 8, 9, 10, 11]], np.int32)
    want, _ = jforward(params, jnp.asarray(toks), cfg)
    tparams = to_port(params)
    got, _ = tllama.forward(tparams, torch.from_numpy(toks).long(), port_config(cfg))
    want = np.asarray(want, np.float32)
    assert _rel_err(got.float().numpy(), want) <= (1e-5 if dtype == "float32" else 3e-2)
    base, _ = tllama.forward(tparams, torch.from_numpy(toks).long(), port_config(cfg.replace(adapter=None)))
    assert _rel_err(base.float().numpy(), got.float().numpy()) > 0.08


def test_cached_paths_match_jax(adapter_model):
    """Unstacked layers: a prefill from zero, a continuing chunk, per-op
    decode steps (one past the cache: the roll) and the slot path, each
    against JAX ``forward``, f32, to 1e-5 of max |logit|."""
    cfg, params = adapter_model
    tc = port_config(cfg)
    jp = jllama.unstack_layers(params)
    tp = to_port(jp)
    S = 16
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 128, size=(1, 9)).astype(np.int32)
    jcache = jllama.unstack_kv_cache(jllama.init_kv_cache(cfg, 1, S, jnp.float32))
    tcache = tllama.init_kv_cache(tc, 1, S, device="cpu")
    want, jcache = jforward(jp, jnp.asarray(toks[:, :6]), cfg, input_pos=jnp.arange(6), kv_cache=jcache,
                                  prefill_from_zero=True)
    got, _ = tllama.forward(tp, torch.from_numpy(toks[:, :6]).long(), tc, kv_cache=tcache, prefill_from_zero=True)
    assert _rel_err(got.numpy(), np.asarray(want)) <= 1e-5
    want, jcache = jforward(jp, jnp.asarray(toks[:, 6:]), cfg, input_pos=jnp.arange(6, 9), kv_cache=jcache)
    got, _ = tllama.forward(tp, torch.from_numpy(toks[:, 6:]).long(), tc, input_pos=[6, 7, 8], kv_cache=tcache)
    assert _rel_err(got.numpy(), np.asarray(want)) <= 1e-5
    for pos in (9, S - 1, S, S + 1):  # from S on the cache rolls
        step = rng.integers(0, 128, size=(1, 1)).astype(np.int32)
        want, jcache = jforward(jp, jnp.asarray(step), cfg, input_pos=jnp.asarray([pos]), kv_cache=jcache)
        got, _ = tllama.forward(tp, torch.from_numpy(step).long(), tc, input_pos=[pos], kv_cache=tcache)
        assert _rel_err(got.numpy(), np.asarray(want)) <= 1e-5, pos
    positions = [0, 5, S + 3]
    B = len(positions)
    cache_np = [{n: (rng.normal(size=(B, cfg.n_head, S, cfg.head_size)) * 0.3).astype(np.float32)
                 for n in ("k", "v")} for _ in range(cfg.n_layer)]
    step = rng.integers(0, 128, size=(B, 1)).astype(np.int32)
    want, _ = jforward(jp, jnp.asarray(step), cfg, slot_pos=jnp.asarray(positions, jnp.int32),
                             kv_cache=tuple({n: jnp.asarray(a) for n, a in kv.items()} for kv in cache_np))
    from lit_llama_tpu_torch.utils.jax_params import cache_from_numpy

    got, _ = tllama.forward(tp, torch.from_numpy(step).long(), tc, slot_pos=torch.tensor(positions, dtype=torch.int32),
                            kv_cache=cache_from_numpy(cache_np, device="cpu"))
    assert _rel_err(got.numpy(), np.asarray(want)) <= 1e-5


@pytest.fixture(scope="module")
def fused_adapter():
    """An int4 model with adapter leaves, as loaded (per layer, interleaved
    rope) and as prepared for the fused paths (half rotation, c_fc12): what
    the gates must keep off the kernels."""
    cfg = LLaMAConfig(block_size=128, vocab_size=128, n_layer=3, n_head=4, n_embd=512, quantize="int4",
                      quant_groupsize=128)
    dense = init_params(cfg.replace(quantize=None), jax.random.PRNGKey(1))
    loaded = jllama.unstack_layers(jllama.quantize_params(dense, cfg))
    fparams, fcfg = jfl.prepare_fused_params(loaded, cfg)
    extra = _adapter_params(cfg.replace(quantize=None, adapter=AdapterConfig()), seed=2)["h"]

    def with_adapter(params):
        return dict(params, h=tuple(dict(lp, adapter_wte=extra["adapter_wte"][i], gating=extra["gating"][i],
                                         adapter_active=extra["adapter_active"][i])
                                    for i, lp in enumerate(params["h"])))

    return (with_adapter(loaded), cfg.replace(adapter=AdapterConfig()), with_adapter(fparams), fcfg,
            fcfg.replace(adapter=AdapterConfig()))


def test_adapter_keeps_off_the_fused_kernels(fused_adapter, monkeypatch):
    """With ``config.adapter`` the fused decode step (K1, K2), the serving
    halves (K7, K8, K9) and their plain versions are never called, even on
    params prepared for them. Greedy tokens equal JAX ``generate``'s on the
    loaded params (it decodes per op; given prepared params its fused step
    would drop the prefix term, ROADMAP queue 3), and the slot step's logits
    equal JAX ``forward``'s, which gates the serving halves."""
    jloaded, lcfg, jp, fcfg, acfg = fused_adapter
    tp, tc = to_port(jp), port_config(acfg)
    assert tfl.use_serve_fused(port_config(fcfg), tp["h"][0], batch=4)
    assert not tfl.use_serve_fused(tc, tp["h"][0], batch=4)
    assert not tfl.fused_layer_supported(port_config(lcfg), to_port(jloaded))

    def refuse(*a, **k):
        raise AssertionError("an adapter model reached a fused kernel's entry")

    for name in ("decode_layers_fused", "lm_head_fused", "block_head_fused", "block_tail_fused"):
        monkeypatch.setattr(tfl, name, refuse)
    monkeypatch.setattr(tllama, "_block_slot_fused", refuse)
    prompt = [3, 17, 42, 99, 7]
    with pltpu.force_tpu_interpret_mode():
        want = jgen.generate(jloaded, jnp.asarray(prompt, jnp.int32), 8, config=lcfg, temperature=0.0)
    got = tgen.generate(tp, prompt, 8, config=tc, temperature=0.0, device="cpu")
    assert got.tolist() == np.asarray(want).tolist()
    S, positions = 16, [2, 9]
    rng = np.random.default_rng(6)
    cache_np = [{n: (rng.normal(size=(2, acfg.n_head, S, acfg.head_size)) * 0.3).astype(np.float32)
                 for n in ("k", "v")} for _ in range(acfg.n_layer)]
    step = np.asarray([[5], [9]], np.int32)
    want, _ = jforward(jp, jnp.asarray(step), acfg, slot_pos=jnp.asarray(positions, jnp.int32),
                             kv_cache=tuple({n: jnp.asarray(a) for n, a in kv.items()} for kv in cache_np))
    from lit_llama_tpu_torch.utils.jax_params import cache_from_numpy

    got, _ = tllama.forward(tp, torch.from_numpy(step).long(), tc, slot_pos=torch.tensor(positions, dtype=torch.int32),
                            kv_cache=cache_from_numpy(cache_np, device="cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("v2", [False, True])
def test_mask_and_state_match_jax(v2):
    cfg = _cfg(v2)
    params = _adapter_params(cfg)
    tparams = to_port(params)
    jmask = jax.tree_util.tree_map(bool, jadapter.trainable_mask(params, v2=v2))
    tmask = tadapter.trainable_mask(tparams, v2=v2)
    assert tree_leaves(tmask) == tree_leaves(jmask)
    want = tree_leaves(jax.tree_util.tree_map(np.asarray, jadapter.adapter_state(params, v2=v2)))
    got = tree_leaves(tadapter.adapter_state(tparams, v2=v2))
    assert sorted(got) == sorted(want) == sorted(n for n, m in tree_leaves(jmask).items() if m)
    for n, a in want.items():
        np.testing.assert_array_equal(got[n].numpy(), a)
    assert ("h/adapter_active" in got) is False
    # overlaying the state on fresh leaves gives the trained model back; the base tree is left as it was
    fresh = tadapter.add_adapter_params(to_port(init_params(cfg.replace(adapter=None), jax.random.PRNGKey(0))),
                                        port_config(cfg))
    before = {n: t.clone() for n, t in tree_leaves(fresh).items()}
    back = tadapter.load_adapter_state(fresh, got)
    for n, t in tree_leaves(back).items():
        torch.testing.assert_close(t, tree_leaves(tparams)[n], rtol=0, atol=0)
    for n, t in tree_leaves(fresh).items():
        assert torch.equal(t, before[n]), n


def test_add_adapter_params_layout():
    """Shapes, dtypes and init of the port's leaves equal JAX's (the prompt's
    values come from another generator: normal(0, 0.02) in both)."""
    for v2 in (False, True):
        cfg = _cfg(v2, "bfloat16")
        want = tree_leaves(jax.tree_util.tree_map(np.asarray, init_params(cfg, jax.random.PRNGKey(0))))
        got = tree_leaves(tllama.init_params(port_config(cfg), torch.Generator().manual_seed(0), device="cpu"))
        assert sorted(got) == sorted(want)
        for n, a in want.items():
            assert tuple(got[n].shape) == a.shape and got[n].dtype == torch.bfloat16, n
            if "adapter_wte" not in n and "/w" not in n and n != "wte":
                np.testing.assert_array_equal(got[n].float().numpy(), a.astype(np.float32), err_msg=n)
        wte = got["h/adapter_wte"].float()
        assert 0.015 < float(wte.std()) < 0.025 and abs(float(wte.mean())) < 2e-3


def _reference_sd(cfg, v2, scalar_gate, seed=0):
    """A reference-format adapter state dict: entries on the layers from the
    start layer on, gates (1, H, 1, 1) or one scalar, v2's per-linear bias and
    scale (no entry for mlp.c_fc2 on layer 2: it falls back to 0 and 1) and
    norm weights."""
    rng = np.random.default_rng(seed)
    D, H, L = cfg.n_embd, cfg.n_head, cfg.n_layer
    sd = {}
    for i in range(2, L):
        sd[f"transformer.h.{i}.attn.adapter_wte.weight"] = torch.from_numpy(rng.normal(size=(10, D)).astype(np.float32))
        g = rng.normal(size=(1,) if scalar_gate else (1, H, 1, 1)).astype(np.float32)
        sd[f"transformer.h.{i}.attn.gating_factor"] = torch.from_numpy(g)
    if v2:
        I = cfg.intermediate_size
        for i in range(L):
            for name, width in (("attn.c_attn", 3 * D), ("attn.c_proj", D), ("mlp.c_fc1", I), ("mlp.c_fc2", I),
                                ("mlp.c_proj", D)):
                if (i, name) == (2, "mlp.c_fc2"):
                    continue
                sd[f"transformer.h.{i}.{name}.adapter_bias"] = torch.from_numpy(rng.normal(size=width).astype(np.float32))
                sd[f"transformer.h.{i}.{name}.adapter_scale"] = torch.from_numpy(rng.normal(size=width).astype(np.float32))
            for norm in ("rms_1", "rms_2"):
                sd[f"transformer.h.{i}.{norm}.scale"] = torch.from_numpy(rng.normal(size=D).astype(np.float32))
        sd["lm_head.adapter_bias"] = torch.from_numpy(rng.normal(size=cfg.vocab_size).astype(np.float32))
        sd["lm_head.adapter_scale"] = torch.from_numpy(rng.normal(size=cfg.vocab_size).astype(np.float32))
        sd["transformer.ln_f.scale"] = torch.from_numpy(rng.normal(size=D).astype(np.float32))
    return sd


@pytest.mark.parametrize("v2,scalar_gate", [(False, False), (False, True), (True, False)])
def test_adapter_sd_to_overlay_matches_jax(v2, scalar_gate):
    cfg = LLaMAConfig(block_size=64, vocab_size=100, n_layer=4, n_head=2, n_embd=256)  # padded vocab 128
    sd = _reference_sd(cfg, v2, scalar_gate)
    jov, jaT, jstart, jv2 = jconvert.adapter_sd_to_overlay({k: v.numpy() for k, v in sd.items()}, cfg)
    tov, aT, start, tv2 = tconvert.adapter_sd_to_overlay(sd, port_config(cfg), device="cpu")
    assert (aT, start, tv2) == (jaT, jstart, jv2) == (10, 2, v2)
    want = tree_leaves(jax.tree_util.tree_map(np.asarray, jov))
    got = tree_leaves(tov)
    assert sorted(got) == sorted(want)
    for n, a in want.items():
        np.testing.assert_array_equal(got[n].numpy(), a, err_msg=n)
    if scalar_gate:
        g = got["h/gating"].numpy()
        assert (g[2:] == g[2:, :1]).all() and (g[:2] == 0).all()


def test_params_from_numpy_carries_adapter_leaves():
    cfg = _cfg(True, "bfloat16")
    params = jax.tree_util.tree_map(np.asarray, _adapter_params(cfg))
    got = tree_leaves(params_from_numpy(params, device="cpu"))
    want = tree_leaves(params)
    assert sorted(got) == sorted(want)
    for n in ("h/adapter_wte", "h/gating", "h/adapter_active", "h/attn/c_attn/av2_bias", "lm_head/av2_scale"):
        assert got[n].dtype == torch.bfloat16
        np.testing.assert_array_equal(got[n].float().numpy(), want[n].astype(np.float32), err_msg=n)
