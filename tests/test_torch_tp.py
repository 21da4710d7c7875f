"""Tensor parallelism on the CPU: the port's TP layout (``parallel.tp``)
byte for byte against the JAX package's ``prepare_tp_params``, and its TP
forward and ``generate_tp`` in gloo ranks (``torch_parallel_ranks``) against
the JAX ``shard_map`` TP on the 8 virtual CPU devices (``tests/conftest.py``).

Tolerance: f32 logits within rtol = atol = 2e-4, as ``tests/test_tp.py``
holds the JAX TP against one device (a partial sum's order is all that
differs); tokens and the layout exactly. The JAX TP refuses int8 weights
(it re-packs an int8 ``c_proj`` as int4 nibbles and shards its (1, D) scale
over the rows, which its placement rejects), so the port's int8 TP is held
against the JAX single-device forward, and its int8 layout keeps the rows.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lit_llama_tpu import LLaMAConfig, forward, init_kv_cache, init_params
from lit_llama_tpu.models import llama as jllama
from lit_llama_tpu.models.config import LoRAConfig
from lit_llama_tpu.models.generate import generate as jgenerate
from lit_llama_tpu.parallel import mesh as jmesh, tp as jtp
from lit_llama_tpu.peft import lora as jlora
from lit_llama_tpu_torch.models import config as tcfg
from lit_llama_tpu_torch.parallel import tp
from lit_llama_tpu_torch.utils.jax_params import params_from_numpy
from tests import torch_parallel_ranks as ranks

TOL = dict(rtol=2e-4, atol=2e-4)
S = 16
TOKS = np.arange(6, dtype=np.int32) + 1
STEP = 7
KINDS = ("dense", "int4", "int8", "lora", "int4_lora")


def port_config(cfg):
    out = tcfg.LLaMAConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                              if f.name not in ("lora", "adapter")})
    if cfg.lora is not None:
        out = out.replace(lora=tcfg.LoRAConfig(r=cfg.lora.r, alpha=cfg.lora.alpha, dropout=cfg.lora.dropout))
    return out


def _with_lora(params, cfg):
    """LoRA A as initialised, B drawn (not zero), as tests/test_tp.py does."""
    params = jlora.add_lora_params(jax.tree_util.tree_map(lambda a: a, params), cfg, jax.random.PRNGKey(3))
    ca = params["h"]["attn"]["c_attn"]
    ca["lora_b"] = (jax.random.normal(jax.random.PRNGKey(9), ca["lora_b"].shape) * 0.05).astype(ca["lora_b"].dtype)
    return params


def _case(kind):
    """(JAX config, JAX params). int4 at width 512, group size 128: I = 1536,
    which mp · 2 · gs = 1024 does not divide at mp = 4, so it pads to 2048."""
    base = dict(block_size=64, vocab_size=96, n_layer=2, n_head=4)
    lcfg = LoRAConfig(r=4, alpha=8.0, dropout=0.0)
    if kind in ("int4", "int4_lora"):
        cfg = LLaMAConfig(**base, n_embd=512, quantize="int4", quant_groupsize=128)
    elif kind == "int8":
        cfg = LLaMAConfig(**base, n_embd=64, quantize="int8")
    else:
        cfg = LLaMAConfig(**base, n_embd=64)
    params = init_params(cfg.replace(quantize=None), jax.random.PRNGKey(0))
    if cfg.quantize:
        params = jllama.quantize_params(params, cfg)
    if kind.endswith("lora"):
        cfg = cfg.replace(lora=lcfg)
        params = _with_lora(params, cfg)
    return cfg, params


@pytest.fixture(scope="module")
def cases():
    return {k: _case(k) for k in KINDS}


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, path=""):
    """{path: array} of a tree of dicts and sequences (tuple and list alike)."""
    if isinstance(tree, dict):
        return {p: a for k, v in tree.items() for p, a in _leaves(v, f"{path}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: a for i, v in enumerate(tree) for p, a in _leaves(v, f"{path}/{i}").items()}
    return {path: tree}


def _port_layout(params, cfg, mp):
    got = tp.prepare_tp_params(params_from_numpy(_numpy(params), device="cpu"), port_config(cfg), mp)
    return got, {p: t.numpy() for p, t in _leaves(got).items()}


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("kind", ["dense", "int4", "lora", "int4_lora"])
def test_prepare_tp_params_matches_jax_byte_for_byte(cases, kind, mp):
    """The permuted c_attn, the per-shard int4 re-pack, the zero-padded MLP
    (int4 at mp = 4: I 1536 -> 2048) and the LoRA leaves equal JAX's bytes;
    each leaf shards along the axis JAX's PartitionSpec names."""
    cfg, params = cases[kind]
    want = _leaves(_numpy(jtp.prepare_tp_params(params, cfg, mp)))
    tree, got = _port_layout(params, cfg, mp)
    assert sorted(got) == sorted(want)
    for path, a in want.items():
        assert got[path].dtype == a.dtype and np.array_equal(got[path], a), path
    if kind == "int4" and mp == 4:
        assert got["/h/0/mlp/c_proj/qw"].shape == (1024, 512) and got["/h/0/mlp/c_fc1/qw"].shape[-1] == 2048
    specs = _leaves(tp.tp_param_specs(tree))
    jspecs = _leaves(jtp.tp_param_specs(jtp.prepare_tp_params(params, cfg, mp)))
    for path, spec in jspecs.items():
        axes = [i - want[path].ndim for i, s in enumerate(spec) if s == "model"]
        assert specs[path] == (axes[0] if axes else None), path


@pytest.mark.parametrize("mp", [2, 4])
def test_prepare_tp_params_int8_shards_rows_as_they_are(cases, mp):
    """int8: c_attn's columns permuted by JAX's permutation; the c_proj rows
    and their per-column scale kept as they are (the whole scale on every
    rank); the MLP hidden dim (256) zero-padded to a multiple of mp · 256, so
    every shard's width stays on K6's route. The JAX layout does not take
    int8 weights: it re-packs an int8 c_proj as int4 nibbles (at mp = 4 it
    fails outright), and its placement refuses the (1, D) scale sharded over
    the rows."""
    cfg, params = cases["int8"]
    tree, got = _port_layout(params, cfg, mp)
    whole = _leaves(_numpy(jllama.unstack_layers(params, fuse_mlp=False)))
    perm = np.asarray(jtp._qkv_col_perm(3 * cfg.n_embd, mp))
    I, I_pad = cfg.intermediate_size, 256 * mp
    for path in got:
        want = whole[path][..., perm] if "c_attn" in path else whole[path]
        if "/mlp/c_fc" in path:
            want = np.pad(want, ((0, 0), (0, I_pad - I)))
        elif path.endswith("/mlp/c_proj/qw"):
            want = np.pad(want, ((0, I_pad - I), (0, 0)))
        assert got[path].dtype == want.dtype and np.array_equal(got[path], want), path
    assert _leaves(tp.tp_param_specs(tree))["/h/0/attn/c_proj/qscale"] is None
    mesh = jmesh.make_mesh(data=1, model=mp, devices=jax.devices()[:mp])
    with pytest.raises((ValueError, KeyError)):
        jtp.shard_params_tp(jllama.unstack_layers(params), mesh, cfg)


def _jax_forwards(cfg, params, mp):
    """(prefill logits, one slot_pos decode step's logits) of the JAX TP
    over mp virtual devices; int8 on one device (see the module docstring)."""
    toks = jnp.asarray(TOKS)[None]
    step = jnp.array([[STEP]], jnp.int32)
    pos = jnp.array([len(TOKS)], jnp.int32)
    if cfg.quantize == "int8":
        logits, cache = forward(params, toks, cfg, input_pos=jnp.arange(len(TOKS)), kv_cache=init_kv_cache(cfg, 1, S))
        step_logits, _ = forward(params, step, cfg, slot_pos=pos, kv_cache=cache)
        return np.asarray(logits), np.asarray(step_logits)
    mesh = jmesh.make_mesh(data=1, model=mp, devices=jax.devices()[:mp])
    sp = jtp.shard_params_tp(jllama.unstack_layers(params), mesh, cfg)
    prefill, decode = jtp.make_tp_forward(cfg, mesh, sp)
    logits, cache = prefill(sp, toks, jnp.arange(len(TOKS)), jtp.init_tp_cache(cfg, mesh, 1, S))
    step_logits, _ = decode(sp, step, pos, cache)
    return np.asarray(logits), np.asarray(step_logits)


GEN_PROMPT = np.arange(5, dtype=np.int32) + 1
GEN_NEW = 8


MP4_KINDS = ("dense", "int4", "int8", "lora")


def _spawn(mp, kinds, cases, tmp_path_factory, generate=None):
    payload = {"S": S, "forwards": {k: (port_config(cases[k][0]), _numpy(cases[k][1]), TOKS, STEP) for k in kinds}}
    if generate:
        payload["generate"], payload["top_k"] = generate, 50
    return ranks.run("tp_forwards", mp, tmp_path_factory.mktemp(f"tp{mp}"), payload)


@pytest.fixture(scope="module")
def tp2(cases, tmp_path_factory):
    """One spawn of two ranks: every forward case; greedy generate_tp with
    and without LoRA, and a sampled one (temperature 0.8, top-k 50, seed 7)."""
    gen = {name: (port_config(cases[k][0]), _numpy(cases[k][1]), GEN_PROMPT, GEN_NEW, 0.0, 0)
           for name, k in (("greedy", "dense"), ("greedy_lora", "lora"))}
    gen["sampled"] = gen["greedy"][:4] + (0.8, 7)
    return _spawn(2, KINDS, cases, tmp_path_factory, gen)


@pytest.fixture(scope="module")
def tp4(cases, tmp_path_factory):
    """One spawn of four ranks: the forward cases of MP4_KINDS."""
    return _spawn(4, MP4_KINDS, cases, tmp_path_factory)


@pytest.mark.parametrize("mp,kind", [(2, k) for k in KINDS] + [(4, k) for k in MP4_KINDS])
def test_tp_forward_matches_jax_shard_map(cases, request, mp, kind):
    """Prefill and one slot_pos decode step through the TP forward, every
    rank's whole logits against the JAX shard_map TP's."""
    results = request.getfixturevalue(f"tp{mp}")
    want_prefill, want_step = _jax_forwards(*cases[kind], mp)
    for rank, out in enumerate(results):
        got_prefill, got_step = out[kind]
        np.testing.assert_allclose(got_prefill, want_prefill, **TOL, err_msg=f"prefill, rank {rank}")
        np.testing.assert_allclose(got_step, want_step, **TOL, err_msg=f"decode, rank {rank}")
    if kind == "lora":  # the update is in play
        assert not np.allclose(results[0]["lora"][0], results[0]["dense"][0], atol=1e-3)


@pytest.mark.parametrize("name", ["greedy", "greedy_lora"])
def test_generate_tp_greedy_matches_jax(cases, tp2, name):
    """Greedy generate_tp on two ranks: JAX generate_tp's tokens, and the
    single-device JAX generate's, on every rank."""
    cfg, params = cases["lora" if name.endswith("lora") else "dense"]
    mesh = jmesh.make_mesh(data=1, model=2, devices=jax.devices()[:2])
    sp = jtp.shard_params_tp(jllama.unstack_layers(params), mesh, cfg)
    want = jtp.generate_tp(sp, GEN_PROMPT, GEN_NEW, config=cfg, mesh=mesh, temperature=0.0,
                           key=jax.random.PRNGKey(0)).tolist()
    assert want == jgenerate(jllama.unstack_layers(params), GEN_PROMPT, GEN_NEW, config=cfg, temperature=0.0,
                             key=jax.random.PRNGKey(0)).tolist()
    for rank, out in enumerate(tp2):
        assert out[name] == want, f"rank {rank}"


def test_generate_tp_sampled_tokens_agree_on_every_rank(tp2):
    """Sampling at temperature 0.8 with top-k 50: both ranks draw the same
    tokens (gathered logits, generators seeded alike)."""
    results = tp2
    assert len(results[0]["sampled"]) == len(GEN_PROMPT) + GEN_NEW
    assert results[0]["sampled"] == results[1]["sampled"]
    assert results[0]["sampled"] != results[0]["greedy"]


@pytest.fixture
def world_of_one(monkeypatch):
    """A one-rank process group for the test, taken down after it."""
    import torch.distributed as dist

    from lit_llama_tpu_torch.parallel import launch, mesh as mesh_lib

    monkeypatch.setattr(launch, "_initialized", False)
    monkeypatch.setattr(launch, "_device", None)
    yield mesh_lib.single_device_mesh(device="cpu")
    dist.destroy_process_group()


def test_generate_tp_stops_at_eos_on_one_rank(cases, world_of_one):
    """In a world of one (a 1 x 1 mesh, no spawn), generate_tp is the plain
    slot_pos generation: it stops after the eos token, which it includes."""
    cfg, params = cases["dense"]
    mesh = world_of_one
    tparams = tp.shard_params_tp(params_from_numpy(_numpy(params), device="cpu"), mesh, port_config(cfg))
    full = tp.generate_tp(tparams, GEN_PROMPT, GEN_NEW, config=port_config(cfg), mesh=mesh, temperature=0.0).tolist()
    eos = full[len(GEN_PROMPT) + 2]
    first = full.index(eos, len(GEN_PROMPT))
    got = tp.generate_tp(tparams, GEN_PROMPT, GEN_NEW, config=port_config(cfg), mesh=mesh, temperature=0.0,
                         eos_id=eos).tolist()
    assert got == full[: first + 1]
    with pytest.raises(ValueError, match="fused"):
        tp.prepare_tp_params(tparams, port_config(cfg).replace(rope_layout="half"), 2)
