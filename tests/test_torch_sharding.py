"""The training layout across ranks on the CPU (``parallel.sharding``,
``parallel.comm``): the port's per-leaf specs against the JAX package's
``param_pspecs`` on a LoRA + Adapter v2 tree at each (fsdp, tp); a leaf cut
into its shards and put back together at every coordinate of meshes whose
axes do not divide it (the padding zero); the TP layout undone; then, in
gloo ranks (``tests/torch_parallel_ranks.py``), ``Layout.shard`` and
``Layout.gather`` byte for byte on every mesh of two ranks, an
Adapter v2 refused under TP, the four differentiable collectives and the
reduce-scatter against their definitions, and the census of one train step
(``tools.comm_anatomy``): the collectives each mesh calls.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from lit_llama_tpu import LLaMAConfig, init_params
from lit_llama_tpu.models.config import AdapterConfig, LoRAConfig
from lit_llama_tpu.parallel import sharding as jsharding
from lit_llama_tpu_torch.models import config as tcfg
from lit_llama_tpu_torch.parallel import sharding, tp
from lit_llama_tpu_torch.utils.checkpoint import tree_leaves
from lit_llama_tpu_torch.utils.jax_params import params_from_numpy
from tests import torch_parallel_ranks as ranks

# widths no axis of 2 or 4 divides everywhere: 3 layers, vocab 100 (padded to
# 128), LoRA on q, k and v (3 groups) of rank 3
SHAPE = dict(block_size=32, vocab_size=100, n_layer=3, n_head=4, n_embd=64)
LORA = LoRAConfig(r=3, alpha=6.0, dropout=0.0, enable_q=True, enable_k=True, enable_v=True)


def port_config(cfg):
    out = tcfg.LLaMAConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                              if f.name not in ("lora", "adapter")})
    if cfg.lora is not None:
        out = out.replace(lora=tcfg.LoRAConfig(**dataclasses.asdict(cfg.lora)))
    if cfg.adapter is not None:
        out = out.replace(adapter=tcfg.AdapterConfig(**dataclasses.asdict(cfg.adapter)))
    return out


def _tree(lora=True, adapter=False):
    cfg = LLaMAConfig(**SHAPE, lora=LORA if lora else None, adapter=AdapterConfig(v2=True) if adapter else None)
    params = jax.tree_util.tree_map(np.asarray, init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)  # every leaf drawn, so a misplaced shard cannot match
    params = jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(a.dtype), params)
    return cfg, params


def _spec_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {n: s for k, v in tree.items() for n, s in _spec_leaves(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


def _jax_dims(spec, ndim):
    data = [i for i, s in enumerate(spec) if s == "data"]
    model = [i for i, s in enumerate(spec) if s == "model"]
    assert len(spec) <= ndim
    return sharding.Spec(data[0] if data else None, model[0] if model else None)


@pytest.mark.parametrize("fsdp,tp", [(False, False), (True, False), (False, True), (True, True)])
def test_param_specs_match_jax(fsdp, tp):
    """Every leaf of a LoRA + Adapter v2 tree: the axis over data and the one
    over model as JAX's ``param_pspecs`` names them (its rule order too:
    LoRA A, LoRA B and v2's bias and scale under a linear take the linear's
    rule, so LoRA B's layer axis goes over data and its group axis over
    model)."""
    cfg, params = _tree(lora=True, adapter=True)
    want = jsharding.param_pspecs(jax.tree_util.tree_map(jax.numpy.asarray, params), fsdp=fsdp, tp=tp)
    flat = jax.tree_util.tree_flatten_with_path(want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    want = {"/".join(p.key for p in path): s for path, s in flat}
    got = _spec_leaves(sharding.param_specs(params_from_numpy(params, device="cpu"), fsdp=fsdp, tp=tp))
    shapes = {n: t.shape for n, t in tree_leaves(params_from_numpy(params, device="cpu")).items()}
    assert sorted(got) == sorted(want)
    for n, spec in want.items():
        assert got[n] == _jax_dims(spec, len(shapes[n])), n
    if fsdp and tp:
        assert got["h/attn/c_attn/lora_b"] == sharding.Spec(0, 1)
        assert got["wte"] == sharding.Spec(1, 0) and got["lm_head/w"] == sharding.Spec(0, 1)
    if fsdp and not tp:
        assert got["lm_head/w"] == sharding.Spec(1, None)


def assemble_tensor(shards, spec, shape):
    """The whole of a leaf from ``shards[d][m]`` (``sharding.shard_tensor``'s
    inverse, as ``Layout.gather`` assembles it over the ranks), its padding
    cut to ``shape``."""
    cols = []
    for m in range(len(shards[0])):
        part = [shards[d][m] for d in range(len(shards))]
        t = torch.cat(part, spec.data).narrow(spec.data, 0, shape[spec.data]) if spec.data is not None else part[0]
        cols.append(t)
    if spec.model is not None:
        return torch.cat(cols, spec.model).narrow(spec.model, 0, shape[spec.model])
    return cols[0]


@pytest.mark.parametrize("dp,mp", [(2, 1), (1, 2), (2, 2), (3, 2), (4, 4)])
def test_shards_put_back_together_at_every_coordinate(dp, mp):
    """``shard_tensor`` at each coordinate of a (dp, mp) mesh and its
    inverse: every leaf of the tree whole again, bit for bit;
    the shards laid side by side are the leaf zero-padded on each sharded
    axis to a multiple of its group's size."""
    _, params = _tree()
    for n, t in tree_leaves(params_from_numpy(params, device="cpu")).items():
        spec = sharding._leaf_spec(tuple(n.split("/")), t.ndim, True, True)
        shards = [[sharding.shard_tensor(t, spec, dp, mp, d, m) for m in range(mp)] for d in range(dp)]
        assert torch.equal(assemble_tensor(shards, spec, t.shape), t), n
        padded = t
        for axis, k in ((spec.model, mp), (spec.data, dp)):
            if axis is not None and k > 1:
                padded = sharding._padded_to(padded, axis, k)
        rows = [torch.cat(row, spec.model) if spec.model is not None and mp > 1 else row[0] for row in shards]
        side = torch.cat(rows, spec.data) if spec.data is not None and dp > 1 else rows[0]
        assert torch.equal(side, padded), n


def test_tp_layout_is_undone():
    """The TP layout of the stacked training tree (``parallel.tp``'s
    ``dense_to_tp``: c_attn's columns in ``parallel.tp``'s order, the MLP
    hidden dim padded with zeros to a multiple of mp) and back, exactly; the
    inference layout of a dense layer is the same function's."""
    from lit_llama_tpu_torch.models import llama

    cfg, _ = _tree(lora=False)
    pcfg = port_config(cfg).replace(n_embd=96, n_head=6)  # I = 256: whole at mp = 2, padded to 258 at mp = 3
    I = pcfg.intermediate_size
    w = torch.randn(3, 96, 288)
    fc = torch.randn(3, 96, I)
    proj = torch.randn(3, I, 96)
    for mp in (2, 3):
        got = tp.dense_to_tp("attn/c_attn/w", w, mp, I)
        assert torch.equal(got, w[..., tp._qkv_col_perm(288, mp)])
        assert torch.equal(tp.dense_from_tp("attn/c_attn/w", got, mp, I), w)
        for name, t, axis in (("mlp/c_fc1/w", fc, -1), ("mlp/c_proj/w", proj, -2)):
            padded = tp.dense_to_tp(name, t, mp, I)
            assert padded.shape[axis] % mp == 0 and not padded.narrow(axis, t.shape[axis], padded.shape[axis]
                                                                       - t.shape[axis]).any()
            assert torch.equal(tp.dense_from_tp(name, padded, mp, I), t)
        layer = {"attn": {"c_attn": {"w": w[0]}, "c_proj": {"w": proj[0, :96]}},
                 "mlp": {"c_fc1": {"w": fc[0]}, "c_fc2": {"w": fc[1]}, "c_proj": {"w": proj[0]}}}
        inference = tp.prepare_tp_params({"h": [layer]}, pcfg, mp)["h"][0]
        for name, t in tree_leaves(llama.unfuse_mlp_layer(layer)).items():
            assert torch.equal(tree_leaves(inference)[name], tp.dense_to_tp(name, t, mp, I)), (mp, name)


# ---- in ranks ---------------------------------------------------------------------------

SUM_TOL = dict(rtol=1e-5, atol=1e-6)  # sums of 2 or 4 f32 values, in the ranks' order
MESHES = [(2, 1, True), (2, 1, False), (1, 2, True), (1, 2, False)]
CENSUS = [(2, 1, False), (2, 1, True), (1, 2, False)]


def _collective_inputs(world):
    rng = np.random.default_rng(world)
    x = rng.normal(size=(world, 4, 3)).astype(np.float32)
    up = {"copy_to_group": rng.normal(size=(world, 4, 3)), "reduce_from_group": rng.normal(size=(world, 4, 3)),
          "gather_last": rng.normal(size=(world, 4, 3 * world)), "gather_dim0": rng.normal(size=(world, 4 * world, 3))}
    return {"x": x, "up": {k: v.astype(np.float32) for k, v in up.items()}}


def _payload(world):
    cfg, params = _tree()
    acfg, aparams = _tree(lora=False, adapter=True)
    ids = np.random.default_rng(2).integers(0, SHAPE["vocab_size"], size=(1, 4, 17)).astype(np.int32)
    return dict(config=port_config(cfg), params=params, meshes=MESHES, adapter_config=port_config(acfg),
                adapter_params=aparams, collectives={world: _collective_inputs(world)}, census=CENSUS, ids=ids)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return ranks.run("sharding_checks", 2, tmp_path_factory.mktemp("shard2"), _payload(2))


@pytest.mark.parametrize("mesh", MESHES, ids=[f"{d}x{m}{'-fsdp' if f else ''}" for d, m, f in MESHES])
def test_layout_shards_and_gathers_byte_for_byte(request, mesh):
    """Each rank's local leaves are its coordinate's shards of the TP layout
    (``shard_tensor``: padding zero), and ``Layout.gather`` gives the tree
    back on rank 0 bit for bit, in the single-process layout, as tensors of
    its own (a later in-place step on the shards leaves it as it was)."""
    dp, mp, fsdp = mesh
    res = request.getfixturevalue("two")
    cfg, params = _tree()
    whole = tree_leaves(params_from_numpy(params, device="cpu"))
    pcfg = port_config(cfg)
    for rank, out in enumerate(res):
        trip = out["trips"][mesh]
        d, m = rank // mp, rank % mp
        for n, t in whole.items():
            spec = sharding._leaf_spec(tuple(n.split("/")), t.ndim, fsdp, mp > 1)
            src = tp.dense_to_tp(n.removeprefix("h/"), t, mp, pcfg.intermediate_size) if mp > 1 else t
            assert np.array_equal(trip["local"][n], sharding.shard_tensor(src, spec, dp, mp, d, m).numpy()), (rank, n)
        if rank == 0:
            assert sorted(trip["whole"]) == sorted(whole)
            for n, t in whole.items():
                assert np.array_equal(trip["whole"][n], t.numpy()), n
        else:
            assert trip["whole"] is None


def test_adapters_are_refused_under_tensor_parallelism(two):
    """An Adapter v2 tree under a model axis raises NotImplementedError (the
    JAX package's placement refuses it; Adapter v1 trains under TP), naming
    the way out."""
    assert "tensor parallelism" in two[0]["adapter_refused"] and "--data_parallel" in two[0]["adapter_refused"]


def test_differentiable_collectives(two):
    """copy_to_group: x forward, the gradients summed backward;
    reduce_from_group: the sum forward, the gradient as it is backward;
    gather_last: the ranks' columns forward, this rank's columns of the
    gradient backward; gather_dim: the ranks' rows forward, the gradients'
    sum reduce-scattered backward; reduce_scatter: each rank's chunk of the
    sum. ``comm.stats`` counts each call by kind."""
    res, world = two, 2
    x, up = _collective_inputs(world)["x"], _collective_inputs(world)["up"]
    R = x.shape[1]
    for r, out in enumerate(res):
        got = out["collectives"]
        y, g = got["copy_to_group"]
        np.testing.assert_allclose(y, x[r])
        np.testing.assert_allclose(g, up["copy_to_group"].sum(0), **SUM_TOL)
        y, g = got["reduce_from_group"]
        np.testing.assert_allclose(y, x.sum(0), **SUM_TOL)
        np.testing.assert_allclose(g, up["reduce_from_group"][r])
        y, g = got["gather_last"]
        np.testing.assert_array_equal(y, np.concatenate(list(x), -1))
        np.testing.assert_array_equal(g, up["gather_last"][r][:, 3 * r:3 * (r + 1)])
        y, g = got["gather_dim0"]
        np.testing.assert_array_equal(y, np.concatenate(list(x), 0))
        np.testing.assert_allclose(g, up["gather_dim0"][:, R * r:R * (r + 1)].sum(0), **SUM_TOL)
        np.testing.assert_allclose(got["reduce_scatter"], x.sum(0)[r * R // world:(r + 1) * R // world], **SUM_TOL)
        stats = got["stats"]
        assert {k: v["calls"] for k, v in stats.items()} == {"all_reduce": 2, "all_gather": 2, "reduce_scatter": 2}
        assert stats["all_gather"]["bytes"] == 2 * world * x[r].nbytes


@pytest.mark.parametrize("mesh", CENSUS, ids=[f"{d}x{m}{'-fsdp' if f else ''}" for d, m, f in CENSUS])
def test_train_step_census(request, mesh):
    """The collectives of one train step, as ``tools.comm_anatomy.census``
    counts them: DP sums each whole leaf's gradient (one all-reduce a leaf)
    and gathers nothing; FSDP gathers each sharded leaf in the forward and
    again in the recompute, and reduce-scatters its gradient; TP sums the
    two projections of each block and the embedding, gathers the logits;
    every step adds the loss's count and sum and the norm. Every rank counts the same."""
    dp, mp, fsdp = mesh
    res = request.getfixturevalue("two")
    rows = [{r["kind"]: r["calls"] for r in out["census"][mesh]["rows"]} for out in res]
    assert all(r == rows[0] for r in rows)
    kinds = rows[0]
    if not fsdp and mp == 1:
        assert "all_gather" not in kinds and "reduce_scatter" not in kinds
        assert kinds["all_reduce"] >= len(tree_leaves(_tree()[1]))  # every leaf trains
    if fsdp and dp > 1:
        assert kinds["reduce_scatter"] > 0 and kinds["all_gather"] > kinds["reduce_scatter"]
    if mp > 1:
        assert kinds["all_reduce"] >= 2 * SHAPE["n_layer"] + 1 and kinds["all_gather"] >= 1
    c = res[0]["census"][mesh]
    assert 0 < c["collective_s"] <= c["wall_s"] and 0 < c["share"] <= 1
