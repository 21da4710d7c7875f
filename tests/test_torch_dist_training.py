"""Training across ranks on the CPU: the port's train step over a (data,
model) mesh of gloo ranks (``tests/torch_parallel_ranks.py``) against the
JAX ``train_step`` under its GSPMD mesh of the same shape on the 8 virtual
devices (``tests/conftest.py``) and against the port's own single-process
step on the global batch: DP (2, 1), FSDP (2, 1), TP (1, 2) and FSDP + TP
(2, 2); an SFT batch whose ranks hold different counts of ignored labels;
steps where the clip engages; a resume onto another mesh; a stop signal
that one rank receives.

Tolerances, f32: against JAX the loss to rtol 1e-5 and the params after 3
steps to rtol 1e-5, atol 1e-2 lr, as ``tests/test_torch_training.py`` holds
one device (an Adam step is about lr times the grad's sign, which f32
rounding of a grad near zero may flip), but for at most 1e-5 of a leaf's
elements, each within 0.1 lr: on the FSDP case's batches the port's
single-process step itself moves one element of wte (of 131072) by 0.031 lr
from JAX's. Against the single-process step
the loss to rtol 2e-6 and every element to rtol 1e-6, atol 1e-2 lr (the
same arithmetic, its sums split over ranks).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from lit_llama_tpu import LLaMAConfig, init_params
from lit_llama_tpu.parallel import mesh as jmesh, sharding as jsharding
from lit_llama_tpu.training import step as jstep
from lit_llama_tpu.utils import checkpoint as jckpt
from lit_llama_tpu_torch.models import config as tcfg
from lit_llama_tpu_torch.models.generate import generate
from lit_llama_tpu_torch.training import loop as tloop
from lit_llama_tpu_torch.training import step as tstep
from lit_llama_tpu_torch.utils.checkpoint import tree_leaves
from lit_llama_tpu_torch.utils.jax_params import params_from_numpy
from lit_llama_tpu_torch.utils.loader import load_model
from tests import torch_parallel_ranks as ranks

SHAPE = dict(block_size=64, vocab_size=512, n_layer=2, n_head=2, n_embd=256)
LR = 1e-3
TC = dict(learning_rate=LR, min_lr=LR / 10, warmup_iters=1, max_iters=3)
STEPS, A, B, T = 3, 2, 4, 32
JAX_TOL = dict(rtol=1e-5, atol=1e-2 * LR)
PORT_TOL = dict(rtol=1e-6, atol=1e-2 * LR)


def port_config(cfg):
    return tcfg.LLaMAConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                               if f.name not in ("lora", "adapter")})


def fresh(params):
    """Tensors of their own (``params_from_numpy`` shares a CPU array's
    memory, and a train step updates in place)."""
    return params_from_numpy(jax.tree_util.tree_map(np.copy, params), device="cpu")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(p.key for p in path): np.asarray(jnp.asarray(v, jnp.float32)) for path, v in flat}


def _tokens(seed, ignore=None):
    """(STEPS, A, B, T) inputs and targets; ``ignore``: ignored labels from
    this column on, a row's cut at a different column for the first data
    rank's rows than for the second's."""
    toks = np.random.default_rng(seed).integers(0, SHAPE["vocab_size"], size=(STEPS, A, B, T + 1)).astype(np.int32)
    ids, tgt = toks[..., :-1].copy(), toks[..., 1:].copy()
    if ignore is not None:
        for b in range(B):
            tgt[:, :, b, ignore[b]:] = -1
    return ids, tgt


def _case(mesh, fsdp, seed=7, ignore=None, **tc):
    cfg = LLaMAConfig(**SHAPE)
    ids, tgt = _tokens(seed, ignore)
    return dict(jax_config=cfg, config=port_config(cfg), params=_np(init_params(cfg, jax.random.PRNGKey(0))),
                mesh=mesh, fsdp=fsdp, tc={**TC, **tc}, ids=ids, tgt=tgt)


# rows 0-1 (data rank 0) keep 28 and 30 labels, rows 2-3 (data rank 1) 5 and 2
UNEVEN = (28, 30, 5, 2)
CASES2 = {"dp": _case((2, 1), False), "fsdp": _case((2, 1), True, seed=8), "tp": _case((1, 2), False, seed=9),
          "uneven_dp": _case((2, 1), False, seed=10, ignore=UNEVEN)}
CASES4 = {"clip_fsdp_tp": _case((2, 2), True, seed=11, grad_clip=0.05),
          "clip_uneven_fsdp_tp": _case((2, 2), True, seed=13, ignore=UNEVEN, grad_clip=0.05)}
CASES = {**CASES2, **CASES4}


def _payload(cases):
    keys = ("config", "params", "mesh", "fsdp", "tc", "ids", "tgt")
    return {"cases": {n: {k: c[k] for k in keys} for n, c in cases.items()}}


RESUME = _case((2, 1), True, seed=14)
RESUME["ids"], RESUME["tgt"] = (np.concatenate([a, b])[:4] for a, b in zip(_tokens(14), _tokens(15)))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One spawn of two ranks: the steps of CASES2, then the resume and stop
    runs (``torch_parallel_ranks.resume_runs``) under "resume"."""
    out = tmp_path_factory.mktemp("dist2")
    payload = _payload(CASES2)
    payload["resume"] = dict(config=RESUME["config"], params=RESUME["params"], tc={**TC, "max_iters": 4},
                             ids=RESUME["ids"], tgt=RESUME["tgt"], out=str(out), stop_at=1, stop_rank=1)
    return ranks.run("train_steps", 2, out, payload)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return ranks.run("train_steps", 4, tmp_path_factory.mktemp("dist4"), _payload(CASES4))


_JAX_OPTIMIZERS = {}


def jax_steps(case):
    """JAX ``train_step`` (remat off: the same arithmetic) on the case's
    batches, its params sharded as the JAX scripts shard them over a mesh of
    the case's shape on the virtual devices, with the case's trainable mask
    (``jax_mask``, for a finetuning mode ``mask``): (losses, final params).
    One optimizer a configuration and mode, so that cases of one mesh share
    a compile."""
    dp, mp = case["mesh"]
    cfg = case["jax_config"]
    key = tuple(sorted(case["tc"].items())) + (case.get("mask"),)
    opt = _JAX_OPTIMIZERS.get(key) or _JAX_OPTIMIZERS.setdefault(
        key, jstep.make_optimizer(jstep.TrainConfig(**case["tc"]), case.get("jax_mask")))
    mesh = jmesh.make_mesh(data=dp, model=mp, devices=jax.devices()[: dp * mp])
    sp = jsharding.shard_params(jax.tree_util.tree_map(jnp.asarray, case["params"]), mesh, fsdp=case["fsdp"],
                                tp=mp > 1)
    state = jstep.TrainState(sp, jax.jit(opt.init)(sp), jnp.int32(0))
    bsh = NamedSharding(mesh, P(None, jmesh.DATA_AXIS, None))
    losses = []
    with mesh:
        for ids, tgt in zip(case["ids"], case["tgt"]):
            state, loss = jstep.train_step(state, jax.device_put(ids, bsh), jax.device_put(tgt, bsh), cfg, opt,
                                           False)
            losses.append(float(loss))
    return losses, _jax_leaves(state.params)


def port_steps(case, grad_clip_probe=False, mask=None):
    """The port's single-process ``train_step`` on the global batches, with
    the trainable mask ``mask(params)`` gives: (losses, final params, each
    step's gradient norm before the clip)."""
    params = fresh(case["params"])
    opt = tstep.make_optimizer(tstep.TrainConfig(**case["tc"]), None if mask is None else mask(params))
    norms = []
    if grad_clip_probe:
        apply = opt.apply

        def probing(params, grads, state, g_norm=None):
            norms.append(float(torch.sqrt(sum(g.float().square().sum() for g in grads.values()))))
            apply(params, grads, state, g_norm)

        opt.apply = probing
    state = tstep.init_train_state(params, opt)
    losses = []
    for ids, tgt in zip(case["ids"], case["tgt"]):
        state, loss = tstep.train_step(state, torch.from_numpy(ids).long(), torch.from_numpy(tgt).long(),
                                       case["config"], opt, True, "dots")
        losses.append(float(loss))
    return losses, {n: t.float().numpy() for n, t in tree_leaves(state.params).items()}, norms


def _held(got, want, tol, what, flips=0.0):
    """Every leaf of ``got`` within ``tol`` of ``want``'s, but for a share
    ``flips`` of a leaf's elements, each within 0.1 lr."""
    assert sorted(got) == sorted(want), what
    for n in want:
        diff = np.abs(got[n] - want[n])
        off = diff > tol["atol"] + tol["rtol"] * np.abs(want[n])
        if off.mean() > flips or (off.any() and diff.max() > 0.1 * LR):
            np.testing.assert_allclose(got[n], want[n], **tol, err_msg=f"{what}: {n}")


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_jax_and_one_process(request, name):
    """Three steps across ranks: the loss every rank returns and the params
    gathered whole, against the JAX step under its mesh and the port's
    single-process step on the global batch. The clip case's gradient norm
    is above its clip at every step (the clip engages); the TP cases' whole
    params come back in the single-process layout (c_attn's column
    permutation undone)."""
    case = CASES[name]
    results = request.getfixturevalue("two_ranks" if name in CASES2 else "four_ranks")
    want_losses, want = jax_steps(case)
    one_losses, one, norms = port_steps(case, grad_clip_probe=name.startswith("clip"))
    for rank, out in enumerate(results):
        np.testing.assert_allclose(out[name]["losses"], want_losses, rtol=1e-5, err_msg=f"rank {rank} vs JAX")
        np.testing.assert_allclose(out[name]["losses"], one_losses, rtol=2e-6, err_msg=f"rank {rank} vs one")
    _held(results[0][name]["params"], want, JAX_TOL, f"{name} vs JAX", flips=1e-5)
    _held(results[0][name]["params"], one, PORT_TOL, f"{name} vs one process")
    np.testing.assert_allclose(one_losses, want_losses, rtol=1e-5)
    if name.startswith("clip"):
        assert min(norms) > 2 * case["tc"]["grad_clip"], norms


def test_per_rank_mean_would_differ_on_uneven_batches():
    """The uneven SFT batch is one on which averaging the data ranks' own
    token means differs from the batch's token mean by far more than the
    tolerances above: a build that averaged them would fail the DP and
    FSDP + TP cases."""
    case = CASES["uneven_dp"]
    logits = torch.randn((B, T, 64), generator=torch.Generator().manual_seed(0))
    tgt = torch.from_numpy(case["tgt"][0, 0]).long() % 64
    tgt[torch.from_numpy(case["tgt"][0, 0]) < 0] = -1
    whole = float(tstep.cross_entropy_loss(logits, tgt))
    halves = [float(tstep.cross_entropy_loss(logits[r * 2:(r + 1) * 2], tgt[r * 2:(r + 1) * 2])) for r in range(2)]
    counts = [int((tgt[r * 2:(r + 1) * 2] >= 0).sum()) for r in range(2)]
    assert counts == [58, 7]
    assert abs(np.mean(halves) - whole) > 1e-3 * whole


def test_fsdp_and_tp_hold_a_share_of_the_state(two_ranks, four_ranks):
    """Params + moments bytes a rank: DP holds the whole state, FSDP over two
    ranks and TP over two about half of it, FSDP + TP over four a quarter
    (whole norms and padding above the exact share)."""
    whole = two_ranks[0]["dp"]["bytes"]
    for name, share in (("fsdp", 2), ("tp", 2)):
        for out in two_ranks:
            assert whole / share <= out[name]["bytes"] < 1.02 * whole / share, name
    for out in four_ranks:
        assert whole / 4 <= out["clip_fsdp_tp"]["bytes"] < 1.03 * whole / 4


# ---- resume on another mesh, and a stop signal at one rank ---------------------------------


@pytest.fixture(scope="module")
def resumed(two_ranks):
    return Path(two_ranks[0]["resume"]["out"]), [r["resume"] for r in two_ranks]


def test_resume_on_the_same_and_another_mesh(resumed):
    """A checkpoint written at FSDP (2, 1) halfway through four steps: the
    run resumed from it on the same mesh ends where the unbroken run ends,
    bit for bit; resumed on one process (1, 1) it ends there within the
    single-process tolerance. The checkpoint holds the single-process layout:
    the JAX loader reads it, and ``load_model`` and ``generate`` take it."""
    out, res = resumed
    ids, tgt = RESUME["ids"], RESUME["tgt"]
    lead = res[0]
    assert lead["unbroken_step"] == 4
    for n, w in lead["unbroken"].items():
        assert np.array_equal(lead["resumed"][n], w), n
    ckpt_dir = out / "unbroken" / "iter-000002"
    opt = tstep.make_optimizer(tstep.TrainConfig(**{**TC, "max_iters": 4}))
    state = tloop.load_train_checkpoint(ckpt_dir, opt, device="cpu")
    assert state.step == 2
    lc = tloop.LoopConfig(out_dir=out / "one", max_iters=4, save_interval=0, eval_interval=0)
    state = tloop.train(state, ranks._batches(ids, tgt, 2), RESUME["config"], opt, lc)
    got = {n: t.numpy() for n, t in tree_leaves(state.params).items()}
    _held(got, lead["unbroken"], PORT_TOL, "resumed on one process")
    jtree = jckpt.load_checkpoint(out / "unbroken" / "iter-000004")
    assert int(np.asarray(jtree["step"])) == 4
    _held(_jax_leaves(jtree["params"]), lead["unbroken"], dict(rtol=0, atol=0), "JAX loader")
    assert set(_jax_leaves(jtree["opt_state"]["mu"])) == set(lead["unbroken"])
    params, cfg = load_model(out / "unbroken" / "iter-000004", device="cpu")
    y = generate(params, [1, 2, 3], 4, config=cfg, temperature=0.0, device="cpu")
    assert len(y) == 7


def test_a_stop_signal_at_one_rank_stops_every_rank_at_one_step(resumed):
    """Rank 1 receives SIGTERM while it draws step 1's batch: both ranks agree
    on the flag at the next step's start and stop there, writing one
    ``preempt-000002`` checkpoint (rank 0) of step 2 and no ``final``. A rank
    that stopped alone would leave the other in the step's collectives until
    the group's timeout failed the spawn."""
    out, res = resumed
    assert [r["stopped_step"] for r in res] == [2, 2]
    stopped = out / "stopped"
    assert sorted(p.name for p in stopped.iterdir() if p.is_dir()) == ["preempt-000002"]
    assert int(jckpt.load_checkpoint(stopped / "preempt-000002")["step"]) == 2
    recs = (stopped / "metrics.jsonl").read_text().splitlines()
    assert len(recs) == 2  # rank 0 alone writes the metrics


def test_without_torchrun_more_than_one_rank_raises():
    """A world of one asked for two ranks names the flags and torchrun; one
    rank with both flags at one builds no mesh."""
    from lit_llama_tpu_torch.parallel import sharding

    for dp, mp in ((2, 1), (1, 2), (-1, 2)):
        with pytest.raises(NotImplementedError, match="torchrun --nproc_per_node"):
            sharding.train_mesh(dp, mp, "cpu")
    assert sharding.train_mesh(1, 1, "cpu") is None and sharding.train_mesh(-1, 1, "cpu") is None
