"""The pretraining slice on the CPU against the JAX package: the loss, the LR
schedule, one AdamW update against the optax chain, three train steps against
the JAX ``train_step`` (remat on and off, f32 and bf16 moments), gradient
accumulation, checkpoints and LITPKDS chunks read across the two packages,
resume, and the ``pretrain.redpajama`` entry point; on the card, one train
step of the kernel path against the plain path (skipped without one)."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from lit_llama_tpu import LLaMAConfig, init_params
from lit_llama_tpu.data import packed_dataset as jpk
from lit_llama_tpu.training import step as jstep
from lit_llama_tpu.utils import checkpoint as jckpt
from lit_llama_tpu_torch.data import packed_dataset as tpk
from lit_llama_tpu_torch.models import config as tcfg
from lit_llama_tpu_torch.training import loop as tloop
from lit_llama_tpu_torch.training import step as tstep
from lit_llama_tpu_torch.utils import checkpoint as tckpt
from lit_llama_tpu_torch.utils.jax_params import params_from_numpy, params_to_numpy

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _port_config(cfg):
    return tcfg.LLaMAConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                               if f.name not in ("lora", "adapter")})


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves_np(tree):
    return {k: v.detach().float().numpy() for k, v in tstep.tree_leaves(tree).items()}


def _jax_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(p.key for p in path): np.asarray(jnp.asarray(v, jnp.float32)) for path, v in flat}


# ---- loss and schedule -------------------------------------------------------

@pytest.mark.parametrize("ignored", ["none", "some", "all"])
def test_cross_entropy_matches_jax(ignored):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32) * 3
    targets = rng.integers(0, 11, size=(2, 5)).astype(np.int64)
    if ignored == "some":
        targets[0, 1] = targets[1, 3] = targets[1, 4] = -1
    elif ignored == "all":
        targets[:] = -1
    want = float(jstep.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(targets)))
    got = float(tstep.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(targets)))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if ignored == "all":
        assert got == 0.0


@pytest.mark.parametrize("decay_lr", [True, False])
def test_cosine_lr_matches_jax(decay_lr):
    tc = dict(learning_rate=6e-4, min_lr=6e-5, warmup_iters=10, max_iters=100, decay_lr=decay_lr)
    want = jstep.cosine_lr(jstep.TrainConfig(**tc))
    got = tstep.cosine_lr(tstep.TrainConfig(**tc))
    for step in (0, 1, 9, 10, 11, 55, 100, 150):  # 0, warmup, past max_iters
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=0)
    assert got(0) == 0.0


# ---- one optimizer update against optax -----------------------------------------

def _tree(rng, L=2, D=8, V=12):
    return {
        "wte": rng.normal(size=(V, D)).astype(np.float32),
        "h": {"rms_1": (1 + 0.1 * rng.normal(size=(L, D))).astype(np.float32),
              "attn": {"c_attn": {"w": rng.normal(size=(L, D, 3 * D)).astype(np.float32)}}},
        "ln_f": (1 + 0.1 * rng.normal(size=(D,))).astype(np.float32),
    }


@pytest.mark.parametrize("state_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_optimizer_updates_match_optax(state_dtype, masked):
    """Four updates (the first at lr 0, one with the global norm under the
    clip) on a stacked tree with 3-D, 2-D (rms_1: decayed) and 1-D (ln_f: not
    decayed) leaves; params and moments must agree."""
    rng = np.random.default_rng(1)
    params = _tree(rng)
    mask = None
    if masked:
        mask = jax.tree_util.tree_map(lambda a: a.ndim != 3, params)  # c_attn frozen
    tc = dict(learning_rate=1e-2, min_lr=1e-3, warmup_iters=2, max_iters=6, adam_state_dtype=state_dtype)
    jopt = jstep.make_optimizer(jstep.TrainConfig(**tc), mask)
    topt = tstep.make_optimizer(tstep.TrainConfig(**tc), mask)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    tparams = params_from_numpy(params, device="cpu")
    tstate = topt.init(tparams)
    for i, scale in enumerate((1.0, 0.01, 3.0, 1.0)):
        grads = jax.tree_util.tree_map(lambda a: (rng.normal(size=a.shape) * scale).astype(np.float32), params)
        upd, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        names = topt.trainable_names(tparams)
        tg = {n: t for n, t in tstep.tree_leaves(params_from_numpy(grads, device="cpu")).items() if n in names}
        topt.apply(tparams, tg, tstate)
        got, want = _leaves_np(tparams), _jax_leaves(jparams)
        for n in want:
            np.testing.assert_allclose(got[n], want[n], rtol=1e-6, atol=1e-6, err_msg=f"update {i}: {n}")
        if i == 0:  # lr(0) == 0: nothing moves
            for n, a in tstep.tree_leaves(params).items():
                np.testing.assert_array_equal(got[n], a)
    assert int(tstate["count"]) == 4
    if masked:
        np.testing.assert_array_equal(got["h/attn/c_attn/w"], params["h"]["attn"]["c_attn"]["w"])
        assert "h/attn/c_attn/w" not in tstep.tree_leaves(tstate["mu"])
    want_dtype = torch.bfloat16 if state_dtype else torch.float32
    for t in tstep.tree_leaves(tstate["nu"]).values():
        assert t.dtype == want_dtype


# ---- train steps against the JAX train_step ---------------------------------------

def _tiny():
    cfg = LLaMAConfig(block_size=64, vocab_size=512, n_layer=2, n_head=2, n_embd=256)
    params = _np(init_params(cfg, jax.random.PRNGKey(0)))
    toks = np.random.default_rng(7).integers(0, 512, size=(3, 2, 2, 65)).astype(np.int32)  # (steps, A, B, T+1)
    return cfg, params, toks


@pytest.mark.parametrize("remat,policy,state_dtype", [(True, "dots", None), (False, "dots", "bfloat16"),
                                                     (True, "full", "bfloat16")])
def test_train_steps_match_jax(remat, policy, state_dtype):
    """Three steps of A = 2 microbatches, f32: the JAX step runs attention_xla
    on the CPU, the port flash_attention_ref and its plain backward, so they
    agree to f32 rounding. Params are unchanged after the first step
    (warmup: lr(0) == 0)."""
    cfg, params, toks = _tiny()
    tc = dict(learning_rate=1e-3, min_lr=1e-4, warmup_iters=1, max_iters=3, adam_state_dtype=state_dtype)
    jopt = jstep.make_optimizer(jstep.TrainConfig(**tc))
    jstate = jstep.init_train_state(jax.tree_util.tree_map(jnp.asarray, params), jopt)
    topt = tstep.make_optimizer(tstep.TrainConfig(**tc))
    tstate = tstep.init_train_state(params_from_numpy(params, device="cpu"), topt)
    tc_port = _port_config(cfg)
    for i in range(3):
        ids, tgt = toks[i, ..., :-1], toks[i, ..., 1:]
        jstate, jloss = jstep.train_step(jstate, jnp.asarray(ids), jnp.asarray(tgt), cfg, jopt, remat, policy)
        tstate, tloss = tstep.train_step(tstate, torch.from_numpy(ids).long(), torch.from_numpy(tgt).long(),
                                         tc_port, topt, remat, policy)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5, atol=1e-5)
        got, want = _leaves_np(tstate.params), _jax_leaves(jstate.params)
        for n in want:
            # an Adam update is about lr * m / sqrt(v): the grads' f32
            # differences, and with bf16 moments a stored moment rounded the
            # other way, move a few elements by up to ~1 % of lr (the weight
            # decay and the clip are held tighter by the optimizer test above)
            np.testing.assert_allclose(got[n], want[n], rtol=1e-5, atol=1e-2 * tc["learning_rate"],
                                       err_msg=f"step {i}: {n}")
        if i == 0:
            for n, a in _jax_leaves(params).items():
                np.testing.assert_array_equal(got[n], a)
    assert tstate.step == 3 and int(jstate.step) == 3


class _Capture(tstep.AdamW):
    """An optimizer that keeps the grads it is given and updates nothing."""

    def apply(self, params, grads, state):
        self.grads = {n: g.clone() for n, g in grads.items()}


def test_grad_accumulation_equals_one_big_batch():
    cfg, params, toks = _tiny()
    tc_port = _port_config(cfg)
    batch = torch.from_numpy(toks[0]).long()  # (2, 2, 65)
    got = {}
    for A in (1, 2, 4):
        opt = _Capture(tstep.TrainConfig())
        state = tstep.init_train_state(params_from_numpy(params, device="cpu"), opt)
        b = batch.reshape(A, 4 // A, 65)
        _, loss = tstep.train_step(state, b[..., :-1], b[..., 1:], tc_port, opt, remat=False)
        got[A] = (float(loss), opt.grads)
    for A in (2, 4):
        np.testing.assert_allclose(got[A][0], got[1][0], rtol=1e-6)
        for n, g in got[1][1].items():
            np.testing.assert_allclose(got[A][1][n].numpy(), g.numpy(), rtol=1e-4, atol=1e-7, err_msg=n)


def test_remat_policies_give_the_same_grads():
    cfg, params, toks = _tiny()
    tc_port = _port_config(cfg)
    b = torch.from_numpy(toks[0]).long()
    grads = []
    for remat, policy in ((False, "dots"), (True, "dots"), (True, "full")):
        opt = _Capture(tstep.TrainConfig())
        state = tstep.init_train_state(params_from_numpy(params, device="cpu"), opt)
        tstep.train_step(state, b[..., :-1], b[..., 1:], tc_port, opt, remat, policy)
        grads.append(opt.grads)
    for other in grads[1:]:
        for n, g in grads[0].items():
            torch.testing.assert_close(other[n], g, rtol=1e-6, atol=1e-9)


# ---- checkpoints and LITPKDS across the packages -----------------------------------

def _mixed_tree(rng):
    return {"params": {"w": rng.normal(size=(3, 5)).astype(np.float32),
                       "b16": rng.normal(size=(4, 2)).astype(ml_dtypes.bfloat16),
                       "q": rng.integers(-127, 128, size=(7,)).astype(np.int8)},
            "step": np.asarray(12, np.int32)}


def test_checkpoint_port_writes_jax_reads(tmp_path):
    tree = _mixed_tree(np.random.default_rng(2))
    ttree = params_from_numpy(tree, device="cpu")
    assert ttree["params"]["b16"].dtype == torch.bfloat16
    tckpt.save_checkpoint(tmp_path / "c", ttree, metadata={"k": 1})
    back = jckpt.load_checkpoint(tmp_path / "c")
    assert back["params"]["b16"].dtype == ml_dtypes.bfloat16
    for k in ("w", "b16", "q"):
        np.testing.assert_array_equal(back["params"][k], tree["params"][k])
        assert back["params"][k].dtype == tree["params"][k].dtype
    assert int(back["step"]) == 12 and jckpt.load_metadata(tmp_path / "c") == {"k": 1}


def test_checkpoint_jax_writes_port_reads(tmp_path):
    tree = _mixed_tree(np.random.default_rng(3))
    jckpt.save_checkpoint(tmp_path / "c", tree)
    back = tckpt.load_checkpoint(tmp_path / "c")
    assert back["params"]["b16"].dtype == torch.bfloat16
    got = params_to_numpy(back["params"])  # bf16 as its bit pattern
    np.testing.assert_array_equal(got["b16"].view(ml_dtypes.bfloat16), tree["params"]["b16"])
    for k in ("w", "q"):
        np.testing.assert_array_equal(got[k], tree["params"][k])
    assert int(back["step"]) == 12
    # the bytes the port writes are the JAX writer's
    tckpt.save_checkpoint(tmp_path / "p", back)
    assert (tmp_path / "p" / "data.bin").read_bytes() == (tmp_path / "c" / "data.bin").read_bytes()
    assert json.loads((tmp_path / "p" / "manifest.json").read_text()) == \
        json.loads((tmp_path / "c" / "manifest.json").read_text())


def _write_chunks(mod, outdir, prefix, vocab, seed, n_tokens=5000):
    outdir.mkdir(parents=True, exist_ok=True)
    b = mod.PackedDatasetBuilder(str(outdir), prefix, chunk_size=17 * 40, sep_token=0, dtype="auto",
                                 vocab_size=vocab)
    rng = np.random.default_rng(seed)
    left = n_tokens
    while left > 0:
        n = int(rng.integers(10, 200))
        b.add_array(rng.integers(1, vocab, size=min(n, left)).astype(b.dtype))
        left -= n
    b.write_reminder()
    return b.filenames


def _blocks(mod, dirs):
    """100 blocks straight from each dataset (past its 2-chunk window, so it
    reloads), then 6 (2, 2, 17) batches of their weighted mixture."""
    datasets = [mod.PackedDataset(sorted(str(p) for p in d.glob("*.bin")), n_chunks=2, block_size=17, seed=5,
                                  shuffle=True, wrap=True) for d in dirs]
    direct = [np.stack([b for b, _ in zip(iter(d), range(100))]) for d in datasets]
    combined = mod.CombinedDataset(datasets, seed=9, weights=[0.3, 0.7])
    return direct + [b for b, _ in zip(mod.batcher(combined, 2, 2), range(6))]


@pytest.mark.parametrize("vocab", [512, 70000])
def test_packed_dataset_interop(tmp_path, vocab):
    """Chunks written by either package are byte-identical, and both readers
    yield the same blocks from either's files for the same seeds."""
    tfiles = _write_chunks(tpk, tmp_path / "t" / "a", "arxiv", vocab, 0) + \
        _write_chunks(tpk, tmp_path / "t" / "b", "book", vocab, 1)
    jfiles = _write_chunks(jpk, tmp_path / "j" / "a", "arxiv", vocab, 0) + \
        _write_chunks(jpk, tmp_path / "j" / "b", "book", vocab, 1)
    assert [Path(f).read_bytes() for f in tfiles] == [Path(f).read_bytes() for f in jfiles]
    assert tpk.read_header(tfiles[0]) == jpk.read_header(jfiles[0])
    dirs_t, dirs_j = [tmp_path / "t" / "a", tmp_path / "t" / "b"], [tmp_path / "j" / "a", tmp_path / "j" / "b"]
    want = _blocks(jpk, dirs_t)  # the JAX reader on the port's files
    got = _blocks(tpk, dirs_j)  # the port's reader on the JAX files
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---- the loop: resume, and the entry point ----------------------------------------------

def _loop_setup(params):
    tc = tstep.TrainConfig(learning_rate=1e-3, min_lr=1e-4, warmup_iters=1, max_iters=3, adam_state_dtype="bfloat16")
    opt = tstep.make_optimizer(tc)
    return opt, tstep.init_train_state(params_from_numpy(params, device="cpu"), opt)


@pytest.fixture
def one_thread():
    """PyTorch's CPU kernels split sums over threads as the load allows, so
    two runs may differ by an ulp; on one thread they repeat bit for bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_resume_equals_unbroken_run(tmp_path, one_thread):
    cfg, params, toks = _tiny()
    tcfg_ = _port_config(cfg)
    batches = [(toks[i, ..., :-1], toks[i, ..., 1:]) for i in range(3)]
    opt, state = _loop_setup(params)
    unbroken = tloop.train(state, iter(batches), tcfg_, opt,
                           tloop.LoopConfig(out_dir=tmp_path / "a", max_iters=3, save_interval=2), remat=False)
    opt2, state2 = _loop_setup(params)
    tloop.train(state2, iter(batches), tcfg_, opt2,
                tloop.LoopConfig(out_dir=tmp_path / "b", max_iters=2, save_interval=2), remat=False)
    opt3 = tstep.make_optimizer(opt2.tc)
    resumed = tloop.load_train_checkpoint(tmp_path / "b" / "iter-000002", opt3, device="cpu")
    assert resumed.step == 2
    resumed = tloop.train(resumed, iter(batches[2:]), tcfg_, opt3,
                          tloop.LoopConfig(out_dir=tmp_path / "b", max_iters=3, save_interval=0), remat=False)
    assert resumed.step == unbroken.step == 3
    for tree_a, tree_b in ((unbroken.params, resumed.params), (unbroken.opt_state, resumed.opt_state)):
        a, b = tstep.tree_leaves(tree_a), tstep.tree_leaves(tree_b)
        assert set(a) == set(b)
        for n in a:
            assert torch.equal(a[n], b[n]), n
    recs = [json.loads(line) for line in (tmp_path / "b" / "metrics.jsonl").read_text().splitlines()]
    assert [r["iter"] for r in recs] == [0, 1, 2]
    assert set(recs[0]) == {"iter", "loss", "tokens_per_sec", "dt_ms"}


def test_loop_validates_profiles_and_stops_at_the_data_end(tmp_path):
    cfg, params, toks = _tiny()
    opt, state = _loop_setup(params)
    batches = [(toks[i, ..., :-1], toks[i, ..., 1:]) for i in range(2)]
    val = tloop.validate_on(lambda: iter(batches), _port_config(cfg), eval_iters=2)
    state = tloop.train(state, iter(batches), _port_config(cfg), opt,
                        tloop.LoopConfig(out_dir=tmp_path, max_iters=5, eval_interval=1, save_interval=0,
                                         profile_at_iter=1),
                        validate_fn=val, remat=False)
    assert state.step == 2
    recs = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [sorted(r) for r in recs if "val_loss" in r] == [["iter", "val_loss"]] * 2
    assert json.loads((tmp_path / "profile" / "trace-000001.json").read_text())["traceEvents"]


def test_loop_saves_and_stops_on_sigterm(tmp_path):
    """A SIGTERM during step 0 saves a resumable preempt-000001 at the next
    step boundary and stops; the handler is restored after."""
    import os
    import signal
    import threading

    # the loop installs its handler only on the main thread; anywhere else the
    # signal would end the process, so check before sending it
    assert threading.current_thread() is threading.main_thread()
    cfg, params, toks = _tiny()
    opt, state = _loop_setup(params)
    batches = [(toks[i, ..., :-1], toks[i, ..., 1:]) for i in range(3)]
    before = signal.getsignal(signal.SIGTERM)

    def log_and_signal(rec):
        os.kill(os.getpid(), signal.SIGTERM)

    state = tloop.train(state, iter(batches), _port_config(cfg), opt,
                        tloop.LoopConfig(out_dir=tmp_path, max_iters=3, save_interval=0),
                        log_fn=log_and_signal, remat=False)
    assert state.step == 1
    back = tloop.load_train_checkpoint(tmp_path / "preempt-000001", tstep.make_optimizer(opt.tc), device="cpu")
    assert back.step == 1 and int(back.opt_state["count"]) == 1
    assert signal.getsignal(signal.SIGTERM) == before


def test_pretrain_entry_point_on_the_cpu(tmp_path):
    """``python -m lit_llama_tpu_torch.pretrain.redpajama --device cpu``: two
    iterations of a tiny config from LITPKDS chunks, then ``final``."""
    data = tmp_path / "data"
    _write_chunks(tpk, data, "cc", 512, 4, n_tokens=65 * 40)
    cmd = [sys.executable, "-m", "lit_llama_tpu_torch.pretrain.redpajama", "--device", "cpu",
           "--train_data_dir", str(data), "--out_dir", str(tmp_path / "out"), "--n_layer", "2",
           "--n_embd", "256", "--n_head", "2", "--block_size", "16", "--vocab_size", "512",
           "--batch_size", "2", "--micro_batch_size", "1", "--max_iters", "2", "--warmup_iters", "1",
           "--save_interval", "1"]
    subprocess.run(cmd, cwd=ROOT, check=True, timeout=300)
    recs = [json.loads(line) for line in (tmp_path / "out" / "metrics.jsonl").read_text().splitlines()]
    assert [r["iter"] for r in recs] == [0, 1] and all(np.isfinite(r["loss"]) for r in recs)
    assert int(tckpt.load_checkpoint(tmp_path / "out" / "final")["step"]) == 2
    assert (tmp_path / "out" / "iter-000001" / "manifest.json").exists()
    bad = subprocess.run(cmd[:3] + ["--device", "cpu", "--model_parallel", "2"], cwd=ROOT, capture_output=True,
                         timeout=300)
    assert bad.returncode != 0 and b"multi-device" in bad.stderr


# ---- the card -------------------------------------------------------------------------

class _Recording(tstep.AdamW):
    """AdamW that keeps a copy of the grads it applies."""

    def apply(self, params, grads, state):
        self.grads = {n: g.clone() for n, g in grads.items()}
        super().apply(params, grads, state)


def test_kernel_train_step_matches_plain(cuda):
    """One train step of a 2-layer model, bf16 compute, remat "dots": the
    K4 + K10 path against the plain path, with chip_smoke.py's rules: each
    leaf's grad error within 2e-2 of its largest grad and 2e-2 of its RMS
    (TOL_TRAIN_GRAD); updates within 5e-2 lr wherever the
    plain grad is clear of 0 by twice the leaf's grad error (AdamW's first
    step is about lr * sign(g), which may flip nearer 0)."""
    from lit_llama_tpu_torch.ops import flash_attention as tflash

    cfg = tcfg.LLaMAConfig(block_size=256, vocab_size=512, n_layer=2, n_head=2, n_embd=256,
                           param_dtype="float32", compute_dtype="bfloat16")
    _, params, _ = _tiny()
    init = {n: torch.from_numpy(np.array(a)).to(cuda) for n, a in tstep.tree_leaves(params).items()}
    toks = torch.from_numpy(np.random.default_rng(8).integers(0, 512, size=(2, 2, 257))).to(cuda)
    lr = 1e-3
    out = {}
    for plain in (False, True):
        opt = _Recording(tstep.TrainConfig(learning_rate=lr, warmup_iters=0, max_iters=10))
        state = tstep.init_train_state(params_from_numpy(params, device=cuda), opt)
        before = tflash.flash_backward_dq.launches
        state, loss = tstep.train_step(state, toks[..., :-1], toks[..., 1:], cfg, opt, True, "dots", plain)
        torch.cuda.synchronize()
        assert tflash.flash_backward_dq.launches - before == (0 if plain else 2 * 2)
        out[plain] = (float(loss), opt.grads, tstep.tree_leaves(state.params))
    assert abs(out[False][0] - out[True][0]) <= 1e-2 * abs(out[True][0])
    for n, p in out[True][2].items():
        g_k, g_p = out[False][1][n], out[True][1][n]
        assert torch.isfinite(g_k).all(), n
        gerr = float((g_k - g_p).abs().max())
        by_max, by_rms = gerr / float(g_p.abs().max()), float((g_k - g_p).norm() / g_p.norm())
        print(f"{n}: max |dgrad| / max |grad| {by_max:.3g}, RMS(dgrad) / RMS(grad) {by_rms:.3g}")
        assert by_max <= 2e-2 and by_rms <= 2e-2, (n, by_max, by_rms)
        diff = ((out[False][2][n] - init[n]) - (p - init[n])).abs()
        may_flip = g_p.abs() <= 2 * gerr
        assert not (diff > lr * (5e-2 + 2 * may_flip)).any(), n
