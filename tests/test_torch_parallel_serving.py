"""Tensor- and data-parallel serving on the CPU: the port's ``DecodeEngine``
on a (data, model) mesh of gloo ranks (``torch_parallel_ranks``) gives the
JAX engine's greedy tokens on the same weights and prompts, the JAX engine
on a mesh of the 8 virtual CPU devices (after ``tests/test_engine.py``);
data parallelism through the fused int4 serving blocks gives the port's
single-process engine's tokens; sampled tokens agree on every rank; and
``serve.http --model_parallel 2`` answers over HTTP from two ranks under
``torchrun`` and stops cleanly. Tokens are compared exactly.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from lit_llama_tpu import LLaMAConfig, init_params
from lit_llama_tpu.parallel import mesh as jmesh
from lit_llama_tpu.serve.engine import DecodeEngine as JaxEngine
from lit_llama_tpu_torch.data.tokenizer import Tokenizer
from lit_llama_tpu_torch.models import config as tcfg, llama as tllama
from lit_llama_tpu_torch.serve import DecodeEngine
from lit_llama_tpu_torch.utils.convert import pytree_to_lit
from lit_llama_tpu_torch.utils.jax_params import params_from_numpy
from tests import torch_parallel_ranks as ranks

ROOT = Path(__file__).resolve().parent.parent
CFG = dict(block_size=64, vocab_size=97, n_layer=2, n_head=4, n_embd=64)
N_NEW = 6
# (data, model), max_batch, prompt lengths (tests/test_engine.py's meshes, 8 devices cut to 4)
MESHES = {(1, 2): (2, (5, 12)), (4, 1): (4, (5, 12, 3, 17, 9)), (2, 2): (4, (7, 4, 13, 10, 6))}


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, CFG["vocab_size"], size=n).astype(np.int32) for n in lengths]


def _port_config(cfg):
    return tcfg.LLaMAConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                               if f.name not in ("lora", "adapter")})


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy(v) for v in tree)
    return tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


@pytest.fixture(scope="module")
def dense():
    cfg = LLaMAConfig(**CFG)
    return cfg, init_params(cfg, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def int4_model():
    """The tiny int4 model the fused serving blocks take (head size 128),
    in the port's layout as loaded."""
    cfg = tcfg.LLaMAConfig(block_size=128, vocab_size=128, n_layer=2, n_head=4, n_embd=512, quantize="int4",
                           quant_groupsize=128)
    dense_params = tllama.init_params(cfg.replace(quantize=None), torch.Generator().manual_seed(0), device="cpu")
    return cfg, tllama.quantize_params(dense_params, cfg)


def _jax_tokens(cfg, params, mesh_shape, max_batch, prompts):
    data, model = mesh_shape
    mesh = jmesh.make_mesh(data=data, model=model, devices=jax.devices()[: data * model])
    eng = JaxEngine(params, cfg, max_batch=max_batch, mesh=mesh, steps_per_sync=2)
    ids = [eng.submit(p, N_NEW) for p in prompts]
    done = eng.run()
    return [done[i].generated for i in ids]


def _run(mesh_shape, max_batch, prompts, model="dense", **kw):
    return dict(mesh=mesh_shape, model=model, requests=[(p, N_NEW) for p in prompts],
                engine=dict(max_batch=max_batch, steps_per_sync=2), **kw)


@pytest.fixture(scope="module")
def two_ranks(dense, int4_model, tmp_path_factory):
    """One spawn of two ranks: (1, 2) greedy and sampled, and (2, 1) on the
    int4 model through the fused serving blocks (16 slots, 8 a data group)."""
    cfg, params = dense
    prompts = _prompts(MESHES[(1, 2)][1], 3)
    i4_prompts = _prompts((5, 30, 17, 9, 60, 3, 44, 12, 21, 8), 8)
    models = {"dense": dict(config=_port_config(cfg), params=jax.tree_util.tree_map(np.asarray, params)),
              "int4": dict(config=int4_model[0], params=_numpy(int4_model[1]))}
    runs = [_run((1, 2), 2, prompts), _run((1, 2), 2, prompts, temperature=0.8),
            dict(_run((2, 1), 16, i4_prompts, model="int4"), engine=dict(max_batch=16, steps_per_sync=4,
                                                                          max_seq_length=96))]
    return i4_prompts, ranks.run("engine_runs", 2, tmp_path_factory.mktemp("serve2"),
                                 {"models": models, "runs": runs})


@pytest.fixture(scope="module")
def four_ranks(dense, tmp_path_factory):
    """One spawn of four ranks: (4, 1) greedy with a max_batch of 3 refused
    first, (2, 2) greedy and sampled."""
    cfg, params = dense
    models = {"dense": dict(config=_port_config(cfg), params=jax.tree_util.tree_map(np.asarray, params))}
    runs = [_run((4, 1), 4, _prompts(MESHES[(4, 1)][1], 5), bad_max_batch=3),
            _run((2, 2), 4, _prompts(MESHES[(2, 2)][1], 6)),
            _run((2, 2), 4, _prompts(MESHES[(2, 2)][1], 6), temperature=0.8)]
    return ranks.run("engine_runs", 4, tmp_path_factory.mktemp("serve4"), {"models": models, "runs": runs})


@pytest.mark.parametrize("mesh_shape", list(MESHES), ids=lambda m: f"data{m[0]}_model{m[1]}")
def test_engine_on_a_mesh_matches_the_jax_engine(dense, two_ranks, four_ranks, mesh_shape):
    """Greedy tokens of every request, on every rank, equal the JAX engine's
    on the same mesh shape (which tests/test_engine.py holds to one device)."""
    cfg, params = dense
    max_batch, lengths = MESHES[mesh_shape]
    seed = {(1, 2): 3, (4, 1): 5, (2, 2): 6}[mesh_shape]
    want = _jax_tokens(cfg, params, mesh_shape, max_batch, _prompts(lengths, seed))
    results = two_ranks[1] if mesh_shape == (1, 2) else four_ranks
    run = {(1, 2): 0, (4, 1): 0, (2, 2): 1}[mesh_shape]
    for rank, out in enumerate(results):
        assert out[run]["tokens"] == want, f"rank {rank}"
        assert out[run]["local_slots"] == max_batch // mesh_shape[0]


def test_max_batch_must_divide_over_the_data_axis(four_ranks):
    for out in four_ranks:
        assert "max_batch=3 must be divisible by the mesh data axis (4)" in out[0]["bad_max_batch"]


@pytest.mark.parametrize("world", [2, 4])
def test_sampled_tokens_agree_on_every_rank(two_ranks, four_ranks, world):
    """Temperature 0.8: every rank holds the same tokens for every request
    (a model group samples the same gathered logits with generators seeded
    alike; data groups' tokens are gathered), and they are not all greedy."""
    results, run, greedy = (two_ranks[1], 1, 0) if world == 2 else (four_ranks, 2, 1)
    toks = results[0][run]["tokens"]
    assert len(toks) == len(results[0][greedy]["tokens"]) and all(len(t) == N_NEW for t in toks)
    for rank, out in enumerate(results):
        assert out[run]["tokens"] == toks, f"rank {rank}"
    assert toks != results[0][greedy]["tokens"]


def test_data_parallel_fused_serving_matches_one_process(int4_model, two_ranks):
    """(2, 1) on the int4 model: each data group decodes its 8 of 16 slots
    through the fused serving blocks (K7-K9's plain versions here), and every
    request's greedy tokens equal the single-process engine's at 16 slots."""
    cfg, params = int4_model
    prompts, results = two_ranks
    eng = DecodeEngine(params, cfg, max_batch=16, steps_per_sync=4, max_seq_length=96, device="cpu")
    assert eng.serve_fused
    ids = [eng.submit(p, N_NEW) for p in prompts]
    done = eng.run()
    want = [done[i].generated for i in ids]
    for rank, out in enumerate(results):
        assert out[2]["serve_fused"] and out[2]["local_slots"] == 8
        assert out[2]["tokens"] == want, f"rank {rank}"
    # each data group prefilled only its own slots' prompts
    assert sum(out[2]["prefills"] for out in results) == len(prompts)


# --- serve.http --model_parallel 2 under torchrun ---------------------------

HTTP_CFG = dict(block_size=128, vocab_size=256, n_layer=2, n_head=4, n_embd=64)
TEXTS = ["the quick brown fox", "a lazy dog", "pack my box with five dozen jugs"]
TIMEOUT = 60


def _post(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    with urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=TIMEOUT) as r:
        return json.loads(r.read())


def test_serve_http_model_parallel_two_ranks_under_torchrun(tmp_path):
    """Two CPU ranks: rank 0 answers /health and concurrent greedy requests
    with the single-process engine's tokens; SIGTERM stops rank 0's server,
    then rank 1's engine, and both report it."""
    (tmp_path / "corpus.txt").write_text("\n".join(TEXTS * 3 + ["over liquor and wizards boxing"]))
    Tokenizer.train(str(tmp_path / "corpus.txt"), str(tmp_path), 120)
    tok = Tokenizer(tmp_path / "tokenizer.model")
    cfg = tcfg.LLaMAConfig(**HTTP_CFG)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    torch.save(pytree_to_lit(params, cfg), tmp_path / "lit-llama.pth")
    (tmp_path / "config.json").write_text(json.dumps(HTTP_CFG))
    log = tmp_path / "serve.log"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
           "-m", "lit_llama_tpu_torch.serve.http", "--device", "cpu", "--model_parallel", "2", "--port", "0",
           "--checkpoint_path", str(tmp_path / "lit-llama.pth"), "--tokenizer_path", str(tmp_path / "tokenizer.model"),
           "--max_batch", "2", "--max_seq_length", "64"]
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT,
                                env={**os.environ, "OMP_NUM_THREADS": "2"})
    try:
        url = None
        deadline = time.monotonic() + 120
        while url is None and time.monotonic() < deadline and proc.poll() is None:
            time.sleep(0.2)
            lines = [ln for ln in log.read_text().splitlines() if ln.startswith("serving on ")]
            url = lines[0].split()[-1] if lines else None
        assert url, log.read_text()[-3000:]
        assert _post(url + "/health") == {"active": 0, "queued": 0}
        with ThreadPoolExecutor(len(TEXTS)) as pool:
            replies = list(pool.map(lambda t: _post(url + "/generate", {"prompt": t, "max_new_tokens": 6,
                                                                       "temperature": 0}), TEXTS))
        eng = DecodeEngine(params, cfg, max_batch=2, max_seq_length=64, device="cpu")
        ids = [eng.submit(tok.encode(t, bos=True), 6, eos_id=tok.eos_id) for t in TEXTS]
        done = eng.run()
        assert [r["tokens"] for r in replies] == [done[i].generated for i in ids]
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=TIMEOUT)
        text = log.read_text()
        assert "[serve] rank 0: stopped" in text and "[serve] rank 1: stopped by rank 0" in text, text[-3000:]
        assert "backend gloo" in text
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=TIMEOUT)
