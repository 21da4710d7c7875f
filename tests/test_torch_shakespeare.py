"""Shakespeare pretraining on the CPU: the batcher draws the JAX script's
(x, y) for the same seed, in the same order between training and
validation; a 3-step run saves, and ``--resume`` from its step-2 checkpoint
(a subprocess) ends on the unbroken run's params and optimizer state; the
multi-device flags raise."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lit_llama_tpu_torch.pretrain import shakespeare
from lit_llama_tpu_torch.scripts import prepare_shakespeare
from lit_llama_tpu_torch.training import step as tstep
from lit_llama_tpu_torch.utils import checkpoint as tckpt

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(n_layer=2, n_embd=64, n_head=4, block_size=16, vocab_size=100)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("shakespeare")
    rng = np.random.default_rng(0)
    words = "to be or not that is the question whether tis nobler in mind suffer slings arrows".split()
    (d / "input.txt").write_text("\n".join(" ".join(rng.choice(words, size=10)) for _ in range(300)))
    prepare_shakespeare.prepare(destination_path=d, vocab_size=100)
    return d


def test_batches_match_jax(data_dir, monkeypatch):
    """The JAX script's train and validation batches, captured from its loop
    (two steps, a validation batch, a third step), against the port's
    ``get_batches`` over one shared generator in the same order."""
    monkeypatch.setenv("LIT_LLAMA_TPU_PLATFORM", "cpu")
    spec = importlib.util.spec_from_file_location("jax_pretrain_shakespeare", ROOT / "pretrain" / "shakespeare.py")
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    from lit_llama_tpu.training import loop as jloop

    captured = {}
    monkeypatch.setattr(jloop, "validate_on", lambda batches_fn, config, eval_iters: batches_fn)

    def fake_train(state, batches, config, optimizer, lc, validate_fn=None, remat_policy=None):
        captured["seq"] = [next(batches), next(batches), next(validate_fn()), next(batches)]
        return state

    monkeypatch.setattr(jloop, "train", fake_train)
    jmod.main(data_dir=data_dir, out_dir=data_dir / "jax_out", batch_size=4, micro_batch_size=2, max_iters=3,
              **TINY)
    train = np.memmap(data_dir / "train.bin", dtype=np.uint16, mode="r")
    val = np.memmap(data_dir / "val.bin", dtype=np.uint16, mode="r")
    rng = np.random.default_rng(1337)
    tr = shakespeare.get_batches(train, 16, 2, 2, rng)
    got = [next(tr), next(tr), next(shakespeare.get_batches(val, 16, 2, 2, rng)), next(tr)]
    for (gx, gy), (wx, wy) in zip(got, captured["seq"]):
        assert gx.shape == (2, 2, 16) and gx.dtype == np.int32
        assert np.array_equal(gx, wx) and np.array_equal(gy, wy)
        assert np.array_equal(gx[..., 1:], gy[..., :-1])


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_resume_equals_an_unbroken_run(data_dir, tmp_path, one_thread):
    """Three steps with a validation and a checkpoint at step 2, then
    ``--resume`` from that checkpoint in a subprocess (one thread, as here):
    its ``final`` holds the unbroken run's params and optimizer state."""
    kw = dict(data_dir=data_dir, batch_size=4, micro_batch_size=2, max_iters=3, eval_interval=2, eval_iters=2,
              device="cpu", **TINY)
    state = shakespeare.main(out_dir=tmp_path / "a", **kw)
    assert int(state.step) == 3
    recs = [json.loads(line) for line in (tmp_path / "a" / "metrics.jsonl").read_text().splitlines()]
    assert [r["iter"] for r in recs if "loss" in r] == [0, 1, 2] and [r["iter"] for r in recs if "val_loss" in r] == [1]
    assert all(np.isfinite(r.get("loss", r.get("val_loss"))) for r in recs)
    assert (tmp_path / "a" / "iter-000002" / "manifest.json").exists()

    cmd = [sys.executable, "-m", "lit_llama_tpu_torch.pretrain.shakespeare", "--device", "cpu",
           "--resume", str(tmp_path / "a" / "iter-000002"), "--out_dir", str(tmp_path / "b")]
    cmd += [f"--{k}={v}" for k, v in kw.items() if k != "device"]
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    subprocess.run(cmd, cwd=ROOT, check=True, timeout=300, env=env)
    unbroken, resumed = (tckpt.load_checkpoint(tmp_path / d / "final") for d in ("a", "b"))
    assert int(unbroken["step"]) == int(resumed["step"]) == 3
    a, b = tstep.tree_leaves(unbroken), tstep.tree_leaves(resumed)
    assert set(a) == set(b) and any(n.startswith("opt_state") for n in a)
    for n in a:
        assert torch.equal(a[n], b[n]), n
    recs = [json.loads(line) for line in (tmp_path / "b" / "metrics.jsonl").read_text().splitlines()]
    assert [r["iter"] for r in recs] == [2]


@pytest.mark.parametrize("flags", [dict(model_parallel=2), dict(data_parallel=2)])
def test_multi_device_flags_raise(data_dir, tmp_path, flags):
    with pytest.raises(NotImplementedError, match="multi-device"):
        shakespeare.main(data_dir=data_dir, out_dir=tmp_path, device="cpu", **flags, **TINY)
