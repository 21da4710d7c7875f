"""The root scripts of the JAX package that the port carries on the CPU:
``tools.gptq_65b_dryrun`` (the GPTQ dry run at the 65B layer shape),
``scripts.make_tiny_checkpoint``, ``scripts.prepare_code_corpus`` and
``scripts.download``, each against the JAX script of the same name.

The dry run quantizes the tree the JAX script builds (params and
calibration ids byte for byte, caught at the call to
``quantize_model_gptq`` in both), prints the JAX record's keys and values
(the seconds aside) and exits 1 above its cap; at ``rows`` 0 its
config has the 65B widths. The tiny checkpoint's tokenizer and config.json
are the JAX script's bytes, and its weights (another RNG) load into both
packages as the same tree with the same logits (f32, rtol 1e-5 of the
largest logit). The code corpus's three files are the JAX script's bytes
on a tree of ``.py`` files the test writes. The download's hub call is
mocked: it receives the JAX script's arguments, and no ``--repo_id``
raises the same ValueError."""

import importlib.util
import json
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from lit_llama_tpu.models import llama as jllama
from lit_llama_tpu.utils import loader as jloader
from lit_llama_tpu_torch.models import llama as tllama
from lit_llama_tpu_torch.scripts import download, make_tiny_checkpoint, prepare_code_corpus
from lit_llama_tpu_torch.tools import gptq_65b_dryrun
from lit_llama_tpu_torch.utils import loader as tloader
from lit_llama_tpu_torch.utils.checkpoint import tree_leaves

ROOT = Path(__file__).resolve().parent.parent
DRYRUN = dict(n_layer=1, n_samples=2, seq=32, rows=256)


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Caught(Exception):
    pass


def _catch(store):
    def quantize(params, config, calib, **kw):
        store.update(params=params, config=config, calib=calib, kw=kw)
        raise _Caught

    return quantize


def test_gptq_dryrun_quantizes_the_jax_scripts_tree(monkeypatch):
    """The tree and the calibration ids each script hands to
    ``quantize_model_gptq``: the same leaves byte for byte, the same ids,
    the same widths, host spilling on in both."""
    from lit_llama_tpu.quant import gptq as jgptq
    from lit_llama_tpu_torch.quant import gptq as tgptq

    want, got = {}, {}
    monkeypatch.setattr(jgptq, "quantize_model_gptq", _catch(want))
    monkeypatch.setattr(tgptq, "quantize_model_gptq", _catch(got))
    with pytest.raises(_Caught):
        _jax_script("gptq_65b_dryrun").main(**DRYRUN)
    with pytest.raises(_Caught):
        gptq_65b_dryrun.main(**DRYRUN, device="cpu")
    w = tree_leaves(jax.tree_util.tree_map(np.asarray, want["params"]))
    g = tree_leaves(got["params"])
    assert sorted(g) == sorted(w)
    for n, a in w.items():
        assert g[n].device.type == "cpu" and g[n].dtype == torch.float32, n
        assert g[n].numpy().tobytes() == np.ascontiguousarray(a).tobytes(), n
    assert np.asarray(got["calib"]).tobytes() == np.asarray(want["calib"]).tobytes()
    assert got["calib"].dtype == np.int32 and got["calib"].shape == (2, 32)
    for field in ("n_layer", "n_head", "n_embd", "intermediate_size", "padded_vocab_size", "block_size",
                  "quant_groupsize"):
        assert getattr(got["config"], field) == getattr(want["config"], field), field
    assert want["kw"] == dict(groupsize=128, batch=2, host_spill=True)
    assert {k: v for k, v in got["kw"].items() if k != "device"} == want["kw"]


def test_gptq_dryrun_prints_the_jax_record(monkeypatch, capsys):
    """The port's run at the CPU cut against the JAX script's record (its
    quantizer faked: the JAX GPTQ itself is held to the port's in
    test_torch_gptq.py): one JSON line, the same keys in the same order and
    the same values but the seconds, ``ok`` true."""
    from lit_llama_tpu.quant import gptq as jgptq

    def quantized(params, config, calib, **kw):
        I, D = config.intermediate_size, config.n_embd
        return {"h": {"attn": {"c_attn": {"qw": np.zeros((1, D // 2, 3 * D), np.uint8)}},
                      "mlp": {"c_proj": {"qw": np.zeros((1, I // 2, D), np.uint8)}}}}

    monkeypatch.setattr(jgptq, "quantize_model_gptq", quantized)
    _jax_script("gptq_65b_dryrun").main(**DRYRUN)
    want = json.loads(capsys.readouterr().out.strip())
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the walk's ~20,000 small ops: a thread, beside the other test workers
    try:
        gptq_65b_dryrun.main(**DRYRUN, device="cpu")
    finally:
        torch.set_num_threads(threads)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert list(got) == list(want)
    assert {k: v for k, v in got.items() if k != "seconds"} == {k: v for k, v in want.items() if k != "seconds"}
    assert got["ok"] is True and got["widths"] == [256, 768]


def test_gptq_dryrun_exits_1_above_its_cap(monkeypatch, capsys):
    """A peak above ``mem_cap_gb`` (faked, as is the quantizer's output):
    the record says ``ok`` false and the exit code is 1."""
    from lit_llama_tpu_torch.quant import gptq as tgptq

    def quantized(params, config, calib, **kw):
        I, D = config.intermediate_size, config.n_embd
        return {"h": {"attn": {"c_attn": {"qw": torch.zeros(1, D // 2, 3 * D, dtype=torch.uint8)}},
                      "mlp": {"c_proj": {"qw": torch.zeros(1, I // 2, D, dtype=torch.uint8)}}}}

    monkeypatch.setattr(tgptq, "quantize_model_gptq", quantized)
    monkeypatch.setattr(gptq_65b_dryrun, "peak_device_gb", lambda dev: 20.0)
    with pytest.raises(SystemExit) as e:
        gptq_65b_dryrun.main(**DRYRUN, mem_cap_gb=14.0, device="cpu")
    assert e.value.code == 1
    rec = json.loads(capsys.readouterr().out.strip())
    assert rec["ok"] is False and rec["peak_device_gb"] == 20.0


def test_gptq_dryrun_full_width_config():
    """At ``rows`` 0 the 65B layer: n_embd 8192, I 22016, 64 heads of 128
    (built, not run)."""
    cfg = gptq_65b_dryrun.dryrun_config(1, 2048, 128, 0)
    assert (cfg.n_embd, cfg.intermediate_size, cfg.n_head, cfg.head_size) == (8192, 22016, 64, 128)
    assert (cfg.n_layer, cfg.block_size, cfg.padded_vocab_size) == (1, 2048, 32000)


def test_make_tiny_checkpoint_matches_jax(tmp_path):
    """The tokenizer and config.json byte for byte; the port's ``.pth``
    loads into both packages as the same tree, with the same logits."""
    kw = dict(n_layer=3, n_head=2, n_embd=256, vocab_size=200, block_size=64)
    _jax_script("make_tiny_checkpoint").main(out_dir=tmp_path / "jax", **kw)
    make_tiny_checkpoint.main(out_dir=tmp_path / "port", **kw)
    for name in ("tokenizer.model", "config.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    jparams, jcfg = jloader.load_model(tmp_path / "port" / "lit-llama.pth")
    tparams, tcfg = tloader.load_model(tmp_path / "port" / "lit-llama.pth", device="cpu")
    jl, tl = tree_leaves(jax.tree_util.tree_map(np.asarray, jparams)), tree_leaves(tparams)
    assert sorted(jl) == sorted(tl)
    for n, a in jl.items():
        assert tl[n].numpy().tobytes() == np.ascontiguousarray(a).tobytes(), n
    ids = np.random.default_rng(0).integers(0, 200, size=(2, 16)).astype(np.int32)
    want = np.asarray(jllama.forward(jparams, ids, jcfg)[0])
    with torch.no_grad():
        got = tllama.forward(tparams, torch.from_numpy(ids).long(), tcfg)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    # the weights come from another generator than JAX's own script's
    assert (tmp_path / "port" / "lit-llama.pth").read_bytes() != (tmp_path / "jax" / "lit-llama.pth").read_bytes()


def test_prepare_code_corpus_matches_jax(tmp_path, monkeypatch):
    """``ROOTS`` pointed at a tree of ``.py`` files (duplicates, a file too
    small, one too large, a ``__pycache__``): tokenizer.model, train.bin and
    val.bin byte for byte the JAX script's."""
    rng = np.random.default_rng(3)
    words = "def return self import class for in if else while yield lambda none true false x y z".split()
    src = tmp_path / "src"
    for i in range(40):
        d = src / f"pkg{i % 4}" / ("__pycache__" if i == 39 else "")
        d.mkdir(parents=True, exist_ok=True)
        lines = [" ".join(rng.choice(words, size=int(rng.integers(2, 9)))) for _ in range(int(rng.integers(4, 80)))]
        (d / f"m{i}.py").write_text("\n".join(lines) + "\n")
    (src / "pkg0" / "copy.py").write_bytes((src / "pkg1" / "m1.py").read_bytes())
    (src / "pkg0" / "tiny.py").write_text("x = 1\n")
    (src / "pkg0" / "big.py").write_text("y = 2\n" * 400)
    jax_mod = _jax_script("prepare_code_corpus")
    roots = (str(src / "pkg0"), str(src / "pkg1"), str(src / "pkg2"), str(src / "pkg3"), str(tmp_path / "absent"))
    monkeypatch.setattr(jax_mod, "ROOTS", roots)
    monkeypatch.setattr(prepare_code_corpus, "ROOTS", roots)
    kw = dict(vocab_size=120, max_mb=1, sample_mb=1, val_fraction=0.05, max_file_kb=2, seed=5)
    jax_mod.prepare(destination_path=tmp_path / "jax", **kw)
    prepare_code_corpus.prepare(destination_path=tmp_path / "port", **kw)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir()) == ["tokenizer.model", "train.bin",
                                                                            "val.bin"]
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    assert (tmp_path / "port" / "val.bin").stat().st_size > 2


def test_download_calls_the_hub_as_jax_does(monkeypatch, tmp_path):
    calls = []
    hub = types.ModuleType("huggingface_hub")
    hub.snapshot_download = lambda *a, **kw: calls.append((a, kw))
    monkeypatch.setitem(sys.modules, "huggingface_hub", hub)
    jax_mod = _jax_script("download")
    for fn in (jax_mod.download_from_hub, download.download_from_hub):
        fn(repo_id="openlm-research/open_llama_7b", local_dir=tmp_path / "7B")
        with pytest.raises(ValueError, match="Please pass --repo_id") as e:
            fn()
        calls.append(str(e.value))
    assert len(calls) == 4 and calls[:2] == calls[2:]
    assert calls[0] == (("openlm-research/open_llama_7b",), dict(local_dir=tmp_path / "7B",
                                                                local_dir_use_symlinks=False,
                                                                allow_patterns=["*.bin", "*.json", "*.model"]))
