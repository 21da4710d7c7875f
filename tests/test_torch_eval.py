"""Perplexity evaluation and the quantize -> evaluate -> generate entry points
of the port against the JAX package on the CPU: ``eval.perplexity``,
``evaluate.{full,lora,adapter,adapter_v2,eval_quality}``, ``quantize.gptq``
and ``generate.full`` against the JAX CLIs on the same files, and the hub
branches through a fake ``datasets`` module.

Tolerances: perplexity relative 1e-5 in f32 (the NLL sums in another
order); a printed perplexity (4 decimals) relative 1e-4; GPTQ leaves and
GPTQ perplexity under actorder as ``tests/test_torch_gptq.py`` holds them
(``MODEL_REL``, ``QUALITY_SHARE``); greedy text equal.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lit_llama_tpu.data.tokenizer import Tokenizer as JaxTokenizer
from lit_llama_tpu.eval import perplexity as jppl
from lit_llama_tpu.models.llama import unstack_layers as junstack
from lit_llama_tpu.training.loop import _config_meta as jconfig_meta
from lit_llama_tpu.utils import checkpoint as jckpt
from lit_llama_tpu.utils import loader as jloader
from lit_llama_tpu_torch.data.tokenizer import Tokenizer
from lit_llama_tpu_torch.eval import perplexity as tppl
from lit_llama_tpu_torch.evaluate import adapter as t_eval_adapter
from lit_llama_tpu_torch.evaluate import adapter_v2 as t_eval_adapter_v2
from lit_llama_tpu_torch.evaluate import eval_quality as t_eval_quality
from lit_llama_tpu_torch.evaluate import full as t_eval_full
from lit_llama_tpu_torch.evaluate import lora as t_eval_lora
from lit_llama_tpu_torch.generate import full as t_gen_full
from lit_llama_tpu_torch.models import llama
from lit_llama_tpu_torch.models.config import AdapterConfig, LoRAConfig
from lit_llama_tpu_torch.peft import adapter as tadapter
from lit_llama_tpu_torch.quantize import gptq as t_quantize
from lit_llama_tpu_torch.utils import checkpoint as tckpt
from lit_llama_tpu_torch.utils import loader as tloader
from lit_llama_tpu_torch.utils.checkpoint import tree_leaves
from lit_llama_tpu_torch.utils.memory import peak_memory_gb
from lit_llama_tpu_torch.utils.random_params import random_lora_overlay
from tests.test_eval_datasets import _StubTok, fake_datasets  # noqa: F401 (a fixture)
from tests.test_torch_gptq import MODEL_REL, QUALITY_SHARE

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-5
PRINTED_REL = 1e-4
LINES = ("the quick brown fox jumps over the lazy dog\n"
         "pack my box with five dozen liquor jugs\n"
         "how vexingly quick daft zebras jump\n")


def _jax_cli(rel: str):
    """A root CLI of the JAX package, imported from its file."""
    spec = importlib.util.spec_from_file_location("jax_cli_" + rel.replace("/", "_")[:-3], ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """scripts/make_tiny_checkpoint.py at 3 layers (an adapter's start layer
    is 2), and a text file of the tokenizer's corpus."""
    out = tmp_path_factory.mktemp("tiny")
    mod = _jax_cli("scripts/make_tiny_checkpoint.py")
    mod.main(out_dir=out, n_layer=3)
    (out / "eval.txt").write_text(LINES * 20)
    return out


def _ppl(out: str) -> float:
    return float(out.split("perplexity:")[1].split()[0])


def test_perplexity_matches_jax(tiny):
    """``_window_nll`` and ``perplexity`` on the tiny model in f32, all windows
    and ``max_windows``; too few tokens raise as in JAX."""
    jparams, jcfg = jloader.load_model(tiny / "lit-llama.pth")
    tparams, tcfg = tloader.load_model(tiny / "lit-llama.pth", device="cpu")
    tokens = np.asarray(JaxTokenizer(tiny / "tokenizer.model").encode(LINES * 10))
    window = tokens[None, :64]
    jn, jc = jppl._window_nll(junstack(jparams), jnp.asarray(window), jcfg)
    tn, tc = tppl._window_nll(tparams, torch.from_numpy(window).long(), tcfg)
    assert tc == int(jc) == 63
    assert abs(float(tn) - float(jn)) <= REL * abs(float(jn))
    for max_windows in (None, 2):
        want = jppl.perplexity(junstack(jparams), tokens, jcfg, block_size=64, max_windows=max_windows)
        got = tppl.perplexity(llama.unstack_layers(tparams), tokens, tcfg, block_size=64, max_windows=max_windows)
        assert abs(got - want) <= REL * want, (max_windows, got, want)
    with pytest.raises(ValueError, match="need at least 64 tokens for one window, got 63"):
        tppl.perplexity(tparams, tokens[:63], tcfg, block_size=64)


def test_load_eval_tokens_text_and_bin(tiny, tmp_path):
    """Text through each package's tokenizer gives the same ids; a ``.bin``
    is read as uint16 in both, ids past 32767 included, and so is one that
    was written as int32 (JAX's reader takes its halves as ids)."""
    jfull = _jax_cli("evaluate/full.py")
    text = tiny / "eval.txt"
    want = jfull.load_eval_tokens("wikitext", text, JaxTokenizer(tiny / "tokenizer.model"))
    got = t_eval_full.load_eval_tokens("wikitext", text, Tokenizer(tiny / "tokenizer.model"))
    assert got.dtype == np.int32 and got[0] == 1
    np.testing.assert_array_equal(got, want)
    ids = np.array([1, 5, 40000, 65535, 7], np.uint16)
    for dtype in (np.uint16, np.int32):
        ids.astype(dtype).tofile(tmp_path / "toks.bin")
        want = jfull.load_eval_tokens("wikitext", tmp_path / "toks.bin", None)
        got = t_eval_full.load_eval_tokens("wikitext", tmp_path / "toks.bin", None)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32
    np.testing.assert_array_equal(got[::2], ids)  # int32 written, uint16 read: the ids and their zero halves


def test_hub_branches_through_fake_datasets(fake_datasets):  # noqa: F811
    """``load_eval_text`` for each corpus and GPTQ's C4 calibration branch
    make the JAX package's calls and give its results."""
    jfull = _jax_cli("evaluate/full.py")
    jquant = _jax_cli("quantize/gptq.py")
    for name in ("wikitext", "ptb", "c4"):
        assert t_eval_full.load_eval_text(name) == jfull.load_eval_text(name)
    assert len(fake_datasets.calls) == 6 and fake_datasets.calls[0::2] == fake_datasets.calls[1::2]
    with pytest.raises(ValueError, match="unknown dataset"):
        t_eval_full.load_eval_tokens("nope", None, _StubTok())
    np.testing.assert_array_equal(t_eval_full.load_eval_tokens("wikitext", None, _StubTok()),
                                  jfull.load_eval_tokens("wikitext", None, _StubTok()))
    fake_datasets.calls.clear()
    got = t_quantize.get_sample_data(_StubTok(), 4, 16, None, 256)
    want = jquant.get_sample_data(_StubTok(), 4, 16, None, 256)
    assert got.dtype == np.int32 and got.shape == (4, 16)
    np.testing.assert_array_equal(got, want)
    assert fake_datasets.calls[0] == fake_datasets.calls[1]
    assert fake_datasets.calls[0][2]["data_files"] == {"train": "en/c4-train.00000-of-01024.json.gz"}


def test_gptq_calibration_fallback_to_random_tokens(monkeypatch, capsys):
    import types

    def fail(*a, **k):
        raise ConnectionError("no network")

    monkeypatch.setitem(sys.modules, "datasets", types.SimpleNamespace(load_dataset=fail))
    jquant = _jax_cli("quantize/gptq.py")
    got = t_quantize.get_sample_data(_StubTok(), 3, 8, None, 100)
    assert "calibration download failed (no network); using random tokens" in capsys.readouterr().err
    np.testing.assert_array_equal(got, jquant.get_sample_data(_StubTok(), 3, 8, None, 100))


def test_gptq_calibration_from_a_file_matches_jax(tiny):
    jquant = _jax_cli("quantize/gptq.py")
    for n, T in ((4, 32), (64, 64)):  # the second tiles the text
        got = t_quantize.get_sample_data(Tokenizer(tiny / "tokenizer.model"), n, T, tiny / "eval.txt", 256)
        want = jquant.get_sample_data(JaxTokenizer(tiny / "tokenizer.model"), n, T, tiny / "eval.txt", 256)
        assert got.shape == (n, T) and got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def _eval_args(tiny):
    return dict(tokenizer_path=tiny / "tokenizer.model", data_file=tiny / "eval.txt", block_size=64, max_windows=3)


@pytest.mark.parametrize("quantize", [None, "llm.int8", "gptq.int4"])
def test_evaluate_full_matches_jax_cli(tiny, capsys, quantize):
    _jax_cli("evaluate/full.py").main(checkpoint_path=tiny / "lit-llama.pth", quantize=quantize, **_eval_args(tiny))
    want = _ppl(capsys.readouterr().out)
    t_eval_full.main(checkpoint_path=tiny / "lit-llama.pth", quantize=quantize, device="cpu", **_eval_args(tiny))
    got = _ppl(capsys.readouterr().out)
    assert abs(got - want) <= PRINTED_REL * want, (got, want)


def test_evaluate_lora_matches_jax_cli(tiny, tmp_path, capsys):
    """A native LoRA directory (r = 4, B drawn, not zero) on the tiny base."""
    _, cfg = tloader.load_model(tiny / "lit-llama.pth", device="cpu")
    overlay = random_lora_overlay(cfg.replace(lora=LoRAConfig(r=4)), seed=3, device="cpu")
    tckpt.save_checkpoint(tmp_path / "lora", {"params": overlay})
    args = dict(lora_path=tmp_path / "lora", checkpoint_path=tiny / "lit-llama.pth", lora_alpha=8.0, **_eval_args(tiny))
    _jax_cli("evaluate/lora.py").main(**args)
    want = _ppl(capsys.readouterr().out)
    t_eval_lora.main(device="cpu", **args)
    got = _ppl(capsys.readouterr().out)
    assert abs(got - want) <= PRINTED_REL * want, (got, want)
    t_eval_full.main(checkpoint_path=tiny / "lit-llama.pth", device="cpu", **_eval_args(tiny))
    assert abs(_ppl(capsys.readouterr().out) - got) > 1e-3, "the overlay changed nothing"


@pytest.mark.parametrize("v2", [False, True])
def test_evaluate_adapter_matches_jax_cli(tiny, tmp_path, capsys, v2):
    """An adapter directory as finetuning saves one (the trainable leaves, no
    ``adapter_active``; prompt length 10, start layer 2, the gates of layers
    below it zero as training leaves them), with drawn gates and v2 leaves."""
    params, cfg = tloader.load_model(tiny / "lit-llama.pth", device="cpu")
    cfg = cfg.replace(adapter=AdapterConfig(v2=v2))
    params = tadapter.add_adapter_params(params, cfg, torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(5)
    h = params["h"]
    h["gating"][2:] = torch.randn(h["gating"][2:].shape, generator=g)
    if v2:
        for node in (h["attn"]["c_attn"], h["attn"]["c_proj"], h["mlp"]["c_fc1"], h["mlp"]["c_fc2"],
                     h["mlp"]["c_proj"], params["lm_head"]):
            node["av2_bias"] = torch.randn(node["av2_bias"].shape, generator=g) * 0.05
            node["av2_scale"] = 1.0 + torch.randn(node["av2_scale"].shape, generator=g) * 0.05
    state = tadapter.adapter_state(params, v2)
    assert "adapter_active" not in state["h"]
    tckpt.save_checkpoint(tmp_path / "adapter", {"params": state})
    args = dict(adapter_path=tmp_path / "adapter", checkpoint_path=tiny / "lit-llama.pth", **_eval_args(tiny))
    _jax_cli("evaluate/adapter_v2.py" if v2 else "evaluate/adapter.py").main(**args)
    want = _ppl(capsys.readouterr().out)
    (t_eval_adapter_v2 if v2 else t_eval_adapter).main(device="cpu", **args)
    got = _ppl(capsys.readouterr().out)
    assert abs(got - want) <= PRINTED_REL * want, (got, want)


@pytest.fixture(scope="module")
def gptq_dirs(tiny):
    """``quantize.gptq`` of the port and the JAX CLI on the same .pth and
    calibration text."""
    out = tiny / "gptq"
    args = dict(checkpoint_path=tiny / "lit-llama.pth", tokenizer_path=tiny / "tokenizer.model", n_samples=4,
                block_size=32, groupsize=32, data_file=tiny / "eval.txt")
    _jax_cli("quantize/gptq.py").main(output_path=out / "jax", **args)
    t_quantize.main(output_path=out / "port", device="cpu", **args)
    return out / "jax", out / "port"


def test_quantize_gptq_matches_jax_cli(gptq_dirs):
    """The port's directory holds JAX's leaves and metadata; both packages'
    loaders read it, and their logits on it agree."""
    jdir, tdir = gptq_dirs
    assert tckpt.load_metadata(tdir) == jckpt.load_metadata(jdir)
    assert tckpt.load_metadata(tdir)["config"]["quantize"] == "int4"
    want = tree_leaves(tckpt.load_checkpoint(jdir))
    got = tree_leaves(tckpt.load_checkpoint(tdir))
    assert sorted(got) == sorted(want)
    for name, a in want.items():
        b = got[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype == torch.uint8:
            assert torch.equal(a, b), name
        else:
            assert float((a - b).abs().max()) <= MODEL_REL * float(a.abs().max()), name
    jparams, jcfg = jloader.load_model(tdir)
    tparams, tcfg = tloader.load_model(tdir, device="cpu")
    assert (tcfg.quantize, tcfg.quant_groupsize) == (jcfg.quantize, jcfg.quant_groupsize) == ("int4", 32)
    tokens = np.arange(1, 41, dtype=np.int32)[None] % 256
    from lit_llama_tpu import forward as jforward

    wl = np.asarray(jforward(jparams, jnp.asarray(tokens), jcfg)[0])
    gl = llama.forward(tparams, torch.from_numpy(tokens).long(), tcfg)[0].numpy()
    assert np.abs(gl - wl).max() <= REL * np.abs(wl).max()


def test_evaluate_and_generate_on_gptq_output(tiny, gptq_dirs, capsys):
    """``evaluate.full`` and ``generate.full`` (greedy, the alpaca template)
    on the port's GPTQ directory against the JAX CLIs on JAX's; then
    ``evaluate.full`` as ``python -m`` with ``--device cpu``."""
    jdir, tdir = gptq_dirs
    _jax_cli("evaluate/full.py").main(checkpoint_path=jdir, **_eval_args(tiny))
    want = _ppl(capsys.readouterr().out)
    t_eval_full.main(checkpoint_path=tdir, device="cpu", **_eval_args(tiny))
    got = _ppl(capsys.readouterr().out)
    assert abs(got - want) <= PRINTED_REL * want, (got, want)
    gen = dict(prompt="the quick", max_new_tokens=8, temperature=0.0, tokenizer_path=tiny / "tokenizer.model")
    _jax_cli("generate/full.py").main(checkpoint_path=jdir, **gen)
    want_text = capsys.readouterr().out
    t_gen_full.main(checkpoint_path=tdir, device="cpu", **gen)
    captured = capsys.readouterr()
    assert captured.out == want_text and want_text.strip()
    assert "Token ids 1: [" in captured.err

    args = ["--checkpoint_path", str(tdir), "--tokenizer_path", str(tiny / "tokenizer.model"), "--data_file",
            str(tiny / "eval.txt"), "--block_size", "64", "--max_windows", "3", "--device", "cpu"]
    proc = subprocess.run([sys.executable, "-m", "lit_llama_tpu_torch.evaluate.full"] + args, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert _ppl(proc.stdout) == got


def test_eval_quality_matches_jax_cli(tiny, tmp_path, capsys):
    """The perplexity ladder on a native checkpoint with ``train.bin`` /
    ``val.bin``: the same summary keys, each rung's perplexity as JAX's (GPTQ
    under actorder within ``QUALITY_SHARE`` of it)."""
    jparams, jcfg = jloader.load_model(tiny / "lit-llama.pth")
    jckpt.save_checkpoint(tmp_path / "ckpt", {"params": jax.tree_util.tree_map(np.asarray, jparams)},
                          metadata={"config": jconfig_meta(jcfg)})
    rng = np.random.default_rng(11)
    (tmp_path / "data").mkdir()
    rng.integers(0, 256, size=2000).astype(np.uint16).tofile(tmp_path / "data" / "train.bin")
    rng.integers(0, 256, size=300).astype(np.uint16).tofile(tmp_path / "data" / "val.bin")
    args = dict(ckpt_dir=tmp_path / "ckpt", data_dir=tmp_path / "data", groupsize=32, n_calib=4, calib_block=32,
                max_windows=2)
    _jax_cli("scripts/eval_quality.py").main(out_json=tmp_path / "jax.json", **args)
    t_eval_quality.main(out_json=tmp_path / "port.json", device="cpu", **args)
    out = capsys.readouterr().out
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert json.loads(out.strip().splitlines()[-1]) == got
    assert got.keys() == want.keys() and got["ppl"].keys() == want["ppl"].keys()
    assert (got["metric"], got["groupsize"], got["actorder"]) == (want["metric"], want["groupsize"], want["actorder"])
    for name in ("bf16", "int8", "rtn-int4"):
        assert abs(got["ppl"][name] - want["ppl"][name]) <= PRINTED_REL * want["ppl"][name], name
    assert abs(got["ppl"]["gptq-int4"] - want["ppl"]["gptq-int4"]) <= QUALITY_SHARE * want["ppl"]["gptq-int4"]
    gap = (got["ppl"]["gptq-int4"] - got["ppl"]["bf16"]) <= (got["ppl"]["rtn-int4"] - got["ppl"]["bf16"]) + 1e-6
    assert got["gptq_closes_gap"] == gap


def test_peak_memory_gb_is_none_on_the_cpu():
    assert peak_memory_gb("cpu") is None
    if not torch.cuda.is_available():
        assert peak_memory_gb() is None
