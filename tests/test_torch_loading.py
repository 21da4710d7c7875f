"""Loading in the port: a checkpoint written as scripts/make_tiny_checkpoint.py
writes it (``.pth`` + ``config.json``) and a native directory load into both
packages with equal tensors; a LoRA overlay in the reference ``.pth`` format
and as a native directory gives the same tree and rank in both, a reference
adapter ``.pth`` the same overlay; the
tokenizer's ids and text equal the JAX Tokenizer's; and the LoRA entry point
runs on the CPU."""

import ast
import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from lit_llama_tpu.data import sp_model as j_sp
from lit_llama_tpu.data.tokenizer import Tokenizer as JaxTokenizer
from lit_llama_tpu.utils import checkpoint as jckpt
from lit_llama_tpu.utils import convert as jconvert
from lit_llama_tpu.utils import loader as jloader
from lit_llama_tpu_torch.data import sft as tsft
from lit_llama_tpu_torch.data import sp_model as t_sp
from lit_llama_tpu_torch.data.tokenizer import Tokenizer
from lit_llama_tpu_torch.models.config import LLaMAConfig, LoRAConfig
from lit_llama_tpu_torch.models.generate import generate
from lit_llama_tpu_torch.peft import lora as tlora
from lit_llama_tpu_torch.utils import convert as tconvert
from lit_llama_tpu_torch.utils import loader as tloader
from lit_llama_tpu_torch.utils.checkpoint import tree_leaves
from lit_llama_tpu_torch.utils.random_params import random_lora_overlay

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny lit-llama checkpoint and tokenizer of scripts/make_tiny_checkpoint.py."""
    out = tmp_path_factory.mktemp("tiny")
    spec = importlib.util.spec_from_file_location("make_tiny_checkpoint", ROOT / "scripts" / "make_tiny_checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(out_dir=out)
    return out


def _leaves_equal(jtree, ttree):
    jl = tree_leaves(jax.tree_util.tree_map(np.asarray, jtree))
    tl = tree_leaves(ttree)
    assert sorted(jl) == sorted(tl)
    for name, a in jl.items():
        t = tl[name]
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(a), err_msg=name)


@pytest.mark.parametrize("quantize", [None, "gptq.int4", "llm.int8"])
def test_pth_loads_into_both_packages(tiny, quantize):
    """The .pth with its config.json, dense or quantized at load: the same
    config and bit-equal tensors (f32 on the CPU in both)."""
    jparams, jcfg = jloader.load_model(tiny / "lit-llama.pth", quantize)
    tparams, tcfg = tloader.load_model(tiny / "lit-llama.pth", quantize, device="cpu")
    for field in ("n_layer", "n_head", "n_embd", "vocab_size", "padded_vocab_size", "block_size", "quantize",
                  "quant_groupsize", "param_dtype", "compute_dtype"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    _leaves_equal(jparams, tparams)


def test_native_dir_loads_into_both_packages(tiny, tmp_path):
    """A native checkpoint directory of dense weights (as the JAX package
    saves one), loaded as it is and with int4 quantization at load."""
    jparams, jcfg = jloader.load_model(tiny / "lit-llama.pth")
    meta = {"config": {k: getattr(jcfg, k) for k in ("block_size", "vocab_size", "n_layer", "n_head", "n_embd")}}
    jckpt.save_checkpoint(tmp_path / "native", jparams, metadata=meta)
    for quantize in (None, "int4"):
        want, wcfg = jloader.load_model(tmp_path / "native", quantize)
        got, gcfg = tloader.load_model(tmp_path / "native", quantize, device="cpu")
        assert (gcfg.n_embd, gcfg.quantize, gcfg.quant_groupsize) == (wcfg.n_embd, wcfg.quantize, wcfg.quant_groupsize)
        _leaves_equal(want, got)
    with pytest.raises(ValueError, match="re-quantize"):
        tloader.load_model(_quantized_dir(tmp_path, jparams, jcfg), "int8", device="cpu")


def _quantized_dir(tmp_path, jparams, jcfg):
    from lit_llama_tpu.models import llama as jllama

    cfg = jcfg.replace(quantize="int4", quant_groupsize=32)
    path = tmp_path / "native_int4"
    jckpt.save_checkpoint(path, jllama.quantize_params(jparams, cfg), metadata={"config": {
        "n_layer": cfg.n_layer, "n_head": cfg.n_head, "n_embd": cfg.n_embd, "vocab_size": cfg.vocab_size,
        "block_size": cfg.block_size, "quantize": "int4", "quant_groupsize": 32}})
    return path


def test_lora_overlay_both_formats(tmp_path):
    """A LoRA overlay as a reference-format .pth (lora_A / lora_B) and as a
    native directory: both packages read the same tree and rank from each,
    and write the same reference state dict."""
    cfg = LLaMAConfig(block_size=64, vocab_size=256, n_layer=2, n_head=4, n_embd=64,
                      lora=LoRAConfig(r=4, alpha=8.0))
    overlay = random_lora_overlay(cfg, seed=3, device="cpu")
    sd = tconvert.lora_overlay_to_sd(overlay, cfg)
    jsd = jconvert.lora_overlay_to_sd(jax.tree_util.tree_map(lambda t: t.numpy(), overlay), cfg)
    assert sorted(sd) == sorted(jsd)
    for name in sd:
        np.testing.assert_array_equal(sd[name].numpy(), jsd[name])
    torch.save(sd, tmp_path / "lora.pth")
    jckpt.save_checkpoint(tmp_path / "lora_dir", jax.tree_util.tree_map(lambda t: t.numpy(), overlay))
    from lit_llama_tpu.models.config import LLaMAConfig as JaxConfig

    jcfg = JaxConfig(block_size=64, vocab_size=256, n_layer=2, n_head=4, n_embd=64)
    for path in (tmp_path / "lora.pth", tmp_path / "lora_dir"):
        jkind, jov, jinfo = jloader.load_peft_checkpoint(path, jcfg)
        kind, ov, info = tloader.load_peft_checkpoint(path, cfg.replace(lora=None), device="cpu")
        assert (kind, info) == (jkind, jinfo) == ("lora", {"r": 4})
        _leaves_equal(jov, ov)
        _leaves_equal(jov, overlay)
    with pytest.raises(ValueError, match="neither"):
        torch.save({"transformer.wte.weight": torch.zeros(2, 2)}, tmp_path / "plain.pth")
        tloader.load_peft_checkpoint(tmp_path / "plain.pth", cfg, device="cpu")
    # a reference-format adapter .pth (it once raised): the same overlay and info in both packages
    adapter_sd = {f"transformer.h.{i}.attn.adapter_wte.weight": torch.randn(10, 64, generator=torch.Generator().manual_seed(i))
                  for i in (1,)}
    adapter_sd["transformer.h.1.attn.gating_factor"] = torch.full((1, 4, 1, 1), 0.5)
    torch.save(adapter_sd, tmp_path / "adapter.pth")
    jkind, jov, jinfo = jloader.load_peft_checkpoint(tmp_path / "adapter.pth", jcfg)
    kind, ov, info = tloader.load_peft_checkpoint(tmp_path / "adapter.pth", cfg.replace(lora=None), device="cpu")
    assert (kind, info) == (jkind, jinfo) == ("adapter", {"prompt_length": 10, "start_layer": 1, "v2": False})
    _leaves_equal(jov, ov)


TEXTS = ["the quick brown fox", "  pack my   box\nwith five", "how vexingly quick daft zebras jump!",
         "Unseen Capitals and 123 digits", ""]


def test_tokenizer_matches_jax(tiny):
    """The trained BPE model of the tiny checkpoint: ids under every flag
    combination and decoded text equal the JAX Tokenizer's."""
    jt, tt = JaxTokenizer(tiny / "tokenizer.model"), Tokenizer(tiny / "tokenizer.model")
    assert (tt.vocab_size, tt.bos_id, tt.eos_id, tt.pad_id) == (jt.vocab_size, jt.bos_id, jt.eos_id, jt.pad_id)
    for text in TEXTS + [tsft.generate_prompt({"instruction": "the quick", "input": "brown fox"})]:
        for kw in (dict(), dict(bos=False, eos=True), dict(max_length=5), dict(max_length=40, pad=True)):
            got, want = tt.encode(text, **kw), jt.encode(text, **kw)
            assert got.dtype == torch.int32 and got.tolist() == want.tolist(), (text, kw)
        ids = jt.encode(text).tolist()
        assert tt.decode(ids) == jt.decode(ids) and tt.decode(torch.tensor(ids)) == jt.decode(ids)


def test_sp_model_unigram_bytes_and_serialization():
    """A unigram model with byte fallback, written by the port's
    serialize_model: the JAX parser reads it, the bytes equal the JAX
    writer's, and both encode (Viterbi, byte fallback) and decode alike."""
    pieces = [t_sp.Piece("<unk>", 0.0, t_sp.UNKNOWN), t_sp.Piece("<s>", 0.0, t_sp.CONTROL),
              t_sp.Piece("</s>", 0.0, t_sp.CONTROL)]
    pieces += [t_sp.Piece(w, -float(i + 1)) for i, w in enumerate(["▁the", "▁qu", "ick", "▁", "t", "h", "e", "q",
                                                                    "u", "i", "c", "k", "▁quick"])]
    pieces += [t_sp.Piece(f"<0x{b:02X}>", 0.0, t_sp.BYTE) for b in range(256)]
    model = t_sp.SPModel(pieces=pieces, model_type=1, byte_fallback=True)
    data = t_sp.serialize_model(model)
    jmodel = j_sp.parse_model(data)
    assert data == j_sp.serialize_model(jmodel)
    again = t_sp.parse_model(data)
    for text in ("the quick", "thequick é!", "quick\nthe"):
        ids = again.encode(text)
        assert ids == jmodel.encode_py(text), text
        assert again.decode(ids) == jmodel.decode(ids)


def test_generate_entry_points_on_the_cpu(tiny, tmp_path):
    """``generate.lora`` in a subprocess with ``--device cpu`` on the tiny
    int4 model and a reference-format LoRA .pth prints text, with the greedy
    token ids of the in-process ``generate`` on the same overlaid weights;
    ``generate.base`` prints its sample."""
    cfg = LLaMAConfig(block_size=128, vocab_size=256, n_layer=2, n_head=4, n_embd=64, lora=LoRAConfig())
    overlay = random_lora_overlay(cfg, seed=5, device="cpu")
    torch.save(tconvert.lora_overlay_to_sd(overlay, cfg), tmp_path / "lora.pth")
    args = ["--lora_path", str(tmp_path / "lora.pth"), "--checkpoint_path", str(tiny / "lit-llama.pth"),
            "--tokenizer_path", str(tiny / "tokenizer.model"), "--quantize", "gptq.int4", "--temperature", "0",
            "--max_new_tokens", "6", "--prompt", "the quick", "--device", "cpu"]
    proc = subprocess.run([sys.executable, "-m", "lit_llama_tpu_torch.generate.lora"] + args, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip()
    ids = ast.literal_eval(proc.stderr.split("Token ids: ")[-1].splitlines()[0])

    params, config = tloader.load_model(tiny / "lit-llama.pth", "gptq.int4", device="cpu")
    params = tlora.load_lora_state(params, overlay)
    config = config.replace(lora=LoRAConfig(r=8, alpha=16.0, dropout=0.0))
    tok = Tokenizer(tiny / "tokenizer.model")
    prompt = tok.encode(tsft.generate_prompt({"instruction": "the quick", "input": ""}))
    want = generate(params, prompt, 6, config=config, temperature=0.0, eos_id=tok.eos_id, device="cpu")
    assert ids == want.tolist()

    from lit_llama_tpu_torch.generate import base

    base.main(prompt="the quick", max_new_tokens=4, top_k=20, checkpoint_path=tiny / "lit-llama.pth",
              tokenizer_path=tiny / "tokenizer.model", device="cpu")
    with pytest.raises(NotImplementedError, match="model_parallel"):
        from lit_llama_tpu_torch.generate import lora as lora_entry

        lora_entry.main(model_parallel=2, device="cpu")
