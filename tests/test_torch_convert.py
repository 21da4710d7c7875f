"""Checkpoint conversion on the CPU against the JAX package: Meta's and HF's
layouts to lit-llama names (bit for bit, with the same keys), the two
converter CLIs' ``.pth`` through the port's loader against JAX ``forward`` on
JAX's conversion, the LoRA merge against JAX's ``merge_lora``, and the HF
conversion verified against ``transformers`` on a tiny seeded model."""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lit_llama_tpu import LLaMAConfig
from lit_llama_tpu.models import llama as jllama
from lit_llama_tpu.utils import checkpoint as jckpt
from lit_llama_tpu.utils import convert as jconvert
from lit_llama_tpu.utils.loader import load_model as jload_model
from lit_llama_tpu_torch.models import config as tcfg
from lit_llama_tpu_torch.models import llama as tllama
from lit_llama_tpu_torch.scripts import convert_checkpoint as tconv_meta
from lit_llama_tpu_torch.scripts import convert_hf_checkpoint as tconv_hf
from lit_llama_tpu_torch.scripts import convert_lora_weights as tconv_lora
from lit_llama_tpu_torch.utils import checkpoint as tckpt
from lit_llama_tpu_torch.utils import convert as tconvert
from lit_llama_tpu_torch.utils.loader import load_model as tload_model

ROOT = Path(__file__).resolve().parent.parent
CFG = dict(block_size=64, vocab_size=128, n_layer=2, n_head=4, n_embd=64)
# Meta name -> (lit-llama name, the dim its tensor-parallel shards split; None: replicated)
META_SPLIT = {
    "tok_embeddings.weight": ("transformer.wte.weight", 1),
    "output.weight": ("lm_head.weight", 0),
    "norm.weight": ("transformer.ln_f.scale", None),
}
META_LAYER = {
    "attention.wo.weight": ("attn.c_proj.weight", 1),
    "feed_forward.w1.weight": ("mlp.c_fc1.weight", 0),
    "feed_forward.w2.weight": ("mlp.c_proj.weight", 1),
    "feed_forward.w3.weight": ("mlp.c_fc2.weight", 0),
    "attention_norm.weight": ("rms_1.scale", None),
    "ffn_norm.weight": ("rms_2.scale", None),
}
HF_LAYER = {
    "self_attn.o_proj.weight": "attn.c_proj.weight",
    "mlp.gate_proj.weight": "mlp.c_fc1.weight",
    "mlp.up_proj.weight": "mlp.c_fc2.weight",
    "mlp.down_proj.weight": "mlp.c_proj.weight",
    "input_layernorm.weight": "rms_1.scale",
    "post_attention_layernorm.weight": "rms_2.scale",
}


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lit_sd(cfg: LLaMAConfig, seed: int, dtype=np.float32):
    """Seeded lit-llama weights (torch orientation) as numpy arrays."""
    rng = np.random.default_rng(seed)
    D, V, I = cfg.n_embd, cfg.vocab_size, cfg.intermediate_size

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32).astype(dtype) * dtype(0.1)

    sd = {"transformer.wte.weight": w(V, D), "transformer.ln_f.scale": 1 + w(D), "lm_head.weight": w(V, D)}
    for i in range(cfg.n_layer):
        sd.update({f"transformer.h.{i}.rms_1.scale": 1 + w(D), f"transformer.h.{i}.rms_2.scale": 1 + w(D),
                   f"transformer.h.{i}.attn.c_attn.weight": w(3 * D, D),
                   f"transformer.h.{i}.attn.c_proj.weight": w(D, D),
                   f"transformer.h.{i}.mlp.c_fc1.weight": w(I, D), f"transformer.h.{i}.mlp.c_fc2.weight": w(I, D),
                   f"transformer.h.{i}.mlp.c_proj.weight": w(D, I)})
    return sd


def _meta_shards(sd, cfg: LLaMAConfig, n_shards: int):
    """The lit weights as Meta state dicts, split along Meta's dims."""
    shards = [{} for _ in range(n_shards)]

    def put(meta_name, arr, dim):
        parts = [arr] * n_shards if dim is None else np.split(arr, n_shards, axis=dim)
        for s, p in zip(shards, parts):
            s[meta_name] = np.ascontiguousarray(p)

    for meta_name, (lit_name, dim) in META_SPLIT.items():
        put(meta_name, sd[lit_name], dim)
    D = cfg.n_embd
    for i in range(cfg.n_layer):
        qkv = sd[f"transformer.h.{i}.attn.c_attn.weight"]
        for j, name in enumerate(("wq", "wk", "wv")):
            put(f"layers.{i}.attention.{name}.weight", qkv[j * D : (j + 1) * D], 0)
        for meta_sub, (lit_sub, dim) in META_LAYER.items():
            put(f"layers.{i}.{meta_sub}", sd[f"transformer.h.{i}.{lit_sub}"], dim)
        put(f"layers.{i}.attention.inner_attention.rope.freqs", np.ones(D // cfg.n_head // 2, np.float32), None)
    return shards


def _hf_permute(w, n_head):
    """HF's rotary q/k permutation (Meta's interleaved pairs -> half split)."""
    d_out, d_in = w.shape
    return w.reshape(n_head, d_out // n_head // 2, 2, d_in).transpose(0, 2, 1, 3).reshape(d_out, d_in)


def _hf_sd(sd, cfg: LLaMAConfig, n_head: int):
    out = {"model.embed_tokens.weight": sd["transformer.wte.weight"], "model.norm.weight": sd["transformer.ln_f.scale"],
           "lm_head.weight": sd["lm_head.weight"], "unrelated.buffer": np.zeros(3, np.float32)}
    D = cfg.n_embd
    for i in range(cfg.n_layer):
        qkv = sd[f"transformer.h.{i}.attn.c_attn.weight"]
        out[f"model.layers.{i}.self_attn.q_proj.weight"] = np.ascontiguousarray(_hf_permute(qkv[:D], n_head))
        out[f"model.layers.{i}.self_attn.k_proj.weight"] = np.ascontiguousarray(_hf_permute(qkv[D : 2 * D], n_head))
        out[f"model.layers.{i}.self_attn.v_proj.weight"] = qkv[2 * D :]
        out[f"model.layers.{i}.self_attn.rotary_emb.inv_freq"] = np.ones(D // cfg.n_head // 2, np.float32)
        for hf_sub, lit_sub in HF_LAYER.items():
            out[f"model.layers.{i}.{hf_sub}"] = sd[f"transformer.h.{i}.{lit_sub}"]
    return out


def _torch_sd(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def _assert_same(got, want):
    """Port tensors against JAX numpy arrays: same keys, dtypes and bits."""
    assert set(got) == set(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g.view(np.uint8), np.ascontiguousarray(w).view(np.uint8)), k


@pytest.mark.parametrize("n_head", [4, 8])
def test_hf_permute_back_matches_jax(n_head):
    w = np.random.default_rng(n_head).standard_normal((64, 48)).astype(np.float32)
    got = tconvert.hf_permute_back(torch.from_numpy(w), n_head)
    assert np.array_equal(got.numpy(), jconvert.hf_permute_back(w, n_head))
    assert np.array_equal(got.numpy(), w.reshape(n_head, 2, 64 // n_head // 2, 48).transpose(0, 2, 1, 3)
                          .reshape(64, 48))


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_hf_to_lit_matches_jax(dtype):
    cfg = LLaMAConfig(**CFG)
    sd = _lit_sd(cfg, 1, dtype)
    hf = _hf_sd(sd, cfg, cfg.n_head)
    got = tconvert.hf_to_lit(_torch_sd(hf), tcfg.LLaMAConfig(**CFG))
    _assert_same(got, jconvert.hf_to_lit(hf, cfg))
    _assert_same(got, sd)  # the round trip
    # every output owns its storage, so torch.save writes no more than the tensor
    assert all(t.untyped_storage().nbytes() == t.numel() * t.element_size() for t in got.values())


@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_meta_to_lit_matches_jax(n_shards, dtype):
    cfg = LLaMAConfig(**CFG)
    sd = _lit_sd(cfg, 2 + n_shards)
    shards = _meta_shards(sd, cfg, n_shards)
    got = tconvert.meta_to_lit([_torch_sd(s) for s in shards], tcfg.LLaMAConfig(**CFG), dtype=dtype)
    _assert_same(got, jconvert.meta_to_lit(shards, cfg, dtype=np.dtype(dtype)))
    _assert_same(got, {k: v.astype(dtype) for k, v in sd.items()})


def _port_logits(path, tokens):
    params, config = tload_model(path, dtype="float32", device="cpu")
    with torch.no_grad():
        return tllama.forward(params, torch.from_numpy(tokens).long(), config)[0].numpy()


def _jax_logits(path, tokens):
    params, config = jload_model(path, dtype="float32")
    return np.asarray(jllama.forward(params, jnp.asarray(tokens), config)[0])


def test_converter_clis_match_jax(tmp_path, monkeypatch):
    """Both converter CLIs, the port's and the JAX package's, on the same
    files: the port's ``.pth`` loads in the port's ``load_model`` and its
    logits equal JAX ``forward`` on JAX's conversion. The CLIs take the 7B
    preset, so the HF un-permutation runs at 32 heads (a different model from
    the tiny config's 4, the same one in both packages)."""
    monkeypatch.setenv("LIT_LLAMA_TPU_PLATFORM", "cpu")
    cfg = LLaMAConfig(**CFG)
    sd = _lit_sd(cfg, 5)
    meta_dir, hf_dir = tmp_path / "meta", tmp_path / "hf"
    meta_dir.mkdir()
    hf_dir.mkdir()
    for rank, shard in enumerate(_meta_shards(sd, cfg, 2)):
        torch.save(_torch_sd(shard), meta_dir / f"consolidated.{rank:02d}.pth")
    hf = _torch_sd(_hf_sd(sd, cfg, 32))
    names = sorted(hf)
    torch.save({k: hf[k] for k in names[: len(names) // 2]}, hf_dir / "pytorch_model-00001-of-00002.bin")
    torch.save({k: hf[k] for k in names[len(names) // 2 :]}, hf_dir / "pytorch_model-00002-of-00002.bin")

    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    runs = {
        "meta": (lambda out: tconv_meta.convert_checkpoint(output_dir=out, input_dir=meta_dir),
                 lambda out: _jax_script("convert_checkpoint").convert_checkpoint(output_dir=out, input_dir=meta_dir)),
        "hf": (lambda out: tconv_hf.convert_hf_checkpoint(output_dir=out, checkpoint_dir=hf_dir),
               lambda out: _jax_script("convert_hf_checkpoint").convert_hf_checkpoint(output_dir=out,
                                                                                      checkpoint_dir=hf_dir)),
    }
    for kind, (port_cli, jax_cli) in runs.items():
        outs = {}
        for side, run in (("port", port_cli), ("jax", jax_cli)):
            outs[side] = tmp_path / f"{kind}_{side}"
            run(outs[side])
            (outs[side] / "config.json").write_text(json.dumps(CFG))
        got = _port_logits(outs["port"] / "lit-llama.pth", tokens)
        want = _jax_logits(outs["jax"] / "lit-llama.pth", tokens)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=kind)
        port_sd = torch.load(outs["port"] / "lit-llama.pth", weights_only=True)
        assert set(port_sd) == set(sd)
        if kind == "meta":  # the Meta conversion gives the seeded weights back
            for k, v in sd.items():
                assert np.array_equal(port_sd[k].numpy(), v), k


def _lora_inputs(tmp_path, kind="lora"):
    cfg = LLaMAConfig(**CFG)
    base = tmp_path / "base"
    base.mkdir()
    torch.save(_torch_sd(_lit_sd(cfg, 7)), base / "lit-llama.pth")
    (base / "config.json").write_text(json.dumps(CFG))
    rng = np.random.default_rng(8)
    L, D, r = cfg.n_layer, cfg.n_embd, 4
    if kind == "lora":
        sd = {}
        for i in range(L):
            sd[f"transformer.h.{i}.attn.c_attn.lora_A"] = rng.standard_normal((2 * r, D)).astype(np.float32)
            sd[f"transformer.h.{i}.attn.c_attn.lora_B"] = rng.standard_normal((2 * D, r)).astype(np.float32)
    else:
        sd = {f"transformer.h.{i}.attn.adapter_wte.weight": rng.standard_normal((3, D)).astype(np.float32)
              for i in range(L)}
        sd.update({f"transformer.h.{i}.attn.gating_factor": np.full((1, cfg.n_head, 1, 1), 0.5, np.float32)
                   for i in range(L)})
    torch.save(_torch_sd(sd), tmp_path / f"{kind}.pth")
    return base / "lit-llama.pth", tmp_path / f"{kind}.pth"


@pytest.mark.parametrize("suffix", [".pth", ""])
def test_convert_lora_weights_matches_jax(tmp_path, monkeypatch, suffix):
    """The merged weights, as a ``.pth`` and as a native directory, equal the
    JAX script's (f32, 1e-6); the native directory carries the config."""
    monkeypatch.setenv("LIT_LLAMA_TPU_PLATFORM", "cpu")
    base, lora = _lora_inputs(tmp_path)
    outs = {side: tmp_path / f"merged_{side}{suffix}" for side in ("port", "jax")}
    tconv_lora.main(lora_path=lora, checkpoint_path=base, output_path=outs["port"], lora_alpha=8.0, device="cpu")
    _jax_script("convert_lora_weights").main(lora_path=lora, checkpoint_path=base, output_path=outs["jax"],
                                             lora_alpha=8.0)
    if suffix == ".pth":
        got = torch.load(outs["port"], weights_only=True)
        want = torch.load(outs["jax"], weights_only=True)
        assert set(got) == set(want)
        pairs = [(got[k].numpy(), want[k].numpy(), k) for k in want]
    else:
        got = tckpt.tree_leaves(tckpt.load_checkpoint(outs["port"]))
        want = tckpt.tree_leaves(jckpt.load_checkpoint(outs["jax"]))
        assert set(got) == set(want)
        pairs = [(np.asarray(got[k]), np.asarray(want[k]), k) for k in want]
        assert tckpt.load_metadata(outs["port"]) == jckpt.load_metadata(outs["jax"])
    changed = 0
    for g, w, k in pairs:
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=k)
        changed += "c_attn" in k
    assert changed  # the merge touched c_attn and nothing else was dropped
    base_sd = torch.load(base, weights_only=True)
    if suffix == ".pth":  # the update is really there: c_attn moved, the rest did not
        assert not torch.equal(got["transformer.h.0.attn.c_attn.weight"], base_sd["transformer.h.0.attn.c_attn.weight"])
        assert torch.equal(got["transformer.h.0.attn.c_proj.weight"], base_sd["transformer.h.0.attn.c_proj.weight"])


def test_convert_lora_weights_refuses_other_checkpoints(tmp_path):
    base, adapter = _lora_inputs(tmp_path, kind="adapter")
    with pytest.raises(ValueError, match="not LoRA"):
        tconv_lora.main(lora_path=adapter, checkpoint_path=base, output_path=tmp_path / "out.pth", device="cpu")
    torch.save({"unrelated": torch.zeros(2)}, tmp_path / "neither.pth")
    with pytest.raises(ValueError):
        tconv_lora.main(lora_path=tmp_path / "neither.pth", checkpoint_path=base, output_path=tmp_path / "out.pth",
                        device="cpu")


def test_hf_conversion_verified_against_transformers(tmp_path):
    """A tiny seeded ``LlamaForCausalLM`` saved as ``.bin`` files: the port's
    conversion, held by its own verify function (transformers' logits, 2e-3),
    and equal to JAX's conversion of the same files."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(11)
    hf_cfg = transformers.LlamaConfig(hidden_size=64, intermediate_size=256, num_attention_heads=4,
                                      num_key_value_heads=4, num_hidden_layers=2, vocab_size=128,
                                      max_position_embeddings=64, rms_norm_eps=1e-5, tie_word_embeddings=False)
    model = transformers.LlamaForCausalLM(hf_cfg)
    with torch.no_grad():  # logits of order 1, so that a wrong q / k layout shows beyond 2e-3
        for p in model.parameters():
            if p.dim() == 2:
                p.normal_(0.0, 0.2)
    model.save_pretrained(tmp_path / "hf", safe_serialization=False, max_shard_size="200KB")
    assert len(list((tmp_path / "hf").glob("*.bin"))) > 1
    cfg = tcfg.LLaMAConfig(**CFG)
    out = tconv_hf.convert_dir(tmp_path / "hf", tmp_path / "lit", cfg)
    tconv_hf.verify_logits(out, tmp_path / "hf", cfg)
    merged = {}
    for b in sorted((tmp_path / "hf").glob("*.bin")):
        merged.update(torch.load(b, weights_only=True))
    _assert_same(torch.load(out, weights_only=True),
                 jconvert.hf_to_lit({k: v.numpy() for k, v in merged.items()}, LLaMAConfig(**CFG)))
    # a wrong head count un-permutes q and k wrongly, and verify says so
    with pytest.raises(AssertionError):
        tconv_hf.verify_logits(tconv_hf.convert_dir(tmp_path / "hf", tmp_path / "bad", cfg.replace(n_head=2)),
                               tmp_path / "hf", cfg)
