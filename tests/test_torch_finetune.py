"""Instruction finetuning in the port against the JAX package on the CPU: a
few steps of ``training.finetune.run`` in each mode (full, LoRA, Adapter v1,
Adapter v2) on a tiny ``.pth``, a tokenizer and SFT data that the test
writes, with the per-step loss, the validation loss and the trained leaves
held to JAX ``finetune.run``; frozen leaves unchanged bit for bit; the
filtered checkpoint read by both packages' ``load_peft_checkpoint`` and
through the ``generate.lora`` / ``generate.adapter`` entry points; LoRA's
dropout; and the multi-device flags refused.

The port runs through its entry points (``finetune.<mode>.main`` with the
CLI's flags). It starts from JAX's initial PEFT leaves (the LoRA A matrix of
``PRNGKey(seed)``, the adapter prompt of ``PRNGKey(7)``), carried across by
patching the port's initializers here. Three steps: step 1 moves nothing
(``cosine_lr(0) == 0``); with ``gating`` at zero the adapter prompt gets its
first gradient at step 3. JAX attends with ``attention_xla`` on the CPU, the
port with ``flash_attention_ref``, so f32 runs agree to f32 rounding, held to
``tests/test_torch_training.py``'s tolerances; full finetuning computes in
bf16 in both packages."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from lit_llama_tpu import LLaMAConfig, init_params
from lit_llama_tpu.data import sft as jsft
from lit_llama_tpu.data.tokenizer import Tokenizer as JaxTokenizer
from lit_llama_tpu.models.config import AdapterConfig as JaxAdapterConfig
from lit_llama_tpu.models.config import LoRAConfig as JaxLoRAConfig
from lit_llama_tpu.peft import adapter as jadapter
from lit_llama_tpu.peft import lora as jlora
from lit_llama_tpu.training import finetune as jft
from lit_llama_tpu.training import loop as jloop
from lit_llama_tpu.training import step as jstep
from lit_llama_tpu.utils import loader as jloader
from lit_llama_tpu_torch.data.tokenizer import Tokenizer
from lit_llama_tpu_torch.models import config as tcfg
from lit_llama_tpu_torch.models.generate import generate
from lit_llama_tpu_torch.models.llama import unstack_layers
from lit_llama_tpu_torch.peft import adapter as tadapter
from lit_llama_tpu_torch.peft import lora as tlora
from lit_llama_tpu_torch.training import finetune as tft
from lit_llama_tpu_torch.training import loop as tloop
from lit_llama_tpu_torch.training import step as tstep
from lit_llama_tpu_torch.utils import loader as tloader
from lit_llama_tpu_torch.utils.checkpoint import load_checkpoint, tree_leaves
from lit_llama_tpu_torch.utils.cli import cli
from lit_llama_tpu_torch.utils.convert import pytree_to_lit
from lit_llama_tpu_torch.utils.jax_params import params_from_numpy, tensor_from_numpy

from tests.test_torch_sft import random_examples, write_tokenizer

ROOT = Path(__file__).resolve().parent.parent
SHAPE = dict(block_size=256, vocab_size=256, n_layer=3, n_head=2, n_embd=256)
SEED = 1337
LR = {"full": 1e-3, "lora": 1e-3, "adapter": 1e-2, "adapter_v2": 1e-2}
HYPER = dict(batch_size=4, micro_batch_size=2, max_iters=3, warmup_iters=1, eval_interval=3, eval_iters=2,
             save_interval=2, log_interval=1, max_seq_length=256)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """A 3-layer model (two heads of 128) as a lit-llama ``.pth`` with its
    ``config.json``, a 128-piece tokenizer and ``train.pt`` / ``test.pt`` of
    alpaca-format samples (prompt masked in the labels)."""
    w = tmp_path_factory.mktemp("finetune")
    tok = write_tokenizer(w / "tokenizer.model")
    cfg = LLaMAConfig(**SHAPE)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, init_params(cfg, jax.random.PRNGKey(0))),
                               device="cpu")
    torch.save(pytree_to_lit(params, tcfg.LLaMAConfig(**SHAPE)), w / "lit-llama.pth")
    (w / "config.json").write_text(json.dumps(SHAPE))
    jt = JaxTokenizer(tok)
    samples = [jsft.prepare_sample(ex, jt, 250) for ex in random_examples(24, 5, max_words=15)]
    (w / "data").mkdir()
    jsft.save_samples(samples[:16], w / "data" / "train.pt")
    jsft.save_samples(samples[16:], w / "data" / "test.pt")
    return w


def _jax_initial_lora_a(config):
    jc = LLaMAConfig(n_layer=config.n_layer, n_head=config.n_head, n_embd=config.n_embd,
                     param_dtype=config.param_dtype, lora=JaxLoRAConfig(**dataclasses.asdict(config.lora)))
    return jlora.add_lora_params({"h": {"attn": {"c_attn": {}}}}, jc, jax.random.PRNGKey(SEED))["h"]["attn"][
        "c_attn"]["lora_a"]


def _jax_initial_adapter_wte(config):
    jc = LLaMAConfig(n_layer=config.n_layer, n_head=config.n_head, n_embd=config.n_embd,
                     param_dtype=config.param_dtype, adapter=JaxAdapterConfig(prompt_length=config.adapter.prompt_length))
    return jadapter.add_adapter_params({"h": {}}, jc)["h"]["adapter_wte"]


def _run_both(mode, work, out):
    """JAX ``finetune.run`` and the port's entry point with the same flags;
    returns each side's losses, validation losses and out dir, and the port's
    final state."""
    rec = {"jax": {"loss": [], "val": []}, "port": {"loss": [], "val": [], "state": None}}
    lr = LR[mode]
    wd = 0.02 if mode.startswith("adapter") else 0.0  # the CLIs' weight decay
    group = mode == "adapter_v2"  # one mode takes the length-grouped batches
    with pytest.MonkeyPatch.context() as mp:
        def recording(side, fn):
            def step(*a, **k):
                state, loss = fn(*a, **k)
                rec[side]["loss"].append(float(loss))
                return state, loss
            return step

        def recording_val(side, fn):
            def make(*a, **k):
                run = fn(*a, **k)

                def val(st):
                    v = run(st)
                    rec[side]["val"].append(v)
                    return v
                return val
            return make

        mp.setattr(jstep, "train_step", recording("jax", jstep.train_step))
        mp.setattr(tstep, "train_step", recording("port", tstep.train_step))
        mp.setattr(jloop, "validate_on", recording_val("jax", jloop.validate_on))
        mp.setattr(tloop, "validate_on", recording_val("port", tloop.validate_on))
        add_lora, add_adapter, finetune = tlora.add_lora_params, tadapter.add_adapter_params, tft.finetune

        def jax_lora(params, config, generator=None):
            add_lora(params, config, generator)
            params["h"]["attn"]["c_attn"]["lora_a"] = tensor_from_numpy(np.asarray(_jax_initial_lora_a(config)), "cpu")
            return params

        def jax_adapter(params, config, generator=None):
            add_adapter(params, config, generator)
            params["h"]["adapter_wte"] = tensor_from_numpy(np.asarray(_jax_initial_adapter_wte(config)), "cpu")
            return params

        def keep_state(*a, **k):
            rec["port"]["state"] = finetune(*a, **k)
            return rec["port"]["state"]

        mp.setattr(tlora, "add_lora_params", jax_lora)
        mp.setattr(tadapter, "add_adapter_params", jax_adapter)
        mp.setattr(tft, "finetune", keep_state)
        jft.run(mode, work / "data", work / "lit-llama.pth", work / "tokenizer.model", out / "jax",
                learning_rate=lr, weight_decay=wd, seed=SEED, group_by_length=group, **HYPER)
        import importlib

        entry = importlib.import_module(f"lit_llama_tpu_torch.finetune.{mode}")
        args = ["--device", "cpu", "--data_dir", str(work / "data"), "--checkpoint_path", str(work / "lit-llama.pth"),
                "--tokenizer_path", str(work / "tokenizer.model"), "--out_dir", str(out / "port"),
                "--learning_rate", str(lr), "--group_by_length", str(group)]
        args += [a for k, v in HYPER.items() for a in (f"--{k}", str(v))]
        if mode.startswith("adapter"):
            args += ["--weight_decay", str(wd)]
        cli(entry.main, args)
    rec["jax"]["out"], rec["port"]["out"] = out / "jax", out / "port"
    return rec


@pytest.fixture(scope="module", params=list(tft.MODES))
def finetuned(request, work, tmp_path_factory):
    return request.param, _run_both(request.param, work, tmp_path_factory.mktemp(request.param))


def test_finetune_matches_jax(finetuned, work):
    """Per-step and validation losses, then the trained leaves as each package
    saved them, against JAX; frozen leaves bit for bit as loaded. f32 (LoRA,
    adapters): losses to 1e-5, leaves to 1e-2 lr (an Adam step is about lr
    times the grad's sign, which f32 rounding of a grad near 0 may flip);
    full finetuning computes in bf16: losses to 2e-3 (the two packages'
    attentions round at other points), leaves to 4 lr (two steps that may
    each go the other way, the first by up to lr, the second by up to about
    twice that), with at most 1 % of a leaf's elements off by more than 0.1 lr
    (the runs read 0.00-0.44 %)."""
    mode, rec = finetuned
    j, p = rec["jax"], rec["port"]
    assert len(p["loss"]) == len(j["loss"]) == HYPER["max_iters"] and len(p["val"]) == len(j["val"]) == 1
    tol = dict(rtol=1e-5, atol=1e-5) if mode != "full" else dict(rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(p["loss"], j["loss"], **tol)
    np.testing.assert_allclose(p["val"], j["val"], **tol)
    name = tft.CHECKPOINT_NAMES[mode]
    want = tree_leaves(load_checkpoint(j["out"] / name)["params"])
    got = tree_leaves(load_checkpoint(p["out"] / name)["params"])
    assert sorted(got) == sorted(want)
    lr = LR[mode]
    state = p["state"]
    assert state.step == HYPER["max_iters"]
    base, _ = tloader.load_model(work / "lit-llama.pth", device="cpu")
    base = tree_leaves(base)
    for n, w in want.items():
        g = got[n].float()
        w = w.float()
        assert g.dtype == w.dtype
        if mode == "full":
            diff = (g - w).abs()
            assert float(diff.max()) <= 4 * lr, n
            assert float((diff > 0.1 * lr).float().mean()) <= 1e-2, n
            assert float(diff.median()) <= 0.2 * lr, n
        else:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-2 * lr, err_msg=n)
        if n in base:  # a trained base leaf moved
            assert not torch.equal(tree_leaves(state.params)[n].float(), base[n].float()), n
    frozen = [n for n in tree_leaves(state.params) if n not in got]
    assert (len(frozen) == 0) == (mode == "full")
    for n in frozen:
        t = tree_leaves(state.params)[n]
        if n in base:
            assert torch.equal(t, base[n]), n
    if mode in ("adapter", "adapter_v2"):  # the gates and the prompt moved (layer 2, the active one)
        assert float(got["h/gating"][2].abs().max()) > 0
        init_wte = np.asarray(_jax_initial_adapter_wte(tcfg.LLaMAConfig(**SHAPE, adapter=tcfg.AdapterConfig())))
        assert not np.array_equal(got["h/adapter_wte"][2].numpy(), init_wte[2])
    recs = [json.loads(line) for line in (p["out"] / "metrics.jsonl").read_text().splitlines()]
    assert [r["iter"] for r in recs] == [0, 1, 2, 2] and "val_loss" in recs[-1]
    assert (p["out"] / "iter-000002").is_dir()


FILTERED = {"lora": {"h/attn/c_attn/lora_a", "h/attn/c_attn/lora_b"},
            "adapter": {"h/adapter_wte", "h/gating"}}
FILTERED["adapter_v2"] = FILTERED["adapter"] | {"h/rms_1", "h/rms_2", "ln_f", "lm_head/av2_bias", "lm_head/av2_scale"} | {
    f"h/{m}/{l}/av2_{k}" for m, l in (("attn", "c_attn"), ("attn", "c_proj"), ("mlp", "c_fc1"), ("mlp", "c_fc2"),
                                      ("mlp", "c_proj")) for k in ("bias", "scale")}


def test_peft_checkpoint_loads_and_generates(finetuned, work):
    """The saved directory holds the filtered leaves and the step, no
    optimizer state; both packages' ``load_peft_checkpoint`` read it alike;
    the port's generate entry point on it gives the greedy tokens of the
    in-process ``generate`` with the overlay."""
    mode, rec = finetuned
    if mode == "full":
        tree = load_checkpoint(rec["port"]["out"] / tft.CHECKPOINT_NAMES[mode])
        assert sorted(tree) == ["opt_state", "params", "step"] and int(tree["step"]) == 3
        return
    path = rec["port"]["out"] / tft.CHECKPOINT_NAMES[mode]
    tree = load_checkpoint(path)
    assert sorted(tree) == ["params", "step"] and int(tree["step"]) == 3
    assert set(tree_leaves(tree["params"])) == FILTERED[mode]
    meta = json.loads((path / "manifest.json").read_text())["metadata"]["config"]
    assert {k: meta[k] for k in SHAPE} == SHAPE
    jkind, jov, jinfo = jloader.load_peft_checkpoint(path, LLaMAConfig(**SHAPE))
    kind, ov, info = tloader.load_peft_checkpoint(path, tcfg.LLaMAConfig(**SHAPE), device="cpu")
    assert (kind, info) == (jkind, jinfo)
    want = tree_leaves(jax.tree_util.tree_map(np.asarray, jov))
    got = tree_leaves(ov)
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_array_equal(got[n].numpy(), want[n])

    params, config = tloader.load_model(work / "lit-llama.pth", device="cpu")
    if kind == "lora":
        config = config.replace(lora=tcfg.LoRAConfig(r=info["r"], alpha=16.0, dropout=0.0))
        params = tlora.load_lora_state(params, ov)
        entry, flag = "lora", "--lora_path"
    else:
        assert info == {"prompt_length": 10, "start_layer": 0, "v2": mode == "adapter_v2"}
        config = config.replace(adapter=tcfg.AdapterConfig(v2=info["v2"], start_layer=0))
        params = tadapter.load_adapter_state(tadapter.add_adapter_params(params, config), ov)
        entry, flag = mode, "--adapter_path"
    tok = Tokenizer(work / "tokenizer.model")
    from lit_llama_tpu_torch.data import sft as tsft

    enc = tok.encode(tsft.generate_prompt({"instruction": "What food do lamas eat?", "input": ""}))
    want_ids = generate(unstack_layers(params), enc, 12, config=config, temperature=0.0, eos_id=tok.eos_id,
                        device="cpu").tolist()
    cmd = [sys.executable, "-m", f"lit_llama_tpu_torch.generate.{entry}", "--device", "cpu", flag, str(path),
           "--checkpoint_path", str(work / "lit-llama.pth"), "--tokenizer_path", str(work / "tokenizer.model"),
           "--temperature", "0", "--max_new_tokens", "12"]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got_ids = json.loads(proc.stderr.split("Token ids: ")[-1].splitlines()[0])
    assert got_ids == want_ids and len(got_ids) > len(enc)


@pytest.mark.parametrize("p", [0.0, 0.3])
def test_lora_delta_dropout(p):
    """With a generator and p > 0 about 1 - p of x's entries are kept, scaled
    by 1 / (1 - p); without one, or at p = 0, the update is x's own."""
    rng = np.random.default_rng(0)
    D, r = 64, 4
    cfg = tcfg.LoRAConfig(r=r, alpha=8.0, dropout=p)
    a = torch.from_numpy(rng.normal(size=(D, 2 * r)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(2, r, D)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(4, 50, D)).astype(np.float32))
    attn = {"lora_a": a, "lora_b": b}
    plain = tlora.lora_delta(attn, x, cfg)
    g = torch.Generator().manual_seed(1)
    dropped = tlora.lora_delta(attn, x, cfg, generator=g)
    if p == 0.0:
        assert torch.equal(dropped, plain)
        return
    g = torch.Generator().manual_seed(1)  # the same draws: the mask the dropout took
    mask = torch.empty(x.shape).bernoulli_(1 - p, generator=g).bool()
    keep = float(mask.float().mean())
    assert abs(keep - (1 - p)) < 0.02
    want = tlora.lora_delta(attn, torch.where(mask, x / (1 - p), torch.zeros(())), cfg)
    torch.testing.assert_close(dropped, want, rtol=1e-5, atol=1e-5)
    assert float((dropped - plain).abs().max()) > 0.1
    assert torch.equal(tlora.lora_delta(attn, x, cfg), plain)


def test_run_refuses_more_than_one_device(work, tmp_path):
    for dp, mp_ in ((2, 1), (1, 2)):
        with pytest.raises(NotImplementedError, match="one\\s+device"):
            tft.run("lora", work / "data", work / "lit-llama.pth", work / "tokenizer.model", tmp_path,
                    learning_rate=1e-3, weight_decay=0.0, data_parallel=dp, model_parallel=mp_, device="cpu", **HYPER)
    with pytest.raises(ValueError, match="mode"):
        tft.prepare("qlora", {"wte": torch.zeros(1)}, tcfg.LLaMAConfig(**SHAPE))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("mode", ["lora", "adapter", "adapter_v2"])
def test_kernel_finetune_grads_match_plain(cuda, mode):
    """One microbatch's loss and trainable grads of a 3-layer model in bf16,
    K4 + K10 against the plain path, with chip_smoke.py's rules
    (TOL_TRAIN_GRAD: each grad within 2e-2 of its largest value and of its
    RMS); K10 runs once a layer, but for Adapter v1's first layer, whose
    attention backward autograd skips (no trainable leaf before it)."""
    from lit_llama_tpu_torch.models import llama as tllama
    from lit_llama_tpu_torch.ops import flash_attention as tflash

    cfg = tcfg.LLaMAConfig(block_size=256, vocab_size=512, n_layer=3, n_head=2, n_embd=256,
                           param_dtype="bfloat16", compute_dtype="bfloat16")
    params = tllama.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    params, mcfg, mask, _ = tft.prepare(mode, params, cfg)
    g = torch.Generator(device=cuda).manual_seed(1)
    leaf = params["h"]["attn"]["c_attn"]["lora_b"] if mode == "lora" else params["h"]["gating"]
    leaf.copy_(torch.randn(leaf.shape, generator=g, device=cuda).to(leaf) * 0.5)
    toks = torch.randint(0, 512, (4, 257), generator=g, device=cuda)
    leaves = tree_leaves(params)
    names = [n for n, m in tree_leaves(mask).items() if m]
    out = {}
    for plain in (False, True):
        for n in names:
            leaves[n].requires_grad_(True)
        before = tflash.flash_backward_dq.launches
        loss = tstep.loss_fn(params, toks[:, :-1], toks[:, 1:], mcfg, remat=True, plain=plain)
        grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        torch.cuda.synchronize()
        assert tflash.flash_backward_dq.launches - before == (0 if plain else 2 if mode == "adapter" else 3)
        out[plain] = (float(loss), dict(zip(names, grads)))
        for n in names:
            leaves[n].requires_grad_(False)
    assert abs(out[False][0] - out[True][0]) <= 1e-2 * abs(out[True][0])
    for n, g_p in out[True][1].items():
        g_k = out[False][1][n].float()
        g_p = g_p.float()
        assert torch.isfinite(g_k).all() and float(g_p.abs().max()) > 0, n
        assert float((g_k - g_p).abs().max()) <= 2e-2 * float(g_p.abs().max()), n
        assert float((g_k - g_p).norm()) <= 2e-2 * float(g_p.norm()), n
