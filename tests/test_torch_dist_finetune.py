"""Finetuning and pretraining across ranks on the CPU: the four finetuning
modes' train steps over gloo ranks (``tests/torch_parallel_ranks.py``) as
the port's entry points shard them (full under FSDP, LoRA and the adapters
under DP, LoRA and Adapter v1 under TP) against the port's single-process
step, and the PEFT modes under DP against the JAX ``train_step`` under the
same mesh,
with each mode's trainable mask; LoRA
leaves that no axis of the mesh divides (padded shards) against the
single-process step; Adapter v1 under TP against JAX's (1, 2) GSPMD step
and one process; the adapter refusals (v2 under TP, any adapter under TP
inference) in both packages; then ``finetune.lora --data_parallel 2`` and
``pretrain.shakespeare --model_parallel 2`` under ``torchrun`` against the
same entry points run in one process (``finetune.adapter
--model_parallel 2``: ``tests/test_torch_dist_adapter.py``).

Tolerances, f32, as ``tests/test_torch_dist_training.py`` holds them;
``finetune.lora`` on the CPU computes in f32: its logged losses to their 4
decimals, its LoRA leaves to rtol 1e-6, atol 1e-2 lr. ``pretrain.shakespeare``
computes in bf16 and its three steps run at the full lr (no warmup), and
under TP each projection's partial sums are rounded to bf16 once more before
they are added: losses to 2e-3, each leaf's median difference within 0.05
lr, at most 5 % of its elements off by more than 0.1 lr, none by more than
6 lr (three Adam steps of about lr times the sign of a gradient that bf16
rounding may flip). A TP leaf in the wrong layout is off by its own scale,
~10 lr.
"""

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest

from lit_llama_tpu import LLaMAConfig, init_params
from lit_llama_tpu.models.config import AdapterConfig, LoRAConfig
from lit_llama_tpu.peft import adapter as jadapter, lora as jlora
from lit_llama_tpu_torch.models import config as tcfg
from lit_llama_tpu_torch.peft import adapter as tadapter, lora as tlora
from lit_llama_tpu_torch.utils.checkpoint import load_checkpoint, tree_leaves
from tests import test_torch_dist_training as dist
from tests import torch_parallel_ranks as ranks
from tests.test_torch_finetune import HYPER, work  # noqa: F401 (a module fixture: the tiny .pth, tokenizer and data)

ROOT = Path(__file__).resolve().parent.parent
SHAPE = dict(block_size=64, vocab_size=512, n_layer=3, n_head=2, n_embd=256)  # 3 layers: adapter from layer 2
LORA = LoRAConfig(r=4, alpha=8.0, dropout=0.0)
LORA_QKV = LoRAConfig(r=3, alpha=6.0, dropout=0.0, enable_k=True)  # 3 groups of rank 3: no axis of 2 divides them


def port_config(cfg):
    out = dist.port_config(cfg)
    if cfg.lora is not None:
        out = out.replace(lora=tcfg.LoRAConfig(**dataclasses.asdict(cfg.lora)))
    if cfg.adapter is not None:
        out = out.replace(adapter=tcfg.AdapterConfig(**dataclasses.asdict(cfg.adapter)))
    return out


def _case(mode, mesh, fsdp, seed, lora=LORA, jax_too=True, **tc):
    """A mode's tree with its PEFT leaves drawn (LoRA B and the gates not at
    zero, so that every trainable leaf has a gradient from the first step)
    and its mask."""
    cfg = LLaMAConfig(**SHAPE, lora=lora if mode == "lora" else None,
                      adapter=AdapterConfig(v2=mode == "adapter_v2") if mode.startswith("adapter") else None)
    params = jax.tree_util.tree_map(np.asarray, init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    h = params["h"]
    if mode == "lora":
        ca = h["attn"]["c_attn"]
        ca["lora_b"] = (rng.normal(size=ca["lora_b"].shape) * 0.05).astype(np.float32)
        mask = jlora.trainable_mask(params)
    elif mode.startswith("adapter"):
        h["gating"] = (rng.normal(size=h["gating"].shape) * 0.5).astype(np.float32)
        mask = jadapter.trainable_mask(params, v2=mode == "adapter_v2")
    else:
        mask = None
    ids, tgt = dist._tokens(seed, ignore=dist.UNEVEN if mode == "full" else None)
    return dict(jax_config=cfg, config=port_config(cfg), params=params, mesh=mesh, fsdp=fsdp,
                tc={**dist.TC, "learning_rate": 1e-2 if mode.startswith("adapter") else dist.LR, **tc},
                ids=ids, tgt=tgt, mask=mode if mode != "full" else None, jax_mask=mask, jax_too=jax_too)


# full finetuning under FSDP trains every leaf, as the FSDP cases of
# test_torch_dist_training.py do against JAX: here against one process
CASES = {"full_fsdp": _case("full", (2, 1), True, 20, jax_too=False), "lora_dp": _case("lora", (2, 1), False, 21),
         "adapter_dp": _case("adapter", (2, 1), False, 22), "adapter_v2_dp": _case("adapter_v2", (2, 1), False, 23),
         "lora_tp": _case("lora", (1, 2), False, 24, jax_too=False),  # TP against JAX: test_torch_dist_training
         "lora_qkv_fsdp": _case("lora", (2, 1), True, 25, LORA_QKV, jax_too=False),
         "lora_qkv_tp": _case("lora", (1, 2), False, 26, LORA_QKV, jax_too=False),
         # the gates drawn distinct per head: a rank that took the other's gates,
         # or its prompt keys from the other's heads, moves the loss; the clip
         # engaged (the gradient's norm is ~8e-4): each rank's norm counts the
         # whole prompt and gates once
         "adapter_tp": _case("adapter", (1, 2), False, 27, grad_clip=2e-4)}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    keys = ("config", "params", "mesh", "fsdp", "tc", "ids", "tgt", "mask")
    payload = {"cases": {n: {k: c[k] for k in keys} for n, c in CASES.items()},
               "adapter_inference": {k: CASES["adapter_tp"][k] for k in ("config", "params")}}
    return ranks.run("train_steps", 2, tmp_path_factory.mktemp("ft2"), payload)


def _port_mask(case, params):
    kind = case["mask"]
    if kind is None:
        return None
    return tlora.trainable_mask(params) if kind == "lora" else tadapter.trainable_mask(params, kind == "adapter_v2")


@pytest.mark.parametrize("name", list(CASES))
def test_mode_step_matches_jax_and_one_process(two_ranks, name):
    """Three steps of a finetuning mode across two ranks (the leaves it
    trains, its mask): the losses and the params gathered whole against the
    JAX step under its mesh (where JAX's placement takes the shapes) and
    the port's single-process step; frozen leaves unchanged bit for bit.
    Each step's gradient norm on every rank is the single process's (each
    leaf counted once); a clip case's is above its clip at every step."""
    case = CASES[name]
    one_losses, one, norms = dist.port_steps(case, grad_clip_probe=True, mask=lambda params: _port_mask(case, params))
    clip = case["tc"].get("grad_clip")
    assert clip is None or min(norms) > clip, norms
    lr = case["tc"]["learning_rate"]
    tol = dict(rtol=1e-6, atol=1e-2 * lr)
    got = two_ranks[0][name]["params"]
    for rank, out in enumerate(two_ranks):
        np.testing.assert_allclose(out[name]["losses"], one_losses, rtol=2e-6, err_msg=f"rank {rank}")
        np.testing.assert_allclose(out[name]["norms"], norms, rtol=1e-5, err_msg=f"rank {rank}")
    dist._held(got, one, tol, f"{name} vs one process")
    frozen = [] if case["mask"] is None else [n for n, m in tree_leaves(_port_mask(case, dist.fresh(case["params"])))
                                              .items() if not m]
    whole = tree_leaves(dist.fresh(case["params"]))
    for n in frozen:
        assert np.array_equal(got[n], whole[n].numpy()), n
    moved = [n for n in got if n not in frozen]
    assert moved and all(not np.array_equal(got[n], whole[n].numpy()) for n in moved), moved
    if not case["jax_too"]:
        return
    want_losses, want = dist.jax_steps(case)
    np.testing.assert_allclose(two_ranks[0][name]["losses"], want_losses, rtol=1e-5)
    dist._held(got, want, dict(rtol=1e-5, atol=1e-2 * lr), f"{name} vs JAX", flips=1e-5)


def test_adapters_are_refused_under_inference_tp(two_ranks):
    """An Adapter v1 model through tensor-parallel inference raises in both
    packages: JAX's shard_map TP forward, and the port's
    ``prepare_tp_params``, ``DecodeEngine(mesh=...)`` and ``generate_tp``
    on two ranks (the training path alone takes an adapter under TP)."""
    from lit_llama_tpu.models import llama as jllama
    from lit_llama_tpu_torch.models import llama as tllama
    from lit_llama_tpu_torch.parallel import tp
    from lit_llama_tpu_torch.utils.jax_params import params_from_numpy

    case = CASES["adapter_tp"]
    with pytest.raises(NotImplementedError, match="adapter"):
        jllama.forward(case["params"], np.zeros((1, 4), np.int32), case["jax_config"], tp_axis="model")
    with pytest.raises(NotImplementedError, match=tllama.ADAPTER_TP):
        tp.prepare_tp_params(params_from_numpy(case["params"], device="cpu"), case["config"], 2)
    for out in two_ranks:
        assert out["adapter_inference"] == {"engine": tllama.ADAPTER_TP, "generate_tp": tllama.ADAPTER_TP}


def test_adapter_v2_is_refused_under_tp_in_both_packages(tmp_path):
    """Adapter v2 under a model axis: JAX's placement puts ``model`` on the
    size-1 axis of the c_proj ``av2_*`` leaves and ``shard_params`` raises;
    the port refuses the same, with the reference's reason, before it loads
    anything (``finetune.run`` on paths that do not exist)."""
    from jax.sharding import Mesh

    from lit_llama_tpu.parallel import sharding as jsharding
    from lit_llama_tpu_torch.training import finetune as tft

    case = CASES["adapter_v2_dp"]
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
    with pytest.raises(ValueError, match="divisible"):
        jsharding.shard_params(jax.tree_util.tree_map(jax.numpy.asarray, case["params"]), mesh, fsdp=False, tp=True)
    specs = jsharding.param_pspecs(case["params"], fsdp=False, tp=True)
    assert specs["h"]["attn"]["c_proj"]["av2_bias"][1] == "model"  # the (L, 1, D) leaf's axis of size 1
    missing = tmp_path / "absent"
    with pytest.raises(NotImplementedError, match="size-1 axis") as e:
        tft.run("adapter_v2", missing, missing / "lit-llama.pth", missing / "tokenizer.model", tmp_path / "out",
                learning_rate=1e-3, weight_decay=0.0, batch_size=4, micro_batch_size=2, max_iters=1, warmup_iters=0,
                eval_interval=1, eval_iters=1, save_interval=1, log_interval=1, max_seq_length=64,
                model_parallel=2, device="cpu")
    assert "tensor parallelism" in str(e.value) and "--data_parallel" in str(e.value)
    assert not (tmp_path / "out").exists()


# ---- the entry points under torchrun ------------------------------------------------------


def test_finetune_lora_data_parallel_under_torchrun(work, tmp_path):  # noqa: F811
    """``finetune.lora --data_parallel 2`` under torchrun: its losses,
    validation loss and saved LoRA leaves are the one-process run's, rank 0
    alone writes the metrics, and the saved directory loads in the
    ``generate.lora`` path with the one-process run's greedy tokens."""
    from lit_llama_tpu_torch.finetune import lora as lora_entry
    from lit_llama_tpu_torch.models.generate import generate
    from lit_llama_tpu_torch.training import finetune as tft
    from lit_llama_tpu_torch.utils.loader import load_model, load_peft_checkpoint

    flags = dict(data_dir=work / "data", checkpoint_path=work / "lit-llama.pth", tokenizer_path=work / "tokenizer.model",
                 learning_rate=1e-3, **HYPER)
    args = [a for k, v in flags.items() for a in (f"--{k}", v)]
    wait = ranks.torchrun("lit_llama_tpu_torch.finetune.lora",
                          args + ["--out_dir", tmp_path / "two", "--data_parallel", 2], tmp_path / "two.log", ROOT)
    lora_entry.main(out_dir=tmp_path / "one", device="cpu", **flags)  # while the ranks run
    text = wait()
    assert "backend gloo" in text
    one, two = ranks.metrics(tmp_path / "one"), ranks.metrics(tmp_path / "two")
    assert [r["iter"] for r in one] == [r["iter"] for r in two]
    for a, b in zip(one, two):
        for k in ("loss", "val_loss"):
            if k in a:
                np.testing.assert_allclose(b[k], a[k], rtol=1e-4, atol=1e-4)  # the logs round to 4 places
    name = tft.CHECKPOINT_NAMES["lora"]
    got = tree_leaves(load_checkpoint(tmp_path / "two" / name)["params"])
    want = tree_leaves(load_checkpoint(tmp_path / "one" / name)["params"])
    assert sorted(got) == sorted(want) == ["h/attn/c_attn/lora_a", "h/attn/c_attn/lora_b"]
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(), rtol=1e-6, atol=1e-2 * 1e-3, err_msg=n)
    base, cfg = load_model(work / "lit-llama.pth", device="cpu")
    tokens = []
    for run in ("one", "two"):
        kind, lp, info = load_peft_checkpoint(tmp_path / run / name, cfg, device="cpu")
        c = cfg.replace(lora=tcfg.LoRAConfig(r=info["r"], alpha=16.0, dropout=0.0))
        tokens.append(generate(tlora.load_lora_state(base, lp), [1, 5, 9, 13], 8, config=c, temperature=0.0,
                               device="cpu").tolist())
    assert tokens[0] == tokens[1]


def test_pretrain_shakespeare_model_parallel_under_torchrun(tmp_path):
    """``pretrain.shakespeare --model_parallel 2`` under torchrun (TP, bf16
    compute): the final checkpoint holds the single-process layout, its
    params and losses the one-process run's within the bf16 tolerance."""
    from lit_llama_tpu_torch.pretrain import shakespeare

    rng = np.random.default_rng(0)
    data = tmp_path / "data"
    data.mkdir()
    for split, n in (("train", 4000), ("val", 1000)):
        rng.integers(0, 100, size=n).astype(np.uint16).tofile(data / f"{split}.bin")
    flags = dict(data_dir=data, n_layer=2, n_embd=256, n_head=2, block_size=64, vocab_size=100, batch_size=4,
                 micro_batch_size=2, max_iters=3, eval_interval=3, eval_iters=1, learning_rate=1e-3)
    args = [a for k, v in flags.items() for a in (f"--{k}", v)]
    wait = ranks.torchrun("lit_llama_tpu_torch.pretrain.shakespeare",
                          args + ["--out_dir", tmp_path / "two", "--model_parallel", 2], tmp_path / "two.log", ROOT)
    shakespeare.main(out_dir=tmp_path / "one", device="cpu", **flags)  # while the ranks run
    wait()
    one, two = ranks.metrics(tmp_path / "one"), ranks.metrics(tmp_path / "two")
    assert [r["iter"] for r in one] == [r["iter"] for r in two]
    np.testing.assert_allclose([r.get("loss", r.get("val_loss")) for r in two],
                               [r.get("loss", r.get("val_loss")) for r in one], rtol=2e-3, atol=2e-3)
    got = load_checkpoint(tmp_path / "two" / "final")
    want = load_checkpoint(tmp_path / "one" / "final")
    assert int(got["step"]) == 3
    g, w = tree_leaves(got["params"]), tree_leaves(want["params"])
    assert sorted(g) == sorted(w) and sorted(tree_leaves(got["opt_state"])) == sorted(tree_leaves(want["opt_state"]))
    for n in w:
        assert g[n].shape == w[n].shape, n
        diff = (g[n] - w[n]).abs()
        assert float(diff.max()) <= 6 * 1e-3, n
        assert float((diff > 0.1 * 1e-3).float().mean()) <= 5e-2, n
        assert float(diff.median()) <= 0.05 * 1e-3, n
