"""Instruction finetuning in four modes: full, LoRA, Adapter v1 and Adapter v2
(counterpart of lit_llama_tpu/training/finetune.py).

One skeleton for the four ``finetune`` entry points: load the base weights,
attach and mark the trainable leaves, draw right-padded SFT batches, take
accumulated AdamW steps, validate (the mean loss and one sampled answer to a
fixed instruction), and save PEFT-filtered checkpoints. ``run`` loads a
checkpoint, its sample files and its tokenizer; ``finetune`` is the rest and
takes the params, the config and the samples in memory.

The flow, the flags and the random draws follow the JAX package: the batches
come from ``np.random.default_rng(seed)`` (validation from ``seed + 1``),
group-by-length batches from ``default_rng(0)`` per chunk. The LoRA A matrix
is drawn from a ``torch.Generator`` seeded ``seed`` and the adapter prompt
from one seeded 7, where JAX draws from ``PRNGKey(seed)`` and ``PRNGKey(7)``.

Across ranks (``data_parallel`` / ``model_parallel`` under ``torchrun``, a
world of their product) the mesh follows JAX's ``shard_params(fsdp=mode ==
"full", tp=model_parallel > 1)``: full finetuning shards its f32 weights and
moments over the data axis (FSDP), the PEFT modes keep the frozen base whole
on the data axis (DP); with a model axis the weights take the TP layout
(Adapter v1 / v2 refuse it: their prefix attention is not laid out by head).
Every rank draws the same global batches and keeps its rows
(``training.step``); rank 0 samples the validation answer from the gathered
params while the others wait.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from lit_llama_tpu_torch.data import sft
from lit_llama_tpu_torch.models import generate as gen
from lit_llama_tpu_torch.models.config import AdapterConfig, LLaMAConfig, LoRAConfig
from lit_llama_tpu_torch.peft import adapter as adapter_mod
from lit_llama_tpu_torch.parallel import launch, sharding
from lit_llama_tpu_torch.peft import lora as lora_mod
from lit_llama_tpu_torch.training import loop as loop_lib
from lit_llama_tpu_torch.training import step as step_lib
from lit_llama_tpu_torch.utils.checkpoint import tree_leaves, tree_unflatten
from lit_llama_tpu_torch.utils.device import resolve_device

MODES = ("full", "lora", "adapter", "adapter_v2")
CHECKPOINT_NAMES = {"full": "lit-llama-full-finetuned", "lora": "lit-llama-lora-finetuned",
                    "adapter": "lit-llama-adapter-finetuned", "adapter_v2": "lit-llama-adapter-v2-finetuned"}
SAMPLE_INSTRUCTION = "Recommend a movie for me to watch during the weekend and explain the reason."
ADAPTER_SEED = 7  # the JAX package draws the adapter prompt from PRNGKey(7)

Params = Dict[str, Any]


def prepare(mode: str, params: Params, config: LLaMAConfig, *, lora_r: int = 8, lora_alpha: float = 16.0,
            lora_dropout: float = 0.05, seed: int = 1337, draw_device=None
            ) -> Tuple[Params, LLaMAConfig, Optional[Params], Optional[Callable[[Params], Params]]]:
    """(params, config, trainable mask, save filter) of a mode. full: f32
    master weights with bf16 compute, every leaf trained and saved; lora: A
    and B on c_attn; adapter / adapter_v2: the adapter leaves (v2 also its
    bias, scale and the norm weights). The new leaves are drawn on
    ``draw_device`` (default: the params' device), so that params held on the
    host for sharding get the values a run on the card draws."""
    if mode not in MODES:
        raise ValueError(f"unknown finetuning mode {mode!r}: use one of {MODES}")
    dev = params["wte"].device if draw_device is None else torch.device(draw_device)
    if mode == "full":
        config = config.replace(param_dtype="float32", compute_dtype="bfloat16")
        params = tree_unflatten({n: t.float() for n, t in tree_leaves(params).items()})
        return params, config, None, None
    if mode == "lora":
        config = config.replace(lora=LoRAConfig(r=lora_r, alpha=lora_alpha, dropout=lora_dropout))
        params = lora_mod.add_lora_params(params, config, torch.Generator(device=dev).manual_seed(seed))
        return params, config, lora_mod.trainable_mask(params), lora_mod.lora_state
    v2 = mode == "adapter_v2"
    config = config.replace(adapter=AdapterConfig(v2=v2))
    params = adapter_mod.add_adapter_params(params, config, torch.Generator(device=dev).manual_seed(ADAPTER_SEED))
    return params, config, adapter_mod.trainable_mask(params, v2=v2), lambda p: adapter_mod.adapter_state(p, v2=v2)


def count_trainable(params: Params, mask: Optional[Params]) -> int:
    leaves = tree_leaves(params)
    if mask is None:
        return sum(t.numel() for t in leaves.values())
    return sum(leaves[n].numel() for n, m in tree_leaves(mask).items() if m)


def finetune(
    mode: str,
    params: Params,
    config: LLaMAConfig,
    train_data: List[Dict[str, np.ndarray]],
    test_data: List[Dict[str, np.ndarray]],
    tokenizer,
    out_dir: Path,
    *,
    learning_rate: float,
    weight_decay: float,
    batch_size: int,
    micro_batch_size: int,
    max_iters: int,
    warmup_iters: int,
    eval_interval: int,
    eval_iters: int,
    save_interval: int,
    log_interval: int,
    max_seq_length: int,
    lora_r: int = 8,
    lora_alpha: float = 16.0,
    lora_dropout: float = 0.05,
    seed: int = 1337,
    group_by_length: bool = False,
    log_fn: Optional[Callable[[Dict], None]] = None,
    mesh=None,
    device=None,
) -> step_lib.TrainState:
    """Finetune base ``params`` (stacked) in ``mode`` on ``device`` (default:
    the params' device); returns the final state. Writes ``metrics.jsonl``,
    the ``iter-*`` checkpoints and, when ``max_iters`` is reached, the mode's
    final checkpoint (``CHECKPOINT_NAMES``) under ``out_dir``. With ``mesh``
    (every rank calls it with the whole params, on the host or the card) the
    state is this rank's shards of it and the checkpoints are gathered."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    dev = params["wte"].device if device is None else torch.device(device)
    params, config, mask, save_filter = prepare(mode, params, config, lora_r=lora_r, lora_alpha=lora_alpha,
                                                lora_dropout=lora_dropout, seed=seed, draw_device=dev)
    if mask is not None and launch.is_main_process():
        print(f"Number of trainable parameters: {count_trainable(params, mask)}", file=sys.stderr)
    layout = None
    if mesh is not None:
        layout = sharding.Layout(mesh, config, params, fsdp=mode == "full")
        params = layout.shard(params, dev)
    main = layout is None or layout.is_main

    tc = step_lib.TrainConfig(learning_rate=learning_rate, weight_decay=weight_decay, warmup_iters=warmup_iters,
                              max_iters=max_iters, min_lr=learning_rate / 10)
    optimizer = step_lib.make_optimizer(tc, trainable_mask=mask)
    state = step_lib.init_train_state(params, optimizer)

    accum = max(1, batch_size // micro_batch_size)
    rng = np.random.default_rng(seed)
    if group_by_length:
        lengths = [len(s["input_ids"]) for s in train_data]
        per_step = accum * micro_batch_size

        def batches():
            while True:
                order = sft.length_grouped_indices(lengths, micro_batch_size, rng)
                for i in range(0, len(order) - per_step + 1, per_step):
                    chunk = [train_data[j] for j in order[i : i + per_step]]
                    yield sft.get_batch(chunk, micro_batch_size, np.random.default_rng(0), accum,
                                        max_seq_length=max_seq_length, sequential=True)
    else:

        def batches():
            while True:
                yield sft.get_batch(train_data, micro_batch_size, rng, accum, max_seq_length=max_seq_length)

    val_rng = np.random.default_rng(seed + 1)

    def val_batches():
        while True:
            yield sft.get_batch(test_data, micro_batch_size, val_rng, 1, max_seq_length=max_seq_length)

    base_validate = loop_lib.validate_on(val_batches, config, eval_iters, layout)

    def validate(st: step_lib.TrainState) -> float:
        val = base_validate(st)
        # one sampled answer, as the reference's validate prints; the prompt is
        # cut to half the context so that a small model can still sample
        params = st.params
        if layout is not None:  # rank 0 samples from the gathered params; the others wait
            params = layout.gather(params, keep=main)
            if not main:
                layout.barrier()
                return val
            params = tree_unflatten({n: t.to(dev) for n, t in tree_leaves(params).items()})
        prompt = sft.generate_prompt({"instruction": SAMPLE_INSTRUCTION, "input": ""})
        encoded = tokenizer.encode(prompt, bos=True, eos=False, max_length=max(config.block_size // 2, 8))
        max_new = min(100, config.block_size - len(encoded))
        t0 = time.perf_counter()
        y = gen.generate(params, encoded, max_new, config=config, temperature=0.8, top_k=200,
                         eos_id=tokenizer.eos_id, generator=torch.Generator(device=dev).manual_seed(int(st.step)),
                         device=dev)
        print(tokenizer.decode(y), file=sys.stderr)
        print(f"(sample took {time.perf_counter() - t0:.1f}s)", file=sys.stderr)
        if layout is not None:
            del params
            layout.barrier()
        return val

    lc = loop_lib.LoopConfig(out_dir=out_dir, max_iters=max_iters, log_interval=log_interval,
                             eval_interval=eval_interval, eval_iters=eval_iters, save_interval=save_interval,
                             save_filter=save_filter)
    state = loop_lib.train(state, batches(), config, optimizer, lc, validate_fn=validate, log_fn=log_fn,
                           layout=layout)
    if int(state.step) >= max_iters:  # a run stopped early saved preempt-NNNNNN instead
        loop_lib.save_train_checkpoint(out_dir, CHECKPOINT_NAMES[mode], state, config, save_filter, layout)
    return state


def run(
    mode: str,
    data_dir: Path,
    checkpoint_path: Path,
    tokenizer_path: Path,
    out_dir: Path,
    *,
    learning_rate: float,
    weight_decay: float,
    batch_size: int,
    micro_batch_size: int,
    max_iters: int,
    warmup_iters: int,
    eval_interval: int,
    eval_iters: int,
    save_interval: int,
    log_interval: int,
    max_seq_length: int,
    lora_r: int = 8,
    lora_alpha: float = 16.0,
    lora_dropout: float = 0.05,
    data_parallel: int = -1,
    model_parallel: int = 1,
    seed: int = 1337,
    group_by_length: bool = False,
    device=None,
) -> step_lib.TrainState:
    """Load ``checkpoint_path`` (a lit-llama ``.pth`` or a native directory)
    on ``device`` (the card when None), ``data_dir``'s ``train.pt`` and
    ``test.pt`` and the tokenizer, then ``finetune``. ``data_parallel`` /
    ``model_parallel`` other than one need a ``torchrun`` world of their
    product (``parallel.sharding.train_mesh``); each rank then reads the
    whole checkpoint on the host, in the card's dtype, and keeps its
    shard."""
    from lit_llama_tpu_torch.data.tokenizer import Tokenizer
    from lit_llama_tpu_torch.utils.loader import load_model

    mesh = sharding.train_mesh(data_parallel, model_parallel, device)
    dev = (mesh is not None and launch.current_device()) or resolve_device(device)
    if mesh is None:
        params, config = load_model(Path(checkpoint_path), device=dev)
    else:
        params, config = load_model(Path(checkpoint_path), dtype="bfloat16" if dev.type == "cuda" else None,
                                    device="cpu")
    train_data = sft.load_samples(Path(data_dir) / "train.pt")
    test_data = sft.load_samples(Path(data_dir) / "test.pt")
    return finetune(mode, params, config, train_data, test_data, Tokenizer(tokenizer_path), out_dir,
                    learning_rate=learning_rate, weight_decay=weight_decay, batch_size=batch_size,
                    micro_batch_size=micro_batch_size, max_iters=max_iters, warmup_iters=warmup_iters,
                    eval_interval=eval_interval, eval_iters=eval_iters, save_interval=save_interval,
                    log_interval=log_interval, max_seq_length=max_seq_length, lora_r=lora_r,
                    lora_alpha=lora_alpha, lora_dropout=lora_dropout, seed=seed, group_by_length=group_by_length,
                    mesh=mesh, device=dev)
