"""Pretrain a small LLaMA on tiny-shakespeare (counterpart of the JAX package's
pretrain/shakespeare.py: the same flags and defaults, plus ``--device``).

    python -m lit_llama_tpu_torch.pretrain.shakespeare --data_dir data/shakespeare \
        [--n_layer 4 --n_embd 256 --n_head 4 ...] [--device cpu]

The 7B preset with vocabulary 100 and block size 1024 (``--n_layer``,
``--n_embd``, ``--n_head`` override the preset), f32 params and bf16
compute, a constant learning rate (no warmup, no decay), blocks drawn at
random offsets of ``train.bin`` / ``val.bin`` (uint16, from
``scripts.prepare_shakespeare``) by ``np.random.default_rng(1337)``, which
the training and the validation batches share, as in the JAX script.
Validation and a checkpoint every ``eval_interval`` steps; ``final`` only
when ``max_iters`` is reached. ``--resume`` restores params, optimizer state
and step, and draws past the batches the run already took, so a resumed run
trains on what an unbroken one would. Across ranks (``torchrun``,
``--data_parallel N --model_parallel M``) the params shard as the JAX script
shards them (FSDP over data, TP over model): every rank draws the same
global batches and trains on its data rank's rows, and checkpoints are
gathered into the single-process layout (``pretrain.redpajama``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Tuple

import numpy as np


def get_batches(data: np.ndarray, block_size: int, accum: int, micro_batch_size: int,
                rng: np.random.Generator) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless (x, y) int32 pairs of shape (accum, micro_batch_size,
    block_size): blocks at ``rng.integers(len(data) - block_size - 1)``
    offsets, y shifted by one token."""
    while True:
        ix = draw_offsets(len(data), block_size, accum * micro_batch_size, rng)
        x = np.stack([data[i : i + block_size].astype(np.int32) for i in ix])
        y = np.stack([data[i + 1 : i + 1 + block_size].astype(np.int32) for i in ix])
        yield x.reshape(accum, micro_batch_size, block_size), y.reshape(accum, micro_batch_size, block_size)


def draw_offsets(n_tokens: int, block_size: int, n: int, rng: np.random.Generator) -> np.ndarray:
    return rng.integers(n_tokens - block_size - 1, size=n)


def main(
    data_dir: Path = Path("data/shakespeare"),
    out_dir: Path = Path("out/training"),
    model_size: str = "7B",
    block_size: int = 1024,
    vocab_size: int = 100,
    batch_size: int = 2,
    micro_batch_size: int = 2,
    max_iters: int = 600000,
    learning_rate: float = 6e-4,
    eval_interval: int = 2000,
    eval_iters: int = 200,
    log_interval: int = 1,
    data_parallel: int = -1,
    model_parallel: int = 1,
    n_layer: int = None,
    n_embd: int = None,
    n_head: int = None,
    resume: Path = None,
    remat_policy: str = "dots",
    adam_state_dtype: str = "",
    device: str = None,
):
    """Pretrain a LLaMA model on tiny-shakespeare.

    Args:
        data_dir: Directory with train.bin / val.bin from prepare_shakespeare.
        out_dir: Checkpoint/log output directory.
        model_size: Config preset (7B/13B/30B/65B).
        block_size: Context length (reference: 1024 for shakespeare).
        vocab_size: Tokenizer vocab (reference: 100).
        batch_size: Global batch size.
        micro_batch_size: Per-step microbatch (grad accumulation = batch/micro).
        max_iters: Total optimizer steps.
        learning_rate: AdamW learning rate (constant).
        eval_interval: Validate and checkpoint every N steps.
        eval_iters: Validation batches per eval.
        log_interval: Log every N steps.
        data_parallel: Data-parallel size, the FSDP axis (-1: every rank the model axis leaves); more than one
            needs torchrun (one process a rank).
        model_parallel: Tensor-parallel size; the world is data x model ranks.
        n_layer: Override layer count.
        n_embd: Override width.
        n_head: Override head count.
        resume: Resume from a checkpoint directory of this package (restores optimizer + step).
        remat_policy: 'dots' (save matmul outputs) or 'full' (recompute all but the block input).
        adam_state_dtype: '' (float32) or 'bfloat16': Adam moments stored in bf16.
        device: cuda (the default: the card) or cpu (the plain PyTorch path).
    """
    import torch

    from lit_llama_tpu_torch import LLaMAConfig
    from lit_llama_tpu_torch.models import llama
    from lit_llama_tpu_torch.training import loop as loop_lib
    from lit_llama_tpu_torch.training import step as step_lib
    from lit_llama_tpu_torch.parallel import launch, sharding
    from lit_llama_tpu_torch.utils.device import resolve_device

    mesh = sharding.train_mesh(data_parallel, model_parallel, device)
    dev = (mesh is not None and launch.current_device()) or resolve_device(device)
    overrides = {k: v for k, v in (("n_layer", n_layer), ("n_embd", n_embd), ("n_head", n_head)) if v}
    config = LLaMAConfig.from_name(model_size, block_size=block_size, vocab_size=vocab_size,
                                   param_dtype="float32", compute_dtype="bfloat16", **overrides)

    train_data = np.memmap(Path(data_dir) / "train.bin", dtype=np.uint16, mode="r")
    val_data = np.memmap(Path(data_dir) / "val.bin", dtype=np.uint16, mode="r")

    tc = step_lib.TrainConfig(learning_rate=learning_rate, warmup_iters=0, max_iters=max_iters, decay_lr=False,
                              adam_state_dtype=adam_state_dtype or None)
    optimizer = step_lib.make_optimizer(tc)
    layout = None
    if mesh is not None:
        layout = sharding.Layout(mesh, config, llama.init_params(config, device="meta"), fsdp=True)
    if resume is not None:
        state = loop_lib.load_train_checkpoint(resume, optimizer, device=dev, layout=layout)
    else:
        gen = torch.Generator(device=dev).manual_seed(1337)
        params = llama.init_params(config, gen, device=dev)
        state = step_lib.init_train_state(params if layout is None else layout.shard(params), optimizer)
        del params

    accum = max(1, batch_size // micro_batch_size)
    rng = np.random.default_rng(1337)
    # a resumed run first draws the offsets of the steps and validations it has
    # run, in the order an unbroken run drew them
    for it in range(int(state.step)):
        draw_offsets(len(train_data), block_size, accum * micro_batch_size, rng)
        if eval_interval and (it + 1) % eval_interval == 0:
            for _ in range(eval_iters):
                draw_offsets(len(val_data), block_size, accum * micro_batch_size, rng)

    lc = loop_lib.LoopConfig(out_dir=Path(out_dir), max_iters=max_iters, log_interval=log_interval,
                             eval_interval=eval_interval, eval_iters=eval_iters, save_interval=eval_interval)
    validate_fn = loop_lib.validate_on(lambda: get_batches(val_data, block_size, accum, micro_batch_size, rng),
                                       config, eval_iters, layout)
    state = loop_lib.train(state, get_batches(train_data, block_size, accum, micro_batch_size, rng), config,
                           optimizer, lc, validate_fn=validate_fn, remat_policy=remat_policy, layout=layout)
    if int(state.step) >= max_iters:
        # only a completed run earns "final": a signal stop saved preempt-NNNNNN
        loop_lib.save_train_checkpoint(Path(out_dir), "final", state, config, layout=layout)
    return state


if __name__ == "__main__":
    from lit_llama_tpu_torch.utils.cli import cli

    cli(main)
