"""Pretrain LLaMA on RedPajama (counterpart of the JAX package's
pretrain/redpajama.py: the same flags and defaults).

    python -m lit_llama_tpu_torch.pretrain.redpajama --train_data_dir DIR [--n_layer 8 ...] [--device cpu]

PackedDatasets of LITPKDS chunks mixed with the LLaMA paper's proportions,
warmup-cosine LR, gradient accumulation (batch_size / micro_batch_size
microbatches per step), clip 1.0, AdamW, activation checkpointing of each
block, periodic validation and checkpoints with true resume. One card:
``data_parallel`` and ``model_parallel`` other than 1 raise (multi-device is
still to port). Params start from ``llama.init_params`` with a
``torch.Generator`` seeded 1337; ``final`` is saved only when ``max_iters``
is reached.
"""

from __future__ import annotations

import glob
from pathlib import Path

# Data proportions from the LLaMA paper, Table 1
data_config = [
    ("arxiv", 2.5),
    ("book", 4.5),
    ("c4", 15.0),
    ("cc", 67.0),
    ("github", 4.5),
    ("stackexchange", 2.0),
    ("wikipedia", 4.5),
]


def create_dataloader(data_dir: Path, block_size: int, accum: int, micro_batch_size: int, seed: int,
                      num_processes: int = 1, process_rank: int = 0, shuffle: bool = True):
    """A generator function over (input, target) numpy pairs (accum,
    micro_batch_size, block_size - 1) from the weighted mixture of the
    per-source PackedDatasets found in ``data_dir``."""
    from lit_llama_tpu_torch.data.packed_dataset import CombinedDataset, PackedDataset, batcher

    datasets, weights = [], []
    for prefix, weight in data_config:
        filenames = sorted(glob.glob(str(Path(data_dir) / f"{prefix}*")))
        if not filenames:
            continue
        datasets.append(PackedDataset(filenames, n_chunks=4, block_size=block_size, shuffle=shuffle, seed=seed,
                                      num_processes=num_processes, process_rank=process_rank, wrap=True))
        weights.append(weight)
    if not datasets:
        raise RuntimeError(f"No data found at {data_dir}. Run scripts/prepare_redpajama.py first.")
    weights = [w / sum(weights) for w in weights]
    combined = CombinedDataset(datasets, seed=seed, weights=weights)

    def gen():
        for arr in batcher(combined, micro_batch_size, accum):
            yield arr[..., :-1], arr[..., 1:]  # a block of T + 1 tokens -> (input, shifted target)

    return gen


def main(
    train_data_dir: Path = Path("data/red_pajama_sample"),
    val_data_dir: Path = None,
    out_dir: Path = Path("out/training"),
    model_size: str = "7B",
    batch_size: int = 125,
    micro_batch_size: int = 5,
    max_iters: int = 600000,
    learning_rate: float = 6e-4,
    min_lr: float = 6e-5,
    warmup_iters: int = 2000,
    save_interval: int = 1000,
    eval_interval: int = 1000,
    eval_iters: int = 100,
    log_interval: int = 1,
    data_parallel: int = -1,
    model_parallel: int = 1,
    n_layer: int = None,
    n_embd: int = None,
    n_head: int = None,
    block_size: int = None,
    vocab_size: int = None,
    resume: Path = None,
    profile_at_iter: int = -1,
    adam_state_dtype: str = "",
    remat_policy: str = "dots",
    device: str = None,
) -> None:
    """Pretrain LLaMA on the RedPajama dataset.

    Args:
        train_data_dir: Directory of LITPKDS chunk files (from prepare_redpajama.py).
        val_data_dir: Optional validation chunk directory.
        out_dir: Checkpoint/log output directory.
        model_size: Config preset (7B/13B/30B/65B).
        batch_size: Global batch size (reference: 125).
        micro_batch_size: Per-step microbatch (reference: 5).
        max_iters: Total optimizer steps (reference: 600k).
        learning_rate: Peak AdamW learning rate.
        min_lr: Final cosine-decayed learning rate.
        warmup_iters: Linear warmup steps (reference: 2000).
        save_interval: Checkpoint every N steps.
        eval_interval: Validate every N steps.
        eval_iters: Validation batches per eval.
        log_interval: Log every N steps.
        data_parallel: Data-parallel size: 1 or -1 (one card; multi-device is still to port).
        model_parallel: Tensor-parallel size: 1 (one card).
        n_layer: Override layer count (the depth cut of a full-width run).
        n_embd: Override width.
        n_head: Override head count.
        block_size: Override context length.
        vocab_size: Override vocab size.
        resume: Resume from a checkpoint directory of this package (restores optimizer + step).
        profile_at_iter: Write a torch.profiler trace of this iteration under out_dir/profile.
        adam_state_dtype: '' (float32) or 'bfloat16': Adam moments stored in bf16.
        remat_policy: 'dots' (save matmul outputs) or 'full' (recompute all but the block input).
        device: 'cuda' (the default: the card) or 'cpu' (the plain PyTorch path).
    """
    import torch

    from lit_llama_tpu_torch import LLaMAConfig
    from lit_llama_tpu_torch.models import llama
    from lit_llama_tpu_torch.training import loop as loop_lib
    from lit_llama_tpu_torch.training import step as step_lib
    from lit_llama_tpu_torch.utils.device import resolve_device

    if data_parallel not in (1, -1) or model_parallel != 1:
        raise NotImplementedError(
            f"data_parallel={data_parallel}, model_parallel={model_parallel}: the port trains on one "
            "device (multi-device is still to port)")
    dev = resolve_device(device)
    overrides = {k: v for k, v in (("n_layer", n_layer), ("n_embd", n_embd), ("n_head", n_head),
                                   ("block_size", block_size), ("vocab_size", vocab_size)) if v}
    config = LLaMAConfig.from_name(model_size, param_dtype="float32", compute_dtype="bfloat16", **overrides)

    accum = max(1, batch_size // micro_batch_size)
    train_gen = create_dataloader(train_data_dir, config.block_size + 1, accum, micro_batch_size, seed=1338)

    tc = step_lib.TrainConfig(learning_rate=learning_rate, min_lr=min_lr, warmup_iters=warmup_iters,
                              max_iters=max_iters, adam_state_dtype=adam_state_dtype or None)
    optimizer = step_lib.make_optimizer(tc)
    if resume is not None:
        state = loop_lib.load_train_checkpoint(resume, optimizer, device=dev)
    else:
        gen = torch.Generator(device=dev).manual_seed(1337)
        state = step_lib.init_train_state(llama.init_params(config, gen, device=dev), optimizer)

    validate_fn = None
    if val_data_dir is not None:
        val_gen = create_dataloader(val_data_dir, config.block_size + 1, 1, micro_batch_size, seed=3424)
        validate_fn = loop_lib.validate_on(val_gen, config, eval_iters)

    lc = loop_lib.LoopConfig(out_dir=Path(out_dir), max_iters=max_iters, log_interval=log_interval,
                             eval_interval=eval_interval if validate_fn else 0, eval_iters=eval_iters,
                             save_interval=save_interval, profile_at_iter=profile_at_iter)
    state = loop_lib.train(state, train_gen(), config, optimizer, lc, validate_fn=validate_fn,
                           remat_policy=remat_policy)
    if int(state.step) >= max_iters:
        # only a completed run earns "final": a signal stop saved preempt-NNNNNN
        loop_lib.save_train_checkpoint(Path(out_dir), "final", state, config)


if __name__ == "__main__":
    from lit_llama_tpu_torch.utils.cli import cli

    cli(main)
