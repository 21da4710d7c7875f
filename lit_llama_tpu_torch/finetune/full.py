"""Full-parameter instruction finetuning (counterpart of the JAX package's
finetune/full.py: the same flags and defaults, plus ``--device``).

    python -m lit_llama_tpu_torch.finetune.full --data_dir DIR --checkpoint_path ckpt/lit-llama.pth \
        --tokenizer_path ckpt/tokenizer.model [--device cpu]

Every weight trains, held in f32 with bf16 compute; checkpoints hold the
params and the optimizer state. ``DIR`` holds ``train.pt`` and ``test.pt``
(``data.sft.save_samples``, or the JAX package's prepare_alpaca /
prepare_dolly output as it is).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional


def main(
    data_dir: Path = Path("data/alpaca"),
    checkpoint_path: Path = Path("checkpoints/lit-llama/7B/lit-llama.pth"),
    tokenizer_path: Path = Path("checkpoints/lit-llama/tokenizer.model"),
    out_dir: Path = Path("out/full/alpaca"),
    learning_rate: float = 3e-5,
    batch_size: int = 32,
    micro_batch_size: int = 4,
    max_iters: int = 5 * 50000 // 4 // 4,
    warmup_iters: int = 100,
    eval_interval: int = 1000,
    eval_iters: int = 100,
    save_interval: int = 1000,
    log_interval: int = 100,
    max_seq_length: int = 512,
    data_parallel: int = -1,
    model_parallel: int = 1,
    group_by_length: bool = False,
    device: Optional[str] = None,
) -> None:
    """Finetune all LLaMA weights on an instruction dataset.

    Args:
        data_dir: Directory with train.pt / test.pt from prepare_alpaca.py.
        checkpoint_path: Base model checkpoint (.pth or native dir).
        tokenizer_path: SentencePiece tokenizer model.
        out_dir: Output directory for checkpoints.
        learning_rate: Peak AdamW learning rate (reference: 3e-5).
        batch_size: Per-host batch (reference: 128/devices).
        micro_batch_size: Per-step microbatch (reference: 4).
        max_iters: Total optimizer steps.
        warmup_iters: Linear warmup steps.
        eval_interval: Validate every N steps.
        eval_iters: Validation batches per eval.
        save_interval: Checkpoint every N steps.
        log_interval: Log every N steps.
        max_seq_length: Truncation length (reference block_size: 512).
        data_parallel: Data-parallel size: 1 or -1 (one device; multi-device is still to port).
        model_parallel: Tensor-parallel size: 1 (one device).
        group_by_length: Batch near-equal-length samples to minimize padding.
        device: cuda (the default: the card) or cpu (the plain PyTorch path).
    """
    from lit_llama_tpu_torch.training import finetune

    finetune.run("full", data_dir, checkpoint_path, tokenizer_path, out_dir, learning_rate=learning_rate,
                 weight_decay=0.0, batch_size=batch_size, micro_batch_size=micro_batch_size, max_iters=max_iters,
                 warmup_iters=warmup_iters, eval_interval=eval_interval, eval_iters=eval_iters,
                 save_interval=save_interval, log_interval=log_interval, max_seq_length=max_seq_length,
                 data_parallel=data_parallel, model_parallel=model_parallel, group_by_length=group_by_length,
                 device=device)


if __name__ == "__main__":
    from lit_llama_tpu_torch.utils.cli import cli

    cli(main)
