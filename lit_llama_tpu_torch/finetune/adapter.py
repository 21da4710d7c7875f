"""LLaMA-Adapter v1 instruction finetuning (counterpart of the JAX package's
finetune/adapter.py: the same flags and defaults, plus ``--device``).

    python -m lit_llama_tpu_torch.finetune.adapter --data_dir DIR --checkpoint_path ckpt/lit-llama.pth \
        --tokenizer_path ckpt/tokenizer.model [--device cpu]

The base weights stay frozen; the prompt and the gates of the blocks from
the third on (``start_layer`` 2) train, and the checkpoints hold only those
leaves (``generate.adapter`` loads them).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional


def main(
    data_dir: Path = Path("data/alpaca"),
    checkpoint_path: Path = Path("checkpoints/lit-llama/7B/lit-llama.pth"),
    tokenizer_path: Path = Path("checkpoints/lit-llama/tokenizer.model"),
    out_dir: Path = Path("out/adapter/alpaca"),
    learning_rate: float = 9e-3,
    weight_decay: float = 0.02,
    batch_size: int = 64,
    micro_batch_size: int = 4,
    max_iters: int = 5 * 50000 // 4,
    warmup_iters: int = 2 * (50000 // 4),
    eval_interval: int = 600,
    eval_iters: int = 100,
    save_interval: int = 1000,
    log_interval: int = 1,
    max_seq_length: int = 256,
    data_parallel: int = -1,
    model_parallel: int = 1,
    group_by_length: bool = False,
    device: Optional[str] = None,
) -> None:
    """Finetune LLaMA with the Adapter v1 method (prefix attention).

    Args:
        data_dir: Directory with train.pt / test.pt from prepare_alpaca.py.
        checkpoint_path: Base model checkpoint (.pth or native dir).
        tokenizer_path: SentencePiece tokenizer model.
        out_dir: Output directory for adapter checkpoints.
        learning_rate: Peak AdamW learning rate (reference: 9e-3).
        weight_decay: AdamW weight decay (reference: 0.02).
        batch_size: Global batch size (reference: 64).
        micro_batch_size: Per-step microbatch (reference: 4).
        max_iters: Total optimizer steps.
        warmup_iters: Linear warmup steps (reference: 2 epochs).
        eval_interval: Validate every N steps.
        eval_iters: Validation batches per eval.
        save_interval: Checkpoint every N steps.
        log_interval: Log every N steps.
        max_seq_length: Truncation length (see prepare_alpaca.py).
        data_parallel: Data-parallel size (-1: every rank the model axis leaves); more than one needs torchrun
            (one process a rank).
        model_parallel: Tensor-parallel size: 1 (the prefix attention is not laid out by head).
        group_by_length: Batch near-equal-length samples to minimize padding.
        device: cuda (the default: the card) or cpu (the plain PyTorch path).
    """
    from lit_llama_tpu_torch.training import finetune

    finetune.run("adapter", data_dir, checkpoint_path, tokenizer_path, out_dir, learning_rate=learning_rate,
                 weight_decay=weight_decay, batch_size=batch_size, micro_batch_size=micro_batch_size,
                 max_iters=max_iters, warmup_iters=warmup_iters, eval_interval=eval_interval,
                 eval_iters=eval_iters, save_interval=save_interval, log_interval=log_interval,
                 max_seq_length=max_seq_length, data_parallel=data_parallel, model_parallel=model_parallel,
                 group_by_length=group_by_length, device=device)


if __name__ == "__main__":
    from lit_llama_tpu_torch.utils.cli import cli

    cli(main)
