"""LoRA instruction finetuning (counterpart of the JAX package's
finetune/lora.py: the same flags and defaults, plus ``--device``).

    python -m lit_llama_tpu_torch.finetune.lora --data_dir DIR --checkpoint_path ckpt/lit-llama.pth \
        --tokenizer_path ckpt/tokenizer.model [--device cpu]

The base weights stay frozen in the checkpoint's dtype (bf16 on the card);
A and B of rank ``lora_r`` on the q and v groups of c_attn train, and the
checkpoints hold only them (``generate.lora`` loads them). ``lora_dropout``
is recorded in the config; the model's forward applies no dropout, as the
JAX package's training step runs it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional


def main(
    data_dir: Path = Path("data/alpaca"),
    checkpoint_path: Path = Path("checkpoints/lit-llama/7B/lit-llama.pth"),
    tokenizer_path: Path = Path("checkpoints/lit-llama/tokenizer.model"),
    out_dir: Path = Path("out/lora/alpaca"),
    learning_rate: float = 3e-4,
    batch_size: int = 128,
    micro_batch_size: int = 4,
    max_iters: int = 50000 * 3 // 4,
    warmup_iters: int = 100,
    eval_interval: int = 100,
    eval_iters: int = 100,
    save_interval: int = 100,
    log_interval: int = 1,
    max_seq_length: int = 256,
    lora_r: int = 8,
    lora_alpha: float = 16.0,
    lora_dropout: float = 0.05,
    data_parallel: int = -1,
    model_parallel: int = 1,
    group_by_length: bool = False,
    device: Optional[str] = None,
) -> None:
    """Finetune LLaMA with LoRA on an instruction dataset.

    Args:
        data_dir: Directory with train.pt / test.pt from prepare_alpaca.py.
        checkpoint_path: Base model checkpoint (.pth or native dir).
        tokenizer_path: SentencePiece tokenizer model.
        out_dir: Output directory for LoRA checkpoints.
        learning_rate: Peak AdamW learning rate (reference: 3e-4).
        batch_size: Global batch size (reference: 128).
        micro_batch_size: Per-step microbatch (reference: 4).
        max_iters: Total optimizer steps.
        warmup_iters: Linear warmup steps (reference: 100).
        eval_interval: Validate every N steps.
        eval_iters: Validation batches per eval.
        save_interval: Checkpoint every N steps.
        log_interval: Log every N steps.
        max_seq_length: Truncation length (see prepare_alpaca.py).
        lora_r: LoRA rank (reference: 8).
        lora_alpha: LoRA alpha (reference: 16).
        lora_dropout: LoRA input dropout (reference: 0.05).
        data_parallel: Data-parallel size: 1 or -1 (one device; multi-device is still to port).
        model_parallel: Tensor-parallel size: 1 (one device).
        group_by_length: Batch near-equal-length samples to minimize padding.
        device: cuda (the default: the card) or cpu (the plain PyTorch path).
    """
    from lit_llama_tpu_torch.training import finetune

    finetune.run("lora", data_dir, checkpoint_path, tokenizer_path, out_dir, learning_rate=learning_rate,
                 weight_decay=0.0, batch_size=batch_size, micro_batch_size=micro_batch_size, max_iters=max_iters,
                 warmup_iters=warmup_iters, eval_interval=eval_interval, eval_iters=eval_iters,
                 save_interval=save_interval, log_interval=log_interval, max_seq_length=max_seq_length,
                 lora_r=lora_r, lora_alpha=lora_alpha, lora_dropout=lora_dropout, data_parallel=data_parallel,
                 model_parallel=model_parallel, group_by_length=group_by_length, device=device)


if __name__ == "__main__":
    from lit_llama_tpu_torch.utils.cli import cli

    cli(main)
