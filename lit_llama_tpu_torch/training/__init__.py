"""Training (counterpart of lit_llama_tpu/training/): the step (loss, AdamW,
accumulation, clipping) and the loop (checkpoints with true resume,
validation, metrics)."""
