"""Parameter-efficient finetuning overlays (counterpart of
lit_llama_tpu/peft/): LoRA."""
