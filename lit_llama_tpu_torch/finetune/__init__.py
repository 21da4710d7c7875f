"""Instruction-finetuning entry points (counterparts of the root finetune/
CLIs): ``python -m lit_llama_tpu_torch.finetune.{full,lora,adapter,adapter_v2}``."""
