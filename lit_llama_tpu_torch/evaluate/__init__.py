"""Evaluation entry points (counterparts of the JAX package's evaluate/ CLIs
and scripts/eval_quality.py):
``python -m lit_llama_tpu_torch.evaluate.{full,lora,adapter,adapter_v2,eval_quality}``."""
