"""Checkpoint conversion and data preparation entry points (counterparts of
the root ``scripts/`` of the JAX package), run as ``python -m
lit_llama_tpu_torch.scripts.<name>``."""
