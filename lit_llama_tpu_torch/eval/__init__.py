"""Perplexity evaluation (counterpart of lit_llama_tpu/eval)."""
