"""Post-training quantization (counterpart of lit_llama_tpu/quant)."""
