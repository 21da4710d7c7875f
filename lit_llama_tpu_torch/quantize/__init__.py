"""Quantization entry point (counterpart of the JAX package's quantize/gptq.py):
``python -m lit_llama_tpu_torch.quantize.gptq``."""
