"""PyTorch/CUDA port of lit_llama_tpu for one NVIDIA H100.

The JAX package ``lit_llama_tpu`` stays the reference; this package mirrors its
module names (``models/``, ``ops/``, ``utils/``) so each counterpart is easy to
find. Every Pallas kernel on the ported path has a hand-written Hopper kernel
under ``csrc/`` with a plain PyTorch version beside its wrapper.

Importing the package is cheap: it loads no torch module and builds no kernel.
Kernels are compiled with ``nvcc`` at first use (``ops/_build.py``).
"""

from lit_llama_tpu_torch.models.config import AdapterConfig, LLaMAConfig, LoRAConfig

__all__ = ["AdapterConfig", "LLaMAConfig", "LoRAConfig"]

__version__ = "0.1.0"
