"""GPTQ at the 65B layer shape under a bound on device memory (counterpart
of the JAX package's scripts/gptq_65b_dryrun.py: the same flags, defaults and
record, plus ``--device``).

    python -m lit_llama_tpu_torch.tools.gptq_65b_dryrun [--n_layer 1 --n_samples 2 --seq 2048 --batch 2]
    python -m lit_llama_tpu_torch.tools.gptq_65b_dryrun --device cpu --n_layer 1 --n_samples 2 --seq 32 --rows 512

Runs ``quant.gptq.quantize_model_gptq`` at the real 65B layer shape
(n_embd 8192, intermediate 22016, 64 heads: the "65B" preset) at a cut
depth, with ``host_spill``: the weights and the stage activations stay on
the host, and the card holds one layer's weights, one Hessian and one
calibration batch at a time (the reference's one block on the device,
quantize/gptq.py:74-75, 116-129). On the card the calibration forwards run
K3 and K4 in f32 at M = batch x seq rows.

The weights and the calibration tokens are drawn from
``np.random.default_rng(0)`` in the JAX script's order (wte, c_attn,
attention c_proj, c_fc1, c_fc2, MLP c_proj, lm_head, then the tokens), each
weight ``standard_normal * 0.01`` in f32, so both scripts quantize the same
tree. Prints one JSON line with the JAX script's keys; ``peak_device_gb`` is
``torch.cuda.max_memory_allocated`` over the run (0 on the CPU, where
``ok`` holds), and the exit code is 1 when it passes ``mem_cap_gb``.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Optional

import numpy as np

from lit_llama_tpu_torch.models.config import LLaMAConfig


def dryrun_config(n_layer: int, seq: int, groupsize: int, rows: int) -> LLaMAConfig:
    """The 65B preset's widths at ``n_layer`` layers, or with ``rows`` the
    CPU cut (n_embd ``rows``, ``rows // 128`` heads), as the JAX script
    builds it."""
    cfg65 = LLaMAConfig.from_name("65B")
    D, H = cfg65.n_embd, cfg65.n_head
    if rows:
        D, H = rows, rows // 128
    config = LLaMAConfig(block_size=max(seq, 128), vocab_size=32000, n_layer=n_layer, n_head=H, n_embd=D,
                         quant_groupsize=groupsize)
    if not rows:
        assert config.intermediate_size == cfg65.intermediate_size, (config.intermediate_size,
                                                                     cfg65.intermediate_size)
    return config


def host_params(config: LLaMAConfig, n_samples: int, seq: int):
    """(numpy params, (n_samples, seq) int32 calibration tokens), drawn in
    the JAX script's order from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    L, D, I, V = config.n_layer, config.n_embd, config.intermediate_size, config.padded_vocab_size

    def w(shape):
        return (rng.standard_normal(shape) * 0.01).astype(np.float32)

    params = {
        "wte": w((V, D)),
        "h": {
            "rms_1": np.ones((L, D), np.float32),
            "attn": {"c_attn": {"w": w((L, D, 3 * D))}, "c_proj": {"w": w((L, D, D))}},
            "rms_2": np.ones((L, D), np.float32),
            "mlp": {"c_fc1": {"w": w((L, D, I))}, "c_fc2": {"w": w((L, D, I))}, "c_proj": {"w": w((L, I, D))}},
        },
        "ln_f": np.ones((D,), np.float32),
        "lm_head": {"w": w((D, V))},
    }
    calib = rng.integers(1, 32000, size=(n_samples, seq)).astype(np.int32)
    return params, calib


def peak_device_gb(dev) -> float:
    """GiB of the card's peak allocation since the last reset; 0 on the CPU."""
    import torch

    return torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0


def main(
    n_layer: int = 1,
    n_samples: int = 16,
    seq: int = 2048,
    groupsize: int = 128,
    batch: int = 2,
    rows: int = 0,
    mem_cap_gb: float = 14.0,
    device: Optional[str] = None,
) -> None:
    """65B-shape GPTQ dry run with host-spilled stages.

    Args:
        n_layer: Transformer blocks to quantize (depth doesn't change the per-layer memory model; 65B is this x 80).
        n_samples: Calibration sequences (reference protocol: 128).
        seq: Calibration sequence length (reference: 2048).
        groupsize: Quantization group size.
        batch: Device-resident calibration slice.
        rows: Truncate the widths for a CPU run (0 = full 65B widths).
        mem_cap_gb: Fail if peak device memory exceeds this.
        device: cuda (the default: the card) or cpu (the plain PyTorch path).
    """
    import torch

    from lit_llama_tpu_torch.quant import gptq
    from lit_llama_tpu_torch.utils.device import resolve_device
    from lit_llama_tpu_torch.utils.jax_params import params_from_numpy

    dev = resolve_device(device)
    config = dryrun_config(n_layer, seq, groupsize, rows)
    arrays, calib = host_params(config, n_samples, seq)
    params = params_from_numpy(arrays, device="cpu")  # on the host: a 65B checkpoint does not fit the card
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    t0 = time.perf_counter()
    out = gptq.quantize_model_gptq(params, config, calib, groupsize=groupsize, batch=batch, host_spill=True,
                                   device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0

    assert out["h"]["attn"]["c_attn"]["qw"].device.type == "cpu"
    assert tuple(out["h"]["mlp"]["c_proj"]["qw"].shape) == (n_layer, config.intermediate_size // 2, config.n_embd)
    peak_gb = peak_device_gb(dev)
    rec = {
        "metric": "gptq_65b_shape_dryrun",
        "n_layer": n_layer,
        "n_samples": n_samples,
        "seq": seq,
        "widths": [config.n_embd, config.intermediate_size],
        "seconds": round(dt, 1),
        "peak_device_gb": round(peak_gb, 2),
        "mem_cap_gb": mem_cap_gb,
        "ok": (peak_gb == 0.0) or (peak_gb <= mem_cap_gb),
    }
    print(json.dumps(rec))
    if not rec["ok"]:
        sys.exit(1)


if __name__ == "__main__":
    from lit_llama_tpu_torch.utils.cli import cli

    cli(main)
