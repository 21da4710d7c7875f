"""Perplexity evaluation, GPTQ protocol (counterpart of
lit_llama_tpu/eval/perplexity.py).

Split the token stream into ``block_size`` windows, sum the token NLLs of
logits[:-1] against targets[1:], report ``exp(total_nll / total_tokens)``
(reference: evaluate/full.py:118-133). Each window is one causal ``forward``
of a (1, T) batch: on the card a prefill, so K4 takes the attention and
K3 / K6 the int4 / int8 linears; dense linears stay ``torch.matmul``, as in
the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lit_llama_tpu_torch.models import llama
from lit_llama_tpu_torch.models.config import LLaMAConfig


def _window_nll(params, tokens: torch.Tensor, config: LLaMAConfig, plain: bool = False):
    """tokens: (1, T) int64. Returns (sum NLL over the T-1 predictions as a 0-d f32
    tensor, count). ``plain`` runs the kernels' plain versions."""
    logits, _ = llama.forward(params, tokens, config, plain=plain)
    logits = logits[:, :-1].float()
    targets = tokens[:, 1:]
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = logz - ll
    return nll.sum(), nll.numel()


def perplexity(
    params,
    tokens,  # (N,) the full token stream
    config: LLaMAConfig,
    block_size: Optional[int] = None,
    max_windows: Optional[int] = None,
) -> float:
    """exp(sum nll / n_tokens) over non-overlapping windows on the params'
    device (reference: evaluate/full.py:118-133)."""
    block_size = block_size or config.block_size
    tokens = np.asarray(tokens, np.int32)
    n_windows = len(tokens) // block_size
    if max_windows is not None:
        n_windows = min(n_windows, max_windows)
    if n_windows == 0:
        raise ValueError(f"need at least {block_size} tokens for one window, got {len(tokens)}")
    dev = params["wte"].device
    total_nll, total_tok = 0.0, 0
    with torch.inference_mode():
        for i in range(n_windows):
            w = torch.from_numpy(tokens[i * block_size : (i + 1) * block_size][None, :]).long().to(dev)
            nll, cnt = _window_nll(params, w, config)
            total_nll += float(nll)
            total_tok += cnt
    return float(np.exp(total_nll / total_tok))
