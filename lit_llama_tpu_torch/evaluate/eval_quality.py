"""Perplexity against bit width on a trained checkpoint (counterpart of the
JAX package's scripts/eval_quality.py: the same flags, plus ``--device``).

    python -m lit_llama_tpu_torch.evaluate.eval_quality --ckpt_dir out/quality/final \
        --data_dir data/quality --groupsize 64 [--device cpu]

Evaluates the same trained weights as stored ("bf16", whatever dtype the
checkpoint holds, as the JAX script labels it), round-to-nearest int8,
round-to-nearest int4 and GPTQ int4 (calibrated on ``train.bin``) on
``val.bin`` (both uint16 token ids), and prints the ladder and a JSON line
with ``gptq_closes_gap``: whether GPTQ's gap to the unquantized perplexity is
no wider than round-to-nearest's.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional

import numpy as np


def main(
    ckpt_dir: Path = Path("out/quality/final"),
    data_dir: Path = Path("data/quality"),
    groupsize: int = 64,
    n_calib: int = 32,
    calib_block: int = 256,
    max_windows: int = 64,
    actorder: bool = True,
    out_json: Optional[Path] = None,
    device: Optional[str] = None,
) -> None:
    """Evaluate val perplexity of a trained checkpoint at bf16/int8/int4.

    Args:
        ckpt_dir: Native training checkpoint directory (from pretrain/*.py).
        data_dir: Directory with train.bin / val.bin (calibration + eval).
        groupsize: int4 quantization group size.
        n_calib: GPTQ calibration samples.
        calib_block: GPTQ calibration window length.
        max_windows: Max val windows per evaluation.
        actorder: GPTQ column ordering by descending diag(H).
        out_json: Optional path for the machine-readable result row.
        device: cuda (the default) or cpu (the plain PyTorch path).
    """
    from lit_llama_tpu_torch.eval.perplexity import perplexity
    from lit_llama_tpu_torch.models import llama
    from lit_llama_tpu_torch.models.config import LLaMAConfig
    from lit_llama_tpu_torch.quant.gptq import quantize_model_gptq
    from lit_llama_tpu_torch.utils import checkpoint as ckpt
    from lit_llama_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    meta = ckpt.load_metadata(ckpt_dir)["config"]
    meta.pop("quantize", None), meta.pop("quant_groupsize", None)
    config = LLaMAConfig(**{k: v for k, v in meta.items() if k != "padded_vocab_size"})
    params = ckpt.load_checkpoint(ckpt_dir, transform=lambda n, t: t.to(dev))["params"]

    val = np.fromfile(Path(data_dir) / "val.bin", dtype=np.uint16)
    train = np.fromfile(Path(data_dir) / "train.bin", dtype=np.uint16)
    rng = np.random.default_rng(7)
    starts = rng.integers(0, len(train) - calib_block, size=n_calib)
    calib = np.stack([train[s : s + calib_block] for s in starts]).astype(np.int32)

    results = {}

    def run(name, p, cfg):
        t0 = time.perf_counter()
        ppl = perplexity(p, val, cfg, max_windows=max_windows)
        print(f"{name:10s} val ppl {ppl:8.4f}   ({time.perf_counter()-t0:.0f}s)", flush=True)
        results[name] = round(ppl, 4)

    run("bf16", params, config)
    cfg8 = config.replace(quantize="int8")
    run("int8", llama.quantize_params(params, cfg8), cfg8)
    cfg4 = config.replace(quantize="int4", quant_groupsize=groupsize)
    run("rtn-int4", llama.quantize_params(params, cfg4), cfg4)
    t0 = time.perf_counter()
    gptq_params = quantize_model_gptq(params, config, calib, groupsize=groupsize, actorder=actorder)
    print(f"gptq quantization: {time.perf_counter()-t0:.0f}s", flush=True)
    run("gptq-int4", gptq_params, cfg4)

    gap_rtn = results["rtn-int4"] - results["bf16"]
    gap_gptq = results["gptq-int4"] - results["bf16"]
    summary = {
        "metric": "quant_quality_val_ppl",
        "ppl": results,
        "groupsize": groupsize,
        "actorder": actorder,
        "gptq_closes_gap": bool(gap_gptq <= gap_rtn + 1e-6),
    }
    print(json.dumps(summary))
    if out_json is not None:
        Path(out_json).write_text(json.dumps(summary, indent=2))


if __name__ == "__main__":
    from lit_llama_tpu_torch.utils.cli import cli

    cli(main)
