"""GPTQ int4 quantization of a checkpoint (counterpart of the JAX package's
quantize/gptq.py: the same flags, plus ``--device``).

    python -m lit_llama_tpu_torch.quantize.gptq --checkpoint_path ckpt/lit-llama.pth \
        --tokenizer_path ckpt/tokenizer.model --data_file calib.txt [--output_path DIR] [--device cpu]

The reference calibrates on 128 random 2048-token windows of C4 from the
HuggingFace hub; without network pass ``--data_file`` (raw text). If the
download fails, the calibration falls back to random tokens, with the JAX
package's line on stderr (a smoke run only: expect worse quality). The model
loads in f32; on the card the calibration forwards run K3 and K4 in f32. The
output is a native checkpoint directory with the JAX package's metadata
(``quantize: "int4"``, ``quant_groupsize``), which both packages' loaders
read.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np


def get_sample_data(tokenizer, n_samples: int, block_size: int, data_file, vocab_size: int,
                    seed: int = 42) -> np.ndarray:
    """(n_samples, block_size) int32 calibration windows (reference:
    gptq.py:24-35), drawn with the JAX package's numpy calls, so a
    ``data_file`` gives the same windows in both packages."""
    rng = np.random.default_rng(seed)
    if data_file is not None:
        tokens = np.asarray(tokenizer.encode(Path(data_file).read_text(), bos=False))
        if len(tokens) < n_samples * block_size:
            reps = -(-n_samples * block_size // len(tokens))
            tokens = np.tile(tokens, reps)
        starts = rng.integers(0, len(tokens) - block_size, size=n_samples)
        return np.stack([tokens[s : s + block_size] for s in starts]).astype(np.int32)
    try:
        from datasets import load_dataset  # needs network

        # one C4 train shard, 1000 random documents (reference: gptq.py:24-35;
        # the shard selected through data_files)
        ds = load_dataset("allenai/c4", data_files={"train": "en/c4-train.00000-of-01024.json.gz"}, split="train")
        order = rng.permutation(len(ds))[:1000]
        text = "\n".join(ds[int(i)]["text"] for i in order)
        tokens = np.asarray(tokenizer.encode(text, bos=False))
        starts = rng.integers(0, len(tokens) - block_size, size=n_samples)
        return np.stack([tokens[s : s + block_size] for s in starts]).astype(np.int32)
    except Exception as e:  # the JAX package's fallback: any failure to fetch or read C4
        print(f"calibration download failed ({e}); using random tokens", file=sys.stderr)
        return rng.integers(0, vocab_size, size=(n_samples, block_size)).astype(np.int32)


def main(
    checkpoint_path: Path = Path("checkpoints/lit-llama/7B/lit-llama.pth"),
    output_path: Optional[Path] = None,
    tokenizer_path: Path = Path("checkpoints/lit-llama/tokenizer.model"),
    n_samples: int = 128,
    block_size: int = 2048,
    groupsize: int = 128,
    batch: int = 4,
    data_file: Optional[Path] = None,
    actorder: bool = False,
    device: Optional[str] = None,
) -> None:
    """Blockwise GPTQ int4 quantization of a LLaMA checkpoint.

    Args:
        checkpoint_path: The checkpoint path to load (.pth or native dir).
        output_path: Output checkpoint directory (default: <input>.gptq.int4).
        tokenizer_path: The tokenizer path to load.
        n_samples: Calibration sequences (reference: 128).
        block_size: Calibration sequence length (reference: 2048).
        groupsize: Quantization group size along the input dim (reference: 128).
        batch: Calibration forward batch size.
        data_file: Local calibration text; random tokens if omitted and offline.
        actorder: Quantize rows in descending-diag(H) order (reference: quantization.py:542-545).
        device: cuda (the default) or cpu (the plain PyTorch path).
    """
    from lit_llama_tpu_torch.data.tokenizer import Tokenizer
    from lit_llama_tpu_torch.quant import gptq
    from lit_llama_tpu_torch.training.loop import config_meta
    from lit_llama_tpu_torch.utils import checkpoint as ckpt
    from lit_llama_tpu_torch.utils.device import resolve_device
    from lit_llama_tpu_torch.utils.loader import load_model
    from lit_llama_tpu_torch.utils.memory import print_peak_memory

    dev = resolve_device(device)
    checkpoint_path = Path(checkpoint_path)
    if output_path is None:
        output_path = checkpoint_path.parent / (checkpoint_path.stem + ".gptq.int4")
    tokenizer = Tokenizer(tokenizer_path)

    t0 = time.perf_counter()
    params, config = load_model(checkpoint_path, dtype="float32", device=dev)
    config = config.replace(quant_groupsize=groupsize)
    calib = get_sample_data(tokenizer, n_samples, min(block_size, config.block_size), data_file, config.vocab_size)
    print(f"loaded model + calib in {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    t0 = time.perf_counter()
    qparams = gptq.quantize_model_gptq(params, config, calib, groupsize=groupsize, batch=batch, actorder=actorder)
    print(f"GPTQ done in {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    print_peak_memory(dev)

    ckpt.save_checkpoint(output_path, {"params": qparams}, metadata={"config": config_meta(config.replace(quantize="int4"))})
    print(f"quantized checkpoint written to {output_path}")


if __name__ == "__main__":
    from lit_llama_tpu_torch.utils.cli import cli

    cli(main)
