"""Perplexity of a checkpoint, GPTQ protocol (counterpart of the JAX
package's evaluate/full.py: the same flags, plus ``--device``).

    python -m lit_llama_tpu_torch.evaluate.full --checkpoint_path ckpt/lit-llama.pth \
        --tokenizer_path ckpt/tokenizer.model --data_file text.txt [--quantize llm.int8] [--device cpu]

wikitext / ptb / c4 come from the HuggingFace hub (reference: evaluate/full.py,
2048-token windows, exp(sum nll / tokens)); without network pass
``--data_file``: raw text, or a pre-tokenized ``.bin``, which is read as
uint16 only, as the JAX package reads it. A GPTQ output directory
(``quantize.gptq``) loads as it is. Prints ``perplexity: ...`` on stdout.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np


def load_eval_text(name: str) -> str:
    """One evaluation corpus from the HF hub (reference: evaluate/full.py:25-45:
    the same datasets, splits, document joiners and the 1100-document C4
    cap; the C4 validation shard selected through ``data_files``)."""
    from datasets import load_dataset  # the HF hub (needs network)

    if name == "wikitext":
        ds = load_dataset("wikitext", "wikitext-2-raw-v1", split="test")
        return "\n\n".join(ds["text"])
    if name == "ptb":
        ds = load_dataset("ptb_text_only", "penn_treebank", split="test")
        return "\n\n".join(ds["sentence"])
    if name == "c4":
        ds = load_dataset(
            "allenai/c4",
            data_files={"validation": "en/c4-validation.00000-of-00008.json.gz"},
            split="validation",
        )
        return " ".join(ds[:1100]["text"])
    raise ValueError(f"unknown dataset {name!r}; pass --data_file for local data")


def load_eval_tokens(datasets: str, data_file: Optional[Path], tokenizer) -> np.ndarray:
    """The token stream to evaluate: ``data_file`` (a ``.bin`` of uint16 ids,
    or text) if given, else the first of ``datasets`` from the hub."""
    if data_file is not None:
        data_file = Path(data_file)
        if data_file.suffix == ".bin":
            return np.fromfile(data_file, dtype=np.uint16).astype(np.int32)
        text = data_file.read_text()
    else:
        text = load_eval_text(datasets.split(",")[0])
    return np.asarray(tokenizer.encode(text, bos=True, eos=False), np.int32)


def evaluate(params, config, tokenizer_path: Path, datasets: str, data_file: Optional[Path], block_size: int,
             max_windows: Optional[int], device) -> float:
    """The evaluation shared by the ``evaluate.*`` entry points: the tokens,
    then the windowed perplexity of ``params`` on ``device``,
    printed with its time and the peak device memory on stderr."""
    from lit_llama_tpu_torch.data.tokenizer import Tokenizer
    from lit_llama_tpu_torch.eval.perplexity import perplexity
    from lit_llama_tpu_torch.utils.memory import print_peak_memory

    tokens = load_eval_tokens(datasets, data_file, Tokenizer(tokenizer_path))
    t0 = time.perf_counter()
    ppl = perplexity(params, tokens, config, block_size=block_size, max_windows=max_windows)
    print(f"perplexity: {ppl:.4f}")
    print(f"Time for evaluation: {time.perf_counter() - t0:.02f} sec", file=sys.stderr)
    print_peak_memory(device)
    return ppl


def main(
    datasets: str = "wikitext",
    checkpoint_path: Path = Path("checkpoints/lit-llama/7B/lit-llama.pth"),
    tokenizer_path: Path = Path("checkpoints/lit-llama/tokenizer.model"),
    model_size: Optional[str] = None,
    quantize: Optional[str] = None,
    block_size: int = 2048,
    max_windows: Optional[int] = None,
    data_file: Optional[Path] = None,
    device: Optional[str] = None,
) -> None:
    """Evaluate model perplexity (GPTQ protocol).

    Args:
        datasets: Comma-separated dataset names (wikitext, ptb, c4).
        checkpoint_path: The checkpoint path to load (.pth or native dir).
        tokenizer_path: The tokenizer path to load.
        model_size: Override the model preset if it cannot be inferred.
        quantize: Whether to quantize the model: "llm.int8" or "gptq.int4".
        block_size: Window length (reference: 2048).
        max_windows: Cap the number of windows (quick checks).
        data_file: Local text (or pre-tokenized uint16 .bin) file instead of downloading.
        device: cuda (the default) or cpu (the plain PyTorch path).
    """
    from lit_llama_tpu_torch.models.llama import unstack_layers
    from lit_llama_tpu_torch.utils.device import resolve_device
    from lit_llama_tpu_torch.utils.loader import load_model

    dev = resolve_device(device)
    params, config = load_model(Path(checkpoint_path), quantize, model_size, device=dev)
    evaluate(unstack_layers(params), config, tokenizer_path, datasets, data_file, block_size, max_windows, dev)


if __name__ == "__main__":
    from lit_llama_tpu_torch.utils.cli import cli

    cli(main)
