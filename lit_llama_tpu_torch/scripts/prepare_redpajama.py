"""Tokenize RedPajama jsonl into LITPKDS chunk files (counterpart of the JAX
package's scripts/prepare_redpajama.py: the same flags and files, local input
only).

    python -m lit_llama_tpu_torch.scripts.prepare_redpajama --source_path data/RedPajama-Data-1T-Sample \
        --tokenizer_path checkpoints/lit-llama/tokenizer.model --destination_path data/red_pajama_sample --sample true

Sample mode reads the eleven ``*_sample.jsonl`` files of RedPajama-1T-Sample,
one ``PackedDatasetBuilder`` a file; full mode one builder a source, over the
files its pattern matches (``common_crawl`` is zstd-compressed, read through
``zstandard``, imported only there). Each document is its tokens plus eos,
without bos; chunks hold ``chunk_size`` tokens, bos between documents. Host
work only: no ``--device``.
"""

from __future__ import annotations

import glob
import json
import os
from pathlib import Path

from lit_llama_tpu_torch.utils.cli import host_only

filenames_sample = [
    "arxiv_sample.jsonl",
    "book_sample.jsonl",
    "c4_sample.jsonl",
    "cc_2019-30_sample.jsonl",
    "cc_2020-05_sample.jsonl",
    "cc_2021-04_sample.jsonl",
    "cc_2022-05_sample.jsonl",
    "cc_2023-06_sample.jsonl",
    "github_sample.jsonl",
    "stackexchange_sample.jsonl",
    "wikipedia_sample.jsonl",
]

filename_sets = {
    "arxiv": "arxiv/arxiv*",
    "book": "book/book*",
    "c4": "c4/c4-train*",
    "common_crawl": "common_crawl/*",
    "github": "github/filtered*",
    "stackexchange": "stackexchange/stackexchange*",
    "wikipedia": "wikipedia/wiki*",
}


def _builder(destination_path: Path, prefix: str, chunk_size: int, tokenizer):
    from lit_llama_tpu_torch.data.packed_dataset import PackedDatasetBuilder

    return PackedDatasetBuilder(outdir=str(destination_path), prefix=prefix, chunk_size=chunk_size,
                                sep_token=tokenizer.bos_id, dtype="auto", vocab_size=tokenizer.vocab_size)


def _add_rows(builder, rows, tokenizer) -> None:
    for row in rows:
        builder.add_array(tokenizer.encode(json.loads(row)["text"], bos=False, eos=True).numpy())


def prepare_sample(source_path: Path, tokenizer_path: Path, destination_path: Path, chunk_size: int) -> None:
    """Tokenize the RedPajama-1T-Sample jsonl files, a prefix a file."""
    from lit_llama_tpu_torch.data.tokenizer import Tokenizer

    destination_path.mkdir(parents=True, exist_ok=True)
    tokenizer = Tokenizer(tokenizer_path)
    for name in filenames_sample:
        filepath = source_path / name
        if not filepath.is_file():
            raise RuntimeError(f"Input file not found at {filepath}. Place the RedPajama-Data-1T-Sample files there.")
        builder = _builder(destination_path, os.path.splitext(name)[0], chunk_size, tokenizer)
        print(f"Processing {name}")
        with open(filepath, encoding="utf-8") as f:
            _add_rows(builder, f, tokenizer)
        builder.write_reminder()


def prepare_full(source_path: Path, tokenizer_path: Path, destination_path: Path, chunk_size: int,
                 match: str = "") -> None:
    """Tokenize the full RedPajama set, one PackedDataset a source."""
    from lit_llama_tpu_torch.data.tokenizer import Tokenizer

    destination_path.mkdir(parents=True, exist_ok=True)
    tokenizer = Tokenizer(tokenizer_path)
    for set_name, pattern in filename_sets.items():
        if match and match not in set_name:
            continue
        filenames = sorted(glob.glob(str(source_path / pattern), recursive=True))
        if not filenames:
            raise RuntimeError(f"No files matched {pattern} under {source_path}.")
        builder = _builder(destination_path, set_name, chunk_size, tokenizer)
        for name in filenames:
            print(f"Processing {name}")
            if set_name == "common_crawl":
                import zstandard as zstd

                with zstd.open(open(name, "rb"), "rt", encoding="utf-8") as f:
                    _add_rows(builder, f, tokenizer)
            else:
                with open(name, encoding="utf-8") as f:
                    _add_rows(builder, f, tokenizer)
        builder.write_reminder()


@host_only
def prepare(
    source_path: Path = Path("data/RedPajama-Data-1T-Sample"),
    tokenizer_path: Path = Path("checkpoints/lit-llama/tokenizer.model"),
    destination_path: Path = Path("data/red_pajama_sample"),
    chunk_size: int = 2049 * 1024,
    sample: bool = False,
    match: str = "",
) -> None:
    """Tokenize RedPajama into LITPKDS chunk files.

    Args:
        source_path: Directory with the raw jsonl files.
        tokenizer_path: SentencePiece tokenizer model.
        destination_path: Output directory for .bin chunk files.
        chunk_size: Tokens per chunk (reference: 2049*1024, i.e. 1024 blocks of 2048+1).
        sample: Process the 1T-Sample file list instead of the full set.
        match: Only process full-set sources whose name contains this substring.
    """
    source_path, tokenizer_path, destination_path = Path(source_path), Path(tokenizer_path), Path(destination_path)
    if sample:
        prepare_sample(source_path, tokenizer_path, destination_path, chunk_size)
    else:
        prepare_full(source_path, tokenizer_path, destination_path, chunk_size, match)


if __name__ == "__main__":
    from lit_llama_tpu_torch.utils.cli import cli

    cli(prepare)
