"""Assemble a training corpus from the machine's Python sources and tokenize
it (counterpart of the JAX package's scripts/prepare_code_corpus.py: the same
flags, order and files).

    python -m lit_llama_tpu_torch.scripts.prepare_code_corpus --destination_path data/quality044

The ``.py`` files under ``ROOTS`` (the interpreter's site-packages and
standard library) of 256 bytes to ``max_file_kb`` are
shuffled by ``random.Random(seed)``, deduplicated by SHA-1 and joined with
blank lines up to ``max_mb`` MB; the first ``sample_mb`` MB train a BPE
tokenizer (``data.tokenizer.Tokenizer.train``, byte for byte the JAX
package's), and the corpus is encoded in newline-aligned 8 MB chunks (the
native encoder where it builds) into uint16 ``train.bin`` and, for the last
``val_fraction`` of the tokens, ``val.bin``: the layout of
``prepare_shakespeare``, which ``pretrain.shakespeare`` and
``evaluate.eval_quality`` read. Host work only: no ``--device``.
"""

from __future__ import annotations

import hashlib
import random
import sysconfig
import time
from pathlib import Path

from lit_llama_tpu_torch.utils.cli import host_only

# the running interpreter's installed packages and standard library: the two
# trees the JAX script names by their fixed paths in its image
ROOTS = (sysconfig.get_paths()["purelib"], sysconfig.get_paths()["stdlib"])


def collect_files(roots, max_file_kb: int) -> list:
    """The ``.py`` files under ``roots`` (outside ``__pycache__``) of 256
    bytes to ``max_file_kb`` KB, in the order the walk finds them."""
    files = []
    for root in roots:
        root = Path(root)
        if not root.exists():
            continue
        for p in root.rglob("*.py"):
            if "__pycache__" in p.parts:
                continue
            try:
                size = p.stat().st_size
            except OSError:
                continue
            if 256 <= size <= max_file_kb * 1024:
                files.append(p)
    return files


@host_only
def prepare(
    destination_path: Path = Path("data/quality044"),
    vocab_size: int = 8192,
    max_mb: int = 320,
    sample_mb: int = 8,
    val_fraction: float = 0.005,
    max_file_kb: int = 512,
    seed: int = 0,
) -> None:
    """Build the code corpus and tokenize it.

    Args:
        destination_path: Output directory (tokenizer.model, train.bin, val.bin).
        vocab_size: BPE vocabulary size (matches the 0.44B bench config).
        max_mb: Corpus size cap in MB of raw text.
        sample_mb: Text sample used to train the tokenizer.
        val_fraction: Fraction of tokens held out as val.bin.
        max_file_kb: Skip files larger than this (generated code).
        seed: File shuffle seed.
    """
    import numpy as np

    from lit_llama_tpu_torch.data.tokenizer import Tokenizer

    dest = Path(destination_path)
    dest.mkdir(parents=True, exist_ok=True)

    t0 = time.time()
    files = collect_files(ROOTS, max_file_kb)
    random.Random(seed).shuffle(files)
    print(f"{len(files)} candidate files ({time.time()-t0:.0f}s)", flush=True)

    seen = set()
    parts, total = [], 0
    cap = max_mb * 1024 * 1024
    for p in files:
        try:
            data = p.read_bytes()
        except OSError:
            continue
        h = hashlib.sha1(data).digest()
        if h in seen:
            continue
        seen.add(h)
        text = data.decode("utf-8", errors="ignore")
        parts.append(text)
        total += len(text)
        if total >= cap:
            break
    corpus = "\n\n".join(parts)
    del parts
    print(f"corpus: {total/1e6:.0f} MB from {len(seen)} files", flush=True)

    sample_path = dest / "_tok_sample.txt"
    sample_path.write_text(corpus[: sample_mb * 1024 * 1024])
    t0 = time.time()
    Tokenizer.train(str(sample_path), str(dest), vocab_size)
    sample_path.unlink()
    print(f"tokenizer trained ({time.time()-t0:.0f}s)", flush=True)
    tok = Tokenizer(dest / "tokenizer.model")

    # chunked encode (newline-aligned) to bound peak memory
    t0 = time.time()
    ids_parts = []
    chunk = 8 * 1024 * 1024
    i = 0
    while i < len(corpus):
        j = min(i + chunk, len(corpus))
        if j < len(corpus):
            nl = corpus.rfind("\n", i, j)
            if nl > i:
                j = nl
        ids_parts.append(tok.encode(corpus[i:j], bos=False).numpy().astype(np.uint16))
        i = j
        done = sum(len(a) for a in ids_parts)
        print(f"  encoded {i/1e6:.0f}/{len(corpus)/1e6:.0f} MB "
              f"({done/1e6:.1f}M tokens, {time.time()-t0:.0f}s)", flush=True)
    ids = np.concatenate(ids_parts)
    n_val = max(1, int(len(ids) * val_fraction))
    ids[:-n_val].tofile(dest / "train.bin")
    ids[-n_val:].tofile(dest / "val.bin")
    print(f"train {len(ids)-n_val:,} tokens, val {n_val:,} tokens")


if __name__ == "__main__":
    from lit_llama_tpu_torch.utils.cli import cli

    cli(prepare)
