"""LLaMA tokenizer (counterpart of lit_llama_tpu/data/tokenizer.py): the
reference wrapper's ``encode`` flags and ``decode`` over ``data.sp_model``,
and a from-scratch BPE trainer whose models are byte-identical to the JAX
package's."""

from __future__ import annotations

import heapq
import os
from collections import Counter
from pathlib import Path
from typing import List, Union

import torch

from lit_llama_tpu_torch.data import sp_model
from lit_llama_tpu_torch.data.sp_model import CONTROL, UNKNOWN, WS, Piece, SPModel


class Tokenizer:
    """A ``tokenizer.model`` (SentencePiece proto, BPE or unigram)."""

    def __init__(self, model_path: Union[str, Path]) -> None:
        self.processor = sp_model.load_model(model_path)
        self.bos_id = self.processor.bos_id
        self.eos_id = self.processor.eos_id
        self.pad_id = self.processor.pad_id

    @property
    def vocab_size(self) -> int:
        return self.processor.vocab_size()

    def encode(self, string: str, bos: bool = True, eos: bool = False, max_length: int = -1,
               pad: bool = False) -> torch.Tensor:
        """Token ids as an int32 tensor: bos prepended, eos appended, cut to
        ``max_length`` (when > 0), right-padded with ``pad_id`` to it when
        ``pad``."""
        tokens: List[int] = self.processor.encode(string)
        if bos:
            tokens = [self.bos_id] + tokens
        if eos:
            tokens = tokens + [self.eos_id]
        if max_length > 0:
            tokens = tokens[:max_length]
        if pad and len(tokens) < max_length:
            tokens += [self.pad_id] * (max_length - len(tokens))
        return torch.tensor(tokens, dtype=torch.int32)

    def decode(self, tokens) -> str:
        if hasattr(tokens, "tolist"):
            tokens = tokens.tolist()
        return self.processor.decode(tokens)

    @staticmethod
    def train(input: str, destination: str, vocab_size: int = 32000) -> None:
        """Train a BPE tokenizer on the text file ``input`` and write
        ``destination/tokenizer.model``."""
        model = train_bpe(Path(input).read_text(encoding="utf-8"), vocab_size)
        with open(os.path.join(destination, "tokenizer.model"), "wb") as f:
            f.write(sp_model.serialize_model(model))


class _RevStr:
    """Inverts the order of strings, so the min-heap pops the largest pair
    among equal counts."""

    __slots__ = ("s",)

    def __init__(self, s):
        self.s = s

    def __lt__(self, other):
        return self.s > other.s


def train_bpe(text: str, vocab_size: int) -> SPModel:
    """BPE over a word-frequency table.

    Words are split on whitespace and prefixed with U+2581 (spm's escaped
    space and dummy prefix); the most frequent adjacent pair is merged, the
    lexicographically largest (count, pair) on ties, until the vocabulary
    holds ``vocab_size`` pieces or no pair is left. Merges score -1, -2, ...
    in merge order (the order the BPE encoder replays), the single characters
    below them in sorted order, after the three specials. Pair counts are
    kept live and the best pair found through a heap whose stale entries are
    skipped, so only the words that hold a merged pair are rescanned."""
    words: Counter = Counter()
    for line in text.splitlines():
        for w in line.split():
            words[WS + w] += 1

    chars = sorted({c for w in words for c in w})
    specials = [Piece("<unk>", 0.0, UNKNOWN), Piece("<s>", 0.0, CONTROL), Piece("</s>", 0.0, CONTROL)]
    n_base = len(specials) + len(chars)
    if vocab_size < n_base:
        raise ValueError(f"vocab_size={vocab_size} < {n_base} (specials + distinct characters)")

    seqs = {w: tuple(w) for w in words}
    pairs: Counter = Counter()
    pair_words: dict = {}
    for w, seq in seqs.items():
        f = words[w]
        for p in zip(seq, seq[1:]):
            pairs[p] += f
            pair_words.setdefault(p, set()).add(w)
    heap = [(-c, _RevStr(p), p) for p, c in pairs.items()]
    heapq.heapify(heap)

    merges: List[str] = []
    while n_base + len(merges) < vocab_size:
        best = None
        while heap:
            negc, _, p = heapq.heappop(heap)
            if pairs.get(p, 0) == -negc and -negc > 0:
                best = p
                break
        if best is None:
            break
        a, b = best
        merged = a + b
        merges.append(merged)
        for w in pair_words.pop(best, ()):
            seq = seqs[w]
            f = words[w]
            out = []
            i = 0
            while i < len(seq):
                if i + 1 < len(seq) and seq[i] == a and seq[i + 1] == b:
                    out.append(merged)
                    i += 2
                else:
                    out.append(seq[i])
                    i += 1
            new_seq = tuple(out)
            if new_seq == seq:
                continue  # the pair was merged away in this word already
            changed = set()
            for p in zip(seq, seq[1:]):
                pairs[p] -= f
                changed.add(p)
            for p in zip(new_seq, new_seq[1:]):
                pairs[p] += f
                changed.add(p)
                pair_words.setdefault(p, set()).add(w)
            seqs[w] = new_seq
            for p in changed:
                if pairs.get(p, 0) <= 0:
                    pairs.pop(p, None)
                    pair_words.pop(p, None)
                else:
                    heapq.heappush(heap, (-pairs[p], _RevStr(p), p))  # older entries go stale
        pairs.pop(best, None)

    pieces = list(specials)
    pieces += [Piece(m, -(i + 1.0)) for i, m in enumerate(merges)]
    pieces += [Piece(c, -(len(merges) + j + 1.0)) for j, c in enumerate(chars)]
    return SPModel(pieces=pieces, model_type=2)
