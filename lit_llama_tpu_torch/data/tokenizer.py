"""LLaMA tokenizer (counterpart of lit_llama_tpu/data/tokenizer.py without
its trainer): the reference wrapper's ``encode`` flags and ``decode`` over
the pure-Python SentencePiece model of ``data.sp_model``."""

from __future__ import annotations

from pathlib import Path
from typing import List, Union

import torch

from lit_llama_tpu_torch.data import sp_model


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
