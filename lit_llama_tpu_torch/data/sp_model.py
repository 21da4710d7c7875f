"""SentencePiece models (counterpart of
lit_llama_tpu/data/sp_model.py): proto I/O, BPE and unigram encoding, decode.

* ``parse_model`` / ``serialize_model`` speak the ``sentencepiece_model.proto``
  wire format (a small protobuf varint codec), so Meta's ``tokenizer.model``
  loads without the sentencepiece library, and a model serialized here loads
  in it.
* ``SPModel.encode`` covers the two model types LLaMA tokenizers use: BPE
  (score-ordered pair merging) and unigram (Viterbi), with byte fallback and
  the whitespace escaping (U+2581) of the C++ normalizer's "identity" rule.

``SPModel.encode`` runs the C++ encoder of ``native/fast_tokenizer.cpp``
(built with the host's compiler on first use) and falls back to the Python
encoder, ``encode_py``, where it cannot be built or ``LIT_LLAMA_TPU_NO_NATIVE``
is set; both give the same ids.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

# SentencePiece piece types (sentencepiece_model.proto, enum SentencePiece.Type)
NORMAL = 1
UNKNOWN = 2
CONTROL = 3
USER_DEFINED = 4
UNUSED = 5
BYTE = 6

WS = "▁"  # ▁ U+2581 LOWER ONE QUARTER BLOCK, spm's escaped space
UNK_SURFACE = " ⁇ "  # " ⁇ ", spm's default unk decode surface


@dataclass
class Piece:
    piece: str
    score: float
    type: int = NORMAL


# ---------------------------------------------------------------------------
# Protobuf wire codec (just what ModelProto needs)
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    out = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _write_varint(out: bytearray, v: int) -> None:
    if v < 0:
        v &= (1 << 64) - 1  # negative int32/int64 → 10-byte two's complement
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _signed(v: int) -> int:
    """Interpret a varint as a signed 64-bit value (proto int32/int64 fields)."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a serialized message."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        fnum, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire == 1:
            v, i = buf[i : i + 8], i + 8
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            v, i = buf[i : i + ln], i + ln
        elif wire == 5:
            v, i = buf[i : i + 4], i + 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield fnum, wire, v


def _tag(out: bytearray, fnum: int, wire: int) -> None:
    _write_varint(out, (fnum << 3) | wire)


def _put_bytes(out: bytearray, fnum: int, data: bytes) -> None:
    _tag(out, fnum, 2)
    _write_varint(out, len(data))
    out += data


def _put_varint(out: bytearray, fnum: int, v: int) -> None:
    _tag(out, fnum, 0)
    _write_varint(out, v)


def _put_float(out: bytearray, fnum: int, v: float) -> None:
    _tag(out, fnum, 5)
    out += struct.pack("<f", v)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


@dataclass
class SPModel:
    """A SentencePiece model: piece inventory + encode/decode.

    model_type: 1 = unigram, 2 = BPE (TrainerSpec.ModelType).
    """

    pieces: List[Piece]
    model_type: int = 1
    unk_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = -1
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    byte_fallback: bool = False
    vocab: Dict[str, int] = field(init=False, repr=False)

    def __post_init__(self):
        self.vocab = {p.piece: i for i, p in enumerate(self.pieces)}
        # pieces eligible as encode output (control/unk/unused text never matches)
        self._encode_vocab = {
            p.piece: i
            for i, p in enumerate(self.pieces)
            if p.type in (NORMAL, USER_DEFINED)
        }
        self._byte_ids = {
            int(p.piece[3:5], 16): i for i, p in enumerate(self.pieces) if p.type == BYTE
        }
        self._max_piece_len = max(
            (len(p) for p in self._encode_vocab), default=1
        )
        scores = [p.score for p in self.pieces if p.type == NORMAL]
        self._min_score = min(scores, default=0.0)

    def vocab_size(self) -> int:
        return len(self.pieces)

    # -- normalization ------------------------------------------------------

    def _normalize(self, text: str) -> str:
        if self.remove_extra_whitespaces:
            # sentencepiece trims/collapses only ASCII space (0x20); other
            # whitespace (\n, \t, NBSP, ...) is preserved and later handled by
            # byte fallback (e.g. <0x0A>). `str.split()` would eat those.
            text = " ".join(p for p in text.split(" ") if p)
        if self.add_dummy_prefix and text:
            text = " " + text
        return text.replace(" ", WS)

    # -- encoding -----------------------------------------------------------

    def encode(self, text: str) -> List[int]:
        enc = self._native()
        if enc is not None:
            return enc.encode(text)
        return self.encode_py(text)

    def encode_py(self, text: str) -> List[int]:
        """The pure-Python encoder (the C++ one is held against it)."""
        s = self._normalize(text)
        if not s:
            return []
        if self.model_type == 2:
            symbols = self._bpe(s)
        else:
            symbols = self._viterbi(s)
        return self._resolve(symbols)

    def _native(self):
        """The C++ encoder over this model's pieces, built and bound on first
        use; None without a toolchain."""
        if not hasattr(self, "_native_enc"):
            self._native_enc = None
            if not os.environ.get("LIT_LLAMA_TPU_NO_NATIVE"):
                try:
                    from lit_llama_tpu_torch.native.tokenizer import NativeEncoder

                    self._native_enc = NativeEncoder(self)
                except Exception:
                    self._native_enc = None
        return self._native_enc

    def _bpe(self, s: str) -> List[str]:
        """Score-ordered pair merging: repeatedly merge the adjacent pair whose
        concatenation is the highest-scoring vocab piece (leftmost on ties).

        Priority queue + linked list (O(n log n)); stale heap entries are
        skipped by begin/end checks."""
        import heapq

        n = len(s)
        if n == 0:
            return []
        ev = self._encode_vocab
        pieces = self.pieces
        # symbol b: [begin, end, prev, next, alive]
        syms = [[i, i + 1, i - 1, i + 1 if i + 1 < n else -1, True] for i in range(n)]

        heap: List = []

        def try_push(li: int) -> None:
            if li < 0:
                return
            l = syms[li]
            if not l[4] or l[3] < 0:
                return
            r = syms[l[3]]
            j = ev.get(s[l[0] : r[1]])
            if j is None:
                return
            # max-heap by score, then leftmost begin
            heapq.heappush(heap, (-pieces[j].score, l[0], li, l[0], l[1], r[1]))

        for i in range(n):
            try_push(i)

        while heap:
            _, _, li, b0, e0, re0 = heapq.heappop(heap)
            l = syms[li]
            if not l[4] or l[0] != b0 or l[1] != e0 or l[3] < 0:
                continue
            r = syms[l[3]]
            if r[1] != re0:
                continue
            l[1] = r[1]
            r[4] = False
            l[3] = r[3]
            if r[3] >= 0:
                syms[r[3]][2] = li
            try_push(l[2])
            try_push(li)

        out = []
        i = 0
        while 0 <= i < n:
            if syms[i][4]:
                out.append(s[syms[i][0] : syms[i][1]])
                i = syms[i][3] if syms[i][3] >= 0 else n
            else:
                i += 1
        return out

    def _viterbi(self, s: str) -> List[str]:
        """Unigram Viterbi: max-sum-of-scores segmentation; unknown single chars
        get min_score - 10 (spm's kUnkPenalty)."""
        n = len(s)
        unk_score = self._min_score - 10.0
        best = [float("-inf")] * (n + 1)
        back: List[int] = [0] * (n + 1)
        best[0] = 0.0
        ev = self._encode_vocab
        for i in range(1, n + 1):
            lo = max(0, i - self._max_piece_len)
            for j in range(lo, i):
                if best[j] == float("-inf"):
                    continue
                sub = s[j:i]
                k = ev.get(sub)
                if k is not None:
                    cand = best[j] + self.pieces[k].score
                elif i - j == 1:
                    cand = best[j] + unk_score
                else:
                    continue
                if cand > best[i]:
                    best[i], back[i] = cand, j
        out: List[str] = []
        i = n
        while i > 0:
            j = back[i]
            out.append(s[j:i])
            i = j
        out.reverse()
        return out

    def _resolve(self, symbols: List[str]) -> List[int]:
        """Map surface symbols to ids; unknown symbols go through byte fallback
        or collapse into a single unk per run."""
        ids: List[int] = []
        prev_unk = False
        for sym in symbols:
            j = self._encode_vocab.get(sym)
            if j is not None:
                ids.append(j)
                prev_unk = False
            elif self.byte_fallback and self._byte_ids:
                for b in sym.encode("utf-8"):
                    ids.append(self._byte_ids[b])
                prev_unk = False
            else:
                if not prev_unk:
                    ids.append(self.unk_id)
                prev_unk = True
        return ids

    # -- decoding -----------------------------------------------------------

    def decode(self, ids) -> str:
        out: List[str] = []
        byte_buf = bytearray()

        def flush():
            if byte_buf:
                out.append(byte_buf.decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            i = int(i)
            if i < 0 or i >= len(self.pieces):
                continue
            p = self.pieces[i]
            if p.type == BYTE:
                byte_buf.append(int(p.piece[3:5], 16))
                continue
            flush()
            if p.type == CONTROL:
                continue
            if p.type == UNKNOWN:
                out.append(UNK_SURFACE)
            else:
                out.append(p.piece)
        flush()
        text = "".join(out).replace(WS, " ")
        return text[1:] if text.startswith(" ") else text


# ---------------------------------------------------------------------------
# ModelProto serialization (sentencepiece_model.proto)
# ---------------------------------------------------------------------------

# Field numbers used:
#   ModelProto:     pieces=1, trainer_spec=2, normalizer_spec=3
#   SentencePiece:  piece=1, score=2, type=3
#   TrainerSpec:    model_type=3, vocab_size=4, byte_fallback=35,
#                   unk_id=40, bos_id=41, eos_id=42, pad_id=43, unk_surface=44
#   NormalizerSpec: name=1, add_dummy_prefix=3, remove_extra_whitespaces=4,
#                   escape_whitespaces=5


def parse_model(data: bytes) -> SPModel:
    pieces: List[Piece] = []
    kwargs = dict(
        model_type=1,
        unk_id=0,
        bos_id=1,
        eos_id=2,
        pad_id=-1,
        add_dummy_prefix=True,
        remove_extra_whitespaces=True,
        byte_fallback=False,
    )
    for fnum, wire, v in _iter_fields(data):
        if fnum == 1 and wire == 2:
            piece, score, ptype = "", 0.0, NORMAL
            for pf, pw, pv in _iter_fields(v):
                if pf == 1:
                    piece = pv.decode("utf-8")
                elif pf == 2:
                    score = struct.unpack("<f", pv)[0]
                elif pf == 3:
                    ptype = pv
            pieces.append(Piece(piece, score, ptype))
        elif fnum == 2 and wire == 2:  # TrainerSpec
            for tf, tw, tv in _iter_fields(v):
                if tf == 3:
                    kwargs["model_type"] = tv
                elif tf == 35:
                    kwargs["byte_fallback"] = bool(tv)
                elif tf == 40:
                    kwargs["unk_id"] = _signed(tv)
                elif tf == 41:
                    kwargs["bos_id"] = _signed(tv)
                elif tf == 42:
                    kwargs["eos_id"] = _signed(tv)
                elif tf == 43:
                    kwargs["pad_id"] = _signed(tv)
        elif fnum == 3 and wire == 2:  # NormalizerSpec
            for nf, nw, nv in _iter_fields(v):
                if nf == 3:
                    kwargs["add_dummy_prefix"] = bool(nv)
                elif nf == 4:
                    kwargs["remove_extra_whitespaces"] = bool(nv)
    return SPModel(pieces=pieces, **kwargs)


def serialize_model(m: SPModel) -> bytes:
    out = bytearray()
    for p in m.pieces:
        sp = bytearray()
        _put_bytes(sp, 1, p.piece.encode("utf-8"))
        _put_float(sp, 2, p.score)
        _put_varint(sp, 3, p.type)
        _put_bytes(out, 1, bytes(sp))

    ts = bytearray()
    _put_varint(ts, 3, m.model_type)
    _put_varint(ts, 4, len(m.pieces))
    _put_varint(ts, 35, int(m.byte_fallback))
    _put_varint(ts, 40, m.unk_id)
    _put_varint(ts, 41, m.bos_id)
    _put_varint(ts, 42, m.eos_id)
    _put_varint(ts, 43, m.pad_id)
    _put_bytes(ts, 44, UNK_SURFACE.encode("utf-8"))
    _put_bytes(out, 2, bytes(ts))

    ns = bytearray()
    _put_bytes(ns, 1, b"identity")
    _put_varint(ns, 3, int(m.add_dummy_prefix))
    _put_varint(ns, 4, int(m.remove_extra_whitespaces))
    _put_varint(ns, 5, 1)  # escape_whitespaces
    _put_bytes(out, 3, bytes(ns))
    return bytes(out)


def load_model(path) -> SPModel:
    with open(path, "rb") as f:
        return parse_model(f.read())
