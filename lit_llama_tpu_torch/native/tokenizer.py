"""ctypes binding of the C++ tokenizer encoder ``native/fast_tokenizer.cpp``
(counterpart of lit_llama_tpu/native/tokenizer.py).

``NativeEncoder(sp_model)`` encodes as ``SPModel.encode_py`` does, id for
id; ``available()`` says whether the library built.
"""

from __future__ import annotations

import ctypes
from typing import List

from lit_llama_tpu_torch.native.build import build_library

_lib = None
_lib_tried = False


def _load():
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    path = build_library("fast_tokenizer", "fast_tokenizer.cpp")
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.tok_create.restype = ctypes.c_void_p
    lib.tok_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_float),
                               ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 6
    lib.tok_free.argtypes = [ctypes.c_void_p]
    lib.tok_encode.restype = ctypes.c_int
    lib.tok_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


class NativeEncoder:
    def __init__(self, model) -> None:
        """``model``: a ``data.sp_model.SPModel``; its piece table is copied
        into the library."""
        lib = _load()
        if lib is None:
            raise RuntimeError("the native tokenizer library did not build")
        self._lib = lib
        n = len(model.pieces)
        self._piece_bufs = [p.piece.encode("utf-8") for p in model.pieces]
        self._h = lib.tok_create((ctypes.c_char_p * n)(*self._piece_bufs),
                                 (ctypes.c_float * n)(*[p.score for p in model.pieces]),
                                 (ctypes.c_int * n)(*[p.type for p in model.pieces]), n, model.model_type,
                                 model.unk_id, int(model.byte_fallback), int(model.add_dummy_prefix),
                                 int(model.remove_extra_whitespaces))
        self._cap = 1 << 14

    def encode(self, text: str) -> List[int]:
        data = text.encode("utf-8")
        while True:
            buf = (ctypes.c_int32 * self._cap)()
            n = self._lib.tok_encode(self._h, data, buf, self._cap)
            if n <= self._cap:
                return list(buf[:n])
            self._cap = max(self._cap * 2, n)

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.tok_free(self._h)
        except Exception:
            pass
