"""Build the native C++ components with the host toolchain (counterpart of
lit_llama_tpu/native/build.py).

A library compiles on first use into ``build/lit_llama_tpu_torch/native/`` at
the repo root, named by a hash of its source, compiler and flags, so a changed
source rebuilds and an unchanged one loads as it is. Each build compiles to a
file of its own and moves it into place with ``os.replace``, so processes that
build at once (test workers) never load a half-written library. Without a
toolchain the callers fall back to pure Python.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional, Sequence

_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lit_llama_tpu_torch" / "native"
_LOCK = threading.Lock()
_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")


def library_path(name: str, source: str, extra_flags: Sequence[str] = ()) -> Path:
    cxx = os.environ.get("CXX", "g++")
    h = hashlib.sha256(" ".join((cxx, *_FLAGS, *extra_flags)).encode())
    h.update((_DIR / source).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_library(name: str, source: str, extra_flags: Sequence[str] = ()) -> Optional[Path]:
    """Compile ``native/<source>`` into a shared library, or find it built;
    returns None (with the compiler's message on stderr) when it cannot be
    built."""
    out = library_path(name, source, extra_flags)
    with _LOCK:
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [os.environ.get("CXX", "g++"), *_FLAGS, str(_DIR / source), "-o", str(tmp), *extra_flags]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=120)
            os.replace(tmp, out)
        except (subprocess.CalledProcessError, OSError, subprocess.TimeoutExpired) as e:
            print(f"[lit_llama_tpu_torch.native] build of {name} failed: {getattr(e, 'stderr', None) or e}",
                  file=sys.stderr)
            return None
        finally:
            tmp.unlink(missing_ok=True)
        return out
