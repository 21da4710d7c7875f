"""Typed CLI from a function signature (counterpart of
lit_llama_tpu/utils/cli.py, without its JAX platform and compile-cache hooks).

One flag per parameter, types from the annotations, defaults from the
signature, help text from the docstring's ``Args:`` section. The port's entry
points take a ``device`` parameter, so every one of them has ``--device``:
left unset they run on the card, ``--device cpu`` runs the plain PyTorch path
on the CPU. An entry point that does no device work (a checkpoint conversion,
a data preparation) says so with ``@host_only`` and has no ``--device``.

Under ``torchrun`` every rank runs the entry point, and only rank 0 writes
its standard output (the other ranks' goes to the null device; their
standard error stays, for their logs and errors).
"""

from __future__ import annotations

import argparse
import inspect
import os
import re
import sys
import typing
from pathlib import Path
from typing import Callable, Optional


def _docstring_arg_help(fn: Callable) -> dict:
    doc = inspect.getdoc(fn) or ""
    helps = {}
    in_args = False
    current = None
    for line in doc.splitlines():
        stripped = line.strip()
        if stripped.lower() in ("args:", "arguments:"):
            in_args = True
            continue
        if in_args:
            m = re.match(r"^(\w+)\s*(?:\([^)]*\))?\s*:\s*(.*)$", stripped)
            if m:
                current = m.group(1)
                helps[current] = m.group(2)
            elif stripped and current:
                helps[current] += " " + stripped
            elif not stripped:
                current = None
    return helps


def _unwrap_optional(tp):
    if typing.get_origin(tp) is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def _parse_bool(s: str) -> bool:
    if s.lower() in ("true", "1", "yes"):
        return True
    if s.lower() in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {s!r}")


def host_only(fn: Callable) -> Callable:
    """Mark an entry point that runs on the host alone: ``cli`` then takes it
    without a ``device`` parameter."""
    fn.host_only = True
    return fn


def cli(fn: Callable, args: Optional[list] = None):
    """Parse argv according to ``fn``'s signature and call it."""
    sig = inspect.signature(fn)
    host = getattr(fn, "host_only", False)
    if host == ("device" in sig.parameters):
        raise TypeError(f"{fn.__name__}: an entry point takes --device unless it is marked @host_only, "
                        "and a @host_only one takes no --device")
    try:
        hints = typing.get_type_hints(fn)
    except Exception:
        hints = {}
    helps = _docstring_arg_help(fn)
    doc = (inspect.getdoc(fn) or "").split("\n\n")[0]
    parser = argparse.ArgumentParser(description=doc, formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    for name, param in sig.parameters.items():
        tp = param.annotation if param.annotation is not inspect.Parameter.empty else str
        tp = _unwrap_optional(hints.get(name, tp))
        kwargs = dict(help=helps.get(name, ""))
        if tp is bool:
            kwargs["type"] = _parse_bool
        elif tp in (int, float, str, Path):
            kwargs["type"] = tp
        else:
            kwargs["type"] = str
        if param.default is not inspect.Parameter.empty:
            kwargs["default"] = param.default
        else:
            kwargs["required"] = True
        parser.add_argument(f"--{name}", **kwargs)
    ns = parser.parse_args(args)
    if int(os.environ.get("RANK", "0")) != 0:
        sys.stdout = open(os.devnull, "w")
    return fn(**vars(ns))
