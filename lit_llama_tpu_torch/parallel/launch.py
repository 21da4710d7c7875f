"""Joining the ranks into one world (counterpart of
lit_llama_tpu/parallel/launch.py).

The port runs one process a rank, as ``torchrun`` starts them: it reads
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` (and ``LOCAL_WORLD_SIZE``) and the
rendezvous address ``MASTER_ADDR`` / ``MASTER_PORT``. Without ``RANK`` and
``WORLD_SIZE`` the process is a world of its own and nothing is started, as
the JAX function does without ``JAX_COORDINATOR``.

The rank's device comes from its local rank: ``cuda:LOCAL_RANK`` when every
local rank has a card of its own, the one card when the local ranks share
it, the CPU when the caller asks for it. The backend follows from that
layout, once, at init: NCCL when every rank has a card of its own, gloo when
ranks share a card or run on the CPU (NCCL refuses two ranks on one card).

One deliberate difference from the JAX function: a failed init raises. The
JAX one prints and carries on alone, and a rank that carried on alone here
would serve its shard of the weights as if it were the whole model.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import torch
import torch.distributed as dist

from lit_llama_tpu_torch.utils.device import resolve_device

_initialized = False
_device: Optional[torch.device] = None  # the rank's device, once initialized here


def rank_device(device=None, local_rank: int = 0, local_world: int = 1) -> torch.device:
    """The device of local rank ``local_rank`` out of ``local_world`` on this
    host: the CPU when asked for, else ``cuda:local_rank`` when each local
    rank has a card of its own, or ``cuda:0`` when the host has one card for
    all of them. Raises when a card is asked for and none is present, or when
    the cards cannot be shared out evenly."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    n = torch.cuda.device_count()
    if n >= local_world:
        return torch.device("cuda", local_rank)
    if n == 1:
        return torch.device("cuda", 0)
    raise ValueError(f"{local_world} local ranks on {n} cards: give each rank a card of its own, or run all of "
                     "them on one card")


def pick_backend(device: torch.device, local_world: int) -> str:
    """NCCL when every local rank has a card of its own, else gloo (ranks on
    one card, or on the CPU)."""
    if device.type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def current_device() -> Optional[torch.device]:
    """The device ``maybe_initialize_distributed`` chose for this rank (None
    before it ran, or in a world of one)."""
    return _device


def maybe_initialize_distributed(device=None) -> bool:
    """Join the world ``torchrun`` describes in the environment. Returns True
    if this call initialized the process group, False when there is nothing
    to join or it was joined before. ``device`` is the entry point's
    ``--device`` (None: the card). Raises KeyError when ``RANK`` comes
    without ``WORLD_SIZE`` (or the reverse), and RuntimeError when the
    process group cannot be initialized."""
    global _initialized, _device
    if _initialized or dist.is_initialized():
        return False
    if "RANK" not in os.environ and "WORLD_SIZE" not in os.environ:
        return False
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev = rank_device(device, local_rank, local_world)
    backend = pick_backend(dev, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    try:
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    except Exception as e:
        raise RuntimeError(f"[launch] rank {rank}/{world}: the {backend} process group did not initialize "
                           f"({type(e).__name__}: {e}); a rank does not carry on alone") from e
    _initialized, _device = True, dev
    print(f"[launch] rank {rank}/{world}, local rank {local_rank}/{local_world}, device {dev}, backend {backend}",
          file=sys.stderr, flush=True)
    return True


def init_single_process(device=None) -> None:
    """A world of one rank (no environment to read): a gloo group on an
    in-memory store, so that a one-rank mesh can be built. A no-op when a
    group exists."""
    global _initialized, _device
    if not dist.is_initialized():
        dev = resolve_device(device)
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
        _initialized, _device = True, dev


def world_size() -> int:
    """The number of ranks ``torchrun`` started (1 without it)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def require_ranks(n: int, flag: str) -> None:
    """Raise unless this process is one of a world of ``n`` ranks (``flag``
    names the option that asked for them): the multi-device paths run one
    process a rank, under ``torchrun --nproc_per_node n``."""
    world = world_size()
    if world != n:
        raise NotImplementedError(
            f"{flag}={n} needs a world of {n} ranks, and this process is one of {world}: without torchrun the port "
            f"runs on one device, and multi-device runs one process a rank (torchrun --nproc_per_node {n} -m ...)")


def is_main_process() -> bool:
    """Rank 0, or a process outside any world: the one that prints."""
    if dist.is_initialized():
        return dist.get_rank() == 0
    return int(os.environ.get("RANK", "0")) == 0
