"""The collectives of the multi-process paths (no JAX counterpart: inside
``shard_map`` the JAX package's ``psum`` and ``all_gather`` are implicit).

* ``all_reduce``: the sum of a tensor over a group (a TP block's two
  projections);
* ``all_gather_last``: tensors concatenated along their last axis in rank
  order (the vocab-sharded logits);
* ``all_gather_stack``: tensors stacked on a new leading axis in rank order
  (a data group's tokens to every rank);
* ``broadcast`` and ``broadcast_object``: a tensor or a picklable object
  from one rank (a step's plan, a prefill's first token).

Ranks that share one card run gloo (NCCL refuses them). Gloo takes CUDA
tensors for ``all_reduce`` and ``broadcast`` (it copies them through pinned
host memory itself) but not for ``all_gather``: on a gloo group that one is
staged here through a host buffer. The choice comes from the group's backend
and the collective, never from a failed call. ``group=None`` is the world
group.

``stats`` counts the calls and their host time. On a gloo group a collective
on CUDA tensors returns once its result is back on the card, so that time
is its whole time, a wait for the card's queued work included; on NCCL it
is the time to enqueue.
"""

from __future__ import annotations

import time
from typing import Any, Optional

import torch
import torch.distributed as dist

stats = {"calls": 0, "seconds": 0.0}


def reset_stats() -> None:
    stats.update(calls=0, seconds=0.0)


def _staged(t: torch.Tensor, group) -> bool:
    """Whether a gather of ``t`` goes through a host buffer (gloo gathers
    host memory only)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _gather_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    # all_gather_single is all_gather_into_tensor's successor (the older name
    # warns that it is deprecated where both exist)
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, x, group=group)


class _Timed:
    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        stats["calls"] += 1
        stats["seconds"] += time.perf_counter() - self.t0


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise sum of ``x`` over ``group``, in place."""
    with _Timed():
        dist.all_reduce(x, group=group)
    return x


def all_gather_stack(x: torch.Tensor, group=None) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` in rank order."""
    n = dist.get_world_size(group)
    with _Timed():
        src = x.contiguous()
        if _staged(x, group):
            src = src.cpu()
        out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))  # concatenated along dim 0
        _gather_into(out, src, group)
        return out.view((n,) + tuple(x.shape)).to(x.device)


def all_gather_last(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along the last axis in rank order."""
    parts = all_gather_stack(x, group)  # (n, ..., d)
    n = parts.shape[0]
    return parts.movedim(0, -2).reshape(*x.shape[:-1], n * x.shape[-1])


def broadcast(x: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Global rank ``src``'s ``x`` on every rank of ``group``, in place
    (every rank passes a tensor of the same shape and dtype)."""
    with _Timed():
        dist.broadcast(x, src=src, group=group)
    return x


def broadcast_object(obj: Any, src: int = 0, group=None, device: Optional[torch.device] = None) -> Any:
    """Global rank ``src``'s ``obj`` (picklable) on every rank of ``group``.
    On an NCCL group the pickled bytes travel through ``device``."""
    box = [obj]
    with _Timed():
        dist.broadcast_object_list(box, src=src, group=group,
                                   device=device if dist.get_backend(group) == "nccl" else None)
    return box[0]
