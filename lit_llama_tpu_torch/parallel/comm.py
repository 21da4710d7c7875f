"""The collectives of the multi-process paths (no JAX counterpart: inside
``shard_map`` and under GSPMD the JAX package's ``psum``, ``all_gather`` and
reduce-scatters are implicit).

* ``all_reduce``: the sum of a tensor over a group (a TP block's two
  projections, a data group's gradients);
* ``all_gather_last``: tensors concatenated along their last axis in rank
  order (the vocab-sharded logits);
* ``all_gather_stack``: tensors stacked on a new leading axis in rank order
  (a data group's tokens to every rank);
* ``reduce_scatter``: the sum over a group, each rank keeping its chunk of
  the leading axis (an FSDP leaf's gradient);
* ``broadcast`` and ``broadcast_object``: a tensor or a picklable object
  from one rank (a step's plan, a prefill's first token).

Training differentiates through four ``torch.autograd.Function``s over them
(the Megatron pair and the two gathers):

* ``copy_to_group``: identity forward, all-reduce backward (the input of a
  column-split product: each rank's input gradient is a partial sum);
* ``reduce_from_group``: all-reduce forward, identity backward (after a
  row-split product);
* ``gather_last``: all-gather along the last axis forward, this rank's
  columns of the gradient backward (the vocab-sharded logits, whose
  gradient every rank of the group computes whole);
* ``gather_dim``: all-gather along one axis forward, reduce-scatter backward
  (an FSDP leaf gathered for use: each rank's gradient of the whole leaf is
  its rows' part, summed into each owner's shard).

Ranks that share one card run gloo (NCCL refuses them). Gloo takes CUDA
tensors for ``all_reduce`` and ``broadcast`` only (through pageable host
memory of its own, which a card's host may copy at a tenth of the pinned
rate), and for neither ``all_gather`` nor ``reduce_scatter``. So on a gloo
group every collective of a CUDA tensor is staged here through a pinned host
buffer (PyTorch's caching host allocator): one rule, ``_staged``, taken from
the group's backend and the tensor's device, never from a failed call.
``host_copy`` gives a caller that wants the result on the host (a gathered
checkpoint) the same staging without the copy back. ``group=None`` is the
world group.

``stats`` counts the calls, their payload bytes (an all-reduce's or a
broadcast's tensor, an all-gather's gathered output, a reduce-scatter's
input) and their host time, in all and by kind. On a gloo group a
collective on CUDA tensors returns once its result is back on the card, so
that time is its whole time, a wait for the card's queued work included; on
NCCL it is the time to enqueue.
"""

from __future__ import annotations

import time
from typing import Any, Optional

import torch
import torch.distributed as dist

stats = {"calls": 0, "seconds": 0.0, "bytes": 0, "kinds": {}}


def reset_stats() -> None:
    stats.update(calls=0, seconds=0.0, bytes=0, kinds={})


def _staged(t: torch.Tensor, group) -> bool:
    """Whether a collective of ``t`` goes through a pinned host buffer: a
    CUDA tensor on a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` in a pinned host buffer (contiguous), the copy finished."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host


def host_copy(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` where ``group``'s collectives take it without staging: a pinned
    host copy of a CUDA tensor on a gloo group, else ``t`` itself."""
    return to_host(t) if _staged(t, group) else t


def _in_place(x: torch.Tensor, group, collective) -> torch.Tensor:
    """``collective(buffer)`` run in place on ``x``, staged (``_staged``)
    through a pinned host copy whose result is copied back."""
    if not _staged(x, group):
        collective(x)
        return x
    host = to_host(x)
    collective(host)
    x.copy_(host, non_blocking=True)
    return x


def _gather_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    # all_gather_single is all_gather_into_tensor's successor (the older name
    # warns that it is deprecated where both exist)
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, x, group=group)


def _scatter_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    scatter(out, x, group=group)


class _Timed:
    def __init__(self, kind: str, nbytes: int):
        self.kind, self.nbytes = kind, nbytes

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        stats["calls"] += 1
        stats["seconds"] += dt
        stats["bytes"] += self.nbytes
        k = stats["kinds"].setdefault(self.kind, {"calls": 0, "bytes": 0, "seconds": 0.0})
        k["calls"] += 1
        k["bytes"] += self.nbytes
        k["seconds"] += dt


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduce(x: torch.Tensor, group=None, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The elementwise sum (or ``op``) of ``x`` over ``group``, in place."""
    with _Timed("all_reduce", _nbytes(x)):
        return _in_place(x, group, lambda t: dist.all_reduce(t, op=op, group=group))


def all_gather_stack(x: torch.Tensor, group=None) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` in rank order."""
    n = dist.get_world_size(group)
    with _Timed("all_gather", n * _nbytes(x)):
        src = x.contiguous()
        shape = (n * src.shape[0],) + tuple(src.shape[1:])  # concatenated along dim 0
        if _staged(x, group):
            src = to_host(src)
            out = torch.empty(shape, dtype=src.dtype, pin_memory=True)
        else:
            out = src.new_empty(shape)
        _gather_into(out, src, group)
        return out.view((n,) + tuple(x.shape)).to(x.device, non_blocking=True)


def all_gather_last(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along the last axis in rank order."""
    parts = all_gather_stack(x, group)  # (n, ..., d)
    n = parts.shape[0]
    return parts.movedim(0, -2).reshape(*x.shape[:-1], n * x.shape[-1])


def all_gather_dim(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    parts = all_gather_stack(x.movedim(dim, 0), group)  # (n, x.shape[dim], ...)
    whole = parts.reshape((-1,) + tuple(parts.shape[2:]))
    return whole.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's chunk, along the leading axis, of the sum of ``x`` over
    ``group`` (the leading axis a multiple of the group's size)."""
    n = dist.get_world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter: {x.shape[0]} rows do not split over {n} ranks")
    with _Timed("reduce_scatter", _nbytes(x)):
        src = x.contiguous()
        shape = (src.shape[0] // n,) + tuple(src.shape[1:])
        if _staged(x, group):
            src = to_host(src)
            out = torch.empty(shape, dtype=src.dtype, pin_memory=True)
        else:
            out = src.new_empty(shape)
        _scatter_into(out, src, group)
        return out.to(x.device, non_blocking=True)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """``reduce_scatter`` along ``dim``."""
    return reduce_scatter(x.movedim(dim, 0), group).movedim(0, dim)


def broadcast(x: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Global rank ``src``'s ``x`` on every rank of ``group``, in place
    (every rank passes a tensor of the same shape and dtype)."""
    with _Timed("broadcast", _nbytes(x)):
        return _in_place(x, group, lambda t: dist.broadcast(t, src=src, group=group))


def broadcast_object(obj: Any, src: int = 0, group=None, device: Optional[torch.device] = None) -> Any:
    """Global rank ``src``'s ``obj`` (picklable) on every rank of ``group``.
    On an NCCL group the pickled bytes travel through ``device``."""
    box = [obj]
    with _Timed("broadcast_object", 0):
        dist.broadcast_object_list(box, src=src, group=group,
                                   device=device if dist.get_backend(group) == "nccl" else None)
    return box[0]


# ---- the differentiable collectives of training --------------------------------


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        # a copy: the input may be a product that activation checkpointing keeps
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        return all_gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g.narrow(-1, r * ctx.width, ctx.width).contiguous(), None


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.group), None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is; in the backward its gradient is summed over ``group``."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (a new tensor); the gradient passes
    back unchanged."""
    return _ReduceFromGroup.apply(x, group)


def gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """``all_gather_last``; the backward keeps this rank's columns of the
    gradient (every rank of the group holds the same whole gradient)."""
    return _GatherLast.apply(x, group)


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``all_gather_dim``; the backward reduce-scatters the gradient along
    ``dim``, so that each rank receives the sum of its rows' gradients."""
    return _GatherDim.apply(x, dim, group)
