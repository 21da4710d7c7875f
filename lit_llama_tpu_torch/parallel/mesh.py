"""The ``("data", "model")`` device mesh (counterpart of
lit_llama_tpu/parallel/mesh.py).

  data  - serving slots (each data group holds the whole weights and its own
          B / data slots)
  model - tensor parallelism over heads, MLP hidden and vocab

A rank is one process with one device, so the mesh lays out ranks: rank r
sits at (r // model, r % model), the model axis innermost, so that a model
group's ranks are neighbours (on one host, NVLink peers). The world group is
built first (``launch``), so that building the mesh never starts a backend
of its own: ``init_device_mesh("cuda", ...)`` would start NCCL, which refuses
ranks that share a card. On a gloo world the mesh's device type is "cpu":
its groups are gloo groups, whose collectives ``comm`` stages through host
buffers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from lit_llama_tpu_torch.parallel import launch

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _mesh(data: int, model: int) -> DeviceMesh:
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(data * model).reshape(data, model),
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def make_mesh(data: int = -1, model: int = 1, device=None) -> DeviceMesh:
    """A {data, model} mesh over the world's ranks (``torchrun``'s, or a world
    of one). ``data=-1`` takes every rank the model axis leaves. ``device`` is
    the entry point's ``--device``."""
    if not launch.maybe_initialize_distributed(device) and not dist.is_initialized():
        launch.init_single_process(device)
    n = dist.get_world_size()
    if data == -1:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return _mesh(data, model)


def single_device_mesh(device=None) -> DeviceMesh:
    """A 1 x 1 mesh: this process alone (a world of one is started if there
    is none)."""
    if not dist.is_initialized():
        launch.init_single_process(device)
    return DeviceMesh("cpu" if dist.get_backend() != "nccl" else "cuda", torch.zeros((1, 1), dtype=torch.long),
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def mesh_shape(mesh: Optional[DeviceMesh]) -> Tuple[int, int]:
    """(data, model) sizes; (1, 1) without a mesh."""
    if mesh is None:
        return 1, 1
    return mesh.size(0), mesh.size(1)


def model_group(mesh: Optional[DeviceMesh]):
    """This rank's model group, None where the model axis is 1."""
    if mesh is None or mesh.size(1) == 1:
        return None
    return mesh.get_group(MODEL_AXIS)


def coordinate(mesh: Optional[DeviceMesh]) -> Tuple[int, int]:
    """This rank's (data index, model index)."""
    if mesh is None:
        return 0, 0
    return mesh.get_local_rank(DATA_AXIS), mesh.get_local_rank(MODEL_AXIS)
