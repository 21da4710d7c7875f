"""Parameter layouts for training across ranks (counterpart of
lit_llama_tpu/parallel/sharding.py).

The JAX package annotates its parameter tree with PartitionSpecs and lets
XLA's SPMD partitioner emit the collectives. Here a rank is one process
holding its shard of each leaf, and the training forward gathers what it
needs explicitly (``Layout.use_layer`` and its siblings), through the differentiable collectives of
``parallel.comm``.

``param_specs`` follows the JAX ``_leaf_spec`` rule for rule, in its order:
for each leaf the axis sharded over ``data`` (FSDP) and the one sharded over
``model`` (tensor parallelism), or None. Layers are stacked on a leading L
axis; weights are stored (in, out).

  wte              (V, D)       model over V, data over D
  lm_head          (D, V)       data over D, model over V; under FSDP
                                without TP data over V (a D shard would sum
                                whole logits in the forward and backward)
  c_attn, c_fc1/2  (L, D, N)    data over D, model over N (and so every leaf
                                under them: LoRA A (L, D, r) likewise)
  c_proj           (L, K, D)    model over K, data over D
  everything else  whole (norms; LoRA B (L, g, r, D) is 4-D, so the JAX rule
                                puts data on its layer axis and model on its
                                group axis; adapter leaves)

Under TP the weights take the Megatron layout of ``parallel.tp``: c_attn's
columns permuted so that a contiguous shard holds (q, k, v) of H/mp heads,
the MLP hidden dim zero-padded to a multiple of mp, c_fc1 / c_fc2 as the
training tree keeps them (unfused). The forward consumes the model axis of
wte, lm_head and the five block weights locally (a vocab-parallel lookup,
column- and row-split products); every other sharded axis is gathered before
use, inside the block's activation checkpoint so the backward gathers again
(ZeRO-3). A leaf sharded over both axes holds its data shard of its model
shard. An axis that its group does not divide is padded with zeros: a zero
parameter whose gradient is zero stays zero under AdamW and adds nothing to
the clip norm, so the padding is exact. Adapter v1's prompt and gates stay
whole on every rank, as JAX places them, and each rank's prefix attention
takes its own heads (``models.llama``); Adapter v2 is refused
(``refuse_adapter_v2``).

Nothing here calls ``torch.distributed.fsdp``: the parameters are trees of
tensors, not modules.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from lit_llama_tpu_torch.models.config import LLaMAConfig
from lit_llama_tpu_torch.parallel import comm, launch, tp
from lit_llama_tpu_torch.parallel.mesh import coordinate, make_mesh, mesh_shape
from lit_llama_tpu_torch.utils.checkpoint import tree_leaves, tree_unflatten
from lit_llama_tpu_torch.utils.math import find_multiple

Params = Dict[str, Any]


class Spec(NamedTuple):
    """The axis of a leaf sharded over ``data`` and the one over ``model``
    (non-negative, None where the leaf is whole along that mesh axis)."""

    data: Optional[int]
    model: Optional[int]


def _leaf_spec(path: Tuple[str, ...], ndim: int, fsdp: bool, tp: bool) -> Spec:
    """JAX ``_leaf_spec`` (``parallel/sharding.py:36-76``), its rules in its
    order, as axis indices."""
    name = path[-1]
    parent = path[-2] if len(path) >= 2 else ""
    s = 1 if ndim == 3 else 0  # the leading L axis of a stacked 3-D leaf

    def spec(data_at: int, model_at: int) -> Spec:
        return Spec(data_at if fsdp else None, model_at if tp else None)

    if name == "wte":
        return spec(1, 0)
    if parent == "lm_head":
        if name in ("qscale", "qzero"):
            return Spec(None, 1 if tp else None)
        if fsdp and not tp:
            return Spec(1, None)
        return spec(0, 1)
    if parent in ("c_attn", "c_fc1", "c_fc2"):
        if name in ("qscale", "qzero"):
            return Spec(None, s + 1 if tp else None)
        return spec(s, s + 1)
    if parent == "c_proj":
        if name in ("qscale", "qzero"):
            return Spec(None, None)
        return spec(s + 1, s)
    if name == "lora_a":
        return Spec(s if fsdp else None, None)
    return Spec(None, None)


def param_specs(params: Params, fsdp: bool = False, tp: bool = True) -> Params:
    """The tree of ``params`` with a ``Spec`` at each leaf (JAX
    ``param_pspecs``)."""
    flat = tree_leaves(params)
    return tree_unflatten({n: _leaf_spec(tuple(n.split("/")), t.ndim, fsdp, tp) for n, t in flat.items()})


# ---- the TP layout of the stacked training tree ------------------------------


def _local_weight(name: str) -> bool:
    """Whether the forward consumes the leaf's model axis locally (the
    vocab-parallel lookup, the column- and row-split products)."""
    path = name.split("/")
    return name == "wte" or (path[-1] == "w" and len(path) >= 2
                             and path[-2] in ("lm_head", "c_attn", "c_fc1", "c_fc2", "c_proj"))


def _rel(name: str) -> str:
    """A stacked leaf's path in a block (``h/attn/c_attn/w`` -> ``attn/c_attn/w``)."""
    return name.removeprefix("h/")


def _padded_to(t: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    extra = -t.shape[axis] % n
    if not extra:
        return t
    widths = [0, 0] * (t.ndim - 1 - axis) + [0, extra]
    return torch.nn.functional.pad(t, widths)


def shard_tensor(t: torch.Tensor, spec: Spec, dp: int, mp: int, d: int, m: int) -> torch.Tensor:
    """Coordinate (d, m)'s shard of ``t``: its model axis zero-padded to a
    multiple of mp and cut in mp, then its data axis likewise in dp."""
    if spec.model is not None and mp > 1:
        t = _padded_to(t, spec.model, mp).chunk(mp, spec.model)[m]
    if spec.data is not None and dp > 1:
        t = _padded_to(t, spec.data, dp).chunk(dp, spec.data)[d]
    return t.contiguous()


def refuse_adapter_v2(model_parallel: int) -> None:
    """Raise NotImplementedError for Adapter v2 training under a model axis,
    as the JAX package does: its placement (``param_pspecs``) gives the
    (L, 1, D) ``av2_bias`` / ``av2_scale`` leaves under attention's and the
    MLP's ``c_proj`` the linear's rule, the model axis on their axis of size
    1, and ``shard_params`` raises. Adapter v1 trains under TP: its leaves
    are whole on every rank."""
    if model_parallel > 1:
        raise NotImplementedError(
            f"adapter_v2 training under tensor parallelism (model_parallel={model_parallel}): the JAX package's "
            "placement puts the model axis on the size-1 axis of the av2_bias / av2_scale leaves under c_proj "
            "and refuses the tree; train Adapter v2 with --data_parallel only")


# ---- a rank's layout --------------------------------------------------------------


def train_mesh(data_parallel: int = -1, model_parallel: int = 1, device=None):
    """The ``(data, model)`` mesh of a training entry point, or None for a
    world of one with both flags at one (``data_parallel=-1``: every rank the
    model axis leaves). Raises NotImplementedError
    (``launch.require_ranks``) when the flags ask for another number of
    ranks than ``torchrun`` started."""
    world = launch.world_size()
    dp = data_parallel if data_parallel != -1 else max(world // model_parallel, 1)
    n = dp * model_parallel
    if n == 1 and world == 1:
        return None
    launch.require_ranks(n, "data_parallel * model_parallel")
    return make_mesh(data=dp, model=model_parallel, device=device)


class Layout:
    """This rank's place in a ``(data, model)`` training mesh and the layout
    of the tree it trains: the ``Spec`` and the TP-layout shape of every leaf
    of ``template`` (a single-process tree, stacked, with the leaves to
    train; only its shapes are read).

    ``fsdp`` shards the params (and so the Adam moments and the gradients)
    over the data axis; ``tp`` (taken when the model axis is > 1) over the
    model axis. A data group sees one slice of the global batch
    (``local_rows``); a model group sees the same rows."""

    def __init__(self, mesh, config: LLaMAConfig, template: Params, *, fsdp: bool):
        self.mesh, self.config, self.fsdp = mesh, config, fsdp
        self.dp, self.mp = mesh_shape(mesh)
        self.d, self.m = coordinate(mesh)
        self.tp = self.mp > 1
        self.data_group = mesh.get_group("data") if self.dp > 1 else None
        self.model_group = mesh.get_group("model") if self.mp > 1 else None
        if self.tp:
            if config.n_head % self.mp:
                raise ValueError(f"{config.n_head} heads do not shard over {self.mp} ranks")
            bad = [n for n in tree_leaves(template) if n.split("/")[-1] in ("qw", "qscale", "qzero")]
            if bad:
                raise ValueError(f"training takes dense weights; {bad[0]} is quantized")
            if config.adapter is not None and config.adapter.v2:
                refuse_adapter_v2(self.mp)
        self.specs: Dict[str, Spec] = {}
        self.shapes: Dict[str, Tuple[int, ...]] = {}
        for name, t in tree_leaves(template).items():
            self.specs[name] = _leaf_spec(tuple(name.split("/")), t.ndim, fsdp, self.tp)
            shape = list(t.shape)
            axis = tp.hidden_axis(_rel(name)) if self.tp else None
            if axis is not None:
                shape[axis] = find_multiple(config.intermediate_size, self.mp)
            self.shapes[name] = tuple(shape)

    # ---- placing and collecting trees ----------------------------------------

    def shard(self, tree: Params, device=None) -> Params:
        """This rank's shard of ``tree`` (the single-process layout; the
        params or any tree of leaves with their names, such as the Adam
        moments), as new tensors on ``device`` (default: where they lie)."""
        out = {}
        for name, t in tree_leaves(tree).items():
            src = tp.dense_to_tp(_rel(name), t, self.mp, self.config.intermediate_size) if self.tp else t
            local = shard_tensor(src, self.specs[name], self.dp, self.mp, self.d, self.m)
            moved = local.to(device) if device is not None else local
            if moved.untyped_storage().data_ptr() == t.untyped_storage().data_ptr():
                moved = moved.clone()
            out[name] = moved
        return tree_unflatten(out)

    def gather(self, tree: Params, keep: bool = True) -> Optional[Params]:
        """The single-process layout of a sharded tree, on the host: every
        rank joins the collectives; the ranks with ``keep`` get the tree
        (one leaf is whole on the others at a time)."""
        out = {}
        for name, local in tree_leaves(tree).items():
            spec, shape = self.specs[name], self.shapes[name]
            t = comm.host_copy(local.detach())  # the gathers' staging, without a copy back to the card
            if spec.data is not None and self.dp > 1:
                t = comm.all_gather_dim(t, spec.data, self.data_group).narrow(spec.data, 0, shape[spec.data])
            if spec.model is not None and self.mp > 1:
                t = comm.all_gather_dim(t, spec.model, self.model_group).narrow(spec.model, 0, shape[spec.model])
            if keep:
                t = t.cpu().contiguous()
                if t.untyped_storage().data_ptr() == local.untyped_storage().data_ptr():
                    t = t.clone()  # a whole leaf on the host: a copy, not the live parameter
                out[name] = tp.dense_from_tp(_rel(name), t, self.mp, self.config.intermediate_size) if self.tp else t
        return tree_unflatten(out) if keep else None

    # ---- the training forward's view of a sharded tree -------------------------

    def _use(self, name: str, t: torch.Tensor, spec: Spec, shape) -> torch.Tensor:
        if spec.data is not None and self.dp > 1:
            t = comm.gather_dim(t, spec.data, self.data_group).narrow(spec.data, 0, shape[spec.data])
        if spec.model is not None and self.mp > 1 and not _local_weight(name):
            t = comm.gather_dim(t, spec.model, self.model_group).narrow(spec.model, 0, shape[spec.model])
        if self.tp and name.endswith("/lora_b"):
            t = t.chunk(self.mp, -1)[self.m]  # this rank's head columns of each enabled group
        return t

    def use_root(self, name: str, node):
        """A root leaf (``wte``, ``ln_f``) or sub-tree (``lm_head``) as the
        forward uses it."""
        if isinstance(node, torch.Tensor):
            return self._use(name, node, self.specs[name], self.shapes[name])
        return tree_unflatten({rel: self._use(f"{name}/{rel}", t, self.specs[f"{name}/{rel}"],
                                              self.shapes[f"{name}/{rel}"])
                               for rel, t in tree_leaves(node).items()})

    def use_stacked(self, h: Params) -> Params:
        """The stacked layers with every leaf sharded along its layer axis
        (LoRA B under FSDP) gathered whole: a layer's view cannot hold it."""
        out = {}
        for rel, t in tree_leaves(h).items():
            name = f"h/{rel}"
            spec = self.specs[name]
            out[rel] = self._use(name, t, spec, self.shapes[name]) if 0 in spec else t
        return tree_unflatten(out)

    def use_layer(self, lp: Params) -> Params:
        """One layer's view of the stacked leaves, each as the forward uses
        it: its FSDP axis gathered, its model axis gathered unless the
        product consumes it locally."""
        out = {}
        for rel, t in tree_leaves(lp).items():
            name = f"h/{rel}"
            spec = self.specs[name]
            if 0 in spec:  # taken whole by use_stacked
                out[rel] = t
                continue
            layer_spec = Spec(*(None if a is None else a - 1 for a in spec))
            out[rel] = self._use(name, t, layer_spec, self.shapes[name][1:])
        return tree_unflatten(out)

    def embed(self, wte: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """The token embeddings, whole on every rank: under TP each rank
        looks up the rows of its vocab shard (zero elsewhere) and the group
        sums them."""
        wte = self.use_root("wte", wte)
        if not self.tp:
            return wte[tokens]
        rows = wte.shape[0]
        idx = tokens - self.m * rows
        mine = (idx >= 0) & (idx < rows)
        x = torch.where(mine[..., None], wte[idx.clamp(0, rows - 1)], torch.zeros((), dtype=wte.dtype,
                                                                                  device=wte.device))
        return comm.reduce_from_group(x, self.model_group)

    def logits(self, local: torch.Tensor) -> torch.Tensor:
        """The whole (B, T, V) logits from this rank's vocab columns."""
        if not self.tp:
            return local
        return comm.gather_last(local, self.model_group)[..., : self.shapes["lm_head/w"][-1]]

    # ---- the batch, the gradients and the norm --------------------------------------

    def local_rows(self, x, axis: int = 1):
        """This data rank's rows of a global batch along ``axis``."""
        B = x.shape[axis]
        if B % self.dp:
            raise ValueError(f"a global batch of {B} rows does not split over data_parallel={self.dp}")
        n = B // self.dp
        return x[(slice(None),) * axis + (slice(self.d * n, (self.d + 1) * n),)]

    def data_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the data group, in place."""
        return comm.all_reduce(t, self.data_group) if self.dp > 1 else t

    def sync_grads(self, grads: Dict[str, torch.Tensor]) -> None:
        """Sum, over the data group and in place, the gradients of the
        leaves that are whole on it (an FSDP leaf's gradient arrives
        reduce-scattered). A leaf whole on the model group needs no sum
        there: its gradient arrives whole, the norms' after the block's
        sum, Adapter v1's prompt and gates through Megatron's f
        (``models.llama``)."""
        if self.dp == 1:
            return
        for name in sorted(grads):
            if self.specs[name].data is None:
                comm.all_reduce(grads[name], self.data_group)

    def global_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global L2 norm of the gradients: each leaf's squares summed
        over its shards, a leaf held whole on several ranks counted once (by
        the ranks at index 0 of the axes it is whole on), in one all-reduce
        over the world."""
        total = None
        for name in sorted(grads):
            spec = self.specs[name]
            if (spec.data is None and self.d) or (spec.model is None and self.m):
                continue
            sq = grads[name].float().square().sum()
            total = sq if total is None else total + sq
        dev = next(iter(grads.values())).device
        total = torch.zeros((), device=dev) if total is None else total
        return torch.sqrt(comm.all_reduce(total, None))

    def any_rank(self, flag: bool, device) -> bool:
        """Whether ``flag`` is set on any rank (every rank calls it)."""
        t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
        return bool(comm.all_reduce(t, None, op=dist.ReduceOp.MAX)[0])

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that writes and prints."""
        return dist.get_rank() == 0

    def barrier(self) -> None:
        dist.barrier()


def shard_params(params: Params, mesh, config: LLaMAConfig, *, fsdp: bool, device=None) -> Tuple[Params, Layout]:
    """(this rank's shard of ``params``, the ``Layout``); ``Layout.gather``
    takes the shards back to the single-process layout."""
    layout = Layout(mesh, config, params, fsdp=fsdp)
    return layout.shard(params, device), layout
