"""Training step: loss, optimizer, gradient accumulation, clipping
(counterpart of lit_llama_tpu/training/step.py).

Cosine LR with warmup, gradient accumulation over A microbatches, global-norm
clip 1.0 and AdamW (b1 0.9, b2 0.95, eps 1e-8, weight decay 0.1), with the
arithmetic of the JAX package's optax chain, written out as plain functions
on tensors (no optax, no ``torch.optim``):

  clip_by_global_norm -> scale_by_adam (or scale_by_adam_lowp for bf16
  moments) -> add_decayed_weights (leaves with ndim >= 2 of the STACKED tree:
  rms_1/rms_2 (L, D) decay, ln_f (D,) does not) -> scale_by_learning_rate
  (-lr(count), count from 0, so the first step moves nothing while
  warmup_iters > 0) -> apply_updates (cast back to the param dtype).

The JAX step is functional. Here ``train_step`` updates the params and the
Adam moments IN PLACE, leaf by leaf, so no second copy of them is made (at the
7B width a copy is gigabytes); it returns a new ``TrainState`` holding the same
tensors. Activation checkpointing is ``llama.forward(remat=True)``.

Across ranks (``layout``, a ``parallel.sharding.Layout``) a step computes what
the single-process step computes on the GLOBAL batch, as the JAX step does
under its GSPMD mesh: every rank is given the whole (A, B, T) batch and keeps
its data rank's B / dp rows; each microbatch's loss is the global token mean
(the count of valid labels summed over the data group before the division,
so ranks that hold different numbers of ignored labels weigh them as one
batch would); the gradients of leaves whole on the data group are summed
over it (an FSDP leaf's arrive reduce-scattered by the forward's gathers);
the clip norm sums every shard's squares once; AdamW runs on the local
shards and their local moments.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from lit_llama_tpu_torch.models import llama
from lit_llama_tpu_torch.models.config import LLaMAConfig
from lit_llama_tpu_torch.parallel import comm
from lit_llama_tpu_torch.utils.checkpoint import tree_leaves, tree_unflatten
from lit_llama_tpu_torch.utils.device import torch_dtype

Params = Dict[str, Any]

IGNORE_INDEX = -1  # label value excluded from the loss


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer and schedule hyperparameters (the JAX package's defaults)."""

    learning_rate: float = 6e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    warmup_iters: int = 2000
    max_iters: int = 600000
    min_lr: float = 6e-5
    decay_lr: bool = True
    # storage dtype of the Adam moments (None = float32); the EMA itself runs
    # in float32 and only the stored moments are rounded
    adam_state_dtype: Optional[str] = None


class TrainState(NamedTuple):
    params: Params
    opt_state: Any
    step: int


def cosine_lr(tc: TrainConfig) -> Callable[[int], float]:
    """Linear warmup, then cosine decay to ``min_lr`` at ``max_iters``."""

    def schedule(step) -> float:
        step = float(step)
        warm = tc.learning_rate * step / max(tc.warmup_iters, 1)
        if step < tc.warmup_iters:
            return warm
        if not tc.decay_lr:
            return tc.learning_rate
        ratio = (step - tc.warmup_iters) / max(tc.max_iters - tc.warmup_iters, 1)
        ratio = min(max(ratio, 0.0), 1.0)
        coeff = 0.5 * (1.0 + math.cos(math.pi * ratio))
        return tc.min_lr + coeff * (tc.learning_rate - tc.min_lr)

    return schedule


class AdamW:
    """The optax chain of ``make_optimizer`` on a parameter tree, as two plain
    functions: ``init(params)`` and ``apply(params, grads, state)``.

    State: {"count": int64 tensor (updates done), "mu": tree, "nu": tree},
    the moments only for trainable leaves, in ``state_dtype``.
    """

    def __init__(self, tc: TrainConfig, trainable_mask: Optional[Params] = None):
        self.tc = tc
        self.lr = cosine_lr(tc)
        self.state_dtype = torch_dtype(tc.adam_state_dtype) if tc.adam_state_dtype else torch.float32
        self.trainable = None if trainable_mask is None else tree_leaves(trainable_mask)

    def trainable_names(self, params: Params):
        names = list(tree_leaves(params))
        if self.trainable is None:
            return names
        return [n for n in names if self.trainable[n]]

    def init(self, params: Params) -> Dict[str, Any]:
        leaves = tree_leaves(params)
        names = self.trainable_names(params)

        def zeros():
            return tree_unflatten({n: torch.zeros_like(leaves[n], dtype=self.state_dtype) for n in names})

        dev = next(iter(leaves.values())).device
        return {"count": torch.zeros((), dtype=torch.int64, device=dev), "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def apply(self, params: Params, grads: Dict[str, torch.Tensor], state: Dict[str, Any],
              g_norm: Optional[torch.Tensor] = None) -> None:
        """One update, in place: ``grads`` maps each trainable leaf's name to
        its f32 gradient, which is consumed (clipped in place); frozen leaves
        get no update (optax's set_to_zero). Each step below is one in-place
        pass over a leaf where the arithmetic allows, so the update streams
        each f32 value a few times instead of once per operator. ``g_norm``
        is the gradients' global norm where they are shards of a larger tree
        (``Layout.global_norm``); by default it is taken over ``grads``."""
        tc = self.tc
        leaves = tree_leaves(params)
        mu, nu = tree_leaves(state["mu"]), tree_leaves(state["nu"])
        names = list(mu)
        if set(grads) != set(names):
            raise ValueError(f"grads for {sorted(grads)}, trainable leaves {sorted(names)}")
        # clip_by_global_norm: g / ||g|| * max_norm when ||g|| >= max_norm
        if g_norm is None:
            g_norm = torch.sqrt(sum(grads[n].float().square().sum() for n in names))
        clip = float(g_norm) >= tc.grad_clip
        count = int(state["count"]) + 1  # scale_by_adam's count after the increment
        f32 = np.float32  # the bias corrections in f32, as optax takes them
        bc1 = float(f32(1) - f32(tc.beta1) ** f32(count))
        bc2 = float(f32(1) - f32(tc.beta2) ** f32(count))
        step_size = -self.lr(count - 1)  # scale_by_schedule reads the count before its increment
        for n in names:
            g = grads[n].float()
            if clip:
                g.div_(g_norm).mul_(tc.grad_clip)
            m = mu[n].float()  # the stored moment itself when it is f32, else an f32 copy
            v = nu[n].float()
            m.mul_(tc.beta1).add_(g, alpha=1 - tc.beta1)
            v.mul_(tc.beta2).addcmul_(g, g, value=1 - tc.beta2)
            if m is not mu[n]:  # moments stored in bf16: rounded when stored
                mu[n].copy_(m)
                nu[n].copy_(v)
            u = (m / bc1).div_((v / bc2).sqrt_().add_(1e-8))
            del g, m, v
            p = leaves[n]
            if p.ndim >= 2:  # add_decayed_weights, masked to ndim >= 2
                u.add_(p, alpha=tc.weight_decay)
            p.add_(u, alpha=step_size)  # scale_by_learning_rate and apply_updates, cast to p's dtype
        state["count"].add_(1)


def make_optimizer(tc: TrainConfig, trainable_mask: Optional[Params] = None) -> AdamW:
    """AdamW with global-norm clip; ``trainable_mask`` (a tree of bools like
    params) freezes the leaves that are False: no moments, no update, and the
    clip's norm over the trainable leaves only (optax.masked)."""
    return AdamW(tc, trainable_mask)


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor, ignore_index: int = IGNORE_INDEX,
                       group=None):
    """Token-mean cross entropy in f32 skipping ``ignore_index`` labels; 0.0
    (not NaN) when every label is ignored. With ``group`` (a data group whose
    ranks hold the other rows of one batch) the count of valid labels is
    summed over the group first: the result is this rank's share of the
    batch's mean, and the shares add up to it over the group."""
    valid = targets != ignore_index
    safe = torch.where(valid, targets, torch.zeros_like(targets)).long()
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, safe[..., None])[..., 0]
    nll = torch.where(valid, logz - ll, torch.zeros_like(logz))
    count = valid.sum()
    if group is not None:
        count = comm.all_reduce(count.double(), group)
    return nll.sum() / count.clamp(min=1).float()


def shift_labels(input_ids: torch.Tensor, targets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next-token alignment: logits[..., :-1] against targets[..., 1:]."""
    return input_ids[..., :-1], targets[..., 1:]


def loss_fn(params: Params, input_ids, targets, config: LLaMAConfig, remat: bool = True,
            remat_policy: str = "dots", plain: bool = False, layout=None) -> torch.Tensor:
    """The batch's token-mean loss; with ``layout``, this data rank's share
    of it (``input_ids`` and ``targets`` its rows)."""
    logits, _ = llama.forward(params, input_ids, config, remat=remat, remat_policy=remat_policy, plain=plain,
                              layout=layout)
    return cross_entropy_loss(logits, targets, group=None if layout is None else layout.data_group)


def flops_per_token(config: LLaMAConfig) -> Tuple[int, int]:
    """(model FLOPs of one trained token, N): 6 N + 6 L T D, with N the
    non-embedding plus lm_head parameters and T the block size; the remat
    recompute is not counted. MFU = this * tokens / step time / peak."""
    L, T, D = config.n_layer, config.block_size, config.n_embd
    n = L * (4 * D * D + 3 * D * config.intermediate_size) + D * config.padded_vocab_size
    return 6 * n + 6 * L * T * D, n


def init_train_state(params: Params, optimizer: AdamW) -> TrainState:
    return TrainState(params, optimizer.init(params), 0)


def train_step(state: TrainState, input_ids: torch.Tensor, targets: torch.Tensor, config: LLaMAConfig,
               optimizer: AdamW, remat: bool = True, remat_policy: str = "dots",
               plain: bool = False, layout=None) -> Tuple[TrainState, torch.Tensor]:
    """One optimizer step over ``A`` microbatches: ``input_ids`` and
    ``targets`` (A, B, T). The microbatch gradients are summed in f32 and
    divided by A; the loss returned is the mean of the A losses. Updates the
    params and the optimizer state in place. With ``layout`` the params and
    the state are this rank's shards, the batch is the global one (every
    rank passes the same), and every rank returns the global loss."""
    if layout is not None:
        input_ids, targets = layout.local_rows(input_ids), layout.local_rows(targets)
    leaves = tree_leaves(state.params)
    names = optimizer.trainable_names(state.params)
    for n, t in leaves.items():
        t.requires_grad_(n in names)
    A = input_ids.shape[0]
    loss_sum = torch.zeros((), dtype=torch.float32, device=input_ids.device)
    acc: Dict[str, torch.Tensor] = {}
    try:
        for a in range(A):
            loss = loss_fn(state.params, input_ids[a], targets[a], config, remat, remat_policy, plain, layout)
            grads = torch.autograd.grad(loss, [leaves[n] for n in names])
            loss_sum += loss.detach()
            for n, g in zip(names, grads):
                if n in acc:
                    acc[n].add_(g)
                else:
                    acc[n] = g.float()
            del loss, grads
    finally:
        for t in leaves.values():
            t.requires_grad_(False)
    if layout is not None:
        layout.sync_grads(acc)
        loss_sum = layout.data_sum(loss_sum)
    for g in acc.values():
        g.div_(A)
    if layout is None:
        optimizer.apply(state.params, acc, state.opt_state)
    else:
        optimizer.apply(state.params, acc, state.opt_state, g_norm=layout.global_norm(acc))
    return TrainState(state.params, state.opt_state, state.step + 1), loss_sum / A
