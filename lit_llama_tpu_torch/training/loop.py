"""Generic training loop: batching, validation, checkpointing, throughput logs
(counterpart of lit_llama_tpu/training/loop.py).

* true resume: params, optimizer state and the step counter are checkpointed
  (the manifest format of ``utils.checkpoint``; each package resumes only its
  own optimizer state); with ``LoopConfig.save_filter`` (PEFT finetuning) a
  checkpoint holds only the filtered params and the step;
* SIGTERM/SIGINT save a resumable ``preempt-NNNNNN`` checkpoint at the next
  step boundary and stop;
* ``metrics.jsonl`` gets the JAX loop's records: {"iter", "loss",
  "tokens_per_sec", "dt_ms"} every ``log_interval`` steps and {"iter",
  "val_loss"} after each validation;
* ``profile_at_iter`` writes a ``torch.profiler`` trace of that step to
  ``out_dir/profile/``.

Across ranks (``layout``): rank 0 alone writes ``metrics.jsonl`` and prints;
``tokens_per_sec`` counts the global batch; validation is the global token
mean; a checkpoint is gathered into the single-process layout (the TP
column permutation undone, padding cut) and rank 0 writes it, so it loads
as a single-process one does, and ``load_train_checkpoint(..., layout=)``
shards a checkpoint of any mesh onto another. The stop flag is agreed by an
all-reduce every step: a signal reaches the ranks at different moments, and
a rank that checkpointed while another waited in the step's collectives
would hang them both.
"""

from __future__ import annotations

import json
import signal
import sys
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from lit_llama_tpu_torch.models.config import LLaMAConfig
from lit_llama_tpu_torch.training import step as step_lib
from lit_llama_tpu_torch.utils import checkpoint as ckpt
from lit_llama_tpu_torch.utils.device import resolve_device


@dataclass
class LoopConfig:
    out_dir: Path
    max_iters: int
    log_interval: int = 1
    eval_interval: int = 1000
    eval_iters: int = 100
    save_interval: int = 1000
    profile_at_iter: int = -1  # write a torch.profiler trace of this iteration
    save_filter: Optional[Callable[[Any], Any]] = None  # params -> the sub-tree a checkpoint keeps


_CONFIG_KEYS = ("block_size", "vocab_size", "padded_vocab_size", "n_layer", "n_head", "n_embd",
                "param_dtype", "compute_dtype", "quantize", "quant_groupsize")


def save_train_checkpoint(out_dir: Path, name: str, state: step_lib.TrainState, config: LLaMAConfig,
                          save_filter: Optional[Callable[[Any], Any]] = None, layout=None) -> Path:
    """Params + optimizer state + step counter under ``out_dir/name``; with
    ``save_filter``, ``save_filter(params)`` and the step, no optimizer state
    (a PEFT checkpoint, as the JAX package writes it). With ``layout`` every
    rank calls it: the shards are gathered into the single-process layout
    and rank 0 writes them."""
    path = Path(out_dir) / name
    step = np.asarray(state.step, np.int32)
    params, opt_state = state.params, state.opt_state
    if save_filter is not None:
        params, opt_state = save_filter(params), None
    if layout is not None:
        keep = layout.is_main
        params = layout.gather(params, keep)
        if opt_state is not None:
            moments = {k: layout.gather(opt_state[k], keep) for k in ("mu", "nu")}
            opt_state = {"count": opt_state["count"].cpu(), **moments}
        if not keep:
            layout.barrier()
            return path
    tree = {"params": params, "step": step}
    if opt_state is not None:
        tree["opt_state"] = opt_state
    ckpt.save_checkpoint(path, tree, metadata={"config": config_meta(config)})
    if layout is not None:
        layout.barrier()
    return path


def config_meta(config: LLaMAConfig) -> Dict[str, Any]:
    """The config keys a checkpoint's metadata records (the JAX package's
    ``_config_meta``), which both packages' loaders read."""
    return {k: getattr(config, k) for k in _CONFIG_KEYS}


def load_train_checkpoint(path, optimizer: step_lib.AdamW, device=None, layout=None) -> step_lib.TrainState:
    """The state ``save_train_checkpoint`` wrote, on ``device`` (the card when
    None). The optimizer state is read when the checkpoint has one, in the
    optimizer's own layout and dtype; else it starts afresh. With
    ``layout`` (a ``parallel.sharding.Layout`` of the checkpoint's tree) the
    params and the moments are this rank's shards of them, whatever mesh
    wrote the checkpoint."""
    dev = resolve_device(device)
    tree = ckpt.load_checkpoint(path, transform=lambda n, t: t if layout is not None else t.to(dev))
    params = tree["params"] if layout is None else layout.shard(tree["params"], dev)
    step = int(tree["step"])
    opt_state = optimizer.init(params)
    if "opt_state" in tree:
        want = step_lib.tree_leaves(opt_state)
        got = step_lib.tree_leaves(tree["opt_state"])
        if set(want) != set(got):
            raise ValueError(f"{path}: optimizer state {sorted(got)} does not fit {sorted(want)}")
        if layout is not None:
            got = {**step_lib.tree_leaves(layout.shard(tree["opt_state"]["mu"], dev), "mu/"),
                   **step_lib.tree_leaves(layout.shard(tree["opt_state"]["nu"], dev), "nu/"),
                   "count": got["count"]}
        for n, t in want.items():
            t.copy_(got[n].reshape(t.shape))
    return step_lib.TrainState(params, opt_state, step)


def train(
    state: step_lib.TrainState,
    batches: Iterator,  # yields (input_ids, targets) of shape (A, B, T)
    config: LLaMAConfig,
    optimizer: step_lib.AdamW,
    loop: LoopConfig,
    *,
    validate_fn: Optional[Callable[[step_lib.TrainState], float]] = None,
    log_fn: Optional[Callable[[Dict], None]] = None,
    remat: bool = True,
    remat_policy: str = "dots",
    layout=None,
) -> step_lib.TrainState:
    """Run ``train_step`` from ``state.step`` to ``loop.max_iters`` (or until
    ``batches`` ends or a signal asks to stop). Batches are numpy arrays or
    tensors; they go to the params' device. With ``layout`` every rank runs
    it on the same global batches and its own shards of the state."""
    out_dir = Path(loop.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    metrics_path = out_dir / "metrics.jsonl"
    dev = next(iter(step_lib.tree_leaves(state.params).values())).device
    main = layout is None or layout.is_main

    if log_fn is None:
        def log_fn(rec):
            if main:
                _default_log(rec)
                with open(metrics_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")

    stop_requested = {"flag": False}

    def _on_signal(signum, frame):
        stop_requested["flag"] = True
        print(f"[train] signal {signum}: checkpointing and stopping", file=sys.stderr)

    prev_handlers = {}
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            prev_handlers[sig] = signal.signal(sig, _on_signal)

    def as_tensor(a):
        return torch.as_tensor(a).to(dev, torch.long)

    start_iter = int(state.step)
    t_last = time.perf_counter()
    it_last = start_iter - 1
    try:
        for it in range(start_iter, loop.max_iters):
            stop = stop_requested["flag"] if layout is None else layout.any_rank(stop_requested["flag"], dev)
            if stop:
                save_train_checkpoint(out_dir, f"preempt-{it:06d}", state, config, loop.save_filter, layout)
                break
            try:
                ids, tgt = next(batches)
            except StopIteration:
                break
            prof = None
            if it == loop.profile_at_iter and main:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
                prof = profile(activities=acts)
                prof.__enter__()
            state, loss = step_lib.train_step(state, as_tensor(ids), as_tensor(tgt), config, optimizer, remat,
                                              remat_policy, layout=layout)
            if prof is not None:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                prof.__exit__(None, None, None)
                (out_dir / "profile").mkdir(exist_ok=True)
                prof.export_chrome_trace(str(out_dir / "profile" / f"trace-{it:06d}.json"))
            if it % loop.log_interval == 0:
                loss_f = float(loss)
                now = time.perf_counter()
                dt = now - t_last
                t_last = now
                n_iters = it - it_last  # dt spans every iteration since the last log
                it_last = it
                tokens = int(np.prod(tuple(ids.shape))) * max(n_iters, 1)
                log_fn({
                    "iter": it,
                    "loss": round(loss_f, 4),
                    "tokens_per_sec": round(tokens / max(dt, 1e-9), 1),
                    "dt_ms": round(dt * 1e3 / max(n_iters, 1), 1),
                })
            if validate_fn is not None and loop.eval_interval and (it + 1) % loop.eval_interval == 0:
                log_fn({"iter": it, "val_loss": round(float(validate_fn(state)), 4)})
            if loop.save_interval and (it + 1) % loop.save_interval == 0:
                save_train_checkpoint(out_dir, f"iter-{it + 1:06d}", state, config, loop.save_filter, layout)
    finally:
        for sig, h in prev_handlers.items():
            signal.signal(sig, h)
    return state


def _default_log(rec: Dict) -> None:
    print(json.dumps(rec), file=sys.stderr)


def validate_on(batches_fn: Callable[[], Iterator], config: LLaMAConfig,
                eval_iters: int, layout=None) -> Callable[[step_lib.TrainState], float]:
    """Mean loss over ``eval_iters`` batches from a fresh ``batches_fn()``;
    with ``layout`` each batch's global token mean, the rows split over the
    data ranks (every rank calls it and gets the same value)."""

    @torch.no_grad()
    def run(state: step_lib.TrainState) -> float:
        dev = next(iter(step_lib.tree_leaves(state.params).values())).device
        losses = []
        it = batches_fn()
        for _ in range(eval_iters):
            try:
                ids, tgt = next(it)
            except StopIteration:
                break
            ids, tgt = torch.as_tensor(ids).to(dev, torch.long), torch.as_tensor(tgt).to(dev, torch.long)
            if ids.ndim == 3:  # (A, B, T): the accumulation axis joins the batch
                ids, tgt = ids.reshape(-1, ids.shape[-1]), tgt.reshape(-1, tgt.shape[-1])
            if layout is not None:
                ids, tgt = layout.local_rows(ids, 0), layout.local_rows(tgt, 0)
                loss = step_lib.loss_fn(state.params, ids, tgt, config, remat=False, layout=layout)
                losses.append(float(layout.data_sum(loss)))
            else:
                losses.append(float(step_lib.loss_fn(state.params, ids, tgt, config, remat=False)))
        return float(np.mean(losses)) if losses else float("nan")

    return run
