"""The collectives of one step of the port across ranks (counterpart of the
JAX package's scripts/comm_anatomy.py).

    torchrun --nproc_per_node 2 -m lit_llama_tpu_torch.tools.comm_anatomy --mode train --data_parallel 2 \
        [--fsdp true] [--n_layer 2] [--device cpu]
    torchrun --nproc_per_node 2 -m lit_llama_tpu_torch.tools.comm_anatomy --mode train --model_parallel 2
    torchrun --nproc_per_node 2 -m lit_llama_tpu_torch.tools.comm_anatomy --mode decode --model_parallel 2

The JAX tool compiles the step and reads the collectives out of the HLO. Here
the collectives are the calls of ``parallel.comm``, which counts each one's
kind, calls, payload bytes and host time (``comm.stats``): ``census`` runs a
step once with the counts reset and returns them beside the step's wall
time. ``--mode train`` is one ``training.step.train_step`` (random tokens,
after a first step that is not counted) under DP, FSDP (``--fsdp``) or TP;
``--mode decode`` one teacher-forced ``slot_pos`` decode step of the TP
forward after a prefill. Rank 0 prints one JSON line: the mesh, the model,
a row a kind and the collectives' share of the step's wall.

On gloo (ranks sharing a card, or the CPU) a collective on CUDA tensors
returns once its result is back on the card, so its time includes the wait
for the card's queued work: the share is an upper bound there. Random
weights from a seed; nothing is read from disk.
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, Optional

import torch


def census(run: Callable[[], Any], sync: Optional[Callable[[], None]] = None) -> Dict[str, Any]:
    """``run()`` once with ``comm.stats`` reset (``sync`` before and after:
    the card's queue): {"rows": [{"kind", "calls", "bytes", "seconds"}],
    "calls", "bytes", "collective_s", "wall_s", "share"}."""
    from lit_llama_tpu_torch.parallel import comm

    if sync is not None:
        sync()
    comm.reset_stats()
    t0 = time.perf_counter()
    run()
    if sync is not None:
        sync()
    wall = time.perf_counter() - t0
    rows = [{"kind": k, **v} for k, v in sorted(comm.stats["kinds"].items())]
    return {"rows": rows, "calls": comm.stats["calls"], "bytes": comm.stats["bytes"],
            "collective_s": comm.stats["seconds"], "wall_s": wall, "share": comm.stats["seconds"] / max(wall, 1e-9)}


def main(
    mode: str = "train",
    data_parallel: int = -1,
    model_parallel: int = 1,
    fsdp: bool = True,
    model_size: str = "7B",
    n_layer: int = 2,
    n_embd: int = None,
    n_head: int = None,
    block_size: int = 2048,
    vocab_size: int = None,
    micro_batch_size: int = 1,
    accum: int = 1,
    prompt: int = 128,
    device: str = None,
) -> None:
    """Count the collectives of one training or TP decode step.

    Args:
        mode: "train" (one train_step) or "decode" (one TP decode step after a prefill).
        data_parallel: Data-parallel size (-1: every rank the model axis leaves).
        model_parallel: Tensor-parallel size.
        fsdp: Train mode: shard the params and moments over the data axis (ZeRO-3); false: DP.
        model_size: Config preset (7B/13B/30B/65B); the width of the model.
        n_layer: Layers (the depth cut of the preset).
        n_embd: Override width.
        n_head: Override head count.
        block_size: Train mode: the sequence length T.
        vocab_size: Override vocab size.
        micro_batch_size: Train mode: a data rank's rows of a microbatch.
        accum: Train mode: microbatches a step.
        prompt: Decode mode: the prefill's tokens.
        device: cuda (the default: the card) or cpu.
    """
    import torch.distributed as dist

    from lit_llama_tpu_torch import LLaMAConfig
    from lit_llama_tpu_torch.models import llama
    from lit_llama_tpu_torch.parallel import launch, sharding, tp
    from lit_llama_tpu_torch.parallel.mesh import make_mesh, mesh_shape
    from lit_llama_tpu_torch.training import step as step_lib
    from lit_llama_tpu_torch.utils.device import resolve_device

    overrides = {k: v for k, v in (("n_layer", n_layer), ("n_embd", n_embd), ("n_head", n_head),
                                   ("vocab_size", vocab_size)) if v}
    mesh = make_mesh(data=data_parallel, model=model_parallel, device=device)
    dev = launch.current_device() or resolve_device(device)
    dp, mp = mesh_shape(mesh)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    gen = torch.Generator(device=dev).manual_seed(0)
    if mode == "train":
        config = LLaMAConfig.from_name(model_size, block_size=block_size, param_dtype="float32",
                                       compute_dtype="bfloat16", **overrides)
        params, layout = sharding.shard_params(llama.init_params(config, gen, device=dev), mesh, config,
                                               fsdp=fsdp)
        opt = step_lib.make_optimizer(step_lib.TrainConfig(warmup_iters=0, max_iters=10))
        state = step_lib.init_train_state(params, opt)
        toks = torch.randint(0, config.vocab_size, (accum, micro_batch_size * dp, block_size + 1), generator=gen,
                             device=dev)
        box = [state]

        def run():
            box[0], loss = step_lib.train_step(box[0], toks[..., :-1], toks[..., 1:], config, opt, layout=layout)
            float(loss)

        run()  # the first step allocates; not counted
        got = census(run, sync)
        what = dict(fsdp=fsdp, micro_batch_size=micro_batch_size, accum=accum, T=block_size)
    elif mode == "decode":
        config = LLaMAConfig.from_name(model_size, param_dtype="bfloat16", compute_dtype="bfloat16", **overrides)
        params = tp.shard_params_tp(llama.init_params(config, gen, device=dev), mesh, config)
        prefill, decode = tp.make_sharded_forwards(config, mesh)
        toks = torch.randint(0, config.vocab_size, (1, prompt + 1), generator=gen, device=dev)
        with torch.no_grad():
            cache = tp.init_tp_cache(config, mesh, 1, prompt + 8, device=dev)
            prefill(params, toks[:, :prompt], cache)
            pos = torch.tensor([prompt], dtype=torch.int32, device=dev)
            got = census(lambda: decode(params, toks[:, prompt:], pos, cache), sync)
        what = dict(prompt=prompt)
    else:
        raise ValueError(f"unknown mode {mode!r} (train|decode)")
    if launch.is_main_process():
        print(json.dumps({"mode": mode, "mesh": [dp, mp], "backend": dist.get_backend(), "device": str(dev),
                          "n_layer": config.n_layer, "n_embd": config.n_embd, **what, **got}))


if __name__ == "__main__":
    from lit_llama_tpu_torch.utils.cli import cli

    cli(main)
