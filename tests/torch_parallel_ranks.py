"""Rank processes for the port's multi-process CPU tests
(``test_torch_tp.py``, ``test_torch_parallel_serving.py``,
``test_torch_sharding.py``, ``test_torch_dist_training.py``; not a test
file).

``run(job, world, tmp_path, payload)`` spawns ``world`` ranks that join a
gloo group through a ``file://`` store under ``tmp_path`` (tests of several
files run at once), run ``JOBS[job](rank, world, payload)`` and save what it
returns; the parent gets every rank's result in rank order. A failing rank
fails the spawn with its traceback, and the group's timeout bounds a rank
that waits on a dead peer. This module imports no JAX: the tests compute the
JAX side in their own process and pass arrays across.
"""

from __future__ import annotations

import datetime
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT = datetime.timedelta(seconds=120)


def run(job: str, world: int, tmp_path: Path, payload):
    tmp_path.mkdir(parents=True, exist_ok=True)
    init = tmp_path / f"{job}_pg"
    init.unlink(missing_ok=True)
    mp.spawn(_entry, args=(world, str(init), job, payload, str(tmp_path)), nprocs=world, join=True)
    return [torch.load(tmp_path / f"{job}_rank{r}.pt", weights_only=False) for r in range(world)]


def _entry(rank: int, world: int, init: str, job: str, payload, out: str) -> None:
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world, timeout=TIMEOUT)
    try:
        result = JOBS[job](rank, world, payload)
    finally:
        dist.destroy_process_group()
    torch.save(result, Path(out) / f"{job}_rank{rank}.pt")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def tp_forwards(rank: int, world: int, payload):
    """For each case (port config, numpy params, prompt tokens, a decode
    token): the TP prefill's logits and one ``slot_pos`` decode step's; then
    ``generate_tp`` for each generation case. Every rank returns its own."""
    from lit_llama_tpu_torch.parallel import mesh as mesh_lib, tp
    from lit_llama_tpu_torch.utils.jax_params import params_from_numpy

    mesh = mesh_lib.make_mesh(data=1, model=world, device="cpu")
    out = {}
    for name, (cfg, params, toks, step) in payload["forwards"].items():
        sp = tp.shard_params_tp(params_from_numpy(params, device="cpu"), mesh, cfg)
        prefill, decode = tp.make_sharded_forwards(cfg, mesh)
        cache = tp.init_tp_cache(cfg, mesh, 1, payload["S"], device="cpu")
        with torch.no_grad():
            logits, cache = prefill(sp, torch.as_tensor(toks)[None], cache)
            step_logits, _ = decode(sp, torch.tensor([[step]]), torch.tensor([len(toks)], dtype=torch.int32),
                                    cache)
        out[name] = (_np(logits), _np(step_logits))
    for name, (cfg, params, prompt, n, temperature, seed) in payload.get("generate", {}).items():
        sp = tp.shard_params_tp(params_from_numpy(params, device="cpu"), mesh, cfg)
        gen = torch.Generator().manual_seed(seed)
        out[name] = tp.generate_tp(sp, prompt, n, config=cfg, mesh=mesh, temperature=temperature,
                                   top_k=payload.get("top_k"), generator=gen).tolist()
    return out


def engine_runs(rank: int, world: int, payload):
    """Each run of ``payload["runs"]``: requests through a ``DecodeEngine`` on
    a (data, model) mesh, rank 0 submitting and running them, the others
    following. Every rank returns, a run, the generated tokens of each
    request it saw finish (by id), its decode steps and prefills, and the
    ValueError of a ``bad_max_batch`` engine where the run asks for one."""
    from lit_llama_tpu_torch.parallel import mesh as mesh_lib
    from lit_llama_tpu_torch.serve import DecodeEngine
    from lit_llama_tpu_torch.utils.jax_params import params_from_numpy

    out = []
    for run in payload["runs"]:
        mesh = mesh_lib.make_mesh(*run["mesh"], device="cpu")
        model = payload["models"][run["model"]]
        params = params_from_numpy(model["params"], device="cpu")
        res = {}
        if run.get("bad_max_batch"):
            try:
                DecodeEngine(params, model["config"], max_batch=run["bad_max_batch"], mesh=mesh, device="cpu")
            except ValueError as e:
                res["bad_max_batch"] = str(e)
        eng = DecodeEngine(params, model["config"], mesh=mesh, device="cpu", **run["engine"])
        if eng.leader:
            ids = [eng.submit(p, n, temperature=run.get("temperature", 0.0)) for p, n in run["requests"]]
            done = eng.run()
            eng.stop()
            res["tokens"] = [done[i].generated for i in ids]
        else:
            kept = eng.follow()
            res["tokens"] = [kept[i].generated for i in sorted(kept)]
        res.update(decode_steps=eng.decode_steps, prefills=eng.prefills, local_slots=eng.local_b,
                   serve_fused=eng.serve_fused)
        out.append(res)
    return out


def _mask(kind, params):
    from lit_llama_tpu_torch.peft import adapter as adapter_mod, lora as lora_mod

    if kind is None:
        return None
    if kind == "lora":
        return lora_mod.trainable_mask(params)
    return adapter_mod.trainable_mask(params, v2=kind == "adapter_v2")


def _gathered_np(layout, tree, keep):
    from lit_llama_tpu_torch.utils.checkpoint import tree_leaves

    whole = layout.gather(tree, keep)
    return None if whole is None else {n: t.float().numpy() for n, t in tree_leaves(whole).items()}


def train_steps(rank: int, world: int, payload):
    """Each case of ``payload["cases"]`` whose mesh has ``world`` ranks: its
    params sharded (``Layout``), ``train_step`` on each of its global
    batches. Every rank returns, a case, the losses and its local params'
    and moments' bytes; rank 0 also the final params gathered whole
    (numpy, single-process layout). With ``payload["resume"]``, also
    ``resume_runs``'s results under "resume"."""
    torch.set_num_threads(1)  # tiny models: a thread a rank, so that the ranks of the CPU tests do not crowd
    from lit_llama_tpu_torch.parallel import mesh as mesh_lib, sharding
    from lit_llama_tpu_torch.training import step as step_lib
    from lit_llama_tpu_torch.utils.checkpoint import tree_leaves
    from lit_llama_tpu_torch.utils.jax_params import params_from_numpy

    out = {}
    for name, case in payload["cases"].items():
        dp, mp_ = case["mesh"]
        if dp * mp_ != world:
            continue
        mesh = mesh_lib.make_mesh(data=dp, model=mp_, device="cpu")
        params = params_from_numpy(case["params"], device="cpu")
        cfg = case["config"]
        local, layout = sharding.shard_params(params, mesh, cfg, fsdp=case["fsdp"])
        opt = step_lib.make_optimizer(step_lib.TrainConfig(**case["tc"]), _mask(case.get("mask"), local))
        state = step_lib.init_train_state(local, opt)
        losses = []
        for ids, tgt in zip(case["ids"], case["tgt"]):
            state, loss = step_lib.train_step(state, torch.as_tensor(ids).long(), torch.as_tensor(tgt).long(), cfg,
                                              opt, True, case.get("policy", "dots"), layout=layout)
            losses.append(float(loss))
        nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(state.params).values())
        nbytes += sum(t.numel() * t.element_size() for k in ("mu", "nu")
                      for t in tree_leaves(state.opt_state[k]).values())
        out[name] = {"losses": losses, "bytes": nbytes,
                     "params": _gathered_np(layout, state.params, rank == 0)}
    if "resume" in payload:
        out["resume"] = dict(resume_runs(rank, world, payload["resume"]), out=payload["resume"]["out"])
    return out


def _batches(ids, tgt, start: int = 0):
    for i in range(start, len(ids)):
        yield ids[i], tgt[i]


def resume_runs(rank: int, world: int, payload):
    """FSDP at (world, 1) through ``loop.train``: an unbroken run of every
    batch with a checkpoint halfway, then a run resumed from it on the same
    mesh; and, when asked, a run of every batch that stops at a signal one
    rank receives. Rank 0 returns the final params of each (gathered)."""
    torch.set_num_threads(1)  # tiny models: a thread a rank, so that the ranks of the CPU tests do not crowd
    import os
    import signal

    from lit_llama_tpu_torch.parallel import mesh as mesh_lib, sharding
    from lit_llama_tpu_torch.training import loop as loop_lib, step as step_lib
    from lit_llama_tpu_torch.utils.jax_params import params_from_numpy

    cfg, out_dir = payload["config"], Path(payload["out"])
    ids, tgt = payload["ids"], payload["tgt"]
    n = len(ids)
    mesh = mesh_lib.make_mesh(data=world, model=1, device="cpu")
    tc = step_lib.TrainConfig(**payload["tc"])
    res = {}

    def fresh():
        opt = step_lib.make_optimizer(tc)
        local, layout = sharding.shard_params(params_from_numpy(payload["params"], device="cpu"), mesh, cfg,
                                              fsdp=True)
        return opt, layout, step_lib.init_train_state(local, opt)

    opt, layout, state = fresh()
    lc = loop_lib.LoopConfig(out_dir=out_dir / "unbroken", max_iters=n, save_interval=n // 2, eval_interval=0)
    state = loop_lib.train(state, _batches(ids, tgt), cfg, opt, lc, layout=layout)
    res["unbroken"] = _gathered_np(layout, state.params, rank == 0)
    res["unbroken_step"] = state.step

    opt = step_lib.make_optimizer(tc)
    state = loop_lib.load_train_checkpoint(out_dir / "unbroken" / f"iter-{n // 2:06d}", opt, device="cpu",
                                           layout=layout)
    lc = loop_lib.LoopConfig(out_dir=out_dir / "resumed", max_iters=n, save_interval=0, eval_interval=0)
    state = loop_lib.train(state, _batches(ids, tgt, n // 2), cfg, opt, lc, layout=layout)
    res["resumed"] = _gathered_np(layout, state.params, rank == 0)

    if payload.get("stop_at") is not None:
        opt, layout, state = fresh()

        def signalled():
            for i, batch in enumerate(_batches(ids, tgt)):
                if rank == payload["stop_rank"] and i == payload["stop_at"]:
                    os.kill(os.getpid(), signal.SIGTERM)
                yield batch

        lc = loop_lib.LoopConfig(out_dir=out_dir / "stopped", max_iters=n, save_interval=0, eval_interval=0)
        state = loop_lib.train(state, signalled(), cfg, opt, lc, layout=layout)
        res["stopped_step"] = state.step
    return res


def collectives(rank: int, world: int, payload):
    """The differentiable collectives of ``parallel.comm`` on this rank's
    slice of ``payload``'s inputs, over the world group: each one's output
    and input gradient under the upstream gradient ``payload["up"]``, a
    reduce-scatter, and the calls ``comm.stats`` counted by kind."""
    from lit_llama_tpu_torch.parallel import comm

    comm.reset_stats()
    x = torch.as_tensor(payload["x"][rank]).requires_grad_()  # (R, C): this rank's input
    out = {}
    for name, fn in (("copy_to_group", lambda t: comm.copy_to_group(t, None)),
                     ("reduce_from_group", lambda t: comm.reduce_from_group(t, None)),
                     ("gather_last", lambda t: comm.gather_last(t, None)),
                     ("gather_dim0", lambda t: comm.gather_dim(t, 0, None))):
        y = fn(x)
        (g,) = torch.autograd.grad(y, x, torch.as_tensor(payload["up"][name][rank]))
        out[name] = (y.detach().numpy(), g.numpy())
    out["reduce_scatter"] = comm.reduce_scatter(torch.as_tensor(payload["x"][rank]), None).numpy()
    out["stats"] = {k: dict(v) for k, v in comm.stats["kinds"].items()}
    return out


def sharding_checks(rank: int, world: int, payload):
    """``parallel.sharding`` and ``parallel.comm`` on ``world`` ranks: each
    (data, model, fsdp) of ``payload["meshes"]`` with ``world`` ranks, the
    tree sharded (every rank's local leaves) and gathered back (rank 0's);
    an adapter tree refused under TP; the differentiable collectives of
    ``comm`` (``collectives``); one train step's census
    (``tools.comm_anatomy``) on each mesh of ``payload["census"]``."""
    torch.set_num_threads(1)  # tiny models: a thread a rank, so that the ranks of the CPU tests do not crowd
    from lit_llama_tpu_torch.parallel import mesh as mesh_lib, sharding
    from lit_llama_tpu_torch.tools import comm_anatomy
    from lit_llama_tpu_torch.training import step as step_lib
    from lit_llama_tpu_torch.utils.checkpoint import tree_leaves
    from lit_llama_tpu_torch.utils.jax_params import params_from_numpy

    out = {"trips": {}, "census": {}}
    params = params_from_numpy(payload["params"], device="cpu")
    for dp, mp_, fsdp in payload["meshes"]:
        if dp * mp_ != world:
            continue
        mesh = mesh_lib.make_mesh(data=dp, model=mp_, device="cpu")
        local, layout = sharding.shard_params(params, mesh, payload["config"], fsdp=fsdp)
        whole = layout.gather(local, rank == 0)
        kept = {n: t.numpy().copy() for n, t in tree_leaves(local).items()}
        for t in tree_leaves(local).values():
            t.add_(1)  # a step after the gather: the gathered tree must not move with it
        out["trips"][(dp, mp_, fsdp)] = {
            "local": kept,
            "whole": None if whole is None else {n: t.numpy() for n, t in tree_leaves(whole).items()}}
        if mp_ > 1 and "adapter_config" in payload:
            try:
                sharding.Layout(mesh, payload["adapter_config"], params_from_numpy(payload["adapter_params"], device="cpu"),
                                fsdp=fsdp)
            except NotImplementedError as e:
                out["adapter_refused"] = str(e)
    if world in payload.get("collectives", {}):
        out["collectives"] = collectives(rank, world, payload["collectives"][world])
    for dp, mp_, fsdp in payload.get("census", ()):
        if dp * mp_ != world:
            continue
        mesh = mesh_lib.make_mesh(data=dp, model=mp_, device="cpu")
        local, layout = sharding.shard_params(params, mesh, payload["config"], fsdp=fsdp)
        opt = step_lib.make_optimizer(step_lib.TrainConfig(warmup_iters=0, max_iters=4))
        box = [step_lib.init_train_state(local, opt)]
        ids = torch.as_tensor(payload["ids"]).long()

        def run():
            box[0], _ = step_lib.train_step(box[0], ids[..., :-1], ids[..., 1:], payload["config"], opt,
                                            layout=layout)

        out["census"][(dp, mp_, fsdp)] = comm_anatomy.census(run)
    return out


JOBS = {"tp_forwards": tp_forwards, "engine_runs": engine_runs, "train_steps": train_steps,
        "resume_runs": resume_runs, "sharding_checks": sharding_checks}
