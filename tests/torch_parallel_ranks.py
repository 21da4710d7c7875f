"""Rank processes for the port's multi-process CPU tests
(``test_torch_tp.py``, ``test_torch_parallel_serving.py``; not a test file).

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


JOBS = {"tp_forwards": tp_forwards, "engine_runs": engine_runs}
