"""Where one training step's time goes on the card.

    python -m lit_llama_tpu_torch.tools.profile_train [--n_layer 8] [--micro_batch_size 2] [--accum 2]
        [--block_size 2048] [--remat_policy dots] [--adam_state_dtype bfloat16]
        [--finetune lora|adapter|adapter_v2|full]

Builds the 7B-width model with the depth cut to ``--n_layer`` (f32 weights,
bf16 compute, random init from a seed) and random tokens, and runs
``training.step.train_step`` (remat on). ``--finetune MODE`` profiles a
finetuning step instead: the base weights in bf16 (f32 for ``full``) with the
mode's trainable leaves and mask (``training.finetune.prepare``), the
sequence ``--block_size`` long (the finetuning runs' 256, say) in a model of
the preset's context. Prints the host wall time of a step
(ending in a synchronise), tokens/s and MFU; the device time of the step's
phases for one microbatch (forward, backward) and of the optimizer update, by
CUDA events; then, from ``torch.profiler`` over one step, the device time per
kernel name and per group (cuBLAS GEMMs, K4, K10, everything else: the
optimizer's and the activations' elementwise passes), the device's busy share
of the step, and the host's own time per operator. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import re
import time

import torch

# kernel name -> group, first match wins
GROUPS = (
    ("K4 flash forward", r"fa90::fwd_kernel|fa256::fwd_kernel|fawide::fwd_kernel|ffma_fwd_kernel|"
                         r"simt_fwd_wide_kernel"),
    ("K10 dq (+ D pre-pass)", r"flash_bwd_dot_kernel|simt_dot_kernel|wide_dot_kernel|fa90::dq_kernel|fa256::dq_kernel|"
                              r"k10tf32::dq_kernel|flash_bwd_dq_wide_kernel|simt_dq_wide_kernel"),
    ("K10 dkv", r"fa90::dkv_kernel|fa256::dkv_kernel|k10tf32::dkv_kernel|flash_bwd_dkv_wide_kernel|"
                r"simt_dkv_wide_kernel"),
    ("GEMM (cuBLAS)", r"gemm|nvjet|cutlass|xmma|sm90_|sm80_|cublas"),
)


def group_of(name: str) -> str:
    for group, pattern in GROUPS:
        if re.search(pattern, name, re.IGNORECASE):
            return group
    return "other (elementwise, reductions, copies)"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n_layer", type=int, default=8)
    ap.add_argument("--micro_batch_size", type=int, default=2)
    ap.add_argument("--accum", type=int, default=2)
    ap.add_argument("--block_size", type=int, default=2048)
    ap.add_argument("--remat_policy", choices=("dots", "full"), default="dots")
    ap.add_argument("--adam_state_dtype", choices=("", "bfloat16"), default="")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--finetune", choices=("", "lora", "adapter", "adapter_v2", "full"), default="")
    args = ap.parse_args()

    from lit_llama_tpu_torch import LLaMAConfig
    from lit_llama_tpu_torch.models import llama
    from lit_llama_tpu_torch.training import finetune
    from lit_llama_tpu_torch.training import step as step_lib
    from lit_llama_tpu_torch.utils.device import device_peaks, resolve_device

    dev = resolve_device(None)
    A, B, T = args.accum, args.micro_batch_size, args.block_size
    tc = step_lib.TrainConfig(warmup_iters=1, max_iters=1000, adam_state_dtype=args.adam_state_dtype or None)
    if args.finetune:
        cfg = LLaMAConfig.from_name("7B", n_layer=args.n_layer, param_dtype="bfloat16", compute_dtype="bfloat16")
        params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        params, cfg, mask, _ = finetune.prepare(args.finetune, params, cfg)
        opt = step_lib.make_optimizer(tc, trainable_mask=mask)
        what = f"{args.finetune} finetuning step ({finetune.count_trainable(params, mask)} trainable parameters)"
    else:
        cfg = LLaMAConfig.from_name("7B", n_layer=args.n_layer, block_size=T, param_dtype="float32",
                                    compute_dtype="bfloat16")
        params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        opt = step_lib.make_optimizer(tc)
        what = "train step"
    L = cfg.n_layer
    state = step_lib.init_train_state(params, opt)
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (A, B, T + 1), generator=gen, device=dev)
    ids, tgt = toks[..., :-1], toks[..., 1:]

    def step():
        nonlocal state
        state, loss = step_lib.train_step(state, ids, tgt, cfg, opt, True, args.remat_policy)
        return loss

    step()  # warm-up: kernel builds, cuBLAS heuristics, the allocator's pool
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        step()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) / args.steps * 1e6
    peak = torch.cuda.max_memory_allocated()
    tokens = A * B * T
    flops_tok, n_mfu = step_lib.flops_per_token(cfg.replace(block_size=T))
    kind = torch.cuda.get_device_name(0)
    tc_peak = device_peaks(kind)[1]
    print(kind)
    print(f"{what}, 7B width, {L} layers, T={T}, micro-batch {B} x {A}, remat {args.remat_policy}, "
          f"Adam moments {args.adam_state_dtype or 'float32'}: wall {wall_us:.1f} us/step, "
          f"{tokens / wall_us * 1e6:.0f} tokens/s, MFU "
          f"{100 * flops_tok * tokens / (wall_us * 1e-6) / tc_peak:.1f} % of {tc_peak / 1e12:.0f} TF/s "
          f"((6 N + 6 L T D) * tokens, N = {n_mfu / 1e9:.3f} B), peak memory {peak / 2**30:.2f} GiB")

    # phases by CUDA events: one microbatch's forward and backward, one update
    leaves = step_lib.tree_leaves(state.params)
    names = opt.trainable_names(state.params)
    for n in names:
        leaves[n].requires_grad_(True)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    loss = step_lib.loss_fn(state.params, ids[0], tgt[0], cfg, True, args.remat_policy)
    ev[1].record()
    grads = torch.autograd.grad(loss, [leaves[n] for n in names])
    ev[2].record()
    for n in names:
        leaves[n].requires_grad_(False)
    opt.apply(state.params, {n: g.float() for n, g in zip(names, grads)}, state.opt_state)
    ev[3].record()
    torch.cuda.synchronize()
    del grads, loss
    fwd, bwd, upd = (ev[i].elapsed_time(ev[i + 1]) * 1e3 for i in range(3))
    print(f"phases (device clock, CUDA events): forward of one microbatch {fwd:.1f} us, its backward (with the "
          f"remat recompute) {bwd:.1f} us, the optimizer update {upd:.1f} us; a step is {A} x (forward + "
          f"backward) + the update + {A} gradient sums")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    rows, host_rows, groups = [], [], {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:  # kernels, not the ops above them
            rows.append((dev_us, evt.count, evt.key))
            g = groups.setdefault(group_of(evt.key), [0.0, 0])
            g[0] += dev_us
            g[1] += evt.count
        if evt.self_cpu_time_total > 0:
            host_rows.append((evt.self_cpu_time_total, evt.count, evt.key))
    rows.sort(reverse=True)
    host_rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    print(f"one profiled step: device busy {busy_us:.1f} us ({100 * busy_us / wall_us:.1f} % of the unprofiled "
          f"wall time), {sum(r[1] for r in rows)} kernel launches")
    for name, (us, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {us:10.1f} us  {100 * us / busy_us:5.1f} %  {count:6d} launches  {name}")
    print("device time per kernel name:")
    for us, count, name in rows[:25]:
        print(f"  {us:10.1f} us  {count:6d} launches  {name[:110]}")
    print(f"host, self time per operator under the profiler ({sum(r[0] for r in host_rows):.1f} us in all):")
    for us, count, name in host_rows[:12]:
        print(f"  {us:10.1f} us  {count:6d} calls  {name[:100]}")


if __name__ == "__main__":
    main()
