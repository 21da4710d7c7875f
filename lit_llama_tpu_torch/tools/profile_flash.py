"""Device time of causal flash attention, K4 (forward) and K10 (dq and dK/dV),
in bf16 at head size 128, beside PyTorch's scaled_dot_product_attention and
the least time the card could take.

    python lit_llama_tpu_torch/tools/profile_flash.py [--root DIR] [--tag NAME]

Run as a file: ``--root DIR`` imports ``lit_llama_tpu_torch`` from DIR (its
kernels build beside it), so another checkout, such as the parent commit
unpacked under ``build/``, is timed on the same card in the same call; the
repo root is the default. Inputs are seeded normal bf16. Shapes: K4 at
(1, 32, T) for T = 128, 200 (prefills of the 7B model) and 2048, and at
(2, 32, 2048) (the training micro-batch); K10 at (1, 32, 2048) and
(2, 32, 2048). Each time is the median device time of 20 launches (CUDA
events, the L2 flushed before each, a spin on the card ahead of the start
event so the host's time in the wrapper is not counted). The library
yardstick is SDPA with ``is_causal=True``: its forward, and the backward of
one forward (dq, dk and dv together). Prints one JSON line. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

BYTES_PER_S, BF16_OPS_PER_S = 3.35e12, 989e12  # H100 SXM: HBM3, dense bf16 tensor cores
H, HS = 32, 128  # the 7B preset's heads and head size
K4_SHAPES = ((1, 128), (1, 200), (1, 2048), (2, 2048))
K10_SHAPES = ((1, 2048), (2, 2048))


def bound_us(nbytes: float, ops: float) -> float:
    return max(nbytes / BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e6


def k4_bound_us(B: int, T: int) -> float:
    """q, k, v read and o written once, lse written; S and P V over the causal pairs."""
    rows = B * H * T
    return bound_us(4 * rows * HS * 2 + rows * 4, 2 * 2 * HS * B * H * T * (T + 1) // 2)


def k10_bound_us(B: int, T: int):
    """(dq, dK/dV): dq reads q, k, v, o, dO, lse and writes D and dq (S, dP and
    dS K); dK/dV reads q, k, v, dO, lse, D and writes dk, dv (S, dP, dV, dK)."""
    rows, pairs = B * H * T, B * H * T * (T + 1) // 2
    return (bound_us(5 * rows * HS * 2 + rows * 4 + rows * HS * 2 + rows * 4, 3 * 2 * HS * pairs),
            bound_us(4 * rows * HS * 2 + 2 * rows * 4 + 2 * rows * HS * 2, 4 * 2 * HS * pairs))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="the directory to import lit_llama_tpu_torch from")
    ap.add_argument("--tag", default="", help="a name for this run in the output")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("profile_flash: no CUDA device", file=sys.stderr)
        return 1
    from lit_llama_tpu_torch.ops import _build
    from lit_llama_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    _build.build(["flash_attention"])
    g = torch.Generator().manual_seed(args.seed)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2

    def time_us(fn, iters=20):
        fn()
        times = []
        for _ in range(iters):
            flush.zero_()
            torch.cuda._sleep(1_000_000)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b) * 1e3)
        return sorted(times)[len(times) // 2]

    def inputs(B, T, n):
        return [torch.randn(B, H, T, HS, generator=g).to(dev, torch.bfloat16) for _ in range(n)]

    k4 = {}
    for B, T in K4_SHAPES:
        q, k, v = inputs(B, T, 3)
        k4[f"B={B} T={T}"] = dict(us=time_us(lambda: fa.flash_attention(q, k, v)),
                                  sdpa_us=time_us(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)),
                                  bound_us=k4_bound_us(B, T))
    k10 = {}
    for B, T in K10_SHAPES:
        q, k, v, do = inputs(B, T, 4)
        o, lse = fa.flash_attention(q, k, v)
        dq, dd = fa.flash_backward_dq(q, k, v, o, lse, do)
        qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        b_dq, b_dkv = k10_bound_us(B, T)
        r = dict(dq_us=time_us(lambda: fa.flash_backward_dq(q, k, v, o, lse, do)),
                 dkv_us=time_us(lambda: fa.flash_backward_dkv(q, k, v, do, lse, dd)),
                 sdpa_backward_us=time_us(lambda: torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True)),
                 dq_bound_us=b_dq, dkv_bound_us=b_dkv)
        r["dq_plus_dkv_us"] = r["dq_us"] + r["dkv_us"]
        k10[f"B={B} T={T}"] = r
        del qs, ks, vs, out
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"tag": args.tag, "root": args.root, "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "k4": k4, "k10": k10}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
