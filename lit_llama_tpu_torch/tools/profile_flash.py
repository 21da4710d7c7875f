"""Device time of causal flash attention, K4 (forward) and K10 (dq and dK/dV),
beside PyTorch's scaled_dot_product_attention and the least time the card
could take.

    python lit_llama_tpu_torch/tools/profile_flash.py [--root DIR] [--tag NAME]

Run as a file: ``--root DIR`` imports ``lit_llama_tpu_torch`` from DIR (its
kernels build beside it), so another checkout, such as the parent commit
unpacked under ``build/``, is timed on the same card in the same call; the
repo root is the default. Inputs are seeded normal. Shapes, bf16 at head
size 128: K4 at (1, 32, T) for T = 128, 200 (prefills of the 7B model) and
2048, and at (2, 32, 2048) (the training micro-batch); K10 at (1, 32, 2048)
and (2, 32, 2048). K4 beyond it (``k4_other``): bf16 at (1, 16, 2048, 256)
(csrc/flash_sm90_hs256.cuh), (1, 8, 1024, 384) and (1, 8, 1024, 512)
(csrc/flash_sm90_wide.cuh), f32 at (1, 32, 2048, 128), (1, 16, 2048, 256),
(1, 8, 1024, 384) and (1, 8, 1024, 512) (the FFMA bodies, bound at the CUDA
cores' FFMA rate). K10 beyond it (``k10_other``): bf16 at (1, 16, 2048,
256), (1, 8, 1024, 384) and (1, 8, 1024, 512) (csrc/flash_sm90_wide.cuh),
f32 at (1, 32, 2048, 128), (1, 16, 2048, 256) (csrc/flash_tf32.cuh),
(1, 8, 1024, 384) and (1, 8, 1024, 512) (the chunked FFMA kernels); in f32
two bounds, the
FFMA rate of the CUDA cores (67 TF/s) and 3xTF32 on the tensor cores (a
third of TF32's 494.5 TF/s, half the bf16 rate). Each time is the median
device time of 20 launches (CUDA events, the L2 flushed before each, a spin
on the card ahead of the start event so the host's time in the wrapper is
not counted). Each output's
bits are hashed (``sha``), so two checkouts' bits compare across runs (K10
takes o and lse from the plain forward, the same in every checkout). The
library yardstick is SDPA with ``is_causal=True``: its forward, and the
backward of one forward (dq, dk and dv together). In f32, K10 and its plain
version are each held against the same backward in f64 on the same inputs
(``err_vs_f64``: max |error| of dq, dk, dv, beside max |f64 value|). Prints
one JSON line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

# H100 SXM: HBM3, dense bf16 tensor cores, f32 FFMA, f32 products in 3xTF32 (three TF32
# products, TF32 at half the bf16 rate), as chip_smoke.py's bounds
BYTES_PER_S, BF16_OPS_PER_S, FFMA_OPS_PER_S = 3.35e12, 989e12, 67e12
TF32X3_OPS_PER_S = BF16_OPS_PER_S / 2 / 3
H, HS = 32, 128  # the 7B preset's heads and head size
K4_SHAPES = ((1, 128), (1, 200), (1, 2048), (2, 2048))
K10_SHAPES = ((1, 2048), (2, 2048))
# (B, H, T, hs, dtype) of K4 and K10 past bf16 at head size 128
K4_OTHER = ((1, 16, 2048, 256, "bfloat16"), (1, 8, 1024, 384, "bfloat16"), (1, 8, 1024, 512, "bfloat16"),
            (1, 32, 2048, 128, "float32"), (1, 16, 2048, 256, "float32"), (1, 8, 1024, 384, "float32"),
            (1, 8, 1024, 512, "float32"))
K10_OTHER = ((1, 16, 2048, 256, "bfloat16"), (1, 8, 1024, 384, "bfloat16"), (1, 8, 1024, 512, "bfloat16"),
             (1, 32, 2048, 128, "float32"), (1, 16, 2048, 256, "float32"), (1, 8, 1024, 384, "float32"),
             (1, 8, 1024, 512, "float32"))


def bound_us(nbytes: float, ops: float, ops_per_s: float = BF16_OPS_PER_S) -> float:
    return max(nbytes / BYTES_PER_S, ops / ops_per_s) * 1e6


def sha(*ts) -> str:
    """A hash of the tensors' bits (bf16 widens to f32 exactly)."""
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def k4_bound_us(B: int, T: int, heads: int = H, hs: int = HS, es: int = 2,
                ops_per_s: float = BF16_OPS_PER_S) -> float:
    """q, k, v read and o written once (es bytes an element), lse written; S
    and P V over the causal pairs at ``ops_per_s``."""
    rows = B * heads * T
    return bound_us(4 * rows * hs * es + rows * 4, 2 * 2 * hs * B * heads * T * (T + 1) // 2, ops_per_s)


def k10_work(rows: int, pairs: int, hs: int, es: int):
    """K10's ((bytes, operations) of dq, of dK/dV) over ``rows`` query rows
    and ``pairs`` causal (query, key) pairs, es bytes an element: dq reads q,
    k, v, o, dO, lse and writes D and dq (S, dP and dS K); dK/dV reads q, k,
    v, dO, lse, D and writes dk, dv (S, dP, dV, dK)."""
    return ((5 * rows * hs * es + rows * 4 + rows * hs * es + rows * 4, 3 * 2 * hs * pairs),
            (4 * rows * hs * es + 2 * rows * 4 + 2 * rows * hs * es, 4 * 2 * hs * pairs))


def k10_bound_us(B: int, T: int, heads: int = H, hs: int = HS, es: int = 2, ops_per_s: float = BF16_OPS_PER_S):
    """(dq, dK/dV) bounds in µs at ``ops_per_s``."""
    rows, pairs = B * heads * T, B * heads * T * (T + 1) // 2
    return tuple(bound_us(nb, ops, ops_per_s) for nb, ops in k10_work(rows, pairs, hs, es))


def k10_f64(q, k, v, o, lse, do):
    """(dq, dk, dv) of causal attention in f64 from the same inputs: the
    exact answer that K10 in f32 and its plain version both round."""
    import torch

    q, k, v, o, lse, do = (t.double() for t in (q, k, v, o, lse, do))
    T, scale = q.shape[-2], q.shape[-1] ** -0.5
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    p = torch.exp((q @ k.transpose(-1, -2) * scale).masked_fill(~causal, float("-inf")) - lse)
    ds = p * (do @ v.transpose(-1, -2) - (do * o).sum(-1, keepdim=True))
    return ds @ k * scale, ds.transpose(-1, -2) @ q * scale, p.transpose(-1, -2) @ do


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="the directory to import lit_llama_tpu_torch from")
    ap.add_argument("--tag", default="", help="a name for this run in the output")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import devtime  # beside this file
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
    time_us = devtime.make_timer(dev)

    def inputs(B, T, n, heads=H, hs=HS, dtype=torch.bfloat16):
        return [torch.randn(B, heads, T, hs, generator=g).to(dev, dtype) for _ in range(n)]

    def k10_row(q, k, v, do, bounds):
        """K10 timed at (q, k, v, do) beside SDPA's backward, its bits hashed.
        o and lse come from the plain forward, so K10's bits do not follow K4's."""
        o, lse = fa.flash_attention_ref(q, k, v)
        dq, dd = fa.flash_backward_dq(q, k, v, o, lse, do)
        dk, dv = fa.flash_backward_dkv(q, k, v, do, lse, dd)
        qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        r = dict(dq_us=time_us(lambda: fa.flash_backward_dq(q, k, v, o, lse, do)),
                 dkv_us=time_us(lambda: fa.flash_backward_dkv(q, k, v, do, lse, dd)),
                 sdpa_backward_us=time_us(lambda: torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True)),
                 **bounds, sha=sha(dq, dk, dv))
        r["dq_plus_dkv_us"] = r["dq_us"] + r["dkv_us"]
        if q.dtype == torch.float32:
            exact = k10_f64(q, k, v, o, lse, do)
            plain = fa.flash_attention_bwd_ref(q, k, v, o, lse, do)
            r["err_vs_f64"] = dict(kernel=[float((a - e).abs().max()) for a, e in zip((dq, dk, dv), exact)],
                                   plain=[float((a - e).abs().max()) for a, e in zip(plain, exact)],
                                   max_abs=[float(e.abs().max()) for e in exact])
            del exact, plain
        return r

    k4 = {}
    for B, T in K4_SHAPES:
        q, k, v = inputs(B, T, 3)
        o, lse = fa.flash_attention(q, k, v)
        k4[f"B={B} T={T}"] = dict(us=time_us(lambda: fa.flash_attention(q, k, v)),
                                  sdpa_us=time_us(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)),
                                  bound_us=k4_bound_us(B, T), sha=sha(o, lse))
    k4_other = {}
    for B, heads, T, hs, dtype in K4_OTHER:
        cd = getattr(torch, dtype)
        q, k, v = inputs(B, T, 3, heads, hs, cd)
        o, lse = fa.flash_attention(q, k, v)
        k4_other[f"B={B} H={heads} T={T} hs={hs} {dtype}"] = dict(
            us=time_us(lambda: fa.flash_attention(q, k, v)),
            sdpa_us=time_us(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)),
            bound_us=k4_bound_us(B, T, heads, hs, cd.itemsize, BF16_OPS_PER_S if cd == torch.bfloat16 else FFMA_OPS_PER_S),
            sha=sha(o, lse))
        del q, k, v, o, lse
    k10 = {}
    for B, T in K10_SHAPES:
        b_dq, b_dkv = k10_bound_us(B, T)
        k10[f"B={B} T={T}"] = k10_row(*inputs(B, T, 4), dict(dq_bound_us=b_dq, dkv_bound_us=b_dkv))
    k10_other = {}
    for B, heads, T, hs, dtype in K10_OTHER:
        cd = getattr(torch, dtype)
        if cd == torch.bfloat16:
            b_dq, b_dkv = k10_bound_us(B, T, heads, hs)
            bounds = dict(dq_bound_us=b_dq, dkv_bound_us=b_dkv)
        else:  # the FFMA rate and 3xTF32 on the tensor cores
            b_dq, b_dkv = k10_bound_us(B, T, heads, hs, 4, FFMA_OPS_PER_S)
            t_dq, t_dkv = k10_bound_us(B, T, heads, hs, 4, TF32X3_OPS_PER_S)
            bounds = dict(dq_bound_us=b_dq, dkv_bound_us=b_dkv, dq_bound_3xtf32_us=t_dq, dkv_bound_3xtf32_us=t_dkv)
        k10_other[f"B={B} H={heads} T={T} hs={hs} {dtype}"] = k10_row(*inputs(B, T, 4, heads, hs, cd), bounds)
    smi = devtime.card_name_and_power_limit()
    print(json.dumps({"tag": args.tag, "root": args.root, "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "allow_tf32": torch.backends.cuda.matmul.allow_tf32, "k4": k4, "k4_other": k4_other, "k10": k10,
                      "k10_other": k10_other}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
