"""Single-construct probes of K1's building blocks (counterpart of
scripts/probe_mosaic.py, P1-P5).

Each case builds one small CUDA kernel (``csrc/probe.cu``) for one construct
the fused decode kernels use, runs it on seeded random inputs, and holds the
whole output against the case's plain PyTorch version. A case prints its
value as the JAX script does (one element of the output) with the largest
difference from the plain version.

    python -m lit_llama_tpu_torch.tools.probe_kernels --all            # every case, each in a subprocess, at once
    python -m lit_llama_tpu_torch.tools.probe_kernels --case mv_small_n  # one case, in this process
    python -m lit_llama_tpu_torch.tools.probe_kernels --all --device cpu  # the plain versions only

On the CPU (``--device cpu``) a case runs its plain version alone and says
so. ``--all`` exits nonzero if a case fails or its process dies.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, Tuple

import torch

from lit_llama_tpu_torch.ops import _build, fused_layer
from lit_llama_tpu_torch.ops.linear import quantize_int4
from lit_llama_tpu_torch.utils.device import resolve_device

H, ROWS, HS = 4, 64, 128  # the JAX script's geometry (7B head size)
K4, N4, GS4, R4 = 512, 256, 128, 8  # P4: the small-N int4 matvec
# |kernel - plain| <= ATOL + RTOL * |plain|: the f32 cases sum the same
# products in another order (dots of 128 products of values ~1: ~1e-5); P4's
# kernel and plain version multiply the same bf16-rounded inputs by the same
# nibbles with f32 sums, in another order
TOL = {"dot_nt": (1e-4, 1e-5), "iota_mask_dots": (1e-4, 1e-5), "reshape3": (1e-4, 1e-5),
       "mv_small_n": (1e-3, 1e-4), "concat": (0.0, 0.0)}

_P, _I = _build.PTR, _build.INT
_SIGS = {
    "p1_dot_nt": [_P, _P, _P, _I, _I, _I, _P],
    "p2_iota_mask_dots": [_P] * 4,
    "p4_mv_small_n": [_P] * 5 + [_I] * 4 + [_P],
    "p5_concat": [_P, _P, _I, _P],
}


def _lib():
    return _build.library("probe", _SIGS)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _f32(t: torch.Tensor, shape, what: str):
    if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{what} takes a contiguous f32 {shape} tensor, got {t.dtype} {tuple(t.shape)}")


# ---- P1 dot_nt: (H, HS) x (H * ROWS, HS)^T --------------------------------------


def dot_nt_ref(a, b):
    return a @ b.t()


def dot_nt(a, b):
    """a (H, HS) f32 @ b (H * ROWS, HS)^T -> (H, H * ROWS). A CPU tensor takes
    the plain version; a CUDA tensor launches P1's kernel or raises."""
    if not a.is_cuda:
        return dot_nt_ref(a, b)
    _f32(a, (H, HS), "P1 a")
    _f32(b, (H * ROWS, HS), "P1 b")
    out = torch.empty((H, H * ROWS), dtype=torch.float32, device=a.device)
    _build.check(_lib().p1_dot_nt(a.data_ptr(), b.data_ptr(), out.data_ptr(), H, H * ROWS, 0, _stream(a)), "P1")
    dot_nt.launches += 1
    return out


dot_nt.launches = 0


# ---- P2 iota_mask_dots: masked scores, then the compaction product ---------------


def iota_mask_dots_ref(q, k):
    s_all = q @ k.t()  # (H, H * ROWS)
    r = torch.arange(H, device=q.device)[:, None]
    c = torch.arange(H * ROWS, device=q.device)[None, :]
    mask = (c // ROWS == r).float()
    sel = (torch.arange(H * ROWS, device=q.device)[:, None] % ROWS
           == torch.arange(ROWS, device=q.device)[None, :]).float()
    return (s_all * mask) @ sel


def iota_mask_dots(q, k):
    """q (H, HS), k (H * ROWS, HS) f32 -> (H, ROWS): each head's scores
    against its own ROWS keys, through the full mask and compaction product."""
    if not q.is_cuda:
        return iota_mask_dots_ref(q, k)
    _f32(q, (H, HS), "P2 q")
    _f32(k, (H * ROWS, HS), "P2 k")
    out = torch.empty((H, ROWS), dtype=torch.float32, device=q.device)
    _build.check(_lib().p2_iota_mask_dots(q.data_ptr(), k.data_ptr(), out.data_ptr(), _stream(q)), "P2")
    iota_mask_dots.launches += 1
    return out


iota_mask_dots.launches = 0


# ---- P3 reshape3: (H, ROWS, HS) collapsed to (H * ROWS, HS), then the NT dot ----


def reshape3_ref(q, k):
    return q @ k.reshape(H * ROWS, HS).t()


def reshape3(q, k):
    """q (H, HS), k (H, ROWS, HS) f32 -> q @ k.reshape(H * ROWS, HS)^T."""
    if not q.is_cuda:
        return reshape3_ref(q, k)
    _f32(q, (H, HS), "P3 q")
    _f32(k, (H, ROWS, HS), "P3 k")
    out = torch.empty((H, H * ROWS), dtype=torch.float32, device=q.device)
    _build.check(_lib().p1_dot_nt(q.data_ptr(), k.data_ptr(), out.data_ptr(), H, H * ROWS, 1, _stream(q)), "P3")
    reshape3.launches += 1
    return out


reshape3.launches = 0


# ---- P4 mv_small_n: K1's int4 matvec at N = 256 ---------------------------------


def mv_small_n_ref(x, w):
    return fused_layer.mv_int4_ref(x.float(), w, torch.bfloat16)


def mv_small_n(x, w):
    """x (R4, K4) bf16 @ dequant(w) -> (R4, N4) f32 through K1's int4 matvec,
    one launch a row; w the int4 params with the decode layout
    (``fused_layer.add_decode_layout``)."""
    if not x.is_cuda:
        return mv_small_n_ref(x, w)
    if x.dtype != torch.bfloat16 or tuple(x.shape) != (R4, K4) or not x.is_contiguous():
        raise ValueError(f"P4 takes contiguous bf16 ({R4}, {K4}) rows")
    fused_layer._check_q4(w, K4, N4, GS4, "P4")
    out = torch.empty((R4, N4), dtype=torch.float32, device=x.device)
    err = _lib().p4_mv_small_n(x.data_ptr(), *[w[key].data_ptr() for key in fused_layer._DECODE_KEYS],
                               out.data_ptr(), R4, K4, N4, GS4, _stream(x))
    _build.check(err, "P4")
    mv_small_n.launches += 1
    return out


mv_small_n.launches = 0


# ---- P5 concat: four (rows, 128) pieces, each scaled, side by side -------------


def concat_ref(x):
    return torch.cat([x[:, i * 128 : (i + 1) * 128] * (i + 1.0) for i in range(4)], dim=1)


def concat(x):
    """x (R, 512) f32 -> the concatenation of x[:, 128 i : 128 (i + 1)] * (i + 1)."""
    if not x.is_cuda:
        return concat_ref(x)
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != 512 or not x.is_contiguous():
        raise ValueError("P5 takes a contiguous f32 (R, 512) tensor")
    out = torch.empty_like(x)
    _build.check(_lib().p5_concat(x.data_ptr(), out.data_ptr(), x.shape[0], _stream(x)), "P5")
    concat.launches += 1
    return out


concat.launches = 0


# ---- the cases -------------------------------------------------------------------


def case_inputs(name: str, device, seed: int = 0) -> Tuple:
    """Seeded inputs of a case, made on the CPU and moved to ``device``."""
    g = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g)

    if name in ("dot_nt", "iota_mask_dots"):
        args = (randn(H, HS), randn(H * ROWS, HS))
    elif name == "reshape3":
        args = (randn(H, HS), randn(H, ROWS, HS))
    elif name == "mv_small_n":
        w = quantize_int4(randn(K4, N4) * 0.05, groupsize=GS4)
        w = fused_layer._with_decode_layout(w)
        args = (randn(R4, K4).to(torch.bfloat16), w)
    elif name == "concat":
        args = (randn(8, 512),)
    else:
        raise KeyError(f"unknown case {name!r}; cases: {', '.join(CASES)}")

    def move(a):
        return {k: v.to(device) for k, v in a.items()} if isinstance(a, dict) else a.to(device)

    return tuple(move(a) for a in args)


# name -> (wrapper, plain version, index of the value the JAX script prints)
CASES: Dict[str, Tuple[Callable, Callable, Tuple[int, int]]] = {
    "dot_nt": (dot_nt, dot_nt_ref, (0, 0)),
    "iota_mask_dots": (iota_mask_dots, iota_mask_dots_ref, (0, 0)),
    "reshape3": (reshape3, reshape3_ref, (0, 0)),
    "concat": (concat, concat_ref, (0, 130)),
    "mv_small_n": (mv_small_n, mv_small_n_ref, (0, 0)),
}


def run_case(name: str, device=None, seed: int = 0) -> Dict[str, float]:
    """Run one case on ``device`` (the card when None) and hold it against
    its plain version. Returns {"value", "max_abs_err"}; raises if they
    disagree beyond TOL."""
    dev = resolve_device(device)
    fn, ref, at = CASES[name]
    args = case_inputs(name, dev, seed)
    got = fn(*args)
    want = ref(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    err = (got.float() - want.float()).abs()
    atol, rtol = TOL[name]
    if not torch.isfinite(got).all() or bool((err > atol + rtol * want.float().abs()).any()):
        raise AssertionError(f"{name}: kernel and plain version disagree, max |err| {float(err.max()):.3g}")
    return {"value": float(got[at]), "max_abs_err": float(err.max())}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--all", action="store_true", help="run every case, each in a subprocess")
    parser.add_argument("--case", choices=list(CASES), help="run one case in this process")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu (plain versions only)")
    args = parser.parse_args(argv)
    if args.case:
        r = run_case(args.case, args.device)
        what = "plain version only, on the CPU" if resolve_device(args.device).type == "cpu" else "kernel vs plain"
        print(f"{args.case}: OK ({r['value']}) max |err| {r['max_abs_err']:.3g} ({what})")
        return 0
    if not args.all:
        parser.error("give --all or --case NAME")
    fails = 0
    extra = ["--device", args.device] if args.device else []
    # the cases' processes start at once (each spends most of its time starting
    # up) and report in the order of CASES
    procs = {name: subprocess.Popen([sys.executable, "-m", "lit_llama_tpu_torch.tools.probe_kernels", "--case", name]
                                    + extra, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                    cwd=Path(__file__).resolve().parents[2]) for name in CASES}
    try:
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=900)
            if proc.returncode == 0:
                print(out.strip().splitlines()[-1])
            else:
                fails += 1
                tail = (err.strip().splitlines() or ["?"])[-1][:200]
                print(f"{name}: FAILED rc={proc.returncode} {tail}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
