"""Where the consumer warpgroups of the Hopper flash kernels (K4, K10 dq and
dK/dV, ``csrc/flash_sm90.cuh``) spend their cycles.

    python lit_llama_tpu_torch/tools/flash_spans.py [--out DIR]

Copies the package to DIR (default ``build/flash_spans``, which the copy's
kernels build beside), adds ``clock64`` spans to the copy's kernels, runs K4,
dq and dK/dV at (1, 32, 2048), (2, 32, 2048) and (1, 32, 200) in bf16 at head
size 128, and prints, for each kernel and shape, the cycles a consumer
warpgroup takes, the cycles a tile step takes, and the share of its time
between each wait and issue of the kernel: the own tile's copy, the ring's
copies, the turn on the tensor cores, the wgmma issue, the waits for the
scores and for the products, the softmax or elementwise work, and the
epilogue. Thread 0 of each consumer warpgroup takes the readings and adds them
atomically into a table the tool reads back, so the instrumented kernels run
slower than the real ones: the shares, not the cycles, are the finding. The
repo's own sources are left as they are. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

# (pattern on a line of a consumer's code, span it ends); the first match wins
RULES = (("mbar_wait(qbar", 1), ("mbar_wait(kvbar", 1), ("mbar_wait(rk.full", 2), ("mbar_wait(rq.full", 2),
         ("mbar_wait(rv.full", 3), ("turn_wait(wg);", 10), ("wgmma_commit();", 4), ("turn_pass(wg);", 4),
         ("fence_regs(s);", 5), ("softmax(", 6), ("ds_tile(", 6), ("pack_a<DKV_BQ>(sa, dp);", 6),
         ("fence_regs(o);", 7), ("fence_regs(dv);", 7), ("fence_regs(acc);", 7), ("pack_a<FWD_BKV>(pa, s);", 8))
SPANS = {1: "own tile copy", 2: "ring copy (K or Q tile)", 3: "ring copy (V tile)", 10: "turn on the tensor cores",
         4: "wgmma issue", 5: "wait for the scores", 6: "softmax / elementwise", 7: "wait for the products",
         8: "rescale + pack", 9: "epilogue"}
KERNELS = (("fwd_kernel(", "K4", "n_kv"), ("dq_kernel(", "K10 dq", "n_kv"), ("dkv_kernel(", "K10 dkv", "(n_q - i0)"))
HEAD = """
__device__ unsigned long long g_spans[3][16];
__device__ __forceinline__ unsigned long long clk() {
  unsigned long long c;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c));
  return c;
}
#define SPAN(K, i) if (t128 == 0) { const unsigned long long _c = clk(); atomicAdd(&g_spans[K][i], _c - t_mark); t_mark = _c; }
"""
READ = """
LLT_EXPORT int flash_spans(unsigned long long* out) {
  int err = (int)cudaMemcpyFromSymbol(out, fa90::g_spans, sizeof(fa90::g_spans));
  unsigned long long zero[48] = {0};
  if (!err) err = (int)cudaMemcpyToSymbol(fa90::g_spans, zero, sizeof(zero));
  return err;
}
"""


def instrument(src: str) -> str:
    """flash_sm90.cuh with a span after each wait and issue of a consumer
    warpgroup, and the totals (cycles, tile steps, warpgroups) at its end."""
    out, kernel, consumer = [], None, False
    for line in src.split("\n"):
        starts = [i for i, (name, _, _) in enumerate(KERNELS) if name in line and "__global__" in line]
        if starts:
            kernel, consumer = starts[0], False
        if kernel is not None and consumer and line == "}":
            out.append(f"  SPAN({kernel}, 9);")
            out.append(f"  if (t128 == 0) {{ atomicAdd(&g_spans[{kernel}][11], clk() - t_start); "
                       f"atomicAdd(&g_spans[{kernel}][12], (unsigned long long){KERNELS[kernel][2]}); "
                       f"atomicAdd(&g_spans[{kernel}][13], 1ull); }}")
            kernel, consumer = None, False
        out.append(line)
        if kernel is None:
            continue
        if "t128 = tid % 128" in line:
            consumer = True
            out.append("  unsigned long long t_mark = clk(), t_start = t_mark;")
        elif consumer and "auto " not in line and not line.strip().startswith("//") and line.rstrip().endswith(";"):
            span = next((k for pattern, k in RULES if pattern in line), None)
            if span is not None:
                out.append(f"{line[:len(line) - len(line.lstrip())]}SPAN({kernel}, {span});")
    return "\n".join(out).replace("namespace fa90 {\n", "namespace fa90 {\n" + HEAD, 1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(Path(__file__).resolve().parents[2] / "build" / "flash_spans"),
                    help="the directory for the instrumented copy of the package")
    args = ap.parse_args()
    package = Path(__file__).resolve().parents[1]
    out = Path(args.out)
    shutil.rmtree(out / package.name, ignore_errors=True)
    shutil.copytree(package, out / package.name, ignore=shutil.ignore_patterns("__pycache__"))
    csrc = out / package.name / "csrc"
    (csrc / "flash_sm90.cuh").write_text(instrument((csrc / "flash_sm90.cuh").read_text()))
    (csrc / "flash_attention.cu").write_text((csrc / "flash_attention.cu").read_text() + READ)
    sys.path.insert(0, str(out))
    import torch

    if not torch.cuda.is_available():
        print("flash_spans: no CUDA device", file=sys.stderr)
        return 1
    from lit_llama_tpu_torch.ops import _build
    from lit_llama_tpu_torch.ops import flash_attention as fa

    assert Path(fa.__file__).resolve().is_relative_to(out.resolve()), "imported the package from elsewhere"
    _build.build(["flash_attention"])
    lib = ctypes.CDLL(str(_build.lib_path("flash_attention")))
    lib.flash_spans.argtypes, lib.flash_spans.restype = [ctypes.c_void_p], ctypes.c_int
    table = (ctypes.c_ulonglong * 48)()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    for B, T in ((1, 2048), (2, 2048), (1, 200)):
        q, k, v, do = (torch.randn(B, 32, T, 128, generator=g).to(dev, torch.bfloat16) for _ in range(4))
        o, lse = fa.flash_attention(q, k, v)
        dq, dd = fa.flash_backward_dq(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        lib.flash_spans(table)  # clears the table
        fa.flash_attention(q, k, v)
        fa.flash_backward_dq(q, k, v, o, lse, do)
        fa.flash_backward_dkv(q, k, v, do, lse, dd)
        torch.cuda.synchronize()
        if lib.flash_spans(table) != 0:
            raise RuntimeError("flash_spans: reading the table failed")
        for i, (_, name, _) in enumerate(KERNELS):
            row = [table[16 * i + j] for j in range(16)]
            cycles, steps, wgs = row[11], row[12], row[13]
            print(json.dumps({"kernel": name, "shape": [B, 32, T, 128], "nvidia_smi": smi, "warpgroups": wgs,
                              "cycles_a_warpgroup": cycles / wgs, "cycles_a_tile_step": cycles / steps,
                              "share": {SPANS[j]: row[j] / cycles for j in SPANS if row[j]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
