"""Write ``csrc/wgmma.cuh``: the inline-PTX wgmma of the weight-only GEMMs'
mainloop (``csrc/gemm_sm90.cuh``) at every token-tile width it takes. Each
width lists its accumulator registers one by one, so the file is generated.

    python -m lit_llama_tpu_torch.tools.gen_wgmma
"""

from __future__ import annotations

from pathlib import Path

# the token tiles of ops/quant_matmul.py SM90_TILES
WIDTHS = (8, 16, 32, 64, 96, 128, 160, 192, 224, 256)

HEAD = """// Generated by lit_llama_tpu_torch/tools/gen_wgmma.py; do not edit.
//
// wgmma<N>(d, a, b): d (64 x N f32, N / 2 registers a thread) += A (64 x 16
// bf16, MN-major, descriptor a) * B (16 x N bf16, K-major, descriptor b),
// issued asynchronously (wgmma.mma_async; commit and wait are the caller's).
#pragma once

#include <stdint.h>

template <int N>
__device__ __forceinline__ void wgmma(float* d, uint64_t a, uint64_t b);
"""


def one(n: int) -> str:
    r = n // 2
    regs = ", ".join(f"%{i}" for i in range(r))
    cons = ", ".join(f'"+f"(d[{i}])' for i in range(r))
    return (f"\ntemplate <>\n__device__ __forceinline__ void wgmma<{n}>(float* d, uint64_t a, uint64_t b) {{\n"
            f"  asm volatile(\n"
            f'      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"\n'
            f'      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "\n'
            f'      "{{{regs}}}, %{r}, %{r + 1}, p, 1, 1, 1, 0;\\n}}\\n"\n'
            f"      : {cons}\n"
            f'      : "l"(a), "l"(b), "r"(1));\n}}\n')


def main() -> None:
    out = Path(__file__).resolve().parent.parent / "csrc" / "wgmma.cuh"
    out.write_text(HEAD + "".join(one(n) for n in WIDTHS))
    print(out)


if __name__ == "__main__":
    main()
