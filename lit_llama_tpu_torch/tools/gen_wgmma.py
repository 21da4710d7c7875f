"""Write ``csrc/wgmma.cuh``: the inline-PTX wgmma of the weight-only GEMMs'
mainloop (``csrc/gemm_sm90.cuh``) at every token-tile width it takes, and the
two forms flash attention (``csrc/flash_sm90.cuh``, ``csrc/flash_sm90_hs256.cuh``)
takes at the widths it uses. Each width lists its accumulator registers one by one, so the file is
generated.

    python -m lit_llama_tpu_torch.tools.gen_wgmma
"""

from __future__ import annotations

from pathlib import Path

# the token tiles of ops/quant_matmul.py SM90_TILES
WIDTHS = (8, 16, 32, 64, 96, 128, 160, 192, 224, 256)
# flash attention: score tiles of 64 (K10) or 128 (K4) keys, both K-major
# from shared memory; products into the head's columns (128, or 256 in K10 at
# head size 256, csrc/flash_sm90_hs256.cuh), A from registers
SS_WIDTHS = (64, 128)
RS_WIDTHS = (128, 256)

HEAD = """// Generated by lit_llama_tpu_torch/tools/gen_wgmma.py; do not edit.
//
// wgmma<N>(d, a, b): d (64 x N f32, N / 2 registers a thread) += A (64 x 16
// bf16, MN-major, descriptor a) * B (16 x N bf16, K-major, descriptor b),
// issued asynchronously (wgmma.mma_async; commit and wait are the caller's).
#pragma once

#include <stdint.h>

//
// wgmma_ss<N>(d, a, b, scale_d): d (64 x N f32) = A (64 x 16 bf16, K-major,
// descriptor a) * B (16 x N bf16, K-major: stored N rows x 16, descriptor b),
// plus d where scale_d != 0.
//
// wgmma_rs<N>(d, a, b): d (64 x N f32) += A (64 x 16 bf16 from registers:
// four 32-bit registers a thread, warp w rows 16 w.., the m16n8k16 A layout)
// * B (16 x N bf16, MN-major: stored 16 rows x N, descriptor b).
template <int N>
__device__ __forceinline__ void wgmma(float* d, uint64_t a, uint64_t b);
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b, int scale_d);
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t b);
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


def ss(n: int) -> str:
    r = n // 2
    regs = ", ".join(f"%{i}" for i in range(r))
    cons = ", ".join(f'"+f"(d[{i}])' for i in range(r))
    return (f"\ntemplate <>\n__device__ __forceinline__ void wgmma_ss<{n}>(float* d, uint64_t a, uint64_t b, "
            f"int scale_d) {{\n"
            f"  asm volatile(\n"
            f'      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"\n'
            f'      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "\n'
            f'      "{{{regs}}}, %{r}, %{r + 1}, p, 1, 1, 0, 0;\\n}}\\n"\n'
            f"      : {cons}\n"
            f'      : "l"(a), "l"(b), "r"(scale_d));\n}}\n')


def rs(n: int) -> str:
    r = n // 2
    regs = ", ".join(f"%{i}" for i in range(r))
    cons = ", ".join(f'"+f"(d[{i}])' for i in range(r))
    return (f"\ntemplate <>\n__device__ __forceinline__ void wgmma_rs<{n}>(float* d, const uint32_t* a, "
            f"uint64_t b) {{\n"
            f"  asm volatile(\n"
            f'      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"\n'
            f'      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "\n'
            f'      "{{{regs}}}, {{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, %{r + 4}, p, 1, 1, 1;\\n}}\\n"\n'
            f"      : {cons}\n"
            f'      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));\n}}\n')


def main() -> None:
    out = Path(__file__).resolve().parent.parent / "csrc" / "wgmma.cuh"
    out.write_text(HEAD + "".join(one(n) for n in WIDTHS) + "".join(ss(n) for n in SS_WIDTHS)
                   + "".join(rs(n) for n in RS_WIDTHS))
    print(out)


if __name__ == "__main__":
    main()
