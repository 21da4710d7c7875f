"""Causal flash attention: the forward K4, the backward K10 and their plain
versions (counterpart of lit_llama_tpu/ops/flash_attention.py).

``flash_attention`` replaces the Pallas ``_flash_kernel``
(lit_llama_tpu/ops/flash_attention.py, entry ``_flash_forward``) with the
CUDA kernels of ``csrc/flash_attention.cu``. It serves every causal prefill
with T > 1 on the card whose head size is a multiple of 128
(``ops.attention.flash_route``), any T (the kernels mask the ragged last
tile), any head size that is a multiple of 128 (``check_flash``). bf16 runs
on Hopper kernels (wgmma, TMA, mbarrier rings), tiled as ``flash_plan``
says: at head size 128, every LLaMA preset's, ``csrc/flash_sm90.cuh``; at
256 ``csrc/flash_sm90_hs256.cuh`` (the same design at four 64-column
panels, KV tiles of 64 keys); past 256 ``csrc/flash_sm90_wide.cuh`` (the
output's columns split over the grid in chunks of 256, the scores computed
over the whole head in each, Q and K streamed as 64-column panels). f32
compute runs on an FFMA body of ``csrc/flash_attention.cu``
(register-blocked, fed by a cp.async ring, tiled as ``flash_plan`` says),
past 256 on chunked FFMA kernels that split the output's columns over the
grid in chunks of 128 and recompute the scores once a chunk.

``flash_attention_backward`` replaces the Pallas pair ``_flash_dq_kernel`` /
``_flash_dkv_kernel`` (entry ``_flash_backward``) with two K10 kernels, each
behind its own launch counter (``flash_backward_dq``, ``flash_backward_dkv``),
tiled as ``k10_plan`` says: bf16 at head size 128 on ``csrc/flash_sm90.cuh``,
bf16 at 256 on ``csrc/flash_sm90_hs256.cuh`` (the same Hopper design at four
64-column panels; dK and dV on two warpgroups that split the work), bf16 past
256 on ``csrc/flash_sm90_wide.cuh`` (the hs-256 designs with the outputs'
columns in chunks of 256 over the grid and the scores' operands streamed as
64-column panels, as K4 past 256), f32 at 128 and 256 on
``csrc/flash_tf32.cuh`` (mma.sync in 3xTF32 on the tensor cores), f32 past
256 on the chunked FFMA kernels. ``FlashAttention`` is the autograd
Function around the pair, the counterpart of the ``jax.custom_vjp`` of
``flash_attention``: its forward runs K4 and saves (q, k, v, o, lse), its
backward runs K10. A CPU tensor, or ``plain=True``, takes the plain versions
in the same Function.

``flash_attention_ref`` computes the same (o, lse) in plain PyTorch: f32
scores, the unnormalised probabilities rounded to the input dtype for the PV
product, normalised after it, as the Pallas kernel does.
``flash_attention_bwd_ref`` is the plain K10, rounded as the Pallas kernels
round.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from lit_llama_tpu_torch.ops import _build

NEG_INF = -1e30

_SIGS = {
    "k4_flash_forward": [_build.PTR] * 5 + [_build.INT] * 3 + [_build.FLOAT] + [_build.INT] * 3 + [_build.PTR],
    "k10_flash_backward_dq": [_build.PTR] * 8 + [_build.INT] * 3 + [_build.FLOAT] + [_build.INT] * 2 + [_build.PTR],
    "k10_flash_backward_dkv": [_build.PTR] * 8 + [_build.INT] * 3 + [_build.FLOAT] + [_build.INT] * 2 + [_build.PTR],
}
HEAD_SIZE_STEP = 128  # the kernels take every head size that is a multiple (csrc/flash_attention.cu)
DTYPES = (torch.bfloat16, torch.float32)
H100_SMS = 132

# The Hopper kernels (csrc/flash_sm90.cuh, bf16 at head size 128): rows a
# tile and ring stages of each kernel, as the source has them
SM90_HS = 128
FWD_KV_ROWS, FWD_STAGES = 128, 3  # K4: keys a KV tile under every plan
DQ_Q_ROWS, DQ_KV_ROWS, DQ_STAGES = 128, 64, 4
DKV_KV_ROWS, DKV_Q_ROWS, DKV_STAGES = 128, 64, 3
SM90_MAX_SMEM = 232448  # what a block may use on the H100

# K4 at head size 256 in bf16 (csrc/flash_sm90_hs256.cuh): 64 or 128 query
# rows a block (as at 128) against KV tiles of 64 keys under either plan, K
# and V in rings of their own
HS256_FWD_KV_ROWS, HS256_FWD_K_STAGES, HS256_FWD_V_STAGES = 64, 2, 2
# K4 past head size 256 in bf16 (csrc/flash_sm90_wide.cuh): 128 query rows a
# block against KV tiles of 64 keys, the output's columns in chunks of 256; a
# stage of the QK ring holds a 64-column panel of the Q tile and of the KV
# tile, a stage of the V ring a KV tile's chunk of V
WIDE_Q_ROWS, WIDE_KV_ROWS, WIDE_CHUNK, WIDE_QK_STAGES, WIDE_V_STAGES = 128, 64, 256, 6, 2
PANEL = 64  # head columns of a 128-byte swizzled panel

# K4's FFMA body of f32 compute (csrc/flash_attention.cu ffma_fwd_kernel, head
# size 128 or 256): query rows a block, keys a tile under every shape,
# threads, and the f32 words of padding a staged row
FFMA_Q_ROWS, FFMA_KV_ROWS, FFMA_THREADS = 64, 64, 256
FFMA_PAD, FFMA_P_PAD = 4, 8


def ffma_stages(hs: int) -> int:
    """Slots of the FFMA body's K/V ring (``ff_stages`` in the source)."""
    return 4 if hs <= 128 else 2


def ffma_smem(hs: int) -> int:
    """Dynamic shared memory of the FFMA body (``ff_smem``): Q and the ring's
    slots (rows of hs + 4 words), P (rows of 72 words), and each row's max
    and sum from its two warps."""
    return ((1 + ffma_stages(hs)) * FFMA_Q_ROWS * (hs + FFMA_PAD)
            + FFMA_Q_ROWS * (FFMA_KV_ROWS + FFMA_P_PAD) + 4 * FFMA_Q_ROWS) * 4


def _tile_bytes(rows: int) -> int:
    return rows * SM90_HS * 2


def sm90_smem(kernel: str, q_rows: int = 128) -> int:
    """Dynamic shared memory of a Hopper kernel ("fwd" at ``q_rows`` query
    rows a block, "dq", "dkv"): 1024 bytes of alignment slack, its tiles and
    its mbarriers (``fwd_smem``, ``dq_smem``, ``dkv_smem`` in the source)."""
    if kernel == "fwd":
        return 1024 + _tile_bytes(q_rows) + FWD_STAGES * 2 * _tile_bytes(FWD_KV_ROWS) + (4 * FWD_STAGES + 1) * 8
    if kernel == "dq":
        return 1024 + 2 * _tile_bytes(DQ_Q_ROWS) + DQ_STAGES * 2 * _tile_bytes(DQ_KV_ROWS) + (4 * DQ_STAGES + 1) * 8
    if kernel == "dkv":
        stage = 2 * _tile_bytes(DKV_Q_ROWS) + 1024  # Q_i, dO_i, their lse and D rows
        return 1024 + 2 * _tile_bytes(DKV_KV_ROWS) + DKV_STAGES * stage + (2 * DKV_STAGES + 1) * 8
    raise ValueError(f"no Hopper flash kernel {kernel!r}")


def hs256_smem(q_rows: int) -> int:
    """Dynamic shared memory of K4 at head size 256 (``fwd_smem`` of
    csrc/flash_sm90_hs256.cuh): alignment slack, the Q tile, the K and V
    rings' tiles of 256 bf16 columns, mbarriers."""
    n = HS256_FWD_K_STAGES + HS256_FWD_V_STAGES
    return 1024 + (q_rows + n * HS256_FWD_KV_ROWS) * 256 * 2 + (2 * n + 1) * 8


def wide_smem() -> int:
    """Dynamic shared memory of K4 past head size 256 (``fwd_smem`` of
    csrc/flash_sm90_wide.cuh): alignment slack, the QK ring (a panel of the Q
    tile and of the KV tile a stage), the V ring (a KV tile's chunk of 256
    columns a stage), mbarriers. The same at every head size."""
    return (1024 + WIDE_QK_STAGES * (WIDE_Q_ROWS + WIDE_KV_ROWS) * PANEL * 2
            + WIDE_V_STAGES * WIDE_KV_ROWS * WIDE_CHUNK * 2 + 2 * (WIDE_QK_STAGES + WIDE_V_STAGES) * 8)


class FlashPlan(NamedTuple):
    """Which body K4 runs for a shape, and its tiling there (K10's is
    ``k10_plan``): ``body`` is "sm90" (bf16 at head size 128:
    csrc/flash_sm90.cuh), "sm90_hs256" (bf16 at 256:
    csrc/flash_sm90_hs256.cuh), "sm90_wide" (bf16 past 256:
    csrc/flash_sm90_wide.cuh), "ffma" (f32 compute at head size 128 or 256)
    or "chunked" (f32 past 256). A K4 block takes ``q_rows`` query rows (on
    the Hopper bodies a consumer warpgroup for each 64) against KV tiles of
    ``kv_rows`` keys, with ``smem`` bytes of shared memory; "chunked" has a
    tiling of its own (0 here)."""
    body: str
    q_rows: int = 0
    kv_rows: int = 0
    smem: int = 0


def flash_plan(B: int, H: int, T: int, hs: int = SM90_HS, dtype: torch.dtype = torch.bfloat16) -> FlashPlan:
    """The body and K4 tiling for (B, H, T, hs, dtype), a pure function of
    the shapes. On the Hopper kernels at head size 128 and 256 a block takes
    64 query rows (one consumer warpgroup) where the blocks of 64 rows all
    fit on the SMs at once, else 128 (two consumer warpgroups, which keep an
    SM's tensor cores busier). At T = 200 and 32 heads, 128 blocks of 64 rows
    beat 64 blocks of 128, which leave half of 132 SMs idle; at T = 512, 256
    blocks of 64 rows take two waves and 128 blocks of 128 rows one. The KV
    tile (128 keys at head size 128, 64 at 256) is the same under either
    plan, so a query row runs the same steps of the online softmax, and gets
    the same bits, whichever plan its shape picks. Past 256, bf16 takes 128
    query rows against KV tiles of 64 keys at every shape. f32 at head size
    128 or 256 takes the FFMA body: 64 query rows against KV tiles of 64
    keys at every shape."""
    if B < 1 or H < 1 or T < 1 or hs < 1 or hs % HEAD_SIZE_STEP:
        raise ValueError(f"flash_plan takes positive shapes and a head size that is a multiple of "
                         f"{HEAD_SIZE_STEP}, got B={B} H={H} T={T} hs={hs}")
    if dtype != torch.bfloat16:
        if hs > 256:
            return FlashPlan("chunked")
        return FlashPlan("ffma", FFMA_Q_ROWS, FFMA_KV_ROWS, ffma_smem(hs))
    if hs > 256:
        return FlashPlan("sm90_wide", WIDE_Q_ROWS, WIDE_KV_ROWS, wide_smem())
    q_rows = 64 if B * H * -(-T // 64) <= H100_SMS else 128
    if hs == 256:
        return FlashPlan("sm90_hs256", q_rows, HS256_FWD_KV_ROWS, hs256_smem(q_rows))
    return FlashPlan("sm90", q_rows, FWD_KV_ROWS, sm90_smem("fwd", q_rows))


def sm90_blocks(kernel: str, T: int, q_rows: int = 128) -> List[Tuple[int, range]]:
    """The grid rows of a Hopper kernel over one head, in launch order
    (``blockIdx.y``) for K4: each block's own tile and the KV tiles its loop
    visits, as csrc/flash_sm90.cuh computes them. "fwd" (``q_rows`` query
    rows a block) owns a Q tile and visits the KV tiles up to its diagonal,
    the last Q tile first. "ffma" is K4's FFMA body of f32 compute
    (csrc/flash_attention.cu ffma_fwd_kernel), tiled as "fwd" with 64 query
    rows and KV tiles of 64. K10's blocks are ``k10_blocks``."""
    if kernel in ("fwd", "ffma"):
        rows, kv = (q_rows, FWD_KV_ROWS) if kernel == "fwd" else (FFMA_Q_ROWS, FFMA_KV_ROWS)
        n = -(-T // rows)
        return [(qt, range(-(-min((qt + 1) * rows, T) // kv))) for qt in (n - 1 - y for y in range(n))]
    raise ValueError(f"no Hopper flash kernel {kernel!r}")


def k4_warpgroups(plan: FlashPlan, T: int) -> List[Tuple[range, range]]:
    """K4's work over one head (and one chunk of columns) on the plan's
    body at head size 256 or past it, in launch order (the last Q tile
    first): for each consumer warpgroup of each block, the 64 query rows it
    owns and the KV tiles it visits, up to its own diagonal (``n_own`` in
    csrc/flash_sm90_hs256.cuh and flash_sm90_wide.cuh). Warpgroup 0 of a
    128-row block leaves out the block's last tile, which holds only keys
    past its rows."""
    if plan.body not in ("sm90_hs256", "sm90_wide"):
        raise ValueError(f"no per-warpgroup schedule for the K4 body {plan.body!r}")
    rows, kv = plan.q_rows, plan.kv_rows
    n = -(-T // rows)
    out = []
    for qt in (n - 1 - y for y in range(n)):
        n_kv = -(-min((qt + 1) * rows, T) // kv)
        for first in range(qt * rows, (qt + 1) * rows, 64):
            out.append((range(first, first + 64), range(min(n_kv, first // kv + 1))))
    return out


# K10 at head size 256 in bf16 (csrc/flash_sm90_hs256.cuh): dq takes 128
# query rows a block (two consumer warpgroups) against KV tiles of 64 keys, K
# and V in rings of their own; dK/dV takes 64 keys a block against Q tiles of
# 64 rows in a ring, with two buffers that hand P^T from one warpgroup to the
# other
HS256_DQ_Q_ROWS, HS256_DQ_KV_ROWS, HS256_DQ_K_STAGES, HS256_DQ_V_STAGES = 128, 64, 2, 1
HS256_DKV_KV_ROWS, HS256_DKV_Q_ROWS, HS256_DKV_STAGES, HS256_DKV_PBUFS = 64, 64, 2, 2
# K10 past head size 256 in bf16 (csrc/flash_sm90_wide.cuh): the output's
# columns in chunks of WIDE_CHUNK over the grid; dq takes 128 query rows a
# block against KV tiles of 64 keys, a stage of its panel ring a 64-column
# panel of Q and dO (128 rows) and of K and V (64 keys), a ring of its own for
# a KV tile's chunk of K; dK/dV takes 64 keys a block against Q tiles of 64
# rows, a stage a panel of K, Q, V and dO, one chunk stage (Q's and dO's
# chunk of columns, the tile's lse and D rows) and two P^T buffers
WIDE_DQ_Q_ROWS, WIDE_DQ_KV_ROWS, WIDE_DQ_STAGES, WIDE_DQ_KC_STAGES = 128, 64, 4, 1
WIDE_DKV_KV_ROWS, WIDE_DKV_Q_ROWS, WIDE_DKV_STAGES, WIDE_DKV_PBUFS = 64, 64, 4, 2
# the Hopper K10 kernels' blocks: a producer and two consumer warpgroups, the
# consumers raised to 240 registers a thread by setmaxnreg
SM90_THREADS, SM90_CONSUMER_REGS = 384, 240
# K10 in f32 (csrc/flash_tf32.cuh): streamed tiles of 32 rows padded to hs + 4
# words; by head size, the rows a block owns (query rows in dq, keys in
# dK/dV), the warps that split a row's head columns, ring stages
TF32_TILE, TF32_PAD = 32, 4
TF32_TILING = {128: (128, 1, 2), 256: (32, 2, 2)}
MAX_THREAD_REGS, SM_REGS = 255, 65536


class K10Kernel(NamedTuple):
    """One K10 kernel's tiling: the rows a block owns (query rows in dq, keys
    in dK/dV), the rows of each tile its loop streams (keys in dq, query rows
    in dK/dV), the stages of that ring (dq at head size 256: K's; V has one),
    threads a block, dynamic shared bytes, the f32 accumulator registers a
    consumer thread holds (its outputs and the score tiles), and the
    registers such a thread may hold."""
    own_rows: int
    tile_rows: int
    stages: int
    threads: int
    smem: int
    acc_regs: int
    reg_limit: int


class K10Plan(NamedTuple):
    """Which body K10 runs for a shape and each kernel's tiling: ``body`` is
    "sm90" (bf16 at head size 128: csrc/flash_sm90.cuh), "sm90_hs256" (bf16
    at 256: csrc/flash_sm90_hs256.cuh), "sm90_wide" (bf16 past 256:
    csrc/flash_sm90_wide.cuh, the tiling of one chunk of 256 output
    columns), "tf32" (f32 at 128 or 256: csrc/flash_tf32.cuh) or "chunked"
    (f32 past 256: no tiling here)."""
    body: str
    dq: Optional[K10Kernel] = None
    dkv: Optional[K10Kernel] = None


def _hs256_smem(kernel: str) -> int:
    """``dq_smem`` / ``dkv_smem`` of csrc/flash_sm90_hs256.cuh: alignment
    slack, tiles of 256 bf16 columns, (dK/dV) the P^T buffers and each
    stage's lse and D rows, mbarriers."""
    tile = lambda rows: rows * 256 * 2  # noqa: E731
    if kernel == "dq":
        n = HS256_DQ_K_STAGES + HS256_DQ_V_STAGES
        return 1024 + 2 * tile(HS256_DQ_Q_ROWS) + n * tile(HS256_DQ_KV_ROWS) + (2 * n + 1) * 8
    return (1024 + 2 * tile(HS256_DKV_KV_ROWS) + HS256_DKV_STAGES * 2 * tile(HS256_DKV_Q_ROWS)
            + HS256_DKV_PBUFS * HS256_DKV_KV_ROWS * HS256_DKV_Q_ROWS * 4 + HS256_DKV_STAGES * 2 * HS256_DKV_Q_ROWS * 4
            + (2 * HS256_DKV_STAGES + 2 * HS256_DKV_PBUFS + 1) * 8)


def _wide_k10_smem(kernel: str) -> int:
    """``dq_smem`` / ``dkv_smem`` of csrc/flash_sm90_wide.cuh: alignment
    slack, the panel ring (stages of 64-column panels, 128 bytes a row),
    dq's K chunk ring or dK/dV's chunk stage (chunks of 256 bf16 columns,
    the lse and D rows) and P^T buffers, mbarriers. The same at every head
    size."""
    row = PANEL * 2
    if kernel == "dq":
        stage = (2 * WIDE_DQ_Q_ROWS + 2 * WIDE_DQ_KV_ROWS) * row
        return (1024 + WIDE_DQ_STAGES * stage + WIDE_DQ_KC_STAGES * WIDE_DQ_KV_ROWS * WIDE_CHUNK * 2
                + 2 * (WIDE_DQ_STAGES + WIDE_DQ_KC_STAGES) * 8)
    stage = (2 * WIDE_DKV_KV_ROWS + 2 * WIDE_DKV_Q_ROWS) * row
    chunk = 2 * WIDE_DKV_Q_ROWS * WIDE_CHUNK * 2 + 2 * WIDE_DKV_Q_ROWS * 4
    return (1024 + WIDE_DKV_STAGES * stage + chunk + WIDE_DKV_PBUFS * WIDE_DKV_KV_ROWS * WIDE_DKV_Q_ROWS * 4
            + 2 * (WIDE_DKV_STAGES + 1 + WIDE_DKV_PBUFS) * 8)


def _tf32_kernels(hs: int) -> Tuple[K10Kernel, K10Kernel]:
    """dq and dK/dV of csrc/flash_tf32.cuh at head size hs: a warp holds 16
    rows of its outputs over hs / cs columns and two 16 x 32 score tiles (S
    and dP); ``dq_smem`` / ``dkv_smem``: the owned rows of two tensors, the
    ring, the column halves' exchange, (dK/dV) each stage's lse and D."""
    rows, cs, stages = TF32_TILING[hs]
    threads = rows // 16 * cs * 32
    hc, ld = hs // cs, hs + TF32_PAD
    xchg = threads // 32 * 2 * 16 * TF32_TILE if cs == 2 else 0
    dq_smem = ((2 * rows + stages * 2 * TF32_TILE) * ld + xchg) * 4
    scores = 2 * 16 * TF32_TILE // 32
    limit = min(MAX_THREAD_REGS, SM_REGS // threads)
    return (K10Kernel(rows, TF32_TILE, stages, threads, dq_smem, 16 * hc // 32 + scores, limit),
            K10Kernel(rows, TF32_TILE, stages, threads, dq_smem + stages * 2 * TF32_TILE * 4,
                      2 * 16 * hc // 32 + scores, limit))


def k10_plan(B: int, H: int, T: int, hs: int = SM90_HS, dtype: torch.dtype = torch.bfloat16) -> K10Plan:
    """The body and tiling of K10's two kernels for (B, H, T, hs, dtype), a
    pure mirror of the CUDA sources (tests/test_torch_flash_plan.py reads
    their constants). The tiles depend on the head size and dtype only, so a
    row's sums run in the same order at every B, H and T."""
    if B < 1 or H < 1 or T < 1 or hs < 1 or hs % HEAD_SIZE_STEP:
        raise ValueError(f"k10_plan takes positive shapes and a head size that is a multiple of "
                         f"{HEAD_SIZE_STEP}, got B={B} H={H} T={T} hs={hs}")
    if dtype != torch.bfloat16:
        return K10Plan("chunked") if hs > 256 else K10Plan("tf32", *_tf32_kernels(hs))
    wg_acc = lambda cols: 64 * cols // 128  # noqa: E731  (a warpgroup's 64-row f32 accumulator a thread)
    if hs > 256:  # as at 256, over a chunk of 256 columns: the chunk beside S and dP, or beside one score tile
        return K10Plan("sm90_wide",
                       K10Kernel(WIDE_DQ_Q_ROWS, WIDE_DQ_KV_ROWS, WIDE_DQ_STAGES, SM90_THREADS, _wide_k10_smem("dq"),
                                 wg_acc(WIDE_CHUNK) + 2 * wg_acc(WIDE_DQ_KV_ROWS), SM90_CONSUMER_REGS),
                       K10Kernel(WIDE_DKV_KV_ROWS, WIDE_DKV_Q_ROWS, WIDE_DKV_STAGES, SM90_THREADS,
                                 _wide_k10_smem("dkv"), wg_acc(WIDE_CHUNK) + wg_acc(WIDE_DKV_Q_ROWS),
                                 SM90_CONSUMER_REGS))
    if hs == SM90_HS:
        return K10Plan("sm90",
                       K10Kernel(DQ_Q_ROWS, DQ_KV_ROWS, DQ_STAGES, SM90_THREADS, sm90_smem("dq"),
                                 wg_acc(hs) + 2 * wg_acc(DQ_KV_ROWS), SM90_CONSUMER_REGS),
                       K10Kernel(DKV_KV_ROWS, DKV_Q_ROWS, DKV_STAGES, SM90_THREADS, sm90_smem("dkv"),
                                 2 * wg_acc(hs) + 2 * wg_acc(DKV_Q_ROWS), SM90_CONSUMER_REGS))
    # hs 256: dq's warpgroup holds dQ, S and dP; dK/dV's two warpgroups hold dV
    # and S^T, or dK and dP^T
    return K10Plan("sm90_hs256",
                   K10Kernel(HS256_DQ_Q_ROWS, HS256_DQ_KV_ROWS, HS256_DQ_K_STAGES, SM90_THREADS, _hs256_smem("dq"),
                             wg_acc(hs) + 2 * wg_acc(HS256_DQ_KV_ROWS), SM90_CONSUMER_REGS),
                   K10Kernel(HS256_DKV_KV_ROWS, HS256_DKV_Q_ROWS, HS256_DKV_STAGES, SM90_THREADS,
                             _hs256_smem("dkv"), wg_acc(hs) + wg_acc(HS256_DKV_Q_ROWS), SM90_CONSUMER_REGS))


def k10_blocks(plan: K10Plan, kernel: str, T: int) -> List[Tuple[int, range]]:
    """The grid rows of one of the plan's K10 kernels ("dq" or "dkv") over
    one head (on "sm90_wide", one head and chunk of output columns: every
    chunk's blocks visit the same tiles), in launch order (``blockIdx.y``):
    each block's own tile and the
    tiles its loop visits. dq owns a Q tile and visits the KV tiles up to
    its diagonal, the last Q tile first; dK/dV owns a KV tile and visits the
    Q tiles at or below it, the first KV tile first (heaviest first)."""
    tiling = {"dq": plan.dq, "dkv": plan.dkv}.get(kernel)
    if tiling is None:
        raise ValueError(f"no K10 kernel {kernel!r} with a tiling in {plan.body!r}")
    own, tile = tiling.own_rows, tiling.tile_rows
    n = -(-T // own)
    if kernel == "dq":
        return [(qt, range(-(-min((qt + 1) * own, T) // tile))) for qt in (n - 1 - y for y in range(n))]
    return [(kt, range(kt * own // tile, -(-T // tile))) for kt in range(n)]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q/k/v (B, H, T, hs) -> (o (B, H, T, hs) in q.dtype, lse (B, H, T, 1) f32)."""
    T, hs = q.shape[-2], q.shape[-1]
    s = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(hs))
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    s = torch.where(causal, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = (p.to(q.dtype).float() @ v.float()) / l
    return o.to(q.dtype), m + torch.log(l)


def check_flash(what: str, *ts: torch.Tensor) -> None:
    """What K4 and K10 take, on any device: contiguous (B, H, T, hs) tensors
    of one shape and one dtype, bf16 or f32, hs a multiple of 128 (the
    head sizes ``flash_route`` sends). Raises ValueError otherwise."""
    B, H, T, hs = ts[0].shape
    if hs <= 0 or hs % HEAD_SIZE_STEP:
        raise ValueError(f"{what} takes a head size that is a multiple of {HEAD_SIZE_STEP}, got {hs}")
    for t in ts:
        if t.dtype != ts[0].dtype or t.dtype not in DTYPES or t.shape != (B, H, T, hs) or not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous bf16 or f32 tensors of one shape and dtype "
                             f"(B, H, T, {hs}), got {t.dtype} {tuple(t.shape)}")


def _check_rows(what: str, *ts: torch.Tensor) -> None:
    check_flash(what, *ts)
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"{what} takes CUDA tensors")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Causal attention over T == S positions, returning (o, lse). A CPU tensor
    takes the plain version; a CUDA tensor launches K4 or raises."""
    if not q.is_cuda:
        return flash_attention_ref(q, k, v)
    _check_rows("K4", q, k, v)
    B, H, T, hs = q.shape
    plan = flash_plan(B, H, T, hs, q.dtype)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T, 1), dtype=torch.float32, device=q.device)
    lib = _build.library("flash_attention", _SIGS)
    err = lib.k4_flash_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, H, T, 1.0 / math.sqrt(hs), int(q.dtype == torch.bfloat16), hs, plan.q_rows,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "K4 flash_attention")
    flash_attention.launches += 1
    return o, lse


flash_attention.launches = 0


def flash_attention_bwd_ref(q, k, v, o, lse, do):
    """The plain K10: (dq, dk, dv) of causal attention in the input dtype, from
    the forward's o and lse. D = rowsum(dO * O) and every sum in f32; P =
    exp(S * scale - lse) under the causal mask; P rounded to ``do.dtype`` for
    dV, dS = P (dP - D) rounded to ``k.dtype`` / ``q.dtype`` for dQ / dK;
    ``scale`` applied after the product, as the Pallas kernels do."""
    T, hs = q.shape[-2], q.shape[-1]
    scale = 1.0 / math.sqrt(hs)
    f32 = torch.float32
    dd = (do.to(f32) * o.to(f32)).sum(dim=-1, keepdim=True)
    s = (q.to(f32) @ k.to(f32).transpose(-1, -2)) * scale
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    p = torch.exp(torch.where(causal, s, torch.full_like(s, NEG_INF)) - lse)
    dp = do.to(f32) @ v.to(f32).transpose(-1, -2)
    ds = p * (dp - dd)
    dv = p.to(do.dtype).to(f32).transpose(-1, -2) @ do.to(f32)
    dq = (ds.to(k.dtype).to(f32) @ k.to(f32)) * scale
    dk = (ds.to(q.dtype).to(f32).transpose(-1, -2) @ q.to(f32)) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_backward_dq(q, k, v, o, lse, do):
    """K10's first kernel pair on the card: D = rowsum(dO * O), then dq.
    Returns (dq, dd), dd (B, H, T, 1) f32 for ``flash_backward_dkv``."""
    _check_rows("K10", q, k, v, o, do)
    B, H, T, hs = q.shape
    if lse.dtype != torch.float32 or lse.shape != (B, H, T, 1) or not lse.is_contiguous():
        raise ValueError("K10 takes the forward's lse, contiguous (B, H, T, 1) f32")
    dq = torch.empty_like(q)
    dd = torch.empty_like(lse)
    lib = _build.library("flash_attention", _SIGS)
    err = lib.k10_flash_backward_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dd.data_ptr(), dq.data_ptr(), B, H, T, 1.0 / math.sqrt(hs), int(q.dtype == torch.bfloat16), hs,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "K10 flash_backward_dq")
    flash_backward_dq.launches += 1
    return dq, dd


def flash_backward_dkv(q, k, v, do, lse, dd):
    """K10's second kernel on the card: (dk, dv) from the dd of
    ``flash_backward_dq``."""
    _check_rows("K10", q, k, v, do)
    B, H, T, hs = q.shape
    for t in (lse, dd):
        if t.dtype != torch.float32 or t.shape != (B, H, T, 1) or not t.is_contiguous():
            raise ValueError("K10 takes lse and dd contiguous (B, H, T, 1) f32")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _build.library("flash_attention", _SIGS)
    err = lib.k10_flash_backward_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), dd.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, H, T, 1.0 / math.sqrt(hs), int(q.dtype == torch.bfloat16), hs,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "K10 flash_backward_dkv")
    flash_backward_dkv.launches += 1
    return dk, dv


flash_backward_dq.launches = 0
flash_backward_dkv.launches = 0


def flash_attention_backward(q, k, v, o, lse, do):
    """(dq, dk, dv) of causal attention. A CPU tensor takes the plain version;
    a CUDA tensor launches K10 (both kernels) or raises."""
    if not q.is_cuda:
        return flash_attention_bwd_ref(q, k, v, o, lse, do)
    dq, dd = flash_backward_dq(q, k, v, o, lse, do)
    dk, dv = flash_backward_dkv(q, k, v, do, lse, dd)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Causal attention with a flash backward: K4 forward, K10 backward on the
    card (the plain versions on the CPU or with ``plain``). Takes contiguous
    q, k, v (B, H, T, hs) and returns o."""

    @staticmethod
    def forward(ctx, q, k, v, plain: bool = False):
        o, lse = (flash_attention_ref if plain else flash_attention)(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.plain = plain
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = flash_attention_bwd_ref if ctx.plain else flash_attention_backward
        dq, dk, dv = bwd(q, k, v, o, lse, do.contiguous())
        return dq, dk, dv, None
