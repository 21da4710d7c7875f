"""K3 at M = 1, the int4 single-token body of ``csrc/gemv4_sm90.cuh``: its
launch plan (``ops.quant_matmul.gemv4_plan``, a pure function of N, K and
the SM count), the group each logical row is scaled with, a step-for-step
model of the kernel in plain PyTorch (the (strip, split) blocks, the mma's
octet sums of each plane, the group flushes with the zero term, the
workspace slots and the last arrival's merge in split order) held to
``matmul_int4_ref`` with the blocks in any order, and, on the card (skipped
without one), the kernel against its plain version, its bits across
launches and streams, a launch that must see the x written by the kernel
just before it (programmatic dependent launch), and one kernel and no
allocation but the output a call.

Tolerances. bf16: the model and the kernel sum exact bf16(x) * nibble
products in f32 and apply the f32 scale and zero to the group's sums, where
the plain version rounds every weight to bf16(q * scale + zero) first; both
round the output to bf16 once: ``chip_smoke.py``'s TOL["K3"] (2e-2, 2e-2).
f32: the same exact products (x in three exact bf16 parts) against the plain
version's f32 weights, sums in another order: 1e-4 relative and absolute
(``chip_smoke.py`` TOL_F32; outputs O(1))."""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lit_llama_tpu_torch.ops import decode_attention as tda
from lit_llama_tpu_torch.ops import quant_matmul as tqm
from lit_llama_tpu_torch.ops.linear import quantize_int4

SOURCE = Path(tqm.__file__).resolve().parent.parent / "csrc" / "gemv4_sm90.cuh"
LINEARS_7B = [("c_attn", 4096, 12288), ("attn.c_proj", 4096, 4096), ("c_fc12", 4096, 22016),
              ("mlp.c_proj", 11008, 4096), ("lm_head", 4096, 32000)]
# N % 256 != 0 (a strip of 16 columns; 1032: rows 8-byte aligned only); one
# strip, many splits; odd group counts a plane (768 at gs 128: 3; 11008: 43);
# few steps; a wide N past one wave (one split)
SHAPES = [(1024, 1040), (768, 1032), (11008, 256), (256, 8192), (128, 70000), (768, 384)]
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}


def _held(got, want, dtype):
    atol, rtol = TOL[dtype]
    got, want = got.float(), want.float()
    return bool(torch.isfinite(got).all()) and bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def _operands(K, N, gs, dtype, seed, device="cpu", std=0.02):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.normal(size=(K, N)) * std).astype(np.float32))
    q = quantize_int4(w, -1 if gs == K else gs)
    x = torch.from_numpy(rng.normal(size=(1, K)).astype(np.float32)).to(dtype)
    return x.to(device), q["qw"].to(device), q["qscale"].to(device), q["qzero"].to(device)


def gemv4_smem(plan, dtype):
    """A block's dynamic shared memory (csrc/gemv4_sm90.cuh smem_bytes): the
    warps' 1 KB tiles, x's bf16 parts (three of an f32 x) in both planes,
    its octet sums and its group sums."""
    nb = 3 if dtype == torch.float32 else 1
    tiles = tqm.GEMV4_THREADS // 32 * tqm.GEMV4_ROWS * tqm.GEMV4_WCOLS
    return tiles + nb * 2 * plan.rows * 2 + 2 * (plan.rows // 8) * 4 + 2 * (plan.rows // 8 + 2) * 4


def test_gemv4_constants_mirror_the_source():
    """The plan's constants are the kernel's: threads, columns a warp and a
    strip, rows a step, steps in flight, blocks an SM, and its shared
    memory."""
    text = SOURCE.read_text()
    got = {k: int(v) for k, v in re.findall(r"constexpr int ([A-Z_]+) = (\d+);", text)}
    assert (got["THREADS"], got["WCOLS"], got["ROWS"], got["STAGES"], got["BLOCKS_PER_SM"]) == (
        tqm.GEMV4_THREADS, tqm.GEMV4_WCOLS, tqm.GEMV4_ROWS, tqm.GEMV4_STAGES, tqm.GEMV4_BLOCKS_PER_SM)
    assert "constexpr int COLS = WARPS * WCOLS;" in text and "constexpr int WARPS = THREADS / 32;" in text
    assert tqm.GEMV4_COLS == tqm.GEMV4_THREADS // 32 * tqm.GEMV4_WCOLS
    assert "constexpr int TILE_BYTES = WARPS * STAGE_BYTES;" in text and "STAGE_BYTES = ROWS * WCOLS;" in text
    assert "(size_t)TILE_BYTES + (size_t)nb * 2 * rows * 2 + (size_t)2 * (rows / 8) * 4 + " \
           "(size_t)2 * (rows / 8 + 2) * 4" in text
    assert "__launch_bounds__(THREADS, BLOCKS_PER_SM)" in text
    # the split of gemv4_split_rows, and block b = strip b % strips of split b / strips
    assert "s0 = (int)((long long)split * steps / splits)" in text
    assert "strip = blockIdx.x % strips, split = blockIdx.x / strips" in text
    assert "pdl_wait();" in text and "launch_pdl(" in text
    assert "splitk" not in text.split("#pragma once")[1]  # the splits merge in the kernel
    assert "gs % 8" in text and "gs % ROWS == 0" in text  # gemv4_takes, and the step-group bodies


@pytest.mark.parametrize("name,K,N", LINEARS_7B + [(f"{K}x{N}", K, N) for K, N in SHAPES],
                         ids=[n for n, _, _ in LINEARS_7B] + [f"{K}x{N}" for K, N in SHAPES])
def test_gemv4_plan_covers_every_packed_row_once(name, K, N):
    """The splits follow one another and cover the K/2 packed rows once,
    none empty and none shorter than GEMV4_MIN_STEPS unless K is; they
    differ by one step at most and the largest is ``rows``; the blocks fit
    one wave of the H100 (and fill most of it at the 7B linears); the
    workspace holds a partial a block and there is a counter a strip, which
    fit the stream's buffers; a block's shared memory fits two an SM."""
    plan = tqm.gemv4_plan(N, K)
    assert plan.strips == -(-N // tqm.GEMV4_COLS) and plan.steps * tqm.GEMV4_ROWS == K // 2
    assert plan.blocks == plan.strips * plan.splits
    rows = [tqm.gemv4_split_rows(plan, z) for z in range(plan.splits)]
    assert rows[0][0] == 0 and rows[-1][1] == K // 2
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))  # no gap, no overlap
    sizes = [(e - b) // tqm.GEMV4_ROWS for b, e in rows]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1 and max(sizes) * tqm.GEMV4_ROWS == plan.rows
    assert plan.splits == 1 or min(sizes) >= tqm.GEMV4_MIN_STEPS
    slots = tqm.GEMV4_BLOCKS_PER_SM * tqm.H100_SMS
    assert plan.blocks <= slots or plan.splits == 1
    if (name, K, N) in LINEARS_7B:
        assert plan.blocks > 0.9 * slots
    for dtype in (torch.bfloat16, torch.float32):
        assert gemv4_smem(plan, dtype) <= 227 * 1024 // tqm.GEMV4_BLOCKS_PER_SM
    if plan.splits > 1:
        assert plan.ws_floats == plan.blocks * tqm.GEMV4_COLS and plan.counters == plan.strips
        assert tda.arrival_counters(plan.counters, "cpu").numel() >= plan.counters
        ws = tda.stream_buffer(plan.ws_floats, torch.float32, "cpu")
        assert ws.dtype == torch.float32 and ws.numel() >= plan.ws_floats
    else:
        assert plan.ws_floats == plan.counters == 0


def test_gemv4_plan_takes_no_m_dtype_or_stream():
    """The plan is a function of N, K and the SM count only, so the same
    (N, K) gives the same splits (and the same order of every sum) in either
    compute dtype and on any stream of a card."""
    assert list(inspect.signature(tqm.gemv4_plan).parameters) == ["N", "K", "sm_count"]
    for _, K, N in LINEARS_7B:
        assert tqm.gemv4_plan(N, K) == tqm.gemv4_plan(N, K, tqm.H100_SMS)
        assert tqm.gemv4_plan(N, K, 114).blocks <= 2 * 114  # another card: another wave
    with pytest.raises(ValueError):
        tqm.gemv4_plan(0, 4096)
    assert [tqm.gemv4_takes(gs) for gs in (8, 16, 32, 64, 128, 4096, 4, 12)] == [True] * 6 + [False] * 2


def group_walk(plan, K, gs, split):
    """The kernel's bookkeeping of one split: per packed row of the split,
    the group each plane's sums go to (the countdown ``left`` and the group
    index ``grp`` of the kernel, flushed after each octet)."""
    Kh = K // 2
    r0, r1 = tqm.gemv4_split_rows(plan, split)
    nr = r1 - r0
    left = [min(gs - r0 % gs, nr), min(gs - (Kh + r0) % gs, nr)]
    grp = [r0 // gs, (Kh + r0) // gs]
    seen = []
    for o in range(nr // 8):
        seen += [(grp[0], grp[1])] * 8
        for plane in (0, 1):
            left[plane] -= 8
            if left[plane] == 0 and nr - 8 * (o + 1) > 0:
                left[plane] = min(gs, nr - 8 * (o + 1))
                grp[plane] += 1
    return r0, seen


@pytest.mark.parametrize("K,gs", [(4096, 8), (4096, 32), (4096, 128), (4096, 4096), (768, 128), (11008, 128),
                                  (1536, 8), (768, 24), (384, 384)],
                         ids=["gs8", "gs32", "gs128", "gsK", "odd-groups", "mlp.c_proj", "gs8-1536", "gs24",
                              "one-group"])
def test_gemv4_every_logical_row_takes_its_group(K, gs):
    """Every logical row k (low plane: packed row k; high plane: packed row
    k - K/2) is scaled with group k // gs, over every split of the plan,
    including a group that straddles K/2 (an odd group count) and gs = K."""
    for N in (256, 4096, 70000):  # 264, 16 and one split(s)
        plan = tqm.gemv4_plan(N, K)
        for z in range(plan.splits):
            r0, seen = group_walk(plan, K, gs, z)
            for i, (glo, ghi) in enumerate(seen):
                r = r0 + i
                assert glo == r // gs and ghi == (K // 2 + r) // gs, (N, z, r)


def kernel_model(x, qw, qs, qz, plan, dtype, orders):
    """gemv4_kernel in plain PyTorch, step for step, for every column at
    once: each split walks its octets of 8 packed rows; an mma adds each
    plane's 8 exact products (x or, in f32, each of its three bf16 parts,
    times the nibble: 128 + q in bf16, q in f32) to the plane's f32 sum D
    (one rounding; the sum of 8 exact products is exact in f64); where a
    plane's group ends the block adds s * D + (z - 128 s) * gx (bf16; f32: s
    * D1+2+3 + z * gx) to its f32 total, gx the sum of x over the group's rows
    in the split (each octet's 8 rows in order, then the octets in order).
    With one split that is the output; else each block's partial goes to its
    slot and the last block of the strip to arrive, for each arrival order
    in ``orders``, adds the slots in split order. Returns one output per
    order; an unwritten slot reads NaN."""
    Kh, N = qw.shape
    K = 2 * Kh
    gs = K // qs.shape[0]
    f32 = dtype == torch.float32
    bias = 0.0 if f32 else 128.0
    C, strips, splits = tqm.GEMV4_COLS, plan.strips, plan.splits
    Np = strips * C
    q = torch.zeros(2, Kh, Np, dtype=torch.float64)
    q[0, :, :N], q[1, :, :N] = (qw & 0xF).double(), (qw >> 4).double()
    s_all, z_all = torch.zeros(qs.shape[0], Np), torch.zeros(qs.shape[0], Np)
    s_all[:, :N], z_all[:, :N] = qs.float(), qz.float()
    xf = x.reshape(-1).float()
    if f32:  # x = x1 + x2 + x3, each bf16, exactly
        p1 = xf.to(torch.bfloat16).float()
        p2 = (xf - p1).to(torch.bfloat16).float()
        p3 = ((xf - p1) - p2).to(torch.bfloat16).float()
        parts = [p1, p2, p3]
        assert torch.equal((p1.double() + p2.double()) + p3.double(), xf.double())
    else:
        parts = [xf]
    partial = torch.full((plan.blocks, C), float("nan"))
    out_one = None
    for split in range(splits):
        r0, r1 = tqm.gemv4_split_rows(plan, split)
        nr = r1 - r0
        D = torch.zeros(len(parts), 2, Np)
        acc = torch.zeros(Np)
        left = [min(gs - r0 % gs, nr), min(gs - (Kh + r0) % gs, nr)]
        grp = [r0 // gs, (Kh + r0) // gs]
        osum = torch.zeros(2, nr // 8)
        for plane in (0, 1):
            v = xf[plane * Kh + r0: plane * Kh + r1].reshape(-1, 8)
            s = v[:, 0].clone()
            for e in range(1, 8):
                s = s + v[:, e]
            osum[plane] = s

        def gx_of(plane, gi):
            lo = max(gi * gs - plane * Kh, r0) - r0
            hi = min((gi + 1) * gs - plane * Kh, r1) - r0
            s = osum[plane, lo // 8].clone()
            for o in range(lo // 8 + 1, hi // 8):
                s = s + osum[plane, o]
            return s

        for o in range(nr // 8):
            rows = slice(r0 + 8 * o, r0 + 8 * o + 8)
            for plane in (0, 1):
                xr = slice(plane * Kh + r0 + 8 * o, plane * Kh + r0 + 8 * o + 8)
                for p, xp in enumerate(parts):
                    prod = ((bias + q[plane, rows]) * xp[xr].double()[:, None]).sum(0)
                    D[p, plane] = (D[p, plane].double() + prod).float()
            for plane in (0, 1):
                left[plane] -= 8
                if left[plane]:
                    continue
                v = D[0, plane]
                if f32:
                    v = (v + D[1, plane]) + D[2, plane]
                s, z = s_all[grp[plane]], z_all[grp[plane]]
                zz = (z.double() - bias * s.double()).float()
                inner = (s.double() * v.double() + (zz * gx_of(plane, grp[plane])).double()).float()
                acc = acc + inner
                D[:, plane] = 0.0
                if nr - 8 * (o + 1) > 0:
                    left[plane] = min(gs, nr - 8 * (o + 1))
                    grp[plane] += 1
        if splits == 1:
            out_one = acc
        for strip in range(strips):
            partial[split * strips + strip] = acc[strip * C:(strip + 1) * C]
    outs = []
    for order in orders:
        if splits == 1:
            outs.append(out_one[:N].reshape(1, N).to(dtype))
            continue
        ws = torch.full((plan.blocks, C), float("nan"))
        counter = [0] * strips
        out = torch.full((Np,), float("nan"))
        for b in order:
            strip = b % strips
            ws[b] = partial[b]
            counter[strip] += 1
            if counter[strip] == splits:
                v = ws[strip]
                for z in range(1, splits):
                    v = v + ws[z * strips + strip]
                out[strip * C:(strip + 1) * C] = v
                counter[strip] = 0
        assert counter == [0] * strips  # left at zero for the next launch
        outs.append(out[:N].reshape(1, N).to(dtype))
    return outs


MODEL_CASES = [(4096, 4096, 128), (1024, 1040, 32), (768, 1032, 8), (768, 384, 128), (1024, 1040, 1024),
               (1536, 512, 16), (11008, 256, 128), (768, 512, 24)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("K,N,gs", MODEL_CASES, ids=[f"{K}x{N}-gs{gs}" for K, N, gs in MODEL_CASES])
def test_gemv4_kernel_order_matches_plain(K, N, gs, dtype):
    """The kernel's order of sums and arithmetic, modelled, equals
    matmul_int4_ref within the dtype's tolerance, and gives the same bits
    whichever block arrives last (blocks in order, reversed, shuffled)."""
    x, qw, qs, qz = _operands(K, N, gs, dtype, K + N + gs)
    plan = tqm.gemv4_plan(N, K)
    want = tqm.matmul_int4_ref(x, qw, qs, qz, dtype)
    blocks = list(range(plan.blocks))
    shuffled = list(np.random.default_rng(K * N).permutation(plan.blocks))
    got, *others = kernel_model(x, qw, qs, qz, plan, dtype, [blocks, blocks[::-1], shuffled])
    assert got.shape == want.shape and _held(got, want, dtype), \
        f"max err {float((got.float() - want.float()).abs().max()):.3g}"
    assert all(torch.equal(o, got) for o in others)


def test_span_tool_instruments_the_int4_body():
    """tools/spans.py int4 finds every anchor of the M = 1 body (the wait for
    the kernel before, x's staging, the loads' wait, the fragments, the
    products, the group flushes, the merge), puts its totals before the
    kernel's end and the table after the header's guard."""
    from lit_llama_tpu_torch.tools import spans

    text = SOURCE.read_text()
    source = next(s for s in spans.INT4_SOURCES if s.file == SOURCE.name)
    out = spans.instrument(text, source)
    assert out.index("#pragma once") < out.index("g_spans[8][16]") < out.index("gemv4_kernel(")
    out = out.replace(spans.HEAD, "")
    assert out.count("SPAN_BEGIN(") == 1 and out.count("SPAN_END(") >= 1
    assert len(spans.INT4_SPANS) <= 13
    with pytest.raises(ValueError, match="anchors not found"):
        spans.instrument(text, source._replace(rules=(("no_such_line(", "SPAN(1)", "after"),)))


# ---- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


CARD_CASES = [(K, N, 128) for _, K, N in LINEARS_7B] + [(4096, 12288, 32), (11008, 4096, 32), (4096, 4096, 4096),
                                                          (1024, 1040, 128), (768, 1032, 8), (768, 384, 128),
                                                          (1536, 1040, 16), (128, 70000, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("K,N,gs", CARD_CASES, ids=[f"{K}x{N}-gs{gs}" for K, N, gs in CARD_CASES])
def test_gemv4_kernel_matches_plain_on_the_card(cuda, K, N, gs, dtype):
    x, qw, qs, qz = _operands(K, N, gs, dtype, K + N, cuda)
    before, before1 = tqm.matmul_int4.launches, tqm.matmul_int4.gemv_launches
    got = tqm.matmul_int4(x, qw, qs, qz, dtype)
    want = tqm.matmul_int4_ref(x, qw, qs, qz, dtype)
    torch.cuda.synchronize()
    assert tqm.matmul_int4.launches == before + 1 and tqm.matmul_int4.gemv_launches == before1 + 1
    assert got.dtype == dtype and got.shape == (1, N)
    assert _held(got, want, dtype), f"max err {float((got.float() - want.float()).abs().max()):.3g}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gemv4_kernel_bits_repeat_across_launches_and_streams_on_the_card(cuda, dtype):
    """Two launches give the same bits; so do launches on two streams at once
    (each stream has its own workspace and counters)."""
    for K, N, gs in ((4096, 4096, 128), (11008, 4096, 128), (1024, 1040, 32)):
        x, qw, qs, qz = _operands(K, N, gs, dtype, 7 * K + N, cuda)
        first = tqm.matmul_int4(x, qw, qs, qz, dtype)
        assert torch.equal(first, tqm.matmul_int4(x, qw, qs, qz, dtype)), (K, N)
        streams = [torch.cuda.Stream(cuda) for _ in range(2)]
        outs = [[], []]
        torch.cuda.synchronize()
        for _ in range(8):
            for s, o in zip(streams, outs):
                with torch.cuda.stream(s):
                    o.append(tqm.matmul_int4(x, qw, qs, qz, dtype))
        torch.cuda.synchronize()
        assert all(torch.equal(first, y) for o in outs for y in o), (K, N)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gemv4_kernel_sees_the_x_written_just_before_on_the_card(cuda, dtype):
    """Under programmatic dependent launch K3 starts before the kernel ahead
    of it ends: x must be read after it. x is written by the kernel launched
    just before each K3 (a copy into the same buffer, and K3 itself: a chain
    of square linears, each output the next input), with no synchronisation
    between; every output must be the plain version of its own input. The
    weight's std is 1 / sqrt(K), so each output keeps its input's scale: the
    plain version rounds every weight to bf16, and its own error grows with
    |x| (with std 0.02, |x| grows 1.3x a link)."""
    K = N = 4096
    _, qw, qs, qz = _operands(K, N, 128, dtype, 11, cuda, std=K ** -0.5)
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.empty(1, K, dtype=dtype, device=cuda)
    inputs = [torch.randn(1, K, generator=g, device=cuda).to(dtype) for _ in range(6)]
    torch.cuda.synchronize()
    outs = []
    for new in inputs:
        x.copy_(new)  # the kernel just before K3 writes its x
        outs.append(tqm.matmul_int4(x, qw, qs, qz, dtype))
    chain = [inputs[0]]
    for _ in range(6):  # K3 after K3: each reads the output of the one before
        chain.append(tqm.matmul_int4(chain[-1], qw, qs, qz, dtype))
    torch.cuda.synchronize()
    for a, y in zip(inputs, outs):
        assert _held(y, tqm.matmul_int4_ref(a, qw, qs, qz, dtype), dtype)
    for a, y in zip(chain, chain[1:]):
        assert _held(y, tqm.matmul_int4_ref(a, qw, qs, qz, dtype), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gemv4_kernel_one_kernel_and_no_workspace_a_call_on_the_card(cuda, dtype):
    """A call launches one kernel (the merge is inside it) and allocates
    only its output: the workspace and the counters are kept across calls."""
    from torch.profiler import ProfilerActivity, profile

    x, qw, qs, qz = _operands(4096, 12288, 128, dtype, 5, cuda)
    tqm.matmul_int4(x, qw, qs, qz, dtype)
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats(cuda)["allocation.all.allocated"]
    y = tqm.matmul_int4(x, qw, qs, qz, dtype)
    assert torch.cuda.memory_stats(cuda)["allocation.all.allocated"] == allocs + 1
    del y
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            tqm.matmul_int4(x, qw, qs, qz, dtype)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 5 and all("gemv4_kernel" in n for n in names), names
