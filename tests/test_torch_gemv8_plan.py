"""K6 at M = 1, the int8 weight stream of ``csrc/gemv_int8_sm90.cuh``: its
launch plan (``ops.quant_matmul.gemv8_plan``, a pure function of N, K and
the SM count), a step-for-step model of the kernel in plain PyTorch (the
(strip, split) blocks, the workspace slots and the last arrival's merge in
split order) held to ``matmul_int8_ref`` with the blocks in any order,
and, on the card (skipped without one), the kernel against its plain version,
its bits across launches and streams, a launch that must see the x written
by the kernel just before it (programmatic dependent launch), and one kernel
and no allocation but the output a call.

Tolerances. f32: the model and the plain version sum the same exact products
in another order, 1e-4 relative and absolute (outputs O(1)); so does the
kernel on the card (``chip_smoke.py`` TOL_F32). bf16: both round the same f32
sum times the scale once, ``chip_smoke.py``'s TOL["K6"] (2e-2, 2e-2)."""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lit_llama_tpu_torch.ops import decode_attention as tda
from lit_llama_tpu_torch.ops import quant_matmul as tqm
from lit_llama_tpu_torch.ops.linear import quantize_int8

SOURCE = Path(tqm.__file__).resolve().parent.parent / "csrc" / "gemv_int8_sm90.cuh"
LINEARS_7B = [("c_attn", 4096, 12288), ("attn.c_proj", 4096, 4096), ("c_fc12", 4096, 22016),
              ("mlp.c_proj", 11008, 4096), ("lm_head", 4096, 32000)]
# K % 64 != 0 and N % 128 != 0 (a short last step, a strip of 16 columns);
# one strip and K = 11008 (172 splits); few steps a strip; one step a strip
# (one split: no workspace); more strips than a wave holds; tiny
SHAPES = [(1000, 1040), (4104, 4112), (11008, 256), (256, 8192), (64, 65536), (16, 32768), (8, 16), (24, 48)]
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}


def _held(got, want, dtype):
    atol, rtol = TOL[dtype]
    got, want = got.float(), want.float()
    return bool(torch.isfinite(got).all()) and bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def _operands(K, N, dtype, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(K, N, generator=g) * 0.02 * (0.5 + 1.5 * torch.rand(1, N, generator=g))
    q = quantize_int8(w)
    x = torch.randn(1, K, generator=g).to(dtype)
    return x.to(device), q["qw"].to(device), q["qscale"].to(device)


def test_gemv8_constants_mirror_the_source():
    """The plan's constants are the kernel's: strip, step, threads, ring, blocks an SM."""
    text = SOURCE.read_text()
    got = {k: int(v) for k, v in re.findall(r"constexpr int ([A-Z_]+) = (\d+);", text)}
    assert (got["THREADS"], got["COLS"], got["STAGES"], got["BLOCKS_PER_SM"]) == (
        tqm.GEMV8_THREADS, tqm.GEMV8_COLS, tqm.GEMV8_STAGES, tqm.GEMV8_BLOCKS_PER_SM)
    assert tqm.GEMV8_ROWS == tqm.GEMV8_THREADS // (tqm.GEMV8_COLS // 32)
    assert "constexpr int ROWS = THREADS / LANES;" in text and "constexpr int LANES = COLS / 32;" in text
    assert "__launch_bounds__(THREADS, BLOCKS_PER_SM)" in text
    # the split of gemv8_split_rows, and block b = strip b % strips of split b / strips
    assert "k0 = (int)((long long)split * steps / splits)" in text
    assert "strip = blockIdx.x % strips, split = blockIdx.x / strips" in text
    assert "pdl_wait();" in text and "launch_pdl(" in text
    assert "splitk" not in text  # the splits merge in the kernel


@pytest.mark.parametrize("name,K,N", LINEARS_7B + [(f"{K}x{N}", K, N) for K, N in SHAPES],
                         ids=[n for n, _, _ in LINEARS_7B] + [f"{K}x{N}" for K, N in SHAPES])
def test_gemv8_plan_covers_every_row_once(name, K, N):
    """The splits follow one another and cover K's steps once, none empty and
    none shorter than GEMV8_MIN_STEPS unless K is; they differ by one step
    at most; the blocks fit one wave of the H100 (and fill most of it at the
    7B linears); the workspace holds a partial a block and there is a counter
    a strip, which fits the arrival counters."""
    plan = tqm.gemv8_plan(N, K)
    assert plan.strips == -(-N // tqm.GEMV8_COLS) and plan.steps == -(-K // tqm.GEMV8_ROWS)
    assert plan.blocks == plan.strips * plan.splits
    rows = [tqm.gemv8_split_rows(plan, z) for z in range(plan.splits)]
    assert rows[0][0] == 0 and rows[-1][1] == plan.steps * tqm.GEMV8_ROWS >= K
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))  # no gap, no overlap
    sizes = [(e - b) // tqm.GEMV8_ROWS for b, e in rows]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert plan.splits == 1 or min(sizes) >= tqm.GEMV8_MIN_STEPS
    slots = tqm.GEMV8_BLOCKS_PER_SM * tqm.H100_SMS
    assert plan.blocks <= slots or plan.splits == 1
    if (name, K, N) in LINEARS_7B:
        assert plan.blocks > 0.9 * slots
    if plan.splits > 1:
        assert plan.ws_floats == plan.blocks * tqm.GEMV8_COLS and plan.counters == plan.strips
        assert tda.arrival_counters(plan.counters, "cpu").numel() >= plan.counters
        ws = tda.stream_buffer(plan.ws_floats, torch.float32, "cpu")
        assert ws.dtype == torch.float32 and ws.numel() >= plan.ws_floats
    else:
        assert plan.ws_floats == plan.counters == 0


def test_gemv8_plan_takes_no_m_dtype_or_stream():
    """The plan is a function of N, K and the SM count only, so the same
    (N, K) gives the same splits (and the same order of every sum) at any M,
    in either compute dtype and on any stream of a card."""
    assert list(inspect.signature(tqm.gemv8_plan).parameters) == ["N", "K", "sm_count"]
    for _, K, N in LINEARS_7B:
        assert tqm.gemv8_plan(N, K) == tqm.gemv8_plan(N, K, tqm.H100_SMS)
        assert tqm.gemv8_plan(N, K, 114).blocks <= 2 * 114  # another card: another wave
    with pytest.raises(ValueError):
        tqm.gemv8_plan(0, 4096)


def kernel_model(x, qw, qscale, plan, order, dtype):
    """gemv8_kernel in plain PyTorch, step for step: each block (a strip and
    a K split) with 32 row lanes summing their rows in turn (an f64 product
    and sum rounded to f32 for an FMA), then a warp's four rows added (lane l
    with l ^ 8, then with l ^ 16) and the warps in order; with one split that is the
    strip's output, else the partial goes to the block's slot and the last
    block of the strip to arrive adds the slots in split order. The blocks
    go in ``order``; an unwritten slot reads NaN."""
    K, N = qw.shape
    R, C, steps, splits, strips = tqm.GEMV8_ROWS, tqm.GEMV8_COLS, plan.steps, plan.splits, plan.strips
    xp = torch.zeros(steps * R, dtype=torch.float64)
    xp[:K] = x.reshape(-1).double()
    wp = torch.zeros(steps * R, strips * C, dtype=torch.float64)
    wp[:K, :N] = qw.double()
    sc = torch.zeros(strips * C)
    sc[:N] = qscale.reshape(-1).float()
    ws = torch.full((plan.blocks, C), float("nan"))
    counter = [0] * strips
    out = torch.full((strips * C,), float("nan"))
    for b in order:
        strip, split = b % strips, b // strips
        cols = slice(strip * C, strip * C + C)
        lo, hi = tqm.gemv8_split_rows(plan, split)
        acc = torch.zeros(R, C)
        for k in range(lo, hi, R):
            acc = (xp[k:k + R, None] * wp[k:k + R, cols] + acc.double()).float()
        quads = (acc[0::4] + acc[1::4]) + (acc[2::4] + acc[3::4])
        part = quads[0]
        for w8 in range(1, R // 4):
            part = part + quads[w8]
        if splits == 1:
            out[cols] = part * sc[cols]
            continue
        ws[b] = part
        counter[strip] += 1
        if counter[strip] == splits:
            v = ws[strip]
            for z in range(1, splits):
                v = v + ws[z * strips + strip]
            out[cols] = v * sc[cols]
            counter[strip] = 0
    assert counter == [0] * strips  # left at zero for the next launch
    return out[:N].reshape(1, N).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("K,N", SHAPES + [(4096, 4096)], ids=[f"{K}x{N}" for K, N in SHAPES + [(4096, 4096)]])
def test_gemv8_kernel_order_matches_plain(K, N, dtype):
    """The kernel's order of sums, modelled, equals matmul_int8_ref within
    the dtype's tolerance, and gives the same bits whichever block arrives
    last (blocks in order, reversed, shuffled)."""
    x, qw, qscale = _operands(K, N, dtype, K + N)
    plan = tqm.gemv8_plan(N, K)
    want = tqm.matmul_int8_ref(x, qw, qscale, dtype)
    blocks = list(range(plan.blocks))
    got = kernel_model(x, qw, qscale, plan, blocks, dtype)
    assert got.shape == want.shape and _held(got, want, dtype)
    shuffled = list(np.random.default_rng(K * N).permutation(plan.blocks))
    for order in (blocks[::-1], shuffled):
        assert torch.equal(kernel_model(x, qw, qscale, plan, order, dtype), got)


def test_span_tool_instruments_the_int8_body():
    """tools/spans.py int8 finds every anchor of the persistent body (the
    wait for the kernel before, the first bytes, the ring, the strip ends,
    the merge), puts its totals before the kernel's end and the table after
    the header's guard."""
    from lit_llama_tpu_torch.tools import spans

    text = SOURCE.read_text()
    source = next(s for s in spans.INT8_SOURCES if s.file == SOURCE.name)
    out = spans.instrument(text, source)
    assert out.index("#pragma once") < out.index("g_spans[8][16]") < out.index("gemv8_kernel(")
    out = out.replace(spans.HEAD, "")
    assert out.count("SPAN(") == len(source.rules) + 1 and out.count("SPAN_END(") == 1
    assert len(spans.INT8_SPANS["gemv8_kernel("]) == len(source.rules) + 1 <= 13
    with pytest.raises(ValueError, match="anchors not found"):
        spans.instrument(text, source._replace(rules=(("no_such_line(", "SPAN(1)", "after"),)))


# ---- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


CARD_SHAPES = [(K, N) for _, K, N in LINEARS_7B] + [(1000, 1040), (4104, 4112), (11008, 256), (16, 32768), (8, 16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("K,N", CARD_SHAPES, ids=[f"{K}x{N}" for K, N in CARD_SHAPES])
def test_gemv8_kernel_matches_plain_on_the_card(cuda, K, N, dtype):
    x, qw, qscale = _operands(K, N, dtype, K + N, cuda)
    before = tqm.matmul_int8.launches
    got = tqm.matmul_int8(x, qw, qscale, dtype)
    want = tqm.matmul_int8_ref(x, qw, qscale, dtype)
    torch.cuda.synchronize()
    assert tqm.matmul_int8.launches == before + 1 and got.dtype == dtype and got.shape == (1, N)
    assert _held(got, want, dtype), f"max err {float((got.float() - want.float()).abs().max()):.3g}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gemv8_kernel_bits_repeat_across_launches_and_streams_on_the_card(cuda, dtype):
    """Two launches give the same bits; so do launches on two streams at once
    (each stream has its own workspace and counters)."""
    for K, N in ((4096, 4096), (11008, 4096), (1000, 1040)):
        x, qw, qscale = _operands(K, N, dtype, 7 * K + N, cuda)
        first = tqm.matmul_int8(x, qw, qscale, dtype)
        assert torch.equal(first, tqm.matmul_int8(x, qw, qscale, dtype)), (K, N)
        streams = [torch.cuda.Stream(cuda) for _ in range(2)]
        outs = [[], []]
        torch.cuda.synchronize()
        for _ in range(8):
            for s, o in zip(streams, outs):
                with torch.cuda.stream(s):
                    o.append(tqm.matmul_int8(x, qw, qscale, dtype))
        torch.cuda.synchronize()
        assert all(torch.equal(first, y) for o in outs for y in o), (K, N)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gemv8_kernel_sees_the_x_written_just_before_on_the_card(cuda, dtype):
    """Under programmatic dependent launch K6 starts before the kernel ahead
    of it ends: x must be read after it. x is written by the kernel launched
    just before each K6 (a copy into the same buffer, and K6 itself: a chain
    of square linears, each output the next input), with no synchronisation
    between; every output must be the plain version of its own input."""
    K = N = 4096
    _, qw, qscale = _operands(K, N, dtype, 11, cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.empty(1, K, dtype=dtype, device=cuda)
    inputs = [torch.randn(1, K, generator=g, device=cuda).to(dtype) for _ in range(6)]
    torch.cuda.synchronize()
    seen, outs = [], []
    for new in inputs:
        x.copy_(new)  # the kernel just before K6 writes its x
        outs.append(tqm.matmul_int8(x, qw, qscale, dtype))
        seen.append(new)
    chain = [inputs[0]]
    for _ in range(6):  # K6 after K6: each reads the output of the one before
        chain.append(tqm.matmul_int8(chain[-1], qw, qscale, dtype))
    torch.cuda.synchronize()
    for a, y in zip(seen, outs):
        assert _held(y, tqm.matmul_int8_ref(a, qw, qscale, dtype), dtype)
    for a, y in zip(chain, chain[1:]):
        assert _held(y, tqm.matmul_int8_ref(a, qw, qscale, dtype), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gemv8_kernel_one_kernel_and_no_workspace_a_call_on_the_card(cuda, dtype):
    """A call launches one kernel (the merge is inside it) and allocates
    only its output: the workspace and the counters are kept across calls."""
    from torch.profiler import ProfilerActivity, profile

    x, qw, qscale = _operands(4096, 12288, dtype, 5, cuda)
    tqm.matmul_int8(x, qw, qscale, dtype)
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats(cuda)["allocation.all.allocated"]
    y = tqm.matmul_int8(x, qw, qscale, dtype)
    assert torch.cuda.memory_stats(cuda)["allocation.all.allocated"] == allocs + 1
    del y
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            tqm.matmul_int8(x, qw, qscale, dtype)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 5 and all("gemv8_kernel" in n for n in names), names
