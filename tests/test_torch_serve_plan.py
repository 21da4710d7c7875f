"""How the bf16 int4 products of K7 and K9 cut their work on the card
(``ops.fused_layer.serve_plan`` and the ``SERVE_*`` constants): pure
functions of the shapes, mirrors of what ``csrc/serve_layer.cu`` computes, so
what the kernels are asked to do is testable here, where they cannot run. A
column block owns SERVE_COLS columns, a K split a run of SERVE_STEP-byte
k-steps; the splits come from N and K alone and are merged in split order.
The plain products merged over the plan's splits, each step's f32 sums
scaled by its groups and its zero-point term taken from the row's 64-sums as
the kernels take them, equal the one-pass plain version."""

import inspect
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lit_llama_tpu_torch.models.config import LLaMAConfig
from lit_llama_tpu_torch.ops import fused_layer as tfl

SOURCE = Path(tfl.__file__).resolve().parent.parent / "csrc" / "serve_layer.cu"
# (n_embd, intermediate size) of the presets, and 14 heads of 128 (7 groups a
# nibble plane in c_attn, 19 in mlp.c_proj)
WIDTHS = {name: (LLaMAConfig.from_name(name).n_embd, LLaMAConfig.from_name(name).intermediate_size)
          for name in ("7B", "13B", "30B", "65B")}
WIDTHS["n_embd 1792"] = (1792, LLaMAConfig(n_layer=1, n_head=14, n_embd=1792).intermediate_size)
PRODUCTS = ("c_attn", "attn.c_proj", "c_fc12", "mlp.c_proj")


def _shape(width: str, product: str):
    """(K, N, SiLU(gate) * up) of a product at a width."""
    D, I = WIDTHS[width]
    return {"c_attn": (D, 3 * D, False), "attn.c_proj": (D, D, False), "c_fc12": (D, 2 * I, True),
            "mlp.c_proj": (I, D, False)}[product]


def _const(text: str, name: str) -> int:
    return int(re.search(rf"\b{name} = (\d+)", text).group(1))


def test_constants_mirror_the_source():
    """The Python mirrors and the CUDA source name the same block, step,
    split rule, prologue and LoRA tiles, and ring depths."""
    src = SOURCE.read_text()
    assert (_const(src, "WARPS"), _const(src, "STEP")) == (tfl.SERVE_WARPS, tfl.SERVE_STEP)
    assert re.search(r"\bCOLS = 16 \* WARPS;", src) and tfl.SERVE_COLS == 16 * tfl.SERVE_WARPS
    assert (_const(src, "SPLIT_TARGET"), _const(src, "MAX_SPLITS"), _const(src, "MIN_SPLIT_STEPS")) == (
        tfl.SERVE_SPLIT_TARGET, tfl.SERVE_MAX_SPLITS, tfl.SERVE_MIN_SPLIT_STEPS)
    assert re.search(r"PREP_K = 4 \* PREP_THREADS", src) and 4 * _const(src, "PREP_THREADS") == tfl.SERVE_PREP_K
    assert (_const(src, "LD_K"), _const(src, "LD_C")) == (tfl.SERVE_LORA_K, tfl.SERVE_LORA_C)
    d1, d2, a, b, c = map(int, re.search(
        r"return deep \? \(nt <= 8 \? (\d+) : (\d+)\) : \(nt <= 4 \? (\d+) : nt == 8 \? (\d+) : (\d+)\);",
        src).groups())
    assert [tfl.serve_stages(t) for t in (8, 16, 32, 64, 128)] == [a, a, a, b, c]
    assert [tfl.serve_stages(t, deep=True) for t in (8, 16, 32, 64, 128)] == [d1, d1, d1, d1, d2]
    assert _const(src, "ONE_WAVE") == tfl.SERVE_ONE_WAVE
    assert "a.N / COLS * a.splits <= ONE_WAVE ? launch_ring<NT, true>" in src
    assert "while (blocks * s < SPLIT_TARGET && s < MAX_SPLITS && steps / (2 * s) >= MIN_SPLIT_STEPS)" in src


@pytest.mark.parametrize("product", PRODUCTS)
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_columns_and_steps_are_covered_once(width, product):
    """Every output column is one block's, and every k-step one split's, at
    most SERVE_MAX_SPLITS splits of at least one step; the blocks reach the
    split target or the splits their limit."""
    K, N, swiglu = _shape(width, product)
    plan = tfl.serve_plan(N, K)
    assert K % 128 == 0 and N % tfl.SERVE_COLS == 0
    cols = [c for b in range(plan.blocks) for c in tfl.serve_columns(b, N, swiglu)]
    assert sorted(cols) == list(range(N))
    steps = [s for sp in range(plan.splits) for s in plan.split_steps(sp)]
    assert steps == list(range(K // 2 // tfl.SERVE_STEP))
    assert 1 <= plan.splits <= tfl.SERVE_MAX_SPLITS and all(len(plan.split_steps(sp)) for sp in range(plan.splits))
    assert (plan.blocks * plan.splits >= tfl.SERVE_SPLIT_TARGET or plan.splits == tfl.SERVE_MAX_SPLITS
            or plan.steps // (2 * plan.splits) < tfl.SERVE_MIN_SPLIT_STEPS)


@pytest.mark.parametrize("product", PRODUCTS)
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_each_step_sits_in_one_group_a_plane(width, product):
    """A step's 64 low-plane and 64 high-plane rows lie in one group each
    (gs 64, 128, 256), the high one Gh groups on: one scale and one zero a
    plane and column a step, as the kernel copies them."""
    K, _, _ = _shape(width, product)
    Kh = K // 2
    for gs in (64, 128, 256):
        if K % gs or (K // gs) % 2:
            continue  # the wrapper refuses it
        Gh = K // gs // 2
        for s in range(Kh // tfl.SERVE_STEP):
            lo = range(64 * s, 64 * s + 64)
            assert len({k // gs for k in lo}) == 1 and {(Kh + k) // gs for k in lo} == {Gh + 64 * s // gs}


def test_plan_depends_on_the_shape_alone():
    """The plan takes no slot count, so a row's sums are the same at any B;
    the token tile, the one thing B chooses, holds up to 128 slots and only
    tiles them."""
    assert list(inspect.signature(tfl.serve_plan).parameters) == ["N", "K"]
    for B in (1, 2, 8, 9, 17, 32, 33, 64, 65, 96, 128, 129, 4096):
        t = tfl.serve_token_tile(B)
        assert t in (8, 16, 32, 64, 128) and (t >= B or t == 128) and (t == 8 or t // 2 < B)


@pytest.mark.parametrize("deep", [False, True])
@pytest.mark.parametrize("tile", [8, 16, 32, 64, 128])
def test_ring_fits_shared_memory(tile, deep):
    """The ring (token rows, the warps' weights, scales and zeros, the tokens'
    64-sums) and the epilogue's tile fit a block's 227 KB; up to 64 slots two
    blocks fit an SM (228 KB, 1 KB reserved a block), as __launch_bounds__
    asks, but in the deep ring of a one-wave grid."""
    src = SOURCE.read_text()
    trow = _const(src, "TROW")
    assert trow >= 2 * 2 * tfl.SERVE_STEP and trow % 16 == 0 and (trow // 16) % 2 == 1  # no bank conflicts
    assert "__launch_bounds__(THREADS, NT <= 8 && !DEEP ? 2 : 1)" in src
    assert "return 8 * nt * TROW + WARPS * 32 * 32 + WARPS * 64 * 4 + 8 * nt * 8;" in src
    stage = tile * trow + tfl.SERVE_WARPS * 32 * 32 + tfl.SERVE_WARPS * 64 * 4 + tile * 8
    epi = tile * (tfl.SERVE_COLS + 4) * 4 + tile * 32 * 4 + 32 * tfl.SERVE_COLS * 4
    smem = max(tfl.serve_stages(tile, deep) * stage, epi)
    assert smem <= tfl.SM90_MAX_SMEM - 16  # the arrival flag is static
    if tile <= 64 and not deep:
        assert 2 * (smem + 16 + 1024) <= 228 * 1024


def _decode_layout(rng, K, N, gs):
    """A random int4 linear in the shared layout and its decode copy."""
    G = K // gs
    w = {"qw": torch.from_numpy(rng.integers(0, 256, size=(K // 2, N), dtype=np.uint8)),
         "qscale": torch.from_numpy(rng.uniform(0.001, 0.02, size=(G, N)).astype(np.float32)),
         "qzero": torch.from_numpy(rng.uniform(-0.1, 0.1, size=(G, N)).astype(np.float32))}
    return {**w, "qw_t": w["qw"].t().contiguous(), "qscale_t": w["qscale"].t().contiguous(),
            "qzero_t": w["qzero"].t().contiguous()}


def _kernel_order(x, w, plan):
    """The product as the kernel sums it, from the decode layout: per split,
    per step, the bf16 row times the exact nibbles of each plane summed in
    f32, times the step's group scale, plus the row's f32 64-sums times the
    group's zero; the splits' partials added in split order."""
    B, K = x.shape
    Kh, (N, G) = K // 2, w["qscale_t"].shape
    Gh, gs = G // 2, K // G
    xb, hs = x.to(torch.bfloat16).float(), x.reshape(B, K // 64, 64).sum(-1)
    lo, hi = (w["qw_t"] & 0xF).float(), (w["qw_t"] >> 4).float()
    st, zt = w["qscale_t"], w["qzero_t"]
    out = None
    for sp in range(plan.splits):
        acc = torch.zeros(B, N)
        for s in plan.split_steps(sp):
            r, gi = slice(64 * s, 64 * s + 64), 64 * s // gs
            dl, dh = xb[:, r] @ lo[:, r].t(), xb[:, Kh + 64 * s:Kh + 64 * s + 64] @ hi[:, r].t()
            acc = acc + dl * st[:, gi] + dh * st[:, Gh + gi] + hs[:, s:s + 1] * zt[:, gi] \
                + hs[:, Kh // 64 + s:Kh // 64 + s + 1] * zt[:, Gh + gi]
        out = acc if out is None else out + acc
    return out


@pytest.mark.parametrize("K,N,gs", [(2048, 2048, 128), (2048, 6144, 64), (1792, 1792, 128), (4864, 1792, 128),
                                    (4096, 1024, 256)])
@pytest.mark.parametrize("B", [1, 3])
def test_split_products_equal_the_one_pass_plain_version(K, N, gs, B):
    """The plain product in the kernel's order, merged over the plan's
    splits (two or more at K >= 2048 with few column blocks), equals
    ``mv_int4_ref`` on the shared layout up to the f32 order of the sums."""
    plan = tfl.serve_plan(N, K)
    rng = np.random.default_rng(K + N + gs)
    w = _decode_layout(rng, K, N, gs)
    x = torch.from_numpy(rng.normal(size=(B, K)).astype(np.float32))
    want = tfl.mv_int4_ref(x, w, torch.bfloat16)
    torch.testing.assert_close(_kernel_order(x, w, plan), want, rtol=1e-5, atol=1e-4)
    if K >= 2048 and N <= 2048:
        assert plan.splits > 1


def test_split_plain_block_halves_equal_the_one_pass_plain_versions():
    """K7's and K9's plain versions with every product taken in the kernel's
    order over its plan equal the one-pass plain versions (n_embd 2048, where
    c_attn and both c_proj products split K)."""
    D, I, B, hs = 2048, 512, 3, 128
    rng = np.random.default_rng(7)
    ws = {name: _decode_layout(rng, K, N, 128) for name, (K, N) in
          {"ca": (D, 3 * D), "cp": (D, D), "f12": (D, 2 * I), "mp": (I, D)}.items()}
    assert [tfl.serve_plan(N, K).splits for K, N in ((D, 3 * D), (D, D), (I, D))] == [2, 2, 1]
    cfg = SimpleNamespace(n_embd=D, head_size=hs, intermediate_size=I)  # what the plain versions read
    x, y = (torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32)).to(torch.bfloat16) for _ in range(2))
    rms = torch.from_numpy(rng.uniform(0.5, 1.5, size=D).astype(np.float32))
    ang = torch.from_numpy(rng.uniform(0, 6.28, size=(B, hs // 2)).astype(np.float32))
    cos = torch.cat([ang.cos(), ang.cos()], -1)
    sin = torch.cat([-ang.sin(), ang.sin()], -1)
    original = tfl.mv_int4_ref
    try:
        tfl.mv_int4_ref = lambda src, w, cdtype: _kernel_order(src, w, tfl.serve_plan(w["qw"].shape[1],
                                                                                      2 * w["qw"].shape[0]))
        head = tfl.block_head_fused_ref(x, rms, cos, sin, ws["ca"], cfg)
        tail = tfl.block_tail_fused_ref(x, y, rms, ws["cp"], ws["f12"], ws["mp"], cfg)
    finally:
        tfl.mv_int4_ref = original
    torch.testing.assert_close(head.float(), tfl.block_head_fused_ref(x, rms, cos, sin, ws["ca"], cfg).float(),
                               rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(tail.float(), tfl.block_tail_fused_ref(x, y, rms, ws["cp"], ws["f12"], ws["mp"],
                                                                      cfg).float(), rtol=1e-2, atol=1e-2)


def test_span_tool_finds_the_product_kernel():
    """tools/spans.py rows instruments the product kernel this source holds:
    spans in its mainloop, its totals at every exit."""
    from lit_llama_tpu_torch.tools import spans

    text = SOURCE.read_text()
    sources = [s for s in spans.ROWS_SOURCES if any(k.name in text for k in s.kernels)]
    assert len(sources) == 1
    out = spans.instrument(text, sources[0]).replace(spans.HEAD, "")
    assert out.count("SPAN(") >= 8 and out.count("SPAN_END(") == 3
    with pytest.raises(ValueError, match="anchors not found"):
        spans.instrument(text, sources[0]._replace(rules=(("no_such_line(", "SPAN(1);", "after"),)))
