"""K5, single-query decode attention (bf16 and int8 cache): the port's plain
version against the JAX Pallas kernel in interpret mode and against the
masked attention on the CPU, and the CUDA kernel against the plain version on
the card (skipped without one).

Tolerances. f32: the same products summed in another order, and ``exp`` from
two libraries: 2e-5, as the JAX package's own test of the kernel. bf16: every
product is rounded to bf16 on both sides and summed in f32 in another order;
outputs are O(1) weighted means: 2e-2 + 2e-2 * |want|. The CUDA kernel
against the plain version, bf16: with every row of a long cache visible the
outputs are small means (|want| <= 0.05 at S = 2048), and the kernel differs
from the plain version in taking each softmax weight relative to another
maximum before rounding it to bf16 (the split body: the running maximum of a
warp's tiles, as the Pallas kernel's over its blocks; the 64-row chunk's in
the first port's bodies): 1e-3 + 2e-2 * |want|, the absolute part from the
errors seen on an H100 (2.4e-4 to 9.8e-4), small enough that a chunk left out
of the merge fails.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lit_llama_tpu.ops.attention import attention_xla
from lit_llama_tpu.ops.decode_attention import decode_attention_pallas
from lit_llama_tpu_torch.ops import decode_attention as tda
from lit_llama_tpu_torch.ops.attention import attention_ref
from lit_llama_tpu_torch.utils.jax_params import tensor_from_numpy

TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TOL_CARD = dict(rtol=2e-2, atol=1e-3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(rng, B, H, S, hs):
    q = rng.normal(size=(B, H, 1, hs)).astype(np.float32)
    k = rng.normal(size=(B, H, S, hs)).astype(np.float32)
    v = rng.normal(size=(B, H, S, hs)).astype(np.float32)
    return q, k, v


def _quantize_rows(a):
    """int8 rows and (…, 1) f32 scales that vary from row to row."""
    s = (np.abs(a).max(-1, keepdims=True) / 127.0).astype(np.float32)
    return np.clip(np.round(a / s), -127, 127).astype(np.int8), s


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


# limits: the first row only, inside a block, the last row, past the cache
# (every row visible) and below zero (no row visible: zeros)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,limits", [(1, [0]), (1, [127]), (3, [0, 64, 255]), (4, [255, 300, -1, 17])])
def test_decode_attention_ref_matches_pallas(rng, B, limits, dtype):
    H, S, hs = 4, 256, 128
    q, k, v = _inputs(rng, B, H, S, hs)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    limit = np.asarray(limits, np.int32)
    want = decode_attention_pallas(jnp.asarray(q).astype(jdt), jnp.asarray(k).astype(jdt),
                                   jnp.asarray(v).astype(jdt), None, None, jnp.asarray(limit), interpret=True)
    got = tda.decode_attention_ref(_t(q, tdt), _t(k, tdt), _t(v, tdt), None, None, _t(limit))
    assert got.shape == (B, H, 1, hs) and got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **TOL[dtype])
    # the dispatching wrapper takes the plain version for a CPU tensor
    out = tda.decode_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt), None, None, _t(limit))
    assert torch.equal(out, got)
    for b, lim in enumerate(limits):
        if lim < 0:
            assert not got[b].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,limits", [(2, 128, [100, 5]), (3, 256, [0, 255, 400])])
def test_decode_attention_ref_int8_matches_pallas(rng, B, S, limits, dtype):
    """The int8 cache is consumed as it is: k scale on the score, v scale on
    the weights."""
    H, hs = 8, 128
    q, kf, vf = _inputs(rng, B, H, S, hs)
    (k8, ks), (v8, vs) = _quantize_rows(kf), _quantize_rows(vf)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    limit = np.asarray(limits, np.int32)
    want = decode_attention_pallas(jnp.asarray(q).astype(jdt), jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(ks),
                                   jnp.asarray(vs), jnp.asarray(limit), interpret=True)
    got = tda.decode_attention_ref(_t(q, tdt), _t(k8), _t(v8), _t(ks), _t(vs), _t(limit))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **TOL[dtype])
    assert torch.equal(tda.decode_attention(_t(q, tdt), _t(k8), _t(v8), _t(ks), _t(vs), _t(limit)), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantized", [False, True])
def test_decode_attention_ref_matches_pallas_head_size_384(rng, dtype, quantized):
    """Head size 384, which the JAX gate sends to the Pallas kernel (the
    card's split body takes it at three pieces of a row a lane): the plain
    version holds, bf16 or int8 cache."""
    B, H, S, hs, limits = 2, 2, 256, 384, [100, 300]
    q, kf, vf = _inputs(rng, B, H, S, hs)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    limit = np.asarray(limits, np.int32)
    if quantized:
        (k, ks), (v, vs) = _quantize_rows(kf), _quantize_rows(vf)
        jk, jv, jks, jvs = jnp.asarray(k), jnp.asarray(v), jnp.asarray(ks), jnp.asarray(vs)
        tk, tv, tks, tvs = _t(k), _t(v), _t(ks), _t(vs)
    else:
        jk, jv, jks, jvs = jnp.asarray(kf).astype(jdt), jnp.asarray(vf).astype(jdt), None, None
        tk, tv, tks, tvs = _t(kf, tdt), _t(vf, tdt), None, None
    want = decode_attention_pallas(jnp.asarray(q).astype(jdt), jk, jv, jks, jvs, jnp.asarray(limit), interpret=True)
    got = tda.decode_attention_ref(_t(q, tdt), tk, tv, tks, tvs, _t(limit))
    assert got.shape == (B, H, 1, hs) and got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **TOL[dtype])


@pytest.mark.parametrize("quantized", [False, True])
def test_decode_attention_ref_matches_masked_attention(rng, quantized):
    """Against what the JAX package runs where it does not dispatch the
    kernel: the whole cache, dequantized, through the masked attention (both
    packages'), at a head size and cache length the kernel would not take.
    f32; the dequantize-first order costs a few ulp more: 2e-4, the tolerance
    of the JAX package's own int8 test."""
    B, H, S, hs = 3, 2, 50, 32
    q, kf, vf = _inputs(rng, B, H, S, hs)
    limit = np.asarray([0, 31, 77], np.int32)
    mask = np.arange(S)[None, :] <= limit[:, None]
    if quantized:
        (k8, ks), (v8, vs) = _quantize_rows(kf), _quantize_rows(vf)
        got = tda.decode_attention_ref(_t(q), _t(k8), _t(v8), _t(ks), _t(vs), _t(limit))
        kf, vf = k8.astype(np.float32) * ks, v8.astype(np.float32) * vs
    else:
        got = tda.decode_attention_ref(_t(q), _t(kf), _t(vf), None, None, _t(limit))
    ours = attention_ref(_t(q), _t(kf), _t(vf), _t(mask)[:, None, None, :])
    jax_side = attention_xla(jnp.asarray(q), jnp.asarray(kf), jnp.asarray(vf), jnp.asarray(mask)[:, None, None, :])
    np.testing.assert_allclose(got.numpy(), ours.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_side), rtol=2e-4, atol=2e-4)


def test_decode_attention_keeps_the_jax_entry_name():
    assert tda.decode_attention_pallas is tda.decode_attention


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantized", [False, True])
def test_decode_attention_ref_matches_pallas_head_size_512(rng, dtype, quantized):
    """Head size 512 (the card's split body at four pieces of an f32 row a
    lane): the plain version holds against the Pallas kernel, bf16 or int8
    cache."""
    B, H, S, hs, limits = 2, 1, 256, 512, [70, 300]
    q, kf, vf = _inputs(rng, B, H, S, hs)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    limit = np.asarray(limits, np.int32)
    if quantized:
        (k, ks), (v, vs) = _quantize_rows(kf), _quantize_rows(vf)
        jk, jv, jks, jvs = jnp.asarray(k), jnp.asarray(v), jnp.asarray(ks), jnp.asarray(vs)
        tk, tv, tks, tvs = _t(k), _t(v), _t(ks), _t(vs)
    else:
        jk, jv, jks, jvs = jnp.asarray(kf).astype(jdt), jnp.asarray(vf).astype(jdt), None, None
        tk, tv, tks, tvs = _t(kf, tdt), _t(vf, tdt), None, None
    want = decode_attention_pallas(jnp.asarray(q).astype(jdt), jk, jv, jks, jvs, jnp.asarray(limit), interpret=True)
    got = tda.decode_attention_ref(_t(q, tdt), tk, tv, tks, tvs, _t(limit))
    assert got.shape == (B, H, 1, hs) and got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **TOL[dtype])


def _card_case(rng, cuda, B, S, limits, quantized):
    H, hs = 32, 128
    q, kf, vf = _inputs(rng, B, H, S, hs)
    # q as the model hands it over: (B, 1, H, hs) rows seen as (B, H, 1, hs)
    qt = _t(q, torch.bfloat16).transpose(1, 2).contiguous().to(cuda).transpose(1, 2)
    limit = _t(np.asarray(limits, np.int32)).to(cuda)
    if quantized:
        (k8, ks), (v8, vs) = _quantize_rows(kf * 0.5), _quantize_rows(vf * 0.5)
        return qt, _t(k8).to(cuda), _t(v8).to(cuda), _t(ks).to(cuda), _t(vs).to(cuda), limit
    return qt, _t(kf * 0.5, torch.bfloat16).to(cuda), _t(vf * 0.5, torch.bfloat16).to(cuda), None, None, limit


# limits per row: 0, the middle of a 64-row block, S - 1, past S, below 0
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("B,S,limits", [
    (1, 2048, [2047]), (1, 2048, [1000]), (1, 256, [300]), (1, 100, [0]),
    (8, 2048, [0, 100, 2047, 2048, 5000, 63, 64, -1]), (3, 100, [99, 37, 64]),
])
def test_decode_attention_kernel_matches_plain(rng, cuda, B, S, limits, quantized):
    args = _card_case(rng, cuda, B, S, limits, quantized)
    before = tda.decode_attention.launches
    got = tda.decode_attention(*args)
    want = tda.decode_attention_ref(*args)
    torch.cuda.synchronize()
    assert tda.decode_attention.launches == before + 1
    assert got.shape == (B, 32, 1, 128) and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **TOL_CARD)


def test_decode_attention_kernel_raises_on_what_it_does_not_take(rng, cuda):
    q, k, v, _, _, limit = _card_case(rng, cuda, 2, 64, [3, 9], False)
    with pytest.raises(ValueError):  # head size
        tda.decode_attention(q[..., :64], k[..., :64].contiguous(), v[..., :64].contiguous(), None, None, limit)
    with pytest.raises(ValueError):  # f32 cache
        tda.decode_attention(q, k.float(), v.float(), None, None, limit)
    with pytest.raises(ValueError):  # int8 rows without their scales
        tda.decode_attention(q, k.to(torch.int8), v.to(torch.int8), None, None, limit)
    with pytest.raises(ValueError):  # limit on the host's dtype
        tda.decode_attention(q, k, v, None, None, limit.long())
    assert tensor_from_numpy(np.zeros(2, np.float32), cuda).is_cuda


# f32 compute (f32 or int8 cache) and head size 256 (bf16 and f32)
@pytest.mark.parametrize("dtype,hs", [("float32", 128), ("bfloat16", 256), ("float32", 256)])
@pytest.mark.parametrize("quantized", [False, True])
def test_decode_attention_kernel_f32_and_head_size_256(rng, cuda, dtype, hs, quantized):
    cd = getattr(torch, dtype)
    B, H, S, limits = 3, 4, 300, [0, 150, 400]
    mk = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda)
    q = mk(B, H, 1, hs).to(cd)
    if quantized:
        k, v = (torch.from_numpy(rng.integers(-127, 128, size=(B, H, S, hs)).astype(np.int8)).to(cuda) for _ in "kv")
        ks, vs = (mk(B, H, S, 1).abs() * 0.01 for _ in "kv")
    else:
        k, v, ks, vs = mk(B, H, S, hs).to(cd), mk(B, H, S, hs).to(cd), None, None
    limit = torch.tensor(limits, dtype=torch.int32, device=cuda)
    before = tda.decode_attention.launches
    got = tda.decode_attention(q, k, v, ks, vs, limit)
    want = tda.decode_attention_ref(q, k, v, ks, vs, limit)
    torch.cuda.synchronize()
    assert tda.decode_attention.launches == before + 1 and got.shape == (B, H, 1, hs) and got.dtype == cd
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == "float32" else TOL_CARD
    torch.testing.assert_close(got.float(), want.float(), **tol)


# past head size 256: the split body, a row laid on its lanes as Geo (decode_sm90.cuh) lays it
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("hs", [384, 512])
@pytest.mark.parametrize("quantized", [False, True])
def test_decode_attention_kernel_head_sizes_past_256(rng, cuda, dtype, hs, quantized):
    test_decode_attention_kernel_f32_and_head_size_256(rng, cuda, dtype, hs, quantized)


# the split body (csrc/decode_sm90.cuh, bf16 at every head size up to 1024):
# limits on both sides of a split boundary (at S = 2048: 256 rows a split at
# head size 128 and 256, 128 at 384, 64 at 512), inside the
# first split, past S and below 0. Caches: bf16; int8 rows quantized as the
# int8 cache holds them; uniform random int8 with row scales 0.01 * U(0, 1).
# On uniform int8 with larger scales (0.03, 0.1) the products reach |v| ~ 4-13
# and no body holds TOL_CARD's absolute part: the first port's chunk body and
# the plain version stand 4.5 to 60 times that tolerance from the exact
# attention there (tools/profile_decode_kernels.py --accuracy, PERF.md)
@pytest.mark.parametrize("hs", [128, 256, 384, 512])
@pytest.mark.parametrize("cache", ["bf16", "int8 rows", "int8 uniform"])
def test_decode_attention_kernel_rows_equal_alone_and_in_a_batch(rng, cuda, hs, cache):
    """A row's output is the same bits alone (B = 1) as among 8 rows, and on
    a rerun: the splits depend on S and hs alone and the merge takes them in
    split order, whatever block arrives last."""
    S = 2048
    split = tda.decode_plan(S, hs).split_rows
    limits = [split - 1, split, 3 * split + 5, S - 1, S + 100, 0, 63, -1]
    B, H = len(limits), 32 if hs == 128 else 16
    q, kf, vf = _inputs(rng, B, H, S, hs)
    q = _t(q, torch.bfloat16).to(cuda)
    if cache == "int8 rows":
        (k, ks), (v, vs) = (tuple(_t(a).to(cuda) for a in _quantize_rows(c * 0.5)) for c in (kf, vf))
    elif cache == "int8 uniform":
        k, v = (_t(rng.integers(-127, 128, size=(B, H, S, hs)).astype(np.int8)).to(cuda) for _ in range(2))
        ks, vs = (_t((0.01 * rng.random((B, H, S, 1))).astype(np.float32)).to(cuda) for _ in range(2))
    else:
        k, v, ks, vs = _t(kf * 0.5, torch.bfloat16).to(cuda), _t(vf * 0.5, torch.bfloat16).to(cuda), None, None
    limit = torch.tensor(limits, dtype=torch.int32, device=cuda)
    got = tda.decode_attention(q, k, v, ks, vs, limit)
    torch.testing.assert_close(got.float(), tda.decode_attention_ref(q, k, v, ks, vs, limit).float(), **TOL_CARD)
    assert torch.equal(got, tda.decode_attention(q, k, v, ks, vs, limit))
    for b in range(B):
        one = [t if t is None else t[b : b + 1].contiguous() for t in (q, k, v, ks, vs)]
        assert torch.equal(tda.decode_attention(*one, limit[b : b + 1]), got[b : b + 1]), (b, limits[b])
    assert not got[limits.index(-1)].float().abs().any()


# f32 compute on the split body: an f32 cache and uniform random int8 with
# row scales; limits 0, the middle of a split, on both sides of a split
# boundary and past S
@pytest.mark.parametrize("hs", [128, 256, 384, 512])
@pytest.mark.parametrize("cache", ["f32", "int8"])
def test_decode_attention_kernel_f32_rows_equal_alone_and_in_a_batch(rng, cuda, hs, cache):
    """In f32 a row's output is the same bits alone (B = 1) as among the
    batch's rows, and on a rerun; each within 1e-4 of the plain version (f32
    sums in another order)."""
    S = 2048
    split = tda.decode_plan(S, hs).split_rows
    limits = [0, split // 2 + 3, split - 1, split, S + 100]
    B, H = len(limits), 32 if hs == 128 else 16
    q, kf, vf = _inputs(rng, B, H, S, hs)
    q = _t(q).to(cuda)
    if cache == "int8":
        k, v = (_t(rng.integers(-127, 128, size=(B, H, S, hs)).astype(np.int8)).to(cuda) for _ in range(2))
        ks, vs = (_t((0.01 * rng.random((B, H, S, 1))).astype(np.float32)).to(cuda) for _ in range(2))
    else:
        k, v, ks, vs = _t(kf * 0.5).to(cuda), _t(vf * 0.5).to(cuda), None, None
    limit = torch.tensor(limits, dtype=torch.int32, device=cuda)
    got = tda.decode_attention(q, k, v, ks, vs, limit)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, tda.decode_attention_ref(q, k, v, ks, vs, limit), rtol=1e-4, atol=1e-5)
    assert torch.equal(got, tda.decode_attention(q, k, v, ks, vs, limit))
    for b in range(B):
        one = [t if t is None else t[b : b + 1].contiguous() for t in (q, k, v, ks, vs)]
        assert torch.equal(tda.decode_attention(*one, limit[b : b + 1]), got[b : b + 1]), (b, limits[b])


@pytest.mark.parametrize("hs,body", [(1024, "split"), (1152, "wide")])
def test_decode_attention_kernel_body_by_head_size(rng, cuda, hs, body):
    """Up to head size 1024 K5 is the split body's one kernel; past it, a
    static route by head size, the first port's two wide kernels: the
    profiler names which ran, and either holds against the plain version."""
    assert tda.uses_split_body(hs, torch.bfloat16) is tda.uses_split_body(hs, torch.float32) is (body == "split")
    B, H, S = 2, 2, 300
    q, kf, vf = _inputs(rng, B, H, S, hs)
    q, k, v = _t(q, torch.bfloat16).to(cuda), _t(kf * 0.5, torch.bfloat16).to(cuda), _t(vf * 0.5, torch.bfloat16).to(cuda)
    limit = torch.tensor([150, 400], dtype=torch.int32, device=cuda)
    tda.decode_attention(q, k, v, None, None, limit)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        got = tda.decode_attention(q, k, v, None, None, limit)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    split = any("k5_kernel" in n for n in names)
    wide = any("decode_attn_wide_partial_kernel" in n for n in names)
    assert (split, wide) == (body == "split", body == "wide"), names
    torch.testing.assert_close(got.float(), tda.decode_attention_ref(q, k, v, None, None, limit).float(), **TOL_CARD)


def test_decode_attention_kernel_leaves_the_counters_at_zero(rng, cuda):
    """Back-to-back launches of the split body, one whose rows all need a
    merge and one with every limit inside the first split, leave the
    arrival counters at zero: the last block of each (row, head) resets its
    own."""
    args = _card_case(rng, cuda, 8, 2048, [2047, 1000, 300, 2048, 5000, 700, 1500, 256], False)
    short = args[:-1] + (torch.tensor([5, 0, 63, 100, 255, 1, 17, 200], dtype=torch.int32, device=cuda),)
    for call in (args, args, short, args):
        tda.decode_attention(*call)
    torch.cuda.synchronize()
    counters = tda.arrival_counters(8 * 32, cuda)
    assert int(counters.abs().sum()) == 0


def test_decode_attention_kernel_on_two_streams(rng, cuda):
    """Launches on two streams at once each take their stream's arrival
    counters, so neither's merge reads the other's counts: every output is
    the same bits as its launch alone."""
    limits = [2047, 1000, 300, 2048, 5000, 700, 1500, 256]
    args = [_card_case(rng, cuda, 8, 2048, limits, quantized) for quantized in (False, True)]
    want = [tda.decode_attention(*a) for a in args]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda) for _ in args]
    got, bufs = [], []
    for _ in range(10):  # interleaved, so the two streams' blocks run together
        for s, a in zip(streams, args):
            with torch.cuda.stream(s):
                got.append(tda.decode_attention(*a))
                bufs.append(tda.arrival_counters(1, cuda))
    torch.cuda.synchronize()
    assert bufs[0].data_ptr() != bufs[1].data_ptr()
    for i, out in enumerate(got):
        assert torch.equal(out, want[i % 2]), i
