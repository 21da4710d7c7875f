"""The continuous-batching engine on the CPU: greedy tokens identical to the
JAX DecodeEngine's (its batched fused kernels in Pallas interpret mode, as
tests/test_fused_layer.py runs it) and to the port's own single-stream
generate, on the tiny int4 model; then the port's scheduling on its own."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lit_llama_tpu import LLaMAConfig, init_params
from lit_llama_tpu.models import llama as jllama
from lit_llama_tpu.ops import fused_layer as jfl
from lit_llama_tpu.serve.engine import DecodeEngine as JaxEngine
from lit_llama_tpu_torch.models import config as tcfg
from lit_llama_tpu_torch.models import generate as tgen
from lit_llama_tpu_torch.serve import DecodeEngine
from lit_llama_tpu_torch.serve.engine import _sample_rows
from lit_llama_tpu_torch.utils.jax_params import params_from_numpy


def _port_config(cfg):
    return tcfg.LLaMAConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                               if f.name not in ("lora", "adapter")})


@pytest.fixture(scope="module")
def model():
    cfg = LLaMAConfig(block_size=256, vocab_size=128, n_layer=2, n_head=4, n_embd=512,
                      quantize="int4", quant_groupsize=128)
    dense = init_params(cfg.replace(quantize=None), jax.random.PRNGKey(0))
    fparams, fcfg = jfl.prepare_fused_params(jllama.unstack_layers(jllama.quantize_params(dense, cfg)), cfg)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, fparams), device="cpu")
    return fparams, fcfg, tparams, _port_config(fcfg)


def _jax_engine_tokens(monkeypatch, fparams, fcfg, prompts, n_new, **kw):
    monkeypatch.setattr(
        jfl, "use_serve_fused",
        lambda config, lp, batch=None: config.rope_layout == "half"
        and "qzero" in lp["attn"]["c_attn"] and "c_fc12" in lp["mlp"],
    )
    with pltpu.force_tpu_interpret_mode():
        eng = JaxEngine(fparams, fcfg, **kw)
        ids = [eng.submit(p, n_new) for p in prompts]
        done = eng.run()
    return [done[i].generated for i in ids]


def _port_engine_tokens(tparams, tc, prompts, n_new, **kw):
    eng = DecodeEngine(tparams, tc, device="cpu", **kw)
    ids = [eng.submit(p, n_new) for p in prompts]
    done = eng.run()
    assert not eng.has_work() and sorted(done) == ids
    return [done[i].generated for i in ids], eng


def _generate_tokens(tparams, tc, prompts, n_new, S):
    return [tgen.generate(tparams, p, n_new, config=tc, max_seq_length=S, temperature=0.0,
                          device="cpu")[len(p):].tolist() for p in prompts]


def test_engine_matches_jax_engine_more_requests_than_slots_chunked(model, monkeypatch):
    """Four requests on two slots, prompts longer than prefill_chunk = 4, so
    slots are recycled and every longer prompt prefills in chunks."""
    fparams, fcfg, tparams, tc = model
    rng = np.random.default_rng(21)
    prompts = [rng.integers(1, 128, size=n).astype(np.int32) for n in (5, 11, 3, 9)]
    kw = dict(max_batch=2, max_seq_length=64, prefill_chunk=4)
    want = _jax_engine_tokens(monkeypatch, fparams, fcfg, prompts, 6, **kw)
    got, eng = _port_engine_tokens(tparams, tc, prompts, 6, **kw)
    assert got == want
    assert got == _generate_tokens(tparams, tc, prompts, 6, 64)
    assert eng.prefills == 2 + 3 + 1 + 3  # chunks of 4: ceil(5/4), ceil(11/4), 1, ceil(9/4)


def test_engine_matches_jax_engine_past_the_cache(model, monkeypatch):
    """S = 16 and 20 new tokens after a 5-token prompt: the slot's ring wraps."""
    fparams, fcfg, tparams, tc = model
    prompts = [np.asarray([5, 23, 81, 2, 40], np.int32)]
    kw = dict(max_batch=2, max_seq_length=16)
    want = _jax_engine_tokens(monkeypatch, fparams, fcfg, prompts, 20, **kw)
    got, _ = _port_engine_tokens(tparams, tc, prompts, 20, **kw)
    assert got == want
    assert got == _generate_tokens(tparams, tc, prompts, 20, 16)


@pytest.mark.parametrize("steps_per_sync", [1, 3])
def test_engine_parked_slot_keeps_its_prompt_rows(model, steps_per_sync):
    """A small prefill_budget parks a long prompt mid-prefill while another
    slot decodes: the parked slot must hold row S - 1 through the whole decode
    chunk, so its prefilled rows stay as they were written."""
    _, _, tparams, tc = model
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 128, size=n).astype(np.int32) for n in (3, 14, 6)]
    got, eng = _port_engine_tokens(tparams, tc, prompts, 7, max_batch=2, max_seq_length=32,
                                   prefill_chunk=4, prefill_budget=4, steps_per_sync=steps_per_sync)
    assert got == _generate_tokens(tparams, tc, prompts, 7, 32)
    assert eng.decode_steps % steps_per_sync == 0


def test_engine_any_cache_length_and_truncation(model):
    """S = 21 is taken as given (the JAX engine would cut it to 16), and an
    over-long prompt keeps its last S - 1 tokens."""
    _, _, tparams, tc = model
    eng = DecodeEngine(tparams, tc, max_batch=1, max_seq_length=21, device="cpu")
    assert eng.S == 21 and eng.cache[0]["k"].shape == (1, 4, 21, 128)
    long = np.arange(1, 41, dtype=np.int32)
    rid = eng.submit(long, 3)
    out = eng.run()[rid]
    assert out.prompt.tolist() == long[-20:].tolist() and len(out.generated) == 3
    assert out.ttft is not None and out.done_t >= out.first_token_t
    eos = out.generated[1]
    rid = eng.submit(long, 3, eos_id=eos)
    stopped = eng.run()[rid].generated
    assert stopped == out.generated[: out.generated.index(eos) + 1]


def test_engine_refuses_what_it_does_not_serve(model):
    _, _, tparams, tc = model
    with pytest.raises(NotImplementedError):
        DecodeEngine(tparams, tc, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):  # no card and no device="cpu": no silent fallback
            DecodeEngine(tparams, tc)
    eng = DecodeEngine(tparams, tc, max_batch=1, max_seq_length=16, top_k=5, device="cpu")
    with pytest.raises(ValueError):
        eng.submit([1, 2], 2, top_k=6)
    with pytest.raises(ValueError):
        DecodeEngine(tparams, tc, top_k=None, device="cpu").submit([1, 2], 2, top_k=3)


def test_engine_sampling_per_slot(model):
    """Sampled and greedy requests side by side: the greedy slot is unchanged
    by its neighbour, a top_k = 1 request is greedy whatever its temperature."""
    _, _, tparams, tc = model
    prompts = [np.asarray([5, 23, 81], np.int32), np.asarray([7, 9], np.int32)]
    greedy = _generate_tokens(tparams, tc, prompts, 5, 32)
    eng = DecodeEngine(tparams, tc, max_batch=3, max_seq_length=32, top_k=10, seed=1, device="cpu")
    a = eng.submit(prompts[0], 5)
    b = eng.submit(prompts[1], 5, temperature=0.9, top_k=1)
    c = eng.submit(prompts[1], 5, temperature=0.9)
    done = eng.run()
    assert done[a].generated == greedy[0] and done[b].generated == greedy[1]
    assert len(done[c].generated) == 5 and max(done[c].generated) < tc.padded_vocab_size


def test_sample_rows_exact_top_k():
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(3, 50, generator=g)
    temps = torch.tensor([0.0, 1.0, 1.0])
    top_ks = torch.tensor([0, 2, 0], dtype=torch.int32)
    top2 = set(torch.topk(logits[1], 2).indices.tolist())
    seen = set()
    for _ in range(40):
        out = _sample_rows(logits, temps, top_ks, 8, g)
        assert int(out[0]) == int(logits[0].argmax())
        seen.add(int(out[1]))
    assert seen <= top2 and len(seen) == 2


def test_engine_int8_weights_and_int8_cache_match_generate():
    """Layers that are not the fused int4 layout take the per-op block in the
    serving step (``decode_attention`` with each slot's position as its
    limit), on an int8 KV cache too: each request's greedy tokens equal the
    port's single-stream ``generate``."""
    from lit_llama_tpu_torch.models import llama as tllama

    tc = tcfg.LLaMAConfig(block_size=64, vocab_size=128, n_layer=2, n_head=4, n_embd=128,
                          quantize="int8", kv_cache_dtype="int8")
    dense = tllama.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    tparams = tllama.unstack_layers(tllama.quantize_params(dense, tc))
    prompts = [np.asarray(p, np.int64) for p in ([5, 23, 81], [7], [9, 9, 3, 40, 2, 11, 64])]
    got, eng = _port_engine_tokens(tparams, tc, prompts, 6, max_batch=2, max_seq_length=32, steps_per_sync=2)
    assert eng.cache[0]["k"].dtype == torch.int8 and set(eng.cache[0]) == {"k", "v", "ks", "vs"}
    for p, toks in zip(prompts, got):
        alone = tgen.generate(tparams, p, 6, config=tc, max_seq_length=32, temperature=0.0, device="cpu")
        assert toks == alone[len(p):].tolist()


def test_engine_prepared_int4_on_int8_cache_matches_jax_engine(model):
    """Prepared int4 layers on an int8 KV cache: the fused serving block reads
    a cache in the compute dtype only, so the step takes the per-op block, as
    the JAX package decides from the cache's layout. Greedy tokens equal the
    JAX engine's, past the cache too, and the scales are written."""
    fparams, fcfg, tparams, tc = model
    rng = np.random.default_rng(33)
    prompts = [rng.integers(1, 128, size=n).astype(np.int32) for n in (5, 11, 3)]
    kw = dict(max_batch=2, max_seq_length=16)
    jeng = JaxEngine(fparams, fcfg.replace(kv_cache_dtype="int8"), **kw)
    ids = [jeng.submit(p, 8) for p in prompts]
    done = jeng.run()
    got, eng = _port_engine_tokens(tparams, tc.replace(kv_cache_dtype="int8"), prompts, 8, **kw)
    assert got == [done[i].generated for i in ids]
    assert eng.cache[0]["k"].dtype == torch.int8 and bool(eng.cache[0]["ks"].any())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_engine_past_64_slots_matches_fewer_slots_on_the_card(model, cuda, compute):
    """70 requests at once through a 72-slot engine on the card (K7 and K9 past
    64 rows, in f32 and bf16 compute): each request's greedy tokens equal the
    same request's in an 8-slot engine. A row's sums do not depend on the
    slot count (K7 and K9 split K the same way in every 32-row tile, K8 and
    the lm_head work per row), so the tokens are equal, not close."""
    from lit_llama_tpu_torch.ops import fused_layer as tfl

    _, _, tparams, tc = model
    tc = tc.replace(compute_dtype=compute)

    def to(tree):
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [to(v) for v in tree]
        return tree.to(cuda)

    params = to(tfl.add_decode_layout(tparams))  # the layout K7 and K9 read in bf16
    rng = np.random.default_rng(72)
    prompts = [rng.integers(1, 128, size=int(n)).astype(np.int64) for n in rng.integers(3, 20, size=70)]
    toks = {}
    for slots in (72, 8):
        eng = DecodeEngine(params, tc, max_batch=slots, max_seq_length=64, steps_per_sync=4, device=cuda)
        assert eng.serve_fused
        before = tfl.block_head_fused.launches
        ids = [eng.submit(p, 5) for p in prompts]
        done = eng.run()
        assert tfl.block_head_fused.launches > before
        toks[slots] = [done[i].generated for i in ids]
    assert toks[72] == toks[8]
