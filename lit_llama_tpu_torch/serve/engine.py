"""Continuous-batching decode engine (counterpart of
lit_llama_tpu/serve/engine.py).

A slotted KV cache where every batch slot runs an independent request at its
own position: new requests prefill into free slots while other slots keep
decoding, and finished slots are recycled at once. The scheduler is plain
Python on the host: admit from the queue, step, harvest.

The device work is
* the prefill of one slot: ``llama.forward`` over the prompt (or a chunk of
  it) against a view of the slot's cache rows, written in place, then the
  first token sampled from the last position;
* the decode chunk: ``steps_per_sync`` steps for ALL slots through
  ``llama.forward(slot_pos=...)`` (K7, K8, K9 per block and K3 for the
  lm_head on the card). Tokens and positions stay on the device between the
  steps of a chunk; the host reads the chunk's tokens once, at its end.
  Inactive slots compute and are ignored on the host.

Temperature and ``top_k`` are per request; the engine-wide ``top_k`` is both
the default and the cap (one exact top-``cap`` sort serves every slot).

Against the JAX engine: there is no compiler to bound, so a prompt prefills at
its true length and the engine keeps no ``prefill_buckets``; the cache length
is taken as given and never shortened (the JAX engine cuts S to a multiple of
16 for its packed cache); a slot parked in the middle of a chunked prefill
stays at row S - 1 for the whole decode chunk (the JAX step advances it, and
past S - 1 its writes wrap into the prompt rows already prefilled); the
``mesh`` (tensor and data parallel serving) is a later slice.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from lit_llama_tpu_torch.models import llama
from lit_llama_tpu_torch.models.config import LLaMAConfig
from lit_llama_tpu_torch.ops.fused_layer import maybe_prepare_fused
from lit_llama_tpu_torch.ops.rope import build_rope_cache
from lit_llama_tpu_torch.utils.device import resolve_device, torch_dtype


@dataclass
class Request:
    id: int
    prompt: np.ndarray
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0  # 0 = no top-k filtering for this request
    eos_id: Optional[int] = None
    # filled by the engine
    prefilled: int = 0  # prompt tokens already written to the slot's cache
    generated: List[int] = field(default_factory=list)
    submit_t: float = field(default_factory=time.perf_counter)
    first_token_t: Optional[float] = None
    done_t: Optional[float] = None

    @property
    def ttft(self) -> Optional[float]:
        return None if self.first_token_t is None else self.first_token_t - self.submit_t


def _sample_rows(logits, temps, top_ks, max_top_k: Optional[int],
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Per-slot sampling from (B, V) f32 logits: greedy where temperature is 0.

    ``top_ks`` is a per-slot int vector (0 disables top-k for that slot);
    ``max_top_k`` is the cap: one exact top-``max_top_k`` sort serves every
    slot, each taking its own k-th value as the cutoff (the JAX engine's sort
    is exact too; its noise comes from per-slot keys, here from one
    generator)."""
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
    if max_top_k is not None:
        vals = torch.topk(scaled, max_top_k, dim=-1).values  # (B, cap), descending
        idx = torch.clamp(top_ks, 1, max_top_k).long()[:, None] - 1
        kth = torch.gather(vals, 1, idx)
        cut = (top_ks > 0)[:, None] & (scaled < kth)
        scaled = torch.where(cut, torch.full_like(scaled, float("-inf")), scaled)
    sampled = torch.multinomial(torch.softmax(scaled, dim=-1), 1, generator=generator)[:, 0]
    return torch.where(temps == 0.0, greedy, sampled)


class DecodeEngine:
    def __init__(
        self,
        params,
        config: LLaMAConfig,
        max_batch: int = 8,
        max_seq_length: Optional[int] = None,
        top_k: Optional[int] = 200,
        seed: int = 0,
        steps_per_sync: int = 4,
        prefill_chunk: int = 512,
        prefill_budget: Optional[int] = 1024,
        mesh=None,
        device=None,
    ):
        """``params``: the weights on ``device`` (the card when None),
        stacked or unstacked, with a LoRA overlay where ``config.lora`` says
        so. Int4 weights that the fused step takes are prepared as
        ``fused_layer.maybe_prepare_fused`` does (once; prepared params pass
        as they are) and decode through the fused block halves, K7 with the
        LoRA operand; any other layout takes the plain blocks.

        ``prefill_chunk`` / ``prefill_budget``: admission control, so that a
        burst of long prompts cannot starve the decodes in flight. A prompt
        longer than ``prefill_chunk`` prefills in chunks of that size, spread
        over successive ``step_once`` calls; each ``step_once`` spends at most
        ``prefill_budget`` prompt tokens on prefill (always at least one chunk)
        before it runs the decode chunk. ``prefill_budget=None`` drains the
        queue at admission; ``prefill_chunk=0`` prefills every prompt whole.

        There are no prefill buckets: they bound the JAX engine's compiles,
        and a prompt here prefills at its true length. ``max_seq_length`` is
        used as given, capped by ``config.block_size``."""
        if mesh is not None:
            raise NotImplementedError("tensor- and data-parallel serving (mesh) is a later slice")
        self.device = resolve_device(device)
        if params["wte"].device.type != self.device.type:
            raise ValueError(f"params lie on {params['wte'].device}, the engine was asked for {self.device}")
        # int4 layers the fused step takes are prepared here, as the JAX engine
        # does (a no-op for params already prepared); a LoRA overlay is folded
        # into K7's operand on the way
        self.params, config = maybe_prepare_fused(llama.unstack_layers(params), config)
        self.config = config
        self.B = max_batch
        self.S = min(max_seq_length or config.block_size, config.block_size)
        self.top_k = None if top_k is None else min(top_k, config.padded_vocab_size)
        self.steps_per_sync = max(1, steps_per_sync)
        self.prefill_chunk = min(prefill_chunk or 0, self.S)
        self.prefill_budget = prefill_budget
        self.rope = build_rope_cache(config.block_size, config.head_size, device=self.device)
        self.cache = llama.init_kv_cache(
            config, self.B, self.S, torch_dtype(config.compute_dtype), device=self.device)
        self.slot_pos = np.zeros((self.B,), np.int32)
        self.last_tok = np.zeros((self.B,), np.int64)
        self.temps = np.zeros((self.B,), np.float32)
        self.top_ks = np.zeros((self.B,), np.int32)  # 0 = slot top-k disabled
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        # host-side state
        self.slot_req: List[Optional[Request]] = [None] * self.B
        self.queue: List[Request] = []
        self.finished: Dict[int, Request] = {}
        self._ids = itertools.count()
        self.decode_steps = 0  # device decode steps run
        self.prefills = 0  # prefill forwards run (whole prompts and chunks)

    # -- device work ---------------------------------------------------------

    def _on_device(self, array, dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(array)).to(self.device, dtype)

    def _sample(self, logits, temps, top_ks) -> torch.Tensor:
        return _sample_rows(logits.float(), temps, top_ks, self.top_k, self.generator)

    @torch.no_grad()
    def _prefill(self, b: int, tokens: np.ndarray, start: int, req: Request) -> torch.Tensor:
        """Prompt tokens [start, start + len(tokens)) of slot ``b``: writes the
        slot's cache rows in place and samples from the last position (only
        the final chunk's sample is used). Returns the token, on the device."""
        slot_cache = [{name: c[b : b + 1] for name, c in kv.items()} for kv in self.cache]
        toks = self._on_device(tokens, torch.long)[None]
        if start == 0:
            logits, _ = llama.forward(self.params, toks, self.config, rope_cache=self.rope,
                                      kv_cache=slot_cache, prefill_from_zero=True)
        else:
            logits, _ = llama.forward(self.params, toks, self.config, rope_cache=self.rope,
                                      kv_cache=slot_cache, input_pos=range(start, start + len(tokens)))
        self.prefills += 1
        temps = torch.full((1,), req.temperature, dtype=torch.float32, device=self.device)
        top_ks = torch.full((1,), req.top_k, dtype=torch.int32, device=self.device)
        return self._sample(logits[:, -1], temps, top_ks)[0]

    @torch.no_grad()
    def _step(self, n_steps: int) -> np.ndarray:
        """``n_steps`` decode steps for all slots, wholly on the device: the
        sampled token feeds the next step's embedding lookup and the positions
        advance there. Returns the (n_steps, B) tokens after ONE copy to the
        host."""
        tok = self._on_device(self.last_tok, torch.long)
        pos = self._on_device(self.slot_pos, torch.int32)
        temps = self._on_device(self.temps, torch.float32)
        top_ks = self._on_device(self.top_ks, torch.int32)
        # a slot parked mid-prefill holds row S - 1 for the whole chunk
        advance = self._on_device(
            [r is not None and r.prefilled >= len(r.prompt) for r in self.slot_req], torch.int32)
        greedy = not bool((self.temps > 0).any())
        toks = []
        for _ in range(n_steps):
            logits, _ = llama.forward(self.params, tok[:, None], self.config, rope_cache=self.rope,
                                      slot_pos=pos, kv_cache=self.cache)
            logits = logits[:, -1]
            tok = torch.argmax(logits, dim=-1) if greedy else self._sample(logits, temps, top_ks)
            pos = pos + advance
            toks.append(tok)
        self.decode_steps += n_steps
        return torch.stack(toks).cpu().numpy()

    # -- public API ---------------------------------------------------------

    def warmup(self) -> None:
        """Run a short request (and, where prompts can exceed the chunk, the
        longest one) before serving traffic, so that building and loading the
        kernels and the device's first-use set-up do not land in the first
        request's time to first token."""
        lengths = {min(8, self.S - 1)}
        if self.prefill_chunk and self.S - 1 > self.prefill_chunk:
            lengths.add(self.S - 1)
        for n in sorted(lengths):
            # max_new_tokens=2: one token comes from the prefill itself, the
            # second from a decode chunk
            self.submit(np.ones((n,), np.int64), 2)
            self.run()

    def submit(
        self,
        prompt: np.ndarray,
        max_new_tokens: int,
        temperature: float = 0.0,
        top_k: Optional[int] = None,  # None -> engine default; must be <= the engine cap
        eos_id: Optional[int] = None,
    ) -> int:
        if top_k is None:
            tk = self.top_k or 0
        else:
            if self.top_k is None:
                raise ValueError(
                    "per-request top_k requires the engine to be built with a "
                    "top_k cap (DecodeEngine(top_k=...)); this engine has none"
                )
            if not (1 <= top_k <= self.top_k):
                raise ValueError(f"top_k={top_k} out of range [1, {self.top_k}] (the engine's cap)")
            tk = top_k
        prompt = np.asarray(prompt, np.int64)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        limit = self.S - 1  # an over-long prompt keeps its last S - 1 tokens
        if len(prompt) > limit:
            prompt = prompt[-limit:]
        req = Request(next(self._ids), prompt, max_new_tokens, temperature, top_k=tk, eos_id=eos_id)
        self.queue.append(req)
        return req.id

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.slot_req)

    def has_work(self) -> bool:
        return bool(self.queue) or self.n_active > 0

    def step_once(self) -> List[Request]:
        """Admit queued requests into free slots, run ``steps_per_sync`` decode
        steps for all active slots, harvest finished requests. Returns the
        newly finished. A slot that finishes mid-chunk decodes garbage for the
        rest of the chunk (discarded; its cache is overwritten by the next
        occupant's prefill and masked decode)."""
        self._admit()
        # parked slots (prefill still in progress) do not decode usefully; skip
        # the device chunk when nothing else is running
        if not any(r is not None and r.prefilled >= len(r.prompt) for r in self.slot_req):
            return []
        return self._harvest(self._step(self.steps_per_sync))

    def run(self) -> Dict[int, Request]:
        """Drain queue + active slots to completion."""
        while self.has_work():
            self.step_once()
        out, self.finished = self.finished, {}
        return out

    # -- internals ----------------------------------------------------------

    def _prefill_some(self, b: int, req: Request, budget: int) -> int:
        """Advance slot ``b``'s prefill by whole chunks within ``budget``
        tokens (at least one chunk, so progress is guaranteed). While
        incomplete the slot is parked: slot_pos = S - 1 (the decode chunk's
        writes land on a row that is rewritten before it is ever attended)
        with temperature/top_k zeroed. Returns tokens spent."""
        T = len(req.prompt)
        C = self.prefill_chunk
        spent = 0
        tok = None
        while req.prefilled < T:
            if spent > 0 and spent >= budget:
                break
            start = req.prefilled
            n = min(C, T - start) if C and T > C else T - start
            tok = self._prefill(b, req.prompt[start : start + n], start, req)
            req.prefilled = start + n
            spent += n
        if req.prefilled < T:  # park until the next step_once
            self.slot_pos[b] = self.S - 1
            self.temps[b] = 0.0
            self.top_ks[b] = 0
            return spent
        tok = int(tok)  # the copy to the host ends the request's wait for its first token
        req.first_token_t = time.perf_counter()
        req.generated.append(tok)
        self.slot_pos[b] = T
        self.last_tok[b] = tok
        self.temps[b] = req.temperature
        self.top_ks[b] = req.top_k
        if self._finished(req):
            self._retire(b)
        return spent

    def _admit(self) -> None:
        budget = self.prefill_budget if self.prefill_budget is not None else 1 << 62
        # resume parked (mid-prefill) slots first: they were admitted earlier
        for b, req in enumerate(self.slot_req):
            if budget <= 0:
                return
            if req is not None and req.prefilled < len(req.prompt):
                budget -= self._prefill_some(b, req, budget)
        for b in range(self.B):
            if budget <= 0 or not self.queue:
                break
            if self.slot_req[b] is not None:
                continue
            req = self.queue.pop(0)
            self.slot_req[b] = req
            budget -= self._prefill_some(b, req, budget)

    def _harvest(self, toks: np.ndarray) -> List[Request]:
        """toks: (n_steps, B) chunk of sampled tokens."""
        n_steps = toks.shape[0]
        done: List[Request] = []
        for b, req in enumerate(self.slot_req):
            if req is None or req.prefilled < len(req.prompt):
                continue  # empty or parked mid-prefill: chunk output is garbage
            for s in range(n_steps):
                tok = int(toks[s, b])
                req.generated.append(tok)
                self.slot_pos[b] += 1
                self.last_tok[b] = tok
                # no retire at S - 1: past the cache the slot's writes wrap its
                # ring, so a request may generate far beyond max_seq_length
                # with a sliding context
                if self._finished(req):
                    done.append(req)
                    self._retire(b)
                    break
        return done

    def _finished(self, req: Request) -> bool:
        if req.eos_id is not None and req.generated and req.generated[-1] == req.eos_id:
            return True
        return len(req.generated) >= req.max_new_tokens

    def _retire(self, b: int) -> None:
        req = self.slot_req[b]
        req.done_t = time.perf_counter()
        self.finished[req.id] = req
        self.slot_req[b] = None
        self.slot_pos[b] = 0
        self.temps[b] = 0.0
        self.top_ks[b] = 0
