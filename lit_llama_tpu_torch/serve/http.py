"""Serve a LLaMA checkpoint over HTTP with continuous batching (counterpart of
the JAX package's root serve.py: the same flags and JSON, plus ``--device``).

    python -m lit_llama_tpu_torch.serve.http --checkpoint_path ckpt/lit-llama.pth \
        --tokenizer_path ckpt/tokenizer.model [--quantize gptq.int4] [--port 8000] [--device cpu]

A stdlib JSON API in front of ``serve.DecodeEngine``. One loop thread owns the
device: it alone calls ``step_once``. HTTP threads only encode the prompt,
queue the request (``DecodeEngine.submit`` is host work) and wait on an event
of their own.

  POST /generate  {"prompt": str, "max_new_tokens": int, "temperature": float,
                   "top_k": int}  ->  {"text", "tokens", "ttft_ms", "total_ms"}
  GET  /health    -> {"active": n, "queued": n}

Any other path is 404, a ``ValueError`` (a ``top_k`` beyond the engine's cap
of 200, a malformed field or body) is 400, any other exception 500.
As in the JAX server, a request waits for its result without a timeout: if
the loop thread dies, requests hang, so callers bound their own calls. Unlike
it, the listening socket takes a backlog of 128 connections (the JAX server
keeps ``socketserver``'s 5). ``HTTPService`` builds the server in-process
(port 0 picks a free one).
"""

from __future__ import annotations

import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional


class _Server:
    """The engine, its lock, and the events that HTTP threads wait on."""

    def __init__(self, engine, tokenizer):
        self.engine = engine
        self.tokenizer = tokenizer
        self.lock = threading.Lock()
        self.events = {}
        self.results = {}
        self.running = True

    def submit(self, prompt_text: str, max_new_tokens: int, temperature: float, top_k: Optional[int]):
        encoded = self.tokenizer.encode(prompt_text, bos=True, eos=False)
        ev = threading.Event()
        with self.lock:
            rid = self.engine.submit(encoded, max_new_tokens, temperature=temperature, top_k=top_k,
                                     eos_id=self.tokenizer.eos_id)
            self.events[rid] = ev
        ev.wait()
        return self.results.pop(rid)

    def loop(self) -> None:
        while self.running:
            with self.lock:
                has = self.engine.has_work()
                done = self.engine.step_once() if has else []
                for req in done:
                    self.results[req.id] = req
                    self.events.pop(req.id).set()
            if not has:
                time.sleep(0.005)


def _handler(server: _Server):
    engine, tokenizer = server.engine, server.tokenizer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._json(200, {"active": engine.n_active, "queued": len(engine.queue)})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                self._json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                top_k = body.get("top_k")
                req = server.submit(body.get("prompt", ""), int(body.get("max_new_tokens", 50)),
                                    float(body.get("temperature", 0.8)), None if top_k is None else int(top_k))
                self._json(200, {
                    "text": tokenizer.decode(req.generated),
                    "tokens": req.generated,
                    "ttft_ms": None if req.ttft is None else round(req.ttft * 1e3, 1),
                    "total_ms": round((req.done_t - req.submit_t) * 1e3, 1),
                })
            except ValueError as e:
                self._json(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001
                self._json(500, {"error": str(e)})

    return Handler


class _HTTPServer(ThreadingHTTPServer):
    # socketserver's listen backlog of 5 drops the connections of a burst
    # beyond it, and their clients retry a second later (or see a reset)
    request_queue_size = 128


class HTTPService:
    """The loop thread over ``engine`` and a ``ThreadingHTTPServer`` on
    (host, port). ``start()`` serves from a daemon thread (in-process use);
    ``serve_forever()`` serves from the caller's; ``shutdown()`` stops both."""

    def __init__(self, engine, tokenizer, host: str = "127.0.0.1", port: int = 8000):
        self.server = _Server(engine, tokenizer)
        self.httpd = _HTTPServer((host, port), _handler(self.server))
        self.loop_thread = threading.Thread(target=self.server.loop, daemon=True)
        self.loop_thread.start()
        self._serve_thread = None

    @property
    def url(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "HTTPService":
        self._serve_thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._serve_thread.start()
        return self

    def serve_forever(self) -> None:
        try:
            self.httpd.serve_forever()
        finally:
            self.server.running = False

    def shutdown(self) -> None:
        """Stop serving and the loop thread (again: a no-op)."""
        if self._serve_thread is not None:
            self.httpd.shutdown()
            self._serve_thread.join()
            self._serve_thread = None
        self.httpd.server_close()
        self.server.running = False
        self.loop_thread.join()


def main(
    checkpoint_path: Path = Path("checkpoints/lit-llama/7B/lit-llama.pth"),
    tokenizer_path: Path = Path("checkpoints/lit-llama/tokenizer.model"),
    quantize: Optional[str] = None,
    model_size: Optional[str] = None,
    host: str = "127.0.0.1",
    port: int = 8000,
    max_batch: int = 8,
    max_seq_length: Optional[int] = None,
    steps_per_sync: int = 4,
    model_parallel: int = 1,
    kv_cache_dtype: Optional[str] = None,
    device: Optional[str] = None,
) -> None:
    """Serve a model over HTTP with continuous batching.

    Args:
        checkpoint_path: The checkpoint path to load (.pth or native dir).
        tokenizer_path: The tokenizer path to load.
        quantize: Whether to quantize the model: "llm.int8" or "gptq.int4".
        model_size: Override the model preset if it cannot be inferred.
        host: Bind address.
        port: Bind port.
        max_batch: Concurrent decode slots.
        max_seq_length: KV-cache length (default: model block_size).
        steps_per_sync: Decode steps per host sync (latency/throughput knob).
        model_parallel: Tensor-parallel degree; the port serves from one card (1).
        kv_cache_dtype: KV-cache storage: None (compute dtype) or "int8" (half memory).
        device: cuda (the default) or cpu (the plain PyTorch path).
    """
    if model_parallel != 1:
        raise NotImplementedError("model_parallel > 1: multi-device serving is a later slice of the port")
    from lit_llama_tpu_torch.data.tokenizer import Tokenizer
    from lit_llama_tpu_torch.serve.engine import DecodeEngine
    from lit_llama_tpu_torch.utils.device import resolve_device
    from lit_llama_tpu_torch.utils.loader import load_model
    from lit_llama_tpu_torch.utils.memory import print_peak_memory

    dev = resolve_device(device)
    print("Loading model ...", file=sys.stderr)
    params, config = load_model(Path(checkpoint_path), quantize, model_size, device=dev)
    if kv_cache_dtype:
        config = config.replace(kv_cache_dtype=kv_cache_dtype)
    tokenizer = Tokenizer(tokenizer_path)
    engine = DecodeEngine(params, config, max_batch=max_batch, max_seq_length=max_seq_length,
                          steps_per_sync=steps_per_sync, device=dev)
    print("warming up (building and loading the kernels)...", file=sys.stderr)
    engine.warmup()
    print_peak_memory(dev)  # weights + slotted KV cache
    service = HTTPService(engine, tokenizer, host, port)
    print(f"serving on {service.url}", file=sys.stderr, flush=True)
    service.serve_forever()


if __name__ == "__main__":
    from lit_llama_tpu_torch.utils.cli import cli

    cli(main)
