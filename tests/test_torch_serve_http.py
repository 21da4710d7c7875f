"""The HTTP server on the CPU: concurrent greedy requests through a server on
a loopback port return the JAX ``DecodeEngine``'s tokens on the same weights,
``text`` decodes ``tokens``, ``/health`` has its keys, unknown paths are 404,
a ``ValueError`` is 400 and any other exception 500; then ``python -m
lit_llama_tpu_torch.serve.http`` in a subprocess. Every HTTP call has a
timeout and a finalizer stops every server, so a hang fails the test."""

import dataclasses
import errno
import json
import selectors
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from lit_llama_tpu import LLaMAConfig, init_params
from lit_llama_tpu.serve.engine import DecodeEngine as JaxEngine
from lit_llama_tpu_torch.data.tokenizer import Tokenizer
from lit_llama_tpu_torch.models import config as tcfg
from lit_llama_tpu_torch.serve import DecodeEngine
from lit_llama_tpu_torch.serve.http import HTTPService, _handler, _HTTPServer
from lit_llama_tpu_torch.utils.convert import pytree_to_lit
from lit_llama_tpu_torch.utils.jax_params import params_from_numpy

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 30
CFG = dict(block_size=128, vocab_size=256, n_layer=2, n_head=4, n_embd=64)
PROMPTS = ["the quick brown fox", "a lazy dog", "pack my box with five dozen jugs", "how vexingly quick",
           "daft zebras jump", "the the the fox"]
NEW_TOKENS = [6, 9, 4, 12, 7, 10]


def _call(url, body=None, timeout=TIMEOUT):
    """(status, JSON) of a GET (body None) or POST."""
    data = None if body is None else (body if isinstance(body, bytes) else json.dumps(body).encode())
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    (d / "corpus.txt").write_text("\n".join(PROMPTS * 3 + ["over liquor and wizards boxing"]))
    Tokenizer.train(str(d / "corpus.txt"), str(d), 120)
    cfg = LLaMAConfig(**CFG)
    jparams = init_params(cfg, jax.random.PRNGKey(3))
    tc = tcfg.LLaMAConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                             if f.name not in ("lora", "adapter")})
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return d, cfg, jparams, tc, tparams


@pytest.fixture
def service(model, request):
    d, _, _, tc, tparams = model
    engine = DecodeEngine(tparams, tc, max_batch=4, max_seq_length=64, steps_per_sync=3, device="cpu")
    svc = HTTPService(engine, Tokenizer(d / "tokenizer.model"), "127.0.0.1", 0).start()
    request.addfinalizer(svc.shutdown)
    return svc


def test_concurrent_requests_match_the_jax_engine(model, service):
    d, cfg, jparams, _, _ = model
    tok = Tokenizer(d / "tokenizer.model")
    assert _call(service.url + "/health") == (200, {"active": 0, "queued": 0})
    with ThreadPoolExecutor(len(PROMPTS)) as pool:
        futs = [pool.submit(_call, service.url + "/generate",
                            {"prompt": p, "max_new_tokens": n, "temperature": 0})
                for p, n in zip(PROMPTS, NEW_TOKENS)]
        replies = [f.result(timeout=TIMEOUT) for f in futs]
    assert service.loop_thread.is_alive()
    eng = JaxEngine(jparams, cfg, max_batch=4, max_seq_length=64, steps_per_sync=3)
    ids = [eng.submit(tok.encode(p, bos=True).numpy(), n, temperature=0.0, eos_id=tok.eos_id)
           for p, n in zip(PROMPTS, NEW_TOKENS)]
    done = eng.run()
    for (status, body), rid, n in zip(replies, ids, NEW_TOKENS):
        assert status == 200 and set(body) == {"text", "tokens", "ttft_ms", "total_ms"}
        assert body["tokens"] == [int(t) for t in done[rid].generated]
        assert 0 < len(body["tokens"]) <= n
        assert body["text"] == tok.decode(body["tokens"])
        assert 0 <= body["ttft_ms"] <= body["total_ms"]
    assert _call(service.url + "/health") == (200, {"active": 0, "queued": 0})


def test_errors_and_health(service):
    assert _call(service.url + "/nowhere")[0] == 404
    assert _call(service.url + "/generate/x", {"prompt": "a"})[0] == 404
    # a top_k beyond the engine's cap (200), a malformed field, a malformed body: ValueError -> 400
    for body in ({"prompt": "a", "top_k": 1000}, {"prompt": "a", "max_new_tokens": "many"}, b"{not json"):
        status, reply = _call(service.url + "/generate", body)
        assert status == 400 and "error" in reply, body
    status, reply = _call(service.url + "/generate", {"prompt": ["not", "text"]})
    assert status == 500 and "error" in reply
    status, reply = _call(service.url + "/generate", {"prompt": "the fox", "max_new_tokens": 3, "top_k": 5,
                                                      "temperature": 0.7})
    assert status == 200 and 0 < len(reply["tokens"]) <= 3
    status, health = _call(service.url + "/health")
    assert status == 200 and set(health) == {"active", "queued"}
    assert service.loop_thread.is_alive()


def test_serve_entry_point_in_a_subprocess(model, tmp_path):
    """``python -m lit_llama_tpu_torch.serve.http --device cpu --port 0``:
    it reports its address, answers /health and a greedy request with the
    in-process engine's tokens, and refuses ``--model_parallel 2``."""
    d, _, _, tc, tparams = model
    torch.save(pytree_to_lit(tparams, tc), tmp_path / "lit-llama.pth")
    (tmp_path / "config.json").write_text(json.dumps(CFG))
    log = tmp_path / "serve.log"
    cmd = [sys.executable, "-m", "lit_llama_tpu_torch.serve.http", "--device", "cpu", "--port", "0",
           "--checkpoint_path", str(tmp_path / "lit-llama.pth"), "--tokenizer_path", str(d / "tokenizer.model"),
           "--max_batch", "2", "--max_seq_length", "64"]
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT)
    try:
        url = None
        deadline = time.monotonic() + 120
        while url is None and time.monotonic() < deadline and proc.poll() is None:
            time.sleep(0.2)
            lines = [ln for ln in log.read_text().splitlines() if ln.startswith("serving on ")]
            url = lines[0].split()[-1] if lines else None
        assert url, log.read_text()[-3000:]
        assert _call(url + "/health") == (200, {"active": 0, "queued": 0})
        status, reply = _call(url + "/generate", {"prompt": PROMPTS[0], "max_new_tokens": 5, "temperature": 0})
        tok = Tokenizer(d / "tokenizer.model")
        eng = DecodeEngine(tparams, tc, max_batch=2, max_seq_length=64, device="cpu")
        rid = eng.submit(tok.encode(PROMPTS[0], bos=True), 5, eos_id=tok.eos_id)
        assert status == 200 and reply["tokens"] == eng.run()[rid].generated
    finally:
        proc.kill()
        proc.wait(timeout=TIMEOUT)
    bad = subprocess.run(cmd + ["--model_parallel", "2"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert bad.returncode != 0 and "multi-device" in bad.stderr


def test_a_burst_of_connections_is_taken_at_once(service):
    """64 clients connecting at once to a listening socket that accepts none
    yet: the kernel completes a connection while the accept queue has room,
    so at the server's backlog of 128 all 64 complete (at socketserver's 5
    the sixth would be the last, the rest's SYNs dropped until a client gives
    up); then the server accepts them and every /health answers 200. No step
    is held to a wall-clock bound but TIMEOUT."""
    httpd = _HTTPServer(("127.0.0.1", 0), _handler(service.server))  # listening, not accepting
    addr = httpd.server_address
    socks, pending, serving = [], selectors.DefaultSelector(), None
    try:
        for _ in range(64):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            socks.append(s)
            s.setblocking(False)
            assert s.connect_ex(addr) in (0, errno.EINPROGRESS)
            pending.register(s, selectors.EVENT_WRITE)
        deadline = time.monotonic() + TIMEOUT
        while pending.get_map() and time.monotonic() < deadline:
            for key, _ in pending.select(timeout=max(deadline - time.monotonic(), 0)):
                assert key.fileobj.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR) == 0
                pending.unregister(key.fileobj)
        assert not pending.get_map(), f"{len(pending.get_map())} of 64 connections not completed"
        for s in socks:
            s.setblocking(True)
            s.settimeout(TIMEOUT)
            s.sendall(b"GET /health HTTP/1.1\r\nHost: localhost\r\nConnection: close\r\n\r\n")
        serving = threading.Thread(target=httpd.serve_forever, daemon=True)
        serving.start()
        for s in socks:
            reply = b""
            while chunk := s.recv(4096):
                reply += chunk
            assert reply.split(b"\r\n", 1)[0].split()[1] == b"200", reply[:200]
    finally:
        pending.close()
        for s in socks:
            s.close()
        if serving is not None:  # shutdown() waits for a serve_forever that ran
            httpd.shutdown()
        httpd.server_close()


def test_service_shutdown_stops_both_threads(service):
    serve_thread = service._serve_thread
    service.shutdown()
    assert not service.loop_thread.is_alive() and not serve_thread.is_alive()
    service.shutdown()  # a second call (the finalizer's) is a no-op
