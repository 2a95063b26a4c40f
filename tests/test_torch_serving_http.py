"""The port's HTTP front (paddle_tpu_torch.serving.http) over a running
engine, on the CPU in f32.

The port's versions of tests/test_serving.py's stream-and-scrape case
and tests/test_serving_resilience.py's HTTP cases: JSONL token streams
(greedy and seeded sampled, token-identical to the JAX engine's), the
Prometheus scrape under the JAX exporter's names, a mid-stream engine
error ending the stream cleanly, 429 + Retry-After on a shed, a request
timeout and a client disconnect each cancelling their request, and the
readiness/liveness/traces endpoints. Every socket and wait has a
timeout; every engine and server is stopped on the way out (`with`).
"""
import json
import socket
import struct
import time
import urllib.error
import urllib.request
from urllib.parse import urlparse

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import ServingEngine as JaxServingEngine

from paddle_tpu_torch import monitor
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
from paddle_tpu_torch.serving import (SamplingParams, ServingEngine,
                                      ServingHTTPServer)

_MODEL = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
              max_seq_len=128, dropout=0.0, initializer_range=0.2)
_ENGINE = dict(max_slots=2, block_size=8, prefill_chunk=8,
               max_model_len=64, dtype=None)
_SAMPLED = dict(decode_strategy="sampling", seed=3, top_k=40, top_p=0.9,
                temperature=0.8)
_WAIT_S = 60


@pytest.fixture(scope="module")
def models():
    paddle.seed(11)
    jm = JaxGPT(JaxGPTConfig(use_flash_attention=False, **_MODEL))
    tm = GPTForPretraining(GPTConfig(**_MODEL), device="cpu")
    load_jax_params(tm, [(n, np.asarray(p._value))
                         for n, p in jm.named_parameters()])
    return jm, tm


def _prompt():
    return np.random.RandomState(0).randint(0, 512, (6,)).tolist()


@pytest.fixture(scope="module")
def refs(models):
    """The JAX engine's greedy and sampled streams of `_prompt()`."""
    jm, _ = models
    eng = JaxServingEngine(jm, **_ENGINE)
    g = eng.submit(_prompt(), JaxSamplingParams(max_new_tokens=6))
    s = eng.submit(_prompt(), JaxSamplingParams(max_new_tokens=6,
                                                **_SAMPLED))
    eng.run_until_idle(max_steps=2000)
    return g.output_tokens, s.output_tokens


def _engine(tm, **kw):
    return ServingEngine(tm, device="cpu", **{**_ENGINE, **kw})


def _slow_steps(eng, seconds=0.01):
    """Make every decode step take at least `seconds`: a 100-token
    request then outlives a 0.05 s request timeout or a client's early
    disconnect by far, so the cancel lands on a running request."""
    step = eng._decode_step

    def slow(*a, **k):
        time.sleep(seconds)
        return step(*a, **k)

    eng._decode_step = slow


def _post(url, body, timeout=_WAIT_S):
    return urllib.request.urlopen(urllib.request.Request(
        url + "/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}), timeout=timeout)


def _http_error(url, body):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, body)
    return e.value


def test_http_front_streams_and_scrapes(models, refs):
    _, tm = models
    greedy_ref, sampled_ref = refs
    eng = _engine(tm)
    with eng, ServingHTTPServer(eng, port=0) as srv:
        r = _post(srv.url, {"prompt": _prompt(), "max_new_tokens": 6,
                            "stream": True, "request_id": "abc"})
        lines = [json.loads(ln) for ln in
                 r.read().decode().strip().splitlines()]
        assert [ln["token"] for ln in lines[:-1]] == greedy_ref
        assert all(ln["request_id"] == "abc" for ln in lines)
        assert lines[-1]["done"] and lines[-1]["tokens"] == greedy_ref
        # a seeded sampled request, answered whole
        body = json.loads(_post(srv.url, {"prompt": _prompt(),
                                          "max_new_tokens": 6,
                                          **_SAMPLED}).read().decode())
        assert body["tokens"] == sampled_ref
        assert body["stats"]["n_tokens"] == 6
        m = urllib.request.urlopen(srv.url + "/metrics",
                                   timeout=_WAIT_S).read().decode()
        for series in ("paddle_tpu_serving_kv_block_utilization",
                       "# TYPE paddle_tpu_serving_ttft_ms histogram",
                       'paddle_tpu_serving_ttft_ms_bucket{le="+Inf"}',
                       "paddle_tpu_serving_ttft_ms_count",
                       "# TYPE paddle_tpu_serving_tokens_generated counter",
                       "paddle_tpu_serving_ttft_p99_ms",
                       "paddle_tpu_serving_queue_depth"):
            assert series in m, series
        # a malformed body -> 400, one that can never fit -> 429
        assert _http_error(srv.url, {}).code == 400
        assert _http_error(srv.url, {"prompt": list(range(60)),
                                     "max_new_tokens": 10}).code == 429
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(srv.url + "/nope", timeout=_WAIT_S)
        assert e.value.code == 404


def test_healthz_livez_traces_and_drain(models):
    _, tm = models
    eng = _engine(tm)
    with eng, ServingHTTPServer(eng, port=0) as srv:
        _post(srv.url, {"prompt": _prompt(), "max_new_tokens": 4}).read()
        r = urllib.request.urlopen(srv.url + "/healthz", timeout=_WAIT_S)
        health = json.loads(r.read().decode())
        assert r.status == 200 and health["status"] == "ok"
        assert "serving.kv_blocks_used" in health["serving"]
        assert all(k.startswith("serving.") for k in health["serving"])
        traces = json.loads(urllib.request.urlopen(
            srv.url + "/traces?n=5", timeout=_WAIT_S).read().decode())
        assert traces["tracing"] and traces["traces"]
        tr = traces["traces"][0]
        assert tr["kind"] == "reqtrace" and tr["outcome"] == "finished"
        assert {"queued", "prefill_chunk", "decode", "finalize"} <= \
            {sp["kind"] for sp in tr["spans"]}
        assert eng.drain(timeout=_WAIT_S) is True
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(srv.url + "/healthz", timeout=_WAIT_S)
        assert e.value.code == 503
        assert json.loads(e.value.read().decode())["status"] == "draining"
        assert urllib.request.urlopen(srv.url + "/livez",
                                      timeout=_WAIT_S).status == 200
        e = _http_error(srv.url, {"prompt": _prompt(), "max_new_tokens": 4})
        assert e.code == 503 and int(e.headers["Retry-After"]) >= 1
        eng.resume_admission()
        assert urllib.request.urlopen(srv.url + "/healthz",
                                      timeout=_WAIT_S).status == 200


def test_http_midstream_error_ends_stream_cleanly(models):
    """An engine error mid-stream ends the JSONL stream with a final
    {"error": ...} event and a valid chunked epilogue; the non-stream
    path answers 500 with the error."""
    _, tm = models
    eng = _engine(tm)

    def boom(*a, **k):
        raise ValueError("injected raising decode")

    with eng, ServingHTTPServer(eng, port=0) as srv:
        eng._decode_step = boom
        r = _post(srv.url, {"prompt": _prompt(), "max_new_tokens": 6,
                            "stream": True})
        lines = [json.loads(ln) for ln in
                 r.read().decode().strip().splitlines()]
        assert "injected raising decode" in lines[-1]["error"]
        assert lines[-1]["status"] == "failed"
        e = _http_error(srv.url, {"prompt": _prompt(), "max_new_tokens": 6})
        assert e.code == 500
        assert "injected raising decode" in \
            json.loads(e.read().decode())["error"]


def test_http_shed_answers_429_with_retry_after(models, refs):
    _, tm = models
    eng = _engine(tm, max_queue=2)
    eng.admission.tpot_ema_ms = 50.0
    with ServingHTTPServer(eng, port=0) as srv:   # the loop is not running
        handles = [eng.submit(_prompt(), SamplingParams(max_new_tokens=6))
                   for _ in range(2)]
        e = _http_error(srv.url, {"prompt": _prompt(), "max_new_tokens": 6,
                                  "queue_wait_deadline_s": 0.001})
        assert e.code == 429 and int(e.headers["Retry-After"]) >= 1
        payload = json.loads(e.read().decode())
        assert payload["status"] == "shed" and payload["queue_depth"] == 2
        # a malformed priority is a client error (400), never a shed
        assert _http_error(srv.url, {"prompt": _prompt(),
                                     "priority": "urgent"}).code == 400
        eng.run_until_idle(max_steps=2000)
        assert all(h.output_tokens == refs[0] for h in handles)
    assert eng._counts["shed"] == 1


def test_http_request_timeout_cancels_request(models):
    _, tm = models
    eng = _engine(tm, max_model_len=128)
    _slow_steps(eng)
    before = monitor.get("serving.cancelled", 0)
    with eng, ServingHTTPServer(eng, port=0, request_timeout=0.05) as srv:
        r = _post(srv.url, {"prompt": _prompt(), "max_new_tokens": 100,
                            "stream": True})
        lines = [json.loads(ln) for ln in
                 r.read().decode().strip().splitlines()]
        assert "error" in lines[-1]         # a clean terminal event
        assert monitor.get("serving.cancelled", 0) > before
        deadline = time.monotonic() + 30
        while eng.pool.num_used and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.pool.num_used == 0       # blocks released, not pinned


def test_http_client_disconnect_cancels_request(models):
    _, tm = models
    eng = _engine(tm, max_model_len=128)
    _slow_steps(eng)
    before = monitor.get("serving.cancelled", 0)
    drops = monitor.get("serving.client_disconnects", 0)
    with eng, ServingHTTPServer(eng, port=0) as srv:
        u = urlparse(srv.url)
        body = json.dumps({"prompt": _prompt(), "max_new_tokens": 100,
                           "stream": True}).encode()
        sk = socket.create_connection((u.hostname, u.port), timeout=30)
        try:
            sk.sendall(b"POST /generate HTTP/1.1\r\nHost: t\r\n"
                       b"Content-Type: application/json\r\n"
                       + f"Content-Length: {len(body)}\r\n\r\n".encode()
                       + body)
            got = b""
            while got.count(b'"token"') < 2:
                part = sk.recv(4096)
                if not part:
                    break
                got += part
            sk.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                          struct.pack("ii", 1, 0))
        finally:
            sk.close()                      # RST mid-stream
        deadline = time.monotonic() + 30
        while monitor.get("serving.client_disconnects", 0) <= drops and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert monitor.get("serving.client_disconnects", 0) > drops
        assert monitor.get("serving.cancelled", 0) > before
        deadline = time.monotonic() + 30
        while eng.pool.num_used and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.pool.num_used == 0       # blocks back, not pinned
