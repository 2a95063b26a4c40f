"""Stdlib HTTP front for the serving engine.

The port of paddle_tpu/serving/http.py, unchanged in its protocol: the
same endpoints, bodies, stream events and status codes, so a client or
a fleet router speaks to either engine alike. A threaded `http.server`
endpoint with zero serving dependencies: the engine process is
scrapeable and servable with nothing but the stdlib.

- **POST /generate** — body `{"prompt": [ids...], "max_new_tokens": N,
  "decode_strategy": "greedy"|"sampling", "top_k", "top_p",
  "temperature", "eos_token_id", "seed", "stream": bool,
  "priority": "interactive"|"normal"|"batch",
  "queue_wait_deadline_s", "ttft_deadline_s", "deadline_s",
  "request_id": str, "replay_tokens": [ids...]}`.
  `request_id` is a stable client-chosen id echoed on every stream
  event and telemetry record (a router joins failover halves on it); `replay_tokens` seeds a failover replay — see
  `ServingEngine.submit`. `stream=true` answers chunked
  `application/jsonl`: one `{"token": id, "request_id": ...}` line per
  generated token AS THE ENGINE EMITS IT (continuous batching means
  concurrent streams interleave at token granularity), then a
  `{"done": true, "tokens": [...], "request_id": ...}` tail — or a
  terminal `{"error": ..., "status": ...}` line when the request
  failed/expired/was cancelled, so clients always see a clean end of
  stream, never a hang or a broken chunked body.
  `stream=false` blocks and answers `{"tokens": [...]}` once.
  Failure-mode status codes: 429 + Retry-After when admission shed the
  request (queue full or predicted to blow its deadline), 503 +
  Retry-After while draining, 503 when the engine is stopped/dead,
  504 when a server-side deadline expired, 499 when the request was
  cancelled, 500 on an engine failure.
- **Client-disconnect detection** — a streaming client that goes away
  mid-generation gets its request CANCELLED: the slot and KV blocks
  return to the pool instead of decoding to max_tokens for nobody
  (`serving.client_disconnects` counts it).
- **GET /metrics** — Prometheus text: the whole monitor registry,
  which includes the engine's `serving.*` gauges/counters (queue
  depth/wait, KV-block utilization, preemptions, shed/cancelled/
  deadline_exceeded, TTFT/TPOT p50/p99) plus true log-bucketed
  HISTOGRAM series for ttft/tpot/queue_wait, with the legacy p50/p99
  gauges recomputed from them at scrape time and age-stamped
  (`serving.slo_gauge_age_s`) so a stalled engine cannot serve frozen
  percentiles.
- **GET /traces[?n=10]** — recent tail-request timelines from the
  request tracer's slowest-K exemplar ring (`telemetry.reqtrace`):
  full kind=reqtrace records, span by span, naming where each slow
  request's latency went.
- **GET /healthz** — READINESS: engine status + the serving.*
  snapshot; answers 503 with status "draining"/"dead" when the engine
  is draining or dead (take it out of the load balancer).
- **GET /livez** — LIVENESS: 200 while the process is up, even during
  a drain (don't kill a pod for finishing its work).

    engine = ServingEngine(model, max_slots=8).start()
    srv = ServingHTTPServer(engine, port=8000).start()
"""
import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .. import monitor
from ..telemetry.metrics_http import prometheus_text
from .resilience import (PRIORITIES, Deadlines, DeadlineExceededError,
                         EngineDeadError, EngineDrainingError,
                         EngineStoppedError, RequestCancelledError,
                         ShedError)
from .scheduler import SamplingParams

__all__ = ["ServingHTTPServer"]

_DISCONNECTS = (BrokenPipeError, ConnectionResetError,
                ConnectionAbortedError)


class _Handler(BaseHTTPRequestHandler):
    server_version = "paddle-tpu-torch-serving/1"
    protocol_version = "HTTP/1.1"

    def _send(self, code, body, ctype="application/json", headers=None):
        data = body.encode() if isinstance(body, str) else body
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        engine = self.server.engine
        path, _, query = self.path.partition("?")
        if path == "/metrics":
            # scrape-time refresh: the legacy p50/p99 gauges recompute
            # from the streaming histograms NOW (age-stamped), so a
            # stalled engine can't serve percentiles frozen at the
            # last finished request; the histogram series themselves
            # ride the same scrape for window-of-choice quantiles
            engine.refresh_latency_gauges()
            self._send(200, prometheus_text(),
                       ctype="text/plain; version=0.0.4; charset=utf-8")
        elif path == "/livez":
            # liveness stays green through a drain: the process is
            # healthy, it is just finishing its work
            self._send(200, json.dumps({"status": "alive"}))
        elif path in ("/", "/healthz"):
            engine.refresh_latency_gauges()
            status, code = "ok", 200
            if engine.dead:
                status, code = "dead", 503
            elif engine.draining:
                status, code = "draining", 503
            body = {"status": status,
                    "serving": engine.metrics_snapshot()}
            self._send(code, json.dumps(body, indent=2, default=repr))
        elif path == "/traces":
            # the slowest-K exemplar timelines (telemetry.reqtrace):
            # each entry is a full kind=reqtrace record — span-by-span
            # decomposition of where that request's latency went
            n = None
            for part in query.split("&"):
                if part.startswith("n="):
                    try:
                        n = int(part[2:])
                    except ValueError:
                        pass
            traces = [] if engine.tracer is None \
                else engine.tracer.timelines(n)
            self._send(200, json.dumps(
                {"tracing": engine.tracer is not None,
                 "traces": traces}, default=repr))
        else:
            self._send(404, json.dumps(
                {"error": f"unknown path {self.path!r}",
                 "endpoints": ["POST /generate", "/metrics", "/healthz",
                               "/livez", "/traces?n=10"]}))

    def _retry_after(self, seconds):
        return {"Retry-After": str(max(1, int(math.ceil(seconds))))}

    def do_POST(self):
        if self.path != "/generate":
            self._send(404, json.dumps({"error": "POST /generate only"}))
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
            prompt = req["prompt"]
            if not isinstance(prompt, list) or not prompt:
                raise ValueError("'prompt' must be a non-empty id list")
            params = SamplingParams(
                max_new_tokens=req.get("max_new_tokens", 32),
                decode_strategy=req.get("decode_strategy", "greedy"),
                top_k=req.get("top_k", 0),
                top_p=req.get("top_p", 1.0),
                temperature=req.get("temperature", 1.0),
                eos_token_id=req.get("eos_token_id"),
                seed=req.get("seed"))
            priority = req.get("priority", "normal")
            if priority not in PRIORITIES:       # client error: 400,
                raise ValueError(                # not a 429 load shed
                    f"unknown priority {priority!r} (expected one of "
                    f"{sorted(PRIORITIES)})")
            dl = {k: req.get(j) for k, j in
                  (("queue_wait_s", "queue_wait_deadline_s"),
                   ("ttft_s", "ttft_deadline_s"),
                   ("total_s", "deadline_s"))}
            deadlines = Deadlines(**dl) if any(
                v is not None for v in dl.values()) else None
            stream = bool(req.get("stream", False))
            request_id = req.get("request_id")
            replay_tokens = req.get("replay_tokens")
            if replay_tokens is not None and \
                    not isinstance(replay_tokens, list):
                raise ValueError("'replay_tokens' must be an id list")
        except (KeyError, ValueError, TypeError,
                json.JSONDecodeError) as e:
            self._send(400, json.dumps({"error": str(e)}))
            return
        try:
            handle = self.server.engine.submit(
                [int(t) for t in prompt], params, deadlines=deadlines,
                priority=priority, request_id=request_id,
                replay_tokens=replay_tokens)
        except ShedError as e:        # load shed: come back later
            self._send(429, json.dumps(
                {"error": str(e), "status": "shed",
                 "reason": type(e).reason, "queue_depth": e.queue_depth,
                 "predicted_wait_ms": e.predicted_wait_ms}),
                headers=self._retry_after(e.retry_after_s))
            return
        except EngineDrainingError as e:
            self._send(503, json.dumps(
                {"error": str(e), "status": "draining"}),
                headers=self._retry_after(e.retry_after_s))
            return
        except (EngineStoppedError, EngineDeadError) as e:
            self._send(503, json.dumps(
                {"error": str(e), "status": "unavailable"}))
            return
        except ValueError as e:       # over-length request etc.
            self._send(429, json.dumps({"error": str(e)}))
            return
        if not stream:
            try:
                toks = handle.result(timeout=self.server.request_timeout)
            except DeadlineExceededError as e:
                self._send(504, json.dumps(
                    {"error": str(e), "status": "deadline_exceeded"}))
                return
            except RequestCancelledError as e:
                self._send(499, json.dumps(
                    {"error": str(e), "status": "cancelled"}))
                return
            except (EngineStoppedError, EngineDeadError) as e:
                # retryable elsewhere, same as the streaming path
                self._send(503, json.dumps(
                    {"error": str(e), "status": "unavailable"}))
                return
            except Exception as e:
                # e.g. request_timeout expired: the server is done with
                # this request, so the engine must be too — without the
                # cancel it would keep decoding to max_tokens with its
                # KV blocks pinned (no-op when already terminal)
                handle.cancel()
                self._send(500, json.dumps({"error": str(e)}))
                return
            self._send(200, json.dumps(
                {"tokens": toks, "stats": handle.stats,
                 "request_id": handle.request_id}))
            return
        # chunked token stream: one JSON line per token as it lands
        self.send_response(200)
        self.send_header("Content-Type", "application/jsonl")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def chunk(obj):
            data = (json.dumps(obj) + "\n").encode()
            self.wfile.write(f"{len(data):x}\r\n".encode() + data
                             + b"\r\n")
            self.wfile.flush()

        def abandoned():
            # the client went away mid-stream: without this, the
            # request decodes to max_tokens pinning its KV blocks for
            # nobody — cancel releases the slot + blocks immediately
            handle.cancel()
            monitor.incr("serving.client_disconnects")
            self.close_connection = True

        toks = []
        rid = handle.request_id    # echoed on EVERY stream event so a
        try:                       # router can join spliced halves
            for tok in handle.tokens(timeout=self.server.request_timeout):
                toks.append(tok)
                chunk({"token": tok, "request_id": rid})
            final = {"done": True, "tokens": toks, "stats": handle.stats,
                     "request_id": rid}
        except _DISCONNECTS:
            abandoned()
            return
        except DeadlineExceededError as e:
            final = {"error": str(e), "status": "deadline_exceeded",
                     "request_id": rid}
        except RequestCancelledError as e:
            final = {"error": str(e), "status": "cancelled",
                     "request_id": rid}
        except (EngineStoppedError, EngineDeadError) as e:
            final = {"error": str(e), "status": "unavailable",
                     "request_id": rid}
        except Exception as e:        # engine failure / server timeout
            # if the request is still live (request_timeout is the
            # usual case), release its slot + KV blocks now — the
            # server has stopped consuming this stream for good
            handle.cancel()
            final = {"error": str(e), "status": "failed",
                     "request_id": rid}
        # terminate the JSONL stream with the final event + the chunked
        # epilogue even on failure — a truncated chunked body looks like
        # an infrastructure fault to the client instead of a clean error
        try:
            chunk(final)
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except _DISCONNECTS + (OSError,):
            abandoned()

    def log_message(self, fmt, *args):
        pass


class ServingHTTPServer:
    """Threaded HTTP endpoint over a running ServingEngine. start() is
    non-blocking; the engine's own loop thread does the work."""

    def __init__(self, engine, host="127.0.0.1", port=0,
                 request_timeout=300.0):
        self.engine = engine
        self.host = host
        self.port = int(port)
        self.request_timeout = float(request_timeout)
        self._httpd = None
        self._thread = None

    def start(self):
        if self._httpd is not None:
            return self
        httpd = ThreadingHTTPServer((self.host, self.port), _Handler)
        httpd.daemon_threads = True
        httpd.engine = self.engine
        httpd.request_timeout = self.request_timeout
        self._httpd = httpd
        self.port = httpd.server_address[1]
        self._thread = threading.Thread(
            target=httpd.serve_forever, name="paddle-tpu-torch-serving-http",
            daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._httpd = None
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)

    @property
    def url(self):
        return f"http://{self.host}:{self.port}"

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
