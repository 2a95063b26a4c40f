"""The fleet's own HTTP front: one door, N engines behind it.

The port of paddle_tpu/fleet/http.py, its protocol unchanged.

Same stdlib-threaded shape as `serving/http.py`, but every request goes
through the `FleetRouter` — so a POST /generate here gets prefix-
affinity placement, cross-replica shedding, and mid-stream failover
replay WITHOUT the client knowing the fleet exists. A replica dying
mid-response shows up to the client as nothing at all: the router
splices the replay stream and the chunked JSONL just keeps coming.

- **POST /generate** — same body schema as the single-engine front
  (prompt/sampling knobs/stream/priority/deadlines/request_id), plus
  optional `"session"` for sticky multi-turn routing. Failure codes
  match the single-engine contract: 429 + Retry-After when the FLEET
  sheds (every healthy replica saturated, or none healthy), 400 on a
  malformed request, 500 when the failover budget is exhausted.
- **GET /metrics** — Prometheus text of the monitor registry, which
  now includes the `fleet.*` counters/gauges (routes, failovers,
  splices, deaths, healthy-replica count) next to the `serving.*`
  family.
- **GET /healthz** — fleet readiness: 200 while ANY replica is
  routable, 503 when none is; body carries the per-replica registry
  view (breaker state, misses, queue depth).
- **GET /livez** — the router process itself is up.
- **GET /replicas** — the registry view alone, for dashboards and the
  drill.
"""
import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..telemetry.metrics_http import prometheus_text
from ..serving.resilience import PRIORITIES, Deadlines
from .router import FleetShedError

__all__ = ["FleetHTTPServer"]

_DISCONNECTS = (BrokenPipeError, ConnectionResetError,
                ConnectionAbortedError)


class _Handler(BaseHTTPRequestHandler):
    server_version = "paddle-tpu-torch-fleet/1"
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
        router = self.server.router
        path = self.path.partition("?")[0]
        if path == "/metrics":
            self._send(200, prometheus_text(),
                       ctype="text/plain; version=0.0.4; charset=utf-8")
        elif path == "/livez":
            self._send(200, json.dumps({"status": "alive"}))
        elif path in ("/", "/healthz"):
            states = router.replica_states()
            routable = [n for n, s in states.items()
                        if not (s["dead"] or s["draining"]
                                or s["breaker"] == "open")]
            code = 200 if routable else 503
            self._send(code, json.dumps(
                {"status": "ok" if routable else "no_healthy_replica",
                 "routable": routable, "replicas": states,
                 "counts": dict(router.counts)}, indent=2))
        elif path == "/replicas":
            self._send(200, json.dumps(router.replica_states(), indent=2))
        else:
            self._send(404, json.dumps(
                {"error": f"unknown path {self.path!r}",
                 "endpoints": ["POST /generate", "/metrics", "/healthz",
                               "/livez", "/replicas"]}))

    def _retry_after(self, seconds):
        return {"Retry-After": str(max(1, int(math.ceil(seconds))))}

    def do_POST(self):
        router = self.server.router
        if self.path != "/generate":
            self._send(404, json.dumps({"error": "POST /generate only"}))
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
            prompt = req["prompt"]
            if not isinstance(prompt, list) or not prompt:
                raise ValueError("'prompt' must be a non-empty id list")
            params = {k: req[k] for k in
                      ("max_new_tokens", "decode_strategy", "top_k",
                       "top_p", "temperature", "eos_token_id", "seed")
                      if k in req}
            priority = req.get("priority", "normal")
            if priority not in PRIORITIES:
                raise ValueError(
                    f"unknown priority {priority!r} (expected one of "
                    f"{sorted(PRIORITIES)})")
            dl = {k: req.get(j) for k, j in
                  (("queue_wait_s", "queue_wait_deadline_s"),
                   ("ttft_s", "ttft_deadline_s"),
                   ("total_s", "deadline_s"))}
            deadlines = Deadlines(**dl) if any(
                v is not None for v in dl.values()) else None
            stream = bool(req.get("stream", False))
            session = req.get("session")
            request_id = req.get("request_id")
        except (KeyError, ValueError, TypeError,
                json.JSONDecodeError) as e:
            self._send(400, json.dumps({"error": str(e)}))
            return
        gen = router.stream([int(t) for t in prompt], params,
                            session=session, request_id=request_id,
                            priority=priority, deadlines=deadlines,
                            timeout=self.server.request_timeout)
        if not stream:
            try:
                toks = list(gen)
            except FleetShedError as e:
                self._send(429, json.dumps(
                    {"error": str(e), "status": "shed",
                     "reason": type(e).reason}),
                    headers=self._retry_after(e.retry_after_s))
                return
            except Exception as e:
                self._send(500, json.dumps({"error": str(e)}))
                return
            self._send(200, json.dumps({"tokens": toks}))
            return
        toks = []
        # pull the FIRST token before committing to a 200: sheds and
        # routing failures surface here, while they can still be an
        # honest status code instead of a mid-stream error event
        try:
            it = iter(gen)
            first = next(it, None)
        except FleetShedError as e:
            self._send(429, json.dumps(
                {"error": str(e), "status": "shed",
                 "reason": type(e).reason}),
                headers=self._retry_after(e.retry_after_s))
            return
        except Exception as e:
            self._send(500, json.dumps({"error": str(e)}))
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/jsonl")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def chunk(obj):
            data = (json.dumps(obj) + "\n").encode()
            self.wfile.write(f"{len(data):x}\r\n".encode() + data
                             + b"\r\n")
            self.wfile.flush()

        try:
            if first is not None:
                toks.append(first)
                chunk({"token": first})
                for tok in it:
                    toks.append(tok)
                    chunk({"token": tok})
            final = {"done": True, "tokens": toks}
        except _DISCONNECTS:
            gen.close()       # stop pulling; the replica-side cancel
            self.close_connection = True    # rides the engine's own
            return                          # disconnect handling
        except Exception as e:
            final = {"error": str(e), "status": "failed"}
        try:
            chunk(final)
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except _DISCONNECTS + (OSError,):
            self.close_connection = True

    def log_message(self, fmt, *args):
        pass


class FleetHTTPServer:
    """Threaded HTTP front over a FleetRouter. start() is non-blocking.

        router = FleetRouter([...])
        front = FleetHTTPServer(router, port=9000).start()
    """

    def __init__(self, router, host="127.0.0.1", port=0,
                 request_timeout=300.0):
        self.router = router
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
        httpd.router = self.router
        httpd.request_timeout = self.request_timeout
        self._httpd = httpd
        self.port = httpd.server_address[1]
        self._thread = threading.Thread(
            target=httpd.serve_forever, name="paddle-tpu-torch-fleet-http",
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
