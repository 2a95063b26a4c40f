"""Prometheus text exposition of the port's monitor registry.

The port's copy of `prometheus_text` from
paddle_tpu/telemetry/metrics_http.py, unchanged: every counter as a
monotonic `counter`, every gauge as a `gauge`, every histogram as a true
`histogram` series (cumulative `le` buckets + _sum + _count), under the
same `paddle_tpu_` prefix and sanitized names, so one scrape
configuration reads the JAX engine and the port's. The serving HTTP
front (serving/http.py) serves it on GET /metrics.

`MetricsServer` is the training process's scrape endpoint (the JAX
module's, unchanged): a threaded stdlib HTTP server over the monitor
registry, an optional `TelemetryRecorder` and an optional
`HealthMonitor`, serving

- `/healthz` (and `/`): the JSON status — "ok", "anomalous" once the
  health detector has fired, "stalled" (HTTP 503) while the hang
  watchdog's armed window is past its deadline — with the counters a
  probe reads (steps, anomalies, watchdog fires, captures, serving);
- `/metrics`: `prometheus_text`, plus the last step record's numbers as
  `last_step_*` gauges;
- `/steps?n=50`: the last n step records (the health ring, else the
  recorder's records).
"""
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from .. import monitor

__all__ = ["prometheus_text", "MetricsServer"]

_PREFIX = "paddle_tpu_"


def _prom_name(name):
    out = []
    for ch in str(name):
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    sanitized = "".join(out)
    if sanitized and sanitized[0].isdigit():
        sanitized = "_" + sanitized
    return _PREFIX + sanitized


def _prom_value(v):
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f) if not float(f).is_integer() else str(int(f))


def _prom_le(bound):
    """le-label formatting: integral bounds print bare, others compact."""
    f = float(bound)
    return str(int(f)) if f.is_integer() else f"{f:g}"


def prometheus_text(last_record=None):
    """Render monitor.snapshot_typed() (+ optionally the last step
    record) as Prometheus exposition text. Counters keep their
    monotonic `# TYPE` so rate() works on the scrape; histograms
    (monitor.observe_hist, e.g. the serving latency distributions)
    render as true `histogram` series — cumulative `le` buckets + _sum
    + _count — so quantiles are computable AT SCRAPE TIME over any
    window, instead of trusting a producer-side percentile gauge that
    freezes whenever the producer stalls."""
    typed = monitor.snapshot_typed()
    lines = []
    for kind in ("counter", "gauge"):
        for name in sorted(typed[kind]):
            val = _prom_value(typed[kind][name])
            if val is None:
                continue
            pname = _prom_name(name)
            lines.append(f"# TYPE {pname} {kind}")
            lines.append(f"{pname} {val}")
    hists = monitor.snapshot_hists()
    for name in sorted(hists):
        h = hists[name]
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} histogram")
        cum = 0
        for bound, count in zip(h["bounds"], h["counts"]):
            cum += count
            lines.append(
                f'{pname}_bucket{{le="{_prom_le(bound)}"}} {cum}')
        lines.append(f'{pname}_bucket{{le="+Inf"}} {h["count"]}')
        lines.append(f"{pname}_sum {_prom_value(h['sum'])}")
        lines.append(f"{pname}_count {h['count']}")
    if last_record:
        for key in sorted(last_record):
            v = last_record[key]
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                continue
            val = _prom_value(v)
            if val is None:
                continue
            pname = _prom_name(f"last_step_{key}")
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {val}")
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    server_version = "paddle-tpu-torch-health/1"

    # the ThreadingHTTPServer instance carries .metrics (MetricsServer)
    def _send(self, code, body, ctype="application/json"):
        data = body.encode() if isinstance(body, str) else body
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        ms = self.server.metrics
        url = urlparse(self.path)
        if url.path in ("/", "/healthz"):
            status, body = ms.healthz()
            self._send(503 if body["status"] == "stalled" else 200,
                       json.dumps(body, indent=2, default=repr))
        elif url.path == "/metrics":
            self._send(200, prometheus_text(ms.last_record()),
                       ctype="text/plain; version=0.0.4; charset=utf-8")
        elif url.path == "/steps":
            q = parse_qs(url.query)
            try:
                n = int(q.get("n", ["50"])[0])
            except ValueError:
                n = 50
            self._send(200, json.dumps(ms.steps_tail(n), default=repr))
        else:
            self._send(404, json.dumps(
                {"error": f"unknown path {url.path!r}",
                 "endpoints": ["/healthz", "/metrics", "/steps?n=50"]}))

    def log_message(self, fmt, *args):   # silence per-request stderr spam
        pass


class MetricsServer:
    """Threaded HTTP scrape endpoint over the process's monitor
    registry, an optional TelemetryRecorder, and an optional
    HealthMonitor. start() is non-blocking (daemon serve thread)."""

    def __init__(self, recorder=None, health=None, host="127.0.0.1",
                 port=0):
        self.recorder = recorder
        self.health = health
        self.host = host
        self.port = int(port)
        self._httpd = None
        self._thread = None

    # -- data plumbing ------------------------------------------------------
    def steps_tail(self, n=50):
        n = max(1, min(int(n), 10000))
        if self.health is not None and len(self.health.ring):
            return list(self.health.ring)[-n:]
        if self.recorder is not None:
            return list(self.recorder.records[-n:])
        return []

    def last_record(self):
        tail = self.steps_tail(1)
        return tail[-1] if tail else None

    def healthz(self):
        snap = monitor.snapshot()
        body = {
            "status": "ok",
            "uptime_s": snap.get("process.uptime_s"),
            "rank": snap.get("process.rank"),
            "steps": snap.get("telemetry.steps", 0),
            "train_steps": snap.get("jit.train_steps", 0),
            "anomalies": snap.get("health.anomalies", 0),
            "nan_steps": snap.get("health.nan_steps", 0),
            "watchdog_fires": snap.get("health.watchdog_fires", 0),
            # compile observatory (telemetry.compile_obs): a probe can
            # spot a retrace storm without parsing the JSONL
            "compiles": snap.get("compile.count", 0),
            "recompiles": snap.get("compile.recompiles", 0),
            "compile_storms": snap.get("compile.storms", 0),
            # resilience runtime (paddle_tpu.resilience): is this job
            # actually checkpointing, and has it had to retry/fall back
            "checkpoint": {
                "saves": snap.get("ckpt.saves", 0),
                "commits": snap.get("ckpt.commits", 0),
                "restores": snap.get("ckpt.restores", 0),
                "fallbacks": snap.get("ckpt.fallbacks", 0),
                "failures": snap.get("ckpt.failures", 0),
                "retries": snap.get("ckpt.retries", 0),
                "preemptions": snap.get("ckpt.preemptions", 0),
                "last_step": snap.get("ckpt.last_step"),
                "last_save_ms": snap.get("ckpt.save_ms"),
            },
            # serving resilience (paddle_tpu.serving): is the engine
            # shedding/expiring/cancelling under load, is it draining,
            # and has it had to warm-restart after step faults
            "serving": {
                "queue_depth": snap.get("serving.queue_depth"),
                "running": snap.get("serving.running"),
                "admitted": snap.get("serving.admitted", 0),
                "shed": snap.get("serving.shed", 0),
                "cancelled": snap.get("serving.cancelled", 0),
                "deadline_exceeded": snap.get(
                    "serving.deadline_exceeded", 0),
                "client_disconnects": snap.get(
                    "serving.client_disconnects", 0),
                "queue_wait_ms_p99": snap.get(
                    "serving.queue_wait_ms_p99"),
                "engine_errors": snap.get("serving.engine_errors", 0),
                "restarts": snap.get("serving.restarts", 0),
                "draining": snap.get("serving.draining", 0),
                "engine_dead": snap.get("serving.engine_dead", 0),
            },
            # elastic mesh resilience (distributed.elastic +
            # resilience.reshard): has the failure detector fired, and
            # did any resume cross a layout change
            "elastic": {
                "alive_hosts": snap.get("elastic.alive_hosts"),
                "heartbeat_misses": snap.get(
                    "elastic.heartbeat_miss", 0),
                "declared_dead": snap.get("elastic.declared_dead", 0),
                "replans": snap.get("elastic.replan", 0),
                "relaunches": snap.get("elastic.relaunch", 0),
                "reshard_restores": snap.get(
                    "elastic.reshard_restores", 0),
                "collective_timeouts": snap.get(
                    "elastic.collective_timeouts", 0),
            },
        }
        h = self.health
        if h is not None:
            body["anomaly_kinds"] = h.detector.kinds()
            wd = h.watchdog
            if wd is not None:
                overdue = wd.overdue_s()
                body["watchdog"] = {
                    "armed": wd.armed,
                    "deadline_s": wd.deadline_s,
                    "overdue_s": round(max(0.0, overdue), 3),
                    "dumps": list(wd.dumps),
                }
                if overdue > 0:
                    body["status"] = "stalled"
            if body["status"] == "ok" and h.anomalies:
                body["status"] = "anomalous"
        last = self.last_record()
        if last:
            body["last_step"] = last
        return 200, body

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        if self._httpd is not None:
            return self
        httpd = ThreadingHTTPServer((self.host, self.port), _Handler)
        httpd.daemon_threads = True
        httpd.metrics = self
        self._httpd = httpd
        self.port = httpd.server_address[1]
        self._thread = threading.Thread(
            target=httpd.serve_forever, name="paddle-tpu-torch-metrics-http",
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
