"""The one backend interface the fleet router speaks.

The port of paddle_tpu/fleet/replica.py, unchanged in behaviour: an
`InProcessReplica` reads the port engine's `dead`, `draining`,
`sched.waiting`, `sched.num_running()` and `pool.num_free`; an
`HTTPReplica` consumes the port's `ServingHTTPServer` JSONL stream,
whose done event carries the engine's `stats` (with `n_tokens`).

A `Replica` is one serving engine the router can probe, stream
through, and drain — whether it lives in this process
(`InProcessReplica`, wrapping a `ServingEngine` directly) or behind a
`serving/http.py` front in another process or on another host
(`HTTPReplica`, stdlib `http.client` over the chunked-JSONL stream).
The router never sees the difference: both raise the same typed errors
(`serving.resilience.*` in process, `resilience.retry.HTTPStatusError`
carrying the status + Retry-After over the wire — and
`classify_failure` maps both onto the same transient/permanent/infra
taxonomy), and both echo the stable `request_id` the router joins
failover halves on.

Health has TWO questions, matching the serving front's /livez-vs-
/healthz split: `probe()` answers both — is the process alive
(unreachable => the probe RAISES, which is what the router counts as a
miss), and is it ready for new work (draining/dead => alive but not
routable). Queue depth and KV headroom ride along so least-loaded
routing is free.
"""
import json
import time

from ..resilience.retry import HTTPStatusError

__all__ = ["Replica", "InProcessReplica", "HTTPReplica",
           "ReplicaStream"]


class ReplicaStream:
    """One in-flight generation on one replica: iterate for the tokens
    (ints, as the engine emits them), then read `.stats` — populated at
    clean completion — for the engine-side accounting. `stats` includes
    `n_tokens`, the engine's count of ALL generated tokens INCLUDING
    any replayed ones, which is how the router PROVES a spliced stream
    balances (streamed_before + streamed_after must equal it)."""

    def __init__(self, request_id, it):
        self.request_id = request_id
        self._it = it
        self.stats = None    # set by the producer at clean completion

    def __iter__(self):
        return self._it


class Replica:
    """Interface contract (duck-typed; both implementations below).

    name          stable registry key ('r0', 'host:port', ...)
    engine_id     the backing engine's telemetry id, or None when
                  unknown (joins fleet quiesce accounting to the
                  per-engine serving quiesce records)
    probe()       -> health dict {alive, ready, draining, dead,
                  queue_depth, running, kv_blocks_free}; RAISES
                  (ConnectionError/OSError) when the replica is
                  unreachable — an exception IS the miss signal
    start_stream(prompt, params, request_id, replay_tokens, priority,
                  deadlines, timeout) -> ReplicaStream; raises the
                  typed admission errors (shed/draining/stopped/dead)
                  at submit time, stream errors during iteration
    drain(timeout) / resume_admission() / restart(timeout)
                  the rolling-restart hooks
    """

    name = "?"
    engine_id = None

    def probe(self):
        raise NotImplementedError

    def start_stream(self, prompt, params=None, request_id=None,
                     replay_tokens=None, priority="normal",
                     deadlines=None, timeout=None):
        raise NotImplementedError

    def drain(self, timeout=None):
        raise NotImplementedError

    def resume_admission(self):
        raise NotImplementedError

    def restart(self, timeout=None):
        """Drain-to-quiesce then reopen admission — the in-place
        'restart' a rolling restart performs on a healthy engine."""
        self.drain(timeout=timeout)
        self.resume_admission()


def _normalize_params(params):
    """Accept a SamplingParams, a dict of its knobs, or None; return
    the plain-dict wire form (what HTTP ships and SamplingParams eats)."""
    if params is None:
        return {}
    if isinstance(params, dict):
        return dict(params)
    return {"max_new_tokens": params.max_new_tokens,
            "decode_strategy": params.decode_strategy,
            "top_k": params.top_k, "top_p": params.top_p,
            "temperature": params.temperature,
            "eos_token_id": params.eos_token_id, "seed": params.seed}


class InProcessReplica(Replica):
    """A `ServingEngine` in this process. Health is read straight off
    the engine's internals (racy scrape by design, matching the
    engine's own lock-free gauge style) — NOT off the monitor registry,
    which is process-global and would alias every in-process replica
    onto the same serving.* gauges."""

    def __init__(self, name, engine):
        self.name = str(name)
        self.engine = engine

    @property
    def engine_id(self):
        return self.engine.engine_id

    def probe(self):
        e = self.engine
        dead = bool(e.dead)
        draining = bool(e.draining)
        return {
            "alive": True,
            "ready": not (dead or draining),
            "draining": draining,
            "dead": dead,
            "queue_depth": len(e.sched.waiting),
            "running": e.sched.num_running(),
            "kv_blocks_free": e.pool.num_free,
        }

    def start_stream(self, prompt, params=None, request_id=None,
                     replay_tokens=None, priority="normal",
                     deadlines=None, timeout=None):
        from ..serving.scheduler import SamplingParams
        kw = _normalize_params(params)
        handle = self.engine.submit(
            [int(t) for t in prompt], SamplingParams(**kw),
            deadlines=deadlines, priority=priority,
            request_id=request_id, replay_tokens=replay_tokens)
        stream = ReplicaStream(handle.request_id, None)

        def gen():
            for tok in handle.tokens(timeout=timeout):
                yield int(tok)
            stream.stats = dict(handle.stats)
        stream._it = gen()
        return stream

    def drain(self, timeout=None):
        self.engine.drain(timeout=timeout)

    def resume_admission(self):
        self.engine.resume_admission()


class HTTPReplica(Replica):
    """A remote `serving/http.py` front. Every non-2xx reply becomes an
    `HTTPStatusError` carrying the status and any Retry-After header —
    which is exactly what `resilience.retry.classify_failure` learned
    to read: 429/503/504 transient (route elsewhere, honor the hint),
    other 4xx permanent (the request itself is wrong), 5xx infra.
    A connection that dies raises ConnectionError/OSError, the signal
    the router's failure detector counts as a miss."""

    def __init__(self, name, url, engine_id=None, connect_timeout=5.0,
                 read_timeout=300.0):
        self.name = str(name)
        self.url = str(url).rstrip("/")
        self.engine_id = engine_id
        self.connect_timeout = float(connect_timeout)
        self.read_timeout = float(read_timeout)

    def _conn(self, timeout):
        import http.client
        from urllib.parse import urlparse
        u = urlparse(self.url)
        return http.client.HTTPConnection(
            u.hostname, u.port or 80, timeout=timeout)

    @staticmethod
    def _retry_after(resp):
        ra = resp.getheader("Retry-After")
        if ra is None:
            return None
        try:
            return float(ra)
        except ValueError:
            return None

    def probe(self):
        conn = self._conn(self.connect_timeout)
        try:
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            body = json.loads(resp.read() or b"{}")
        finally:
            conn.close()
        status = str(body.get("status", "ok"))
        snap = body.get("serving") or {}
        return {
            "alive": True,          # it answered — /livez semantics
            "ready": resp.status == 200,
            "draining": status == "draining",
            "dead": status == "dead",
            "queue_depth": int(snap.get("serving.queue_depth", 0) or 0),
            "running": int(snap.get("serving.running", 0) or 0),
            "kv_blocks_free": None,
        }

    def start_stream(self, prompt, params=None, request_id=None,
                     replay_tokens=None, priority="normal",
                     deadlines=None, timeout=None):
        body = dict(_normalize_params(params))
        body["prompt"] = [int(t) for t in prompt]
        body["stream"] = True
        body["priority"] = priority
        if request_id is not None:
            body["request_id"] = str(request_id)
        if replay_tokens:
            body["replay_tokens"] = [int(t) for t in replay_tokens]
        if deadlines is not None:
            for key, attr in (("queue_wait_deadline_s", "queue_wait_s"),
                              ("ttft_deadline_s", "ttft_s"),
                              ("deadline_s", "total_s")):
                v = getattr(deadlines, attr, None)
                if v is not None:
                    body[key] = v
        body = {k: v for k, v in body.items() if v is not None}
        conn = self._conn(timeout if timeout is not None
                          else self.read_timeout)
        try:
            conn.request("POST", "/generate", json.dumps(body),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
        except Exception:
            conn.close()
            raise
        if resp.status != 200:
            try:
                payload = json.loads(resp.read() or b"{}")
            except ValueError:
                payload = {}
            finally:
                conn.close()
            raise HTTPStatusError(
                payload.get("error",
                            f"replica {self.name}: HTTP {resp.status}"),
                resp.status, retry_after_s=self._retry_after(resp))
        stream = ReplicaStream(request_id, None)

        def gen():
            # http.client undoes the chunked framing; each read line is
            # one JSONL stream event
            try:
                while True:
                    line = resp.readline()
                    if not line:
                        raise ConnectionError(
                            f"replica {self.name}: stream ended without "
                            "a terminal event")
                    line = line.strip()
                    if not line:
                        continue
                    ev = json.loads(line)
                    if "token" in ev:
                        if ev.get("request_id") is not None:
                            stream.request_id = ev["request_id"]
                        yield int(ev["token"])
                        continue
                    if ev.get("done"):
                        stream.stats = ev.get("stats")
                        if ev.get("request_id") is not None:
                            stream.request_id = ev["request_id"]
                        return
                    # terminal error event: surface as the status the
                    # blocking path would have answered
                    status_code = {"deadline_exceeded": 504,
                                   "cancelled": 499,
                                   "unavailable": 503,
                                   "shed": 429}.get(
                                       ev.get("status"), 500)
                    raise HTTPStatusError(
                        ev.get("error", f"replica {self.name}: stream "
                               f"failed ({ev.get('status')})"),
                        status_code)
            finally:
                conn.close()
        stream._it = gen()
        return stream

    # -- rolling-restart hooks ---------------------------------------------
    # the stdlib serving front exposes no remote drain/restart control
    # (deliberately: an unauthenticated drain endpoint is a footgun).
    # A process supervisor owns these; the drill wires them via
    # FleetRouter.rolling_restart(restart_fn=...).
    def drain(self, timeout=None):
        raise NotImplementedError(
            f"replica {self.name}: HTTP replicas are drained by their "
            "supervisor (pass restart_fn to rolling_restart)")

    def resume_admission(self):
        raise NotImplementedError(
            f"replica {self.name}: HTTP replicas are resumed by their "
            "supervisor (pass restart_fn to rolling_restart)")

    def wait_ready(self, timeout_s=30.0, interval_s=0.05):
        """Poll /healthz until the replica answers ready (post-restart
        re-admission). Returns True when ready, False on timeout."""
        deadline = time.monotonic() + float(timeout_s)
        while time.monotonic() < deadline:
            try:
                if self.probe().get("ready"):
                    return True
            except Exception:
                pass
            time.sleep(interval_s)
        return False
