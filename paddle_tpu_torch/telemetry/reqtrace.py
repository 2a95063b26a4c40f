"""Per-request tracer for the serving engine: span timelines (the
Dapper move applied to continuous batching).

The port's copy of `RequestTrace` and `RequestTracer` from
paddle_tpu/telemetry/reqtrace.py, with their logic unchanged and a plain
`threading` lock, and its latency attribution (`CAUSES`,
`PATHOLOGICAL_CAUSES`, `decompose`, `dominant_cause`), which the health
detector's `tail_latency` rule (telemetry/health.py) judges traces by.
The JAX module's Chrome export of request lanes has no user in the port
and is not copied.

- **RequestTrace** — one request's ordered span list. Spans TILE the
  request's [submit, finish] wall-clock interval: every span begins
  where the previous one ended, so the durations sum to the end-to-end
  latency BY CONSTRUCTION (a dropped event, an out-of-order append or a
  clock mix-up breaks the sum). Decode steps COALESCE into one span per
  consecutive stretch at engine-step boundaries — O(1) bookkeeping per
  request per step, never per-token span appends; nothing touches the
  device.
- **RequestTracer** — the engine-side collector: every completed trace
  lands as a `kind=reqtrace` record (telemetry.sink) through the
  engine's sink, and a bounded slowest-K exemplar heap keeps full
  timelines of the tail requests (`GET /traces` on the HTTP front).
"""
import heapq
import itertools
import threading

from .. import monitor
from .sink import REQTRACE_SPAN_KINDS, make_reqtrace_record

__all__ = ["RequestTrace", "RequestTracer", "CAUSES", "PATHOLOGICAL_CAUSES",
           "decompose", "dominant_cause"]

# the attribution vocabulary: every span kind maps onto exactly one of
# these buckets (decompose below); "other" absorbs the zero-duration
# markers (admit/finalize) and anything a newer producer adds
CAUSES = ("queue_wait", "preemption", "restart", "prefill", "cow_fork",
          "decode", "collective", "transfer", "other")
# causes that are a PROBLEM when they dominate a request's latency —
# decode and prefill are the work the user asked for; these are the
# serving stack's own mechanisms getting in the way
PATHOLOGICAL_CAUSES = ("queue_wait", "preemption", "restart", "cow_fork")


class RequestTrace:
    """One request's span timeline. The engine (and scheduler) call the
    note_* hooks at event boundaries; `_cursor` tracks the end of the
    last span so every append tiles the wall clock. All times are
    process-monotonic seconds (the clock `Request.submit_time` uses)."""

    __slots__ = ("rid", "t0", "spans", "outcome", "e2e_ms", "_cursor",
                 "_dec_end", "_dec_tokens", "_in_queue",
                 "_requeue_reason", "_replay_cause", "_max_prefilled")

    def __init__(self, rid, t0):
        self.rid = rid
        self.t0 = float(t0)
        self.spans = []
        self.outcome = None
        self.e2e_ms = None
        self._cursor = self.t0
        self._dec_end = None         # open decode segment end, or None
        self._dec_tokens = 0
        self._in_queue = True        # waiting (initially, and on requeue)
        self._requeue_reason = None  # why the NEXT queued span exists
        self._replay_cause = None    # attribution for replayed chunks
        self._max_prefilled = 0      # high-water mark of written positions

    # -- span plumbing ------------------------------------------------------
    def _push(self, kind, t1, **attrs):
        t0 = self._cursor
        if t1 < t0:                  # defensive: clocks are monotonic,
            t1 = t0                  # but never emit a negative span
        span = {"kind": kind,
                "t0_ms": round((t0 - self.t0) * 1000.0, 4),
                "dur_ms": round((t1 - t0) * 1000.0, 4)}
        for k, v in attrs.items():
            if v is not None:
                span[k] = v
        self.spans.append(span)
        self._cursor = t1

    def _flush_decode(self):
        """Close the open coalesced-decode segment, if any."""
        if self._dec_end is None:
            return
        end, n = self._dec_end, self._dec_tokens
        self._dec_end = None
        self._dec_tokens = 0
        self._push("decode", end, n_tokens=n)

    # -- engine hooks -------------------------------------------------------
    def note_admit(self, t, queue_depth=None, prefix_cached_tokens=None,
                   predicted_wait_ms=None):
        """Admission out of the waiting queue: closes the queued span
        (reason = submit, or why the request was requeued) and stamps
        the decision — including the prefix-cache hit — as a
        zero-duration `admit` span."""
        reason = self._requeue_reason or "submit"
        self._requeue_reason = None
        self._in_queue = False
        self._push("queued", t, reason=reason)
        self._push("admit", t, queue_depth=queue_depth,
                   prefix_cached_tokens=prefix_cached_tokens or None,
                   predicted_wait_ms=predicted_wait_ms)

    def note_requeue(self, t, reason, n_prefilled=None):
        """Preemption or warm-restart requeue: the marker span, then
        back to the queue. `reason` in ('preempt', 'restart')."""
        self._flush_decode()
        kind = "preempt" if reason == "preempt" else "restart_replay"
        self._push(kind, t, lost_positions=n_prefilled)
        self._requeue_reason = reason
        self._replay_cause = "preemption" if reason == "preempt" \
            else "restart"
        self._in_queue = True

    def note_prefill_chunk(self, t, p0, n_tokens):
        """One chunked-prefill dispatch covering positions
        [p0, p0 + n_tokens). Chunks re-covering positions the request
        had already written before a requeue are REPLAY — their cost is
        the preemption's/restart's, not the prompt's."""
        self._flush_decode()
        attrs = {"p0": int(p0), "n_tokens": int(n_tokens)}
        if p0 < self._max_prefilled and self._replay_cause is not None:
            attrs["replay"] = True
            attrs["replay_cause"] = self._replay_cause
        self._max_prefilled = max(self._max_prefilled, int(p0) + int(n_tokens))
        self._push("prefill_chunk", t, **attrs)

    def note_cow_fork(self, t):
        """Copy-on-write fork of a shared block before a write."""
        self._flush_decode()
        self._push("cow_fork", t)

    def note_decode(self, t):
        """One decode-step token for this request: O(1) — extends the
        open coalesced segment instead of appending a span per token."""
        self._dec_end = t
        self._dec_tokens += 1

    def note_shed(self, t, queue_depth=None, reason=None):
        """Admission rejected the request up front: the whole life was
        queue time, stamped with the shed verdict."""
        self._push("queued", t, reason="submit")
        self._push("shed", t, queue_depth=queue_depth, reason=reason)
        self.outcome = "shed"
        self.e2e_ms = round((t - self.t0) * 1000.0, 4)

    def finish(self, t, outcome):
        """Terminal transition: close any open decode segment, account
        time still spent waiting (a request cancelled/expired in the
        queue never saw an admit), and stamp the finalize span."""
        self._flush_decode()
        if self._in_queue and t > self._cursor:
            self._push("queued", t,
                       reason=self._requeue_reason or "submit")
        self._push("finalize", t, outcome=outcome)
        self.outcome = outcome
        self.e2e_ms = round((t - self.t0) * 1000.0, 4)


class RequestTracer:
    """The engine-side trace collector: hands out RequestTrace objects,
    emits completed traces as `kind=reqtrace` records through the sink,
    and keeps the slowest-K full timelines in a bounded exemplar heap
    for `/traces` and the Chrome export. Thread-safe (the engine lock
    serializes the note_* hooks; finish/timelines may race a scrape)."""

    def __init__(self, engine_id=0, rank=0, sink=None, exemplar_k=32):
        self.engine_id = int(engine_id)
        self.rank = int(rank)
        self.exemplar_k = int(exemplar_k)
        self._sink = sink
        self._mu = threading.Lock()
        self._heap = []     # guarded by: _mu — (e2e_ms, seq, record) min-heap
        self._seq = itertools.count()   # guarded by: _mu
        self.n_traces = 0            # guarded by: _mu

    def start(self, rid, t0):
        return RequestTrace(rid, t0)

    def _note(self, rec):
        with self._mu:
            self.n_traces += 1
            item = (rec.get("e2e_ms", 0.0), next(self._seq), rec)
            if len(self._heap) < self.exemplar_k:
                heapq.heappush(self._heap, item)
            elif item[0] > self._heap[0][0]:
                heapq.heapreplace(self._heap, item)
        monitor.incr("serving.traces")
        if self._sink is not None:
            self._sink.write(rec)
        return rec

    def finish(self, req, t):
        """Finalize `req`'s trace at time `t` (its terminal state is
        already set) and emit the record. Idempotent — a second
        finalize attempt on the same trace is a no-op."""
        tr = getattr(req, "trace", None)
        if tr is None or tr.outcome is not None:
            return None
        tr.finish(t, req.state)
        return self._note(make_reqtrace_record(
            rid=req.rid, outcome=tr.outcome, spans=tr.spans,
            e2e_ms=tr.e2e_ms, rank=self.rank, engine=self.engine_id,
            t0_s=tr.t0, ttft_ms=req.ttft_ms(), tpot_ms=req.tpot_ms(),
            queue_wait_ms=req.queue_wait_ms(),
            n_tokens=len(req.out_tokens), prompt_len=len(req.prompt),
            preemptions=req.preemptions,
            request_id=getattr(req, "request_id", None)))

    def record_shed(self, req, t, queue_depth=None, reason=None):
        """A request admission rejected up front: its trace is the
        verdict (queued + shed spans), outcome 'shed'."""
        tr = getattr(req, "trace", None) or RequestTrace(
            req.rid, req.submit_time)
        tr.note_shed(t, queue_depth=queue_depth, reason=reason)
        return self._note(make_reqtrace_record(
            rid=req.rid, outcome="shed", spans=tr.spans,
            e2e_ms=tr.e2e_ms, rank=self.rank, engine=self.engine_id,
            t0_s=tr.t0, prompt_len=len(req.prompt),
            request_id=getattr(req, "request_id", None)))

    # -- consumers ----------------------------------------------------------
    def timelines(self, n=None):
        """The exemplar ring's records, slowest first (what `/traces`
        serves)."""
        with self._mu:
            items = sorted(self._heap, key=lambda it: it[0], reverse=True)
        recs = [rec for _, _, rec in items]
        return recs if n is None else recs[:max(0, int(n))]


def decompose(rec):
    """Latency decomposition of one reqtrace record: {cause: ms} over
    the CAUSES vocabulary. Replayed prefill chunks are charged to the
    preemption/restart that forced them."""
    causes = dict.fromkeys(CAUSES, 0.0)
    for sp in rec.get("spans", ()):
        kind = sp.get("kind")
        if kind not in REQTRACE_SPAN_KINDS:
            continue
        dur = sp.get("dur_ms")
        if not isinstance(dur, (int, float)) or dur != dur or dur < 0:
            continue
        if kind == "queued":
            reason = sp.get("reason", "submit")
            key = {"submit": "queue_wait", "preempt": "preemption",
                   "restart": "restart"}.get(reason, "queue_wait")
        elif kind == "prefill_chunk":
            key = sp["replay_cause"] \
                if sp.get("replay") and sp.get("replay_cause") in CAUSES \
                else "prefill"
        elif kind == "decode":
            key = "decode"
        elif kind == "cow_fork":
            key = "cow_fork"
        elif kind == "preempt":
            key = "preemption"
        elif kind == "restart_replay":
            key = "restart"
        elif kind == "shed":
            key = "queue_wait"
        elif kind == "collective":
            key = "collective"
        elif kind == "transfer":
            key = "transfer"
        else:                        # admit / finalize markers
            key = "other"
        causes[key] += float(dur)
    return causes


def dominant_cause(rec):
    """(cause, ms, fraction-of-e2e) for the largest contributor. The
    fraction denominator is the recorded e2e_ms when present (so a
    doctored non-summing trace cannot inflate its own fractions), else
    the span total."""
    causes = decompose(rec)
    total = rec.get("e2e_ms")
    if not isinstance(total, (int, float)) or total <= 0:
        total = sum(causes.values())
    cause = max(causes, key=lambda k: causes[k])
    ms = causes[cause]
    return cause, ms, (ms / total if total else 0.0)
