"""Structured records of the serving engine, and the JSONL sink.

The port's copy of the serving subset of paddle_tpu/telemetry/sink.py,
unchanged: the kind=serving lifecycle record (`make_serving_record`,
`SERVING_EVENTS`), the kind=reqtrace request timeline
(`make_reqtrace_record`, `REQTRACE_SPAN_KINDS`), the memory
observatory's kind=memsnap ledger record (`make_memsnap_record`,
`MEMSNAP_BUCKETS`, `MEMSNAP_EVENTS`), the fleet router's kind=fleet
record (`make_fleet_record`, `FLEET_EVENTS`), the kind=compile record
(`make_compile_record`: here one capture of a step as a CUDA graph,
telemetry/compile_obs.py), and `JsonlSink`, the
append-only file they are written to. Same schema version and keys, so
the JAX package's offline tools read a ledger of either engine; the
port's own copy of the cross-record rules is telemetry/ledger_check.py.
"""
import atexit
import json
import os
import threading
import weakref

__all__ = ["SCHEMA_VERSION", "SERVING_EVENTS", "REQTRACE_SPAN_KINDS",
           "REQTRACE_OUTCOMES", "FLEET_RECORD_KEYS", "FLEET_EVENTS",
           "MEMSNAP_RECORD_KEYS", "MEMSNAP_BUCKETS", "MEMSNAP_EVENTS",
           "make_serving_record", "make_reqtrace_record",
           "make_fleet_record", "make_memsnap_record",
           "make_compile_record", "JsonlSink"]

# one process-wide atexit hook over weak refs: sinks stay collectable
# (a per-instance atexit.register would pin every sink + its fd for the
# process lifetime) while anything still alive at exit gets flushed
_LIVE_SINKS = weakref.WeakSet()
_ATEXIT_INSTALLED = False


def _close_live_sinks():
    for sink in list(_LIVE_SINKS):
        sink.close()


SCHEMA_VERSION = 1

# a serving-lifecycle record (serving.engine.ServingEngine) always
# carries schema, kind, rank, event; optional: rid, engine, queue_depth,
# queue_wait_ms, queue_deadline_ms, predicted_wait_ms, retry_after_s,
# n_tokens, priority, reason, error, attempt, requeued, running,
# completed, drained_ms, kv_blocks_used, counts
# the request-lifecycle vocabulary: admitted (passed admission control
# into the bounded queue), one of four TERMINAL outcomes (finished /
# failed / cancelled / expired), shed (rejected up front: queue full or
# predicted to blow its deadline — MUST carry queue_depth, the
# pressure that justified the rejection), restart (transient step
# fault -> arenas rebuilt, in-flight requeued for recompute-replay),
# drain_begin/drain_end (graceful drain protocol), quiesce (engine
# idle: counts must balance — admitted == finished+failed+cancelled+
# expired — and kv_blocks_used must be 0; tools/trace_check.py
# enforces both).
SERVING_EVENTS = ("admitted", "finished", "failed", "cancelled",
                  "expired", "shed", "restart", "drain_begin",
                  "drain_end", "quiesce")

# a per-request trace record (telemetry.reqtrace.RequestTracer)
# always carries schema, kind, rank, rid, outcome, e2e_ms, spans;
# optional: engine, t0_s, ttft_ms, tpot_ms, queue_wait_ms, n_tokens,
# prompt_len, preemptions
# the span vocabulary: queued (waiting; `reason` says why — submit /
# preempt / restart), admit (the admission decision with its prefix-hit
# info), shed (rejected up front), prefill_chunk (one chunked-prefill
# dispatch; `replay`+`replay_cause` mark chunks recomputing positions a
# preemption or warm restart threw away), decode (CONSECUTIVE decode
# steps coalesced into one segment at engine-step boundaries — one span
# per decode stretch, never one per token), preempt / restart_replay
# (the requeue markers), cow_fork (copy-on-write block fork), finalize
# (terminal transition + stream close). Spans TILE the request's
# [submit, finish] wall-clock interval — each begins where the previous
# ended — which is what makes the decomposition invariant (durations
# sum to e2e_ms) checkable by tools/trace_check.py.
# `collective` / `transfer` are the multi-chip vocabulary (ROADMAP
# multi-chip serving item): time inside a cross-chip collective or a
# host<->device / chip<->chip transfer. They tile like every other
# kind, so the decomposition invariant is unchanged — a trace carrying
# them still sums to e2e_ms.
REQTRACE_SPAN_KINDS = ("queued", "admit", "shed", "prefill_chunk",
                       "decode", "preempt", "cow_fork", "restart_replay",
                       "finalize", "collective", "transfer")
# trace outcomes: the four terminal request states plus `shed` (the
# request never entered the engine; its trace is the admission verdict)
REQTRACE_OUTCOMES = ("finished", "failed", "cancelled", "expired",
                     "shed")

# required keys of a fleet-tier record (fleet.FleetRouter —
# the router/front tier over N engine replicas); optional: replica,
# to_replica, request_id, policy, healthy, miss_count, detect_s,
# breaker, streamed_before, streamed_after, n_tokens, queue_depth,
# retry_after_s, reason, error, counts
FLEET_RECORD_KEYS = ("schema", "kind", "rank", "event")
# the fleet lifecycle vocabulary: route (a routing decision — which
# replica and WHY: prefix_affinity / session / least_loaded), probe
# (one health-probe verdict; an unhealthy probe carries miss_count, the
# ElasticCoordinator consecutive-miss pattern one tier up),
# declared_dead (miss_count consecutive failed probes — must be
# preceded by at least one failed probe for the same replica, the
# elastic declared-dead rule), failover (a request resubmitted after
# replica death or a mid-stream error: must reference a preceding death
# OR carry the error that justified it), replay_spliced (the spliced
# stream's accounting: n_tokens MUST equal streamed_before +
# streamed_after — the recompute-replay invariant made auditable),
# restart (one rolling-restart step: drain -> quiesce -> restart ->
# re-admit for one replica), shed (cross-replica admission rejected the
# request at the fleet door: every replica full/unhealthy), quiesce
# (the fleet ledger snapshot: requests == admitted + shed, and the sum
# of per-replica serving admissions must equal fleet admitted +
# failover re-admissions; tools/trace_check.py enforces all of it).
FLEET_EVENTS = ("route", "probe", "declared_dead", "failover",
                "replay_spliced", "restart", "shed", "quiesce")

# required keys of a memory-observatory ledger record
# (telemetry/mem_obs); optional: the attribution
# buckets, budget/headroom/projection anchors, KV-pool accounting, and
# the postmortem payload (top_arrays, compile_families)
MEMSNAP_RECORD_KEYS = ("schema", "kind", "rank", "event", "step",
                       "total_bytes")

# attribution buckets — every live byte lands in exactly ONE, so
# tools/trace_check.py can recompute total_bytes from the record's own
# fields (the reqtrace decomposition stance, applied to HBM)
MEMSNAP_BUCKETS = ("params_bytes", "opt_state_bytes", "kv_bytes",
                   "workspace_bytes", "other_bytes")

# what one memsnap record may claim to be: a step-cadence ledger
# snapshot, or the capture-on-failure POSTMORTEM written when an
# allocation failed (torch.OutOfMemoryError) — a postmortem must carry
# an error note and the top-K array listing (telemetry/ledger_check
# validates both), so an OOM
# is diagnosable offline from the ledger alone
MEMSNAP_EVENTS = ("snapshot", "postmortem")


def make_serving_record(event, rank=0, rid=None, engine=None,
                        queue_depth=None, queue_wait_ms=None,
                        queue_deadline_ms=None, predicted_wait_ms=None,
                        retry_after_s=None, n_tokens=None, priority=None,
                        reason=None, error=None, kv_blocks_used=None,
                        counts=None, **extra):
    """One serving-lifecycle event as a first-class record
    (kind="serving", serving.engine.ServingEngine). `event` is one
    of SERVING_EVENTS; `engine` is the emitting engine instance id (so
    one ledger can carry several sequential engines and the quiesce
    accounting stays per-engine); `counts` is the quiesce snapshot of
    the engine's request accounting."""
    if event not in SERVING_EVENTS:
        raise ValueError(f"serving event must be one of {SERVING_EVENTS}, "
                         f"got {event!r}")
    rec = {
        "schema": SCHEMA_VERSION,
        "kind": "serving",
        "rank": int(rank),
        "event": str(event),
    }
    if rid is not None:
        rec["rid"] = int(rid)
    if engine is not None:
        rec["engine"] = int(engine)
    if queue_depth is not None:
        rec["queue_depth"] = int(queue_depth)
    if queue_wait_ms is not None:
        rec["queue_wait_ms"] = round(float(queue_wait_ms), 4)
    if queue_deadline_ms is not None:
        rec["queue_deadline_ms"] = round(float(queue_deadline_ms), 4)
    if predicted_wait_ms is not None:
        rec["predicted_wait_ms"] = round(float(predicted_wait_ms), 4)
    if retry_after_s is not None:
        rec["retry_after_s"] = round(float(retry_after_s), 4)
    if n_tokens is not None:
        rec["n_tokens"] = int(n_tokens)
    if priority is not None:
        rec["priority"] = str(priority)
    if reason is not None:
        rec["reason"] = str(reason)
    if error is not None:
        rec["error"] = str(error)
    if kv_blocks_used is not None:
        rec["kv_blocks_used"] = int(kv_blocks_used)
    if counts is not None:
        rec["counts"] = {str(k): int(v) for k, v in counts.items()}
    for k, v in extra.items():
        if v is not None:
            rec[k] = v
    return rec


def make_reqtrace_record(rid, outcome, spans, e2e_ms, rank=0, engine=None,
                         t0_s=None, ttft_ms=None, tpot_ms=None,
                         queue_wait_ms=None, n_tokens=None,
                         prompt_len=None, preemptions=None, **extra):
    """One request's complete span timeline as a first-class record
    (kind='reqtrace', telemetry.reqtrace.RequestTracer). `spans` is the
    ordered tiling of the request's wall-clock life — each span a dict
    {kind, t0_ms, dur_ms, ...attrs} with t0_ms relative to submit time —
    and `e2e_ms` the end-to-end latency the span durations must sum to
    (tools/trace_check.py enforces the decomposition within 1%).
    `t0_s` is the submit instant on the process monotonic clock, which
    is what lets offline tools order requests and the Chrome export
    place per-request lanes next to engine-step spans."""
    if outcome not in REQTRACE_OUTCOMES:
        raise ValueError(f"reqtrace outcome must be one of "
                         f"{REQTRACE_OUTCOMES}, got {outcome!r}")
    norm = []
    for sp in spans:
        s = {"kind": str(sp["kind"]),
             "t0_ms": round(float(sp["t0_ms"]), 4),
             "dur_ms": round(float(sp["dur_ms"]), 4)}
        for k, v in sp.items():
            if k not in ("kind", "t0_ms", "dur_ms") and v is not None:
                s[k] = v
        norm.append(s)
    rec = {
        "schema": SCHEMA_VERSION,
        "kind": "reqtrace",
        "rank": int(rank),
        "rid": int(rid),
        "outcome": str(outcome),
        "e2e_ms": round(float(e2e_ms), 4),
        "spans": norm,
    }
    if engine is not None:
        rec["engine"] = int(engine)
    if t0_s is not None:
        rec["t0_s"] = round(float(t0_s), 6)
    if ttft_ms is not None:
        rec["ttft_ms"] = round(float(ttft_ms), 4)
    if tpot_ms is not None:
        rec["tpot_ms"] = round(float(tpot_ms), 4)
    if queue_wait_ms is not None:
        rec["queue_wait_ms"] = round(float(queue_wait_ms), 4)
    if n_tokens is not None:
        rec["n_tokens"] = int(n_tokens)
    if prompt_len is not None:
        rec["prompt_len"] = int(prompt_len)
    if preemptions is not None:
        rec["preemptions"] = int(preemptions)
    for k, v in extra.items():
        if v is not None:
            rec[k] = v
    return rec



def make_fleet_record(event, rank=0, replica=None, to_replica=None,
                      request_id=None, policy=None, healthy=None,
                      miss_count=None, detect_s=None, breaker=None,
                      streamed_before=None, streamed_after=None,
                      n_tokens=None, queue_depth=None, retry_after_s=None,
                      reason=None, error=None, counts=None, **extra):
    """One fleet-tier event as a first-class record (kind='fleet',
    fleet.FleetRouter). `event` is one of FLEET_EVENTS;
    `replica` names the replica the event is ABOUT (for a failover,
    the one that failed — `to_replica` is where the request went);
    `request_id` is the stable client-visible id that joins fleet
    records to the per-replica kind=serving / kind=reqtrace records;
    `counts` is the quiesce snapshot of the router's accounting."""
    if event not in FLEET_EVENTS:
        raise ValueError(f"fleet event must be one of {FLEET_EVENTS}, "
                         f"got {event!r}")
    rec = {
        "schema": SCHEMA_VERSION,
        "kind": "fleet",
        "rank": int(rank),
        "event": str(event),
    }
    if replica is not None:
        rec["replica"] = str(replica)
    if to_replica is not None:
        rec["to_replica"] = str(to_replica)
    if request_id is not None:
        rec["request_id"] = str(request_id)
    if policy is not None:
        rec["policy"] = str(policy)
    if healthy is not None:
        rec["healthy"] = bool(healthy)
    if miss_count is not None:
        rec["miss_count"] = int(miss_count)
    if detect_s is not None:
        rec["detect_s"] = round(float(detect_s), 4)
    if breaker is not None:
        rec["breaker"] = str(breaker)
    if streamed_before is not None:
        rec["streamed_before"] = int(streamed_before)
    if streamed_after is not None:
        rec["streamed_after"] = int(streamed_after)
    if n_tokens is not None:
        rec["n_tokens"] = int(n_tokens)
    if queue_depth is not None:
        rec["queue_depth"] = int(queue_depth)
    if retry_after_s is not None:
        rec["retry_after_s"] = round(float(retry_after_s), 4)
    if reason is not None:
        rec["reason"] = str(reason)
    if error is not None:
        rec["error"] = str(error)
    if counts is not None:
        rec["counts"] = {str(k): int(v) for k, v in counts.items()}
    for k, v in extra.items():
        if v is not None:
            rec[k] = v
    return rec


def make_compile_record(fn, step, compile_ms, rank=0, n_compiles=1,
                        backend=None, cause=None, signature=None, **extra):
    """One capture of a step as a CUDA graph, as a kind='compile' record.

    `cause` is the recapture diff (list of human-readable strings) —
    None/absent on the FIRST capture of a family, required on every
    later one (tools/trace_check.py enforces this). The port's fields
    (the graph pool's bytes, the capture key) ride under `extra`."""
    rec = {
        "schema": SCHEMA_VERSION,
        "kind": "compile",
        "rank": int(rank),
        "fn": str(fn),
        "step": int(step),
        "compile_ms": round(float(compile_ms), 4),
        "n_compiles": int(n_compiles),
    }
    if backend is not None:
        rec["backend"] = str(backend)
    if cause:
        rec["cause"] = [str(c) for c in cause]
    if signature is not None:
        rec["signature"] = signature
    if extra:
        rec["extra"] = extra
    return rec


def make_memsnap_record(event, step, total_bytes, rank=0,
                        params_bytes=None, opt_state_bytes=None,
                        kv_bytes=None, workspace_bytes=None,
                        other_bytes=None, hbm_budget_bytes=None,
                        headroom_bytes=None, projected_bytes=None,
                        projection_family=None, n_arrays=None,
                        kv_blocks_total=None, kv_blocks_held=None,
                        kv_blocks_free=None, kv_blocks_cached=None,
                        kv_occupancy=None, kv_cache_share=None,
                        kv_evictions=None, kv_admissions=None,
                        kv_eviction_rate=None, kv_admission_rate=None,
                        evictions_by_class=None, admissions_by_class=None,
                        engine=None, error=None, top_arrays=None,
                        compile_families=None, **extra):
    """One live-HBM ledger snapshot as a first-class typed record
    (kind='memsnap') — the memory sibling of kind='commbench': the mesh
    observatory measures what the mesh moves, the memory observatory
    measures what the chip HOLDS. The bucket fields (MEMSNAP_BUCKETS)
    partition total_bytes — tools/trace_check.py recomputes the sum;
    `headroom_bytes` is max(0, hbm_budget_bytes - total_bytes), the
    admission signal the serving engine gauges; `projected_bytes` is
    a static projection the reconcile-drift rule latches against (the
    port's capture records project nothing, so it stays None); the
    kv_* fields snapshot the
    BlockPool/PrefixIndex accounting (held+free+cached must tile
    kv_blocks_total) plus the eviction/admission rates the kv_thrash
    rule judges — all riding ON the record, so an offline replay and
    an in-flight detector see identical numbers. A postmortem event
    additionally carries `error`, the top-K `top_arrays` by bytes, and
    the active `compile_families`. Non-finite measurements become None
    + an error note — a NaN never rides the ledger silently."""
    def _clean(v):
        if v is None:
            return None, False
        bad = isinstance(v, float) and (v != v or v in (float("inf"),
                                                        float("-inf")))
        return (None if bad else float(v)), bad

    total_bytes, bad = _clean(total_bytes)
    rec = {
        "schema": SCHEMA_VERSION,
        "kind": "memsnap",
        "rank": int(rank),
        "event": str(event),
        "step": int(step),
        "total_bytes": None if total_bytes is None else int(total_bytes),
    }
    if bad:
        rec["error"] = "non-finite total_bytes"
    for key, v in (("params_bytes", params_bytes),
                   ("opt_state_bytes", opt_state_bytes),
                   ("kv_bytes", kv_bytes),
                   ("workspace_bytes", workspace_bytes),
                   ("other_bytes", other_bytes),
                   ("hbm_budget_bytes", hbm_budget_bytes),
                   ("headroom_bytes", headroom_bytes),
                   ("projected_bytes", projected_bytes)):
        v, bad = _clean(v)
        if v is not None:
            rec[key] = int(v)
        elif bad:
            rec["error"] = f"non-finite {key}"
    for key, v in (("kv_occupancy", kv_occupancy),
                   ("kv_cache_share", kv_cache_share),
                   ("kv_eviction_rate", kv_eviction_rate),
                   ("kv_admission_rate", kv_admission_rate)):
        v, bad = _clean(v)
        if v is not None:
            rec[key] = round(v, 6)
        elif bad:
            rec["error"] = f"non-finite {key}"
    for key, v in (("n_arrays", n_arrays),
                   ("kv_blocks_total", kv_blocks_total),
                   ("kv_blocks_held", kv_blocks_held),
                   ("kv_blocks_free", kv_blocks_free),
                   ("kv_blocks_cached", kv_blocks_cached),
                   ("kv_evictions", kv_evictions),
                   ("kv_admissions", kv_admissions),
                   ("engine", engine)):
        if v is not None:
            rec[key] = int(v)
    if projection_family is not None:
        rec["projection_family"] = str(projection_family)
    if evictions_by_class is not None:
        rec["evictions_by_class"] = {str(k): int(v) for k, v
                                     in evictions_by_class.items()}
    if admissions_by_class is not None:
        rec["admissions_by_class"] = {str(k): int(v) for k, v
                                      in admissions_by_class.items()}
    if error is not None:
        rec["error"] = str(error)
    if top_arrays is not None:
        rec["top_arrays"] = list(top_arrays)
    if compile_families is not None:
        rec["compile_families"] = list(compile_families)
    for k, v in extra.items():
        if v is not None:
            rec[k] = v
    return rec

class JsonlSink:
    """Append-only JSONL metrics file, one record per line. Thread-safe.

    Crash durability: the file handle is held open and every record is
    flushed to the OS as it is written, and live sinks are closed by a
    process-wide `atexit` hook (weak refs — a sink is still collectable
    the moment its owner drops it) — records buffered at the moment of
    an exception (or a SystemExit tearing the interpreter down) are on
    disk, not lost in a dead buffer. A write after close() transparently
    reopens (append), so a closed sink still works."""

    def __init__(self, path):
        global _ATEXIT_INSTALLED
        self.path = os.fspath(path)
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        self._mu = threading.Lock()
        self._n = 0
        self._f = open(self.path, "a")
        if not _ATEXIT_INSTALLED:
            atexit.register(_close_live_sinks)
            _ATEXIT_INSTALLED = True
        _LIVE_SINKS.add(self)

    def write(self, record):
        line = json.dumps(record, sort_keys=True)
        with self._mu:
            if self._f is None or self._f.closed:
                self._f = open(self.path, "a")
            self._f.write(line + "\n")
            self._f.flush()
            self._n += 1
        return record

    def flush(self):
        with self._mu:
            if self._f is not None and not self._f.closed:
                self._f.flush()
                try:
                    os.fsync(self._f.fileno())
                except OSError:
                    pass

    def close(self):
        with self._mu:
            if self._f is not None and not self._f.closed:
                self._f.flush()
                self._f.close()

    def __len__(self):
        return self._n
