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
append-only file they are written to. Also the training and bench
kinds: the kind=step record of a training step (`make_step_record`:
`STEP_RECORD_KEYS`, the health taps' `HEALTH_KEYS`, the MoE routing
fields' `MOE_KEYS`; telemetry/recorder.py writes it), the kind=bench
result (`make_bench_record`, the serving family's names and gate
directions in `SERVING_BENCH_METRICS`), the kind=phase metric dict
(`make_phase_record`), the kernel observatory's kind=kernelbench
measurement (`make_kernelbench_record`), the checkpoint lifecycle's
kind=ckpt record (`make_ckpt_record`, `CKPT_EVENTS`) and the
kind=elastic record a cross-layout restore writes
(`make_elastic_record`, `ELASTIC_EVENTS`) with `emit_record`, their
sink fallback chain, `read_jsonl`, and the Chrome
trace export of host spans (`spans_to_trace_events`,
`export_chrome_tracing`). Same schema version and keys, so
the JAX package's offline tools read a ledger of either engine; the
port's own copy of the per-record and cross-record rules is
telemetry/ledger_check.py.
"""
import atexit
import json
import os
import threading
import weakref

__all__ = ["SCHEMA_VERSION", "STEP_RECORD_KEYS", "STEP_OPTIONAL_KEYS",
           "INPUT_KEYS", "HEALTH_KEYS", "MOE_KEYS", "COMM_KEYS",
           "BENCH_RECORD_KEYS", "SERVING_BENCH_METRICS",
           "KERNELBENCH_RECORD_KEYS", "KERNELBENCH_EVENTS",
           "make_step_record", "make_bench_record", "make_phase_record",
           "make_kernelbench_record", "read_jsonl",
           "spans_to_trace_events", "export_chrome_tracing",
           "SERVING_EVENTS", "REQTRACE_SPAN_KINDS",
           "REQTRACE_OUTCOMES", "FLEET_RECORD_KEYS", "FLEET_EVENTS",
           "MEMSNAP_RECORD_KEYS", "MEMSNAP_BUCKETS", "MEMSNAP_EVENTS",
           "make_serving_record", "make_reqtrace_record",
           "make_fleet_record", "make_memsnap_record",
           "make_compile_record", "JsonlSink", "CKPT_RECORD_KEYS",
           "CKPT_EVENTS", "ELASTIC_RECORD_KEYS", "ELASTIC_EVENTS",
           "make_ckpt_record", "make_elastic_record", "emit_record"]

# one process-wide atexit hook over weak refs: sinks stay collectable
# (a per-instance atexit.register would pin every sink + its fd for the
# process lifetime) while anything still alive at exit gets flushed
_LIVE_SINKS = weakref.WeakSet()
_ATEXIT_INSTALLED = False


def _close_live_sinks():
    for sink in list(_LIVE_SINKS):
        sink.close()


SCHEMA_VERSION = 1

# required keys of a per-step record (validated by tools/trace_check.py)
STEP_RECORD_KEYS = ("schema", "kind", "rank", "step", "step_ms",
                    "compile_ms", "execute_ms")
# optional, present when the recorder has the inputs to compute them
STEP_OPTIONAL_KEYS = ("loss", "tokens_per_sec", "mfu", "mem_bytes",
                      "cache_hits", "cache_misses", "collectives",
                      "grad_norm", "update_ratio", "nan_count",
                      "inf_count", "input_wait_ms", "input_queue_depth",
                      "input_bound_frac", "moe_entropy",
                      "moe_dropped_frac", "moe_overflow", "moe_aux_loss",
                      "moe_num_experts", "comm_ms", "comm_frac", "extra")
# input-pipeline fields (io.prefetch loader health taps: how long the
# step blocked waiting for its batch, ready-queue depth at fetch, and
# the EMA input-bound fraction — host-bound vs chip-bound as a number)
INPUT_KEYS = ("input_wait_ms", "input_queue_depth", "input_bound_frac")
# health-tap fields (telemetry.health numerics taps; None until a fetch
# step lands them — they appear every k-th record when taps are on)
HEALTH_KEYS = ("grad_norm", "update_ratio", "nan_count", "inf_count")
# MoE routing-health fields (paddle_tpu.moe.stats; present on steps of
# models exposing collect_moe_stats): expert-load entropy (<= log E —
# cross-checked by tools/trace_check.py against moe_num_experts),
# dropped-token fraction in [0, 1], capacity-overflow ratio (>= 0,
# > 1 means some expert saw more assignments than capacity), and the
# load-balancing aux-loss value
MOE_KEYS = ("moe_entropy", "moe_dropped_frac", "moe_overflow",
            "moe_aux_loss", "moe_num_experts")
# communication-attribution fields (telemetry/comm_obs + recorder):
# wall-time collective.* span milliseconds summed over the step
# (trace-time spans tagged traced=true are excluded) and that sum as a
# fraction of step_ms in [0, 1] — compute-vs-communication step
# decomposition as a number; the per-op breakdown stays in
# 'collectives'
COMM_KEYS = ("comm_ms", "comm_frac")


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


# required keys of a checkpoint-event record (resilience.ckpt);
# optional: save_ms, bytes, op, error, problems, removed, signal
CKPT_RECORD_KEYS = ("schema", "kind", "rank", "step", "event")
# the event vocabulary the ledger checks accept
CKPT_EVENTS = ("save", "commit", "restore", "fallback", "failed", "gc",
               "preempt")

# required keys of an elastic record (resilience.reshard); optional:
# host, step, miss_count, detect_s, world_from, world_to, layout_from,
# layout_to
ELASTIC_RECORD_KEYS = ("schema", "kind", "rank", "event")
ELASTIC_EVENTS = ("heartbeat_miss", "declared_dead", "replan",
                  "reshard_restore", "relaunch")


def make_ckpt_record(event, step, rank=0, save_ms=None, bytes=None,  # noqa: A002
                     **extra):
    """One checkpoint-lifecycle event as a first-class record
    (kind='ckpt', resilience.ckpt). `event` is one of CKPT_EVENTS: save
    (async kickoff), commit (manifest + atomic rename landed), restore,
    fallback (a corrupt checkpoint was skipped), failed (retries
    exhausted), gc (retention sweep), preempt (graceful-shutdown
    checkpoint)."""
    if event not in CKPT_EVENTS:
        raise ValueError(f"ckpt event must be one of {CKPT_EVENTS}, "
                         f"got {event!r}")
    rec = {
        "schema": SCHEMA_VERSION,
        "kind": "ckpt",
        "rank": int(rank),
        "step": int(step),
        "event": str(event),
    }
    if save_ms is not None:
        rec["save_ms"] = round(float(save_ms), 4)
    if bytes is not None:
        rec["bytes"] = int(bytes)
    for k, v in extra.items():
        if v is not None:
            rec[k] = v
    return rec


def make_elastic_record(event, rank=0, host=None, step=None,
                        miss_count=None, detect_s=None, world_from=None,
                        world_to=None, layout_from=None, layout_to=None,
                        **extra):
    """One elastic lifecycle event as a first-class record
    (kind='elastic'). `event` is one of ELASTIC_EVENTS; `layout_from`/
    `layout_to` are axis dicts (resilience.reshard.normalize_layout
    canonical form)."""
    if event not in ELASTIC_EVENTS:
        raise ValueError(f"elastic event must be one of {ELASTIC_EVENTS}, "
                         f"got {event!r}")
    rec = {
        "schema": SCHEMA_VERSION,
        "kind": "elastic",
        "rank": int(rank),
        "event": str(event),
    }
    if host is not None:
        rec["host"] = str(host)
    if step is not None:
        rec["step"] = int(step)
    if miss_count is not None:
        rec["miss_count"] = int(miss_count)
    if detect_s is not None:
        rec["detect_s"] = float(detect_s)
    if world_from is not None:
        rec["world_from"] = int(world_from)
    if world_to is not None:
        rec["world_to"] = int(world_to)
    if layout_from is not None:
        rec["layout_from"] = dict(layout_from)
    if layout_to is not None:
        rec["layout_to"] = dict(layout_to)
    for k, v in extra.items():
        if v is not None:
            rec[k] = v
    return rec


def emit_record(rec, *sinks):
    """Write one record through the sink fallback chain: the first
    candidate that is not None wins (a sink object, anything with
    .write, or a path, opened append as a JsonlSink), else the
    context-active recorder's sink, else the record is returned
    unwritten."""
    out = None
    for s in sinks:
        if s is None:
            continue
        out = JsonlSink(s) if isinstance(s, str) else s
        break
    if out is None:
        from .recorder import current_recorder
        r = current_recorder()
        out = r.sink if r is not None else None
    if out is not None:
        out.write(rec)
    return rec


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

def make_step_record(step, step_ms, compile_ms, rank=0, loss=None,
                     tokens_per_sec=None, mfu=None, mem_bytes=None,
                     cache_hits=None, cache_misses=None, collectives=None,
                     grad_norm=None, update_ratio=None, nan_count=None,
                     inf_count=None, input_wait_ms=None,
                     input_queue_depth=None, input_bound_frac=None,
                     moe_entropy=None, moe_dropped_frac=None,
                     moe_overflow=None, moe_aux_loss=None,
                     moe_num_experts=None, comm_ms=None, comm_frac=None,
                     **extra):
    """Normalize one step's measurements into the schema dict."""
    rec = {
        "schema": SCHEMA_VERSION,
        "kind": "step",
        "rank": int(rank),
        "step": int(step),
        "step_ms": round(float(step_ms), 4),
        "compile_ms": round(float(compile_ms), 4),
        "execute_ms": round(max(0.0, float(step_ms) - float(compile_ms)), 4),
    }
    if loss is not None:
        rec["loss"] = float(loss)
    if tokens_per_sec is not None:
        rec["tokens_per_sec"] = round(float(tokens_per_sec), 2)
    if mfu is not None:
        rec["mfu"] = round(float(mfu), 6)
    if mem_bytes is not None:
        rec["mem_bytes"] = int(mem_bytes)
    if cache_hits is not None:
        rec["cache_hits"] = int(cache_hits)
    if cache_misses is not None:
        rec["cache_misses"] = int(cache_misses)
    # health taps: keep non-finite values AS IS (NaN round-trips through
    # json.loads) — a poisoned grad_norm is the signal, not noise; the
    # paired nan/inf counts make it machine-checkable regardless
    if grad_norm is not None:
        rec["grad_norm"] = float(grad_norm)
    if update_ratio is not None:
        rec["update_ratio"] = float(update_ratio)
    if nan_count is not None:
        rec["nan_count"] = int(nan_count)
    if inf_count is not None:
        rec["inf_count"] = int(inf_count)
    # input-pipeline taps (io.prefetch): numeric, wait/depth >= 0, the
    # bound fraction in [0, 1] — validated by tools/trace_check.py
    if input_wait_ms is not None:
        rec["input_wait_ms"] = round(float(input_wait_ms), 4)
    if input_queue_depth is not None:
        rec["input_queue_depth"] = int(input_queue_depth)
    if input_bound_frac is not None:
        rec["input_bound_frac"] = round(float(input_bound_frac), 4)
    # MoE routing-health taps (paddle_tpu.moe.stats): bounded fractions
    # + the expert count that anchors the entropy bound — validated
    # below and cross-checked by tools/trace_check.py
    if moe_entropy is not None:
        rec["moe_entropy"] = round(float(moe_entropy), 6)
    if moe_dropped_frac is not None:
        rec["moe_dropped_frac"] = round(float(moe_dropped_frac), 6)
    if moe_overflow is not None:
        rec["moe_overflow"] = round(float(moe_overflow), 6)
    if moe_aux_loss is not None:
        rec["moe_aux_loss"] = round(float(moe_aux_loss), 6)
    if moe_num_experts is not None:
        rec["moe_num_experts"] = int(moe_num_experts)
    # communication attribution (telemetry/comm_obs): wall-time
    # collective span sum + its fraction of the step — validated below
    # and bounded by tools/trace_check.py
    if comm_ms is not None:
        rec["comm_ms"] = round(float(comm_ms), 4)
    if comm_frac is not None:
        rec["comm_frac"] = round(float(comm_frac), 6)
    if collectives:
        rec["collectives"] = {
            str(k): {"ms": round(float(v[0]), 4), "calls": int(v[1])}
            if isinstance(v, (tuple, list)) else v
            for k, v in collectives.items()}
    if extra:
        rec["extra"] = extra
    return rec


BENCH_RECORD_KEYS = ("schema", "kind", "metric", "value")

# the SERVING bench-metric family (bench_serving.py over
# paddle_tpu/serving): one source of truth for metric names + gate
# directions so the bench emitter, the rolling baseline
# (tools/bench_baseline.json), and tools/trace_check.py's serving
# cross-rules cannot drift. Directions are the bench_gate vocabulary:
# 'higher' fails when the value drops, 'lower' when it rises (latency),
# 'info' is recorded but never gated.
SERVING_BENCH_METRICS = {
    "serving.single_stream_tokens_per_sec": "higher",
    "serving.throughput_tokens_per_sec": "higher",
    "serving.throughput_vs_single": "higher",
    "serving.ttft_p50_ms": "lower",
    "serving.ttft_p99_ms": "lower",
    "serving.tpot_p50_ms": "lower",
    "serving.tpot_p99_ms": "lower",
    "serving.requests": "info",
    "serving.preemptions": "info",
    "serving.kv_block_utilization_peak": "info",
    # the serving-resilience drill's rated-load leg (tools/
    # serving_drill.py --rated-only): throughput at rated load with SLO
    # deadlines armed, queue-wait p99 under admission control, and the
    # shed count — direction 'lower' over a 0.0 baseline means ANY shed
    # at rated load fails the gate (the SLO sweep must run shed-free)
    "serving.rated_throughput_tokens_per_sec": "higher",
    "serving.rated_queue_wait_ms_p99": "lower",
    "serving.rated_shed": "lower",
    # the prefix-sharing sweep (bench_serving.py shared-prefix phase):
    # N requests over K templates through a warm prefix-cache engine
    # vs a cold-cache control with identical token streams. hit_rate
    # and tokens_saved are deterministic for the seeded workload
    # (direction 'higher': a drop means the matcher stopped finding
    # prefixes it used to); tokens_offered is the denominator that
    # makes tokens_saved auditable (info); the TTFT rows quote the
    # WARM engine, and the speedup row is warm-vs-cold at p50 — the
    # whole point of the cache
    "serving.prefix_hit_rate": "higher",
    "serving.prefill_tokens_saved": "higher",
    "serving.prefill_tokens_offered": "info",
    "serving.prefix_ttft_p50_ms": "lower",
    "serving.prefix_ttft_p99_ms": "lower",
    "serving.prefix_ttft_speedup": "higher",
    "serving.prefix_tokens_recomputed_per_request": "lower",
    # the request tracer's cost (bench_serving.py trace_overhead_phase):
    # rated-level throughput with tracing on vs off as a fraction lost,
    # direction 'lower' so bench_gate holds the tracer to its <=2%
    # budget once a device round seeds the row — a tracer that starts
    # doing per-token host work fails the gate like any regression
    "serving.trace_overhead_frac": "lower",
    # the fleet-tier rated leg (bench_serving.py --fleet N): aggregate
    # rated throughput over N replicas, and scaling efficiency —
    # aggregate / (N x the single-replica rated figure measured in the
    # same run). Direction 'higher' on both: a router whose efficiency
    # decays is paying routing/affinity overhead the ROADMAP's
    # ~linear-scaling target does not allow. replicas is the
    # denominator that makes the efficiency row auditable (info).
    "fleet.rated_throughput_tokens_per_sec": "higher",
    "fleet.scaling_efficiency": "higher",
    "fleet.replicas": "info",
}

# required keys of a kernel-observatory measurement record
# (telemetry/kernel_obs); optional: dtype,
# fallback_ms, speedup, compile_ms, flops, bytes_accessed, flops_frac,
# bw_frac, predicted_ms, bound, config, db_key, n_samples, warmup,
# event, seed
KERNELBENCH_RECORD_KEYS = ("schema", "kind", "rank", "kernel", "sig",
                           "backend", "kernel_ms")

# what one kernelbench record may claim to be (cross-checked by
# tools/trace_check.py: a db_update must reference a measured row)
KERNELBENCH_EVENTS = ("measure", "tune", "db_update")


def make_kernelbench_record(kernel, sig, backend, kernel_ms, rank=0,
                            dtype=None, fallback_ms=None, speedup=None,
                            compile_ms=None, flops=None,
                            bytes_accessed=None, flops_frac=None,
                            bw_frac=None, predicted_ms=None, bound=None,
                            config=None, db_key=None, n_samples=None,
                            warmup=None, event=None, seed=None, **extra):
    """One measured kernel data point as a first-class typed record
    (kind='kernelbench') — the dynamic sibling of kind='kernel_lint':
    the Kernel Doctor records what a kernel IS, the observatory records
    how fast it RAN. `sig` + `dtype` + `backend` reproduce the DB key
    (telemetry/kernel_obs.db_key); `kernel_ms` is the compile-excluded
    execute median (compile_ms rides separately, the PR-4 split);
    roofline fractions are achieved/peak in [0, 1]; `predicted_ms` is
    the roofline floor the kernel_time_drift rule judges against.
    Non-finite timings become None + an error note, like
    make_bench_record — the validators fail them loudly rather than
    letting a NaN ride the ledger."""
    def _clean(v):
        if v is None:
            return None, False
        bad = isinstance(v, float) and (v != v or v in (float("inf"),
                                                        float("-inf")))
        return (None if bad else float(v)), bad

    kernel_ms, bad = _clean(kernel_ms)
    rec = {
        "schema": SCHEMA_VERSION,
        "kind": "kernelbench",
        "rank": int(rank),
        "kernel": str(kernel),
        "sig": str(sig),
        "backend": str(backend),
        "kernel_ms": kernel_ms,
    }
    if bad:
        rec["error"] = "non-finite kernel_ms"
    if dtype is not None:
        rec["dtype"] = str(dtype)
    for key, v in (("fallback_ms", fallback_ms), ("speedup", speedup),
                   ("compile_ms", compile_ms),
                   ("flops_frac", flops_frac), ("bw_frac", bw_frac),
                   ("predicted_ms", predicted_ms)):
        v, bad = _clean(v)
        if v is not None:
            rec[key] = v
        elif bad:
            rec["error"] = f"non-finite {key}"
    if flops is not None:
        rec["flops"] = int(flops)
    if bytes_accessed is not None:
        rec["bytes_accessed"] = int(bytes_accessed)
    if bound is not None:
        rec["bound"] = str(bound)
    if config is not None:
        rec["config"] = dict(config)
    if db_key is not None:
        rec["db_key"] = str(db_key)
    if n_samples is not None:
        rec["n_samples"] = int(n_samples)
    if warmup is not None:
        rec["warmup"] = int(warmup)
    if event is not None:
        rec["event"] = str(event)
    if seed is not None:
        rec["seed"] = int(seed)
    for k, v in extra.items():
        if v is not None:
            rec[k] = v
    return rec


def make_bench_record(metric, value, unit=None, rank=0, device=None,
                      bench_round=None, baseline=None, **extra):
    """One benchmark RESULT as a first-class typed record (kind='bench')
    — the perf-regression gate's unit of account (tools/bench_gate.py).
    Distinct from kind='phase' (a phase's raw metric dict): a bench
    record is one tracked scalar with its identity (metric name, device,
    round) so baselines diff record-against-record. Non-finite values
    are kept as None + an error note (the gate fails them loudly)."""
    rec = {
        "schema": SCHEMA_VERSION,
        "kind": "bench",
        "rank": int(rank),
        "metric": str(metric),
    }
    bad = isinstance(value, float) and (value != value or
                                        value in (float("inf"),
                                                  float("-inf")))
    rec["value"] = None if bad or value is None else float(value)
    if bad:
        rec["error"] = f"non-finite value {value!r}"
    if unit is not None:
        rec["unit"] = str(unit)
    if device is not None:
        rec["device"] = str(device)
    if bench_round is not None:
        rec["round"] = int(bench_round)
    if baseline is not None:
        rec["baseline"] = float(baseline)
    for k, v in extra.items():
        if v is not None:
            rec[k] = v
    return rec


def make_phase_record(phase, metrics, rank=0):
    """A bench-phase record (bench.py): same envelope, kind='phase', the
    phase's metric dict under 'metrics'. Non-finite floats become None —
    json.dumps would otherwise emit bare NaN/Infinity tokens, which are
    invalid for strict JSON consumers (jq, Chrome)."""
    clean = {}
    for k, v in (metrics or {}).items():
        if isinstance(v, float) and (v != v or v in (float("inf"),
                                                     float("-inf"))):
            clean[k] = None
        elif isinstance(v, (int, float)) or v is None or isinstance(v, str):
            clean[k] = v
    return {"schema": SCHEMA_VERSION, "kind": "phase", "rank": int(rank),
            "phase": str(phase), "metrics": clean}


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


def read_jsonl(path):
    """Load a metrics JSONL back into a list of dicts (round-trip)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


# ---------------------------------------------------------------------------
# Chrome trace export (multi-rank)
# ---------------------------------------------------------------------------

def spans_to_trace_events(spans, default_rank=0):
    """spans: iterable of dicts {name, t0, dur, rank?, tid?, cat?} (seconds)
    -> chrome trace 'X' events in microseconds, pid == rank."""
    events = []
    ranks = set()
    for sp in spans:
        rank = int(sp.get("rank", default_rank))
        ranks.add(rank)
        ev = {
            "name": sp["name"], "ph": "X",
            "pid": rank, "tid": int(sp.get("tid", 0)),
            "ts": float(sp["t0"]) * 1e6, "dur": float(sp["dur"]) * 1e6,
            "cat": sp.get("cat", "host"),
        }
        if sp.get("args"):
            ev["args"] = sp["args"]
        events.append(ev)
    meta = [{"name": "process_name", "ph": "M", "pid": r,
             "args": {"name": f"rank {r}"}} for r in sorted(ranks)]
    return meta + events


def export_chrome_tracing(path, sources, align_on=None):
    """Write one Chrome-trace JSON merging host spans across ranks.

    `sources` is a list whose items are either TelemetryRecorder objects
    (their `.spans` and `.rank` are used) or plain span-dict lists. Each
    rank becomes its own trace pid. `align_on`: optional span name
    whose start is declared t=0 per rank (a `__sync__` marker span
    recorded at one agreed instant on every rank).

    Spans still OPEN at export time (a stuck collective, an aborted
    step) are closed at 'now' and tagged args={'open': True} rather
    than dropped — an export made from a crash handler must show what
    the program was inside, not pretend it was idle.

    Returns the number of spans written. Output loads in chrome://tracing
    or Perfetto.
    """
    all_spans = []
    for i, src in enumerate(sources):
        spans = getattr(src, "spans", src)
        open_fn = getattr(src, "open_span_dicts", None)
        if open_fn is not None:
            spans = list(spans) + list(open_fn())
        rank = getattr(src, "rank", None)
        for sp in spans:
            sp = dict(sp)
            if "rank" not in sp:
                sp["rank"] = i if rank is None else rank
            all_spans.append(sp)
    if align_on is not None:
        zero = {}
        for sp in all_spans:
            if sp["name"] == align_on:
                zero.setdefault(sp["rank"], sp["t0"])
        for sp in all_spans:
            sp["t0"] = sp["t0"] - zero.get(sp["rank"], 0.0)
    events = spans_to_trace_events(all_spans)
    path = os.fspath(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": events,
                   "displayTimeUnit": "ms"}, f)
    return len(all_spans)
