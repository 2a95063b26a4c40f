"""The ledger rules the fleet drill gates on: the port's own copy.

The port of the kind=memsnap, fleet, ckpt, elastic, plan and commbench
rules of the JAX package's tools/trace_check.py (`check_memsnap_records`,
`check_fleet_records`, `check_ckpt_records`, `check_elastic_records`,
`check_plan_records` with its 15 % projection-drift rule,
`check_commbench_records`) and of the per-record schema checks of
paddle_tpu/telemetry/sink.py's `validate_step_record` for the kinds the
port writes — memsnap, fleet, ckpt, elastic, plan, commbench, and the
training and bench kinds: step (the recorder's step record, health and
MoE fields included), bench, phase and kernelbench —
unchanged, so a ledger passes here exactly when it passes there (the
CPU tests hold the two against each other, on the same records and on
the JAX package's specimens). `check_records(records)` runs all of them
over one combined ledger; `check_jsonl(path)` reads one first.
"""
import json

from .sink import (BENCH_RECORD_KEYS, CKPT_EVENTS, CKPT_RECORD_KEYS,
                   COMM_KEYS, COMMBENCH_EVENTS, COMMBENCH_OPS,
                   COMMBENCH_RECORD_KEYS, ELASTIC_EVENTS,
                   ELASTIC_RECORD_KEYS, PLAN_RECORD_KEYS,
                   FLEET_EVENTS,
                   FLEET_RECORD_KEYS, HEALTH_KEYS, INPUT_KEYS,
                   KERNELBENCH_EVENTS, KERNELBENCH_RECORD_KEYS,
                   MEMSNAP_BUCKETS, MEMSNAP_EVENTS, MEMSNAP_RECORD_KEYS,
                   MOE_KEYS, STEP_RECORD_KEYS)

__all__ = ["validate_record", "check_memsnap_records",
           "check_fleet_records", "check_ckpt_records",
           "check_elastic_records", "check_plan_records",
           "check_commbench_records", "PLAN_DRIFT_FRAC",
           "COMMBENCH_DERIVED_TOL", "check_records", "check_jsonl"]


def validate_record(rec):
    """Schema problems of one kind=memsnap, fleet, ckpt, elastic, plan,
    commbench, step, bench, phase or kernelbench record ([] == valid; records of other
    kinds are not judged here)."""
    problems = []
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, not dict"]
    kind = rec.get("kind")
    if kind == "ckpt":
        for key in CKPT_RECORD_KEYS:
            if key not in rec:
                problems.append(f"ckpt record missing '{key}'")
        ev = rec.get("event")
        if ev is not None and ev not in CKPT_EVENTS:
            problems.append(f"unknown ckpt event {ev!r} "
                            f"(expected one of {list(CKPT_EVENTS)})")
        for key in ("save_ms", "bytes"):
            v = rec.get(key)
            if v is not None and (not isinstance(v, (int, float)) or v < 0):
                problems.append(f"'{key}' not a non-negative number: {v!r}")
        if ev == "commit" and "save_ms" not in rec:
            problems.append("ckpt commit record carries no save_ms")
        return problems
    if kind == "elastic":
        return _validate_elastic(rec)
    if kind == "commbench":
        for key in COMMBENCH_RECORD_KEYS:
            if key not in rec:
                problems.append(f"commbench record missing '{key}'")
        op = rec.get("op")
        if op is not None and op not in COMMBENCH_OPS:
            problems.append(f"unknown commbench op {op!r} (expected one "
                            f"of {list(COMMBENCH_OPS)})")
        for key in ("time_ms", "compile_ms", "predicted_ms", "db_ms",
                    "wire_bytes", "achieved_bw", "peak_bw"):
            v = rec.get(key)
            if v is not None and (not isinstance(v, (int, float))
                                  or v != v or v < 0):
                problems.append(
                    f"'{key}' not a non-negative number: {v!r}")
        if rec.get("time_ms") is None and "error" not in rec:
            problems.append("commbench record with null time_ms "
                            "carries no 'error' note")
        v = rec.get("bw_frac")
        if v is not None and (not isinstance(v, (int, float))
                              or v != v or not 0.0 <= v <= 1.0):
            problems.append(
                f"'bw_frac' not a bandwidth fraction in [0, 1]: {v!r}")
        for key in ("axis_size", "payload_bytes"):
            v = rec.get(key)
            if v is not None and (not isinstance(v, int) or v < 1):
                problems.append(f"'{key}' not a positive int: {v!r}")
        for key in ("n_samples", "warmup"):
            v = rec.get(key)
            if v is not None and (not isinstance(v, int) or v < 0):
                problems.append(
                    f"'{key}' not a non-negative int: {v!r}")
        m = rec.get("medium")
        if m is not None and m not in ("ici", "dcn"):
            problems.append(f"'medium' not 'ici'/'dcn': {m!r}")
        ev = rec.get("event")
        if ev is not None and ev not in COMMBENCH_EVENTS:
            problems.append(f"unknown commbench event {ev!r} "
                            f"(expected one of "
                            f"{list(COMMBENCH_EVENTS)})")
        return problems
    if kind == "plan":
        for key in PLAN_RECORD_KEYS:
            if key not in rec:
                problems.append(f"plan record missing '{key}'")
        chosen = rec.get("chosen")
        if chosen is not None:
            if not isinstance(chosen, dict):
                problems.append(f"'chosen' not a layout dict: {chosen!r}")
            else:
                for axis in ("dp", "pp", "mp"):
                    v = chosen.get(axis)
                    if not isinstance(v, int) or v < 1:
                        problems.append(
                            f"chosen layout '{axis}' not a positive "
                            f"int: {v!r}")
        n = rec.get("candidates_considered")
        rejected = rec.get("candidates_rejected")
        if n is not None and (not isinstance(n, int) or n < 1):
            problems.append(
                f"'candidates_considered' not a positive int: {n!r}")
        if rejected is not None:
            if not isinstance(rejected, list):
                problems.append("'candidates_rejected' not a list")
            else:
                if isinstance(n, int) and len(rejected) >= n:
                    problems.append(
                        f"{len(rejected)} rejected candidates but only "
                        f"{n} considered — the chosen layout cannot be "
                        "among them")
                for j, r in enumerate(rejected):
                    if not isinstance(r, dict) or \
                            not str(r.get("reason", "")).strip():
                        problems.append(
                            f"rejected candidate {j} carries no reason "
                            "— a rejection the ledger cannot explain")
        for key in ("projected_hbm_bytes", "measured_hbm_bytes",
                    "hbm_budget_bytes"):
            v = rec.get(key)
            if v is not None and (not isinstance(v, (int, float))
                                  or v < 0):
                problems.append(
                    f"'{key}' not a non-negative number: {v!r}")
        return problems
    if kind == "phase":
        for key in ("schema", "phase", "metrics"):
            if key not in rec:
                problems.append(f"phase record missing '{key}'")
        return problems
    if kind == "bench":
        for key in BENCH_RECORD_KEYS:
            if key not in rec:
                problems.append(f"bench record missing '{key}'")
        v = rec.get("value")
        if v is not None and not isinstance(v, (int, float)):
            problems.append(f"'value' not numeric: {v!r}")
        if isinstance(v, float) and (v != v or v in (float("inf"),
                                                     float("-inf"))):
            problems.append(f"'value' non-finite: {v!r}")
        if v is None and "error" not in rec:
            problems.append("bench record with null value carries no "
                            "'error' note")
        return problems
    if kind == "kernelbench":
        for key in KERNELBENCH_RECORD_KEYS:
            if key not in rec:
                problems.append(f"kernelbench record missing '{key}'")
        if not str(rec.get("kernel", "")).strip():
            problems.append("kernelbench record names no kernel")
        for key in ("kernel_ms", "fallback_ms", "compile_ms",
                    "predicted_ms"):
            v = rec.get(key)
            if v is not None and (not isinstance(v, (int, float))
                                  or v != v or v < 0):
                problems.append(
                    f"'{key}' not a non-negative number: {v!r}")
        if rec.get("kernel_ms") is None and "error" not in rec:
            problems.append("kernelbench record with null kernel_ms "
                            "carries no 'error' note")
        for key in ("flops_frac", "bw_frac"):
            v = rec.get(key)
            if v is not None and (not isinstance(v, (int, float))
                                  or v != v or not 0.0 <= v <= 1.0):
                problems.append(
                    f"'{key}' not a roofline fraction in [0, 1]: {v!r}")
        v = rec.get("speedup")
        if v is not None and (not isinstance(v, (int, float))
                              or v != v or v <= 0):
            problems.append(f"'speedup' not a positive number: {v!r}")
        for key in ("flops", "bytes_accessed", "n_samples", "warmup"):
            v = rec.get(key)
            if v is not None and (not isinstance(v, int) or v < 0):
                problems.append(
                    f"'{key}' not a non-negative int: {v!r}")
        b = rec.get("bound")
        if b is not None and b not in ("compute", "memory"):
            problems.append(f"'bound' not 'compute'/'memory': {b!r}")
        ev = rec.get("event")
        if ev is not None and ev not in KERNELBENCH_EVENTS:
            problems.append(f"unknown kernelbench event {ev!r} "
                            f"(expected one of "
                            f"{list(KERNELBENCH_EVENTS)})")
        return problems
    if kind == "step":
        for key in STEP_RECORD_KEYS:
            if key not in rec:
                problems.append(f"step record missing '{key}'")
        for key in ("step_ms", "compile_ms", "execute_ms"):
            v = rec.get(key)
            if v is not None and (not isinstance(v, (int, float)) or v < 0):
                problems.append(f"'{key}' not a non-negative number: {v!r}")
        for key in ("tokens_per_sec", "mfu", "loss"):
            v = rec.get(key)
            if v is not None and not isinstance(v, (int, float)):
                problems.append(f"'{key}' not numeric: {v!r}")
            if isinstance(v, float) and (v != v or v in (float("inf"),
                                                         float("-inf"))):
                problems.append(f"'{key}' non-finite: {v!r}")
        for key in HEALTH_KEYS:
            # numeric when present; non-finite is ALLOWED here — a NaN
            # grad_norm is the health taps reporting a poisoned step, and
            # the paired nan/inf counts stay machine-checkable integers
            v = rec.get(key)
            if v is not None and not isinstance(v, (int, float)):
                problems.append(f"'{key}' not numeric: {v!r}")
        for key in INPUT_KEYS:
            v = rec.get(key)
            if v is None:
                continue
            if not isinstance(v, (int, float)) or v != v or v < 0:
                problems.append(
                    f"'{key}' not a non-negative number: {v!r}")
            elif key == "input_bound_frac" and v > 1.0:
                problems.append(f"'input_bound_frac' above 1.0: {v!r}")
        for key in MOE_KEYS:
            v = rec.get(key)
            if v is None:
                continue
            if key == "moe_num_experts":
                if not isinstance(v, int) or v < 1:
                    problems.append(
                        f"'moe_num_experts' not a positive int: {v!r}")
                continue
            if not isinstance(v, (int, float)) or v != v:
                problems.append(f"'{key}' not a finite number: {v!r}")
                continue
            if key in ("moe_entropy", "moe_dropped_frac", "moe_overflow") \
                    and v < 0:
                problems.append(f"'{key}' negative: {v!r}")
            if key == "moe_dropped_frac" and v > 1.0:
                problems.append(f"'moe_dropped_frac' above 1.0: {v!r}")
        for key in COMM_KEYS:
            v = rec.get(key)
            if v is None:
                continue
            if not isinstance(v, (int, float)) or v != v or v < 0:
                problems.append(
                    f"'{key}' not a non-negative number: {v!r}")
            elif key == "comm_frac" and v > 1.0:
                problems.append(f"'comm_frac' above 1.0: {v!r}")
        return problems
    if kind == "fleet":
        for key in FLEET_RECORD_KEYS:
            if key not in rec:
                problems.append(f"fleet record missing '{key}'")
        ev = rec.get("event")
        if ev is not None and ev not in FLEET_EVENTS:
            problems.append(f"unknown fleet event {ev!r} "
                            f"(expected one of {list(FLEET_EVENTS)})")
        if ev in ("route", "probe", "declared_dead", "failover",
                  "replay_spliced", "restart"):
            if not str(rec.get("replica", "")).strip():
                problems.append(f"fleet {ev} record names no replica")
        if ev == "declared_dead":
            mc = rec.get("miss_count")
            if not isinstance(mc, int) or mc < 1:
                problems.append(
                    f"fleet declared_dead 'miss_count' not a positive "
                    f"int: {mc!r}")
        if ev == "failover" and not str(rec.get("to_replica",
                                                "")).strip():
            problems.append("fleet failover record names no to_replica "
                            "— where did the request go?")
        if ev == "replay_spliced":
            # the splice must be auditable on its own: both halves and
            # the total are WHAT it asserts (the cross-rule checks the
            # arithmetic; the validator checks the fields exist)
            for key in ("streamed_before", "streamed_after", "n_tokens"):
                v = rec.get(key)
                if not isinstance(v, int) or v < 0:
                    problems.append(
                        f"fleet replay_spliced '{key}' not a "
                        f"non-negative int: {v!r}")
        if ev == "quiesce":
            counts = rec.get("counts")
            if not isinstance(counts, dict):
                problems.append(
                    "fleet quiesce record carries no counts dict")
            else:
                for k, v in counts.items():
                    if not isinstance(v, int) or v < 0:
                        problems.append(
                            f"fleet quiesce count {k!r} not a "
                            f"non-negative int: {v!r}")
        for key in ("miss_count", "detect_s", "streamed_before",
                    "streamed_after", "n_tokens", "queue_depth",
                    "retry_after_s"):
            v = rec.get(key)
            if v is not None and (not isinstance(v, (int, float))
                                  or v != v or v < 0):
                problems.append(
                    f"'{key}' not a non-negative number: {v!r}")
        return problems
    if kind == "memsnap":
        for key in MEMSNAP_RECORD_KEYS:
            if key not in rec:
                problems.append(f"memsnap record missing '{key}'")
        ev = rec.get("event")
        if ev is not None and ev not in MEMSNAP_EVENTS:
            problems.append(f"unknown memsnap event {ev!r} "
                            f"(expected one of {list(MEMSNAP_EVENTS)})")
        for key in ("total_bytes",) + MEMSNAP_BUCKETS + (
                "hbm_budget_bytes", "headroom_bytes", "projected_bytes",
                "kv_eviction_rate", "kv_admission_rate"):
            v = rec.get(key)
            if v is not None and (not isinstance(v, (int, float))
                                  or v != v or v < 0):
                problems.append(
                    f"'{key}' not a non-negative number: {v!r}")
        if rec.get("total_bytes") is None and "error" not in rec:
            problems.append("memsnap record with null total_bytes "
                            "carries no 'error' note")
        for key in ("kv_occupancy", "kv_cache_share"):
            v = rec.get(key)
            if v is not None and (not isinstance(v, (int, float))
                                  or v != v or not 0.0 <= v <= 1.0):
                problems.append(
                    f"'{key}' not a fraction in [0, 1]: {v!r}")
        for key in ("n_arrays", "kv_blocks_total", "kv_blocks_held",
                    "kv_blocks_free", "kv_blocks_cached",
                    "kv_evictions", "kv_admissions"):
            v = rec.get(key)
            if v is not None and (not isinstance(v, int) or v < 0):
                problems.append(
                    f"'{key}' not a non-negative int: {v!r}")
        for key in ("evictions_by_class", "admissions_by_class"):
            v = rec.get(key)
            if v is None:
                continue
            if not isinstance(v, dict):
                problems.append(f"'{key}' not a dict: {v!r}")
            else:
                for cls, n in v.items():
                    if not isinstance(n, int) or n < 0:
                        problems.append(
                            f"'{key}' count for class {cls!r} not a "
                            f"non-negative int: {n!r}")
        if ev == "postmortem":
            # the forensic contract: an OOM record that cannot say
            # what failed, or show WHO held the bytes, diagnoses
            # nothing offline
            if not str(rec.get("error", "")).strip():
                problems.append(
                    "memsnap postmortem carries no error note — a "
                    "forensic record that cannot say what killed the "
                    "allocation")
            ta = rec.get("top_arrays")
            if not isinstance(ta, list) or not ta:
                problems.append(
                    "memsnap postmortem carries no top_arrays listing "
                    "— an OOM with no suspects named")
            else:
                for j, a in enumerate(ta):
                    if not isinstance(a, dict) or \
                            not isinstance(a.get("bytes"), int) or \
                            a["bytes"] < 0:
                        problems.append(
                            f"top_arrays[{j}] carries no non-negative "
                            "'bytes'")
    return problems


# how far kv_occupancy / kv_cache_share may drift from the values
# recomputable from the block counts on the same record (the counts
# are exact ints; the fractions are rounded to 6 places on write)
MEMSNAP_DERIVED_TOL = 1e-4


def check_memsnap_records(records, path):
    """Cross-rules over memory-observatory ledger records
    (kind='memsnap', telemetry/mem_obs). The schema basics
    (non-negative bytes, fractions in [0, 1], postmortem forensics
    completeness) live in `validate_record`; here
    the claims that must be recomputable from the record's own fields:

    - when every attribution bucket is present, the buckets must sum
      EXACTLY to total_bytes — the ledger walk assigns each live array
      to exactly one bucket, so a mismatch means bytes were invented
      or dropped after the walk;
    - headroom_bytes must equal max(0, hbm_budget_bytes - total_bytes)
      and requires the budget on the record — headroom against an
      undeclared budget is a claim with no denominator;
    - the KV block census must tile: held + free + cached ==
      blocks_total (every pool block is in exactly one of the three
      states — BlockPool's own invariant, re-proved per record);
    - kv_occupancy must equal (held + cached) / blocks_total and
      kv_cache_share must equal cached / blocks_total, each requiring
      its counts on the record;
    - the per-class eviction/admission breakdowns, when present, must
      sum to the cumulative kv_evictions / kv_admissions counters;
    - a postmortem's top_arrays bytes must each be <= total_bytes — a
      suspect larger than the whole ledger is a fabricated suspect.
    """
    problems = []

    def _num(v):
        return isinstance(v, (int, float)) and v == v

    buckets = ("params_bytes", "opt_state_bytes", "kv_bytes",
               "workspace_bytes", "other_bytes")
    for i, rec in enumerate(records):
        if not isinstance(rec, dict) or rec.get("kind") != "memsnap":
            continue
        label = f"memsnap step {rec.get('step')}"
        total = rec.get("total_bytes")
        vals = [rec.get(k) for k in buckets]
        if _num(total) and all(_num(v) for v in vals):
            bsum = sum(vals)
            if bsum != total:
                problems.append(
                    f"{path}:{i + 1}: {label} buckets sum to {bsum} "
                    f"but total_bytes claims {total} — the ledger walk "
                    "assigns every array to exactly one bucket, so "
                    "bytes were invented or dropped after the walk")
        head = rec.get("headroom_bytes")
        budget = rec.get("hbm_budget_bytes")
        if _num(head):
            if not _num(budget) or not _num(total):
                problems.append(
                    f"{path}:{i + 1}: {label} claims headroom_bytes "
                    f"{head} without hbm_budget_bytes and total_bytes "
                    "— headroom against an undeclared budget")
            elif head != max(0, budget - total):
                problems.append(
                    f"{path}:{i + 1}: {label} headroom_bytes {head} "
                    f"does not match max(0, budget {budget} - total "
                    f"{total}) = {max(0, budget - total)}")
        nt = rec.get("kv_blocks_total")
        nh, nf, nc = (rec.get("kv_blocks_held"),
                      rec.get("kv_blocks_free"),
                      rec.get("kv_blocks_cached"))
        counts_ok = all(isinstance(v, int) for v in (nt, nh, nf, nc))
        if counts_ok and nh + nf + nc != nt:
            problems.append(
                f"{path}:{i + 1}: {label} KV census does not tile: "
                f"held {nh} + free {nf} + cached {nc} != total {nt} — "
                "every pool block is in exactly one state")
        occ = rec.get("kv_occupancy")
        if _num(occ):
            if not counts_ok or nt <= 0:
                problems.append(
                    f"{path}:{i + 1}: {label} claims kv_occupancy "
                    f"{occ} without a positive block census — a "
                    "fraction with no counts behind it")
            else:
                want = min(1.0, (nh + nc) / nt)
                if abs(occ - want) > MEMSNAP_DERIVED_TOL:
                    problems.append(
                        f"{path}:{i + 1}: {label} kv_occupancy "
                        f"{occ:.6g} does not match (held + cached)/"
                        f"total = {want:.6g}")
        share = rec.get("kv_cache_share")
        if _num(share):
            if not counts_ok or nt <= 0:
                problems.append(
                    f"{path}:{i + 1}: {label} claims kv_cache_share "
                    f"{share} without a positive block census")
            else:
                want = min(1.0, nc / nt)
                if abs(share - want) > MEMSNAP_DERIVED_TOL:
                    problems.append(
                        f"{path}:{i + 1}: {label} kv_cache_share "
                        f"{share:.6g} does not match cached/total = "
                        f"{want:.6g}")
        for by_key, cum_key in (("evictions_by_class", "kv_evictions"),
                                ("admissions_by_class",
                                 "kv_admissions")):
            by = rec.get(by_key)
            cum = rec.get(cum_key)
            if isinstance(by, dict) and by and isinstance(cum, int):
                bsum = sum(v for v in by.values()
                           if isinstance(v, int))
                if bsum != cum:
                    problems.append(
                        f"{path}:{i + 1}: {label} {by_key} sums to "
                        f"{bsum} but {cum_key} claims {cum} — the "
                        "per-class breakdown and the cumulative "
                        "counter disagree")
        if rec.get("event") == "postmortem" and _num(total):
            for t in rec.get("top_arrays") or []:
                b = t.get("bytes") if isinstance(t, dict) else None
                if isinstance(b, int) and b > total:
                    problems.append(
                        f"{path}:{i + 1}: {label} postmortem names a "
                        f"suspect of {b} bytes, larger than the whole "
                        f"ledger ({total}) — a fabricated suspect")
    return problems


def check_fleet_records(records, path):
    """Cross-record rules for fleet-tier events (kind=fleet,
    fleet.FleetRouter + fleet/drill.py). Ordered
    rules bind only WITHIN the fleet records (the router emits them
    from one process, so concatenating per-process ledgers preserves
    their relative order); rules that join fleet records to the
    replicas' own kind=serving records are presence-based, because a
    combined ledger gives no cross-process ordering.

    - a DECLARED_DEAD must be preceded by a failed probe (healthy
      false) for the same replica — a death the prober never
      witnessed is a verdict without evidence;
    - a FAILOVER must reference a replica previously DECLARED DEAD or
      carry a non-empty `error` — re-routing a live, unerrored
      replica's request is load-balancing wearing a failover's name,
      and it would hide real failover bugs in the noise;
    - a REPLAY_SPLICED record's arithmetic must balance: n_tokens ==
      streamed_before + streamed_after — the spliced stream claims to
      be token-identical to an uninterrupted run, and a count that
      doesn't add up means tokens were dropped or double-streamed at
      the splice point; it must also follow a FAILOVER for the same
      request_id (a splice with no failover to explain it);
    - a fleet QUIESCE's counts must balance: requests == (admitted -
      failover) + shed + rejected — every request terminates exactly
      once: a first admission (failovers are RE-admissions), a shed
      at the fleet door, or a permanent rejection;
    - the fleet quiesce's `admitted_by_engine` must agree with each
      engine's OWN serving-quiesce admitted count, for engines whose
      serving quiesce appears in the ledger (a SIGKILLed replica
      never quiesces, so it is exempt — its admissions are vouched
      for by its flushed per-request records instead);
    - when the ledger carries the replicas' serving admitted records,
      every failover's request_id must appear on at least TWO of them
      (the first admission and the replay), at least one marked
      `replayed` — the replayed request on replica B must reference
      the same id as its first admission on replica A.
    """
    problems = []
    fleet = [(i, r) for i, r in enumerate(records)
             if isinstance(r, dict) and r.get("kind") == "fleet"]
    if not fleet:
        return problems
    admitted_rids = {}    # request_id -> [n_admissions, n_replayed]
    serving_quiesce = {}  # str(engine) -> admitted count (last wins)
    any_serving_admitted = False
    for r in records:
        if not isinstance(r, dict) or r.get("kind") != "serving":
            continue
        if r.get("event") == "admitted":
            any_serving_admitted = True
            rid = r.get("request_id")
            if rid is not None:
                slot = admitted_rids.setdefault(str(rid), [0, 0])
                slot[0] += 1
                if r.get("replayed"):
                    slot[1] += 1
        elif r.get("event") == "quiesce":
            counts = r.get("counts")
            if isinstance(counts, dict) and r.get("engine") is not None:
                serving_quiesce[str(r.get("engine"))] = \
                    counts.get("admitted", 0)
    probe_failed = set()     # replicas with a witnessed failed probe
    dead = set()             # replicas declared dead so far
    failover_rids = set()    # request_ids with a failover so far
    for i, rec in fleet:
        ev = rec.get("event")
        replica = rec.get("replica")
        if ev == "probe" and rec.get("healthy") is False:
            probe_failed.add(replica)
        elif ev == "declared_dead":
            if replica not in probe_failed:
                problems.append(
                    f"{path}:{i + 1}: replica {replica!r} declared "
                    "dead with no preceding failed probe — a death "
                    "verdict the prober never witnessed")
            dead.add(replica)
        elif ev == "failover":
            rid = rec.get("request_id")
            if rid is not None:
                failover_rids.add(str(rid))
            if replica not in dead and not rec.get("error"):
                problems.append(
                    f"{path}:{i + 1}: failover away from replica "
                    f"{replica!r} which was neither declared dead nor "
                    "carries an error — a re-route wearing a "
                    "failover's name")
            if any_serving_admitted and rid is not None:
                n_adm, n_replayed = admitted_rids.get(str(rid), (0, 0))
                # a failover at streamed_before == 0 re-admits WITHOUT
                # replay tokens (there is nothing to replay), so the
                # replayed marker is only owed when tokens were already
                # on the wire
                need_replayed = bool(rec.get("streamed_before"))
                if n_adm < 2 or (need_replayed and n_replayed < 1):
                    problems.append(
                        f"{path}:{i + 1}: failover for request "
                        f"{rid!r} but the ledger shows {n_adm} "
                        f"admission(s) ({n_replayed} replayed) for "
                        "that id — the replay on the new replica must "
                        "reference the same request_id as its first "
                        "admission")
        elif ev == "replay_spliced":
            before = rec.get("streamed_before")
            after = rec.get("streamed_after")
            n = rec.get("n_tokens")
            if isinstance(before, int) and isinstance(after, int) and \
                    isinstance(n, int) and before + after != n:
                problems.append(
                    f"{path}:{i + 1}: spliced stream accounting "
                    f"broken: n_tokens {n} != streamed_before "
                    f"{before} + streamed_after {after} — tokens were "
                    "dropped or double-streamed at the splice point")
            rid = rec.get("request_id")
            if rid is not None and str(rid) not in failover_rids:
                problems.append(
                    f"{path}:{i + 1}: replay_spliced for request "
                    f"{rid!r} with no preceding failover for that "
                    "request — a splice nothing explains")
        elif ev == "quiesce":
            counts = rec.get("counts")
            if isinstance(counts, dict):
                req = counts.get("requests", 0)
                first = counts.get("admitted", 0) \
                    - counts.get("failover", 0)
                expect = first + counts.get("shed", 0) \
                    + counts.get("rejected", 0)
                if req != expect:
                    problems.append(
                        f"{path}:{i + 1}: fleet quiesce counts don't "
                        f"balance: requests {req} != (admitted - "
                        f"failover) + shed + rejected {expect} — a "
                        "request terminated zero or twice")
            by_engine = rec.get("admitted_by_engine")
            if isinstance(by_engine, dict):
                for eng, n_adm in by_engine.items():
                    have = serving_quiesce.get(str(eng))
                    if have is not None and have != n_adm:
                        problems.append(
                            f"{path}:{i + 1}: fleet routed {n_adm} "
                            f"admission(s) to engine {eng} but that "
                            f"engine's own quiesce counted {have} — "
                            "the router and the replica disagree "
                            "about what was admitted")
    return problems


def _validate_elastic(rec):
    problems = []
    for key in ELASTIC_RECORD_KEYS:
        if key not in rec:
            problems.append(f"elastic record missing '{key}'")
    ev = rec.get("event")
    if ev is not None and ev not in ELASTIC_EVENTS:
        problems.append(f"unknown elastic event {ev!r} "
                        f"(expected one of {list(ELASTIC_EVENTS)})")
    if ev in ("heartbeat_miss", "declared_dead"):
        if not str(rec.get("host", "")).strip():
            problems.append(f"elastic {ev} record names no host")
        mc = rec.get("miss_count")
        if mc is not None and (not isinstance(mc, int) or mc < 1):
            problems.append(f"'miss_count' not a positive int: {mc!r}")
    for key in ("world_from", "world_to"):
        v = rec.get(key)
        if v is not None and (not isinstance(v, int) or v < 1):
            problems.append(f"'{key}' not a positive int: {v!r}")
    for key in ("layout_from", "layout_to"):
        v = rec.get(key)
        if v is None:
            continue
        if not isinstance(v, dict) or not v:
            problems.append(f"'{key}' not a non-empty layout dict: {v!r}")
            continue
        for a, n in v.items():
            if not isinstance(n, int) or n < 1:
                problems.append(f"'{key}' axis {a!r} size not a positive "
                                f"int: {n!r}")
    if ev == "reshard_restore":
        for key in ("layout_from", "layout_to", "step"):
            if rec.get(key) is None:
                problems.append(f"reshard_restore record missing '{key}'")
    return problems


def check_ckpt_records(records, path="ledger"):
    """Cross-record rules for checkpoint events: per rank, commit steps
    are monotonic non-decreasing; every commit follows a save event of
    the same step and rank; a restore or fallback references a step
    some commit in the ledger landed, when the ledger holds commits."""
    problems = []
    last_commit = {}
    saved = set()
    committed = set()
    any_commits = False
    for i, rec in enumerate(records):
        if not isinstance(rec, dict) or rec.get("kind") != "ckpt":
            continue
        rank = rec.get("rank", 0)
        step = rec.get("step")
        event = rec.get("event")
        if not isinstance(step, (int, float)):
            continue
        if event == "save":
            saved.add((rank, step))
        elif event == "commit":
            any_commits = True
            committed.add((rank, step))
            if (rank, step) not in saved:
                problems.append(
                    f"{path}:{i + 1}: ckpt commit at step {step} "
                    f"(rank {rank}) with no preceding save event")
            prev = last_commit.get(rank)
            if prev is not None and step < prev:
                problems.append(
                    f"{path}:{i + 1}: ckpt commit at step {step} after "
                    f"one at step {prev} (rank {rank}, non-monotonic)")
            last_commit[rank] = step
        elif event in ("restore", "fallback") and any_commits and \
                (rank, step) not in committed:
            problems.append(
                f"{path}:{i + 1}: ckpt {event} references step {step} "
                f"(rank {rank}) that no commit in this ledger landed")
    return problems


def check_elastic_records(records, path="ledger"):
    """Cross-record rules for elastic events: a declared_dead follows a
    heartbeat_miss of the same host; a reshard_restore references a
    step some ckpt commit in the ledger landed, when the ledger holds
    commits; a relaunch follows a replan."""
    problems = []
    missed = set()
    committed = set()
    any_commits = any_replan = False
    for i, rec in enumerate(records):
        if not isinstance(rec, dict):
            continue
        kind = rec.get("kind")
        if kind == "ckpt" and rec.get("event") == "commit" and \
                isinstance(rec.get("step"), (int, float)):
            any_commits = True
            committed.add(rec["step"])
            continue
        if kind != "elastic":
            continue
        event, host = rec.get("event"), rec.get("host")
        if event == "heartbeat_miss":
            missed.add(host)
        elif event == "declared_dead" and host not in missed:
            problems.append(f"{path}:{i + 1}: host {host!r} declared dead "
                            "with no preceding heartbeat_miss record")
        elif event == "replan":
            any_replan = True
        elif event == "relaunch" and not any_replan:
            problems.append(f"{path}:{i + 1}: elastic relaunch with no "
                            "preceding replan record")
        elif event == "reshard_restore":
            step = rec.get("step")
            if any_commits and isinstance(step, (int, float)) and \
                    step not in committed:
                problems.append(
                    f"{path}:{i + 1}: reshard_restore references step "
                    f"{step} that no ckpt commit in this ledger landed")
    return problems


# plan-record projection drift threshold (the JAX tool's 15%): past it
# the planner's feasibility decisions were made on fiction
PLAN_DRIFT_FRAC = 0.15


def check_plan_records(records, path="ledger"):
    """Cross-record rules for auto-sharding plan records (kind=plan,
    planner.Plan.to_record; per-record schema in `validate_record`):

    - the chosen layout's axis product must equal n_chips when both
      are present — a plan whose mesh does not multiply out to its
      chip count never factorized anything;
    - when both projected_hbm_bytes and measured_hbm_bytes are present
      (the compile observatory measured the chosen layout), they must
      agree within PLAN_DRIFT_FRAC — a plan whose projection drifted
      >15% from the measured peak chose its layout on numbers that
      were wrong, and the search must be re-run with the measured
      calibration.
    """
    problems = []
    for i, rec in enumerate(records):
        if not isinstance(rec, dict) or rec.get("kind") != "plan":
            continue
        chosen = rec.get("chosen")
        n_chips = rec.get("n_chips")
        if isinstance(chosen, dict) and isinstance(n_chips, int):
            prod = 1
            for axis in ("dp", "pp", "mp", "sp", "ep"):
                v = chosen.get(axis, 1)
                prod *= v if isinstance(v, int) and v > 0 else 1
            if prod != n_chips:
                problems.append(
                    f"{path}:{i + 1}: chosen layout multiplies to "
                    f"{prod} chips but the plan claims n_chips="
                    f"{n_chips}")
        projected = rec.get("projected_hbm_bytes")
        measured = rec.get("measured_hbm_bytes")
        if isinstance(projected, (int, float)) and \
                isinstance(measured, (int, float)) and measured > 0:
            drift = abs(measured - projected) / float(measured)
            if drift > PLAN_DRIFT_FRAC:
                problems.append(
                    f"{path}:{i + 1}: plan projection drift "
                    f"{drift * 100:.1f}% (projected "
                    f"{projected / 2**30:.2f} GiB vs measured "
                    f"{measured / 2**30:.2f} GiB) exceeds "
                    f"{PLAN_DRIFT_FRAC * 100:.0f}% — re-plan with "
                    "calibration from the measured peak")
    return problems


# how far achieved_bw / bw_frac / predicted_ms may drift from the
# values recomputable from their own inputs on the same record
COMMBENCH_DERIVED_TOL = 0.05


def check_commbench_records(records, path="ledger"):
    """Cross-rules over mesh-observatory measurement records
    (kind='commbench', telemetry/comm_obs via tools/commlab.py). The
    schema basics (non-negative ms, bw_frac in [0, 1], positive
    axis_size/payload) live in `validate_record`; here the claims that
    must be recomputable from the record's own fields:

    - achieved_bw must equal wire_bytes / (time_ms / 1e3) within 5% —
      a bandwidth the ledger cannot reproduce is a doctored row;
    - bw_frac must equal min(1, achieved_bw / peak_bw) within 5%, and
      requires BOTH inputs on the record;
    - predicted_ms must equal wire_bytes / peak_bw * 1e3 within 5% —
      the analytic floor the calibration ratio divides by must match
      the peak the record claims to have been priced against;
    - wire_bytes must lie in (0, 2 x payload_bytes] — no wire-fraction
      convention (comm_audit: (n-1)/n, full, or ring 2(n-1)/n) moves
      more than twice the operand;
    - a db_update event must reference, by db_key, a measured row in
      the SAME file — the DB may only roll forward from measurements
      the ledger shows (the kernelbench rule).
    """
    problems = []
    measured_keys = set()
    for r in records:
        if isinstance(r, dict) and r.get("kind") == "commbench" \
                and r.get("event") in (None, "measure") \
                and r.get("db_key"):
            measured_keys.add(r["db_key"])

    def _num(v):
        return isinstance(v, (int, float)) and v == v

    for i, rec in enumerate(records):
        if not isinstance(rec, dict) or rec.get("kind") != "commbench":
            continue
        label = f"{rec.get('op')} over {rec.get('axis')!r}"
        tm, wb = rec.get("time_ms"), rec.get("wire_bytes")
        abw, pbw = rec.get("achieved_bw"), rec.get("peak_bw")
        frac, pm = rec.get("bw_frac"), rec.get("predicted_ms")
        payload = rec.get("payload_bytes")
        if _num(wb) and isinstance(payload, int) and payload > 0 \
                and not 0.0 < wb <= 2.0 * payload:
            problems.append(
                f"{path}:{i + 1}: commbench {label} claims wire_bytes "
                f"{wb} outside (0, 2 x payload_bytes {payload}] — no "
                "wire-fraction convention moves that")
        if _num(abw):
            if not _num(tm) or tm <= 0 or not _num(wb) or wb <= 0:
                problems.append(
                    f"{path}:{i + 1}: commbench {label} claims "
                    f"achieved_bw {abw} without positive time_ms and "
                    "wire_bytes — a bandwidth with no inputs on the "
                    "ledger")
            else:
                want = wb / (tm / 1e3)
                if abs(abw - want) > COMMBENCH_DERIVED_TOL * want:
                    problems.append(
                        f"{path}:{i + 1}: commbench {label} achieved_bw "
                        f"{abw:.4g} does not match wire_bytes/"
                        f"(time_ms/1e3) = {want:.4g} — the claim and "
                        "its inputs disagree")
        if _num(frac):
            if not _num(abw) or not _num(pbw) or pbw <= 0:
                problems.append(
                    f"{path}:{i + 1}: commbench {label} claims bw_frac "
                    f"{frac} without achieved_bw and peak_bw — a "
                    "fraction with no numerator or denominator")
            else:
                want = min(1.0, abw / pbw)
                if abs(frac - want) > COMMBENCH_DERIVED_TOL \
                        * max(want, 1e-9):
                    problems.append(
                        f"{path}:{i + 1}: commbench {label} bw_frac "
                        f"{frac:.4g} does not match min(1, achieved/"
                        f"peak) = {want:.4g}")
        if _num(pm) and _num(wb) and _num(pbw) and pbw > 0:
            want = wb / pbw * 1e3
            if want > 0 and abs(pm - want) > COMMBENCH_DERIVED_TOL * want:
                problems.append(
                    f"{path}:{i + 1}: commbench {label} predicted_ms "
                    f"{pm:.4g} does not match wire_bytes/peak_bw = "
                    f"{want:.4g} — the analytic floor and the peak it "
                    "claims disagree")
        if rec.get("event") == "db_update":
            key = rec.get("db_key")
            if not key:
                problems.append(
                    f"{path}:{i + 1}: commbench db_update for {label} "
                    "carries no db_key — an update that references "
                    "nothing")
            elif key not in measured_keys:
                problems.append(
                    f"{path}:{i + 1}: commbench db_update references "
                    f"db_key {key!r} but no measured record in this "
                    "file carries it — the DB may only roll forward "
                    "from measurements the ledger shows")
    return problems


def check_records(records, path="ledger"):
    """Every rule of this module over one ledger (a list of records,
    e.g. the concatenation of every process's JSONL): per-record schema
    problems, then the cross-record rules. Returns the
    problems ([] == clean)."""
    problems = []
    for i, rec in enumerate(records):
        for p in validate_record(rec):
            problems.append(f"{path}:{i + 1}: {p}")
    problems += check_memsnap_records(records, path)
    problems += check_fleet_records(records, path)
    problems += check_ckpt_records(records, path)
    problems += check_elastic_records(records, path)
    problems += check_plan_records(records, path)
    problems += check_commbench_records(records, path)
    return problems


def check_jsonl(path):
    """(records, problems) of a JSONL ledger file; a line that is not
    JSON is a problem, and so is a file with no records."""
    records, problems = [], []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError as e:
                problems.append(f"{path}:{i + 1}: not JSON: {e}")
    if not records:
        problems.append(f"{path}: no records")
    return records, problems + check_records(records, path)
