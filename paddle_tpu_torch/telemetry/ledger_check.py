"""The ledger rules the fleet drill gates on: the port's own copy.

The port of the kind=memsnap and kind=fleet rules of the JAX package's
tools/trace_check.py (`check_memsnap_records`, `check_fleet_records`)
and of the per-record schema checks of those two kinds from
paddle_tpu/telemetry/sink.py's `validate_step_record`, unchanged, so a
ledger passes here exactly when it passes there (the CPU tests hold the
two against each other, on the same records and on the JAX package's
fleet specimens). `check_records(records)` runs all of them over one
combined ledger; `check_jsonl(path)` reads one first.
"""
import json

from .sink import (FLEET_EVENTS, FLEET_RECORD_KEYS, MEMSNAP_BUCKETS,
                   MEMSNAP_EVENTS, MEMSNAP_RECORD_KEYS)

__all__ = ["validate_record", "check_memsnap_records",
           "check_fleet_records", "check_records", "check_jsonl"]


def validate_record(rec):
    """Schema problems of one kind=memsnap or kind=fleet record ([] ==
    valid; records of other kinds are not judged here)."""
    problems = []
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, not dict"]
    kind = rec.get("kind")
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


def check_records(records, path="ledger"):
    """Every rule of this module over one ledger (a list of records,
    e.g. the concatenation of every process's JSONL): per-record schema
    problems, then the memsnap and fleet cross-record rules. Returns the
    problems ([] == clean)."""
    problems = []
    for i, rec in enumerate(records):
        for p in validate_record(rec):
            problems.append(f"{path}:{i + 1}: {p}")
    problems += check_memsnap_records(records, path)
    problems += check_fleet_records(records, path)
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
