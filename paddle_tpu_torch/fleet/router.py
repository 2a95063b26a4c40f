"""FleetRouter: health-probed, affinity-routed, failover-replaying
front over N replicas.

The port of paddle_tpu/fleet/router.py, its policy unchanged: the same
FNV-1a affinity key, rendezvous order, stickiness, door shed, breaker,
failover splice, stamped seeds and rolling restart, so the same prompts
and replica names route the same way in both packages. The design
rides three earlier invariants instead of inventing new machinery:

- **Failure detection**: consecutive probe misses (an unreachable
  replica, or one reporting itself dead) count per replica;
  `miss_threshold` of them declare it dead — every miss and the
  declaration are `kind=fleet` records, so the ledger rules
  (telemetry/ledger_check.py) can enforce that no replica is declared
  dead without the misses that justify it. One probe of a replica
  runs at a time (a second caller skips it), so verdicts land in the
  order they were asked for. A per-replica circuit
  breaker (closed -> open -> half-open) keeps a flapping replica from
  eating live traffic while it recovers. The clock is injectable; tests pin the schedule.
- **Prefix affinity** hashes the SAME chunk key the radix prefix index
  uses (the first `block_size` prompt tokens), rendezvous-hashed over
  the healthy replicas — shared prompts land where their KV blocks are
  warm, which turns the per-engine prefix cache into a fleet-wide win.
  Session stickiness (multi-turn chat: the conversation IS a growing
  shared prefix) pins a session to its replica; least-loaded by probed
  queue depth is the fallback, and when every healthy replica is
  saturated the fleet sheds AT THE DOOR with 429 + Retry-After.
- **Failover replay** is the engine's recompute-replay invariant made
  cross-replica: on a mid-stream death the router resubmits prompt +
  already-streamed tokens to another replica (`replay_tokens`); the
  engine prefills the replayed positions (riding the prefix cache) and
  resumes decode at `fold_in(base, len(streamed))`, so the spliced
  stream is token-identical to an uninterrupted run. The router
  PROVES the splice: the replay replica's own terminal accounting
  (`stats.n_tokens`, which counts replayed + new) must equal
  streamed_before + streamed_after, and the `replay_spliced` record
  publishes the arithmetic for the ledger rules. Sampling requests
  without a seed get one STAMPED at the door — a replica draws an
  unseeded request's key from its own process's generator, which
  another replica cannot reproduce, and an unseeded replay would
  splice a different stream.
"""
import itertools
import threading
import time

from .. import monitor
from ..resilience.retry import classify_failure, retry_after_hint
from ..serving.resilience import ShedError
from ..telemetry.sink import make_fleet_record

__all__ = ["FleetRouter", "FleetShedError", "NoHealthyReplicaError",
           "BREAKER_CLOSED", "BREAKER_OPEN", "BREAKER_HALF_OPEN"]

BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"


class FleetShedError(ShedError):
    """Every healthy replica refused the request (or none is healthy):
    the fleet sheds at the door — HTTP 429 + Retry-After, same contract
    as a single engine's admission shed."""

    reason = "fleet_saturated"


class NoHealthyReplicaError(FleetShedError):
    """The registry has no routable replica at all (all dead, open, or
    draining)."""

    reason = "no_healthy_replica"


def _fnv1a(data):
    """FNV-1a 64-bit — a stable, dependency-free hash for rendezvous
    routing (hash() is salted per process; two routers would disagree)."""
    h = 0xcbf29ce484222325
    for b in data.encode() if isinstance(data, str) else data:
        h ^= b
        h = (h * 0x100000001b3) & 0xFFFFFFFFFFFFFFFF
    return h


class _ReplicaState:
    """Router-side view of one replica: breaker, consecutive misses,
    last probe snapshot, sticky sessions land here."""

    def __init__(self, replica):
        self.replica = replica
        self.breaker = BREAKER_CLOSED
        self.misses = 0
        self.first_miss_t = None
        self.open_until = None
        self.dead = False
        self.draining = False      # router-side (rolling restart)
        self.snap = None           # last successful probe dict
        self.last_probe_t = None
        self.incarnation = 0       # bumped by readmit (a new process)
        self.probing = False       # a probe of this replica is in flight


class FleetRouter:
    """Route, probe, fail over, restart. All mutable state is guarded
    by one lock; streaming happens OUTSIDE it (only bookkeeping is
    locked, so N streams interleave freely).

        router = FleetRouter([InProcessReplica("r0", e0), ...],
                             sink=JsonlSink("fleet.jsonl"))
        for tok in router.stream(prompt, {"max_new_tokens": 32}):
            ...

    `clock` is injectable (fake-clock tests pin breaker cooldowns and
    death-declaration timing exactly); `probe_interval_s` throttles
    implicit probes on the routing path; `block_size` must match the
    replicas' engine block size for affinity to hit the same chunk key
    the radix index uses.
    """

    def __init__(self, replicas, miss_threshold=3, probe_interval_s=1.0,
                 breaker_cooldown_s=5.0, block_size=16, max_queue_depth=None,
                 failover_budget=3, seed_base=0, sink=None, rank=0,
                 clock=None):
        if not replicas:
            raise ValueError("FleetRouter needs at least one replica")
        if miss_threshold < 1:
            raise ValueError(
                f"miss_threshold must be >= 1, got {miss_threshold}")
        self._mu = threading.Lock()
        self._states = {}               # guarded by: _mu
        for r in replicas:
            if r.name in self._states:
                raise ValueError(f"duplicate replica name {r.name!r}")
            self._states[r.name] = _ReplicaState(r)
        self.miss_threshold = int(miss_threshold)
        self.probe_interval_s = float(probe_interval_s)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.block_size = int(block_size)
        # cross-replica admission: with every healthy replica's probed
        # queue at/above this depth the fleet sheds at the door (None:
        # rely on the per-replica admission controllers' sheds only)
        self.max_queue_depth = None if max_queue_depth is None \
            else int(max_queue_depth)
        self.failover_budget = int(failover_budget)
        self.rank = int(rank)
        self._clock = clock or time.monotonic
        self.sink = sink
        self.events = []                # guarded by: _mu
        self._sessions = {}             # guarded by: _mu — session -> name
        self._seed_seq = itertools.count(int(seed_base))
        self._req_seq = itertools.count()
        # the quiesce ledger: every counter the fleet quiesce record
        # publishes and the ledger rules balance
        self.counts = {"requests": 0, "admitted": 0, "shed": 0,
                       "rejected": 0, "failover": 0, "spliced": 0,
                       "restart": 0}
        self.admitted_by_engine = {}    # guarded by: _mu — engine_id -> n

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------
    def _emit(self, event, **fields):
        rec = make_fleet_record(event, rank=self.rank, **fields)
        with self._mu:
            self.events.append(rec)
        monitor.incr(f"fleet.{event}")
        if self.sink is not None:
            self.sink.write(rec)
        return rec

    def _update_gauges(self):
        with self._mu:
            healthy = sum(1 for st in self._states.values()
                          if self._routable_locked(st))
            dead = sum(1 for st in self._states.values() if st.dead)
        monitor.set_gauge("fleet.replicas", len(self._states))
        monitor.set_gauge("fleet.replicas_healthy", healthy)
        monitor.set_gauge("fleet.replicas_dead", dead)

    def emit_quiesce(self):
        """Publish the router's accounting ledger. The ledger rules
        balance it: requests == first-admissions + sheds + rejections
        (first-admissions = admitted - failover re-admissions), and each
        engine's own serving-quiesce admitted count must equal the
        router's admitted_by_engine entry for it."""
        with self._mu:
            counts = dict(self.counts)
            by_engine = {str(k): v
                         for k, v in self.admitted_by_engine.items()}
        return self._emit("quiesce", counts=counts,
                          admitted_by_engine=by_engine or None)

    # ------------------------------------------------------------------
    # health: probes, breaker, death declaration
    # ------------------------------------------------------------------
    def _routable_locked(self, st):
        if st.dead or st.draining:
            return False
        if st.breaker == BREAKER_OPEN:
            if st.open_until is not None and \
                    self._clock() >= st.open_until:
                st.breaker = BREAKER_HALF_OPEN   # cooldown elapsed:
                return True                      # one trial allowed
            return False
        return True

    def probe(self, name):
        """Probe one replica NOW; update breaker/miss state; emit the
        kind=fleet probe record. Returns the set of replicas newly
        declared dead ({} or {name})."""
        with self._mu:
            st = self._states[name]
            if st.probing:
                # one probe of a replica at a time: the prober, the
                # routing path and a failed stream may all ask at once,
                # and overlapping verdicts could land out of order (a
                # slow success after a fast miss left a replica dead
                # with no misses); the probe in flight judges it
                return set()
            st.probing = True
            incarnation = st.incarnation
        snap = None
        err = None
        try:
            snap = st.replica.probe()
            if snap.get("dead"):
                err = "replica reports dead"
        except Exception as e:            # unreachable IS the miss
            err = f"{type(e).__name__}: {e}"
        except BaseException:
            with self._mu:
                st.probing = False
            raise
        newly_dead = set()
        with self._mu:
            st.probing = False
            if st.incarnation != incarnation:
                # readmitted while this probe ran: its verdict is about
                # the process the restart replaced (a probe hung on the
                # old one would count misses against the new one)
                return newly_dead
            # the clock is read under the lock, after the probe: two
            # probes of one replica can overlap (the prober and a failed
            # stream's miss), and a time taken before the probe could
            # precede the first miss the other one recorded, giving a
            # negative detect_s
            now = self._clock()
            st.last_probe_t = now
            if err is None:
                st.snap = snap
                st.misses = 0
                st.first_miss_t = None
                if st.breaker != BREAKER_CLOSED:
                    st.breaker = BREAKER_CLOSED
                    st.open_until = None
                healthy, miss_count = True, None
            else:
                st.misses += 1
                if st.first_miss_t is None:
                    st.first_miss_t = now
                st.breaker = BREAKER_OPEN
                st.open_until = now + self.breaker_cooldown_s
                healthy, miss_count = False, st.misses
                if st.misses >= self.miss_threshold and not st.dead:
                    st.dead = True
                    newly_dead.add(name)
            breaker = st.breaker
            queue_depth = (st.snap or {}).get("queue_depth")
            detect_s = None if not newly_dead or st.first_miss_t is None \
                else now - st.first_miss_t
            miss_n = st.misses
        self._emit("probe", replica=name, healthy=healthy,
                   miss_count=miss_count, breaker=breaker,
                   queue_depth=queue_depth, error=err)
        if newly_dead:
            self._emit("declared_dead", replica=name, miss_count=miss_n,
                       detect_s=detect_s)
            monitor.incr("fleet.deaths")
        self._update_gauges()
        return newly_dead

    def probe_all(self):
        """Probe every not-yet-dead replica; returns all newly declared
        dead names."""
        with self._mu:
            names = [n for n, st in self._states.items() if not st.dead]
        dead = set()
        for name in names:
            dead |= self.probe(name)
        return dead

    def _maybe_probe(self):
        """Routing-path refresh: probe replicas whose snapshot is older
        than probe_interval_s (or never probed)."""
        now = self._clock()
        with self._mu:
            stale = [n for n, st in self._states.items()
                     if not st.dead and
                     (st.last_probe_t is None or
                      now - st.last_probe_t >= self.probe_interval_s)]
        for name in stale:
            self.probe(name)

    def _note_miss(self, name, err):
        """A live request hit a connection-level failure on `name`:
        that is a probe miss learned the expensive way. Feeds the same
        consecutive-miss counter the prober uses (and may declare the
        death right here)."""
        with self._mu:
            st = self._states.get(name)
            if st is None or st.dead:
                return
        self.probe(name)    # confirm via the probe path (counts a miss
        #                     when the replica really is unreachable)

    def declare_dead(self, name, reason="external"):
        """Explicitly declare a replica dead (a supervisor that KNOWS —
        e.g. it killed the process — need not wait out the probe
        misses). Still records a probe miss first so the ledger shows
        a failed probe preceding every declaration."""
        with self._mu:
            st = self._states[name]
            if st.dead:
                return
            st.misses = max(st.misses, 1) if st.misses else 1
            st.breaker = BREAKER_OPEN
            st.dead = True
            miss_n = st.misses
        self._emit("probe", replica=name, healthy=False,
                   miss_count=miss_n, breaker=BREAKER_OPEN, error=reason)
        self._emit("declared_dead", replica=name, miss_count=miss_n,
                   reason=reason)
        monitor.incr("fleet.deaths")
        self._update_gauges()

    def readmit(self, name):
        """Bring a replica back into rotation (post-restart): clears
        dead/draining/breaker/miss state. The next probe re-validates;
        a probe still in flight from before is discarded (it judged the
        replaced process)."""
        with self._mu:
            st = self._states[name]
            st.incarnation += 1
            st.dead = False
            st.draining = False
            st.breaker = BREAKER_CLOSED
            st.misses = 0
            st.first_miss_t = None
            st.open_until = None
            st.snap = None
            st.last_probe_t = None
        self._update_gauges()

    def replica_states(self):
        """Registry view for /replicas and the drill: name -> dict."""
        with self._mu:
            out = {}
            for name, st in self._states.items():
                out[name] = {
                    "breaker": st.breaker, "dead": st.dead,
                    "draining": st.draining, "misses": st.misses,
                    "queue_depth": (st.snap or {}).get("queue_depth"),
                    "engine_id": st.replica.engine_id,
                }
            return out

    # ------------------------------------------------------------------
    # routing policy
    # ------------------------------------------------------------------
    def _affinity_key(self, prompt):
        """The radix-index chunk key for this prompt — the FIRST
        full-block token chunk (kv_cache.PrefixIndex keys its trie on
        `tuple(tokens[:block_size])` chunks). Prompts shorter than one
        block share no cacheable prefix, so affinity abstains."""
        if len(prompt) < self.block_size:
            return None
        return ",".join(str(int(t))
                        for t in prompt[:self.block_size])

    def _pick(self, prompt, session=None, exclude=()):
        """One routing decision -> (replica, policy) or raises
        FleetShedError/NoHealthyReplicaError. Order: session sticky ->
        prefix affinity (rendezvous) -> least loaded."""
        with self._mu:
            candidates = [
                (n, st) for n, st in self._states.items()
                if n not in exclude and self._routable_locked(st)]
            if not candidates:
                raise NoHealthyReplicaError(
                    "no routable replica (dead/draining/breaker-open)",
                    retry_after_s=self.breaker_cooldown_s)
            # cross-replica admission: shed at the fleet door when the
            # whole fleet is saturated — a request that would only join
            # the deepest queue in the building belongs outside it
            if self.max_queue_depth is not None:
                depths = [(st.snap or {}).get("queue_depth")
                          for _, st in candidates]
                known = [d for d in depths if d is not None]
                if known and min(known) >= self.max_queue_depth and \
                        len(known) == len(depths):
                    raise FleetShedError(
                        f"every healthy replica's queue >= "
                        f"{self.max_queue_depth}",
                        retry_after_s=1.0, queue_depth=min(known))
            if session is not None:
                sticky = self._sessions.get(session)
                for n, st in candidates:
                    if n == sticky:
                        return st.replica, "session"
            key = self._affinity_key(prompt)
            if key is not None:
                # rendezvous (highest-random-weight): every router
                # instance maps the same key to the same replica, and a
                # replica loss only remaps ITS keys. The name goes
                # FIRST: replica names usually differ only in their
                # final byte, and FNV-1a's last-byte avalanche is too
                # weak to reorder the weights — hashed key-last, one
                # replica wins nearly every key; hashed name-first,
                # every key byte amplifies the name difference and the
                # split is near-uniform
                n, st = max(candidates,
                            key=lambda c: _fnv1a(f"{c[0]}|{key}"))
                return st.replica, "prefix_affinity"
            n, st = min(candidates,
                        key=lambda c: ((c[1].snap or {}).get(
                            "queue_depth") or 0))
            return st.replica, "least_loaded"

    # ------------------------------------------------------------------
    # the request path: route -> stream -> fail over -> splice
    # ------------------------------------------------------------------
    def stream(self, prompt, params=None, session=None, request_id=None,
               priority="normal", deadlines=None, timeout=None):
        """Generator of token ids with failover built in. Yields each
        token ONCE — after a mid-stream replica death the replay on
        another replica resumes exactly where the dead one stopped, and
        the client never notices beyond latency."""
        from .replica import _normalize_params
        params = _normalize_params(params)
        if params.get("decode_strategy") == "sampling" and \
                params.get("seed") is None:
            # stamp the seed HERE: an unseeded sampling request draws
            # its base key from the replica's process-local generator,
            # which a failover replay on another replica cannot
            # reproduce — the stamped seed makes the replayed stream
            # provably the same stream
            params["seed"] = next(self._seed_seq)
        rid = str(request_id) if request_id is not None \
            else f"fleet-{self.rank}-{next(self._req_seq)}"
        with self._mu:
            self.counts["requests"] += 1
        monitor.incr("fleet.requests")
        return self._stream_gen(list(prompt), params, session, rid,
                                priority, deadlines, timeout)

    def _stream_gen(self, prompt, params, session, rid, priority,
                    deadlines, timeout):
        # the accounting identity the quiesce record must satisfy
        # (the ledger rules enforce it): every request terminates exactly
        # once — a first admission (admitted - failover), a door shed
        # (never admitted), or a permanent rejection (never admitted).
        # The failover counter therefore counts RE-ADMISSIONS, not
        # attempts: its record is emitted when the replacement replica
        # actually admits the replay, never for a re-route whose first
        # try was rejected at the door.
        streamed = []
        splice_at = None       # len(streamed) at the LAST re-admission
        failed = None          # (name, err) of an admitted-then-failed
        ever_admitted = False
        failures = 0
        exclude = set()
        shed_hint = None
        while True:
            self._maybe_probe()
            try:
                target, policy = self._pick(prompt, session=session,
                                            exclude=exclude)
            except FleetShedError as exc:
                if not ever_admitted:
                    self._account_shed(
                        rid, retry_after_hint(exc) or shed_hint)
                raise
            self._emit("route", replica=target.name, request_id=rid,
                       policy=policy, session=session,
                       queue_depth=self._snap_depth(target.name))
            admitted_here = False
            try:
                rs = target.start_stream(
                    prompt, params, request_id=rid,
                    replay_tokens=streamed or None,
                    priority=priority, deadlines=deadlines,
                    timeout=timeout)
                self._note_admitted(target, session)
                admitted_here = ever_admitted = True
                if failed is not None:
                    # the replay is ADMITTED: now the failover is real
                    fname, ferr = failed
                    self._emit(
                        "failover", replica=fname,
                        to_replica=target.name, request_id=rid,
                        reason="declared_dead" if self._is_dead(fname)
                        else "stream_error",
                        error=ferr, streamed_before=len(streamed))
                    with self._mu:
                        self.counts["failover"] += 1
                    monitor.incr("fleet.failovers")
                    splice_at = len(streamed)
                    failed = None
                for tok in rs:
                    streamed.append(int(tok))
                    yield int(tok)
            except Exception as exc:
                kind = classify_failure(exc)
                if kind == "permanent":
                    # the request itself is wrong; every replica would
                    # reject it the same way
                    if not ever_admitted:
                        self._account_rejected(rid)
                    raise
                if not admitted_here:
                    # submit-time rejection (shed / draining) or an
                    # unreachable replica: nothing admitted, nothing
                    # streamed — a re-route, not a failover
                    shed_hint = retry_after_hint(exc) or shed_hint
                    if not (isinstance(exc, ShedError) or
                            getattr(exc, "http_status", None) == 429):
                        self._note_miss(
                            target.name, f"{type(exc).__name__}: {exc}")
                    exclude.add(target.name)
                    continue
                # admitted, then failed mid-flight: the failover case
                err = f"{type(exc).__name__}: {exc}"
                self._note_miss(target.name, err)
                failures += 1
                if failures > self.failover_budget:
                    raise
                failed = (target.name, err)
                exclude.add(target.name)
                continue
            # clean completion
            if splice_at is not None:
                before, after = splice_at, len(streamed) - splice_at
                n = len(streamed)
                engine_n = (rs.stats or {}).get("n_tokens")
                if engine_n is not None and int(engine_n) != n:
                    # the proof failed: the replay replica's own ledger
                    # disagrees with the splice arithmetic
                    raise RuntimeError(
                        f"request {rid}: spliced stream accounting "
                        f"broken — engine reports {engine_n} token(s), "
                        f"router streamed {before}+{after}={n}")
                self._emit("replay_spliced", replica=target.name,
                           request_id=rid, streamed_before=before,
                           streamed_after=after, n_tokens=n)
                with self._mu:
                    self.counts["spliced"] += 1
                monitor.incr("fleet.spliced")
            return

    def _snap_depth(self, name):
        with self._mu:
            st = self._states.get(name)
            return (st.snap or {}).get("queue_depth") if st else None

    def _is_dead(self, name):
        with self._mu:
            st = self._states.get(name)
            return bool(st and st.dead)

    def _note_admitted(self, target, session):
        with self._mu:
            self.counts["admitted"] += 1
            eid = target.engine_id
            if eid is not None:
                self.admitted_by_engine[eid] = \
                    self.admitted_by_engine.get(eid, 0) + 1
            if session is not None:
                self._sessions[session] = target.name
        monitor.incr("fleet.admitted")

    def generate(self, prompt, params=None, **kw):
        """Blocking convenience: the full token list (drains the
        failover-spliced stream)."""
        return list(self.stream(prompt, params, **kw))

    def _account_shed(self, rid, hint):
        with self._mu:
            self.counts["shed"] += 1
        monitor.incr("fleet.shed")
        self._emit("shed", request_id=rid, reason="fleet_saturated",
                   retry_after_s=hint if hint is not None else 1.0)

    def _account_rejected(self, rid):
        with self._mu:
            self.counts["rejected"] += 1
        monitor.incr("fleet.rejected")

    # ------------------------------------------------------------------
    # rolling restart
    # ------------------------------------------------------------------
    def rolling_restart(self, restart_fn=None, drain_timeout_s=30.0,
                        budget=None):
        """Drain one replica, wait for quiesce, restart it, re-admit,
        move to the next — the fleet keeps serving throughout because
        routing excludes the draining replica. `restart_fn(replica)`
        overrides the in-place `Replica.restart` (HTTP replicas need
        their supervisor). `budget` bounds how many replicas may be
        restarted (default: all of them, once); the budget is the
        blast-radius cap — a restart that does not come back healthy
        consumes budget WITHOUT re-admitting, so a bad rollout stops
        instead of marching through the whole fleet."""
        budget = len(self._states) if budget is None else int(budget)
        restarted = []
        for name in list(self._states):
            if budget <= 0:
                break
            with self._mu:
                st = self._states[name]
                if st.dead:
                    continue     # nothing to drain; readmit() is explicit
                st.draining = True
            self._update_gauges()
            t0 = self._clock()
            ok = True
            err = None
            try:
                if restart_fn is not None:
                    restart_fn(st.replica)
                else:
                    st.replica.drain(timeout=drain_timeout_s)
                    st.replica.resume_admission()
            except Exception as e:
                ok = False
                err = f"{type(e).__name__}: {e}"
            budget -= 1
            if ok:
                self.readmit(name)
                restarted.append(name)
            else:
                with self._mu:
                    st.draining = False   # not draining — broken
                self._update_gauges()
            with self._mu:
                self.counts["restart"] += 1
            self._emit("restart", replica=name,
                       reason="rolling", error=err,
                       detect_s=self._clock() - t0,
                       healthy=ok)
            monitor.incr("fleet.restarts")
            if not ok:
                break
        return restarted
