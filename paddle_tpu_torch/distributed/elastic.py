"""Elastic training manager and the failure-detect -> replan -> relaunch
coordinator — the port of paddle_tpu/distributed/elastic.py.

Reference analog: `fleet/elastic/manager.py:103` — an etcd3-backed node
registry with scale-in/out vs fault classification
(PADDLE_ELASTIC_FAULT_TOLERANC_LEVEL, `manager.py:118`) and the
ELASTIC_EXIT_CODE=101 relaunch protocol. Two registry backends:

- a shared directory of heartbeat files (a shared mount);
- the TCP KV store (`kvstore.KVClient` -> `csrc/kvstore.cc`), the
  cross-host path matching the reference's etcd store (`manager.py:147`)
  with no shared filesystem.

Recovery is checkpoint-restart: a lost host invalidates the job's
process group, so the manager's job is detection and the relaunch
decision, not in-place repair. `ElasticCoordinator` closes the loop: a
declared-dead protocol over the heartbeats (a missed-heartbeat
threshold, every membership event a `kind=elastic` record), a replan
through the caller's `plan_fn` for the surviving chip count, a final
checkpoint drained through `ResilienceManager.graceful_shutdown`, and
the exit 101 relaunch, after which `ResilienceManager.resume()` reshards
the committed state onto the new layout (`resilience.reshard`).

The JAX coordinator's `model_cfg=` replans through `planner.plan()`;
the planner is not ported yet (ROADMAP Queue 1 item 3), so `model_cfg=`
raises and the replan comes from `plan_fn`.
"""
import json
import os
import time

__all__ = ["ElasticStatus", "ElasticManager", "elastic_run",
           "MembershipEvent", "ElasticCoordinator", "ELASTIC_EXIT_CODE"]

from .launch import ELASTIC_EXIT_CODE  # noqa: F401  (protocol re-export)


class ElasticStatus:
    COMPLETED = "completed"
    ERROR = "error"
    HOLD = "hold"
    RESTART = "restart"
    EXIT = "exit"


class ElasticManager:
    """Register this host in a shared registry; watch membership.

    Backends: `registry_dir` (heartbeat files on a shared mount) or
    `store` (a `kvstore.KVClient` to the job's TCP store — the etcd
    analog, works across hosts with no shared filesystem).

    fault_tolerance_level 0: any change -> EXIT (job-level restart);
    level >= 1: missing host -> RESTART (relaunch protocol), new host ->
    RESTART with the larger world.
    """

    def __init__(self, registry_dir=None, np=None, host_id=None,  # noqa: A002
                 heartbeat_interval=1.0, timeout=5.0,
                 fault_tolerance_level=None, store=None, clock=None,
                 sleep=None, backoff=1.5, max_interval=None):
        if (registry_dir is None) == (store is None):
            raise ValueError("ElasticManager: pass exactly one of "
                             "registry_dir or store")
        self.dir = registry_dir
        self.store = store
        if self.dir is not None:
            os.makedirs(self.dir, exist_ok=True)
        self.np = np or int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        self.host_id = host_id if host_id is not None else \
            os.environ.get("PADDLE_TRAINER_ID", "0")
        self.interval = heartbeat_interval
        self.timeout = timeout
        if fault_tolerance_level is None:
            fault_tolerance_level = int(os.environ.get(
                "PADDLE_ELASTIC_FAULT_TOLERANC_LEVEL", "0"))
        self.level = fault_tolerance_level
        self._stop = False
        # staleness is judged on OUR monotonic clock (see alive_hosts);
        # clock/sleep are injectable so tests pin the schedule exactly
        self._clock = clock or time.monotonic
        self._sleep = sleep or time.sleep
        self.backoff = float(backoff)
        self.max_interval = float(max_interval) if max_interval is not None \
            else max(float(heartbeat_interval), float(timeout) / 2.0)
        self._seen = {}     # host -> (last payload ts, our clock at change)

    # ---- registry ----
    def _path(self, host_id):
        return os.path.join(self.dir, f"host-{host_id}.json")

    def register(self):
        self.heartbeat()
        return self

    def heartbeat(self):
        rec = json.dumps({"host": self.host_id, "ts": time.time(),
                          "np": self.np})
        if self.store is not None:
            self.store.set(f"__elastic__/host-{self.host_id}", rec)
            return
        tmp = self._path(self.host_id) + ".tmp"
        with open(tmp, "w") as f:
            f.write(rec)
        os.replace(tmp, self._path(self.host_id))

    def deregister(self):
        if self.store is not None:
            self.store.delete(f"__elastic__/host-{self.host_id}")
            return
        try:
            os.remove(self._path(self.host_id))
        except FileNotFoundError:
            pass

    def _records(self):
        if self.store is not None:
            # transient coordinator unreachability must classify (stale
            # hosts age out via ts), not crash the watcher — mirror the
            # fs backend's per-record OSError tolerance
            try:
                keys = self.store.list("__elastic__/host-")
            except ConnectionError:
                return
            for key in keys:
                try:
                    raw = self.store.get(key)
                except ConnectionError:
                    continue
                if raw is not None:
                    yield raw
            return
        for name in os.listdir(self.dir):
            if name.startswith("host-") and name.endswith(".json"):
                try:
                    with open(os.path.join(self.dir, name), "rb") as f:
                        yield f.read()
                except OSError:
                    continue

    def alive_hosts(self):
        """Hosts with a fresh heartbeat.

        Staleness is clock-skew-proof: a record's wall-clock `ts` is
        only compared against ITSELF. The first sighting of a (host,
        ts) pair stamps OUR monotonic clock; the host goes stale when
        its payload hasn't CHANGED for `timeout` seconds of our time.
        A peer whose wall clock runs minutes ahead or behind (the
        failure mode of the old `now - ts` check: either permanently
        "stale" or immortally "fresh") is judged exactly like a
        well-synced one."""
        now = self._clock()
        alive = []
        present = set()
        for raw in self._records():
            try:
                rec = json.loads(raw)
            except ValueError:
                continue
            host = str(rec["host"])
            ts = rec.get("ts", 0)
            present.add(host)
            seen = self._seen.get(host)
            if seen is None or seen[0] != ts:
                self._seen[host] = (ts, now)    # fresh payload
                alive.append(host)
            elif now - seen[1] <= self.timeout:
                alive.append(host)
        # a deregistered host must not resurrect with its old ts later
        self._seen = {h: v for h, v in self._seen.items() if h in present}
        return sorted(alive)

    # ---- watch ----
    def check(self):
        """One membership check -> ElasticStatus."""
        alive = self.alive_hosts()
        if len(alive) == self.np:
            return ElasticStatus.HOLD
        if self.level == 0:
            return ElasticStatus.EXIT
        return ElasticStatus.RESTART

    def watch(self, max_checks=None):
        """Heartbeat + check loop; returns the first non-HOLD status.

        Sleeps with multiplicative backoff (interval * backoff^n,
        capped at max_interval <= timeout/2 so our own heartbeat can
        never age past the staleness window) instead of the old tight
        fixed-interval poll — a large idle pod stops hammering the
        registry while still detecting membership changes in bounded
        time."""
        checks = 0
        interval = self.interval
        while not self._stop:
            self.heartbeat()
            status = self.check()
            if status != ElasticStatus.HOLD:
                return status
            checks += 1
            if max_checks is not None and checks >= max_checks:
                return ElasticStatus.HOLD
            self._sleep(interval)
            interval = min(interval * self.backoff, self.max_interval)
        return ElasticStatus.COMPLETED

    def stop(self):
        self._stop = True


def elastic_run(train_fn, manager=None, classify=None):
    """Run train_fn under the elastic exit-code protocol.

    Infra failures (a dead peer's collective timeout, a CUDA or
    backend runtime error, transient storage weather) become
    SystemExit(ELASTIC_EXIT_CODE) so the launcher relaunches
    (reference exit-code contract, `manager.py:26`). PROGRAMMING
    errors — ValueError, TypeError, and friends, as judged by
    `resilience.retry.classify_failure` — re-raise untouched: turning
    a bug into exit 101 puts the job in a relaunch loop that replays
    the identical traceback until the restart cap runs out, which is
    strictly worse than failing loudly once. `classify` overrides the
    classifier (exc -> 'transient'|'permanent'|'infra')."""
    from ..resilience.retry import classify_failure
    classify = classify or classify_failure
    try:
        result = train_fn()
        if manager is not None:
            manager.deregister()
        return result
    except SystemExit:
        raise
    except Exception as e:
        if classify(e) == "permanent":
            raise
        if manager is not None:
            status = manager.check()
            if status == ElasticStatus.EXIT:
                raise
        raise SystemExit(ELASTIC_EXIT_CODE)


# ---------------------------------------------------------------------------
# the failure-detect -> replan -> drain -> relaunch coordinator
# ---------------------------------------------------------------------------

class MembershipEvent:
    """Event vocabulary of the declared-dead protocol — mirrors the
    `kind=elastic` telemetry record vocabulary (telemetry.sink
    ELASTIC_EVENTS), one string per lifecycle transition."""
    HEARTBEAT_MISS = "heartbeat_miss"
    DECLARED_DEAD = "declared_dead"
    REPLAN = "replan"
    RESHARD_RESTORE = "reshard_restore"
    RELAUNCH = "relaunch"


class ElasticCoordinator:
    """Failure detector + replan loop over an ElasticManager.

        em = ElasticManager(registry_dir, np=2, host_id="0", ...)
        coord = ElasticCoordinator(em, plan_fn=lambda n: {"dp": n})
        coord.attach(resilience_manager)      # wires both directions
        ...
        loss = step(x, y)   # resilience.step_boundary polls the
                            # coordinator after every completed step

    Each poll heartbeats and reads membership. A known host missing
    from one poll is a HEARTBEAT_MISS (recorded per miss, per host);
    `miss_threshold` CONSECUTIVE misses declare it dead. A declared
    death (or a new host joining) is a membership change: the
    coordinator calls `plan_fn` for the surviving chip count (a layout
    dict, or anything with `.layout` or `to_dict`), records the REPLAN with both worlds, drains a final
    checkpoint through the attached ResilienceManager's graceful-
    shutdown path, records RELAUNCH, and exits with
    ELASTIC_EXIT_CODE=101 — the launcher relaunches onto the new
    world, where `resume()` reshards the drained checkpoint onto the
    new layout.

    `exit_on_change=False` turns the exit into a return value (the
    chosen next layout) for tests and callers that own the relaunch
    themselves. `clock` is injectable so detector timing is pinned by
    a fake clock in tests. A host missing from the FIRST poll is never
    insta-declared: misses only count once the host has been seen
    alive (or listed in `expected_hosts`). With `model_cfg=` and no
    `plan_fn`, the replan is a real `planner.plan()` search for the
    surviving chip count on `chip` (verify="sharding"), as in JAX.
    """

    def __init__(self, manager, resilience=None, plan_fn=None,
                 model_cfg=None, chip="h100", chips_per_host=1,
                 miss_threshold=3, expected_hosts=None, sink=None,
                 rank=0, clock=None, exit_on_change=True,
                 poll_interval=None):
        if plan_fn is None and model_cfg is not None:
            def plan_fn(n_chips, _cfg=model_cfg, _chip=chip):
                from ..planner import plan as _plan
                return _plan(_cfg, n_chips=n_chips, chip=_chip,
                             verify="sharding")
        self.manager = manager
        self.resilience = resilience
        self.plan_fn = plan_fn
        self.chips_per_host = int(chips_per_host)
        if miss_threshold < 1:
            raise ValueError(
                f"miss_threshold must be >= 1, got {miss_threshold}")
        self.miss_threshold = int(miss_threshold)
        self.rank = int(rank)
        self._clock = clock or time.monotonic
        # registry polls are THROTTLED on the step boundary: a poll is
        # one heartbeat write + a full membership read (O(hosts) on a
        # shared-mount backend), and sub-second train steps must not
        # turn that into a registry hammer. Default: the manager's own
        # heartbeat interval; 0 polls on every call (tests).
        self.poll_interval = float(
            poll_interval if poll_interval is not None
            else getattr(manager, "interval", 1.0))
        self._last_poll = None
        self.exit_on_change = bool(exit_on_change)
        self._known = set(str(h) for h in (expected_hosts or ()))
        self._misses = {}            # host -> consecutive miss count
        self._first_miss = {}        # host -> our clock at first miss
        self._grown = False
        # a detected-but-unhandled membership change LATCHES until a
        # step_boundary consumes it — a caller that polls directly must
        # not swallow the detection
        self._pending_change = False
        self.dead = set()
        self.events = []             # every emitted kind=elastic record
        self.next_layout = None
        from ..telemetry.sink import JsonlSink
        self._owns_sink = isinstance(sink, str)
        self.sink = JsonlSink(sink) if self._owns_sink else sink
        if resilience is not None:
            self.attach(resilience)

    # -- wiring -------------------------------------------------------------
    def attach(self, resilience):
        """Wire a ResilienceManager both ways: the coordinator drains
        final checkpoints through it, and its step_boundary polls the
        coordinator. Shares its telemetry sink when this coordinator
        has none, so the whole elastic sequence lands in ONE ledger."""
        self.resilience = resilience
        resilience.elastic = self
        if self.sink is None:
            self.sink = resilience.ckpt.sink
        return self

    def _emit(self, event, **fields):
        from .. import monitor
        from ..telemetry.sink import emit_record, make_elastic_record
        rec = make_elastic_record(event, rank=self.rank, **fields)
        self.events.append(rec)
        monitor.incr(f"elastic.{event}")
        return emit_record(rec, self.sink)

    # -- detection ----------------------------------------------------------
    def poll(self, step=None):
        """One heartbeat + membership read. Returns the set of hosts
        newly DECLARED dead this poll (usually empty). Misses are
        per-host and consecutive: a host that reappears before the
        threshold resets its count. Calls inside the throttle window
        (`poll_interval`) are no-ops so a fast train loop doesn't
        hammer the registry; detection latency stays bounded by
        timeout + miss_threshold * poll_interval."""
        now = self._clock()
        if self._last_poll is not None and \
                now - self._last_poll < self.poll_interval:
            return set()
        self._last_poll = now
        self.manager.heartbeat()
        alive = set(self.manager.alive_hosts())
        from .. import monitor
        monitor.set_gauge("elastic.alive_hosts", float(len(alive)))
        newly_dead = set()
        for host in sorted(self._known - alive - self.dead):
            n = self._misses.get(host, 0) + 1
            self._misses[host] = n
            self._first_miss.setdefault(host, now)
            self._emit(MembershipEvent.HEARTBEAT_MISS, host=host,
                       step=step, miss_count=n)
            if n >= self.miss_threshold:
                self.dead.add(host)
                newly_dead.add(host)
                self._emit(MembershipEvent.DECLARED_DEAD, host=host,
                           step=step, miss_count=n,
                           detect_s=round(now - self._first_miss[host], 4))
        for host in alive:
            self._misses.pop(host, None)
            self._first_miss.pop(host, None)
        # growth = a NEW host beyond an already-assembled world. Hosts
        # appearing while the pod is still coming up to the manager's
        # expected size (and the first poll's wholesale adoption) are
        # assembly, not a membership change — triggering a replan on
        # them would tear the pod down at step 1.
        expected = int(getattr(self.manager, "np", 1) or 1)
        new_hosts = alive - self._known
        self._grown = bool(new_hosts) and bool(self._known) and \
            len(self._known - self.dead) >= expected
        self._known |= alive
        if newly_dead or self._grown:
            self._pending_change = True
        return newly_dead

    def step_boundary(self, step=None):
        """The per-step hook (called by ResilienceManager.step_boundary
        when attached): poll, and on a completed membership change run
        the replan -> drain -> relaunch protocol."""
        self.poll(step=step)
        if self._pending_change:
            self._pending_change = False
            survivors = sorted(self._known - self.dead)
            return self.on_membership_change(survivors, step=step,
                                             dead=sorted(self.dead))
        return None

    # -- the replan/relaunch protocol ---------------------------------------
    def on_membership_change(self, survivors, step=None, dead=()):
        """Shrink or grow: replan for the surviving chip count, drain a
        final checkpoint, exit ELASTIC_EXIT_CODE (or return the chosen
        layout under exit_on_change=False)."""
        from .. import monitor
        world_from = max(1, len(self._known))   # pre-change world view
        n_chips = max(1, len(survivors) * self.chips_per_host)
        layout_from = None
        if self.resilience is not None:
            layout_from = self.resilience.layout or \
                (self.resilience.state.layout
                 if self.resilience.state else None)
        new_layout = None
        if self.plan_fn is not None:
            plan = self.plan_fn(n_chips)
            chosen = getattr(plan, "layout", plan)
            from ..resilience.reshard import normalize_layout
            new_layout = normalize_layout(chosen)
        self.next_layout = new_layout
        monitor.set_gauge("elastic.world_size", float(len(survivors)))
        self._emit(MembershipEvent.REPLAN, step=step,
                   world_from=world_from, world_to=len(survivors),
                   layout_from=layout_from, layout_to=new_layout,
                   dead_hosts=list(dead) or None)
        self._emit(MembershipEvent.RELAUNCH, step=step,
                   world_to=len(survivors), layout_to=new_layout)
        if self.resilience is not None and self.exit_on_change:
            # drains + commits the final checkpoint (stamped with the
            # OLD layout, which is what routes the relaunched resume
            # through the reshard path), dumps the black box, raises
            # SystemExit(ELASTIC_EXIT_CODE)
            self.resilience.graceful_shutdown(
                reason=f"elastic membership change at step {step}: "
                       f"dead={list(dead)}, survivors={survivors}",
                exit_code=ELASTIC_EXIT_CODE)
        if self.exit_on_change:
            raise SystemExit(ELASTIC_EXIT_CODE)
        return new_layout

    # -- lifecycle ----------------------------------------------------------
    def close(self):
        if self.sink is not None and self._owns_sink:
            self.sink.close()
