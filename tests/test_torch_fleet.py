"""The port's fleet tier (paddle_tpu_torch.fleet), on the CPU.

The port's versions of tests/test_fleet.py's classes (TestHealth,
TestRouting, TestFailover, TestRollingRestart, TestFleetLedger,
TestHTTPReplica, TestHTTPTaxonomy) against the port's router, over the
same scripted `FakeReplica`s, with the port's records checked by the
JAX package's tools/trace_check.py rules. Against the JAX package: the
same prompts and replica names give the same affinity keys, hashes and
routes in both routers; the port's ledger rules
(telemetry/ledger_check.py) agree with trace_check on the same records
and catch both fleet specimens; and a mini drill — two
`InProcessReplica`s over port engines, a mid-stream failure injected at
the same token as in a JAX fleet of two JAX engines on the same weights
— splices streams token-identical to the JAX fleet's and to the JAX
single engine's, in f32, with a ledger both rule sets pass. Every
server listens on port 0; no subprocess is spawned.
"""
import json
import os
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.fleet import FleetRouter as JaxFleetRouter
from paddle_tpu.fleet import InProcessReplica as JaxInProcessReplica
from paddle_tpu.fleet.replica import ReplicaStream as JaxReplicaStream
from paddle_tpu.fleet.router import _fnv1a as _jax_fnv1a
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import ServingEngine as JaxServingEngine

from paddle_tpu_torch import monitor
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.fleet import (FleetRouter, FleetShedError, HTTPReplica,
                                    InProcessReplica, NoHealthyReplicaError,
                                    Replica)
from paddle_tpu_torch.fleet.replica import ReplicaStream, _normalize_params
from paddle_tpu_torch.fleet.router import (BREAKER_CLOSED, BREAKER_HALF_OPEN,
                                           BREAKER_OPEN, _fnv1a)
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
from paddle_tpu_torch.resilience.retry import (HTTPStatusError,
                                               classify_failure,
                                               classify_http_status,
                                               retry_after_hint)
from paddle_tpu_torch.serving import (SamplingParams, ServingEngine,
                                      ServingHTTPServer)
from paddle_tpu_torch.telemetry import ledger_check
from paddle_tpu_torch.telemetry.sink import (FLEET_EVENTS, JsonlSink,
                                             make_fleet_record,
                                             make_serving_record)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


class FakeClock:
    """Injectable monotonic clock: breaker cooldowns and death timing
    are pinned, not slept for."""

    def __init__(self, t=100.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += float(dt)


def _tokens(prompt, max_new):
    """The scripted stream: a pure function of the prompt, so a replay
    on any fake replica provably continues the same stream."""
    base = sum(int(t) for t in prompt) * 31 % 509
    return [(base + 7 * i) % 512 for i in range(max_new)]


class FakeReplica(Replica):
    """Scripted backend: probe health, queue depth, submit-time errors,
    and a mid-stream death are all injectable."""

    def __init__(self, name, engine_id=None, queue_depth=0):
        self.name = str(name)
        self.engine_id = engine_id
        self.queue_depth = queue_depth
        self.down = False               # probe raises (unreachable)
        self.submit_error = None        # raised once at start_stream
        self.die_after = None           # yield N tokens, then raise once
        self.n_tokens_override = None   # lie in stats (proof tests)
        self.calls = []                 # (prompt, request_id, replay)

    def probe(self):
        if self.down:
            raise ConnectionError(f"{self.name} unreachable")
        return {"alive": True, "ready": True, "draining": False,
                "dead": False, "queue_depth": self.queue_depth,
                "running": 0, "kv_blocks_free": 64}

    def start_stream(self, prompt, params=None, request_id=None,
                     replay_tokens=None, priority="normal",
                     deadlines=None, timeout=None):
        if self.submit_error is not None:
            err, self.submit_error = self.submit_error, None
            raise err
        kw = _normalize_params(params)
        max_new = int(kw.get("max_new_tokens", 8))
        full = _tokens(prompt, max_new)
        replay = [int(t) for t in (replay_tokens or [])]
        assert full[:len(replay)] == replay, \
            "replayed tokens are not a prefix of this prompt's stream"
        self.calls.append((list(prompt), request_id, list(replay)))
        stream = ReplicaStream(request_id, None)

        def gen():
            for j in range(len(replay), len(full)):
                if self.die_after is not None and j >= self.die_after:
                    self.die_after = None
                    self.down = True    # a dead process stops answering
                    raise ConnectionError(
                        f"{self.name} died mid-stream")
                yield full[j]
            n = len(full) if self.n_tokens_override is None \
                else self.n_tokens_override
            stream.stats = {"n_tokens": n}
        stream._it = gen()
        return stream

    def drain(self, timeout=None):
        pass

    def resume_admission(self):
        pass


def _router(replicas, **kw):
    base = dict(block_size=8, probe_interval_s=1000.0, miss_threshold=3,
                breaker_cooldown_s=5.0)
    base.update(kw)
    return FleetRouter(replicas, **base)


def _events(router, event):
    with router._mu:
        return [dict(r) for r in router.events if r["event"] == event]


LONG = list(range(10, 22))      # >= one block: affinity applies
SHORT = [1, 2, 3]               # < one block: affinity abstains


# ---------------------------------------------------------------------------
# health: breaker, consecutive-miss death, readmission
# ---------------------------------------------------------------------------

class TestHealth:
    def test_constructor_validation(self):
        with pytest.raises(ValueError, match="at least one replica"):
            FleetRouter([])
        with pytest.raises(ValueError, match="miss_threshold"):
            FleetRouter([FakeReplica("r0")], miss_threshold=0)
        with pytest.raises(ValueError, match="duplicate"):
            FleetRouter([FakeReplica("a"), FakeReplica("a")])

    def test_miss_opens_breaker_cooldown_half_opens_success_recloses(self):
        clk = FakeClock()
        r = FakeReplica("r0")
        router = _router([r], clock=clk, miss_threshold=3,
                         breaker_cooldown_s=5.0)
        r.down = True
        router.probe("r0")
        assert router.replica_states()["r0"]["breaker"] == BREAKER_OPEN
        # open and not cooled down: nothing routable
        with pytest.raises(NoHealthyReplicaError):
            router._pick(LONG)
        r.down = False
        clk.advance(5.0)            # cooldown elapsed: one trial allowed
        target, _ = router._pick(LONG)
        assert target is r
        assert router.replica_states()["r0"]["breaker"] == \
            BREAKER_HALF_OPEN
        router.probe("r0")          # trial succeeded
        st = router.replica_states()["r0"]
        assert st["breaker"] == BREAKER_CLOSED and st["misses"] == 0

    def test_success_resets_consecutive_misses(self):
        clk = FakeClock()
        r = FakeReplica("r0")
        router = _router([r], clock=clk, miss_threshold=3)
        r.down = True
        router.probe("r0")
        router.probe("r0")
        assert router.replica_states()["r0"]["misses"] == 2
        r.down = False
        router.probe("r0")
        assert router.replica_states()["r0"]["misses"] == 0
        r.down = True               # 2 more misses: still below threshold
        router.probe("r0")
        router.probe("r0")
        assert not router.replica_states()["r0"]["dead"]

    def test_threshold_misses_declare_death_with_detect_time(self):
        clk = FakeClock()
        r = FakeReplica("r0")
        router = _router([r], clock=clk, miss_threshold=3)
        before = monitor.get("fleet.deaths", 0)
        r.down = True
        assert router.probe("r0") == set()
        clk.advance(1.0)
        assert router.probe("r0") == set()
        clk.advance(1.5)
        assert router.probe("r0") == {"r0"}
        assert router.replica_states()["r0"]["dead"]
        assert monitor.get("fleet.deaths", 0) == before + 1
        dead = _events(router, "declared_dead")
        assert len(dead) == 1 and dead[0]["miss_count"] == 3
        # detect_s spans first miss -> declaration on the fake clock
        assert dead[0]["detect_s"] == pytest.approx(2.5)
        # probe_all skips the dead; no duplicate declaration
        assert router.probe_all() == set()
        assert len(_events(router, "declared_dead")) == 1

    def test_replica_reporting_dead_counts_as_miss(self):
        r = FakeReplica("r0")
        router = _router([r], clock=FakeClock(), miss_threshold=1)
        orig = r.probe

        def reporting_dead():
            snap = orig()
            snap["dead"] = True
            return snap
        r.probe = reporting_dead
        assert router.probe("r0") == {"r0"}

    def test_declare_dead_external_still_ledgers_a_failed_probe(self):
        sys.path.insert(0, TOOLS)
        import trace_check
        r = FakeReplica("r0")
        router = _router([r], clock=FakeClock())
        router.declare_dead("r0", reason="supervisor killed it")
        with router._mu:
            recs = list(router.events)
        assert trace_check.check_fleet_records(recs, "t") == []
        router.declare_dead("r0")           # idempotent
        assert len(_events(router, "declared_dead")) == 1

    def test_readmit_clears_death_and_breaker(self):
        clk = FakeClock()
        r = FakeReplica("r0")
        router = _router([r], clock=clk, miss_threshold=1)
        r.down = True
        router.probe("r0")
        assert router.replica_states()["r0"]["dead"]
        r.down = False
        router.readmit("r0")
        st = router.replica_states()["r0"]
        assert not st["dead"] and st["breaker"] == BREAKER_CLOSED
        target, _ = router._pick(LONG)
        assert target is r

    def test_a_probe_from_before_a_readmit_is_discarded(self):
        """A probe hung on the replaced process that returns after the
        readmit counts no miss against the new one."""
        clk = FakeClock()
        r = FakeReplica("r0")
        router = _router([r], clock=clk, miss_threshold=1)
        started, release = threading.Event(), threading.Event()
        inner = r.probe

        def hung_probe():
            started.set()
            release.wait(10)
            raise ConnectionError("the old process never answered")

        r.probe = hung_probe
        t = threading.Thread(target=router.probe, args=("r0",))
        t.start()
        assert started.wait(10)
        r.probe = inner                 # the restarted process answers
        router.readmit("r0")
        release.set()
        t.join(10)
        assert not t.is_alive()
        st = router.replica_states()["r0"]
        assert not st["dead"] and st["misses"] == 0
        assert _events(router, "declared_dead") == []
        router.probe("r0")              # a probe after it counts
        r.down = True
        router.probe("r0")
        assert router.replica_states()["r0"]["dead"]

    def test_a_probe_in_flight_is_the_only_one(self):
        """The routing path asks while the prober's slow probe is in
        flight: the second ask is skipped, so a miss cannot land before
        the slow probe's success and leave the replica dead with no
        misses (what two overlapping probes did)."""
        clk = FakeClock()
        r = FakeReplica("r0")
        router = _router([r], clock=clk, miss_threshold=1)
        started, release = threading.Event(), threading.Event()
        inner = r.probe

        def slow_probe():
            snap = inner()              # answered, its reply still coming
            started.set()
            release.wait(10)
            return snap

        r.probe = slow_probe
        t = threading.Thread(target=router.probe, args=("r0",))
        t.start()
        assert started.wait(10)
        r.probe = inner
        r.down = True
        assert router.probe("r0") == set()      # skipped: one in flight
        release.set()
        t.join(10)
        assert not t.is_alive()
        st = router.replica_states()["r0"]
        assert not st["dead"] and st["misses"] == 0
        assert _events(router, "declared_dead") == []
        assert router.probe("r0") == {"r0"}     # the next probe judges

    def test_health_gauges_track_registry(self):
        clk = FakeClock()
        reps = [FakeReplica(f"r{i}") for i in range(3)]
        router = _router(reps, clock=clk, miss_threshold=1)
        router.probe_all()
        assert monitor.get_gauge("fleet.replicas", 0) == 3
        assert monitor.get_gauge("fleet.replicas_healthy", 0) == 3
        reps[1].down = True
        router.probe("r1")
        assert monitor.get_gauge("fleet.replicas_healthy", 0) == 2
        assert monitor.get_gauge("fleet.replicas_dead", 0) == 1


# ---------------------------------------------------------------------------
# routing policy: affinity, stickiness, least-loaded, the fleet door
# ---------------------------------------------------------------------------

class TestRouting:
    def test_affinity_key_is_the_radix_chunk_key(self):
        router = _router([FakeReplica("r0")], clock=FakeClock())
        assert router._affinity_key(SHORT) is None      # < one block
        key = router._affinity_key(LONG)
        assert key == ",".join(str(t) for t in LONG[:8])
        # only the first block matters: shared prefixes share the key
        assert router._affinity_key(LONG[:8] + [499, 500]) == key

    def test_rendezvous_is_stable_across_router_instances(self):
        names = ["r0", "r1", "r2"]
        picks = []
        for _ in range(2):      # two independent routers must agree
            router = _router([FakeReplica(n) for n in names],
                             clock=FakeClock())
            picks.append([router._pick([k + 1] * 12)[0].name
                          for k in range(16)])
        assert picks[0] == picks[1]
        assert len(set(picks[0])) > 1       # keys actually spread

    def test_rendezvous_spread_is_roughly_uniform(self):
        """Replica names differing only in their final byte must still
        split the key space ~evenly (FNV-1a hashed key-last has almost
        no last-byte avalanche and collapses onto ONE replica — the
        router hashes name-first for exactly this reason)."""
        from collections import Counter
        names = ["r0", "r1", "r2"]
        router = _router([FakeReplica(n) for n in names],
                         clock=FakeClock())
        got = Counter(router._pick([k + 1] * 12)[0].name
                      for k in range(300))
        for n in names:                 # ~100 expected per replica
            assert got[n] >= 50, dict(got)

    def test_replica_loss_remaps_only_its_keys(self):
        names = ["r0", "r1", "r2"]
        prompts = [[k + 1] * 12 for k in range(24)]
        router = _router([FakeReplica(n) for n in names],
                         clock=FakeClock(), miss_threshold=1)
        before = [router._pick(p)[0].name for p in prompts]
        router.declare_dead("r1")
        after = [router._pick(p)[0].name for p in prompts]
        for b, a in zip(before, after):
            if b != "r1":
                assert a == b       # survivors keep their keys
            else:
                assert a != "r1"    # the dead one's keys remap

    def test_repeat_prompts_concentrate_and_policy_is_recorded(self):
        reps = [FakeReplica(f"r{i}") for i in range(3)]
        router = _router(reps, clock=FakeClock())
        for _ in range(4):
            assert router.generate(LONG, {"max_new_tokens": 4}) == \
                _tokens(LONG, 4)
        routes = _events(router, "route")
        assert {r["policy"] for r in routes} == {"prefix_affinity"}
        assert len({r["replica"] for r in routes}) == 1

    def test_short_prompt_falls_back_to_least_loaded(self):
        reps = [FakeReplica("r0", queue_depth=5),
                FakeReplica("r1", queue_depth=1),
                FakeReplica("r2", queue_depth=3)]
        router = _router(reps, clock=FakeClock())
        router.probe_all()          # load the queue-depth snapshots
        target, policy = router._pick(SHORT)
        assert (target.name, policy) == ("r1", "least_loaded")

    def test_session_stickiness_overrides_affinity(self):
        reps = [FakeReplica("r0", queue_depth=9),
                FakeReplica("r1", queue_depth=9)]
        router = _router(reps, clock=FakeClock())
        router.probe_all()
        # find a long prompt whose rendezvous winner is r0 ...
        prompt = None
        for k in range(64):
            p = [k + 1] * 12
            if router._pick(p)[0].name == "r0":
                prompt = p
                break
        assert prompt is not None
        # ... then pin the session to r1 via a short prompt
        reps[1].queue_depth = 0
        router.probe("r1")
        router.generate(SHORT, {"max_new_tokens": 2}, session="chat-7")
        assert router.generate(prompt, {"max_new_tokens": 4},
                               session="chat-7") == _tokens(prompt, 4)
        last = _events(router, "route")[-1]
        assert (last["replica"], last["policy"]) == ("r1", "session")
        # without the session the same prompt still goes to r0
        assert router._pick(prompt)[0].name == "r0"

    def test_sticky_replica_death_moves_the_session(self):
        reps = [FakeReplica("r0"), FakeReplica("r1")]
        router = _router(reps, clock=FakeClock(), miss_threshold=1)
        router.generate(SHORT, {"max_new_tokens": 2}, session="s")
        sticky = _events(router, "route")[-1]["replica"]
        router.declare_dead(sticky)
        router.generate(SHORT, {"max_new_tokens": 2}, session="s")
        assert _events(router, "route")[-1]["replica"] != sticky

    def test_fleet_door_sheds_when_every_queue_is_deep(self):
        reps = [FakeReplica(f"r{i}", queue_depth=4) for i in range(2)]
        router = _router(reps, clock=FakeClock(), max_queue_depth=4)
        router.probe_all()
        with pytest.raises(FleetShedError) as e:
            router.generate(LONG, {"max_new_tokens": 4})
        assert e.value.retry_after_s > 0
        assert router.counts["shed"] == 1
        shed = _events(router, "shed")
        assert len(shed) == 1 and shed[0]["retry_after_s"] > 0
        # one replica drains below the mark: the door reopens
        reps[0].queue_depth = 0
        router.probe("r0")
        assert router.generate(LONG, {"max_new_tokens": 4}) == \
            _tokens(LONG, 4)

    def test_no_depth_snapshot_means_no_door_shed(self):
        router = _router([FakeReplica("r0", queue_depth=9)],
                         clock=FakeClock(), max_queue_depth=1)
        # never probed: depth unknown — admission is the engine's call
        assert router._pick(LONG)[0].name == "r0"

    def test_all_dead_raises_no_healthy_and_counts_shed(self):
        router = _router([FakeReplica("r0")], clock=FakeClock(),
                         miss_threshold=1)
        router.declare_dead("r0")
        with pytest.raises(NoHealthyReplicaError):
            router.generate(LONG, {"max_new_tokens": 4})
        assert router.counts["shed"] == 1
        assert router.counts["requests"] == 1

    def test_unseeded_sampling_gets_a_stamped_seed(self):
        r = FakeReplica("r0")
        router = _router([r], clock=FakeClock(), seed_base=77)
        list(router.stream(LONG, {"max_new_tokens": 2,
                                  "decode_strategy": "sampling",
                                  "top_k": 4}))
        # the replica saw a concrete seed, not None (a replay on
        # another replica could not reproduce an unseeded draw)
        assert len(r.calls) == 1


# ---------------------------------------------------------------------------
# failover replay + the splice proof
# ---------------------------------------------------------------------------

class TestFailover:
    def test_midstream_death_splices_token_identical_stream(self):
        a, b = FakeReplica("r0", engine_id=0), \
            FakeReplica("r1", engine_id=1)
        router = _router([a, b], clock=FakeClock(), miss_threshold=1)
        # make BOTH orderings deterministic: whoever wins affinity dies
        winner = router._pick(LONG)[0]
        winner.die_after = 3
        before_f = monitor.get("fleet.failovers", 0)
        got = router.generate(LONG, {"max_new_tokens": 8},
                              request_id="fo-1")
        assert got == _tokens(LONG, 8)      # identical to uninterrupted
        assert monitor.get("fleet.failovers", 0) == before_f + 1
        assert router.counts["failover"] == 1
        assert router.counts["spliced"] == 1
        fo = _events(router, "failover")
        assert len(fo) == 1
        assert fo[0]["replica"] == winner.name
        assert fo[0]["streamed_before"] == 3
        assert fo[0]["reason"] == "declared_dead"   # miss_threshold=1
        sp = _events(router, "replay_spliced")[0]
        assert (sp["streamed_before"], sp["streamed_after"],
                sp["n_tokens"]) == (3, 5, 8)
        # the survivor was handed exactly the streamed tokens to replay
        other = b if winner is a else a
        assert other.calls[-1][2] == _tokens(LONG, 8)[:3]

    def test_splice_proof_failure_raises(self):
        a, b = FakeReplica("r0"), FakeReplica("r1")
        router = _router([a, b], clock=FakeClock(), miss_threshold=1)
        winner = router._pick(LONG)[0]
        other = b if winner is a else a
        winner.die_after = 2
        other.n_tokens_override = 7         # engine ledger disagrees
        with pytest.raises(RuntimeError,
                           match="spliced stream accounting broken"):
            router.generate(LONG, {"max_new_tokens": 8})

    def test_zero_token_failover_replays_nothing(self):
        a, b = FakeReplica("r0"), FakeReplica("r1")
        router = _router([a, b], clock=FakeClock(), miss_threshold=1)
        winner = router._pick(LONG)[0]
        winner.die_after = 0                # admitted, died before tok 1
        assert router.generate(LONG, {"max_new_tokens": 6}) == \
            _tokens(LONG, 6)
        fo = _events(router, "failover")[0]
        assert fo["streamed_before"] == 0
        other = b if winner is a else a
        assert other.calls[-1][2] == []     # replay_tokens omitted
        # the splice record still balances, trivially: 0 + n == n
        sp = _events(router, "replay_spliced")[0]
        assert (sp["streamed_before"], sp["streamed_after"]) == (0, 6)

    def test_submit_time_shed_reroutes_without_failover(self):
        a, b = FakeReplica("r0"), FakeReplica("r1")
        router = _router([a, b], clock=FakeClock())
        winner = router._pick(LONG)[0]
        winner.submit_error = HTTPStatusError(
            "shed", 429, retry_after_s=1.0)
        assert router.generate(LONG, {"max_new_tokens": 4}) == \
            _tokens(LONG, 4)
        assert router.counts["failover"] == 0       # a re-route, not a
        assert _events(router, "failover") == []    # failover
        assert router.counts["admitted"] == 1
        # a shed is not a probe miss: the breaker stays closed
        assert router.replica_states()[winner.name]["breaker"] == \
            BREAKER_CLOSED

    def test_permanent_error_rejects_without_retry(self):
        a, b = FakeReplica("r0"), FakeReplica("r1")
        router = _router([a, b], clock=FakeClock())
        winner = router._pick(LONG)[0]
        other = b if winner is a else a
        winner.submit_error = HTTPStatusError("malformed", 400)
        with pytest.raises(HTTPStatusError):
            router.generate(LONG, {"max_new_tokens": 4})
        assert other.calls == []        # no other replica was bothered
        assert router.counts["rejected"] == 1
        assert router.counts["admitted"] == 0

    def test_failover_budget_bounds_the_death_march(self):
        reps = [FakeReplica(f"r{i}") for i in range(3)]
        for r in reps:
            r.die_after = 1         # every replica dies once admitted
        router = _router(reps, clock=FakeClock(), miss_threshold=1,
                         failover_budget=2)
        with pytest.raises(ConnectionError):
            router.generate(LONG, {"max_new_tokens": 8})

    def test_quiesce_identity_balances_after_mixed_traffic(self):
        sys.path.insert(0, TOOLS)
        import trace_check
        a, b = FakeReplica("r0", engine_id=10), \
            FakeReplica("r1", engine_id=11)
        router = _router([a, b], clock=FakeClock(), miss_threshold=1,
                         max_queue_depth=50)
        for i in range(3):                              # 3 clean
            router.generate(LONG[:8] + [i] * 4, {"max_new_tokens": 4})
        winner = router._pick(LONG)[0]
        winner.die_after = 2                            # 1 failover
        router.generate(LONG, {"max_new_tokens": 6})
        router.readmit(winner.name)
        winner.down = False
        a.queue_depth = b.queue_depth = 99              # 1 door shed
        router.probe_all()
        with pytest.raises(FleetShedError):
            router.generate(LONG, {"max_new_tokens": 4})
        a.queue_depth = b.queue_depth = 0
        router.probe_all()
        target = router._pick(SHORT)[0]                 # 1 rejection
        target.submit_error = HTTPStatusError("bad", 422)
        with pytest.raises(HTTPStatusError):
            router.generate(SHORT, {"max_new_tokens": 4})
        rec = router.emit_quiesce()
        c = rec["counts"]
        assert c["requests"] == 6
        assert c["requests"] == (c["admitted"] - c["failover"]) \
            + c["shed"] + c["rejected"]
        # per-engine admissions are ledgered under the engine's own id
        assert sum(rec["admitted_by_engine"].values()) == c["admitted"]
        with router._mu:
            recs = list(router.events)
        assert trace_check.check_fleet_records(recs, "t") == []


# ---------------------------------------------------------------------------
# rolling restart
# ---------------------------------------------------------------------------

class TestRollingRestart:
    def test_restart_fn_marches_the_whole_fleet(self):
        reps = [FakeReplica(f"r{i}") for i in range(3)]
        router = _router(reps, clock=FakeClock())
        seen = []
        routed_during = []

        def restart_fn(replica):
            # mid-restart the draining replica must be unroutable
            routed_during.append(router._pick(LONG)[0].name)
            seen.append(replica.name)
        restarted = router.rolling_restart(restart_fn=restart_fn)
        assert restarted == seen == [r.name for r in reps]
        assert all(routed_during[i] != seen[i] for i in range(3))
        assert router.counts["restart"] == 3
        assert all(not st["draining"]
                   for st in router.replica_states().values())
        recs = _events(router, "restart")
        assert [r["healthy"] for r in recs] == [True] * 3

    def test_budget_caps_the_blast_radius(self):
        reps = [FakeReplica(f"r{i}") for i in range(3)]
        router = _router(reps, clock=FakeClock())
        restarted = router.rolling_restart(restart_fn=lambda r: None,
                                           budget=1)
        assert len(restarted) == 1

    def test_failed_restart_stops_the_march(self):
        reps = [FakeReplica(f"r{i}") for i in range(3)]
        router = _router(reps, clock=FakeClock())

        def restart_fn(replica):
            if replica.name == "r1":
                raise RuntimeError("new binary segfaults on boot")
        restarted = router.rolling_restart(restart_fn=restart_fn)
        assert restarted == ["r0"]      # r1 failed, r2 never touched
        recs = _events(router, "restart")
        assert len(recs) == 2 and recs[-1]["healthy"] is False
        assert "segfault" in recs[-1]["error"]

    def test_dead_replicas_are_skipped(self):
        reps = [FakeReplica("r0"), FakeReplica("r1")]
        router = _router(reps, clock=FakeClock(), miss_threshold=1)
        router.declare_dead("r0")
        restarted = router.rolling_restart(restart_fn=lambda r: None)
        assert restarted == ["r1"]


# ---------------------------------------------------------------------------
# telemetry: record schema + trace_check cross-rules, both ways
# ---------------------------------------------------------------------------

class TestFleetLedger:
    def test_make_fleet_record_validates_event(self):
        with pytest.raises(ValueError, match="fleet event"):
            make_fleet_record("rebooted")
        rec = make_fleet_record("probe", replica="r0", healthy=True,
                                queue_depth=2)
        assert rec["kind"] == "fleet" and rec["event"] == "probe"
        assert rec["queue_depth"] == 2
        assert set(FLEET_EVENTS) >= {"route", "probe", "declared_dead",
                                     "failover", "replay_spliced",
                                     "restart", "shed", "quiesce"}

    def _check(self, recs):
        """The JAX rules' verdict, which the port's copy must repeat."""
        sys.path.insert(0, TOOLS)
        import trace_check
        problems = trace_check.check_fleet_records(recs, "t")
        assert ledger_check.check_fleet_records(recs, "t") == problems
        return problems

    def test_death_without_failed_probe_is_flagged(self):
        ok = [make_fleet_record("probe", replica="r0", healthy=False,
                                miss_count=1, breaker=BREAKER_OPEN),
              make_fleet_record("declared_dead", replica="r0",
                                miss_count=1)]
        assert self._check(ok) == []
        bad = [make_fleet_record("declared_dead", replica="r0",
                                 miss_count=3)]
        assert any("never witnessed" in p for p in self._check(bad))

    def test_failover_needs_a_death_or_an_error(self):
        base = [make_fleet_record("probe", replica="r0", healthy=False,
                                  miss_count=3),
                make_fleet_record("declared_dead", replica="r0",
                                  miss_count=3)]
        ok = base + [make_fleet_record("failover", replica="r0",
                                       to_replica="r1",
                                       request_id="q")]
        assert self._check(ok) == []
        ok_err = [make_fleet_record("failover", replica="r2",
                                    to_replica="r1", request_id="q",
                                    error="ConnectionError: reset")]
        assert self._check(ok_err) == []
        bad = [make_fleet_record("failover", replica="r2",
                                 to_replica="r1", request_id="q")]
        assert any("re-route wearing a failover's name" in p
                   for p in self._check(bad))

    def test_splice_arithmetic_and_orphan_splice(self):
        fo = make_fleet_record("failover", replica="r0",
                               to_replica="r1", request_id="q",
                               error="x")
        ok = [fo, make_fleet_record("replay_spliced", replica="r1",
                                    request_id="q", streamed_before=3,
                                    streamed_after=5, n_tokens=8)]
        assert self._check(ok) == []
        bad_sum = [fo, make_fleet_record(
            "replay_spliced", replica="r1", request_id="q",
            streamed_before=3, streamed_after=5, n_tokens=9)]
        assert any("accounting broken" in p
                   for p in self._check(bad_sum))
        orphan = [make_fleet_record("replay_spliced", replica="r1",
                                    request_id="zz", streamed_before=1,
                                    streamed_after=1, n_tokens=2)]
        assert any("no preceding failover" in p
                   for p in self._check(orphan))

    def test_quiesce_balance_rule(self):
        ok = [make_fleet_record(
            "quiesce", counts={"requests": 6, "admitted": 5,
                               "failover": 1, "shed": 1, "rejected": 1,
                               "spliced": 1, "restart": 0})]
        assert self._check(ok) == []
        bad = [make_fleet_record(
            "quiesce", counts={"requests": 7, "admitted": 5,
                               "failover": 1, "shed": 1,
                               "rejected": 1})]
        assert any("don't balance" in p for p in self._check(bad))

    def test_admitted_by_engine_must_match_serving_quiesce(self):
        serving = make_serving_record(
            "quiesce", engine=3, kv_blocks_used=0,
            counts={"admitted": 4, "finished": 4, "failed": 0,
                    "cancelled": 0, "expired": 0})
        fleet_q = make_fleet_record(
            "quiesce", counts={"requests": 4, "admitted": 4,
                               "failover": 0, "shed": 0, "rejected": 0},
            admitted_by_engine={"3": 4})
        assert self._check([serving, fleet_q]) == []
        serving_off = make_serving_record(
            "quiesce", engine=3, kv_blocks_used=0,
            counts={"admitted": 5, "finished": 5, "failed": 0,
                    "cancelled": 0, "expired": 0})
        assert any("disagree" in p
                   for p in self._check([serving_off, fleet_q]))
        # a SIGKILLed incarnation never quiesces: absent engine is exempt
        fleet_q2 = make_fleet_record(
            "quiesce", counts={"requests": 4, "admitted": 4,
                               "failover": 0, "shed": 0, "rejected": 0},
            admitted_by_engine={"3": 4, "99": 1})
        assert self._check([serving, fleet_q2]) == []

    def test_failover_rid_needs_two_admissions_one_replayed(self):
        fo = make_fleet_record("failover", replica="r0",
                               to_replica="r1", request_id="q",
                               error="x", streamed_before=3)
        adm = [make_serving_record("admitted", rid=1, engine=0,
                                   request_id="q"),
               make_serving_record("admitted", rid=1, engine=1,
                                   request_id="q", replayed=3)]
        assert self._check(adm + [fo]) == []
        assert any("same request_id" in p
                   for p in self._check(adm[:1] + [fo]))
        # no replayed marker on the second admission: also flagged ...
        unreplayed = [adm[0],
                      make_serving_record("admitted", rid=1, engine=1,
                                          request_id="q")]
        assert any("same request_id" in p
                   for p in self._check(unreplayed + [fo]))
        # ... unless nothing had streamed (zero-token failover)
        fo0 = make_fleet_record("failover", replica="r0",
                                to_replica="r1", request_id="q",
                                error="x", streamed_before=0)
        assert self._check(unreplayed + [fo0]) == []

    def test_router_ledger_roundtrips_through_a_jsonl_sink(self, tmp_path):
        sys.path.insert(0, TOOLS)
        import trace_check
        path = str(tmp_path / "fleet.jsonl")
        sink = JsonlSink(path)
        a, b = FakeReplica("r0", engine_id=0), \
            FakeReplica("r1", engine_id=1)
        router = _router([a, b], clock=FakeClock(), miss_threshold=1,
                         sink=sink)
        winner = router._pick(LONG)[0]
        winner.die_after = 2
        assert router.generate(LONG, {"max_new_tokens": 8}) == \
            _tokens(LONG, 8)
        router.emit_quiesce()
        sink.close()
        recs = [json.loads(l) for l in open(path)]
        assert trace_check.check_fleet_records(recs, path) == []
        assert ledger_check.check_jsonl(path)[1] == []
        assert trace_check.check_pair(path)[0] == []
        events = [r["event"] for r in recs]
        for needed in ("route", "probe", "declared_dead", "failover",
                       "replay_spliced", "quiesce"):
            assert needed in events, needed

    def test_drill_specimens_are_caught(self):
        sys.path.insert(0, TOOLS)
        import trace_check
        no_death = os.path.join(TOOLS, "specimens",
                                "fleet_failover_no_death.jsonl")
        splice = os.path.join(TOOLS, "specimens",
                              "fleet_splice_mismatch.jsonl")
        problems, _ = trace_check.check_pair(no_death)
        assert any("neither declared dead" in p for p in problems)
        assert ledger_check.check_jsonl(no_death)[1] == problems
        problems, _ = trace_check.check_pair(splice)
        assert any("accounting broken" in p for p in problems)
        assert ledger_check.check_jsonl(splice)[1] == problems

    def test_record_schema_agrees_with_the_jax_validator(self):
        from paddle_tpu.telemetry.sink import validate_step_record
        recs = [make_fleet_record("declared_dead", replica="r0",
                                  miss_count=1),
                dict(make_fleet_record("declared_dead", replica="r0",
                                       miss_count=1), miss_count=0),
                dict(make_fleet_record("failover", replica="r0",
                                       to_replica="r1"), to_replica=""),
                dict(make_fleet_record("replay_spliced", replica="r1"),
                     n_tokens=-1),
                dict(make_fleet_record("quiesce"), counts=None),
                dict(make_fleet_record("probe", replica="r0"),
                     event="rebooted"),
                make_fleet_record("route", request_id="q")]
        for rec in recs:
            assert ledger_check.validate_record(rec) == \
                validate_step_record(rec), rec


# ---------------------------------------------------------------------------
# HTTP replica: error taxonomy over the wire
# ---------------------------------------------------------------------------

class _StubFront:
    """A scripted serving/http.py stand-in: /healthz answers draining,
    /generate answers by the first prompt token — 1: 429+Retry-After,
    2: a clean 2-token stream, 3: a mid-stream deadline error event."""

    def __enter__(self):
        import http.server

        class H(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, status, body, headers=()):
                payload = body.encode()
                self.send_response(status)
                for k, v in headers:
                    self.send_header(k, v)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                self._send(503, json.dumps(
                    {"status": "draining",
                     "serving": {"serving.queue_depth": 3,
                                 "serving.running": 1}}))

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                first = (body.get("prompt") or [0])[0]
                if first == 1:
                    self._send(429, json.dumps({"error": "shed"}),
                               headers=[("Retry-After", "2.5")])
                elif first == 2:
                    lines = [{"token": 7, "request_id": "rq"},
                             {"token": 9},
                             {"done": True, "stats": {"n_tokens": 2},
                              "request_id": "rq"}]
                    self._send(200, "".join(
                        json.dumps(l) + "\n" for l in lines))
                else:
                    lines = [{"token": 7},
                             {"error": "too slow",
                              "status": "deadline_exceeded"}]
                    self._send(200, "".join(
                        json.dumps(l) + "\n" for l in lines))
        self.srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=self.srv.serve_forever,
                         daemon=True).start()
        return f"http://127.0.0.1:{self.srv.server_address[1]}"

    def __exit__(self, *a):
        self.srv.shutdown()
        self.srv.server_close()


class TestHTTPReplica:
    def test_probe_reads_the_healthz_split(self):
        with _StubFront() as url:
            rep = HTTPReplica("h0", url)
            snap = rep.probe()
        assert snap["alive"] and not snap["ready"]
        assert snap["draining"] and not snap["dead"]
        assert snap["queue_depth"] == 3 and snap["running"] == 1

    def test_shed_carries_status_and_retry_after(self):
        with _StubFront() as url:
            rep = HTTPReplica("h0", url)
            with pytest.raises(HTTPStatusError) as e:
                rep.start_stream([1, 2, 3], {"max_new_tokens": 4})
        assert e.value.http_status == 429
        assert retry_after_hint(e.value) == 2.5
        assert classify_failure(e.value) == "transient"

    def test_stream_tokens_stats_and_request_id(self):
        with _StubFront() as url:
            rep = HTTPReplica("h0", url)
            rs = rep.start_stream([2, 2, 2], {"max_new_tokens": 4})
            toks = list(rs)
        assert toks == [7, 9]
        assert rs.stats == {"n_tokens": 2}
        assert rs.request_id == "rq"

    def test_midstream_error_event_maps_to_status(self):
        with _StubFront() as url:
            rep = HTTPReplica("h0", url)
            rs = rep.start_stream([3, 2, 2], {"max_new_tokens": 4})
            it = iter(rs)
            assert next(it) == 7
            with pytest.raises(HTTPStatusError) as e:
                next(it)
        assert e.value.http_status == 504
        assert classify_failure(e.value) == "transient"

    def test_unreachable_probe_raises_the_miss_signal(self):
        rep = HTTPReplica("h0", "http://127.0.0.1:9",  # discard port
                          connect_timeout=0.2)
        with pytest.raises((ConnectionError, OSError)):
            rep.probe()

    def test_supervisor_owns_drain(self):
        rep = HTTPReplica("h0", "http://127.0.0.1:9")
        with pytest.raises(NotImplementedError, match="supervisor"):
            rep.drain()
        with pytest.raises(NotImplementedError, match="supervisor"):
            rep.resume_admission()


# ---------------------------------------------------------------------------
# retry taxonomy the router routes by
# ---------------------------------------------------------------------------

class TestHTTPTaxonomy:
    def test_transient_statuses_are_the_serving_refusals(self):
        assert classify_http_status(429) == "transient"   # shed
        assert classify_http_status(503) == "transient"   # draining
        assert classify_http_status(504) == "transient"   # deadline
        assert classify_http_status(400) == "permanent"
        assert classify_http_status(404) == "permanent"
        assert classify_http_status(422) == "permanent"
        assert classify_http_status(500) == "infra"
        assert classify_http_status(502) == "infra"

    def test_classify_failure_reads_http_status(self):
        assert classify_failure(HTTPStatusError("x", 429)) == "transient"
        assert classify_failure(HTTPStatusError("x", 400)) == "permanent"
        assert classify_failure(HTTPStatusError("x", 500)) == "infra"
        assert classify_failure(ConnectionError("x")) == "transient"

    def test_retry_after_hint_parsing(self):
        assert retry_after_hint(
            HTTPStatusError("x", 429, retry_after_s=3.0)) == 3.0
        assert retry_after_hint(HTTPStatusError("x", 429)) is None

        class Weird:
            retry_after_s = "soon"
        assert retry_after_hint(Weird()) is None

        class Negative:
            retry_after_s = -1.0
        assert retry_after_hint(Negative()) is None




# ---------------------------------------------------------------------------
# against the JAX router: the same prompts and names route the same way
# ---------------------------------------------------------------------------

def _serve_like_prompts(n=48, seed=0):
    """Prompts of 3..40 tokens, a third sharing a 16-token prefix."""
    rs = np.random.RandomState(seed)
    shared = rs.randint(0, 50304, (16,)).tolist()
    return [(shared if i % 3 == 0 else []) +
            rs.randint(0, 50304, (3 + i % 25,)).tolist() for i in range(n)]


@pytest.mark.parametrize("names", [["r0", "r1", "r2"],
                                   ["127.0.0.1:8001", "127.0.0.1:8002"],
                                   ["a", "b", "c", "d", "e"]])
def test_routes_equal_the_jax_routers(names):
    prompts = _serve_like_prompts()
    routers = [cls([FakeReplica(n) for n in names], block_size=16,
                   probe_interval_s=1000.0, clock=FakeClock())
               for cls in (FleetRouter, JaxFleetRouter)]
    for r in routers:
        r.declare_dead(names[-1])       # one replica gone: keys remap
        r.readmit(names[-1])
    for p in prompts:
        keys = [r._affinity_key(p) for r in routers]
        assert keys[0] == keys[1]
        if keys[0] is not None:
            assert _fnv1a(keys[0]) == _jax_fnv1a(keys[1])
        picks = [(t.name, pol) for t, pol in (r._pick(p) for r in routers)]
        assert picks[0] == picks[1]
    assert len({routers[0]._pick(p)[0].name for p in prompts
                if len(p) >= 16}) > 1
    for r in routers:
        r.declare_dead(names[0])
    assert [routers[0]._pick(p)[0].name for p in prompts] == \
        [routers[1]._pick(p)[0].name for p in prompts]


def test_session_and_least_loaded_equal_the_jax_routers():
    out = []
    for cls in (FleetRouter, JaxFleetRouter):
        reps = [FakeReplica("r0", queue_depth=5),
                FakeReplica("r1", queue_depth=1),
                FakeReplica("r2", queue_depth=3)]
        router = cls(reps, block_size=8, probe_interval_s=1000.0,
                     clock=FakeClock(), seed_base=11)
        router.probe_all()
        toks = router.generate(SHORT, {"max_new_tokens": 3}, session="s")
        toks2 = router.generate(LONG, {"max_new_tokens": 3,
                                       "decode_strategy": "sampling"},
                                session="s")
        with router._mu:
            routes = [(e["replica"], e["policy"]) for e in router.events
                      if e["event"] == "route"]
        out.append((toks, toks2, routes, dict(router.counts)))
    assert out[0] == out[1]
    assert out[0][2] == [("r1", "least_loaded"), ("r1", "session")]


# ---------------------------------------------------------------------------
# real port engines: an HTTP replica over the port's front, and the mini
# drill held against the JAX fleet and the JAX single engine
# ---------------------------------------------------------------------------

_MODEL = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
              max_seq_len=128, dropout=0.0, initializer_range=0.2)
_ENGINE = dict(max_slots=4, block_size=8, prefill_chunk=8,
               max_model_len=64)
_WAIT_S = 60


@pytest.fixture(scope="module")
def models():
    paddle.seed(3)
    jms = [JaxGPT(JaxGPTConfig(use_flash_attention=False, **_MODEL))
           for _ in range(3)]           # one model per JAX engine
    for jm in jms[1:]:
        for (_, src), (_, dst) in zip(jms[0].named_parameters(),
                                      jm.named_parameters()):
            dst._value = src._value
    tm = GPTForPretraining(GPTConfig(**_MODEL), device="cpu")
    load_jax_params(tm, [(n, np.asarray(p._value))
                         for n, p in jms[0].named_parameters()])
    return jms, tm


def _mini_prompts():
    rs = np.random.RandomState(3)
    return [rs.randint(0, 512, (10 + i,)).tolist() for i in range(4)]


def test_http_replica_over_the_ports_front(models):
    _, tm = models
    eng = ServingEngine(tm, device="cpu", dtype=None, engine_id=901,
                        **_ENGINE)
    with eng, ServingHTTPServer(eng, port=0) as srv:
        rep = HTTPReplica("h0", srv.url, engine_id=901)
        snap = rep.probe()
        assert snap["ready"] and not snap["draining"] and not snap["dead"]
        rs = rep.start_stream([1, 2, 3, 4], {"max_new_tokens": 5},
                              request_id="hr-1")
        toks = list(rs)
        assert rs.request_id == "hr-1"
        assert rs.stats["n_tokens"] == 5 and len(toks) == 5
        # a replay: the stream continues where the replayed tokens stop
        rs2 = rep.start_stream([1, 2, 3, 4], {"max_new_tokens": 5},
                               request_id="hr-2", replay_tokens=toks[:2])
        assert list(rs2) == toks[2:]
        assert rs2.stats["n_tokens"] == 5
        eng.drain(timeout=_WAIT_S)
        assert rep.probe()["draining"]
        with pytest.raises(HTTPStatusError) as e:
            rep.start_stream([1, 2], {"max_new_tokens": 2})
        assert e.value.http_status == 503
        assert classify_failure(e.value) == "transient"


def _dying(base, stream_cls, armed):
    """A replica class whose first stream to reach 3 tokens dies once,
    fleet-wide (the drill's injected mid-stream failure)."""

    class Dying(base):
        def start_stream(self, *a, **kw):
            inner = super().start_stream(*a, **kw)
            stream = stream_cls(inner.request_id, None)

            def gen():
                n = 0
                for tok in inner:
                    yield tok
                    n += 1
                    if armed["on"] and n >= 3:
                        armed["on"] = False
                        raise ConnectionError(
                            "injected mid-stream replica failure")
                stream.stats = inner.stats
            stream._it = gen()
            return stream
    return Dying


def _mini_fleet(router_cls, replica_cls, stream_cls, engines, sink):
    armed = {"on": True}
    dying = _dying(replica_cls, stream_cls, armed)
    router = router_cls([dying(f"m{i}", e) for i, e in enumerate(engines)],
                        block_size=8, probe_interval_s=0.0,
                        miss_threshold=3, sink=sink)
    outs = [router.generate(p, {"max_new_tokens": 10},
                            request_id=f"mini-{i}")
            for i, p in enumerate(_mini_prompts())]
    for e in engines:
        e.drain(timeout=_WAIT_S)
    router.emit_quiesce()
    with router._mu:
        events = list(router.events)
    return outs, events


def test_mini_drill_splices_streams_identical_to_jax(models, tmp_path):
    jms, tm = models
    # the JAX single engine, uninterrupted
    ref_eng = JaxServingEngine(jms[2], max_slots=4, block_size=8,
                               prefill_chunk=8, max_model_len=64,
                               dtype=None)
    hs = [ref_eng.submit(p, JaxSamplingParams(max_new_tokens=10))
          for p in _mini_prompts()]
    ref_eng.run_until_idle(max_steps=5000)
    refs = [h.output_tokens for h in hs]
    # the JAX fleet: two JAX engines, one fails mid-stream at token 3
    jax_engines = [JaxServingEngine(jms[i], max_slots=4, block_size=8,
                                    prefill_chunk=8, max_model_len=64,
                                    dtype=None, engine_id=200 + i,
                                    enable_tracing=False).start()
                   for i in range(2)]
    try:
        jax_outs, jax_events = _mini_fleet(
            JaxFleetRouter, JaxInProcessReplica, JaxReplicaStream,
            jax_engines, None)
    finally:
        for e in jax_engines:
            e.stop()
    # the port's fleet, the same failure at the same token
    path = str(tmp_path / "mini.jsonl")
    sink = JsonlSink(path)
    engines = [ServingEngine(tm, device="cpu", dtype=None,
                             engine_id=100 + i, sink=sink,
                             enable_tracing=False, **_ENGINE).start()
               for i in range(2)]
    try:
        outs, events = _mini_fleet(FleetRouter, InProcessReplica,
                                   ReplicaStream, engines, sink)
    finally:
        for e in engines:
            e.stop()
        sink.close()
    assert outs == jax_outs == refs
    spliced = [(e["request_id"], e["streamed_before"], e["streamed_after"])
               for e in events if e["event"] == "replay_spliced"]
    assert spliced == [(e["request_id"], e["streamed_before"],
                        e["streamed_after"])
                       for e in jax_events if e["event"] == "replay_spliced"]
    assert spliced and spliced[0][1] == 3
    assert [e["event"] for e in events] == [e["event"] for e in jax_events]
    # the port's ledger (both engines' serving records + the router's)
    # passes the JAX rules and the port's copy
    sys.path.insert(0, TOOLS)
    import trace_check
    recs = [json.loads(line) for line in open(path)]
    assert trace_check.check_fleet_records(recs, path) == []
    problems, stats = trace_check.check_pair(path)
    assert problems == [] and stats["n_fleet"] > 0
    assert ledger_check.check_jsonl(path)[1] == []
    q = [r for r in recs if r.get("kind") == "fleet"
         and r["event"] == "quiesce"][-1]
    assert sum(q["admitted_by_engine"].values()) == q["counts"]["admitted"]


def test_inprocess_replica_probe_matches_engine_internals(models):
    _, tm = models
    eng = ServingEngine(tm, device="cpu", dtype=None, engine_id=501,
                        **_ENGINE).start()
    try:
        rep = InProcessReplica("e0", eng)
        assert rep.engine_id == 501
        snap = rep.probe()
        assert snap["ready"] and not snap["draining"]
        assert snap["queue_depth"] == 0 and snap["running"] == 0
        assert snap["kv_blocks_free"] == eng.pool.num_free > 0
        eng.drain(timeout=_WAIT_S)
        assert rep.probe()["draining"] and not rep.probe()["ready"]
    finally:
        eng.stop()


def test_fleet_http_front_streams_and_sheds(models):
    from paddle_tpu_torch.fleet import FleetHTTPServer
    reps = [FakeReplica("r0", queue_depth=0), FakeReplica("r1")]
    router = FleetRouter(reps, block_size=8, probe_interval_s=1000.0,
                         max_queue_depth=4)
    with FleetHTTPServer(router, port=0) as front:
        body = json.dumps({"prompt": LONG, "max_new_tokens": 6,
                           "stream": True, "session": "s1"}).encode()
        req = urllib.request.Request(
            front.url + "/generate", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=_WAIT_S) as r:
            lines = [json.loads(line) for line in r]
        assert [ln["token"] for ln in lines[:-1]] == _tokens(LONG, 6)
        assert lines[-1] == {"done": True, "tokens": _tokens(LONG, 6)}
        with urllib.request.urlopen(front.url + "/healthz",
                                    timeout=_WAIT_S) as r:
            assert sorted(json.loads(r.read())["routable"]) == ["r0", "r1"]
        with urllib.request.urlopen(front.url + "/metrics",
                                    timeout=_WAIT_S) as r:
            assert b"paddle_tpu_fleet_replicas_healthy" in r.read()
        for rep in reps:
            rep.queue_depth = 9
        router.probe_all()
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=_WAIT_S)
        assert e.value.code == 429
        assert int(e.value.headers["Retry-After"]) >= 1
