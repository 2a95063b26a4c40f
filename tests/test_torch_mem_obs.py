"""The port's memory observatory (paddle_tpu_torch.telemetry.mem_obs and
the serving engine's hooks), on the CPU in f32.

The port's versions of tests/test_mem_obs.py's cases where they apply:
the provider registry (weakref owners, broken providers), `is_oom` on
torch's exception types, the snapshot record, its headroom and a budget
of none, the postmortem's fields, the engine's ledger, headroom shed
(also as HTTP 429 + Retry-After) and OOM postmortem written before the
arena rebuild. Against the JAX package: the port's memsnap records pass
tools/trace_check.py's rules and the port's own copy of them
(telemetry/ledger_check.py) agrees; the engine's `params_bytes` and
`kv_bytes` equal the JAX engine's for the same model and configuration;
the scheduler's per-class counters move as the JAX scheduler's do. On
the CPU there are no allocator stats, so `workspace` and `other` are 0;
the card's arithmetic (allocated, reserved) is held with injected stats.
"""
import gc
import json
import os
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu.serving.scheduler import Request as JaxRequest
from paddle_tpu.serving.scheduler import Scheduler as JaxScheduler
from paddle_tpu.serving import BlockPool as JaxBlockPool

from paddle_tpu_torch import monitor
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
from paddle_tpu_torch.serving import (BlockPool, MemoryPressureError,
                                      SamplingParams, ServingEngine,
                                      ServingHTTPServer, ShedError)
from paddle_tpu_torch.serving.scheduler import Request, Scheduler
from paddle_tpu_torch.telemetry import ledger_check, mem_obs
from paddle_tpu_torch.telemetry.mem_obs import (BUCKETS, MemoryObservatory,
                                                capture_postmortem, is_oom,
                                                register_provider,
                                                registered_providers,
                                                snapshot_ledger,
                                                unregister_provider)
from paddle_tpu_torch.telemetry.sink import JsonlSink, make_memsnap_record

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")

_MODEL = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=2,
              max_seq_len=64, dropout=0.0, initializer_range=0.2)
_ENGINE = dict(max_slots=2, block_size=8, prefill_chunk=8,
               max_model_len=64, dtype=None)
_WAIT_S = 60


def _tc():
    sys.path.insert(0, TOOLS)
    import trace_check
    return trace_check


def _write(tmp_path, name, recs):
    p = tmp_path / name
    p.write_text("\n".join(json.dumps(r) for r in recs) + "\n")
    return str(p)


def _both_clean(path):
    """The file passes the JAX trace_check and the port's ledger_check;
    returns the JAX stats."""
    problems, stats = _tc().check_pair(path)
    assert problems == []
    _, port_problems = ledger_check.check_jsonl(path)
    assert port_problems == []
    return stats


@pytest.fixture(scope="module")
def models():
    paddle.seed(5)
    jm = JaxGPT(JaxGPTConfig(use_flash_attention=False, **_MODEL))
    tm = GPTForPretraining(GPTConfig(**_MODEL), device="cpu")
    load_jax_params(tm, [(n, np.asarray(p._value))
                         for n, p in jm.named_parameters()])
    return jm, tm


def _engine(tm, **kw):
    return ServingEngine(tm, device="cpu", **{**_ENGINE, **kw})


@pytest.fixture(autouse=True)
def _no_stale_engines():
    """The ledger is per process: engines of earlier tests must not be
    counted in this one's."""
    gc.collect()
    yield


class _Owner:
    """Something for a provider to hang off: the registry holds it by
    weakref only."""

    def __init__(self, tensors):
        self.tensors = tensors


# ---------------------------------------------------------------------------
# the ledger + provider registry
# ---------------------------------------------------------------------------

def test_register_provider_rejects_unknown_bucket():
    with pytest.raises(ValueError, match="unknown bucket"):
        register_provider("x", "not_a_bucket", _Owner([]), lambda o: [])


def test_ledger_attributes_tagged_tensors_and_partitions():
    a = torch.ones(1024)                    # 4096 bytes
    b = torch.ones(512)                     # 2048 bytes
    owner = _Owner([a, b])
    key = register_provider("test.params", "params", owner,
                            lambda o: o.tensors)
    try:
        led = snapshot_ledger(device="cpu")
        assert led["params_bytes"] >= a.nbytes + b.nbytes
        # the buckets PARTITION the total; the CPU keeps no allocator
        # stats, so the total is the tagged sum
        assert sum(led[f"{bk}_bytes"] for bk in BUCKETS) \
            == led["total_bytes"]
        assert led["workspace_bytes"] == led["other_bytes"] == 0
        assert led["n_arrays"] >= 2
        tops = led["top_arrays"]
        assert tops == sorted(tops, key=lambda r: r["bytes"], reverse=True)
        assert all(t["bucket"] in BUCKETS for t in tops)
        assert {"bytes": 4096, "bucket": "params", "shape": [1024],
                "dtype": "torch.float32"} in tops
    finally:
        unregister_provider(key)
    led2 = snapshot_ledger(device="cpu")
    assert led2["params_bytes"] == led["params_bytes"] - 6144


def test_views_and_repeats_count_their_storage_once():
    base = torch.zeros(4, 256)              # 4096 bytes
    owner = _Owner([base, base[1], base.t(), base])
    key = register_provider("test.kv", "kv", owner, lambda o: o.tensors)
    try:
        led = snapshot_ledger(device="cpu")
        assert led["kv_bytes"] == 4096
        assert led["n_arrays"] == 1
    finally:
        unregister_provider(key)


def test_only_tensors_on_the_ledger_device_count():
    owner = _Owner([torch.ones(256)])
    key = register_provider("test.params", "params", owner,
                            lambda o: o.tensors)
    try:
        assert snapshot_ledger(device="cpu")["params_bytes"] == 1024
        assert snapshot_ledger(device="meta")["params_bytes"] == 0
    finally:
        unregister_provider(key)


def test_dead_owner_drops_out_of_the_registry():
    owner = _Owner([torch.ones(64)])
    key = register_provider("test.kv", "kv", owner, lambda o: o.tensors)
    assert any(k == key for k, _ in registered_providers())
    del owner
    gc.collect()
    # a dead owner must not pin its tensors: the provider vanishes
    assert not any(k == key for k, _ in registered_providers())
    snapshot_ledger(device="cpu")           # reaps without error
    unregister_provider(key)                # idempotent on reaped keys


def test_broken_provider_cannot_kill_sampling():
    def boom(owner):
        raise RuntimeError("provider exploded")
    owner = _Owner([])
    key = register_provider("test.bad", "opt_state", owner, boom)
    try:
        led = snapshot_ledger(device="cpu")  # must not raise
        assert led["total_bytes"] >= 0
    finally:
        unregister_provider(key)


def test_card_arithmetic_partitions_the_reserved_bytes(monkeypatch):
    """On a card: workspace = allocated - tagged, other = reserved -
    allocated, total = reserved (injected allocator stats)."""
    owner = _Owner([torch.ones(1000)])      # 4000 tagged bytes
    key = register_provider("test.params", "params", owner,
                            lambda o: o.tensors)
    monkeypatch.setattr(mem_obs, "allocator_stats", lambda device: {
        "allocated_bytes.all.current": 10_000,
        "reserved_bytes.all.current": 16_384})
    try:
        led = snapshot_ledger(device="cpu")
    finally:
        unregister_provider(key)
    assert led["params_bytes"] == 4000
    assert led["workspace_bytes"] == 6000
    assert led["other_bytes"] == 6384
    assert led["total_bytes"] == 16_384


def test_is_oom_recognition():
    assert is_oom(torch.OutOfMemoryError("CUDA out of memory."))
    assert is_oom(torch.cuda.OutOfMemoryError("CUDA out of memory."))
    assert is_oom(MemoryError("host allocator"))
    assert is_oom(RuntimeError("CUDA error: out of memory"))
    assert is_oom(RuntimeError(
        "RESOURCE_EXHAUSTED: Out of memory allocating 4096 bytes"))
    assert not is_oom(ValueError("shape mismatch"))
    assert not is_oom(RuntimeError("CUDA error: an illegal memory access"))


# ---------------------------------------------------------------------------
# the observatory: records, gauges, headroom, postmortem
# ---------------------------------------------------------------------------

def test_observatory_snapshot_record_and_headroom(tmp_path):
    path = str(tmp_path / "mem.jsonl")
    sink = JsonlSink(path)
    kv = {"blocks_total": 16, "blocks_held": 4, "blocks_free": 10,
          "blocks_cached": 2, "evictions": 0, "admissions": 3,
          "evictions_by_class": {}, "admissions_by_class": {"normal": 3}}
    obs = MemoryObservatory(sink=sink, hbm_budget_bytes=1 << 32,
                            kv_source=lambda: dict(kv), engine=7,
                            device="cpu")
    assert obs.headroom_bytes() is None     # nothing sampled yet
    r1 = obs.snapshot(1)
    kv.update(evictions=2, admissions=5, evictions_by_class={"batch": 2},
              admissions_by_class={"normal": 5})
    r2 = obs.snapshot(3)
    sink.close()

    assert r1["kind"] == "memsnap" and r1["event"] == "snapshot"
    assert r1["engine"] == 7
    assert sum(r1[f"{bk}_bytes"] for bk in BUCKETS) == r1["total_bytes"]
    assert r1["headroom_bytes"] == max(0, (1 << 32) - r1["total_bytes"])
    assert obs.headroom_bytes() == r2["headroom_bytes"]
    assert r1["kv_blocks_total"] == 16 and r1["kv_blocks_held"] == 4
    assert r1["kv_occupancy"] == pytest.approx(6 / 16)
    assert r1["kv_cache_share"] == pytest.approx(2 / 16)
    # rates need a window: absent on the first sample, per-step after
    assert "kv_eviction_rate" not in r1
    assert r2["kv_eviction_rate"] == pytest.approx(2 / 2)
    assert r2["kv_admission_rate"] == pytest.approx(2 / 2)
    # no projection in the port
    assert "projected_bytes" not in r1 and "projection_family" not in r1
    assert monitor.get_gauge("mem.total_bytes") == float(r2["total_bytes"])
    assert monitor.get_gauge("mem.headroom_bytes") == float(
        r2["headroom_bytes"])
    assert _both_clean(path)["n_memsnap"] == 2


def test_observatory_no_budget_means_no_opinion():
    obs = MemoryObservatory(device="cpu")
    rec = obs.snapshot(1)
    assert "hbm_budget_bytes" not in rec
    assert "headroom_bytes" not in rec
    assert obs.headroom_bytes() is None     # admission: no opinion


def test_postmortem_carries_forensics(tmp_path):
    path = str(tmp_path / "post.jsonl")
    sink = JsonlSink(path)
    owner = _Owner([torch.ones(2048)])
    key = register_provider("test.kv", "kv", owner, lambda o: o.tensors)
    try:
        obs = MemoryObservatory(sink=sink, hbm_budget_bytes=1 << 30,
                                device="cpu")
        rec = obs.capture_postmortem(
            torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                   "allocate 9.00 GiB"), step=12)
        one = capture_postmortem("allocation failure", sink=sink, step=3,
                                 device="cpu")
    finally:
        unregister_provider(key)
    sink.close()
    assert rec["event"] == "postmortem" and rec["step"] == 12
    assert "out of memory" in rec["error"]
    assert rec["top_arrays"][0]["bytes"] >= 8192
    assert rec["compile_families"] == []
    # no allocator on the CPU: no retry/OOM counts, no segments
    assert "num_ooms" not in rec and "top_segments" not in rec
    assert one["event"] == "postmortem" and one["step"] == 3
    assert _both_clean(path)["n_memsnap"] == 2


def test_postmortem_reads_the_allocator_on_a_card(monkeypatch):
    monkeypatch.setattr(mem_obs, "allocator_stats", lambda device: {
        "allocated_bytes.all.current": 100, "reserved_bytes.all.current":
        200, "num_alloc_retries": 2, "num_ooms": 1})
    monkeypatch.setattr(mem_obs, "_top_segments", lambda device, k: [
        {"bytes": 200, "allocated_bytes": 100,
         "segment_type": "large", "stream": 0}])
    rec = MemoryObservatory(device="cpu").capture_postmortem("oom", step=1)
    assert rec["num_alloc_retries"] == 2 and rec["num_ooms"] == 1
    assert rec["top_segments"][0]["bytes"] == 200
    assert rec["total_bytes"] >= 200


# ---------------------------------------------------------------------------
# the ledger rules: the port's copy agrees with the JAX trace_check
# ---------------------------------------------------------------------------

def _snap(step, total, budget=None, **kw):
    return make_memsnap_record("snapshot", step, total,
                               hbm_budget_bytes=budget, **kw)


def test_memsnap_cross_rules_agree_with_trace_check(tmp_path):
    tc = _tc()
    good = _snap(1, 100, budget=150, params_bytes=60, opt_state_bytes=20,
                 kv_bytes=10, workspace_bytes=8, other_bytes=2,
                 headroom_bytes=50, kv_blocks_total=16, kv_blocks_held=10,
                 kv_blocks_free=4, kv_blocks_cached=2,
                 kv_occupancy=12 / 16, kv_cache_share=2 / 16,
                 kv_evictions=1, evictions_by_class={"normal": 1})
    cases = {"ok": (good, None),
             "sum": (dict(good, params_bytes=61), "bucket"),
             "head": (dict(good, headroom_bytes=9), "headroom"),
             "census": (dict(good, kv_blocks_free=5), "tile"),
             "occupancy": (dict(good, kv_occupancy=0.5), "kv_occupancy"),
             "by_class": (dict(good, evictions_by_class={"normal": 2}),
                          "evictions_by_class"),
             "post": (make_memsnap_record("postmortem", 2, 100), "error")}
    for name, (rec, needle) in cases.items():
        path = _write(tmp_path, f"{name}.jsonl", [rec])
        jax_problems, _ = tc.check_pair(path)
        _, port_problems = ledger_check.check_jsonl(path)
        assert [p.split(": ", 1)[1] for p in port_problems] == \
            [p.split(": ", 1)[1] for p in jax_problems], name
        if needle is None:
            assert port_problems == []
        else:
            assert any(needle in p for p in port_problems), name


def test_jax_memsnap_specimen_agrees():
    path = os.path.join(TOOLS, "specimens", "memsnap_pressure.jsonl")
    jax_problems, _ = _tc().check_pair(path)
    _, port_problems = ledger_check.check_jsonl(path)
    assert port_problems == jax_problems == []


# ---------------------------------------------------------------------------
# serving-engine wiring: ledger cadence, headroom gate, OOM postmortem
# ---------------------------------------------------------------------------

def test_engine_emits_validating_ledger(models, tmp_path):
    _, tm = models
    path = str(tmp_path / "serve.jsonl")
    sink = JsonlSink(path)
    eng = _engine(tm, hbm_budget_mb=256, sink=sink)
    h = eng.submit(list(range(1, 7)), SamplingParams(max_new_tokens=4))
    eng.run_until_idle(max_steps=2000)
    assert h.status == "finished"
    sink.close()
    stats = _both_clean(path)
    assert stats["n_memsnap"] == eng._steps
    last = eng.mem_obs.last
    # the engine tags its own weights and arenas, exactly
    assert last["params_bytes"] == sum(
        p.numel() * p.element_size() for p in tm.parameters())
    assert last["kv_bytes"] == eng.cache.nbytes
    assert last["kv_blocks_total"] == eng.pool.capacity
    assert last["admissions_by_class"] == {"normal": 1}
    assert monitor.get_gauge("serving.mem_headroom_bytes") \
        == float(eng.mem_obs.headroom_bytes())


def test_mem_sample_every_sets_the_cadence(models):
    _, tm = models
    eng = _engine(tm, mem_sample_every=3)
    eng.submit(list(range(1, 7)), SamplingParams(max_new_tokens=6))
    n = eng.run_until_idle(max_steps=2000)
    assert [r["step"] for r in eng.mem_obs.records] == \
        list(range(3, n + 1, 3))


def test_headroom_gauge_falls_back_to_free_kv_bytes(models):
    _, tm = models
    eng = _engine(tm)
    per_block = 2 * 2 * 8 * 64 * 4          # K+V, layers, block, width, f32
    assert monitor.get_gauge("serving.mem_headroom_bytes") == float(
        eng.pool.num_free * per_block)


@pytest.fixture
def ballast():
    """2 MiB tagged as optimizer state: with it the ledger exceeds a
    1 MiB budget (the tiny engine alone holds ~0.25 MiB)."""
    owner = _Owner([torch.zeros(2 ** 19)])
    key = register_provider("test.ballast", "opt_state", owner,
                            lambda o: o.tensors)
    yield owner
    unregister_provider(key)


def test_engine_sheds_on_exhausted_headroom(models, ballast):
    _, tm = models
    eng = _engine(tm, hbm_budget_mb=1)
    eng.mem_obs.snapshot(0)                  # ledger: headroom 0
    assert eng.mem_obs.headroom_bytes() == 0
    before = monitor.get("serving.mem_shed", 0)
    with pytest.raises(MemoryPressureError) as e:
        eng.submit(list(range(1, 7)), SamplingParams(max_new_tokens=4))
    assert isinstance(e.value, ShedError)
    assert e.value.reason == "mem_pressure"
    assert e.value.retry_after_s > 0
    assert monitor.get("serving.mem_shed", 0) == before + 1
    assert eng._counts["shed"] == 1 and eng._counts["admitted"] == 0


def test_http_front_answers_429_on_memory_pressure(models, ballast):
    _, tm = models
    eng = _engine(tm, hbm_budget_mb=1)
    eng.mem_obs.snapshot(0)
    with eng, ServingHTTPServer(eng, port=0) as srv:
        body = json.dumps({"prompt": [1, 2, 3], "max_new_tokens": 4,
                           "stream": True}).encode()
        req = urllib.request.Request(
            srv.url + "/generate", data=body,
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=_WAIT_S)
        reply = json.loads(e.value.read().decode())
    assert e.value.code == 429
    assert int(e.value.headers["Retry-After"]) >= 1
    assert reply["reason"] == "mem_pressure" and reply["status"] == "shed"


def test_engine_sheds_exactly_when_the_budget_is_exhausted(models):
    _, tm = models
    eng = _engine(tm, hbm_budget_mb=256)
    eng.mem_obs.snapshot(0)
    assert eng.mem_obs.headroom_bytes() > 0
    h = eng.submit(list(range(1, 7)), SamplingParams(max_new_tokens=2))
    eng.run_until_idle(max_steps=2000)
    assert h.status == "finished" and eng._counts["shed"] == 0
    # the same engine with its headroom used up: the next submit sheds
    eng.mem_obs.hbm_budget_bytes = eng.mem_obs.last["total_bytes"]
    eng.mem_obs.snapshot(eng._steps + 1)
    with pytest.raises(MemoryPressureError):
        eng.submit(list(range(1, 7)), SamplingParams(max_new_tokens=2))


def test_engine_without_budget_never_mem_sheds(models):
    _, tm = models
    eng = _engine(tm)
    eng.mem_obs.snapshot(0)
    h = eng.submit(list(range(1, 7)), SamplingParams(max_new_tokens=2))
    eng.run_until_idle(max_steps=2000)
    assert h.status == "finished"
    assert eng._counts["shed"] == 0


class _ListSink:
    def __init__(self):
        self.records = []

    def write(self, rec):
        self.records.append(rec)
        return rec


def _jax_stream(jm, prompt, n):
    eng = JaxServingEngine(jm, **_ENGINE)
    h = eng.submit(prompt, JaxSamplingParams(max_new_tokens=n))
    eng.run_until_idle(max_steps=5000)
    return h.output_tokens


def test_engine_oom_writes_postmortem_before_rebuild(models):
    """One step raises torch.OutOfMemoryError: the postmortem is written
    while the old arenas are still the engine's (their bytes on the
    record, the record before the restart record), the engine warm-
    restarts, and the stream is the JAX engine's uninterrupted one."""
    jm, tm = models
    sink = _ListSink()
    eng = _engine(tm, hbm_budget_mb=256, sink=sink, restart_backoff_s=0.01)
    old_cache = eng.cache
    calls = {"n": 0}
    inner = eng._decode_step

    def boom(inputs, sampling):
        calls["n"] += 1
        if calls["n"] == 3:
            raise torch.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 9.20 GiB")
        return inner(inputs, sampling)

    eng._decode_step = boom
    prompt = list(range(1, 8))
    with eng:
        h = eng.submit(prompt, SamplingParams(max_new_tokens=8))
        toks = h.result(timeout=_WAIT_S)
    assert calls["n"] >= 3
    events = [(r.get("kind"), r.get("event")) for r in sink.records]
    post = events.index(("memsnap", "postmortem"))
    assert post < events.index(("serving", "restart"))
    rec = sink.records[post]
    assert "out of memory" in rec["error"] and rec["top_arrays"]
    assert rec["kv_bytes"] == old_cache.nbytes
    assert eng.cache is not old_cache       # rebuilt after the record
    assert toks == _jax_stream(jm, prompt, 8)
    assert ledger_check.check_records(sink.records) == []


def test_engine_oom_until_dead_still_leaves_postmortems(models):
    _, tm = models
    eng = _engine(tm, hbm_budget_mb=256, max_restarts=1,
                  restart_backoff_s=0.01)

    def boom(*a, **k):
        raise torch.OutOfMemoryError("CUDA out of memory.")

    eng._decode_step = boom
    with eng:
        h = eng.submit(list(range(1, 7)), SamplingParams(max_new_tokens=4))
        with pytest.raises(Exception, match="out of memory"):
            h.result(timeout=_WAIT_S)
    posts = [r for r in eng.mem_obs.records
             if r.get("event") == "postmortem"]
    assert len(posts) == 2                  # one per failed step
    assert eng.dead


# ---------------------------------------------------------------------------
# against the JAX engine and scheduler
# ---------------------------------------------------------------------------

def test_params_and_kv_bytes_equal_the_jax_engines(models):
    jm, tm = models
    jeng = JaxServingEngine(jm, hbm_budget_mb=256, **_ENGINE)
    jrec = jeng.mem_obs.snapshot(0)
    rec = _engine(tm, hbm_budget_mb=256).mem_obs.snapshot(0)
    assert rec["params_bytes"] == jrec["params_bytes"] > 0
    assert rec["kv_bytes"] == jrec["kv_bytes"] > 0
    for key in ("kv_blocks_total", "kv_blocks_held", "kv_blocks_free",
                "kv_blocks_cached", "hbm_budget_bytes"):
        assert rec[key] == jrec[key], key


def test_class_counters_move_as_the_jax_schedulers():
    """Admissions count every entry into prefill (replays included),
    evictions every preemption, per priority class — the same sequence
    on both schedulers gives the same ledgers."""
    key = np.zeros((2,), np.uint32)
    out = []
    for pool_cls, sched_cls, req_cls, params_cls in (
            (JaxBlockPool, JaxScheduler, JaxRequest, JaxSamplingParams),
            (BlockPool, Scheduler, Request, SamplingParams)):
        pool = pool_cls(7)                   # capacity 6
        sched = sched_cls(pool, block_size=8, max_slots=3,
                          max_model_len=48)
        reqs = [req_cls([1] * 8, params_cls(max_new_tokens=8), key,
                        priority=p)
                for p in ("normal", "batch", "interactive")]
        for r in reqs:
            sched.submit(r)
        sched.admit()
        for r in reqs:
            assert sched.ensure_blocks(r, 16, evict=False)
        # growth under pressure preempts the youngest block-holder (the
        # batch-class request: the queue admits by class)
        assert sched.ensure_blocks(reqs[0], 17, evict=True)
        assert reqs[1].state == "waiting"
        sched.finish(reqs[2])
        sched.admit()                        # the victim is re-admitted
        out.append((dict(sched.admissions_by_class),
                    dict(sched.evictions_by_class)))
    assert out[0] == out[1]
    adm, ev = out[1]
    assert sum(adm.values()) == 4 and sum(ev.values()) == 1
