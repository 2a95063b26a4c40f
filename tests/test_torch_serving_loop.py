"""The port's serve loop: start/stop, warm restart, the restart cap,
permanent failures, drain and the quiesce ledger, on the CPU in f32.

The port's versions of tests/test_serving_resilience.py's lifecycle
cases and tests/test_serving.py's step-error case. A warm restart after
an injected step fault (a RuntimeError, an out-of-memory error, a
transient-tagged OSError) must replay every stream — greedy and sampled
— token-identically to the JAX engine's uninterrupted streams. Every
wait is bounded (`result(timeout=)`, join timeouts) and every started
engine is stopped on the way out (`with eng:`).
"""
import json
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import ServingEngine as JaxServingEngine

from paddle_tpu_torch import monitor
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
from paddle_tpu_torch.resilience.retry import classify_failure, tag_transient
from paddle_tpu_torch.serving import (EngineDeadError, EngineDrainingError,
                                      EngineStoppedError, SamplingParams,
                                      ServingEngine)
from paddle_tpu_torch.serving.resilience import restart_backoff
from paddle_tpu_torch.telemetry.sink import JsonlSink

_MODEL = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
              max_seq_len=128, dropout=0.0, initializer_range=0.2)
_ENGINE = dict(max_slots=2, block_size=8, prefill_chunk=8,
               max_model_len=64, dtype=None)
_KNOBS = (dict(), dict(decode_strategy="sampling", seed=5, top_k=20,
                       top_p=0.9, temperature=0.8),
          dict(decode_strategy="sampling", seed=9))
_WAIT_S = 60


@pytest.fixture(scope="module")
def models():
    paddle.seed(11)
    jm = JaxGPT(JaxGPTConfig(use_flash_attention=False, **_MODEL))
    tm = GPTForPretraining(GPTConfig(**_MODEL), device="cpu")
    load_jax_params(tm, [(n, np.asarray(p._value))
                         for n, p in jm.named_parameters()])
    return jm, tm


@pytest.fixture(scope="module")
def jax_streams(models):
    """The JAX engine's uninterrupted streams of `_prompts()` x
    `_KNOBS`, 10 tokens each."""
    jm, _ = models
    eng = JaxServingEngine(jm, **_ENGINE)
    hs = [eng.submit(p, JaxSamplingParams(max_new_tokens=10, **k))
          for p, k in zip(_prompts(), _KNOBS)]
    eng.run_until_idle(max_steps=5000)
    return [h.output_tokens for h in hs]


def _prompts():
    rs = np.random.RandomState(0)
    return [rs.randint(0, 512, (n,)).tolist() for n in (7, 5, 9)]


def _engine(tm, **kw):
    return ServingEngine(tm, device="cpu", **{**_ENGINE, **kw})


def test_stop_fails_blocked_submitters(models):
    _, tm = models
    eng = _engine(tm)
    p = _prompts()[0]
    handles = [eng.submit(p, SamplingParams(max_new_tokens=8))
               for _ in range(3)]
    assert eng.stop() is True               # loop never ran: queue stuck
    for h in handles:
        assert h.status == "failed"
        with pytest.raises(EngineStoppedError):
            h.result(timeout=5)
    with pytest.raises(EngineStoppedError):
        eng.submit(p, SamplingParams(max_new_tokens=4))
    assert eng._counts["failed"] == 3
    assert eng.pool.num_used == 0


def test_stop_stays_bounded_when_loop_is_wedged(models):
    """A wedged step holding the engine lock past the join window must
    not turn stop() into an unbounded hang."""
    _, tm = models
    eng = _engine(tm)
    eng._join_timeout_s = 0.1
    eng._stop_lock_timeout_s = 0.1
    release = threading.Event()
    holding = threading.Event()

    def wedged():
        with eng._mu:                       # a step stuck on the device
            holding.set()
            release.wait(30)

    t = threading.Thread(target=wedged, daemon=True)
    t.start()
    try:
        assert holding.wait(10)
        eng._thread = t                     # stands in for the loop
        t0 = time.monotonic()
        assert eng.stop() is False
        assert time.monotonic() - t0 < 2.0  # bounded, not forever
    finally:
        release.set()
        t.join(timeout=10)
    assert not t.is_alive()
    eng._thread = None
    assert eng.stop() is True


_FAULTS = {
    "runtime_error": lambda: RuntimeError("injected CUDA launch error"),
    "out_of_memory": lambda: torch.OutOfMemoryError("injected OOM"),
    "transient_oserror": lambda: tag_transient(
        OSError(5, "injected transient fault")),
}


@pytest.mark.parametrize("fault", sorted(_FAULTS))
def test_warm_restart_replays_streams_identically(models, jax_streams,
                                                  fault):
    """A step fault classified infra/transient warm-restarts the engine:
    arenas rebuilt, in-flight requests requeued, and every stream —
    greedy and sampled — token-identical to the JAX engine's."""
    _, tm = models
    assert classify_failure(_FAULTS[fault]()) in ("infra", "transient")
    eng = _engine(tm, restart_backoff_s=0.01)
    before = monitor.get("serving.restarts", 0)
    calls = {"n": 0}
    orig = eng._decode_step

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] == 4:
            raise _FAULTS[fault]()
        return orig(*a, **k)

    eng._decode_step = flaky
    with eng:
        handles = [eng.submit(p, SamplingParams(max_new_tokens=10, **k))
                   for p, k in zip(_prompts(), _KNOBS)]
        outs = [h.result(timeout=_WAIT_S) for h in handles]
    assert outs == jax_streams
    assert calls["n"] >= 4                  # the fault really fired
    assert monitor.get("serving.restarts", 0) == before + 1
    assert eng._counts["finished"] == 3 and eng._counts["failed"] == 0
    eng.pool.assert_quiesced()


def test_engine_dead_after_restart_cap(models):
    """A persistent fault must not restart forever: past max_restarts
    consecutive failures the engine is dead, fails everything
    outstanding, and refuses new work."""
    _, tm = models
    eng = _engine(tm, max_restarts=2, restart_backoff_s=0.01)
    sleeps = []
    eng._sleep = sleeps.append              # no real backoff sleeping

    def always_down(*a, **k):
        raise RuntimeError("device gone")

    eng._decode_step = always_down
    # 5 tokens: each replay (prompt + the tokens streamed so far) stays
    # one prefill chunk, so no fault-free step resets the restart count
    p = _prompts()[1]
    with eng:
        h = eng.submit(p, SamplingParams(max_new_tokens=8))
        with pytest.raises(EngineDeadError, match="device gone"):
            h.result(timeout=_WAIT_S)
        assert eng.dead
        with pytest.raises(EngineDeadError):
            eng.submit(p, SamplingParams(max_new_tokens=4))
        with pytest.raises(EngineDeadError):
            eng.start()
    assert sleeps == [restart_backoff(1, 0.01), restart_backoff(2, 0.01)]
    assert eng.pool.num_used == 0
    assert monitor.get_gauge("serving.engine_dead", 0) == 1


def test_permanent_error_fails_active_requests_and_loop_survives(
        models, jax_streams):
    """A programming error in a step fails the requests it hit (their
    streams raise, never hang), rebuilds the arenas, and the loop keeps
    serving."""
    _, tm = models
    eng = _engine(tm)
    orig = eng._decode_step
    before = monitor.get("serving.engine_errors", 0)

    def boom(*a, **k):
        raise ValueError("injected raising decode")

    p = _prompts()[0]
    with eng:
        eng._decode_step = boom
        h = eng.submit(p, SamplingParams(max_new_tokens=5))
        with pytest.raises(RuntimeError, match="injected"):
            h.result(timeout=_WAIT_S)
        assert h.finished and h.status == "failed"
        assert monitor.get("serving.engine_errors", 0) > before
        assert eng.pool.num_used == 0       # state rebuilt clean
        eng._decode_step = orig             # the "device" recovers
        h2 = eng.submit(p, SamplingParams(max_new_tokens=10))
        assert h2.result(timeout=_WAIT_S) == jax_streams[0]


def test_drain_closes_admission_and_quiesce_balances(models, jax_streams,
                                                     tmp_path):
    _, tm = models
    path = tmp_path / "serving.jsonl"
    sink = JsonlSink(path)
    eng = ServingEngine(tm, sink=sink, device="cpu", **_ENGINE)
    try:
        with eng:
            handles = [eng.submit(p, SamplingParams(max_new_tokens=10,
                                                    **k))
                       for p, k in zip(_prompts(), _KNOBS)]
            h_cancel = eng.submit(_prompts()[1],
                                  SamplingParams(max_new_tokens=40))
            h_cancel.cancel()
            done = {}
            t = threading.Thread(
                target=lambda: done.update(ok=eng.drain(timeout=_WAIT_S)))
            t.start()
            deadline = time.monotonic() + 10
            while not eng.draining and time.monotonic() < deadline:
                time.sleep(0.005)
            assert eng.draining
            assert monitor.get_gauge("serving.draining") == 1
            with pytest.raises(EngineDrainingError) as e:
                eng.submit(_prompts()[0], SamplingParams(max_new_tokens=4))
            assert e.value.retry_after_s > 0
            t.join(timeout=_WAIT_S)
            assert not t.is_alive() and done.get("ok") is True
            assert [h.output_tokens for h in handles] == jax_streams
            eng.resume_admission()
            h = eng.submit(_prompts()[0], SamplingParams(max_new_tokens=4))
            assert h.result(timeout=_WAIT_S) == jax_streams[0][:4]
    finally:
        sink.close()
    recs = [json.loads(ln) for ln in path.read_text().splitlines()]
    serving = [r for r in recs if r["kind"] == "serving"]
    events = [r["event"] for r in serving]
    assert events.count("admitted") == 5 and "drain_begin" in events
    quiesce = [r for r in serving if r["event"] == "quiesce"][-1]
    c = quiesce["counts"]
    assert c["admitted"] == 4 and c["cancelled"] == 1
    assert c["admitted"] == (c["finished"] + c["failed"] + c["cancelled"]
                             + c["expired"])
    assert quiesce["kv_blocks_used"] == 0
    # every finished request's trace tiles its life: spans sum to e2e
    traces = [r for r in recs if r["kind"] == "reqtrace"]
    assert len(traces) == 5
    for tr in traces:
        total = sum(sp["dur_ms"] for sp in tr["spans"])
        assert abs(total - tr["e2e_ms"]) <= 0.01 * tr["e2e_ms"] + 0.01
    assert {tr["outcome"] for tr in traces} == {"finished", "cancelled"}


def test_metrics_snapshot_and_latency_histograms(models):
    _, tm = models
    eng = _engine(tm)
    n0 = (monitor.get_hist("serving.ttft_ms").total
          if monitor.get_hist("serving.ttft_ms") else 0)
    for p, k in zip(_prompts(), _KNOBS):
        eng.submit(p, SamplingParams(max_new_tokens=6, **k))
    eng.run_until_idle(max_steps=2000)
    assert monitor.get_hist("serving.ttft_ms").total == n0 + 3
    snap = eng.metrics_snapshot()
    for name in ("serving.queue_depth", "serving.kv_block_utilization",
                 "serving.ttft_p50_ms", "serving.tpot_p99_ms",
                 "serving.tokens_generated", "serving.decode_steps"):
        assert name in snap, name
    assert snap["serving.queue_depth"] == 0
    assert all(k.startswith("serving.") for k in snap)


def test_kv_memory_mb_sizes_the_pool_and_engine_id_names_requests(models):
    """The JAX engine's sizing rule: kv_memory_mb over the bytes of one
    block across layers, K and V; request ids default to e<id>-r<rid>."""
    _, tm = models
    eng = _engine(tm, kv_memory_mb=1, engine_id=7)
    per_block = 2 * _MODEL["num_layers"] * _ENGINE["block_size"] \
        * _MODEL["hidden_size"] * 4                   # f32 arenas
    assert eng.pool.num_blocks == 2 ** 20 // per_block
    h = eng.submit(_prompts()[0], SamplingParams(max_new_tokens=2))
    assert h.request_id == f"e7-r{h.rid}"
    eng.run_until_idle(max_steps=100)
    assert h.result(timeout=5) and eng.pool.num_used == 0
