"""The port's flight recorder (paddle_tpu_torch.telemetry.recorder) and
its step record, against the JAX package's, on the CPU.

- A tiny GPT's `TrainStep` under the port's `TelemetryRecorder` and the
  JAX one under the JAX recorder (same weights, batch, health every_k 2,
  memory tracking off in both: the CPU has no allocator counter) write
  step records with the same key set on every step; each port record
  passes the JAX `validate_step_record` and the port's `validate_record`,
  and its loss and health fields agree with the JAX record's. A GPTMoE
  step carries the `moe_*` fields and passes both validators.
- The compile split: a graph capture inside a step window is that
  step's compile_ms (a cache miss); the next step shows 0.0 (a hit).
- The Chrome export closes a still-open span as args.open; the open-span
  table is right across threads; `StepTimer` counts hits and misses.
"""
import json
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jax_opt
from paddle_tpu import telemetry as jax_telemetry
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.telemetry.health import HealthConfig as JaxHealthConfig
from paddle_tpu.telemetry.sink import validate_step_record

from paddle_tpu_torch import jit
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
from paddle_tpu_torch.moe import GPTMoE, GPTMoEConfig
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.telemetry import (HealthConfig, TelemetryRecorder,
                                        validate_record)
from paddle_tpu_torch.telemetry import recorder
from paddle_tpu_torch.telemetry.recorder import StepTimer, open_spans, span

_MODEL = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
              max_seq_len=64, dropout=0.0, initializer_range=0.02)
_TOKENS = 2 * 64


def _batch():
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 512, (2, 64)).astype(np.int32)
    lbl = rs.randint(0, 512, (2, 64)).astype(np.int32)
    return ids, lbl


def _record_runs():
    """Four JAX and four port TrainSteps under their recorders. The JAX
    recorder pops the JAX input pipeline's one-shot stash into the first
    step it records (`paddle_tpu.io.prefetch.consume_step_input_stats`);
    a stash left filled by an earlier test in the same process (the
    prefetch tests) would add its `input_*` keys to that record alone,
    so it is drained first: the port has no input pipeline yet."""
    from paddle_tpu.io.prefetch import consume_step_input_stats
    consume_step_input_stats()
    paddle.seed(5)
    jm = JaxGPT(JaxGPTConfig(**_MODEL))
    arrays = [(n, np.asarray(p._value)) for n, p in jm.named_parameters()]
    jo = jax_opt.AdamW(learning_rate=1e-4, parameters=jm.parameters())
    jstep = paddle.jit.TrainStep(jm, jm.loss, jo, health=JaxHealthConfig(
        every_k=2, action="record", dump_on_exception=False))
    tm = load_jax_params(GPTForPretraining(GPTConfig(**_MODEL),
                                           device="cpu"), arrays)
    to = AdamW(learning_rate=1e-4, parameters=tm.parameters())
    tstep = jit.TrainStep(tm, tm.loss, to, health=HealthConfig(
        every_k=2, action="record", dump_on_exception=False))
    ids, lbl = _batch()
    kw = dict(tokens_per_step=_TOKENS, flops_per_token=1e6,
              track_memory=False)
    jrec = jax_telemetry.TelemetryRecorder(**kw)
    trec = TelemetryRecorder(**kw)
    with jrec:
        for _ in range(4):
            jstep(paddle.to_tensor(ids, "int32"),
                  paddle.to_tensor(lbl, "int32"))
    with trec:
        for _ in range(4):
            tstep(torch.from_numpy(ids), torch.from_numpy(lbl))
    return jrec.records, trec.records


@pytest.fixture(scope="module")
def records():
    return _record_runs()


def test_step_records_carry_the_jax_key_set(records):
    jr, tr = records
    assert len(jr) == len(tr) == 4
    for j, t in zip(jr, tr):
        assert sorted(t) == sorted(j)
    # the health taps land on the fetch steps only (every_k 2)
    assert ["grad_norm" in t for t in tr] == [False, True, False, True]


def test_a_stash_left_by_the_input_pipeline_does_not_move_the_key_set():
    """A filled stash (as tests/test_io_prefetch.py leaves it) before the
    runs: both key sets still agree on every step."""
    from paddle_tpu.io.prefetch import _note_input_stats
    _note_input_stats(1.5, 2, 0.25)
    jr, tr = _record_runs()
    assert len(jr) == len(tr) == 4
    for j, t in zip(jr, tr):
        assert sorted(t) == sorted(j)
        assert not any(k.startswith("input_") for k in j)


def test_step_records_pass_both_validators(records):
    for rec in records[1]:
        rt = json.loads(json.dumps(rec))
        assert validate_step_record(rt) == []
        assert validate_record(rt) == []
        assert rt["kind"] == "step" and rt["mfu"] == 0.0   # no CPU peak
        assert rt["tokens_per_sec"] > 0


def test_step_record_values_track_the_jax_records(records):
    jr, tr = records
    for j, t in zip(jr, tr):
        assert t["step"] == j["step"]
        assert t["loss"] == pytest.approx(j["loss"], rel=1e-5)
        for key in ("grad_norm", "update_ratio"):
            if key in j:
                assert t[key] == pytest.approx(j[key], rel=1e-5)
        for key in ("nan_count", "inf_count"):
            assert t.get(key) == j.get(key)


def test_moe_fields_ride_the_step_record():
    cfg = GPTMoEConfig(vocab_size=128, hidden_size=64, num_layers=2,
                       num_heads=2, max_seq_len=32, dropout=0.0,
                       num_experts=4, expert_top_k=2, capacity_factor=1.25)
    model = GPTMoE(cfg, device="cpu")
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    step = jit.TrainStep(model, model.loss, opt)
    ids = torch.randint(0, 128, (2, 32), generator=torch.Generator()
                        .manual_seed(0))
    step(ids, ids)                   # no recorder: nothing fetched
    rec = TelemetryRecorder(track_memory=False)
    with rec:
        step(ids, ids)
    r = json.loads(json.dumps(rec.records[0]))
    assert r["moe_num_experts"] == 4
    assert 0.0 <= r["moe_dropped_frac"] <= 1.0
    assert 0.0 <= r["moe_entropy"] <= np.log(4) + 1e-6
    assert validate_step_record(r) == [] and validate_record(r) == []


class _SleepyGraph:
    """A graph stand-in on the CPU whose capture takes 20 ms."""

    def __init__(self, keep_graph=False):
        pass

    def capture_begin(self, pool=None, capture_error_mode="global"):
        time.sleep(0.02)

    def capture_end(self):
        pass

    def instantiate(self):
        pass

    def replay(self):
        pass


def test_the_compile_split_counts_a_capture():
    steps = jit.CapturedStep("cpu", graph_cls=_SleepyGraph)
    rec = TelemetryRecorder(track_memory=False)
    with rec:
        for _ in range(2):
            with rec.step() as win:
                steps.run("decode", "k", lambda: 1)
                win.note(loss=1.0)
    first, second = rec.records
    assert first["compile_ms"] >= 20.0 and first["cache_misses"] == 1
    assert second["compile_ms"] == 0.0 and second["cache_hits"] == 1
    assert validate_step_record(first) == []


def test_note_compile_reaches_every_open_window():
    rec = TelemetryRecorder(track_memory=False)
    with rec:
        with rec.step():
            recorder.note_compile(0.5)
    recorder.note_compile(0.5)           # no window open: dropped
    assert rec.records[0]["compile_ms"] == 500.0
    assert rec.records[0]["execute_ms"] == 0.0


def test_chrome_export_closes_open_spans(tmp_path):
    rec = TelemetryRecorder(track_memory=False)
    entered, release = threading.Event(), threading.Event()

    def stuck():
        with span("collective.all_reduce", cat="collective", axis="dp"):
            entered.set()
            release.wait(10)

    with rec:
        with span("host.work"):
            pass
        t = threading.Thread(target=stuck, name="stuck-thread")
        t.start()
        assert entered.wait(10)
        path = tmp_path / "trace.json"
        n = rec.export_chrome_tracing(str(path))
        release.set()
        t.join(10)
    assert not t.is_alive()
    events = json.load(open(path))["traceEvents"]
    names = {e["name"]: e for e in events if e.get("ph") == "X"}
    assert n == 2 and set(names) == {"host.work", "collective.all_reduce"}
    assert names["collective.all_reduce"]["args"]["open"] is True
    assert "open" not in names["host.work"].get("args", {})


def test_open_span_registry_across_threads():
    n = 6
    entered = threading.Barrier(n + 1)
    release = threading.Event()

    def worker(i):
        with span(f"w{i}", shard=i):
            entered.wait(10)
            release.wait(10)

    threads = [threading.Thread(target=worker, args=(i,), name=f"t{i}")
               for i in range(n)]
    for t in threads:
        t.start()
    entered.wait(10)
    spans = open_spans()
    release.set()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    mine = sorted((s["name"], s["thread"], s["attrs"]["shard"])
                  for s in spans if s["name"].startswith("w"))
    assert mine == [(f"w{i}", f"t{i}", i) for i in range(n)]
    assert all(s["age_s"] >= 0 for s in spans)
    assert [s for s in open_spans() if s["name"].startswith("w")] == []


def test_step_timer_counts_hits_and_misses():
    rec = TelemetryRecorder(track_memory=False)
    timer = StepTimer(lambda x: x * 2, recorder=rec)
    with rec:
        timer(torch.ones(3))
        timer(torch.ones(3))
        timer(torch.ones(4))
    assert (timer.cache_hits, timer.cache_misses) == (1, 2)
    assert timer.memory_analysis() is None
    assert [r["cache_misses"] for r in rec.records] == [1, 1, 2]
