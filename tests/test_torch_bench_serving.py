"""The port's serving bench (paddle_tpu_torch.tools.bench_serving)
against the JAX package's bench_serving.py, on the CPU in f32.

- `SERVING_BENCH_METRICS` (names, order, gate directions) equals JAX's.
- `shared_prefix_phase` at the CPU configuration, same weights, f32 on
  both sides: the same streams, and the warm engines end with the same
  prefix accounting (lookups, hits, tokens saved and offered).
- `serve_level` at level 2 over the CPU configuration's engine and
  prompts: the same requests, token counts and streams as JAX's.
- `main --cpu` writes one valid kind=bench record per metric the
  single-engine bench owns (every SERVING_BENCH_METRICS row but the
  rated-load and fleet ones), valid under both validators.
"""
import functools
import json

import numpy as np
import pytest
import torch

import bench_serving as jax_bench
import paddle_tpu as paddle
import paddle_tpu.serving as jax_serving
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.telemetry.sink import SERVING_BENCH_METRICS as JAX_METRICS
from paddle_tpu.telemetry.sink import validate_step_record

import paddle_tpu_torch.serving as port_serving
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
from paddle_tpu_torch.telemetry.ledger_check import validate_record
from paddle_tpu_torch.telemetry.sink import SERVING_BENCH_METRICS
from paddle_tpu_torch.tools import bench_serving

_MODEL = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
              max_seq_len=128, dropout=0.0, initializer_range=0.2,
              use_flash_attention=False)


def test_serving_bench_metrics_equal_the_jax_table():
    assert list(SERVING_BENCH_METRICS.items()) == list(JAX_METRICS.items())


@pytest.fixture(scope="module")
def pair():
    paddle.seed(3)
    jm = JaxGPT(JaxGPTConfig(**_MODEL))
    tm = load_jax_params(
        GPTForPretraining(GPTConfig(**_MODEL), device="cpu"),
        [(n, np.asarray(p._value)) for n, p in jm.named_parameters()])
    return jm, tm


def _record_engines(monkeypatch, module, f32_config=None):
    """Keep every engine `module.ServingEngine` builds; with
    `f32_config`, its EngineConfig computes in the model's f32."""
    made = []
    base = module.ServingEngine

    class Recording(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(module, "ServingEngine", Recording)
    if f32_config is not None:
        monkeypatch.setattr(module, "EngineConfig",
                            functools.partial(f32_config, dtype=None))
    return made


def test_shared_prefix_phase_tracks_the_jax_phase(pair, monkeypatch):
    jm, tm = pair
    j_engines = _record_engines(monkeypatch, jax_serving,
                                jax_serving.EngineConfig)
    j = jax_bench.shared_prefix_phase(jm, False)
    t_engines = _record_engines(monkeypatch, port_serving)
    t = bench_serving.shared_prefix_phase(tm, False, device="cpu",
                                          dtype=None)
    assert t["_streams"] == j["_streams"]
    assert all(len(s) == 4 for s in t["_streams"])
    assert t["prefix_streams_identical"] and j["prefix_streams_identical"]
    for key in ("serving.prefill_tokens_saved",
                "serving.prefill_tokens_offered", "serving.prefix_hit_rate",
                "serving.prefix_tokens_recomputed_per_request",
                "prefix_hits", "prefix_requests"):
        assert t[key] == j[key], key
    assert t["prefix_hits"] > 0 and t["prefix_lookups"] == 16
    # the warm engines (the first built on each side) end alike
    jw, tw = j_engines[0].prefix_stats(), t_engines[0].prefix_stats()
    for key in ("lookups", "hits", "tokens_saved", "tokens_offered"):
        assert tw[key] == jw[key], key


def test_serve_level_2_tracks_the_jax_level(pair):
    jm, tm = pair
    ekw = dict(max_slots=8, block_size=8, prefill_chunk=16,
               max_model_len=48, dtype=None)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 512, (12 + (i % 5) - 2,)).tolist()
               for i in range(8)]
    jeng = jax_serving.ServingEngine(jm, **ekw)
    teng = port_serving.ServingEngine(tm, device="cpu", **ekw)
    handles = {"jax": [], "port": []}
    for side, eng in (("jax", jeng), ("port", teng)):
        submit = eng.submit

        def keep(*a, _submit=submit, _side=side, **kw):
            h = _submit(*a, **kw)
            handles[_side].append(h)
            return h
        eng.submit = keep
    _, js = jax_bench.serve_level(jeng, prompts, 24, 2)
    _, ts = bench_serving.serve_level(teng, prompts, 24, 2)
    assert ts["requests"] == js["requests"] == 4
    jstreams = [list(h.output_tokens) for h in handles["jax"]]
    tstreams = [h.output_tokens for h in handles["port"]]
    assert tstreams == jstreams
    assert [len(s) for s in tstreams] == [24] * 4 and ts["min_tokens"] == 24
    assert ts["captures"] == 0 and ts["decode_steps"] > 0
    for key in ("ttft_p50_ms", "ttft_p99_ms", "tpot_p50_ms", "tpot_p99_ms"):
        assert ts[key] > 0


def test_main_cpu_writes_one_valid_record_per_owned_metric(tmp_path):
    path = tmp_path / "serving.jsonl"
    assert bench_serving.main(["--cpu", "--telemetry", str(path)]) == 0
    records = [json.loads(line) for line in open(path) if line.strip()]
    bench = [r for r in records if r["kind"] == "bench"]
    owned = [m for m in SERVING_BENCH_METRICS
             if not m.startswith(("serving.rated_", "fleet."))]
    assert [r["metric"] for r in bench] == owned
    for r in bench:
        assert validate_step_record(r) == [] and validate_record(r) == []
        assert r["value"] is not None and r["device"] == "cpu"
    values = {r["metric"]: r["value"] for r in bench}
    assert values["serving.prefix_hit_rate"] > 0
    assert values["serving.requests"] == 2 * (1 + 2 + 4 + 8)
