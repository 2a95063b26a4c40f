"""Serving benchmark of the port: an offered-load sweep over the
continuous-batching engine (paddle_tpu_torch.serving), reported as
throughput at a fixed p99 TTFT/TPOT SLO — the port of the JAX package's
bench_serving.py, every function under its JAX name.

1. **single-request baseline** (`single_stream_baseline`) — `generate`
   serving the requests one at a time, median of 3 sequential sweeps ->
   `serving.single_stream_tokens_per_sec`. Each distinct prompt is
   served once before the sweeps, so every graph a length needs is
   captured before the clock starts (the sweeps capture nothing; the
   capture records say so).
2. **offered-load sweep** (`serve_level`) — the engine serves rising
   levels of concurrency (1, 2, 4, ... max_slots requests in flight, 2
   waves each so continuous batching rotates the slots). Each level
   reports aggregate tokens/s and TTFT/TPOT p50/p99 from the request
   handles, the captures made inside it (none: the warm-up captured the
   prefill and decode graphs) and the kernel launches it made.
3. **headline** — the highest-throughput level whose p99s meet the SLO
   is `serving.throughput_tokens_per_sec`; `serving.throughput_vs_single`
   is the continuous-batching win over the single-request baseline.
4. **shared-prefix sweep** (`shared_prefix_phase`) — templated requests
   (>= 50 % shared tokens) through a warm prefix-cache engine vs a
   cold-cache control; the streams must be identical.
5. **tracing cost** (`trace_overhead_phase`) — the rated level through a
   tracing-off and a tracing-on engine, best of 2 waves each:
   `serving.trace_overhead_frac`.

Every tracked scalar is a typed kind=bench record
(telemetry.sink.SERVING_BENCH_METRICS) in the `--telemetry` JSONL, with
the engine's capture records (kind=compile) beside them.

The card configuration is the JAX tool's accelerator configuration:
GPT-3 125M with weight-only int8 linears (quantized before the baseline,
so the ratio isolates batching), 16 slots, block 16, chunk 128,
max_model_len 512, prompts of 126-130 tokens, 128 new tokens, levels 1
to 16, and the tool's declared SLO of 2000 ms p99 TTFT and 20 ms p99
TPOT (declarations, not readings). `--cpu` (`--device cpu`) keeps the
JAX tool's CPU configuration.

    python -m paddle_tpu_torch.tools.bench_serving            # the card
    python -m paddle_tpu_torch.tools.bench_serving --cpu
    python -m paddle_tpu_torch.tools.bench_serving --cpu --fleet 2

**Fleet mode** (`--fleet N`) benches the tier above the engine: the
same concurrent wave through a `FleetRouter` over N in-process replicas
vs over 1 (`fleet.rated_throughput_tokens_per_sec`,
`fleet.scaling_efficiency`), plus the shared-prefix affinity leg: every
hit on one replica, streams equal to a cold single engine's.

Exit codes: 0 ok; 4 when the shared-prefix streams diverge, when
`--check-vs-single` is given and the measured ratio falls below it, or
when the fleet leg's affinity/identity invariants fail.
"""
import argparse
import json
import sys
import threading
import time

import numpy as np

from .. import monitor


def _percentile(vals, q):
    return float(np.percentile(vals, q)) if vals else None


def _r2(v):
    return None if v is None else round(v, 2)


def _fmt(v):
    return "n/a" if v is None else f"{v:.1f}"


def _launches():
    from ..ops.kernel_registry import kernels
    return {k.name: k.launches for k in kernels()}


def serve_level(engine, prompts, max_new, level):
    """Offer `level` concurrent streams (two waves, 2*level requests)
    through the engine; returns (aggregate tok/s, stats dict). Besides
    the JAX tool's stats: the fewest tokens a request got, the captures
    made inside the level, the engine's decode steps and prefill chunks
    and the kernel launches of the level."""
    from ..serving import SamplingParams

    reqs = [prompts[i % len(prompts)] for i in range(2 * level)]
    captures0 = len(engine._graphs.records)
    steps0 = (engine.decode_steps, engine.prefill_chunks)
    launches0 = _launches()
    t0 = time.perf_counter()
    handles = [engine.submit(p, SamplingParams(max_new_tokens=max_new))
               for p in reqs]
    engine.run_until_idle()
    dt = max(1e-9, time.perf_counter() - t0)
    n_tokens = sum(len(h.output_tokens) for h in handles)
    ttft = [h.stats["ttft_ms"] for h in handles
            if h.stats["ttft_ms"] is not None]
    tpot = [h.stats["tpot_ms"] for h in handles
            if h.stats["tpot_ms"] is not None]
    launches = {k: n - launches0[k] for k, n in _launches().items()}
    return n_tokens / dt, {
        "level": level,
        "requests": len(handles),
        "tokens_per_sec": round(n_tokens / dt, 1),
        "ttft_p50_ms": _percentile(ttft, 50),
        "ttft_p99_ms": _percentile(ttft, 99),
        "tpot_p50_ms": _percentile(tpot, 50),
        "tpot_p99_ms": _percentile(tpot, 99),
        "min_tokens": min(len(h.output_tokens) for h in handles),
        "captures": len(engine._graphs.records) - captures0,
        "decode_steps": engine.decode_steps - steps0[0],
        "prefill_chunks": engine.prefill_chunks - steps0[1],
        "launches": {k: n for k, n in launches.items() if n},
    }


def shared_prefix_phase(model, on_card, seed=0, n_requests=None,
                        device=None, dtype="bfloat16"):
    """Shared-prefix sweep: N requests over 2 prompt templates through a
    WARM prefix-cache engine vs a cold-cache control engine.

    >= 50 % of each prompt is a shared template; both engines are warmed
    with one short request per template (the same warm-up both sides, so
    the comparison isolates caching, not capture), then the same seeded
    wave runs through both. Reports TTFT p50/p99 (warm), the warm-vs-cold
    p50 speedup, hit rate, tokens saved / offered / recomputed per
    request, and whether the token streams are IDENTICAL between the two
    engines. Deterministic per seed: prompts, schedule and hit
    accounting come from the seeded generator over a single-threaded
    engine loop."""
    from ..serving import EngineConfig, SamplingParams, ServingEngine

    if on_card:
        tpl_len, tail_len, max_new = 96, 32, 16
        n_requests = n_requests or 32
        kw = dict(max_slots=8, block_size=16, prefill_chunk=32,
                  max_model_len=256)
    else:
        tpl_len, tail_len, max_new = 24, 8, 4
        n_requests = n_requests or 16
        kw = dict(max_slots=4, block_size=8, prefill_chunk=8,
                  max_model_len=64)
    vocab = model.config.vocab_size
    rs = np.random.RandomState(seed)
    templates = [rs.randint(0, vocab, (tpl_len,)).tolist()
                 for _ in range(2)]
    prompts = [templates[i % 2]
               + rs.randint(0, vocab, (tail_len,)).tolist()
               for i in range(n_requests)]

    def run(enable):
        engine = ServingEngine(model, config=EngineConfig(
            enable_prefix_cache=enable, device=device, dtype=dtype, **kw))
        # same warm-up both sides: captures the steps and (warm engine
        # only) seeds the index with each template's blocks
        for tpl in templates:
            engine.submit(tpl, SamplingParams(max_new_tokens=2))
        engine.run_until_idle()
        before = engine.prefix_stats()
        t0 = time.perf_counter()
        handles = [engine.submit(p, SamplingParams(max_new_tokens=max_new))
                   for p in prompts]
        engine.run_until_idle()
        dt = max(1e-9, time.perf_counter() - t0)
        streams = [h.output_tokens for h in handles]
        ttft = [h.stats["ttft_ms"] for h in handles
                if h.stats["ttft_ms"] is not None]
        after = engine.prefix_stats()
        stats = {k: after[k] - before[k]
                 for k in ("tokens_saved", "tokens_offered", "hits",
                           "lookups")}
        return streams, ttft, stats, dt

    warm_streams, warm_ttft, stats, warm_dt = run(True)
    cold_streams, cold_ttft, _, cold_dt = run(False)
    identical = warm_streams == cold_streams
    offered = stats["tokens_offered"]
    saved = stats["tokens_saved"]
    warm_p50 = _percentile(warm_ttft, 50)
    cold_p50 = _percentile(cold_ttft, 50)
    return {
        "serving.prefix_hit_rate":
            round(saved / offered, 4) if offered else 0.0,
        "serving.prefill_tokens_saved": saved,
        "serving.prefill_tokens_offered": offered,
        "serving.prefix_ttft_p50_ms": _r2(warm_p50),
        "serving.prefix_ttft_p99_ms": _r2(_percentile(warm_ttft, 99)),
        "serving.prefix_ttft_speedup":
            round(cold_p50 / warm_p50, 3)
            if warm_p50 and cold_p50 else None,
        "serving.prefix_tokens_recomputed_per_request":
            round((offered - saved) / len(prompts), 2),
        "prefix_streams_identical": identical,
        "prefix_requests": len(prompts),
        "prefix_hits": stats["hits"],
        "prefix_lookups": stats["lookups"],
        "prefix_cold_ttft_p50_ms": _r2(cold_p50),
        "prefix_warm_s": round(warm_dt, 3),
        "prefix_cold_s": round(cold_dt, 3),
        "_streams": warm_streams,
    }


def trace_overhead_phase(model, ecfg, prompts, max_new, level):
    """Tracer-cost leg at the RATED level: the same offered-load wave
    through a tracing-off then a tracing-on engine, best of 2 waves per
    side. Each engine is warmed first with a short greedy request, which
    captures its prefill and decode graphs, so no capture lands in a
    timed wave (`trace_captures_timed` counts any that did).

    `serving.trace_overhead_frac` = (tps_off - tps_on) / tps_off,
    floored at 0 (negative deltas are host noise)."""
    from ..serving import SamplingParams, ServingEngine

    captured = []

    def best_tps(enable):
        ecfg.enable_tracing = enable
        engine = ServingEngine(model, config=ecfg)
        engine.submit(prompts[0][:4], SamplingParams(max_new_tokens=2))
        engine.run_until_idle()      # warm: the captures out of the clock
        best = 0.0
        for _ in range(2):
            tps, stats = serve_level(engine, prompts, max_new, level)
            captured.append(stats["captures"])
            best = max(best, tps)
        return best

    try:
        tps_off = best_tps(False)
        tps_on = best_tps(True)
    finally:
        ecfg.enable_tracing = True
    return {
        "serving.trace_overhead_frac":
            round(max(0.0, (tps_off - tps_on) / max(tps_off, 1e-9)), 4),
        "trace_on_tokens_per_sec": round(tps_on, 1),
        "trace_off_tokens_per_sec": round(tps_off, 1),
        "trace_captures_timed": sum(captured),
    }


def single_stream_baseline(model, prompts, max_new, reps=3, device=None,
                           dtype="bfloat16", stats=None):
    """The predictor serving model: one request at a time through
    `generate`, median of `reps` sequential sweeps. Each distinct prompt
    is served once first (the JAX tool warms one; here a model keeps the
    graphs of each prompt length it has served, so warming every length
    keeps all captures out of the sweeps). `stats`, when a dict, gets
    the capture records' counts: `captures_warm` and `captures_timed`
    (0 unless a sweep captured)."""
    import torch
    from ..generation import capture_records

    def serve(p):
        ids = torch.tensor([p], dtype=torch.long, device=device)
        out, _ = model.generate(ids, max_new_tokens=max_new, dtype=dtype,
                                device=device)
        float(out.sum().item())     # the sync

    for p in prompts:
        serve(p)
    warm = len(capture_records(model))
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for p in prompts:
            serve(p)
        runs.append(len(prompts) * max_new /
                    max(1e-9, time.perf_counter() - t0))
    if stats is not None:
        stats["captures_warm"] = warm
        stats["captures_timed"] = len(capture_records(model)) - warm
        stats["runs_tokens_per_sec"] = runs
    return sorted(runs)[len(runs) // 2]


def _device_kind(device):
    import torch
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"


def _configs(on_card):
    """(model config, engine kwargs, prompt_len, max_new, slo_ttft,
    slo_tpot) of the JAX tool: the accelerator configuration on the
    card, the CPU one otherwise."""
    from ..models.gpt import GPTConfig
    if on_card:
        return (GPTConfig.gpt3_125m(max_seq_len=1024, dropout=0.0),
                dict(max_slots=16, block_size=16, prefill_chunk=128,
                     max_model_len=512, weights="wo8"),
                128, 128, 2000.0, 20.0)
    return (GPTConfig(vocab_size=2048, hidden_size=256, num_layers=4,
                      num_heads=8, max_seq_len=128, dropout=0.0,
                      use_flash_attention=False),
            dict(max_slots=8, block_size=8, prefill_chunk=16,
                 max_model_len=48),
            12, 24, 60000.0, 250.0)


def fleet_phase(args, n_replicas):
    """Fleet-tier leg: rated throughput + scaling efficiency through a
    FleetRouter over N in-process replicas (each replica owns its own
    identically-seeded model), plus the shared-prefix affinity proof.
    Owns the fleet.* SERVING_BENCH_METRICS rows."""
    from ..fleet import FleetRouter, InProcessReplica
    from ..models.gpt import GPTConfig, GPTForPretraining
    from ..quant import quantize_for_decode
    from ..serving import EngineConfig, SamplingParams, ServingEngine
    from ..telemetry import JsonlSink, make_bench_record

    device = args.device
    on_card = device is None or str(device).startswith("cuda")
    if on_card:
        mcfg = GPTConfig.gpt3_125m(max_seq_len=1024, dropout=0.0)
        ekw = dict(max_slots=16, block_size=16, prefill_chunk=128,
                   max_model_len=512, weights="wo8")
        prompt_len, max_new, tpl_len, tail_len = 128, 64, 96, 32
    else:
        # small enough that N replicas + a cold control build inside a
        # CPU budget; the fleet rows measure SCALING, not the engine
        mcfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                         num_heads=4, max_seq_len=128, dropout=0.0,
                         use_flash_attention=False)
        ekw = dict(max_slots=4, block_size=8, prefill_chunk=8,
                   max_model_len=64)
        prompt_len, max_new, tpl_len, tail_len = 12, 12, 16, 6
    block_size = ekw["block_size"]
    vocab = mcfg.vocab_size

    def build_engine(engine_id, enable_prefix=True):
        m = GPTForPretraining(mcfg, device=device, seed=args.seed)
        if ekw.get("weights") == "wo8":
            quantize_for_decode(m)
        e = ServingEngine(m, config=EngineConfig(
            engine_id=engine_id, enable_prefix_cache=enable_prefix,
            device=device, **ekw))
        # warm NOW: the captures land sequentially at build time,
        # outside the timed waves
        e.submit(list(range(2, 2 + block_size)),
                 SamplingParams(max_new_tokens=2))
        e.run_until_idle()
        return e

    engines = [build_engine(i) for i in range(n_replicas)]
    replicas = [InProcessReplica(f"b{i}", e)
                for i, e in enumerate(engines)]
    for e in engines:
        e.start()

    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, vocab, (prompt_len + (i % 5) - 2,)).tolist()
               for i in range(8)]

    def wave(router, n_requests, wave_prompts):
        results = [None] * n_requests
        errors = []

        def worker(i):
            try:
                results[i] = router.generate(
                    wave_prompts[i % len(wave_prompts)],
                    {"max_new_tokens": max_new})
            except Exception as e:      # noqa: BLE001 — surfaced below
                errors.append(f"{type(e).__name__}: {e}")

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_requests)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        dt = max(1e-9, time.perf_counter() - t0)
        if errors:
            raise RuntimeError(f"fleet wave failed: {errors[:3]}")
        return sum(len(r) for r in results) / dt, results

    try:
        # single-replica rated baseline through the SAME router
        # machinery, so the ratio isolates fleet scaling; best of 2
        single_router = FleetRouter(replicas[:1], block_size=block_size,
                                    probe_interval_s=0.05)
        n_single = 2 * ekw["max_slots"]
        single_tps = max(wave(single_router, n_single, prompts)[0]
                         for _ in range(2))
        router = FleetRouter(replicas, block_size=block_size,
                             probe_interval_s=0.05)
        fleet_tps = max(
            wave(router, n_replicas * n_single, prompts)[0]
            for _ in range(2))
        efficiency = fleet_tps / max(n_replicas * single_tps, 1e-9)
        print(f"# fleet rated: {fleet_tps:.1f} tok/s over {n_replicas} "
              f"replicas vs {single_tps:.1f} single "
              f"(efficiency {efficiency:.3f})", file=sys.stderr)

        # shared-prefix affinity leg: every prompt opens with the same
        # template (>= 1 full block), so rendezvous prefix affinity must
        # land ALL of them on one replica where the radix index is warm
        template = rs.randint(0, vocab, (tpl_len,)).tolist()
        shared = [template + rs.randint(0, vocab, (tail_len,)).tolist()
                  for _ in range(8)]
        before = [e.prefix_stats() for e in engines]
        router.generate(shared[0], {"max_new_tokens": 2})   # warm the
        _, warm_streams = wave(router, len(shared), shared)  # affine one
        after = [e.prefix_stats() for e in engines]
        hits = [a["hits"] - b["hits"] for a, b in zip(after, before)]
        saved = sum(a["tokens_saved"] - b["tokens_saved"]
                    for a, b in zip(after, before))
        offered = sum(a["tokens_offered"] - b["tokens_offered"]
                      for a, b in zip(after, before))
        hit_rate = saved / offered if offered else 0.0
        affine = int(np.argmax(hits)) if any(hits) else None
        concentrated = sum(hits) > 0 and max(hits) == sum(hits)
        print(f"# fleet shared-prefix: hit_rate {round(hit_rate, 4)}, "
              f"hits per replica {hits} (affine b{affine}, "
              f"concentrated={concentrated})", file=sys.stderr)
    finally:
        for e in engines:
            e.stop()

    # the cold reference: a fresh prefix-cache-OFF single engine must
    # produce identical streams — affinity is placement, and placement
    # must be invisible in the output
    control = build_engine(1000 + n_replicas, enable_prefix=False)
    refs = []
    for p in shared:
        h = control.submit(p, SamplingParams(max_new_tokens=max_new))
        control.run_until_idle()
        refs.append(list(h.output_tokens))
    identical = [list(s) for s in warm_streams] == refs

    kind = _device_kind(device)
    tsink = JsonlSink(args.telemetry)
    summary = {
        "metric": "fleet.rated_throughput_tokens_per_sec",
        "value": round(fleet_tps, 1),
        "unit": "tokens/sec",
        "device": kind,
        "fleet.rated_throughput_tokens_per_sec": round(fleet_tps, 1),
        "fleet.scaling_efficiency": round(efficiency, 4),
        "fleet.replicas": n_replicas,
        "single_replica_tokens_per_sec": round(single_tps, 1),
        "serving.prefix_hit_rate": round(hit_rate, 4),
        "prefix_hits_per_replica": hits,
        "prefix_affine_replica": affine,
        "prefix_hits_concentrated": concentrated,
        "prefix_streams_identical": identical,
    }
    for name, unit in (("fleet.rated_throughput_tokens_per_sec",
                        "tokens/sec"),
                       ("fleet.scaling_efficiency", "frac"),
                       ("fleet.replicas", "replicas")):
        tsink.write(make_bench_record(name, summary[name], unit=unit,
                                      device=kind))
    tsink.close()
    print(json.dumps(summary))

    rc = 0
    if not identical:
        print("FAIL: fleet shared-prefix streams diverged from the "
              "cold single-engine control", file=sys.stderr)
        rc = 4
    if hit_rate <= 0:
        print("FAIL: fleet-wide prefix hit rate is zero — affinity "
              "routing never landed a prompt on its warm replica",
              file=sys.stderr)
        rc = 4
    elif not concentrated:
        print(f"FAIL: prefix hits scattered across replicas {hits} — "
              "rendezvous affinity is not concentrating the shared "
              "template", file=sys.stderr)
        rc = 4
    return rc


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="the CPU configuration on the CPU (--device cpu)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--fleet", type=int, default=None, metavar="N",
                    help="fleet mode: bench a FleetRouter over N "
                         "in-process replicas (owns the fleet.* rows); "
                         "skips the single-engine sweep")
    ap.add_argument("--telemetry", default="serving_telemetry.jsonl")
    ap.add_argument("--slo-ttft-ms", type=float, default=None,
                    help="p99 TTFT SLO (default: config-dependent)")
    ap.add_argument("--slo-tpot-ms", type=float, default=None,
                    help="p99 TPOT SLO (default: config-dependent)")
    ap.add_argument("--check-vs-single", type=float, default=None,
                    metavar="R", help="exit 4 unless engine throughput "
                    ">= R x the single-request baseline")
    args = ap.parse_args(argv)
    if args.cpu:
        args.device = "cpu"
    if args.fleet is not None and args.fleet < 1:
        ap.error("--fleet needs N >= 1")
    return args


def run(args):
    """The single-engine bench -> (exit code, summary dict)."""
    from ..models.gpt import GPTForPretraining
    from ..quant import quantize_for_decode
    from ..serving import EngineConfig, ServingEngine
    from ..telemetry import JsonlSink, make_bench_record
    from ..telemetry.sink import SERVING_BENCH_METRICS

    device = args.device
    on_card = device is None or str(device).startswith("cuda")
    kind = _device_kind(device)
    mcfg, ekw, prompt_len, max_new, slo_ttft, slo_tpot = _configs(on_card)
    slo_ttft = args.slo_ttft_ms or slo_ttft
    slo_tpot = args.slo_tpot_ms or slo_tpot
    ecfg = EngineConfig(device=device, **ekw)
    model = GPTForPretraining(mcfg, device=device, seed=args.seed)
    if ecfg.weights == "wo8":
        # quantize BEFORE the single-stream baseline so the ratio
        # isolates continuous batching: both sides serve wo8 weights
        # (the engine's own quantize call is then a no-op)
        quantize_for_decode(model)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, mcfg.vocab_size,
                          (prompt_len + (i % 5) - 2,)).tolist()
               for i in range(8)]
    # the engine's counters are process-wide: the run reads deltas
    preempt0 = monitor.get("serving.preemptions", 0)

    tsink = JsonlSink(args.telemetry)
    single = {}
    single_tps = single_stream_baseline(model, prompts[:3], max_new,
                                        device=device, dtype=ecfg.dtype,
                                        stats=single)
    print(f"# single stream: {single_tps:.1f} tok/s (captures: "
          f"{single['captures_warm']} warm, {single['captures_timed']} "
          "in the sweeps)", file=sys.stderr)

    engine = ServingEngine(model, config=ecfg, sink=tsink)
    # warm-up: capture prefill + decode outside the timed levels
    engine.submit(prompts[0][:prompt_len], max_new_tokens=4)
    engine.run_until_idle()
    warm_captures = len(engine._graphs.records)
    levels = []
    level = 1
    while level <= ecfg.max_slots:
        _, stats = serve_level(engine, prompts, max_new, level)
        levels.append(stats)
        print(f"# level {level}: {stats['tokens_per_sec']} tok/s "
              f"ttft p50/p99 {_fmt(stats['ttft_p50_ms'])}/"
              f"{_fmt(stats['ttft_p99_ms'])}ms tpot p50/p99 "
              f"{_fmt(stats['tpot_p50_ms'])}/{_fmt(stats['tpot_p99_ms'])}"
              f"ms", file=sys.stderr)
        level *= 2

    prefix = shared_prefix_phase(model, on_card, device=device,
                                 dtype=ecfg.dtype)
    print(f"# shared-prefix: hit_rate {prefix['serving.prefix_hit_rate']} "
          f"ttft_p50 {_fmt(prefix['serving.prefix_ttft_p50_ms'])}ms "
          f"(cold {_fmt(prefix['prefix_cold_ttft_p50_ms'])}ms, "
          f"speedup {prefix['serving.prefix_ttft_speedup']}x), "
          f"saved {prefix['serving.prefill_tokens_saved']}/"
          f"{prefix['serving.prefill_tokens_offered']} tokens, "
          f"streams_identical={prefix['prefix_streams_identical']}",
          file=sys.stderr)

    within = [s for s in levels
              if s["ttft_p99_ms"] is not None
              and s["ttft_p99_ms"] <= slo_ttft
              and (s["tpot_p99_ms"] is None
                   or s["tpot_p99_ms"] <= slo_tpot)]
    best = max(within or levels, key=lambda s: s["tokens_per_sec"])

    overhead = trace_overhead_phase(model, ecfg, prompts, max_new,
                                    best["level"])
    print(f"# trace overhead: {overhead['serving.trace_overhead_frac']} "
          f"(on {overhead['trace_on_tokens_per_sec']} vs off "
          f"{overhead['trace_off_tokens_per_sec']} tok/s at level "
          f"{best['level']})", file=sys.stderr)

    summary = {
        "metric": "serving.throughput_tokens_per_sec",
        "value": best["tokens_per_sec"],
        "unit": "tokens/sec",
        "device": kind,
        "slo_ttft_ms": slo_ttft,
        "slo_tpot_ms": slo_tpot,
        "slo_met": bool(within),
        "best_level": best["level"],
        "serving.single_stream_tokens_per_sec": round(single_tps, 1),
        "serving.throughput_vs_single":
            round(best["tokens_per_sec"] / max(single_tps, 1e-9), 3),
        "serving.ttft_p50_ms": _r2(best["ttft_p50_ms"]),
        "serving.ttft_p99_ms": _r2(best["ttft_p99_ms"]),
        "serving.tpot_p50_ms": _r2(best["tpot_p50_ms"]),
        "serving.tpot_p99_ms": _r2(best["tpot_p99_ms"]),
        "serving.requests": sum(s["requests"] for s in levels),
        "serving.preemptions": self_preempt(engine, preempt0),
        "serving.kv_block_utilization_peak":
            round(engine.kv_peak_utilization, 4),
        "levels": levels,
        "single_stream": single,
        "warm_captures": warm_captures,
        "num_layers": mcfg.num_layers,
        "max_new_tokens": max_new,
    }
    summary.update({k: v for k, v in prefix.items()
                    if not k.startswith("_")})
    summary.update(overhead)

    units = {"tokens_per_sec": "tokens/sec", "_ms": "ms",
             "vs_single": "x", "speedup": "x", "hit_rate": "frac",
             "recomputed": "tokens", "tokens_saved": "tokens",
             "tokens_offered": "tokens", "requests": "requests",
             "preemptions": "preemptions", "utilization": "frac",
             "overhead": "frac"}

    def unit_of(name):
        for suffix, u in units.items():
            if suffix in name:
                return u
        return "count"

    values = dict(summary)
    values["serving.throughput_tokens_per_sec"] = summary["value"]
    for name in SERVING_BENCH_METRICS:
        if name.startswith("serving.rated_") or name.startswith("fleet."):
            # the rated-load SLO rows belong to the resilience drill's
            # leg and the fleet.* rows to --fleet mode
            continue
        v = values.get(name)
        extra = {}
        if v is None:
            # null values must carry their reason (sink schema)
            extra["error"] = ("no measurement: degenerate level "
                              "(every request finished with <2 tokens)")
        tsink.write(make_bench_record(name, v, unit=unit_of(name),
                                      device=kind, **extra))
    tsink.close()

    print(json.dumps(summary))
    print(f"# device={kind} engine {best['tokens_per_sec']:.0f} tok/s at "
          f"level {best['level']} vs single {single_tps:.0f} tok/s "
          f"({summary['serving.throughput_vs_single']}x), "
          f"slo_met={summary['slo_met']}", file=sys.stderr)

    if not prefix["prefix_streams_identical"]:
        print("FAIL: shared-prefix streams diverged from the "
              "cold-cache control — prefix sharing corrupted a stream",
              file=sys.stderr)
        return 4, summary
    if args.check_vs_single is not None and \
            summary["serving.throughput_vs_single"] < args.check_vs_single:
        print(f"FAIL: throughput_vs_single "
              f"{summary['serving.throughput_vs_single']} < required "
              f"{args.check_vs_single}", file=sys.stderr)
        return 4, summary
    return 0, summary


def self_preempt(engine, since=0):
    """Preemptions since `since`: the counter is process-wide, so a run
    reads it as a delta from its own start."""
    return int(monitor.get("serving.preemptions", 0) - since)


def main(argv=None):
    args = parse_args(argv)
    if args.fleet:
        return fleet_phase(args, args.fleet)
    return run(args)[0]


if __name__ == "__main__":
    sys.exit(main())
