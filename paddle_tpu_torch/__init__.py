"""paddle_tpu_torch — the PyTorch + CUDA port of `paddle_tpu`.

The JAX package stays the reference; this package is its counterpart for
an NVIDIA H100, ported slice by slice along the system's main paths:
GPT served through the continuous-batching engine over the paged KV
cache (the paged attention kernels, `ops/paged_attention.py`), the GPT
training step under bf16 amp (the flash attention forward and
backward, `ops/flash_attention.py`, and the residual-add + LayerNorm,
`ops/layernorm.py`) with the JAX package's training options, up to
GPT-3 1.3B with its optimizer states offloaded to the host, decoding
with `generate` and weight-only
int8 (`ops/decode_attention.py`, `ops/int8_matvec.py`), and the
mixture-of-experts training step (the dispatch and combine kernels,
`moe/kernels.py`), each kernel written by hand in CUDA, and the
hybrid-parallel training step over a mesh of ranks. The serving
engine runs as a server with the JAX engine's HTTP front, metrics and
request traces, and samples with jax.random's own draws.

Layout mirrors the JAX package so a reader finds each counterpart:

- `device`        — default-device resolution (CUDA, or raise);
- `amp`           — auto_cast with the JAX package's white/black lists;
- `nn`            — Linear ([in, out] weights), Embedding, LayerNorm,
                    Dropout, tanh-gelu, fused residual-add + LayerNorm,
                    cross entropy, gradient clipping (`nn.clip`);
- `models.gpt`    — GPTConfig presets, the GPT decoder and its loss;
- `optimizer`     — SGD, Momentum, Adam and AdamW with the JAX update
                    rule (groups, L1/L2 decay, f32 masters, state
                    dicts) and the 15 learning-rate schedules (`lr`);
- `distributed`   — the process group and the (dp, pp, mp, sp, ep)
                    DeviceMesh, the collectives (eager and per mesh
                    axis, under a deadline), the tensor-parallel
                    layers, the hybrid-parallel `ShardedTrainStep`
                    (ZeRO-1/2, ring and Ulysses attention over sp),
                    DataParallel, the collective half of `fleet`, the
                    launcher; per-block recompute and the
                    host-offloaded `OffloadTrainStep`;
- `flags`         — the runtime flags the port reads (`use_fused_ce`);
- `jit`           — TrainStep (one eager step: loss, backward, update)
                    and CapturedStep (a fixed-shape step captured as a
                    CUDA graph and replayed: the engine's decode and
                    prefill, `generate`'s token step);
- `telemetry`     — peak FLOP/s and bytes/s and the train FLOPs per
                    token (MFU), the step, bench, serving and kernelbench
                    records and their JSONL sink, the flight recorder,
                    the health monitor and hang watchdog (behind
                    `TrainStep(health=)`), request traces, the
                    Prometheus text and the training MetricsServer, the
                    memory and kernel observatories, the capture records
                    (compile_obs);
- `tools`         — `bench_serving` (the serving bench's legs),
                    `healthwatch` and `memwatch` (offline replays of
                    the health rules), `serve_13b_w8a16`, `dist_drill`
                    (the hybrid-parallel step as rank processes),
                    `chaos_drill` (kill mid-save and resume);
- `convert`       — load JAX-package parameters into a port model;
- `ops`           — the kernel registry, the nvcc/ctypes build step, the
                    attention entry points (ring and Ulysses attention
                    among them), every kernel with its plain version,
                    and the fused projection + cross entropy
                    (`fused_ce`);
- `serving`       — BlockPool/PrefixIndex/PagedKVCache, the scheduler,
                    admission control, `ServingEngine` (greedy and
                    sampled decoding, the serve loop with drain and warm
                    restart) and `ServingHTTPServer`;
- `prng`          — jax.random's threefry2x32 PRNG (keys, bits,
                    uniform, gumbel, categorical) in torch;
- `monitor`       — the stat registry (counters, gauges, histograms)
                    the engine's `serving.*` metrics live in;
- `resilience`    — failure classification and retry, step checkpoints
                    (a piece a rank, atomic commit, restore past
                    corruption), preemption and auto-resume (the
                    `resilience=` hook), cross-layout restore, chaos;
- `generation`    — `run_generate` (greedy, sampling, beam search);
- `quant`         — weight-only int8 linears and embeddings;
- `moe`           — the router, MoEFFN, GPTMoE and the dispatch and
                    combine kernels with their plain versions.

Entry points run on CUDA unless the caller passes `device="cpu"`; with
no GPU and no explicit CPU request they raise. This package never
imports `jax` or `paddle_tpu`.
"""
from .device import resolve_device, resolve_dtype

__all__ = ["resolve_device", "resolve_dtype"]
