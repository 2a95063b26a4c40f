"""Continuous-batching serving engine over the paged KV cache.

The port of paddle_tpu/serving/engine.py. A long-lived engine holds a
fixed batch of decode SLOTS; requests flow through them at token
granularity (scheduler.py) with their K/V in the shared block arenas
(kv_cache.py). Every `step()` reaps cancelled and expired requests,
admits waiting ones, runs at most one chunked-prefill dispatch and one
decode batch; `start()`/`stop()` run the steps on a background thread,
`drain()` finishes the accepted work with admission closed, and a failed
step warm-restarts the engine (fresh arenas, in-flight requests
replayed) or, when the failure is a programming error, fails the
requests it hit.

Numerics: the per-layer math is the JAX engine's `block_step` — the same
ln1/project_qkv/out_proj/_add_ln2/mlp/lm_head modules — with attention
through the paged kernels (`ops.paged_attention`): on the card their
CUDA kernels, on the CPU their plain versions, which copy the JAX
gather+dense fallbacks. Token selection is the JAX engine's `select`,
operation by operation: temperature, the top-k order statistic, the
top-p mask over the stable descending order, and a categorical draw with
the key fold_in(request key, token index) from `prng`, the port's
jax.random — so a sampled stream is independent of its batch and the
same as the JAX engine's. A decode batch whose slots are all greedy
takes the greedy program (argmax, no sort, no draw), as the JAX engine
dispatches its greedy-only variant. In f32 on the CPU the streams, greedy
and sampled, are token-identical to the JAX engine's on the same
weights.

Device state: the arenas are updated in place (`index_put_`). The JAX
engine compiles its decode steps (sampling and greedy) and its prefill
chunk into XLA programs; here each is captured once as a CUDA graph
(`jit.CapturedStep`) over static device buffers and replayed: a step
copies its packed int32 inputs from one pinned host buffer into the
step's static device buffer, replays, and copies the token and logp
back. The position a prefill chunk starts at is device data (the
`flash_prefill_chunk` kernel reads it from that buffer), so one graph
serves every chunk: one for greedy chunks and one for sampled ones, as
for decode. `_decode_step` and `_prefill_chunk` stay the seams tests
replace to inject faults; the graphs live inside them. Each capture is
a kind=compile record on the engine's sink (family `decode`,
`decode_greedy` or `prefill`, the signature, capture ms, the graph
pool's bytes), as the JAX engine's compile observatory records a
compile; a warm restart's new arenas change the key (`arenas` in the
signature), so the next step recaptures and its record names the cause.
On the CPU the same step bodies run eagerly over the same buffers.
Donation has no counterpart (the arenas are updated in place).

Weight-only int8 (`weights="wo8"`) quantizes the caller's model in
place with `quant.quantize_for_decode` (linears) before the compute-dtype
copy is made, as the JAX engine does, so the int8 codes come from the
model's own weights and never from bf16-rounded ones. A model quantized
beforehand with `quantize_weights_int8(model, embeddings=True)` serves
its tied head through the `int8_matvec` kernel on the card.

Metrics: `serving.*` counters, gauges and the ttft/tpot/queue-wait
histograms on the port's monitor registry, under the JAX engine's names
(scrape them from the HTTP front, serving/http.py); per-request span
timelines (telemetry.reqtrace) ride the attached sink as kind=reqtrace
records, with the slowest-K exemplars on `GET /traces`.

Memory: every engine builds a memory observatory (telemetry/mem_obs)
over the CUDA caching allocator. It tags the serving copy's parameters
and buffers as `params` and the KV arenas as `kv`, samples the ledger
every `mem_sample_every` steps into kind=memsnap records, gauges
`serving.mem_headroom_bytes`, sheds at `submit` with
`MemoryPressureError` once a declared `hbm_budget_mb` is used up, and
writes an OOM postmortem before a warm restart rebuilds the arenas. Not
ported yet: `EngineConfig.from_inference_config`.
"""
import copy
import itertools
import threading
import time
import traceback

import numpy as np
import torch

from .. import monitor, prng
from ..device import resolve_device, resolve_dtype
from ..jit import CapturedStep
from ..ops.paged_attention import flash_prefill_chunk, paged_decode_attention
from ..quant import quantize_for_decode
from ..resilience.retry import classify_failure
from ..telemetry.compile_obs import signature_of
from ..telemetry.mem_obs import MemoryObservatory, is_oom, register_provider
from ..telemetry.reqtrace import RequestTracer
from ..telemetry.sink import make_serving_record
from .kv_cache import NULL_BLOCK, BlockPool, PagedKVCache, PrefixIndex
from .resilience import (AdmissionController, DeadlineExceededError,
                         EngineDeadError, EngineDrainingError,
                         EngineStoppedError, MemoryPressureError,
                         RequestCancelledError, ShedError, restart_backoff)
from .scheduler import (CANCELLED, EXPIRED, FAILED, FINISHED, PREFILL,
                        TERMINAL_STATES, Request, RequestHandle,
                        SamplingParams, Scheduler)

__all__ = ["EngineConfig", "ServingEngine"]

_NEG_INF = -1e30

_ENGINE_IDS = itertools.count()

# the per-slot selection inputs packed beside tokens/ctx/tables into a
# step's single host->device copy (int32 columns; temp and top_p are
# f32 bit patterns, the key words uint32 bit patterns)
_KNOBS = ("count", "top_k", "greedy", "key1", "key2", "temp", "top_p")


class EngineConfig:
    """Engine shape/capacity knobs, fixed at construction.

    `device=None` serves from the CUDA card (raises without one);
    `dtype=None` computes in the model's own dtype, "bfloat16" casts a
    copy of the weights and the KV arenas to bf16. `weights="wo8"`
    serves weight-only int8 linears (the model is quantized in place).
    `kv_memory_mb` sizes the KV pool by bytes when `num_blocks` is not
    given. `hbm_budget_mb` declares the device-memory budget the
    admission headroom is measured against (None: no budget, no memory
    shed); the memory ledger is sampled every `mem_sample_every`
    steps."""

    def __init__(self, max_slots=4, block_size=16, num_blocks=None,
                 max_model_len=None, prefill_chunk=32, dtype="bfloat16",
                 weights="native", kv_memory_mb=None, device=None,
                 max_queue=None, max_restarts=3, restart_backoff_s=1.0,
                 enable_prefix_cache=True, enable_tracing=True,
                 trace_exemplars=32, hbm_budget_mb=None,
                 mem_sample_every=1, engine_id=None):
        if weights not in ("native", "wo8"):
            raise ValueError(f"weights must be 'native' or 'wo8', got "
                             f"{weights!r}")
        self.max_slots = int(max_slots)
        self.block_size = int(block_size)
        self.num_blocks = num_blocks
        self.max_model_len = max_model_len
        self.prefill_chunk = int(prefill_chunk)
        self.dtype = dtype
        self.weights = weights
        self.kv_memory_mb = kv_memory_mb
        self.device = device
        # prefix-sharing KV cache (copy-on-write block reuse across
        # requests); off, the index is simply never consulted
        self.enable_prefix_cache = bool(enable_prefix_cache)
        # per-request tracing (telemetry.reqtrace): host-side span
        # bookkeeping at event boundaries, nothing on the device;
        # `trace_exemplars` bounds the slowest-K ring /traces serves
        self.enable_tracing = bool(enable_tracing)
        self.trace_exemplars = int(trace_exemplars)
        # resilience knobs: bounded waiting queue (None -> 16x slots),
        # warm-restart cap + backoff base for failed steps
        self.max_queue = 16 * self.max_slots if max_queue is None \
            else int(max_queue)
        self.max_restarts = int(max_restarts)
        self.restart_backoff_s = float(restart_backoff_s)
        # memory observatory: a declared budget (None -> the observatory
        # still samples, but nothing is shed) and the step cadence of
        # ledger snapshots
        self.hbm_budget_mb = hbm_budget_mb
        self.mem_sample_every = max(1, int(mem_sample_every))
        # explicit engine identity for multi-process fleets (the default
        # per-process counter collides across replicas)
        self.engine_id = None if engine_id is None else int(engine_id)


def _serving_copy(model, device, dtype):
    """The weights the engine computes with: `model` itself when it
    already lives on `device` in `dtype`, else a converted copy (the JAX
    engine casts inside its compiled step; here the cast is done once)."""
    p = next(model.parameters())
    if p.device == device and p.dtype == dtype:
        return model
    return copy.deepcopy(model).to(device=device, dtype=dtype)


def _block_step(block, h, attend, write):
    """One GPTBlock over the paged cache: the JAX engine's block_step
    (engine.py:324-335). K/V are written first, then attended."""
    y = block.ln1(h)
    q, k, v = block.attn.project_qkv(y)
    write(k, v)
    a = block.attn.out_proj(attend(q))
    y2, h2 = block._add_ln2(h, block.dropout(a))
    return h2 + block.dropout(block.mlp(y2))


def _greedy(last):
    """Greedy selection over f32 logits [B, V] -> (token, logp)."""
    lg = last.float()
    tok = torch.argmax(lg, dim=-1)
    logp = torch.log_softmax(lg, dim=-1).gather(1, tok[:, None])[:, 0]
    return tok, logp


def _select(last, keys, counts, temp, top_k, top_p, greedy,
            sampling=True):
    """Per-row token selection, the JAX engine's `select`
    (engine.py:337-374) with the knobs as tensors: last [B, V] logits,
    keys [B, 2] base keys, counts [B] token indices, temp/top_p [B] f32,
    top_k [B] int (0: off), greedy [B] bool. Returns (token, logp),
    logp from the untempered log-softmax. `sampling=False` skips the
    sorts and the draw (every row greedy)."""
    V = last.shape[-1]
    lg = last.float() / temp[:, None]
    greedy_tok = torch.argmax(lg, dim=-1)
    if not sampling:
        tok = greedy_tok
    else:
        # the k-th order statistic: only its value matters, so the
        # order of ties in this sort does not
        sorted_desc = torch.sort(lg, dim=-1, descending=True).values
        top_k = top_k.long()
        k_eff = torch.where(top_k > 0, top_k.clamp(1, V),
                            torch.full_like(top_k, V))
        kth = sorted_desc.gather(1, (k_eff - 1)[:, None])
        lg_s = torch.where(lg < kth, _NEG_INF, lg)
        # stable: equal logits keep index order, as jnp.argsort(-x)
        sorted_logits, sort_idx = torch.sort(lg_s, dim=-1, descending=True,
                                             stable=True)
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p[:, None]     # top token always kept
        masked = torch.where(keep, sorted_logits, _NEG_INF)
        lg_s = torch.empty_like(masked).scatter_(1, sort_idx, masked)
        sampled = prng.categorical(prng.fold_in(keys, counts), lg_s)
        tok = torch.where(greedy, greedy_tok, sampled)
    logp = torch.log_softmax(last.float(), dim=-1)
    return tok, logp.gather(1, tok[:, None])[:, 0]


def _static_knobs(params, key):
    """The fixed part of a request's `_KNOBS` row (all but the count),
    int32: made once at submit, since the host builds a row per slot
    every step."""
    return np.concatenate([
        np.array([params.top_k, int(params.greedy)], np.int32),
        np.asarray(key, np.uint32).view(np.int32),
        np.array([params.temperature, params.top_p],
                 np.float32).view(np.int32)])


def _knobs(req):
    """A request's selection inputs as the int32 row of `_KNOBS`."""
    return np.concatenate([np.array([len(req.out_tokens)], np.int32),
                           req.static_knobs])


# an inactive slot's row: greedy, temperature 1, top_p 1
_IDLE_KNOBS = np.concatenate([np.zeros(1, np.int32),
                              _static_knobs(SamplingParams(), [0, 0])])


def _unpack_knobs(cols):
    """The device view of `_KNOBS` columns [B, 7] (int32) -> the
    arguments of `_select` after `last`."""
    keys = cols[:, 3:5].long() & 0xFFFFFFFF
    floats = cols[:, 5:7].view(torch.float32)
    return (keys, cols[:, 0], floats[:, 0], cols[:, 1], floats[:, 1],
            cols[:, 2] != 0)


class ServingEngine:
    """submit(prompt, params) -> streaming RequestHandle; step() runs one
    scheduler iteration (one prefill chunk + one decode batch);
    start()/stop() run the loop on a background thread.

    `model` is a `models.gpt.GPTForPretraining` (or anything exposing its
    `.gpt` core — wte/wpe/drop/blocks/ln_f — and `.lm_head`). `sink` (a
    telemetry.sink.JsonlSink, optional) receives the kind=serving
    lifecycle records and the kind=reqtrace timelines."""

    def __init__(self, model, config=None, sink=None, **overrides):
        self.cfg = config or EngineConfig(**overrides)
        cfg = self.cfg
        self.engine_id = next(_ENGINE_IDS) if cfg.engine_id is None \
            else cfg.engine_id
        self._sink = sink
        self.device = resolve_device(cfg.device)
        mcfg = model.config
        self.n_heads = mcfg.num_heads
        self.hidden = mcfg.hidden_size
        self.num_layers = mcfg.num_layers
        self.max_model_len = int(cfg.max_model_len or mcfg.max_seq_len)
        self.block_size = cfg.block_size
        self.max_blocks_per_seq = PagedKVCache.blocks_for_tokens(
            self.max_model_len, self.block_size)
        self._compute_dtype = resolve_dtype(cfg.dtype or mcfg.dtype)
        if cfg.weights == "wo8":
            quantize_for_decode(model)
        self._net = _serving_copy(model, self.device, self._compute_dtype)

        num_blocks = self._resolve_num_blocks()
        self.pool = BlockPool(num_blocks)   # guarded by: _mu
        self.cache = PagedKVCache(          # guarded by: _mu
            self.num_layers, num_blocks, self.block_size, self.hidden,
            dtype=self._compute_dtype, device=self.device)
        self.prefix_index = (
            PrefixIndex(self.block_size, pool=self.pool)
            if cfg.enable_prefix_cache else None)
        self.sched = Scheduler(self.pool, self.block_size, cfg.max_slots,
                               self.max_model_len,
                               prefix_index=self.prefix_index)
        # the engine lock IS the step serializer: one step at a time;
        # submit/cancel from other threads serialize against it
        self._mu = threading.RLock()
        self._cv = threading.Condition(self._mu)
        self._thread = None     # start/stop confined
        self._stopping = False  # one-way flag; the loop re-reads it
        self._stopped = False   # set by stop(), without the lock by design
        self._draining = False  # guarded by: _mu
        self._dead = False      # guarded by: _mu
        self._restarts = 0      # serve-loop confined: CONSECUTIVE restarts
        self._sleep = time.sleep        # injectable (tests pin backoff)
        self._join_timeout_s = 30.0     # stop(): loop-join bound
        self._stop_lock_timeout_s = 5.0  # stop(): wedged-lock bound
        self.admission = AdmissionController(cfg.max_queue, cfg.max_slots)
        self._counts = {"admitted": 0, "finished": 0, "failed": 0,
                        "cancelled": 0, "expired": 0, "shed": 0}
        # latency lives in the monitor's streaming histograms; the
        # legacy p50/p99 gauges are recomputed from them at every step
        # and at scrape time, age-stamped by `_last_latency_obs`
        self._last_latency_obs = None   # guarded by: _mu
        self._finished = 0              # guarded by: _mu
        self.tracer = (
            RequestTracer(engine_id=self.engine_id, sink=sink,
                          exemplar_k=cfg.trace_exemplars)
            if cfg.enable_tracing else None)
        # prefix-cache accounting: offered = positions each admission
        # would have to prefill cold, saved = positions a hit covered
        self._prefix_stats = {"lookups": 0, "hits": 0,
                              "tokens_saved": 0, "tokens_offered": 0}
        # device dispatches run so far (one attention launch per layer
        # each)
        self.decode_steps = 0
        self.prefill_chunks = 0
        self.kv_peak_utilization = 0.0
        # memory observatory: the ledger sampled every
        # `mem_sample_every` steps; its headroom is what submit()'s
        # admission consult reads. Always built — without a declared
        # budget it still ledgers, it just never sheds
        self.mem_obs = MemoryObservatory(   # guarded by: _mu
            sink=sink,
            hbm_budget_bytes=(int(cfg.hbm_budget_mb) * 2 ** 20
                              if cfg.hbm_budget_mb else None),
            kv_source=self._kv_accounting, engine=self.engine_id,
            device=self.device)
        # a serving process has no optimizer to tag the weights, so the
        # engine tags its serving copy's parameters and buffers. Listed
        # once: torch updates tensors in place and the serving copy is
        # never re-bound (walking the module tree at every snapshot
        # would cost ~0.6 ms of host time a step at GPT-3 125M)
        self._weights = list(self._net.parameters()) + list(
            self._net.buffers())
        register_provider("engine.weights", "params", self,
                          lambda eng: eng._weights)
        self._steps = 0                 # guarded by: _mu
        # the compiled steps: CUDA graphs over static input buffers (the
        # pinned host side and the device side of each step's one
        # packed int32 copy), keyed by the arenas' generation
        self._graphs = CapturedStep(self.device, sink=sink,  # guarded by: _mu
                                    engine=self.engine_id)
        self._arena_gen = 0             # guarded by: _mu
        C, mb = cfg.prefill_chunk, self.max_blocks_per_seq
        self._staging = {
            "decode": self._staging_buffers((cfg.max_slots,
                                             2 + len(_KNOBS) + mb)),
            "prefill": self._staging_buffers(
                (4 * C + mb + len(_KNOBS) + 1,))}
        monitor.set_gauge("serving.kv_blocks_total", self.pool.capacity)
        monitor.set_gauge("serving.draining", 0)
        self._update_gauges()

    def _staging_buffers(self, shape):
        """[pinned host buffer, static device buffer, the copy's event]
        of one step's packed int32 inputs (on the CPU: a plain host
        buffer and no event)."""
        cuda = self.device.type == "cuda"
        return [torch.zeros(shape, dtype=torch.int32, pin_memory=cuda),
                torch.zeros(shape, dtype=torch.int32, device=self.device),
                torch.cuda.Event() if cuda else None]

    def _stage(self, name, inputs):     # requires: _mu
        """Copy a step's packed inputs into its static device buffer,
        through the pinned host buffer (an asynchronous copy: the host
        buffer is rewritten only after the last copy out of it is done).
        Returns the device buffer, which the step's graph reads."""
        host, dev, done = self._staging[name]
        if done is not None:
            done.synchronize()
        host.numpy()[...] = inputs
        dev.copy_(host, non_blocking=True)
        if done is not None:
            done.record()
        return dev

    def _resolve_num_blocks(self):
        cfg = self.cfg
        if cfg.num_blocks is not None:
            return int(cfg.num_blocks)
        if cfg.kv_memory_mb:
            itemsize = torch.empty((), dtype=self._compute_dtype).itemsize
            per_block = (2 * self.num_layers * self.block_size
                         * self.hidden * itemsize)
            return max(2, int(cfg.kv_memory_mb) * 2 ** 20 // per_block)
        # default: every slot can hold a full-length sequence (+ null)
        return cfg.max_slots * self.max_blocks_per_seq + 1

    # ------------------------------------------------------------------
    # submission / admission control
    # ------------------------------------------------------------------
    def submit(self, prompt_ids, params=None, deadlines=None,
               priority="normal", request_id=None, replay_tokens=None,
               **kw):
        """Queue one generation; returns a RequestHandle whose
        `.tokens()` stream yields ids as the engine emits them.

        A sampled request draws from PRNGKey(params.seed) (a fresh seed
        when None); `replay_tokens` seeds a failover replay: tokens
        another replica already streamed. They are treated like a
        preemption's kept tokens — prefill recomputes their K/V and
        decode resumes at fold_in(key, len(replay_tokens)) — so the
        continued stream is the uninterrupted one; the handle yields only
        the NEW tokens. Raises `ShedError`/`QueueFullError` when
        admission control rejects the request, `EngineDrainingError`
        during a drain, `EngineStoppedError`/`EngineDeadError` when no
        engine is left to serve it, ValueError when it can never fit
        this engine."""
        params = params or SamplingParams(**kw)
        if params.seed is not None:
            seed = int(params.seed)
        elif params.greedy:
            seed = 0                        # unused by greedy slots
        else:
            seed = prng.fresh_seed()
        base = prng.prng_key(seed).numpy().astype(np.uint32)
        req = Request(prompt_ids, params, base, deadlines=deadlines,
                      priority=priority, request_id=request_id)
        req.static_knobs = _static_knobs(params, base)
        if req.request_id is None:
            req.request_id = f"e{self.engine_id}-r{req.rid}"
        if replay_tokens:
            replay = [int(t) for t in replay_tokens]
            if len(replay) >= params.max_new_tokens:
                raise ValueError(
                    f"replay_tokens carries {len(replay)} token(s) but "
                    f"max_new_tokens is {params.max_new_tokens} — "
                    "nothing left to stream")
            if params.eos_token_id is not None and \
                    int(params.eos_token_id) in replay:
                raise ValueError(
                    "replay_tokens contains eos_token_id — the stream "
                    "already terminated")
            # direct assignment, NOT push_token: these tokens are
            # already on the client's wire
            req.out_tokens = replay
        with self._cv:
            if self._dead:
                raise EngineDeadError(
                    "engine is dead (warm-restart attempts exhausted)")
            if self._stopping or self._stopped:
                raise EngineStoppedError("engine is stopped")
            if self._draining:
                raise EngineDrainingError(
                    "engine is draining (admission stopped)",
                    retry_after_s=5.0)
            self.sched.validate(req)        # client error, not load
            try:
                self._check_mem_headroom()
                self.admission.admit_or_raise(req, self.sched.waiting)
            except ShedError as e:
                self._counts["shed"] += 1
                monitor.incr("serving.shed")
                self._record("shed", rid=req.rid,
                             request_id=req.request_id,
                             queue_depth=e.queue_depth,
                             predicted_wait_ms=e.predicted_wait_ms,
                             retry_after_s=e.retry_after_s,
                             reason=type(e).reason,
                             priority=req.priority_class)
                if self.tracer is not None:
                    # the shed verdict IS this request's trace
                    self.tracer.record_shed(
                        req, time.monotonic(),
                        queue_depth=e.queue_depth,
                        reason=type(e).reason)
                raise
            if self.tracer is not None:
                req.trace = self.tracer.start(req.rid, req.submit_time)
            self.sched.enqueue(req)     # validated above, by design
            self._counts["admitted"] += 1
            monitor.incr("serving.requests")
            monitor.incr("serving.admitted")
            self._record("admitted", rid=req.rid,
                         request_id=req.request_id,
                         queue_depth=len(self.sched.waiting),
                         priority=req.priority_class,
                         queue_deadline_ms=self._queue_deadline_ms(req),
                         replayed=len(req.out_tokens) or None)
            self._update_gauges()
            self._cv.notify_all()
        return RequestHandle(req, engine=self)

    def cancel(self, req):
        """Cancel `req` (RequestHandle.cancel lands here): its slot and KV
        blocks go back to the pool now and its stream ends with
        `RequestCancelledError`."""
        with self._cv:
            if req.state in TERMINAL_STATES:
                return False
            req.cancel_requested = True
            self._finalize(
                req, CANCELLED, "cancelled",
                exc=RequestCancelledError(
                    f"request {req.rid} cancelled after "
                    f"{len(req.out_tokens)} token(s)"),
                counter="serving.cancelled")
            self._update_gauges()
            self._cv.notify_all()
        return True

    # ------------------------------------------------------------------
    # the engine loop
    # ------------------------------------------------------------------
    def step(self):
        """One scheduler iteration: reap (cancellations + deadlines),
        admit, at most one prefill chunk, one decode batch. Returns True
        when any device work was done."""
        with self._mu:
            now = time.monotonic()
            self._reap(now)
            admitted = self.sched.admit(now=now)
            if self.prefix_index is not None:
                ps = self._prefix_stats
                for req in admitted:
                    ps["lookups"] += 1
                    ps["tokens_offered"] += len(req.tokens_all)
                    if req.prefix_cached_tokens:
                        ps["hits"] += 1
                        ps["tokens_saved"] += req.prefix_cached_tokens
                        monitor.incr("serving.prefix_hits")
            depth = len(self.sched.waiting)
            for req in admitted:
                if req.trace is not None:
                    req.trace.note_admit(
                        now, queue_depth=depth,
                        prefix_cached_tokens=req.prefix_cached_tokens)
                # sample only FIRST admissions (admit stamped them with
                # this step's clock): a requeued request keeps its first
                # admit_time, and re-observing it would double-count
                if req.admit_time != now:
                    continue
                qw = req.queue_wait_ms()
                if qw is not None:
                    monitor.observe_hist("serving.queue_wait_ms", qw)
                    self._last_latency_obs = now
            did = self._prefill_one()
            did = self._decode_once() or did
            self._steps += 1
            if self._steps % self.cfg.mem_sample_every == 0:
                try:
                    self.mem_obs.snapshot(self._steps)
                except Exception:
                    pass    # the ledger must never take a step down
            self._update_gauges()
            return did

    def _reap(self, now):     # requires: _mu
        """Step-boundary enforcement of cancellation + server-side
        deadlines: every reaped request releases its slot and KV blocks
        at once and its stream ends with a typed error."""
        for req, why in self.sched.reap(now):
            if why == "cancelled":
                self._finalize(
                    req, CANCELLED, "cancelled",
                    exc=RequestCancelledError(
                        f"request {req.rid} cancelled after "
                        f"{len(req.out_tokens)} token(s)"),
                    counter="serving.cancelled")
            else:
                self._finalize(
                    req, EXPIRED, "expired",
                    exc=DeadlineExceededError(
                        f"request {req.rid} blew its {why} deadline "
                        f"({req.deadlines!r})", which=why),
                    counter="serving.deadline_exceeded", reason=why)

    def run_until_idle(self, max_steps=None):
        n = 0
        while self.sched.has_work():
            self.step()
            n += 1
            if max_steps is not None and n >= max_steps:
                break
        return n

    def start(self):
        """Run the steps on a background thread (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        if self._dead:
            raise EngineDeadError(
                "engine is dead (warm-restart attempts exhausted); "
                "build a fresh ServingEngine")
        self._stopping = False
        self._stopped = False
        self._thread = threading.Thread(
            target=self._serve_loop, name="paddle-tpu-torch-serving-engine",
            daemon=True)
        self._thread.start()
        return self

    def stop(self):
        """Stop the serve loop, then FAIL every request still queued or
        in flight with `EngineStoppedError` — a submitter blocked on a
        handle gets a clean error, never a hang. Every wait is bounded:
        returns False when the loop did not join in time (a wedged
        step), leaving the leftovers for a later stop()."""
        # the flag is set WITHOUT the engine lock (a wedged step could
        # hold it indefinitely; the loop re-reads the flag each
        # iteration, and an idle loop self-wakes from its 0.1 s wait)
        self._stopping = True
        if self._mu.acquire(timeout=self._stop_lock_timeout_s):
            try:
                self._cv.notify_all()
            finally:
                self._mu.release()
        t = self._thread
        joined = True
        if t is not None:
            t.join(timeout=self._join_timeout_s)
            if t.is_alive():
                # keep the reference so a later start() cannot race a
                # SECOND loop against this one
                joined = False
            else:
                self._thread = None
        if not self._mu.acquire(
                timeout=-1 if joined else self._stop_lock_timeout_s):
            self._stopped = True
            return joined
        try:
            self._stopped = True
            leftovers = (list(self.sched.waiting)
                         + list(self.sched.prefilling)
                         + [r for r in self.sched.running
                            if r is not None])
            for req in leftovers:
                self._finalize(
                    req, FAILED, "failed",
                    error="engine stopped before the request finished",
                    exc=EngineStoppedError(
                        f"request {req.rid}: engine stopped before the "
                        "request finished"),
                    counter="serving.failed")
            if leftovers:
                self._update_gauges()
        finally:
            self._mu.release()
        return joined

    # ------------------------------------------------------------------
    # graceful drain
    # ------------------------------------------------------------------
    @property
    def draining(self):     # a racy scrape by design
        return self._draining

    @property
    def dead(self):     # a racy scrape by design
        return self._dead

    def drain(self, timeout=None):
        """Graceful drain: stop admission (submit raises
        `EngineDrainingError`; the HTTP front answers 503 on /healthz
        while /livez stays 200), finish every request already accepted,
        then emit the quiesce record. Returns True when fully drained,
        False on timeout (admission stays stopped either way;
        `resume_admission()` reopens it)."""
        with self._cv:
            self._draining = True
            monitor.set_gauge("serving.draining", 1)
            self._record("drain_begin",
                         queue_depth=len(self.sched.waiting),
                         running=self.sched.num_running())
            self._cv.notify_all()
        t0 = time.monotonic()
        loop_alive = self._thread is not None and self._thread.is_alive()
        if loop_alive:
            while True:
                with self._cv:
                    if not self.sched.has_work() or self._dead:
                        break
                    self._cv.wait(timeout=0.05)
                if timeout is not None and \
                        time.monotonic() - t0 > timeout:
                    self._record("drain_end", completed=False,
                                 drained_ms=(time.monotonic() - t0)
                                 * 1000.0)
                    return False
        else:
            self.run_until_idle()
        completed = not self.sched.has_work()
        if completed and self.prefix_index is not None:
            # a drain precedes a restart or shutdown: the arenas (and
            # their physical ids) do not survive it, so the index must
            # not either — quiesce also proves zero retained blocks
            with self._mu:
                self.prefix_index.flush()
                self._update_gauges()
        self._record("drain_end", completed=bool(completed),
                     drained_ms=(time.monotonic() - t0) * 1000.0)
        self.emit_quiesce()
        return completed

    def resume_admission(self):
        """Reopen admission after a drain."""
        with self._cv:
            self._draining = False
            monitor.set_gauge("serving.draining", 0)
            self._cv.notify_all()

    def emit_quiesce(self):
        """Emit the kind=serving quiesce record: the request ledger
        (admitted must equal finished+failed+cancelled+expired) plus the
        pool's allocation count (must be zero — a leak here is a dropped
        request) and the prefix-cache audit."""
        with self._mu:
            ps = self._prefix_stats
            offered = ps["tokens_offered"]
            self._record("quiesce", kv_blocks_used=self.pool.num_used,
                         queue_depth=len(self.sched.waiting),
                         counts=dict(self._counts),
                         prefix_blocks_shared=self.pool.num_shared,
                         prefix_hit_rate=(
                             ps["tokens_saved"] / offered
                             if offered else 0.0),
                         prefill_tokens_saved=ps["tokens_saved"],
                         prefill_tokens_offered=offered)

    def _serve_loop(self):
        while True:
            with self._cv:
                if self._stopping:
                    return
                if not self.sched.has_work():
                    self._cv.wait(timeout=0.1)
                    continue
            try:
                did = self.step()
            except Exception as e:      # noqa: BLE001 — long-lived loop
                # a dead serve thread strands every open stream forever;
                # classify the failure and warm-restart (transient/infra)
                # or fail the in-flight work loudly (permanent)
                alive, backoff = self._on_step_error(e)
                if not alive:
                    return
                if backoff:
                    self._sleep(backoff)
                continue
            self._restarts = 0          # a completed step resets the cap
            with self._cv:
                self._cv.notify_all()   # wake drain()/result() waiters
            if not did:
                # work exists but none runnable (prefill waiting on
                # blocks): don't spin the lock hot
                time.sleep(0.002)

    def _rebuild_arenas(self):     # requires: _mu
        """Fresh pool + fresh K/V arenas on the engine's device: after a
        failed step the arenas' contents are suspect, and every
        surviving request holds zero blocks by construction (failed or
        requeued). The prefix index MUST flush and rebind — its physical
        block ids name the old arenas' rows — and the captured steps go:
        they write into the old arenas, so the next steps recapture over
        the new ones (a new `arenas` generation in their key)."""
        self._graphs.invalidate()
        self._arena_gen += 1
        if self.prefix_index is not None:
            self.prefix_index.flush()
        self.pool = BlockPool(self.pool.num_blocks)
        self.sched.pool = self.pool
        if self.prefix_index is not None:
            self.prefix_index.bind(self.pool)
        old = self.cache
        self.cache = None                   # free the old arenas first
        del old
        self.cache = PagedKVCache(
            self.num_layers, self.pool.num_blocks, self.block_size,
            self.hidden, dtype=self._compute_dtype, device=self.device)

    def _on_step_error(self, exc):
        """A step raised mid-flight (out of memory, a CUDA error, a
        kernel's launch error): the in-flight requests' KV state is
        suspect. Rides `resilience.retry.classify_failure`:

        - PERMANENT (a programming error): replay would hit the same
          bug, so fail every ACTIVE request with the error, rebuild the
          arenas clean, and keep serving the queued requests;
        - TRANSIENT / INFRA: warm restart — rebuild the arenas and
          REQUEUE the in-flight requests for recompute-replay (their
          streams replay identically), with bounded attempts + backoff;
          past `max_restarts` consecutive failures the engine declares
          itself DEAD and fails everything outstanding.

        Returns (keep_serving, backoff_s). Manual step() callers see the
        exception raw — this path is the background loop's."""
        monitor.incr("serving.engine_errors")
        msg = f"{type(exc).__name__}: {exc}"
        kind = classify_failure(exc)
        traceback.print_exc()
        with self._mu:
            if is_oom(exc):
                # capture-on-failure: write the postmortem BEFORE the
                # arena rebuild below frees the evidence
                try:
                    self.mem_obs.capture_postmortem(msg, step=self._steps)
                except Exception:
                    pass  # forensics must never mask the real failure
            active = [r for r in self.sched.admit_order
                      if r.state not in TERMINAL_STATES]
            if kind == "permanent":
                for req in active:
                    self._finalize(req, FAILED, "failed", error=msg,
                                   counter="serving.failed")
                self._rebuild_arenas()
                self._update_gauges()
                self._cv.notify_all()
                return True, 0.0
            self._restarts += 1
            attempt = self._restarts
            if attempt > self.cfg.max_restarts:
                self._dead = True
                monitor.set_gauge("serving.engine_dead", 1)
                doomed = active + list(self.sched.waiting)
                for req in doomed:
                    err = (f"engine dead after {attempt - 1} warm-"
                           f"restart attempt(s); last failure: {msg}")
                    self._finalize(req, FAILED, "failed", error=err,
                                   exc=EngineDeadError(
                                       f"request {req.rid}: {err}"),
                                   counter="serving.failed")
                self._update_gauges()
                self._cv.notify_all()
                return False, 0.0
            monitor.incr("serving.restarts")
            # requeue oldest-first so the waiting FRONT preserves the
            # original admission order for the replay
            now = time.monotonic()
            for req in reversed(active):
                if req.trace is not None:
                    req.trace.note_requeue(now, "restart",
                                           n_prefilled=req.n_prefilled)
                self.sched.requeue(req)
            self._rebuild_arenas()
            self._record("restart", attempt=attempt, reason=kind,
                         error=msg, requeued=len(active))
            self._update_gauges()
        return True, restart_backoff(attempt, self.cfg.restart_backoff_s)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def prefix_stats(self):
        """Prefix-cache accounting: lookups, hits, tokens saved/offered,
        hit_rate (saved / offered), shared/cached block counts."""
        with self._mu:
            ps = dict(self._prefix_stats)
            offered = ps["tokens_offered"]
            ps["hit_rate"] = ps["tokens_saved"] / offered \
                if offered else 0.0
            ps["blocks_shared"] = self.pool.num_shared
            ps["blocks_cached"] = self.pool.num_cached
            return ps

    # ------------------------------------------------------------------
    # host-side step logic (the JAX engine's, unchanged)
    # ------------------------------------------------------------------
    def _cow_fork(self, req, bi, evict=True):     # requires: _mu
        """Copy-on-write: make `req.blocks[bi]` safe to write. A block
        another request (or the prefix index) can read is never mutated:
        fork it into a fresh private block, swap the table entry, and
        drop this request's reference to the original. Block acquisition
        follows the `ensure_blocks` reclaim ladder — index leaves first,
        then preemption only when `evict` allows it. Returns False when
        the chunk must wait (or the request yielded its own place)."""
        pool = self.sched.pool
        old = req.blocks[bi]
        if pool.is_private(old, req.rid):
            return True
        while True:
            got = pool.alloc(1, owner=req.rid)
            if got is not None:
                break
            if self.prefix_index is not None and \
                    self.prefix_index.evict(1, pool):
                continue
            if not evict:
                return False                # wait for free blocks
            victim = self.sched._pick_victim(exclude=req)
            if victim is None:
                self.sched.preempt(req)     # yield; replay re-matches
                return False
            self.sched.preempt(victim)
        new = got[0]
        self.cache.copy_block(old, new)
        pool.free([old], owner=req.rid)
        req.blocks[bi] = new
        monitor.incr("serving.prefix_cow_forks")
        if req.trace is not None:
            req.trace.note_cow_fork(time.monotonic())
        return True

    def _prefill_one(self):     # requires: _mu
        sched = self.sched
        # prefill growth normally WAITS for blocks instead of evicting;
        # with nothing decoding, the oldest prefill may evict its way
        # forward (else a pool held by fellow prefills would deadlock)
        allow_evict = sched.num_running() == 0
        for idx, req in enumerate(list(sched.prefilling)):
            seq = req.tokens_all
            p0 = req.n_prefilled
            c_real = min(self.cfg.prefill_chunk, len(seq) - p0)
            if c_real <= 0:                     # defensive; place it
                sched.place(req)
                continue
            if not sched.ensure_blocks(req, p0 + c_real,
                                       evict=allow_evict and idx == 0):
                continue                        # wait for free blocks
            # a prefix hit may resume INSIDE a shared block: fork before
            # the chunk writes into it (blocks past p0's are fresh)
            bi = p0 // self.block_size
            if bi < len(req.blocks) and not self._cow_fork(
                    req, bi, evict=allow_evict and idx == 0):
                continue                        # wait / yielded
            C = self.cfg.prefill_chunk
            ids = np.zeros((C,), np.int32)
            ids[:c_real] = seq[p0:p0 + c_real]
            tok, logp = self._prefill_chunk(ids, p0, c_real,
                                            self._table_row(req),
                                            _knobs(req))
            self.prefill_chunks += 1
            monitor.incr("serving.prefill_chunks")
            req.n_prefilled = p0 + c_real
            if req.trace is not None:
                req.trace.note_prefill_chunk(time.monotonic(), p0, c_real)
            if req.n_prefilled >= len(seq):
                # publish the full prompt blocks to the prefix index,
                # then stream the token sampled from the last position
                sched.note_prefill_done(req)
                self._emit(req, tok, logp)
                if req.state == PREFILL:    # _emit finishes done ones
                    sched.place(req)
            return True
        return False

    def _decode_once(self):     # requires: _mu
        sched = self.sched
        # grow blocks oldest-first so eviction lands on the youngest
        for req in list(sched.admit_order):
            if req.slot is None:
                continue
            sched.ensure_blocks(req, req.n_prefilled + 1, evict=True)
            # decode writes position n_prefilled: defensively fork a
            # still-shared tail (normally prefill already forked it)
            bi = req.n_prefilled // self.block_size
            if req.slot is not None and bi < len(req.blocks):
                self._cow_fork(req, bi)
        active = [(i, r) for i, r in enumerate(sched.running)
                  if r is not None]
        if not active:
            return False
        S = self.cfg.max_slots
        mb = self.max_blocks_per_seq
        nk = len(_KNOBS)
        # one host array for all step inputs: [token, ctx, knobs...,
        # table...] per slot. Inactive slots decode token 0 at position 0
        # through an all-null table, greedy: their writes land in the
        # null block, their outputs are finite and ignored
        inputs = np.zeros((S, 2 + nk + mb), np.int32)
        inputs[:, 2 + nk:] = NULL_BLOCK
        inputs[:, 2:2 + nk] = _IDLE_KNOBS
        for i, req in active:
            inputs[i, 0] = req.tokens_all[req.n_prefilled]
            inputs[i, 1] = req.n_prefilled
            inputs[i, 2] = len(req.out_tokens)
            inputs[i, 3:2 + nk] = req.static_knobs
            inputs[i, 2 + nk:2 + nk + len(req.blocks)] = req.blocks
        # all-greedy batches take the greedy program (no sort, no draw)
        sampling = any(not r.params.greedy for _, r in active)
        tok, logp = self._decode_step(inputs, sampling)
        self.decode_steps += 1
        monitor.incr("serving.decode_steps")
        now = time.monotonic()
        for i, req in active:
            req.n_prefilled += 1
            if req.trace is not None:
                # O(1) per request per step: extends the coalesced
                # decode segment (one span per stretch, never per token)
                req.trace.note_decode(now)
            self._emit(req, int(tok[i]), float(logp[i]), now=now)
        return True

    # ------------------------------------------------------------------
    # device steps
    # ------------------------------------------------------------------
    def _step_signature(self, packed, static):     # requires: _mu
        """The capture record's signature of a step: its static input
        buffer, the arenas it writes, the knobs of its key."""
        return signature_of((packed, self.cache.k[0]),
                            arg_names=("inputs", "arena"),
                            static={**static, "arenas": self._arena_gen})

    @torch.inference_mode()
    def _decode_step(self, inputs, sampling):
        """One decode token for every slot. `inputs` [S, 2 + 7 + mb]
        int32: token, ctx, the `_KNOBS` columns, the block table. Writes
        each slot's K/V at (table[ctx // bs], ctx % bs), attends over its
        blocks, selects (greedily unless `sampling`). Returns host arrays
        (tokens [S], logp [S]). On the card the step is a CUDA graph
        over the static input buffer, one for each of the two
        programs."""
        packed = self._stage("decode", inputs)
        family = "decode" if sampling else "decode_greedy"
        tok, logp = self._graphs.run(
            family, (family, self._arena_gen),
            lambda: self._decode_body(packed, sampling),
            signature=lambda: self._step_signature(
                packed, {"sampling": sampling}),
            step=self._steps)
        return tok.cpu().numpy(), logp.cpu().numpy()

    def _decode_body(self, packed, sampling):
        """The decode step over the static input buffer -> (tokens [S],
        logp [S]) on the device."""
        core = self._net.gpt
        S, nh, bs = self.cfg.max_slots, self.hidden, self.block_size
        nk = len(_KNOBS)
        tok_d = packed[:, 0]
        ctx_d = packed[:, 1].contiguous()
        tab_d = packed[:, 2 + nk:].contiguous()
        ctx_l = ctx_d.long()
        blk = tab_d.long().gather(1, (ctx_l // bs)[:, None])[:, 0]
        off = ctx_l % bs
        h = core.drop(core.wte(tok_d[:, None]) + core.wpe(ctx_d[:, None]))
        for li, block in enumerate(core.blocks):
            kp, vp = self.cache.k[li], self.cache.v[li]

            def write(k, v, kp=kp, vp=vp):
                kp.index_put_((blk, off), k.reshape(S, nh).to(kp.dtype))
                vp.index_put_((blk, off), v.reshape(S, nh).to(vp.dtype))

            def attend(q, kp=kp, vp=vp):
                return paged_decode_attention(
                    q.reshape(S, 1, nh).contiguous(), kp, vp, tab_d, ctx_d,
                    self.n_heads)

            h = _block_step(block, h, attend, write)
        last = self._net.lm_head(core.ln_f(h))[:, -1]
        if sampling:
            return _select(last, *_unpack_knobs(packed[:, 2:2 + nk]))
        return _greedy(last)

    @torch.inference_mode()
    def _prefill_chunk(self, ids, p0, n_real, table_row, knobs):
        """One chunk of ONE request: ids [C] (the tail past n_real is
        padding, written to the null block) at positions p0..p0+C-1;
        `knobs` is the request's `_KNOBS` row. Returns the token selected
        from the last real position and its logp — used by the caller
        only after the final chunk. On the card the chunk is a CUDA
        graph over the static input buffer, which holds p0 and the last
        real row as device data: one graph for greedy chunks, one for
        sampled ones."""
        C, bs = self.cfg.prefill_chunk, self.block_size
        mb = self.max_blocks_per_seq
        positions = p0 + np.arange(C, dtype=np.int32)
        blk = np.where(np.arange(C) < n_real,
                       table_row[np.clip(positions // bs, 0, mb - 1)],
                       NULL_BLOCK).astype(np.int32)
        packed = self._stage("prefill", np.concatenate(
            [ids, positions, blk, positions % bs, table_row, knobs,
             np.array([n_real - 1], np.int32)]))
        # a greedy request skips the sorts and the draw: its token is
        # the tempered argmax either way, as in the JAX engine's select
        sampling = not bool(knobs[2])
        tok, logp = self._graphs.run(
            "prefill", ("prefill", sampling, self._arena_gen),
            lambda: self._prefill_body(packed, sampling),
            signature=lambda: self._step_signature(
                packed, {"sampling": sampling}),
            step=self._steps)
        return int(tok[0]), float(logp[0])

    def _prefill_body(self, packed, sampling):
        """The prefill chunk over the static input buffer [ids C,
        positions C, blocks C, offsets C, table mb, knobs 7, last real
        row 1] -> (token [1], logp [1]) on the device."""
        core = self._net.gpt
        C, nh = self.cfg.prefill_chunk, self.hidden
        mb, nk = self.max_blocks_per_seq, len(_KNOBS)
        ids_d, pos_d = packed[:C], packed[C:2 * C]
        blk_d, off_d = packed[2 * C:3 * C].long(), packed[3 * C:4 * C].long()
        tab_d = packed[4 * C:4 * C + mb]
        knobs_d = packed[4 * C + mb:4 * C + mb + nk]
        row_d = packed[4 * C + mb + nk:].long()
        h = core.drop(core.wte(ids_d[None]) + core.wpe(pos_d[None]))
        for li, block in enumerate(core.blocks):
            kp, vp = self.cache.k[li], self.cache.v[li]

            def write(k, v, kp=kp, vp=vp):
                kp.index_put_((blk_d, off_d), k.reshape(C, nh).to(kp.dtype))
                vp.index_put_((blk_d, off_d), v.reshape(C, nh).to(vp.dtype))

            def attend(q, kp=kp, vp=vp):
                return flash_prefill_chunk(
                    q.reshape(1, C, nh).contiguous(), kp, vp, tab_d,
                    pos_d[0], self.n_heads)

            h = _block_step(block, h, attend, write)
        hf = core.ln_f(h)
        last = self._net.lm_head(hf.index_select(1, row_d))[:, -1]
        return _select(last, *_unpack_knobs(knobs_d[None]),
                       sampling=sampling)

    # ------------------------------------------------------------------
    # helpers: accounting, records, gauges
    # ------------------------------------------------------------------
    def _table_row(self, req):
        row = np.full((self.max_blocks_per_seq,), NULL_BLOCK, np.int32)
        row[:len(req.blocks)] = req.blocks
        return row

    def _queue_deadline_ms(self, req):
        d = req.deadlines
        if d is None or d.queue_wait_s is None:
            return None
        return d.queue_wait_s * 1000.0

    def _record(self, event, **fields):
        """Emit one kind=serving lifecycle record to the attached sink
        (no-op without one); counters and gauges are updated by the
        callers regardless."""
        if self._sink is None:
            return
        self._sink.write(make_serving_record(
            event, engine=self.engine_id, **fields))

    def _finalize(self, req, status, event,  # requires: _mu
                  error=None, exc=None, counter=None, **fields):
        """The single terminal transition: release slot + blocks via the
        scheduler, account the outcome, emit the typed record, close the
        trace. Idempotent (a cancel racing a natural finish is a
        no-op)."""
        if req.state in TERMINAL_STATES:
            return
        self.sched.finish(req, error=error, status=status, failure=exc)
        self._counts[event] += 1
        if counter is not None:
            monitor.incr(counter)
        self._record(event, rid=req.rid,
                     request_id=req.request_id,
                     n_tokens=len(req.out_tokens),
                     queue_wait_ms=req.queue_wait_ms(),
                     queue_deadline_ms=self._queue_deadline_ms(req),
                     priority=req.priority_class, error=error, **fields)
        if self.tracer is not None:
            # the finalize span ends at the scheduler-stamped
            # finish_time, so the spans sum to e2e for every outcome
            self.tracer.finish(req, req.finish_time)

    def _emit(self, req, tok, logp, now=None):     # requires: _mu
        req.push_token(tok, now=now)
        monitor.incr("serving.tokens_generated")
        if req.done:
            self._finished += 1
            monitor.incr("serving.finished")
            t = req.ttft_ms()
            if t is not None:
                monitor.observe_hist("serving.ttft_ms", t)
                self._last_latency_obs = time.monotonic()
            self._finalize(req, FINISHED, "finished")
            t = req.tpot_ms()
            if t is not None:
                monitor.observe_hist("serving.tpot_ms", t)
                self._last_latency_obs = time.monotonic()
                self.admission.note_tpot_ms(t)  # feeds shed prediction

    def _update_gauges(self):     # requires: _mu
        monitor.set_gauge("serving.queue_depth", len(self.sched.waiting))
        monitor.set_gauge("serving.running", self.sched.num_running())
        monitor.set_gauge("serving.prefilling", len(self.sched.prefilling))
        monitor.set_gauge("serving.kv_blocks_used", self.pool.num_used)
        ps = self._prefix_stats
        offered = ps["tokens_offered"]
        monitor.set_gauge("serving.prefix_hit_rate",
                          ps["tokens_saved"] / offered if offered
                          else 0.0)
        monitor.set_gauge("serving.prefix_blocks_shared",
                          self.pool.num_shared)
        monitor.set_gauge("serving.prefix_blocks_cached",
                          self.pool.num_cached)
        monitor.set_gauge("serving.prefill_tokens_saved",
                          ps["tokens_saved"])
        monitor.set_gauge("serving.prefill_tokens_offered", offered)
        util = self.pool.utilization()
        monitor.set_gauge("serving.kv_block_utilization", util)
        self.kv_peak_utilization = max(self.kv_peak_utilization, util)
        monitor.set_gauge("serving.mem_headroom_bytes",
                          self._mem_headroom_bytes())
        self.refresh_latency_gauges()

    def _kv_accounting(self):     # requires: _mu (called from snapshot)
        """The memory observatory's `kv_source`: the pool's block census
        (held + free + cached tile its capacity) plus the scheduler's
        cumulative per-priority-class eviction/admission counters."""
        pool, sched = self.pool, self.sched
        ev = dict(sched.evictions_by_class)
        adm = dict(sched.admissions_by_class)
        return {
            "blocks_total": pool.capacity,
            "blocks_held": pool.num_used,
            "blocks_free": pool.num_free,
            "blocks_cached": pool.num_cached,
            "evictions": sum(ev.values()),
            "admissions": sum(adm.values()),
            "evictions_by_class": ev,
            "admissions_by_class": adm,
        }

    def _mem_headroom_bytes(self):     # requires: _mu
        """Bytes the engine believes it can still allocate: the ledger's
        headroom (declared budget minus the sampled total) when the
        observatory has both, else the KV pool's free blocks in bytes —
        so the gauge exists without a declared budget."""
        h = self.mem_obs.headroom_bytes()
        if h is not None:
            return h
        return self.pool.num_free * (2 * self.num_layers * self.block_size
                                     * self.hidden
                                     * self._compute_dtype.itemsize)

    def _check_mem_headroom(self):     # requires: _mu
        """submit()'s admission consult: with a declared budget and a
        sampled ledger showing it used up, shed at the door
        (MemoryPressureError -> 429 + Retry-After) instead of admitting
        work into an allocation failure mid-decode. Without a budget or
        before the first snapshot there is no verdict."""
        if self.mem_obs.hbm_budget_bytes is None:
            return
        h = self.mem_obs.headroom_bytes()
        if h is None or h > 0:
            return
        monitor.incr("serving.mem_shed")
        raise MemoryPressureError(
            f"HBM budget exhausted: ledger shows 0 headroom bytes "
            f"against the declared "
            f"{self.mem_obs.hbm_budget_bytes} byte budget",
            retry_after_s=1.0, queue_depth=len(self.sched.waiting))

    # the legacy-gauge <- histogram mapping (the JAX engine's names)
    _LATENCY_GAUGES = (
        ("serving.ttft_ms", "serving.ttft_p50_ms",
         "serving.ttft_p99_ms"),
        ("serving.tpot_ms", "serving.tpot_p50_ms",
         "serving.tpot_p99_ms"),
        ("serving.queue_wait_ms", "serving.queue_wait_ms_p50",
         "serving.queue_wait_ms_p99"),
    )

    def refresh_latency_gauges(self):
        """Recompute the legacy p50/p99 SLO gauges from the streaming
        histograms NOW (over their bounded recent window) and age-stamp
        them (`serving.slo_gauge_age_s`). Called on every engine step and
        from the HTTP front's /metrics and /healthz handlers, so a
        stalled engine cannot serve percentiles frozen at its last
        finished request. Like every serving.* stat, the histograms are
        process-global: several engines in one process merge them."""
        for hist_name, p50_name, p99_name in self._LATENCY_GAUGES:
            p50 = monitor.hist_quantile(hist_name, 0.50)
            p99 = monitor.hist_quantile(hist_name, 0.99)
            if p50 is None or p99 is None:
                continue
            monitor.set_gauge(p50_name, float(p50))
            monitor.set_gauge(p99_name, float(p99))
        with self._mu:      # a step-loop field; scrape threads land here
            last = self._last_latency_obs
        if last is not None:
            monitor.set_gauge("serving.slo_gauge_age_s",
                              round(time.monotonic() - last, 3))

    def metrics_snapshot(self):
        """Point-in-time serving stats (the /metrics serving.* family,
        as a dict)."""
        snap = monitor.snapshot()
        return {k: v for k, v in snap.items() if k.startswith("serving.")}
