"""Training flight recorder: per-step telemetry with a compile/execute
split — the port of paddle_tpu/telemetry/recorder.py.

Mechanics:

- compile time: the JAX recorder hears it from `jax.monitoring`'s
  compile events. The port's eager steps compile nothing, but two
  things do a one-time build inside a step: `ops/_build.py`'s first-use
  `nvcc` of a kernel source, and a `jit.CapturedStep` capturing a CUDA
  graph. Both report their host seconds through `note_compile(secs)`,
  which adds them to every open step window, as the JAX listener does.
  A step with compile_ms > 0 counts as a cache miss; steady-state steps
  show 0.0 and advance the hit counter.
- spans (`span("name")`) are host intervals tagged with the recorder's
  rank; the serving engine's `step()` runs inside a `serving_step`
  span. Spans export to a multi-rank Chrome trace
  (sink.export_chrome_tracing), and open ones sit in a table the hang
  watchdog's dump reads (`open_spans`).
- every closed step writes one JSONL record (sink.make_step_record):
  step, loss, step_ms, compile_ms, execute_ms, tokens/sec, MFU
  (telemetry/mfu.py's peaks), mem_bytes (`torch.cuda.memory_allocated`),
  per-collective ms, cache hit/miss counters. The loss is fetched at the
  step's close, and that fetch is the step's device sync.
- `monitor` counters (`telemetry.steps`,
  `telemetry.compile_cache_hits/misses`) advance with every step.
"""
import contextlib
import threading
import time

import torch

from .. import monitor
from .mfu import device_peak_flops
from .sink import JsonlSink, make_step_record

__all__ = ["TelemetryRecorder", "StepTimer", "span", "open_spans",
           "auto_step", "current_recorder", "note_compile"]

_LOCK = threading.Lock()
_RECORDER_STACK = []          # guarded by: _LOCK — active (context-entered) recorders
_OPEN_STEPS = []              # guarded by: _LOCK — open _StepWindow objects (compile sink)
_OPEN_SPANS = []              # guarded by: _LOCK — spans entered but not yet exited (any thread)


def note_compile(secs):
    """Add `secs` of one-time build work (an nvcc build, a graph
    capture) to every open step window. A no-op with none open."""
    with _LOCK:
        for win in _OPEN_STEPS:
            win.compile_secs += secs


def current_recorder():
    """The innermost context-active TelemetryRecorder, or None."""
    with _LOCK:
        return _RECORDER_STACK[-1] if _RECORDER_STACK else None


class _StepWindow:
    """One open step measurement: wall clock + compile accumulation +
    span capture start index."""

    def __init__(self, recorder):
        self.recorder = recorder
        self.compile_secs = 0.0
        self.loss = None
        self.extra = {}
        self.span_start = len(recorder.spans) if recorder is not None else 0
        self.t0 = time.perf_counter()

    def note(self, loss=None, **extra):
        """Attach the step's loss (Tensor/array/float — fetched lazily at
        close, which also syncs the device) and any extra record fields."""
        if loss is not None:
            self.loss = loss
        self.extra.update(extra)
        return self


@contextlib.contextmanager
def auto_step(**extra):
    """Bracket a train-step body with the active recorder, if any.

    Used by TrainStep so any step executed while a
    recorder is context-active gets recorded with zero call-site changes.
    Re-entrant calls (a recorder-managed wrapper around an instrumented
    step) record only the OUTERMOST window. Yields a _StepWindow (or an
    inert one when no recorder is active) whose .note(loss=...) feeds the
    record.
    """
    rec = current_recorder()
    if rec is None or rec._open:
        yield _InertWindow()
        return
    win = rec.start_step()
    if extra:
        win.extra.update(extra)
    try:
        yield win
    finally:
        rec.end_step()


class _InertWindow:
    def note(self, loss=None, **extra):
        return self


def _push_open_span(name, cat, t0, rec=None, rank=None, attrs=None):
    """Register a just-entered span in the module-wide open-span table.
    The hang watchdog reads this table to NAME what a stalled step is
    stuck inside (e.g. `collective.all_reduce`), and chrome export
    closes these instead of dropping them. Returns the entry (identity
    is the removal token)."""
    entry = {"name": name, "cat": cat, "t0": t0,
             "tid": threading.get_ident(),
             "thread": threading.current_thread().name,
             "rec": rec, "rank": rank, "attrs": dict(attrs or {})}
    with _LOCK:
        _OPEN_SPANS.append(entry)
    return entry


def _pop_open_span(entry):
    with _LOCK:
        try:
            _OPEN_SPANS.remove(entry)
        except ValueError:
            pass


def open_spans():
    """Snapshot of every currently-open telemetry span (all threads):
    [{name, cat, age_s, thread, rank, attrs}], oldest first. This is
    what the watchdog black-box dump records, so a hang inside an
    instrumented region is attributable without a debugger."""
    now = time.perf_counter()
    with _LOCK:
        entries = list(_OPEN_SPANS)
    return [{"name": e["name"], "cat": e["cat"],
             "age_s": round(now - e["t0"], 4), "thread": e["thread"],
             "rank": e["rank"], "attrs": e["attrs"]} for e in entries]


@contextlib.contextmanager
def span(name, cat="host", rank=None, **attrs):
    """Record a named host span into the active recorder. Extra keyword
    attrs ride into the span dict, the chrome-trace `args`, and the
    watchdog's open-span dump. While the body runs the span sits in the
    open-span table, so a hang inside it is named in black-box dumps.
    (The JAX span also feeds the JAX package's profiler table; the port
    has no such profiler.)"""
    rec = current_recorder()
    t0 = time.perf_counter()
    entry = _push_open_span(name, cat, t0, rec=rec,
                            rank=rank if rank is not None
                            else (rec.rank if rec is not None else None),
                            attrs=attrs)
    try:
        yield
    finally:
        dur = time.perf_counter() - t0
        _pop_open_span(entry)
        if rec is not None:
            rec.add_span(name, t0, dur, cat=cat, rank=rank, args=attrs)


class StepTimer:
    """Explicit compile/execute split for a plain step function: a
    cache keyed on the shapes and dtypes of the tensor arguments. A key
    miss counts as a compile, and its compile_ms is the build and
    capture time the call reported (`note_compile`); the rest of the
    call, up to a device sync when an output is on the card, is
    execute_ms. The counterpart of the JAX StepTimer's AOT cache.

    timer = StepTimer(fn); out = timer(*args)
    timer.cache_hits / timer.cache_misses / timer.last_compile_ms
    """

    def __init__(self, fn, recorder=None):
        self._fn = fn
        self._seen = set()
        self.recorder = recorder
        self.cache_hits = 0
        self.cache_misses = 0
        self.last_compile_ms = 0.0
        self.last_execute_ms = 0.0

    @staticmethod
    def _key(args):
        return tuple((tuple(a.shape), str(a.dtype), a.device.type)
                     if isinstance(a, torch.Tensor) else type(a).__name__
                     for a in args)

    def __call__(self, *args):
        key = self._key(args)
        miss = key not in self._seen
        win = _StepWindow(None)
        with _LOCK:
            _OPEN_STEPS.append(win)
        try:
            t0 = time.perf_counter()
            out = self._fn(*args)
            outs = out if isinstance(out, (tuple, list)) else (out,)
            if any(isinstance(o, torch.Tensor) and o.is_cuda for o in outs):
                torch.cuda.synchronize()
            total_ms = (time.perf_counter() - t0) * 1000.0
        finally:
            with _LOCK:
                _OPEN_STEPS.remove(win)
        if miss:
            self._seen.add(key)
            self.cache_misses += 1
            monitor.incr("telemetry.aot_cache_misses")
            self.last_compile_ms = win.compile_secs * 1000.0
        else:
            self.cache_hits += 1
            monitor.incr("telemetry.aot_cache_hits")
            self.last_compile_ms = 0.0
        self.last_execute_ms = max(0.0, total_ms - self.last_compile_ms)
        if self.recorder is not None:
            self.recorder.record_external_step(
                step_ms=self.last_compile_ms + self.last_execute_ms,
                compile_ms=self.last_compile_ms,
                cache_hits=self.cache_hits,
                cache_misses=self.cache_misses)
        return out

    def memory_analysis(self):
        """None always: the JAX StepTimer reads the compiled program's
        memory analysis, and an eager PyTorch step has no compiled
        program to analyse. The card's live bytes ride each step record
        as `mem_bytes` instead."""
        return None

    def memory_analysis_dict(self):
        """None always (see `memory_analysis`)."""
        return None


class TelemetryRecorder:
    """Flight recorder for a training loop.

    rec = TelemetryRecorder(sink="run.jsonl", tokens_per_step=B*S,
                            flops_per_token=mfu.model_flops_per_token(...))
    with rec:                      # recorder active: TrainStep auto-records
        for batch in loader:
            loss = train_step(*batch)

    or wrap an arbitrary step callable:  step = rec.wrap(train_step).

    Per closed step, one schema record (sink.make_step_record) goes to the
    JSONL sink and to `rec.records`. MFU inputs: flops_per_step OR
    flops_per_token (analytic, e.g. mfu.gpt_train_flops_per_token)
    combined with tokens_per_step; peak_flops defaults from the card's
    name (mfu.device_peak_flops, bf16 — None on the CPU => MFU 0.0,
    still finite, as in the JAX recorder). `mem_bytes` is
    `torch.cuda.memory_allocated()` at the step's close (absent without
    a card).
    """

    def __init__(self, sink=None, rank=0, tokens_per_step=None,
                 flops_per_step=None, flops_per_token=None,
                 peak_flops=None, n_devices=None, track_memory=True):
        self._owns_sink = isinstance(sink, str)
        self.sink = JsonlSink(sink) if self._owns_sink else sink
        self.rank = int(rank)
        self.tokens_per_step = tokens_per_step
        self.flops_per_step = flops_per_step
        self.flops_per_token = flops_per_token
        if peak_flops is None:
            peak_flops = device_peak_flops()
        self.peak_flops = peak_flops
        self.n_devices = n_devices or 1
        self.track_memory = track_memory
        self.records = []
        self.spans = []
        self.cache_hits = 0
        self.cache_misses = 0
        self._step_idx = 0
        self._win = None

    # -- span API ----------------------------------------------------------
    def add_span(self, name, t0, dur, cat="host", rank=None, tid=None,
                 args=None):
        sp = {
            "name": name, "t0": float(t0), "dur": float(dur),
            "cat": cat, "rank": self.rank if rank is None else int(rank),
            "tid": threading.get_ident() % 1000 if tid is None else tid}
        if args:
            sp["args"] = {k: (v if isinstance(v, (int, float, str, bool))
                              else repr(v)) for k, v in args.items()}
        self.spans.append(sp)

    def open_span_dicts(self):
        """Spans currently open under this recorder, synthesized as
        closed span dicts ending 'now' and tagged args={'open': True} —
        chrome export includes them instead of dropping them."""
        now = time.perf_counter()
        with _LOCK:
            entries = [e for e in _OPEN_SPANS if e["rec"] is self]
        return [{"name": e["name"], "t0": float(e["t0"]),
                 "dur": float(now - e["t0"]), "cat": e["cat"],
                 "rank": self.rank if e["rank"] is None else e["rank"],
                 "tid": e["tid"] % 1000,
                 "args": {"open": True, **{k: repr(v) for k, v
                                           in e["attrs"].items()}}}
                for e in entries]

    # -- step lifecycle ----------------------------------------------------
    @property
    def _open(self):
        return self._win is not None

    def start_step(self):
        if self._win is not None:
            raise RuntimeError("TelemetryRecorder: step already open")
        self._win = _StepWindow(self)
        with _LOCK:
            _OPEN_STEPS.append(self._win)
        return self._win

    def end_step(self, loss=None, **extra):
        win = self._win
        if win is None:
            raise RuntimeError("TelemetryRecorder: no open step")
        if loss is not None:
            win.loss = loss
        win.extra.update(extra)
        loss_val = None
        if win.loss is not None:
            # fetching the scalar double-duties as the device sync, so
            # step_ms covers the full computation, not just dispatch
            try:
                v = win.loss
                v = v.item() if hasattr(v, "item") else v
                loss_val = float(v)
            except Exception:
                loss_val = None
        t1 = time.perf_counter()
        with _LOCK:
            _OPEN_STEPS.remove(win)
        self._win = None
        step_s = t1 - win.t0
        compile_ms = win.compile_secs * 1000.0
        if compile_ms > 0:
            self.cache_misses += 1
            monitor.incr("telemetry.compile_cache_misses")
        else:
            self.cache_hits += 1
            monitor.incr("telemetry.compile_cache_hits")
        monitor.incr("telemetry.steps")

        execute_s = max(1e-9, step_s - win.compile_secs)
        tokens_per_sec = None
        if self.tokens_per_step:
            tokens_per_sec = self.tokens_per_step / execute_s
        flops_per_step = self.flops_per_step
        if flops_per_step is None and self.flops_per_token \
                and self.tokens_per_step:
            flops_per_step = self.flops_per_token * self.tokens_per_step
        mfu_val = None
        if flops_per_step is not None:
            peak = (self.peak_flops or 0.0) * max(1, int(self.n_devices))
            mfu_val = flops_per_step / execute_s / peak if peak else 0.0
        mem_bytes = self._live_bytes() if self.track_memory else None
        coll, comm_ms = self._collect_collectives(win.span_start)
        # compute-vs-communication decomposition: the wall-time
        # collective total and its bounded share of the step
        # (telemetry/comm_obs — validated by sink + trace_check)
        step_ms_total = step_s * 1000.0
        comm_frac = min(1.0, comm_ms / step_ms_total) \
            if step_ms_total > 0 else 0.0

        # an external step source (StepTimer) reports its OWN cache
        # counters; they override the recorder's window-derived ones
        extra = dict(win.extra)
        cache_hits = extra.pop("cache_hits", self.cache_hits)
        cache_misses = extra.pop("cache_misses", self.cache_misses)
        rec = make_step_record(
            step=self._step_idx, step_ms=step_s * 1000.0,
            compile_ms=compile_ms, rank=self.rank, loss=loss_val,
            tokens_per_sec=tokens_per_sec, mfu=mfu_val, mem_bytes=mem_bytes,
            cache_hits=cache_hits, cache_misses=cache_misses,
            collectives=coll,
            comm_ms=comm_ms if coll else None,
            comm_frac=comm_frac if coll else None, **extra)
        # the whole step is also a span, so the JSONL ledger and the
        # chrome trace describe the same intervals
        self.add_span(f"step {self._step_idx}", win.t0, step_s, cat="step")
        self._step_idx += 1
        self.records.append(rec)
        if self.sink is not None:
            self.sink.write(rec)
        return rec

    def record_external_step(self, step_ms, compile_ms, **kwargs):
        """Record a step measured elsewhere (StepTimer, bench phases)."""
        win = self.start_step()
        win.t0 = time.perf_counter() - step_ms / 1000.0
        win.compile_secs = compile_ms / 1000.0
        return self.end_step(**kwargs)

    @contextlib.contextmanager
    def step(self, **extra):
        win = self.start_step()
        win.extra.update(extra)
        try:
            yield win
        finally:
            self.end_step()

    def wrap(self, step_fn):
        """Wrap a train-step callable: every invocation becomes one
        recorded step, the (scalar) return value its loss."""
        def wrapped(*args, **kwargs):
            win = self.start_step()
            try:
                out = step_fn(*args, **kwargs)
                win.note(loss=out)
                return out
            finally:
                self.end_step()
        wrapped.__name__ = getattr(step_fn, "__name__", "step")
        return wrapped

    # -- context activation (TrainStep auto-record) ------------------------
    def __enter__(self):
        # under _LOCK: `current_recorder()` is consulted from other
        # threads (emit_record's fallback chain, span()), and an
        # unlocked append/remove raced those reads
        with _LOCK:
            _RECORDER_STACK.append(self)
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if self._win is not None:
            # abandoned window (the step raised): close it as an aborted
            # record instead of dropping the measurements — the crash
            # file and the JSONL then agree on when the run died
            try:
                self._win.loss = None   # likely poisoned; don't fetch
                self.end_step(aborted=True,
                              abort_reason=(exc_type.__name__
                                            if exc_type else "unknown"))
            except Exception:
                with _LOCK:
                    if self._win in _OPEN_STEPS:
                        _OPEN_STEPS.remove(self._win)
                self._win = None
        with _LOCK:
            _RECORDER_STACK.remove(self)
        if self.sink is not None:
            if self._owns_sink:
                # we opened this file handle; release it (a later write
                # through this recorder transparently reopens append)
                self.sink.close()
            elif hasattr(self.sink, "flush"):
                self.sink.flush()
        return False

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def _live_bytes():
        """Bytes the caching allocator has handed out on the current
        card (a host-side counter: no sync); None without a card."""
        if not torch.cuda.is_available():
            return None
        return int(torch.cuda.memory_allocated())

    def _collect_collectives(self, span_start):
        """Aggregate this step's wall-time collective spans (cat
        'collective') into the per-op breakdown + their total,
        (coll_or_None, comm_ms). Spans tagged traced=true cover trace
        time, not communication wall time — they stay in the chrome
        trace but never enter the step record's comm attribution."""
        coll, comm_ms = {}, 0.0
        for sp in self.spans[span_start:]:
            if sp.get("cat") != "collective":
                continue
            if (sp.get("args") or {}).get("traced"):
                continue
            ms, calls = coll.get(sp["name"], (0.0, 0))
            dur_ms = sp["dur"] * 1000.0
            coll[sp["name"]] = (ms + dur_ms, calls + 1)
            comm_ms += dur_ms
        return coll or None, comm_ms

    def export_chrome_tracing(self, path, extra_sources=(), align_on=None):
        """Export this recorder's spans (plus any peer ranks') as one
        Chrome trace. See sink.export_chrome_tracing."""
        from .sink import export_chrome_tracing as _export
        return _export(path, [self, *extra_sources], align_on=align_on)
