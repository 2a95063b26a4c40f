"""TrainStep and CapturedStep — the port's counterparts of jax.jit.

`TrainStep` is the port of paddle_tpu/jit/__init__.py::TrainStep. The
JAX TrainStep traces forward, backward and the optimizer update into
one jitted program. Here the step is eager: clear the gradients, run the
loss, backpropagate, clip the gradients with the optimizer's
`grad_clip` where the JAX step does (after the backward, before the
update), and apply the optimizer's rule to every trainable parameter of
the model (a parameter that received no gradient is updated with a zero
one, as in the JAX step) at the optimizer's `get_lr()` of that call, so
a scheduler stepped between calls takes effect at once. The step tells
the optimizer the parameters' names (`model.named_parameters()`), which
AdamW's `apply_decay_param_fun` and the state dict read. It returns the
loss tensor without reading it back, so a caller that times a run of
steps syncs once at its end. A model with `collect_moe_stats`
(moe.GPTMoE) leaves its routing-health vector of the step, detached and
unread, in `_last_moe`, as the JAX step does. Each step first drops
what `generate` keeps for the model (`generation.release`: the
decode-dtype weights, the loop buffers, the graphs), so none of it sits
beside training's memory.

Telemetry, as in the JAX step: while a `telemetry.TelemetryRecorder` is
active, every step is recorded (`telemetry.recorder.auto_step`): its
wall time up to the loss fetch at the close (the step's sync), the
compile split (nvcc builds and graph captures inside it), and on a
model with `collect_moe_stats` the `moe_*` fields (one fetch of the
stats vector; without a recorder nothing is fetched). `health=`
(None | True | dict | `telemetry.HealthConfig` |
`telemetry.HealthMonitor`) runs the health monitor's `guard()` around
each step: the hang watchdog armed, a black-box dump when an exception
escapes, and the numerics taps — global grad norm over the RAW grads
(before the clip), the update/param norm ratio, NaN/Inf counts over the
grads and the loss, and the loss — fetched, judged by the anomaly
detector and noted into the step record every `every_k` steps. The JAX
step computes the taps inside its program on every step; this eager
step builds them only on the steps that fetch
(`HealthMonitor.will_fetch()`), so with every_k > 1 the steps between
add no launch and no sync. The update ratio needs the parameters'
values before the update: a fetch step copies them first (one copy of
the trainable parameters, `tap_bytes` bytes, freed when the taps are
built; ~5.2 GB at GPT-3 1.3B's f32 parameters). The copy is made after
the backward has freed the activations.
`torch.compile`, CUDA graphs and the JAX step's `lint=` and
`resilience=` options are not carried over.

`CapturedStep` is the counterpart of `jax.jit` over a fixed-shape
inference step (the serving engine's decode and prefill steps,
`generate`'s token step): a cache of `torch.cuda.CUDAGraph`s keyed by
the caller's key, each captured over a body that reads static input
buffers and returns (or writes) static outputs. On a CUDA device:

- the first call of a key runs the body eagerly, as real work, on the
  step's own side stream (cuBLAS and the allocator settle there, as
  `torch.cuda.graph`'s warm-up rule asks), then captures the same body
  on that stream with `capture_error_mode="thread_local"` (the serve
  loop captures on its own thread while others may touch the card);
  capture executes nothing, and the call returns the warm-up's result;
- every later call replays the graph on the current stream and returns
  its static outputs, which the caller reads before the next replay of
  any graph of the step: the graphs share one memory pool
  (`torch.cuda.graph_pool_handle()`), so one graph's temporaries may
  sit where another's outputs were;
- the kernels' launch counters (`ops.kernel_registry`) are Python ints
  that a replay, which runs no Python, cannot advance: the counts the
  capture added are taken back out, kept with the graph and added on
  every replay, so a count still says how often the kernel ran;
- a capture or replay error raises; nothing falls back to the body.

On the CPU (the tests) the same body runs eagerly on every call, over
the same static buffers. A capture's host ms count as compile time of
the open telemetry step windows (`telemetry.recorder.note_compile`).
Every capture becomes a kind=compile record
(telemetry/compile_obs.py: family, signature, capture ms, the pool's
bytes, on a recapture the cause diff) on the step's sink, as the JAX
compile observatory records a compile; `invalidate()` drops the graphs
when the buffers they read are replaced (the engine's arenas after a
warm restart), and the next capture's record names the cause.
"""
import contextlib
import time

import torch

from . import monitor
from .telemetry.compile_obs import RecompileTracker
from .telemetry.health import as_monitor, device_health_stats, update_ratio
from .telemetry.recorder import auto_step, note_compile

__all__ = ["TrainStep", "CapturedStep"]


class TrainStep:
    def __init__(self, model, loss_fn, optimizer, health=None):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        optimizer._bind_names(named)
        self.params = [p for _, p in named]
        for p in self.params:
            optimizer._get_state(p)
        self._last_moe = None
        self.health = as_monitor(health)
        self._last_health = None
        self.tap_bytes = 0      # the last fetch step's pre-update copy

    def __call__(self, *batch):
        with auto_step() as win:
            if self.health is not None:
                with self.health.guard(win) as g:
                    loss = self._run_step(batch, self.health.will_fetch())
                    g.stage(self._last_health)
            else:
                loss = self._run_step(batch, False)
            if self._last_moe is not None \
                    and getattr(win, "recorder", None) is not None:
                from .moe.stats import note_step_stats
                note_step_stats(win, self._last_moe,
                                getattr(self.model, "moe_num_experts", None))
            win.note(loss=loss)
        return loss

    def _run_step(self, batch, taps):
        from .generation import release
        release(self.model)     # generate's kept decode buffers and graphs
        for p in self.params:
            p.grad = None
        loss = self.loss_fn(*batch)
        collect = getattr(self.model, "collect_moe_stats", None)
        mstats = collect() if collect is not None else None
        self._last_moe = None if mstats is None else mstats.detach()
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        self._last_health = None
        if taps:
            # the raw grads are judged before the clip may scale them
            stats = device_health_stats(loss.detach(), grads, None, None)
            old = [p.detach().clone() for p in self.params]
            self.tap_bytes = sum(t.numel() * t.element_size() for t in old)
        clip = self.optimizer._grad_clip
        if clip is not None:
            with torch.no_grad():
                grads = [g for _, g in clip(list(zip(self.params, grads)))]
        self.optimizer.update(self.params, grads)
        if taps:
            ratio = update_ratio([p.detach() for p in self.params], old)
            del old
            self._last_health = torch.cat(
                [stats[:1], ratio.reshape(1), stats[2:]])
        return loss.detach()


# bodies run eagerly on the card while set: how chip_smoke.py and
# serve_ab.py compare the captured steps with the same bodies run eager
_EAGER = False


@contextlib.contextmanager
def _eager_steps():
    """Run every CapturedStep's body eagerly on the card (the same body
    and buffers as the captured path), process-wide, while active."""
    global _EAGER
    prev, _EAGER = _EAGER, True
    try:
        yield
    finally:
        _EAGER = prev


def _launch_counts():
    from .ops.kernel_registry import kernels
    return [(k, k.launches) for k in kernels()]


class _Graph:
    __slots__ = ("graph", "outputs", "deltas")

    def __init__(self, graph, outputs, deltas):
        self.graph = graph
        self.outputs = outputs
        self.deltas = deltas        # [(Kernel, launches a replay)]


class CapturedStep:
    """Graphs of one engine or one model's `generate` steps, sharing a
    memory pool and a capture stream. `run(family, key, body)` is the
    step; `records` the capture records; `pool_bytes` the device memory
    the captures reserved; `capture_ms` their total host time.

    `graph_cls` replaces `torch.cuda.CUDAGraph` (a test's stub graph on
    the CPU); without it a CPU step runs its body eagerly."""

    def __init__(self, device, sink=None, engine=None, graph_cls=None):
        self.device = torch.device(device)
        self.sink = sink
        self.engine = engine
        if graph_cls is None and self.device.type == "cuda":
            graph_cls = torch.cuda.CUDAGraph
        self._graph_cls = graph_cls
        self.tracker = RecompileTracker(backend=self.device.type)
        self.graphs = {}            # key -> _Graph
        self._retired = []          # dropped graphs holding the pool
        self._pool = None
        self._stream = None
        self.pool_bytes = 0
        self.capture_ms = 0.0

    @property
    def records(self):
        return self.tracker.records

    def run(self, family, key, body, signature=None, step=0):
        """The step `key` of `family`: replay its graph, or (first call)
        run `body` eagerly and capture it; eagerly every call where
        nothing is captured. `signature` (a CompileSignature, or a
        callable made into one only at a capture) and `step` go into the
        capture record. Returns the body's result (a replay: the graph's
        static outputs)."""
        if self._graph_cls is None or _EAGER:
            return body()
        g = self.graphs.get(key)
        if g is None:
            return self._capture(family, key, body, signature, step)
        g.graph.replay()
        for k, n in g.deltas:
            k.launches += n
        return g.outputs

    def discard(self, pred):
        """Drop the graphs whose key satisfies `pred(key)` (the buffers
        they read are going away); the others keep the pool alive."""
        for key in [k for k in self.graphs if pred(k)]:
            del self.graphs[key]

    def invalidate(self, keep_pool=False):
        """Drop every graph (the buffers they read are being replaced);
        the pool goes with them. With `keep_pool` the dropped graphs,
        never replayed again, are held until the next capture has joined
        their pool (a pool lives while one of its graphs does), so that
        capture reuses the pool's blocks instead of reserving its own.
        The tracker keeps each family's last signature, so the next
        capture records its cause."""
        self._retired = (self._retired + list(self.graphs.values())
                         if keep_pool else [])
        self.graphs.clear()
        if not self._retired:
            self._pool = None

    def _capture(self, family, key, body, signature, step):
        cuda = self.device.type == "cuda"
        if cuda:
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            here = torch.cuda.current_stream(self.device)
            self._stream.wait_stream(here)
            ctx = torch.cuda.stream(self._stream)
        else:
            ctx = contextlib.nullcontext()
        with ctx:
            out = body()                    # the warm-up: real work
            before = _launch_counts()
            reserved = torch.cuda.memory_reserved(self.device) if cuda else 0
            t0 = time.perf_counter()
            graph = self._graph_cls(keep_graph=True)
            if self._pool is None and cuda:
                self._pool = torch.cuda.graph_pool_handle()
            graph.capture_begin(pool=self._pool,
                                capture_error_mode="thread_local")
            try:
                outputs = body()
            except BaseException:
                self._restore(before)
                try:
                    graph.capture_end()
                except Exception:   # noqa: BLE001 — the body's error wins
                    pass
                self._stream = None     # a broken capture taints it
                if not self.graphs and not self._retired:
                    self._pool = None   # no graph keeps it alive
                raise
            graph.capture_end()
            graph.instantiate()
            self._retired = []
            ms = (time.perf_counter() - t0) * 1e3
            pool = (torch.cuda.memory_reserved(self.device) - reserved
                    if cuda else 0)
            deltas = self._restore(before)
        if cuda:
            here.wait_stream(self._stream)
        self.pool_bytes += pool
        self.capture_ms += ms
        note_compile(ms / 1e3)      # the open step windows' compile split
        if callable(signature):
            signature = signature()
        rec = self.tracker.observe(family, signature, ms, step,
                                   pool_bytes=pool, key=repr(key),
                                   engine=self.engine)
        monitor.incr("compile.count")
        if rec["n_compiles"] > 1:
            monitor.incr("compile.recompiles")
        monitor.set_gauge("compile.last_ms", ms)
        if self.sink is not None:
            self.sink.write(rec)
        self.graphs[key] = _Graph(graph, outputs, deltas)
        return out

    @staticmethod
    def _restore(before):
        """Take the capture's counts back out; -> [(kernel, count)] of
        the kernels the capture reached."""
        deltas = []
        for k, n in before:
            if k.launches != n:
                deltas.append((k, k.launches - n))
                k.launches = n
        return deltas
