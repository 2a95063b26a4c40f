"""Kernel observatory: measured rooflines and a persistent timing DB over
the port's registered kernels — the measuring half of
paddle_tpu/telemetry/kernel_obs.py.

- **measure_kernel** — run a registration's seeded example
  (`ops.kernel_registry`: `example(rng, device)`, the main path's shape)
  through the kernel's wrapper and its plain version on the same inputs
  and report the median time of each and the kernel-vs-plain speedup.
  On the card each timed launch follows a read of 256 MB (the L2 holds
  none of its inputs and no dirty line) and is timed by its own pair of
  CUDA events, as PERF.md §6 times the kernels; `compile_ms` is the
  first call (a first-use nvcc build lands there), never in the median.
  `clock=` replaces the events by a host clock (the tests inject a fake
  one, which makes the measurement deterministic).
- **roofline** — combine the measured time with the registration's
  `cost(args)` (operations and bytes, each distinct byte once) and the
  card's peaks (telemetry/mfu.py: bf16 or f32 FLOP/s by the example's
  dtype, HBM bytes/s) into achieved fractions, a compute- vs
  memory-bound verdict, and `predicted_ms`, the least time the card
  could take — PERF.md §6's bound column, computed in code — which the
  health detector's `kernel_time_drift` rule judges the measured time
  against.
- **KernelDB** — best-known time per (kernel, shape signature, dtype,
  backend) key, kept at `build/paddle_tpu_torch/kernel_db.json`; `update`
  refuses non-finite rows and keeps the best.

Every measurement becomes a typed kind=kernelbench record
(telemetry/sink.make_kernelbench_record, the JAX validator's schema) and
`kernel.*` gauges on the monitor.

Not ported: the JAX module's block-size tuning (`tuned_param`,
`tuned_blocks`, `tune_flash_fwd`): it chooses Pallas block sizes from
the DB, and none of the port's kernels has such a knob.
"""
import json
import math
import os
import statistics
import time

import numpy as np
import torch

from .. import monitor
from .mfu import device_peak_flops, device_peak_hbm_bw
from .sink import make_kernelbench_record

__all__ = ["DEFAULT_DB_PATH", "KernelDB", "MeasureResult", "db_key",
           "dominant_dtype", "measure_kernel", "measure_registry",
           "roofline", "shape_signature"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DB_PATH = os.path.join(_REPO, "build", "paddle_tpu_torch",
                               "kernel_db.json")

DB_SCHEMA = 1

# the L2 flush before each timed launch: 256 MB of f32 zeros, read
FLUSH_ELEMS = 64 * 2 ** 20

_SHORT_DTYPE = {
    "float32": "f32", "float64": "f64", "bfloat16": "bf16",
    "float16": "f16", "int32": "i32", "int64": "i64", "int8": "i8",
    "uint8": "u8", "bool": "b1",
}


def _dt_short(dtype):
    name = str(dtype).replace("torch.", "")
    return _SHORT_DTYPE.get(name, name)


def _tensors(args, kwargs):
    leaves = list(args) + [v for _, v in sorted((kwargs or {}).items())]
    return [a for a in leaves if isinstance(a, torch.Tensor)]


def shape_signature(args, kwargs=None):
    """Stable shape/dtype signature of one example's inputs:
    ``f32[4,128],i32[40]`` — tensors only, python scalars excluded, in
    positional order. The DB's shape axis (the JAX format)."""
    return ",".join(f"{_dt_short(a.dtype)}[{','.join(map(str, a.shape))}]"
                    for a in _tensors(args, kwargs))


def dominant_dtype(args, kwargs=None):
    """The record's dtype axis: the first tensor argument's dtype."""
    ts = _tensors(args, kwargs)
    return _dt_short(ts[0].dtype) if ts else "?"


def db_key(kernel, sig, dtype, backend):
    """``kernel|sig|dtype|backend`` — the DB's primary key."""
    return f"{kernel}|{sig}|{dtype}|{backend}"


class MeasureResult:
    """One measured (kernel, inputs) point, roofline-attributed."""

    __slots__ = ("kernel", "sig", "dtype", "backend", "kernel_ms",
                 "fallback_ms", "speedup", "compile_ms", "flops",
                 "bytes_accessed", "roof", "n_samples", "warmup",
                 "config", "seed", "device")

    def __init__(self, **kw):
        for s in self.__slots__:
            setattr(self, s, kw.get(s))

    def to_record(self, rank=0, event="measure"):
        roof = self.roof or {}
        return make_kernelbench_record(
            kernel=self.kernel, sig=self.sig, backend=self.backend,
            kernel_ms=self.kernel_ms, rank=rank, dtype=self.dtype,
            fallback_ms=self.fallback_ms, speedup=self.speedup,
            compile_ms=self.compile_ms, flops=self.flops,
            bytes_accessed=self.bytes_accessed,
            flops_frac=roof.get("flops_frac"),
            bw_frac=roof.get("bw_frac"),
            predicted_ms=roof.get("predicted_ms"),
            bound=roof.get("bound"), config=self.config,
            db_key=db_key(self.kernel, self.sig, self.dtype,
                          self.backend),
            n_samples=self.n_samples, warmup=self.warmup,
            event=event, seed=self.seed, device=self.device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_call(fn, args, warmup, k, clock, device, flush):
    """(median ms, compile ms, samples) of `fn(*args)`. The first call
    is timed alone as compile_ms. On the card without `clock`: each of
    the k launches after a read of `flush`, timed by its own CUDA event
    pair; otherwise `clock` (seconds) around each call and a sync."""
    timer = clock or time.perf_counter
    t0 = timer()
    fn(*args)
    _sync(device)
    compile_ms = (timer() - t0) * 1e3
    for _ in range(max(0, warmup)):
        fn(*args)
    _sync(device)
    samples = []
    if clock is None and device.type == "cuda":
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(k)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(k)]
        for s, e in zip(starts, ends):
            flush.sum()
            s.record()
            fn(*args)
            e.record()
        torch.cuda.synchronize(device)
        samples = [s.elapsed_time(e) for s, e in zip(starts, ends)]
    else:
        for _ in range(max(1, k)):
            t0 = timer()
            fn(*args)
            _sync(device)
            samples.append((timer() - t0) * 1e3)
    return statistics.median(samples), compile_ms, samples


def roofline(flops, bytes_accessed, time_ms, peak_flops=None,
             peak_bw=None, device_kind=None, dtype="bfloat16"):
    """Place one measured point on the card's roofline. Returns a dict:

    - achieved_flops / achieved_bw — measured rates (None without the
      corresponding count or a positive time);
    - flops_frac / bw_frac — achieved over peak, clamped to [0, 1]
      (None where the peak tables answer None: the CPU);
    - predicted_ms — the floor max(flops / peak_flops, bytes / peak_bw),
      what `kernel_time_drift` judges measured time against;
    - bound — 'compute' | 'memory', whichever term sets the floor (None
      when either peak is unknown).

    `device_kind` (None: the current card) and `dtype` pick the peaks
    when they are not given."""
    if peak_flops is None:
        peak_flops = device_peak_flops(device_kind, dtype)
    if peak_bw is None:
        peak_bw = device_peak_hbm_bw(device_kind)
    t_s = time_ms / 1e3 if time_ms and time_ms > 0 else None
    out = {"achieved_flops": None, "achieved_bw": None,
           "flops_frac": None, "bw_frac": None,
           "predicted_ms": None, "bound": None,
           "peak_flops": peak_flops, "peak_hbm_bw": peak_bw}
    if t_s and flops:
        out["achieved_flops"] = flops / t_s
        if peak_flops:
            out["flops_frac"] = min(1.0, out["achieved_flops"]
                                    / peak_flops)
    if t_s and bytes_accessed:
        out["achieved_bw"] = bytes_accessed / t_s
        if peak_bw:
            out["bw_frac"] = min(1.0, out["achieved_bw"] / peak_bw)
    if peak_flops and peak_bw and (flops or bytes_accessed):
        t_compute = (flops or 0) / peak_flops
        t_memory = (bytes_accessed or 0) / peak_bw
        out["predicted_ms"] = max(t_compute, t_memory) * 1e3
        out["bound"] = "compute" if t_compute >= t_memory else "memory"
    return out


def measure_kernel(reg, seed=1234, warmup=2, k=5, clock=None,
                   time_fallback=True, args=None, config=None,
                   device=None, flush=None):
    """Measure one registration (`ops.kernel_registry.Kernel`) on its
    seeded example at the main path's shape (or on explicit `args`):
    the wrapper's median of k, the plain version's median on the SAME
    inputs, and the cost roofline. `device` None is the card (raises
    without one, as every entry point of the port does); `flush` is the
    tensor read before each timed launch (made here when None).
    Deterministic given `clock` and `seed`."""
    from ..device import resolve_device
    device = resolve_device(device)
    if args is None:
        args = reg.example(np.random.default_rng(seed), device=device)
    if flush is None and clock is None and device.type == "cuda":
        flush = torch.zeros(FLUSH_ELEMS, device=device)
    kernel_ms, compile_ms, _ = _timed_call(
        reg.wrapper, args, warmup, k, clock, device, flush)
    fallback_ms = speedup = None
    if time_fallback and reg.plain is not None:
        fallback_ms, _, _ = _timed_call(
            reg.plain, args, warmup, k, clock, device, flush)
        if kernel_ms > 0:
            speedup = fallback_ms / kernel_ms
    flops, nbytes = reg.cost(args) if reg.cost is not None else (None, None)
    kind = torch.cuda.get_device_name(device) \
        if device.type == "cuda" else "cpu"
    dtype = dominant_dtype(args)
    roof = roofline(flops, nbytes, kernel_ms, device_kind=kind,
                    dtype="float32" if dtype == "f32" else "bfloat16")
    res = MeasureResult(
        kernel=reg.name, sig=shape_signature(args), dtype=dtype,
        backend=device.type, kernel_ms=kernel_ms, fallback_ms=fallback_ms,
        speedup=speedup, compile_ms=compile_ms,
        flops=None if flops is None else int(flops),
        bytes_accessed=None if nbytes is None else int(nbytes), roof=roof,
        n_samples=max(1, k), warmup=max(0, warmup), config=config,
        seed=seed, device=kind)
    _export_gauges(res)
    return res


def _export_gauges(res):
    """Mirror one measurement onto the monitor (the /metrics scrape)."""
    name = res.kernel
    monitor.set_gauge(f"kernel.{name}.ms", float(res.kernel_ms))
    if res.speedup is not None:
        monitor.set_gauge(f"kernel.{name}.speedup", float(res.speedup))
    roof = res.roof or {}
    if roof.get("flops_frac") is not None:
        monitor.set_gauge(f"kernel.{name}.flops_frac",
                          float(roof["flops_frac"]))
    if roof.get("bw_frac") is not None:
        monitor.set_gauge(f"kernel.{name}.bw_frac",
                          float(roof["bw_frac"]))
    monitor.incr("kernel.measured")


def measure_registry(registry=None, seeds=(1234,), warmup=2, k=5,
                     clock=None, device=None):
    """Measure every registered kernel (or the `Kernel`s in `registry`)
    once per seed. Returns [MeasureResult, ...] in registry order."""
    from ..device import resolve_device
    from ..ops.kernel_registry import kernels
    device = resolve_device(device)
    regs = kernels() if registry is None else list(registry)
    flush = torch.zeros(FLUSH_ELEMS, device=device) \
        if clock is None and device.type == "cuda" else None
    return [measure_kernel(reg, seed=seed, warmup=warmup, k=k, clock=clock,
                           device=device, flush=flush)
            for reg in regs for seed in seeds]


def _finite(v):
    return isinstance(v, (int, float)) and math.isfinite(v)


class KernelDB:
    """Best-known time per (kernel, shape signature, dtype, backend)
    key. `update` REFUSES non-finite rows: a NaN that slips into the DB
    would silently disarm every later comparison against it."""

    def __init__(self, path=DEFAULT_DB_PATH):
        self.path = path
        self.entries = {}
        self.comment = ""
        if path and os.path.exists(path):
            with open(path) as f:
                data = json.load(f)
            self.entries = dict(data.get("entries", {}))
            self.comment = data.get("comment", "")

    def lookup(self, kernel, sig=None, dtype=None, backend=None):
        """Entries for one kernel, narrowed by whatever axes the caller
        knows. Returns [(key, entry), ...]."""
        out = []
        for key, e in self.entries.items():
            if e.get("kernel") != kernel:
                continue
            if sig is not None and e.get("sig") != sig:
                continue
            if dtype is not None and e.get("dtype") != dtype:
                continue
            if backend is not None and e.get("backend") != backend:
                continue
            out.append((key, e))
        return out

    def best_ms(self, kernel, sig, dtype, backend):
        e = self.entries.get(db_key(kernel, sig, dtype, backend))
        return e.get("best_ms") if e else None

    def update(self, results, keep_best=True):
        """Roll measured rows in. `results` is [MeasureResult] or
        [(key, entry_dict)]. Returns (updated_keys, refused) where
        refused is [(key, reason)] — non-finite timings never land, and
        with keep_best a slower row than the incumbent is skipped (not
        refused: losing a race is not an error)."""
        updated, refused = [], []
        for item in results:
            if isinstance(item, MeasureResult):
                key = db_key(item.kernel, item.sig, item.dtype,
                             item.backend)
                entry = {
                    "kernel": item.kernel, "sig": item.sig,
                    "dtype": item.dtype, "backend": item.backend,
                    "best_ms": item.kernel_ms,
                    "fallback_ms": item.fallback_ms,
                    "flops": item.flops,
                    "bytes_accessed": item.bytes_accessed,
                }
                if item.device is not None:
                    entry["device"] = item.device
                if item.config:
                    entry["config"] = dict(item.config)
            else:
                key, entry = item
                entry = dict(entry)
                # the key IS the identity — backfill the lookup axes
                # from it so a hand-built (key, entry) pair can't ship
                # an entry lookup() would never find
                parts = key.split("|")
                if len(parts) == 4:
                    for axis, val in zip(
                            ("kernel", "sig", "dtype", "backend"), parts):
                        entry.setdefault(axis, val)
            ms = entry.get("best_ms")
            if not _finite(ms) or ms < 0:
                refused.append(
                    (key, f"REFUSED: non-finite best_ms {ms!r}"))
                continue
            bad = [k for k, v in entry.items()
                   if isinstance(v, float) and not math.isfinite(v)]
            if bad:
                refused.append(
                    (key, f"REFUSED: non-finite value(s) in {bad}"))
                continue
            old = self.entries.get(key)
            if keep_best and old and _finite(old.get("best_ms")) \
                    and old["best_ms"] <= ms:
                continue
            self.entries[key] = entry
            updated.append(key)
        return updated, refused

    def save(self, path=None):
        path = path or self.path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        data = {"schema": DB_SCHEMA, "comment": self.comment,
                "entries": {k: self.entries[k]
                            for k in sorted(self.entries)}}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        return path
