"""Mesh observatory: measured collective latencies against the planner's
link peaks, a persistent comm DB, and per-step comm attribution — the
port of paddle_tpu/telemetry/comm_obs.py.

- **measure_collective / sweep_mesh** — run each collective of the
  port's layer (`distributed/collective.py`: `_all_reduce_` as psum,
  `_all_gather`, `_reduce_scatter`, `_all_to_all`, `exchange` as
  ppermute) over a mesh axis's process group at one payload rung: the
  first call (the backend's setup) timed apart as `compile_ms`, then
  warm-up and the median of k timed calls (each ended by a device
  synchronize on the card) against an injectable clock. The per-rank
  operand is the payload, laid out as JAX's sweep lays the per-device
  operand (rows of 128 elements; a reduce-scatter's operand is the full
  array).
- **attribution** — each measurement as an achieved-bandwidth fraction
  against the SAME link table the planner prices with
  (`cost_model.LINK_BW_BY_CHIP` / `DCN_BW_BYTES`), with wire bytes by
  the comm-audit fraction convention (all_gather / reduce_scatter /
  all_to_all (n-1)/n, psum 2(n-1)/n, ppermute the whole operand; a
  group of one moves its operand once). gloo ranks move through the
  host and have no peak, and a CPU has none: `bw_frac` and
  `predicted_ms` are None there.
- **CommDB** — `paddle_tpu_torch/tools/comm_db.json` (the port's own,
  empty at first): best-known latency per (op, axis-size, payload,
  backend) key, rolled forward only by `commlab --update-db`, keep-best,
  non-finite refused. A measurement slower than the `comm_bw_degraded`
  band of its DB row fires that rule (telemetry/health.py); the DB
  reference rides on the record (db_ms).
- **rank_step_skew** — per-rank step-boundary skew over step records,
  the offline view of the `straggler` rule.

Opt-in flag: `PADDLE_TPU_TORCH_COMM_DB=/path/to/comm_db.json` (or `=1`
for the checked-in file) attaches the DB reference; unset, records carry
none and the drift rule has no jurisdiction.

Every measurement is a typed kind=commbench record
(sink.make_commbench_record, checked by telemetry/ledger_check.py) and
mirrored as `comm.*` gauges. CLI: `python -m
paddle_tpu_torch.tools.commlab` (--smoke / --selfcheck / --update-db).
"""
import functools
import json
import math
import os
import statistics
import time

import torch

from .. import monitor
from .sink import make_commbench_record

__all__ = [
    "CommDB", "CommMeasureResult", "DEFAULT_DB_PATH", "PAYLOAD_MAX_BYTES",
    "PAYLOAD_MIN_BYTES", "SWEEP_OPS", "attribution", "db_flag_path",
    "db_key", "device_peak_ici_bw", "measure_collective", "payload_sweep",
    "rank_step_skew", "sweep_axes", "sweep_mesh", "wire_bytes",
]

# the sweep matrix: the collectives the training step issues (pmean and
# pmax are all-reduces)
SWEEP_OPS = ("psum", "all_gather", "reduce_scatter", "all_to_all",
             "ppermute")

# log2 payload sweep bounds — 256 KiB (latency-dominated) to 256 MiB
# (bandwidth-saturated)
PAYLOAD_MIN_BYTES = 256 * 1024
PAYLOAD_MAX_BYTES = 256 * 1024 * 1024

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_DB_PATH = os.path.join(_PKG, "tools", "comm_db.json")

DB_SCHEMA = 1
ENV_FLAG = "PADDLE_TPU_TORCH_COMM_DB"

# second dim of every swept operand, so payload rounding only ever moves
# along the first (cut) dim
_SWEEP_COLS = 128


def payload_sweep(min_bytes=PAYLOAD_MIN_BYTES, max_bytes=PAYLOAD_MAX_BYTES):
    """The log2 payload ladder [min, 2*min, ..., <= max], in bytes."""
    out = []
    b = int(min_bytes)
    while b <= int(max_bytes):
        out.append(b)
        b *= 2
    return out


def db_key(op, axis_size, payload_bytes, backend):
    """``op|ax<n>|<payload_bytes>|<backend>`` — the DB's primary key."""
    return f"{op}|ax{int(axis_size)}|{int(payload_bytes)}|{backend}"


# ---------------------------------------------------------------------------
# peaks + attribution (the planner's own tables — one source of truth)
# ---------------------------------------------------------------------------

def device_peak_ici_bw(kind=None):
    """Aggregate link bytes/s of a device name (None: the current CUDA
    device), from the SAME `cost_model.LINK_BW_BY_CHIP` table the planner
    prices layouts with (JAX's name; on the H100 the link is NVLink).
    None when unknown (the CPU)."""
    from ..cost_model import device_peak_link_bw
    return device_peak_link_bw(kind)


# the comm-audit wire-fraction convention (JAX analysis/comm_audit.py;
# anything else, ppermute among them, moves its whole operand)
_SHARD = ("all_to_all", "all_gather", "reduce_scatter")
_ALLREDUCE = ("psum",)


def wire_bytes(op, payload_bytes, axis_size):
    """Wire traffic per participant for `op` moving a `payload_bytes`
    operand over an axis of `axis_size`: all_gather / reduce_scatter /
    all_to_all (n-1)/n, psum 2(n-1)/n (ring all-reduce), ppermute the
    whole operand, and the whole operand over an axis of one."""
    n = int(axis_size)
    payload = float(payload_bytes)
    if n <= 1:
        frac = 1.0
    elif op in _SHARD:
        frac = (n - 1) / n
    elif op in _ALLREDUCE:
        frac = 2.0 * (n - 1) / n
    else:
        frac = 1.0
    return float(payload * frac)


def attribution(op, payload_bytes, axis_size, time_ms, peak_bw=None,
                device_kind=None, over_dcn=False):
    """Attribute one measured collective against the planner's peaks:

    - wire_bytes — the convention's wire traffic of the operand;
    - achieved_bw — wire_bytes / measured seconds (None without a
      positive time);
    - bw_frac — achieved over peak, clamped to [0, 1] (None without a
      peak: gloo, the CPU);
    - predicted_ms — wire_bytes / peak * 1e3, the analytic floor
      `calibration_from_comm_records` ratios measured time against;
    - medium — 'dcn' when over_dcn, 'ici' (the record schema's word for
      the card's scale-up link) when a link peak resolved, else None.
    """
    from ..cost_model import DCN_BW_BYTES
    wb = wire_bytes(op, payload_bytes, axis_size)
    if peak_bw is None:
        peak_bw = float(DCN_BW_BYTES) if over_dcn \
            else device_peak_ici_bw(device_kind)
    t_s = time_ms / 1e3 if time_ms and time_ms > 0 else None
    out = {"wire_bytes": wb, "achieved_bw": None, "bw_frac": None,
           "predicted_ms": None, "peak_bw": peak_bw,
           "medium": ("dcn" if over_dcn
                      else ("ici" if peak_bw else None))}
    if t_s and wb:
        out["achieved_bw"] = wb / t_s
        if peak_bw:
            out["bw_frac"] = min(1.0, out["achieved_bw"] / peak_bw)
    if peak_bw and wb:
        out["predicted_ms"] = wb / peak_bw * 1e3
    return out


# ---------------------------------------------------------------------------
# the swept collectives
# ---------------------------------------------------------------------------

def _sweep_call(op, axis, mesh, payload_bytes, dtype, device):
    """One swept collective over `axis`'s process group: -> (call, the
    per-rank payload bytes actually moved). The operand is [rows, 128]
    (a reduce-scatter's: the full array, rows divisible by the axis)."""
    from ..distributed import collective as C
    from ..distributed import env
    if op not in SWEEP_OPS:
        raise ValueError(f"unknown sweep op {op!r} "
                         f"(expected one of {SWEEP_OPS})")
    n = env.axis_size(axis, mesh)
    group = mesh.get_group(axis)
    itemsize = torch.empty((), dtype=dtype).element_size()
    rows = max(1, int(payload_bytes) // (_SWEEP_COLS * itemsize))
    if op in ("all_to_all", "reduce_scatter"):
        rows = max(n, rows // n * n)
    x = torch.arange(rows * _SWEEP_COLS, device=device).reshape(
        rows, _SWEEP_COLS).to(dtype)
    if op == "psum":
        def call():
            return C._all_reduce_(x, C.ReduceOp.SUM, group, name="psum",
                                  axis=axis)
    elif op == "all_gather":
        def call():
            return C._all_gather(x, group, axis=axis)
    elif op == "reduce_scatter":
        chunks = list(x.chunk(n))

        def call():
            return C._reduce_scatter(chunks, group, axis=axis)
    elif op == "all_to_all":
        chunks = list(x.chunk(n))

        def call():
            return C._all_to_all(chunks, group, axis=axis)
    else:   # ppermute: a ring shift, one send and one receive a rank
        if n == 1:
            raise ValueError("ppermute over an axis of one is a local copy, "
                             "not a collective")
        i = env.axis_index(axis, mesh)

        def call():
            return C.exchange(x, axis, (i + 1) % n, (i - 1) % n).wait()
    return call, rows * _SWEEP_COLS * itemsize


def _timed_call(call, warmup, k, clock, cuda):
    """First call timed apart (`compile_ms`: the backend's setup), then
    warm-up and k timed calls, each ended by a device synchronize on
    the card; -> (median_ms, compile_ms, samples)."""
    def run():
        call()
        if cuda:
            torch.cuda.synchronize()
    t0 = clock()
    run()
    compile_ms = (clock() - t0) * 1e3
    for _ in range(max(0, warmup)):
        run()
    samples = []
    for _ in range(max(1, k)):
        t0 = clock()
        run()
        samples.append((clock() - t0) * 1e3)
    return statistics.median(samples), compile_ms, samples


class CommMeasureResult:
    """One measured (op, axis, payload) point, bandwidth-attributed."""

    __slots__ = ("op", "axis", "axis_size", "payload_bytes", "backend",
                 "time_ms", "compile_ms", "wire_bytes", "achieved_bw",
                 "bw_frac", "predicted_ms", "peak_bw", "medium",
                 "n_samples", "warmup", "db_ms")

    def __init__(self, **kw):
        for s in self.__slots__:
            setattr(self, s, kw.get(s))

    def key(self):
        return db_key(self.op, self.axis_size, self.payload_bytes,
                      self.backend)

    def to_record(self, rank=0, event="measure"):
        return make_commbench_record(
            op=self.op, axis=self.axis, axis_size=self.axis_size,
            payload_bytes=self.payload_bytes, backend=self.backend,
            time_ms=self.time_ms, rank=rank, compile_ms=self.compile_ms,
            wire_bytes=self.wire_bytes, achieved_bw=self.achieved_bw,
            peak_bw=self.peak_bw, bw_frac=self.bw_frac,
            predicted_ms=self.predicted_ms, medium=self.medium,
            db_key=self.key(), db_ms=self.db_ms,
            n_samples=self.n_samples, warmup=self.warmup, event=event)


def measure_collective(op, axis, mesh=None, payload_bytes=PAYLOAD_MIN_BYTES,
                       dtype=torch.float32, warmup=2, k=5, clock=None,
                       over_dcn=False, db=None):
    """Measure one (op, axis, payload) point on the live mesh (every rank
    of the axis calls it): the median of k timed calls, attributed
    against the planner's link table — none under gloo, whose ranks move
    through the host. Deterministic given `clock` (tests inject a fake
    counter). With the PADDLE_TPU_TORCH_COMM_DB flag set (or `db`
    passed) the best-known DB latency for this key rides on the result
    as `db_ms`."""
    import torch.distributed as dist
    from ..distributed import env

    clock = clock or time.perf_counter
    mesh = mesh if mesh is not None else env.current_mesh()
    if mesh is None:
        raise RuntimeError("measure_collective: no mesh — pass mesh= or "
                           "env.build_mesh(...) first")
    device = env.current_device()
    call, actual = _sweep_call(op, axis, mesh, payload_bytes, dtype, device)
    cuda = device.type == "cuda"
    time_ms, compile_ms, _ = _timed_call(call, warmup, k, clock, cuda)
    backend = dist.get_backend(mesh.get_group(axis))
    n = env.axis_size(axis, mesh)
    # gloo moves through the host: the link table's "gloo" entry has no
    # peak, so no roofline and no predicted floor
    kind = "gloo" if backend == "gloo" else (
        torch.cuda.get_device_name(device) if cuda else "cpu")
    attr = attribution(op, actual, n, time_ms, over_dcn=over_dcn,
                       device_kind=kind)
    db_ms = None
    ref = db if db is not None else _flagged_db()
    if ref is not None:
        db_ms = ref.best_ms(op, n, actual, backend)
    res = CommMeasureResult(
        op=op, axis=str(axis), axis_size=n, payload_bytes=actual,
        backend=backend, time_ms=time_ms, compile_ms=compile_ms,
        wire_bytes=attr["wire_bytes"], achieved_bw=attr["achieved_bw"],
        bw_frac=attr["bw_frac"], predicted_ms=attr["predicted_ms"],
        peak_bw=attr["peak_bw"], medium=attr["medium"],
        n_samples=max(1, k), warmup=max(0, warmup), db_ms=db_ms)
    _export_gauges(res)
    return res


def _export_gauges(res):
    """Mirror one measurement onto the metrics (`comm.<op>.*`)."""
    monitor.set_gauge(f"comm.{res.op}.ms", float(res.time_ms))
    if res.achieved_bw is not None:
        monitor.set_gauge(f"comm.{res.op}.achieved_bw",
                          float(res.achieved_bw))
    if res.bw_frac is not None:
        monitor.set_gauge(f"comm.{res.op}.bw_frac", float(res.bw_frac))
    monitor.incr("comm.measured")


def sweep_axes(mesh):
    """The mesh axes worth sweeping: size > 1 (a 1-axis collective
    moves nothing), in mesh axis order."""
    from ..distributed import env
    return [a for a in env.MESH_AXES if env.axis_size(a, mesh) > 1]


def sweep_mesh(mesh=None, ops=SWEEP_OPS, payloads=None, dtype=torch.float32,
               warmup=2, k=5, clock=None, over_dcn_axes=(), db=None,
               axes=None):
    """The full sweep: every op x every axis (default `sweep_axes`; an
    axis of one is given explicitly, as a one-rank NCCL sweep does, and
    then skips ppermute) x every payload rung. Returns
    [CommMeasureResult, ...] in deterministic (op, axis, payload)
    order."""
    from ..distributed import env

    mesh = mesh if mesh is not None else env.current_mesh()
    if mesh is None:
        raise RuntimeError("sweep_mesh: no mesh — pass mesh= or "
                           "env.build_mesh(...) first")
    payloads = list(payloads) if payloads is not None else payload_sweep()
    axes = list(axes) if axes is not None else sweep_axes(mesh)
    out = []
    for op in ops:
        for axis in axes:
            if op == "ppermute" and env.axis_size(axis, mesh) == 1:
                continue
            for payload in payloads:
                out.append(measure_collective(
                    op, axis, mesh=mesh, payload_bytes=payload,
                    dtype=dtype, warmup=warmup, k=k, clock=clock,
                    over_dcn=axis in over_dcn_axes, db=db))
    return out


# ---------------------------------------------------------------------------
# per-rank step-boundary skew (the straggler measurement)
# ---------------------------------------------------------------------------

def rank_step_skew(records):
    """Per-step, per-rank step-boundary skew over kind=step records
    from MULTIPLE ranks: for each step index seen on >= 2 ranks,
    skew_ms[rank] = that rank's step_ms minus the fastest rank's.
    Returns {step: {rank: skew_ms}}, only steps with >= 2 ranks."""
    by_step = {}
    for rec in records or ():
        if not isinstance(rec, dict) or rec.get("kind", "step") != "step":
            continue
        step, rank, ms = rec.get("step"), rec.get("rank"), rec.get("step_ms")
        if step is None or rank is None \
                or not isinstance(ms, (int, float)) or not math.isfinite(ms):
            continue
        by_step.setdefault(int(step), {})[int(rank)] = float(ms)
    out = {}
    for step, ranks in sorted(by_step.items()):
        if len(ranks) < 2:
            continue
        fastest = min(ranks.values())
        out[step] = {r: round(ms - fastest, 4)
                     for r, ms in sorted(ranks.items())}
    return out


# ---------------------------------------------------------------------------
# persistent measurement DB
# ---------------------------------------------------------------------------

def _finite(v):
    return isinstance(v, (int, float)) and math.isfinite(v)


class CommDB:
    """The comm DB: best-known latency per (op, axis-size, payload,
    backend) key. `update` REFUSES non-finite rows and with keep_best
    skips rows slower than the incumbent — losing a race is not an
    error."""

    def __init__(self, path=DEFAULT_DB_PATH):
        self.path = path
        self.entries = {}
        self.comment = ""
        if path and os.path.exists(path):
            with open(path) as f:
                data = json.load(f)
            self.entries = dict(data.get("entries", {}))
            self.comment = data.get("comment", "")

    def lookup(self, op, axis_size=None, payload_bytes=None, backend=None):
        """Entries for one op, narrowed by whatever axes the caller
        knows. Returns [(key, entry), ...]."""
        out = []
        for key, e in self.entries.items():
            if e.get("op") != op:
                continue
            if axis_size is not None and e.get("axis_size") != int(axis_size):
                continue
            if payload_bytes is not None \
                    and e.get("payload_bytes") != int(payload_bytes):
                continue
            if backend is not None and e.get("backend") != backend:
                continue
            out.append((key, e))
        return out

    def best_ms(self, op, axis_size, payload_bytes, backend):
        e = self.entries.get(db_key(op, axis_size, payload_bytes, backend))
        return e.get("best_ms") if e else None

    def update(self, results, keep_best=True):
        """Roll measured rows in. `results` is [CommMeasureResult] or
        [(key, entry_dict)]. Returns (updated_keys, refused) where
        refused is [(key, reason)] — non-finite timings never land."""
        updated, refused = [], []
        for item in results:
            if isinstance(item, CommMeasureResult):
                key = item.key()
                entry = {
                    "op": item.op, "axis_size": int(item.axis_size),
                    "payload_bytes": int(item.payload_bytes),
                    "backend": item.backend, "best_ms": item.time_ms,
                    "wire_bytes": item.wire_bytes,
                    "predicted_ms": item.predicted_ms,
                }
            else:
                key, entry = item
                entry = dict(entry)
                # the key IS the identity — backfill the lookup axes
                parts = key.split("|")
                if len(parts) == 4 and parts[1].startswith("ax"):
                    entry.setdefault("op", parts[0])
                    try:
                        entry.setdefault("axis_size", int(parts[1][2:]))
                        entry.setdefault("payload_bytes", int(parts[2]))
                    except ValueError:
                        pass
                    entry.setdefault("backend", parts[3])
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
        data = {"schema": DB_SCHEMA, "comment": self.comment,
                "entries": {k: self.entries[k]
                            for k in sorted(self.entries)}}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        return path


# ---------------------------------------------------------------------------
# opt-in DB reference resolution
# ---------------------------------------------------------------------------

def db_flag_path():
    """The opt-in flag: PADDLE_TPU_TORCH_COMM_DB unset/empty/'0' -> None
    (no DB reference attached, the drift rule has no jurisdiction); '1'
    -> the checked-in paddle_tpu_torch/tools/comm_db.json; anything else
    -> that path."""
    raw = os.environ.get(ENV_FLAG, "").strip()
    if not raw or raw == "0":
        return None
    return DEFAULT_DB_PATH if raw == "1" else raw


@functools.lru_cache(maxsize=8)
def _load_db(path):
    try:
        return CommDB(path)
    except Exception:
        return None


def clear_db_cache():
    _load_db.cache_clear()


def _flagged_db():
    path = db_flag_path()
    return _load_db(path) if path else None
