"""Memory observatory: live device-memory ledger, KV occupancy telemetry,
OOM forensics, and the admission-headroom gauge.

The port of paddle_tpu/telemetry/mem_obs.py over PyTorch's CUDA caching
allocator. Torch has no `jax.live_arrays()`, so the ledger is built from
what the allocator reports and what the owners tag:

- **ledger** — `snapshot_ledger` sums the tensors the registered
  providers tag into their buckets (`params`, `opt_state`, `kv`),
  each storage once (views of one storage — a tied head, an arena
  slice — are not counted twice: tensors are deduplicated by
  `untyped_storage().data_ptr()`). On a CUDA device the rest of
  `torch.cuda.memory_stats(device)` is attributed too: `workspace` is
  `allocated_bytes.all.current` minus the tagged sum (activations,
  step temporaries, anything untagged), and `other` is
  `reserved_bytes.all.current` minus allocated — the bytes the
  caching allocator holds but has not handed out. `total_bytes` is
  the sum of the buckets, which is the reserved bytes: what the
  process holds on the card, and what a declared budget is compared
  with. The buckets PARTITION the total by construction, so the
  ledger rules (telemetry/ledger_check.py, and the JAX package's
  tools/trace_check.py) can recompute the sum from each record. On
  the CPU there are no allocator stats: `workspace` and `other` are 0
  and the total is the tagged sum. Only tensors on the ledger's device
  are counted.
- **provider registry** — `register_provider(name, bucket, owner,
  fn)`: the serving engine tags its weights, the paged KV cache its
  arenas. Providers are queried FRESH at snapshot time and hold their
  owner only by weakref — a dead owner drops out of the ledger instead
  of pinning its tensors; a provider that raises is skipped.
- **MemoryObservatory** — samples the ledger on a step cadence into
  typed kind=memsnap records (telemetry/sink.make_memsnap_record),
  mirrors `mem.*` gauges on /metrics, and gives the headroom
  (declared budget minus the sampled total) the serving engine's
  admission consults.
- **OOM forensics** — `is_oom` recognizes an allocation failure
  (`torch.OutOfMemoryError`, which `torch.cuda.OutOfMemoryError`
  names too, `MemoryError`, and the "out of memory" texts);
  `capture_postmortem` writes an event=postmortem record carrying the
  ledger, the largest tagged tensors, the KV pool state, the
  allocator's `num_alloc_retries` / `num_ooms` and its largest
  segments from `torch.cuda.memory_snapshot()`.

No projection: the port has no compile observatory, so a record's
`projected_bytes` / `projection_family` stay None (as in a JAX record
without a projection) and the `mem_projection_drift` rule has no
jurisdiction; `compile_families` is empty. The health hooks over these
records (`hbm_pressure`, `kv_thrash`) wait for a port of
telemetry/health.py.
"""
import threading
import weakref

import torch

from .. import monitor
from .sink import make_memsnap_record

__all__ = [
    "BUCKETS", "MemoryObservatory", "allocator_stats", "capture_postmortem",
    "is_oom", "register_provider", "registered_providers",
    "snapshot_ledger", "unregister_provider",
]

# the attribution buckets, in ledger order (sink.MEMSNAP_BUCKETS minus
# the _bytes suffix)
BUCKETS = ("params", "opt_state", "kv", "workspace", "other")

# ---------------------------------------------------------------------------
# provider registry (the tagging hooks)
# ---------------------------------------------------------------------------

_PROVIDERS = {}          # name -> (bucket, weakref-to-owner, fn)
_PROVIDER_LOCK = threading.Lock()
_PROVIDER_SEQ = [0]


def register_provider(name, bucket, owner, fn):
    """Register a byte-bucket provider: `fn(owner)` returns the CURRENT
    tensors belonging to `bucket` (params / opt_state / kv). The owner
    is held by weakref only — when it dies the provider drops out of the
    next snapshot and is removed from the registry, so tagging never
    extends an arena's lifetime (the engine rebuilds its KV cache on a
    warm restart; the old one must stay collectible). Returns the unique
    registry name (`name#<n>`)."""
    if bucket not in BUCKETS:
        raise ValueError(f"unknown bucket {bucket!r} "
                         f"(expected one of {BUCKETS})")
    with _PROVIDER_LOCK:
        _PROVIDER_SEQ[0] += 1
        key = f"{name}#{_PROVIDER_SEQ[0]}"
        _PROVIDERS[key] = (bucket, weakref.ref(owner), fn)
    return key


def unregister_provider(key):
    with _PROVIDER_LOCK:
        _PROVIDERS.pop(key, None)


def registered_providers():
    """[(name, bucket), ...] of providers whose owner is still alive."""
    with _PROVIDER_LOCK:
        items = list(_PROVIDERS.items())
    return [(k, bucket) for k, (bucket, ref, _fn) in items
            if ref() is not None]


def _query_providers():
    """Yield (bucket, tensors) per live provider; reap dead owners."""
    with _PROVIDER_LOCK:
        items = list(_PROVIDERS.items())
    dead = []
    out = []
    for key, (bucket, ref, fn) in items:
        owner = ref()
        if owner is None:
            dead.append(key)
            continue
        try:
            tensors = fn(owner)
        except Exception:
            continue          # a broken provider must not kill sampling
        if tensors:
            out.append((bucket, tensors))
    if dead:
        with _PROVIDER_LOCK:
            for key in dead:
                _PROVIDERS.pop(key, None)
    return out


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------

def allocator_stats(device):
    """The caching allocator's allocated and reserved bytes, retries and
    OOMs on a CUDA device, under `torch.cuda.memory_stats`'s names
    (`allocated_bytes.all.current`, `reserved_bytes.all.current`,
    `num_alloc_retries`, `num_ooms`); None for any other device (the CPU
    keeps no allocator stats). Read from the nested form of the same
    stats: flattening them all, as `memory_stats` does, costs the
    sampling step ~0.3 ms of host time."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    st = torch.cuda.memory_stats_as_nested_dict(device)
    if not st:
        return {}
    return {"allocated_bytes.all.current":
            st["allocated_bytes"]["all"]["current"],
            "reserved_bytes.all.current":
            st["reserved_bytes"]["all"]["current"],
            "num_alloc_retries": st.get("num_alloc_retries", 0),
            "num_ooms": st.get("num_ooms", 0)}


def _tagged(device):
    """{storage key: [bytes, bucket, tensor]} of the providers' tensors
    on `device`, each storage once (the first provider to name it wins
    the attribution)."""
    rows = {}
    for bucket, tensors in _query_providers():
        for t in tensors:
            if not isinstance(t, torch.Tensor) or t.device != device:
                continue
            st = t.untyped_storage()
            key = st.data_ptr()
            if key not in rows:
                rows[key] = [st.nbytes(), bucket, t]
    return rows


def _ledger_device(device):
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    for _bucket, tensors in _query_providers():
        for t in tensors:
            if isinstance(t, torch.Tensor) and t.is_cuda:
                return t.device
    return torch.device("cpu")


def snapshot_ledger(top_k=8, device=None):
    """Attribute the device's bytes once.

    Returns a plain dict: per-bucket byte sums (`<bucket>_bytes`),
    `total_bytes`, `n_arrays` (tagged storages), `top_arrays` ([{bytes,
    bucket, shape, dtype}, ...] of the largest tagged storages,
    descending, length <= top_k), `device`, and on a CUDA device the
    allocator's `stats`. `device=None` takes the device of the first
    tagged CUDA tensor, else the CPU."""
    dev = _ledger_device(device)
    rows = _tagged(dev)
    sums = {b: 0 for b in BUCKETS}
    for nb, bucket, _t in rows.values():
        sums[bucket] += nb
    tagged = sum(sums.values())
    stats = allocator_stats(dev)
    if stats is not None:
        allocated = int(stats.get("allocated_bytes.all.current", 0))
        reserved = int(stats.get("reserved_bytes.all.current", 0))
        sums["workspace"] = max(0, allocated - tagged)
        sums["other"] = max(0, reserved - tagged - sums["workspace"])
    top = sorted(rows.values(), key=lambda r: r[0], reverse=True)
    led = {f"{b}_bytes": sums[b] for b in BUCKETS}
    led["total_bytes"] = sum(sums.values())
    led["n_arrays"] = len(rows)
    led["top_arrays"] = [
        {"bytes": nb, "bucket": bucket, "shape": list(t.shape),
         "dtype": str(t.dtype)}
        for nb, bucket, t in top[:max(0, int(top_k))]]
    led["device"] = str(dev)
    led["stats"] = stats
    return led


def _top_segments(device, k):
    """The `k` largest segments of the caching allocator on `device`:
    [{bytes, allocated_bytes, segment_type, stream}, ...]."""
    segs = [s for s in torch.cuda.memory_snapshot()
            if s.get("device") == device.index]
    segs.sort(key=lambda s: s.get("total_size", 0), reverse=True)
    return [{"bytes": int(s.get("total_size", 0)),
             "allocated_bytes": int(s.get("allocated_size", 0)),
             "segment_type": s.get("segment_type"),
             "stream": s.get("stream")} for s in segs[:k]]


# ---------------------------------------------------------------------------
# OOM recognition
# ---------------------------------------------------------------------------

_OOM_TYPES = (MemoryError,) + ((torch.OutOfMemoryError,)
                               if hasattr(torch, "OutOfMemoryError")
                               else ())


def is_oom(exc):
    """True when `exc` is an allocation failure: the caching allocator's
    `torch.OutOfMemoryError` (`torch.cuda.OutOfMemoryError` is the same
    class), a host `MemoryError`, or an error whose text says out of
    memory (a CUDA launch that could not allocate, an XLA-style
    RESOURCE_EXHAUSTED)."""
    if isinstance(exc, _OOM_TYPES):
        return True
    text = f"{type(exc).__name__}: {exc}"
    return "RESOURCE_EXHAUSTED" in text or "Out of memory" in text \
        or "out of memory" in text


# ---------------------------------------------------------------------------
# the observatory
# ---------------------------------------------------------------------------

class MemoryObservatory:
    """Step-cadence device-memory sampler -> typed memsnap records.

    `sink` takes the records (None -> in memory only; `.records` keeps
    the tail either way); `hbm_budget_bytes` anchors the headroom —
    None means no budget was declared, so headroom is None and
    admission has no memory opinion; `kv_source` is a zero-arg callable
    returning the serving engine's pool/scheduler accounting dict
    (blocks_total/held/free/cached, cumulative evictions/admissions and
    the per-class dicts); `device` is the ledger's device (None: see
    `snapshot_ledger`)."""

    def __init__(self, sink=None, rank=0, hbm_budget_bytes=None,
                 kv_source=None, engine=None, device=None, top_k=8,
                 keep=64):
        self.sink = sink
        self.rank = int(rank)
        self.hbm_budget_bytes = None if hbm_budget_bytes is None \
            else int(hbm_budget_bytes)
        self.kv_source = kv_source
        self.engine = engine
        self.device = device
        self.top_k = int(top_k)
        self.keep = int(keep)
        self.records = []
        self.last = None
        self._prev_kv = None      # (step, evictions, admissions)

    # -- KV accounting ----------------------------------------------------

    def _kv_fields(self, step):
        if self.kv_source is None:
            return {}
        try:
            kv = self.kv_source()
        except Exception:
            return {}
        if not isinstance(kv, dict):
            return {}
        total = kv.get("blocks_total")
        held = kv.get("blocks_held")
        cached = kv.get("blocks_cached")
        fields = {
            "kv_blocks_total": total,
            "kv_blocks_held": held,
            "kv_blocks_free": kv.get("blocks_free"),
            "kv_blocks_cached": cached,
            "kv_evictions": kv.get("evictions"),
            "kv_admissions": kv.get("admissions"),
            "evictions_by_class": kv.get("evictions_by_class"),
            "admissions_by_class": kv.get("admissions_by_class"),
        }
        if isinstance(total, int) and total > 0:
            if isinstance(held, int) and isinstance(cached, int):
                fields["kv_occupancy"] = min(
                    1.0, (held + cached) / float(total))
            if isinstance(cached, int):
                fields["kv_cache_share"] = min(1.0, cached / float(total))
        # windowed per-step rates from the cumulative counters, written
        # ON the record; no previous sample -> no window -> no rate
        ev, adm = kv.get("evictions"), kv.get("admissions")
        if isinstance(ev, int) and isinstance(adm, int):
            prev = self._prev_kv
            if prev is not None and step > prev[0]:
                dstep = float(step - prev[0])
                fields["kv_eviction_rate"] = max(0, ev - prev[1]) / dstep
                fields["kv_admission_rate"] = max(0, adm - prev[2]) / dstep
            self._prev_kv = (step, ev, adm)
        return {k: v for k, v in fields.items() if v is not None}

    def _headroom(self, total):
        budget = self.hbm_budget_bytes
        return max(0, budget - total) if budget else None

    # -- sampling ---------------------------------------------------------

    def snapshot(self, step, device=None):
        """Sample the ledger once into a kind=memsnap record: emit it to
        the sink and mirror the mem.* gauges. Returns the record."""
        led = snapshot_ledger(top_k=self.top_k,
                              device=device if device is not None
                              else self.device)
        total = led["total_bytes"]
        rec = make_memsnap_record(
            "snapshot", step, total, rank=self.rank,
            params_bytes=led["params_bytes"],
            opt_state_bytes=led["opt_state_bytes"],
            kv_bytes=led["kv_bytes"],
            workspace_bytes=led["workspace_bytes"],
            other_bytes=led["other_bytes"],
            hbm_budget_bytes=self.hbm_budget_bytes,
            headroom_bytes=self._headroom(total),
            n_arrays=led["n_arrays"], engine=self.engine,
            **self._kv_fields(step))
        self._commit(rec)
        monitor.incr("mem.snapshots")
        return rec

    def capture_postmortem(self, error, step=None, device=None):
        """Capture-on-failure: write the forensic record an OOM leaves
        behind — the ledger at the failure (not at the last cadence
        tick), the largest tagged tensors, the KV pool state, and on a
        CUDA device the allocator's retry/OOM counts and its largest
        segments. Returns the record."""
        led = snapshot_ledger(top_k=self.top_k,
                              device=device if device is not None
                              else self.device)
        if step is None:
            step = (self.last or {}).get("step", 0) or 0
        total = led["total_bytes"]
        top = led["top_arrays"] or [
            {"bytes": 0, "bucket": "other", "note": "no tagged tensors"}]
        extra = {}
        stats = led["stats"]
        if stats is not None:
            extra = {"num_alloc_retries": int(stats.get("num_alloc_retries",
                                                        0)),
                     "num_ooms": int(stats.get("num_ooms", 0)),
                     "top_segments": _top_segments(
                         torch.device(led["device"]), self.top_k)}
        rec = make_memsnap_record(
            "postmortem", step, total, rank=self.rank,
            params_bytes=led["params_bytes"],
            opt_state_bytes=led["opt_state_bytes"],
            kv_bytes=led["kv_bytes"],
            workspace_bytes=led["workspace_bytes"],
            other_bytes=led["other_bytes"],
            hbm_budget_bytes=self.hbm_budget_bytes,
            headroom_bytes=self._headroom(total),
            n_arrays=led["n_arrays"], engine=self.engine,
            error=str(error) or "allocation failure",
            top_arrays=top, compile_families=[],
            **extra, **self._kv_fields(step))
        self._commit(rec)
        monitor.incr("mem.postmortems")
        return rec

    def _commit(self, rec):
        self.last = rec
        self.records.append(rec)
        del self.records[:-self.keep]
        if self.sink is not None:
            try:
                self.sink.write(rec)
            except Exception:
                pass
        _export_gauges(rec)

    # -- the admission signal --------------------------------------------

    def headroom_bytes(self):
        """Bytes between the last sampled total and the declared budget
        (clamped at 0), or None when no budget was declared or nothing
        has been sampled — the serving admission path treats None as
        'no memory opinion'."""
        if self.last is None:
            return None
        return self.last.get("headroom_bytes")


def _export_gauges(rec):
    """Mirror one ledger record onto /metrics."""
    for key in ("total_bytes", "params_bytes", "opt_state_bytes",
                "kv_bytes", "workspace_bytes", "other_bytes",
                "headroom_bytes", "n_arrays", "kv_occupancy",
                "kv_cache_share"):
        v = rec.get(key)
        if isinstance(v, (int, float)):
            monitor.set_gauge(f"mem.{key}", float(v))


def capture_postmortem(error, sink=None, step=0, rank=0, **kw):
    """One-shot postmortem without a standing observatory."""
    obs = MemoryObservatory(sink=sink, rank=rank, **kw)
    return obs.capture_postmortem(error, step=step)
