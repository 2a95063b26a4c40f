"""Framework stat counters — the Monitor/StatRegistry analog.

The port's copy of paddle_tpu/monitor.py (the JAX package's module
imports no JAX, but the port imports nothing of that package): the same
registry, stat kinds and names, with plain `threading` locks.

Parity target: `paddle/fluid/platform/monitor.h` (StatRegistry of named
int64 stats). Thread-safe named counters/gauges with a one-call
snapshot. In the port the serving engine is the producer: its
`serving.*` counters, gauges and latency histograms, under the JAX
engine's names so that one scrape configuration reads both.

Three stat kinds (Prometheus-compatible semantics, exported verbatim by
`telemetry.metrics_http`):

- counters (`incr`) are MONOTONIC — they only move forward; a negative
  delta raises instead of silently corrupting a rate() over the scrape;
- gauges (`set_gauge`) are point-in-time values that may move both ways
  (loss, grad norm, queue depth);
- histograms (`observe_hist`) are streaming log-bucketed distributions
  (latency samples), exported in Prometheus histogram text format so
  scrapes can compute quantiles over ANY window instead of trusting a
  producer-side p99 gauge frozen at the last sample.

`snapshot()` merges both plus process identity (``process.uptime_s``,
``process.rank``) so one scrape/dump is self-describing;
`snapshot_typed()` keeps the kinds separate for the /metrics exporter.
"""
import bisect
import os
import threading
import time

__all__ = ["incr", "set_gauge", "get", "get_gauge", "observe_hist",
           "get_hist", "snapshot_hists", "hist_quantile", "snapshot",
           "snapshot_typed", "StatRegistry", "LogHistogram"]

_START_TIME = time.monotonic()


def _default_rank():
    for var in ("PADDLE_TRAINER_ID", "RANK"):
        v = os.environ.get(var)
        if v is not None:
            try:
                return int(v)
            except ValueError:
                pass
    return 0


# default log-bucketed boundaries for latency histograms: powers of two
# from 0.25ms to ~2.3 hours (26 finite buckets + an overflow bucket).
# Log spacing keeps relative quantile error bounded by one bucket width
# (~2x) across six orders of magnitude with a fixed, tiny footprint —
# the streaming analog of a sorted-sample percentile.
DEFAULT_HIST_BOUNDS = tuple(0.25 * (2.0 ** i) for i in range(26))


class LogHistogram:    # guarded by: StatRegistry._mu
    """Streaming log-bucketed histogram (Prometheus `histogram` shape:
    cumulative `le` buckets + sum + count at export). `observe` is O(log
    buckets); `quantile` interpolates linearly inside the target bucket
    (the `histogram_quantile` convention), so its error is bounded by
    the bucket width rather than growing with the stream length.

    The EXPORTED series is cumulative over the process lifetime (the
    Prometheus model — scrapers window it with rate()), but `quantile`
    defaults to a bounded RECENT window (two rotating half-windows of
    `window` samples each): quantile gauges derived from it keep the
    sensitivity of a sliding sample buffer instead of needing 1% of
    all lifetime traffic to move a p99 after days of healthy uptime.
    Pass `recent=False` for the lifetime quantile.

    Samples must be finite and non-negative — same stance as the
    registry's monotonic counters: a negative or infinite latency is a
    producer bug (mixed clocks, uninitialized timestamp) and raises
    instead of silently corrupting every later scrape."""

    __slots__ = ("bounds", "counts", "total", "sum", "window",
                 "_win", "_prev", "_win_n", "_prev_n")

    def __init__(self, bounds=DEFAULT_HIST_BOUNDS, window=2048):
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError("histogram bounds must be strictly increasing")
        n = len(self.bounds) + 1                     # last = +Inf overflow
        self.counts = [0] * n
        self.total = 0
        self.sum = 0.0
        self.window = max(1, int(window))
        self._win = [0] * n                          # current half-window
        self._prev = [0] * n                         # previous half-window
        self._win_n = 0
        self._prev_n = 0

    def observe(self, value):
        v = float(value)
        if v != v or v < 0 or v in (float("inf"), float("-inf")):
            raise ValueError(
                f"histogram sample must be a finite non-negative "
                f"number, got {value!r} — a negative/non-finite latency "
                "is a producer bug (mixed clocks?)")
        i = bisect.bisect_left(self.bounds, v)
        self.counts[i] += 1
        self.total += 1
        self.sum += v
        self._win[i] += 1
        self._win_n += 1
        if self._win_n >= self.window:               # rotate half-windows
            self._prev, self._win = self._win, [0] * len(self.counts)
            self._prev_n, self._win_n = self._win_n, 0

    def quantile(self, q, recent=True):
        """Estimate the q-quantile (q in [0, 1]); None when empty.
        `recent=True` (default) computes over the last `window` to
        2*`window` samples; `recent=False` over the whole lifetime."""
        if recent:
            counts = [a + b for a, b in zip(self._prev, self._win)]
            total = self._prev_n + self._win_n
        else:
            counts, total = self.counts, self.total
        if not total:
            return None
        target = max(1.0, float(q) * total)
        cum = 0
        for i, c in enumerate(counts):
            if c and cum + c >= target:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) \
                    else self.bounds[-1]     # overflow clamps to top bound
                return lo + (hi - lo) * ((target - cum) / c)
            cum += c
        return self.bounds[-1]

    def to_dict(self):
        """{'bounds', 'counts', 'count', 'sum'} — counts are PER-bucket
        (the exporter renders the cumulative `le` series)."""
        return {"bounds": list(self.bounds), "counts": list(self.counts),
                "count": self.total, "sum": round(self.sum, 4)}


class StatRegistry:
    def __init__(self):
        self._mu = threading.Lock()
        self._stats = {}    # guarded by: _mu
        self._gauges = {}   # guarded by: _mu
        self._hists = {}    # guarded by: _mu

    def incr(self, name, delta=1):
        if delta < 0:
            raise ValueError(
                f"monitor counter {name!r} is monotonic; use set_gauge() "
                f"for values that can decrease (got delta={delta})")
        with self._mu:
            self._stats[name] = self._stats.get(name, 0) + delta
            return self._stats[name]

    def set_gauge(self, name, value):
        with self._mu:
            self._gauges[name] = float(value)

    def get(self, name, default=0):
        with self._mu:
            return self._stats.get(name, default)

    def get_gauge(self, name, default=0.0):
        with self._mu:
            return self._gauges.get(name, default)

    def observe_hist(self, name, value, bounds=None):
        """Add one sample to the named histogram (created lazily)."""
        with self._mu:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = LogHistogram(
                    bounds or DEFAULT_HIST_BOUNDS)
            h.observe(value)
            return h.total

    def get_hist(self, name):
        with self._mu:
            return self._hists.get(name)

    def hist_quantile(self, name, q, default=None):
        with self._mu:
            h = self._hists.get(name)
            v = h.quantile(q) if h is not None else None
            return default if v is None else v

    def snapshot_hists(self):
        """{name: LogHistogram.to_dict()} for the /metrics exporter."""
        with self._mu:
            return {name: h.to_dict() for name, h in self._hists.items()}

    def _identity(self):    # requires: _mu
        rank = _default_rank()
        return {"process.uptime_s": round(time.monotonic() - _START_TIME, 3),
                "process.rank": rank}

    def snapshot(self):
        """One flat dict: counters + gauges + process identity. Counter
        names win on collision (they existed first; don't reuse names)."""
        with self._mu:
            out = dict(self._gauges)
            out.update(self._stats)
            out.update(self._identity())
            return out

    def snapshot_typed(self):
        """{'counter': {...}, 'gauge': {...}} — the kind split the
        Prometheus text exposition needs for its # TYPE lines. Process
        identity (uptime, rank) rides with the gauges."""
        with self._mu:
            gauges = dict(self._gauges)
            gauges.update(self._identity())
            return {"counter": dict(self._stats), "gauge": gauges}


_registry = StatRegistry()

incr = _registry.incr
set_gauge = _registry.set_gauge
get = _registry.get
get_gauge = _registry.get_gauge
observe_hist = _registry.observe_hist
get_hist = _registry.get_hist
hist_quantile = _registry.hist_quantile
snapshot_hists = _registry.snapshot_hists
snapshot = _registry.snapshot
snapshot_typed = _registry.snapshot_typed
