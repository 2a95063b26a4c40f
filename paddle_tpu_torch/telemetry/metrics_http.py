"""Prometheus text exposition of the port's monitor registry.

The port's copy of `prometheus_text` from
paddle_tpu/telemetry/metrics_http.py, unchanged: every counter as a
monotonic `counter`, every gauge as a `gauge`, every histogram as a true
`histogram` series (cumulative `le` buckets + _sum + _count), under the
same `paddle_tpu_` prefix and sanitized names, so one scrape
configuration reads the JAX engine and the port's. The serving HTTP
front (serving/http.py) serves it on GET /metrics. The JAX module's
training MetricsServer has no user in the port and is not copied.
"""
from .. import monitor

__all__ = ["prometheus_text"]

_PREFIX = "paddle_tpu_"


def _prom_name(name):
    out = []
    for ch in str(name):
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    sanitized = "".join(out)
    if sanitized and sanitized[0].isdigit():
        sanitized = "_" + sanitized
    return _PREFIX + sanitized


def _prom_value(v):
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f) if not float(f).is_integer() else str(int(f))


def _prom_le(bound):
    """le-label formatting: integral bounds print bare, others compact."""
    f = float(bound)
    return str(int(f)) if f.is_integer() else f"{f:g}"


def prometheus_text(last_record=None):
    """Render monitor.snapshot_typed() (+ optionally the last step
    record) as Prometheus exposition text. Counters keep their
    monotonic `# TYPE` so rate() works on the scrape; histograms
    (monitor.observe_hist, e.g. the serving latency distributions)
    render as true `histogram` series — cumulative `le` buckets + _sum
    + _count — so quantiles are computable AT SCRAPE TIME over any
    window, instead of trusting a producer-side percentile gauge that
    freezes whenever the producer stalls."""
    typed = monitor.snapshot_typed()
    lines = []
    for kind in ("counter", "gauge"):
        for name in sorted(typed[kind]):
            val = _prom_value(typed[kind][name])
            if val is None:
                continue
            pname = _prom_name(name)
            lines.append(f"# TYPE {pname} {kind}")
            lines.append(f"{pname} {val}")
    hists = monitor.snapshot_hists()
    for name in sorted(hists):
        h = hists[name]
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} histogram")
        cum = 0
        for bound, count in zip(h["bounds"], h["counts"]):
            cum += count
            lines.append(
                f'{pname}_bucket{{le="{_prom_le(bound)}"}} {cum}')
        lines.append(f'{pname}_bucket{{le="+Inf"}} {h["count"]}')
        lines.append(f"{pname}_sum {_prom_value(h['sum'])}")
        lines.append(f"{pname}_count {h['count']}")
    if last_record:
        for key in sorted(last_record):
            v = last_record[key]
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                continue
            val = _prom_value(v)
            if val is None:
                continue
            pname = _prom_name(f"last_step_{key}")
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {val}")
    return "\n".join(lines) + "\n"
