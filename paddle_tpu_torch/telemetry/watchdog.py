"""Hang watchdog: heartbeat-armed stall detection + black-box dumps.

The port of paddle_tpu/telemetry/watchdog.py. A hung job's only symptom
is silence — no exception, no log line, no exit. The watchdog turns
silence into evidence:

- `step_opened()` / `step_closed()` (called by the health hook around
  every train step) arm and disarm a deadline; a daemon thread checks
  it a few times per deadline period.
- past the deadline, the watchdog writes a **black box**: every
  thread's Python stack (`sys._current_frames`), the open telemetry
  spans — so the stuck region is NAMED, not just located —,
  `monitor.snapshot()` (counters + gauges + uptime/rank), and the
  last-N step-record ring.
- the same `dump_black_box()` fires when an exception escapes a train
  step (HealthMonitor.on_exception), so crash and hang leave the same
  artifact.

An eager train step returns before the card finishes it, so a hung
device is seen where the host waits for it: the health monitor's every-k
fetch, which runs inside the armed window.
"""
import json
import os
import sys
import threading
import time
import traceback

from .. import monitor

__all__ = ["HangWatchdog", "dump_black_box"]


def _thread_stacks():
    """Python stacks of every live thread, keyed by thread name."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for tid, frame in sys._current_frames().items():
        label = f"{names.get(tid, 'unknown')} (tid={tid})"
        out[label] = traceback.format_stack(frame)
    return out


def dump_black_box(reason="", dump_dir=".", ring=(), path=None, extra=None):
    """Write the black-box crash file and return its path.

    Contents: reason, pid/rank/uptime, ALL thread stacks, open
    telemetry spans (name + category + age + thread — the stuck
    region is named here), the lock table (always empty: the port has
    no counterpart of the JAX package's lockwatch registry, whose table
    is empty too unless it was armed), the full monitor snapshot, and
    the last-N step records. Best-effort by design: a dump must never
    turn a hang into a crash, so every section degrades to an error
    string rather than raising.

    The dump runs on the watchdog's own thread while another thread may
    be capturing a CUDA graph (the serve loop's captures exclude only
    their own thread's work), so it makes no CUDA call at all: it reads
    Python state and the monitor's counters."""
    from . import recorder as _recorder

    def _section(fn):
        try:
            return fn()
        except Exception as e:          # pragma: no cover - defensive
            return f"<unavailable: {type(e).__name__}: {e}>"

    box = {
        "kind": "health_blackbox",
        "reason": reason,
        "time_unix": time.time(),
        "pid": os.getpid(),
        "threads": _section(_thread_stacks),
        "open_spans": _section(_recorder.open_spans),
        "locks": [],
        "monitor": _section(monitor.snapshot),
        "ring": list(ring),
    }
    if extra:
        box["extra"] = extra
    if path is None:
        path = os.path.join(
            dump_dir or ".",
            f"health_blackbox_{os.getpid()}_{int(time.time() * 1000)}.json")
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(box, f, indent=2, default=repr)
            f.flush()
            os.fsync(f.fileno())
    except OSError as e:                 # pragma: no cover - defensive
        sys.stderr.write(f"[health] black-box dump to {path} failed: {e}\n")
        return None
    sys.stderr.write(f"[health] black box dumped: {path} ({reason})\n")
    return path


class HangWatchdog:
    """Deadline heartbeat over train-step open/close events.

    wd = HangWatchdog(deadline_s=300, dump_dir="...")
    wd.start()
    wd.step_opened()   # arm      (train step begins)
    wd.step_closed()   # disarm   (train step returned)
    wd.beat()          # re-arm mid-step (a known-slow legit section)

    While armed, exceeding the deadline writes one black-box dump (per
    armed window — a 2-hour hang produces one file, not 2400) and
    advances the `health.watchdog_fires` counter. The checker thread is
    a daemon: an exiting process never blocks on it.
    """

    def __init__(self, deadline_s=300.0, dump_dir=".", ring=None,
                 poll_s=None, on_dump=None):
        self.deadline_s = float(deadline_s)
        self.dump_dir = dump_dir
        self.ring = ring if ring is not None else []
        self.on_dump = on_dump
        self._poll_s = poll_s if poll_s is not None else \
            min(max(self.deadline_s / 4.0, 0.02), 30.0)
        self._mu = threading.Lock()
        self._armed_at = None             # guarded by: _mu
        self._dumped_this_window = False  # guarded by: _mu
        self._stop = threading.Event()
        self._thread = None  # guarded by: none (caller-serialized lifecycle)
        self.dumps = []      # guarded by: none (checker-thread confined)
        self.fires = 0       # guarded by: none (checker-thread confined)

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="paddle-tpu-torch-hang-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=max(1.0, self._poll_s * 4))
        self._thread = None

    # -- heartbeat events ---------------------------------------------------
    def step_opened(self):
        with self._mu:
            self._armed_at = time.monotonic()
            self._dumped_this_window = False

    beat = step_opened

    def step_closed(self, record=None):
        with self._mu:
            self._armed_at = None
            self._dumped_this_window = False
        if record:
            self.ring.append(record)

    @property
    def armed(self):
        with self._mu:
            return self._armed_at is not None

    def overdue_s(self):
        """Seconds past the deadline for the current armed window
        (<= 0: not overdue / not armed). /healthz uses this."""
        with self._mu:
            if self._armed_at is None:
                return 0.0
            return (time.monotonic() - self._armed_at) - self.deadline_s

    # -- checker ------------------------------------------------------------
    def _run(self):
        while not self._stop.wait(self._poll_s):
            self._check()

    def _check(self):
        with self._mu:
            armed_at = self._armed_at
            already = self._dumped_this_window
            if armed_at is None or already:
                return
            stalled_s = time.monotonic() - armed_at
            if stalled_s <= self.deadline_s:
                return
            self._dumped_this_window = True
        self.fires += 1
        monitor.incr("health.watchdog_fires")
        path = self.dump(
            reason=f"train step stalled for {stalled_s:.1f}s "
                   f"(deadline {self.deadline_s:.1f}s)")
        if self.on_dump is not None:
            try:
                self.on_dump(path)
            except Exception:            # pragma: no cover - defensive
                pass

    def dump(self, reason=""):
        path = dump_black_box(reason=reason, dump_dir=self.dump_dir,
                              ring=list(self.ring))
        if path:
            self.dumps.append(path)
        return path
