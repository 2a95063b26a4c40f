"""Deterministic fault injection for resilience drills — the port's
copy of paddle_tpu/resilience/chaos.py (a monkey's visits take a lock:
the port's checkpoint writes pieces on helper threads).

You don't know your checkpoint path survives a mid-save crash until
something has crashed mid-save ON PURPOSE. This module is the
in-process half of the chaos harness (`tools/chaos_drill.py` drives
the out-of-process half: SIGKILL at step N via a subprocess driver):

- **transient I/O errors** with a configured probability at named
  injection points (`save`, `commit`, `restore`, `fs`) — raised as
  OSError(EIO) tagged `.transient = True`, so the retry layer
  (`resilience.retry`) treats them exactly like a real storage blip;
- **slow writes** — a configured stall at the same points, for
  exercising the `checkpoint_stall` anomaly rule and save-time budgets;
- **corrupt-a-shard-after-write** — flip bytes in one file of a
  committed checkpoint, which the manifest digest verification must
  catch on restore.

Everything is seeded: the same ChaosConfig produces the same fault
schedule, so a drill that fails replays identically. Injection is
context-scoped (`with ChaosMonkey(cfg).active():`) — nothing in the
hot path pays more than a truthiness check when no monkey is active.
"""
import contextlib
import errno
import os
import random
import threading
import time

__all__ = ["ChaosConfig", "ChaosMonkey", "current", "inject",
           "corrupt_one_file"]

_ACTIVE = []     # innermost-last stack of active monkeys


class ChaosConfig:
    """Knobs for one chaos run.

    seed            RNG seed — same seed, same fault schedule
    io_error_rate   P(injected transient OSError) per injection point hit
    slow_write_s    stall injected at save/commit points (0: off)
    ops             injection points that may fault (default all)
    max_faults      hard cap on injected faults (None: unlimited) — a
                    drill can guarantee forward progress
    """

    def __init__(self, seed=0, io_error_rate=0.0, slow_write_s=0.0,
                 ops=("save", "commit", "restore", "fs"), max_faults=None):
        self.seed = int(seed)
        self.io_error_rate = float(io_error_rate)
        self.slow_write_s = float(slow_write_s)
        self.ops = tuple(ops)
        self.max_faults = max_faults

    def __repr__(self):
        return (f"ChaosConfig(seed={self.seed}, "
                f"io_error_rate={self.io_error_rate}, ops={self.ops})")


class ChaosError(OSError):
    """Injected transient I/O failure. Subclasses OSError(EIO) so
    un-instrumented except-clauses treat it as real weather; tagged
    `.transient = True` so `retry.is_transient` retries it."""

    transient = True

    def __init__(self, op, n):
        super().__init__(errno.EIO, f"chaos[{op}] injected I/O error #{n}")
        self.op = op


class ChaosMonkey:
    """Seeded fault injector. Activate with `with monkey.active():` —
    every `inject(op)` call inside the context consults it."""

    def __init__(self, config=None, sleep=None):
        self.config = config or ChaosConfig()
        self._rand = random.Random(self.config.seed)
        self._sleep = sleep or time.sleep
        self.faults = 0           # injected errors
        self.stalls = 0           # injected slow writes
        self._mu = threading.Lock()

    def _spent(self):
        mf = self.config.max_faults
        return mf is not None and self.faults >= mf

    def visit(self, op):
        """One injection-point hit: maybe stall, maybe raise."""
        c = self.config
        if op not in c.ops:
            return
        if c.slow_write_s > 0 and op in ("save", "commit"):
            with self._mu:
                self.stalls += 1
            self._sleep(c.slow_write_s)
        with self._mu:
            hit = c.io_error_rate > 0 and not self._spent() \
                and self._rand.random() < c.io_error_rate
            if hit:
                self.faults += 1
                n = self.faults
        if hit:
            raise ChaosError(op, n)

    @contextlib.contextmanager
    def active(self):
        _ACTIVE.append(self)
        try:
            yield self
        finally:
            _ACTIVE.remove(self)


def current():
    """The innermost active ChaosMonkey, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def inject(op):
    """Injection point: called by resilience.ckpt (save/commit/restore)
    at its I/O boundaries. No-op (one list peek)
    when no monkey is active."""
    m = _ACTIVE[-1] if _ACTIVE else None
    if m is not None:
        m.visit(op)


def corrupt_one_file(ckpt_dir, seed=0, skip=("manifest.json",),
                     prefer=None):
    """Corrupt-a-shard-after-write: pick one data file under `ckpt_dir`
    (deterministically, by seed) and flip its bytes in place. Returns
    the corrupted path (manifest verification must subsequently reject
    it), or None when the directory holds no eligible file. `prefer` is
    a path substring that narrows the pick (e.g. a leaf name, so the
    verifier's leaf attribution can be asserted)."""
    rand = random.Random(seed)
    candidates = []
    for root, _, files in os.walk(ckpt_dir):
        for name in sorted(files):
            if name in skip:
                continue
            p = os.path.join(root, name)
            if os.path.getsize(p) > 0:
                candidates.append(p)
    if prefer:
        narrowed = [p for p in candidates if prefer in p]
        candidates = narrowed or candidates
    if not candidates:
        return None
    path = rand.choice(candidates)
    with open(path, "rb") as f:
        data = bytearray(f.read())
    pos = rand.randrange(len(data))
    data[pos] ^= 0xFF
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    return path
