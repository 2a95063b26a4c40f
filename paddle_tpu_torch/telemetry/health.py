"""Training health monitor: numerics taps + anomaly detection.

The port of paddle_tpu/telemetry/health.py. The flight recorder
(recorder.py) tells what a step COST; this module watches a job that is
RUNNING WRONG — NaN'd grads silently poisoning weights, a loss spike
hours in, a step-time regression — and a sibling watchdog (watchdog.py)
catches the job that stops running at all.

Three pieces:

- **Numerics taps** (`device_health_stats`) — global grad-norm over the
  raw (unclipped) grads, the update/param norm ratio, and NaN/Inf
  counts (the loss included), computed on the device as one (5,) f32
  tensor. The JAX step builds them inside its traced program on every
  step and fetches them every `every_k`; the port's step is eager, so
  `jit.TrainStep` builds them only on the steps that fetch
  (`HealthMonitor.will_fetch()`): with `every_k > 1` a step between
  fetches adds no launch and no sync. The fetch (one tiny transfer) is
  the window's only sync, and it happens inside `guard()`, with the
  hang watchdog armed — an eager step returns before its device work
  ends, so a hung card shows only at that sync. The sharded steps
  (`ShardedTrainStep`, `PipelineParallel`) tap their pieces with
  `health_rows` and `sharded_health_stats`: each parameter's squares
  and counts summed over the ranks that hold its other pieces by the
  rule their clips use, so the fetched scalars are global, as GSPMD
  makes the JAX step's.

- **Anomaly detector** (`AnomalyDetector`) — pure host logic over
  records, the JAX rules unchanged: hard NaN/Inf (`nan`), `loss_spike`,
  `grad_explosion`, `step_time_regression`, `phase_error`,
  `recompile_storm`, `hbm_projection_drift`, `flops_drift`,
  `checkpoint_failed`, `checkpoint_stall`, `kernel_time_drift`,
  `comm_bw_degraded`, `straggler`, `tail_latency`, `hbm_pressure`,
  `kv_thrash` and `mem_projection_drift`. Rules over record kinds
  nothing in the port writes yet (commbench, ckpt, multi-rank steps,
  compile records with a projection) are ported all the same: the same
  records fire the same anomalies in both packages, in flight and in an
  offline replay (`paddle_tpu_torch.tools.healthwatch`).

- **HealthMonitor** — ties taps + detector + watchdog together behind
  the `health=` hook: normalizes config, applies the configured action
  (`warn` / `record` / `raise` HealthError), advances the
  `health.anomalies` / `health.nan_steps` monitor counters, exports
  last-seen values as monitor gauges, and arms/disarms the hang
  watchdog around each step. One difference from the JAX guard: a
  HealthError that `action='raise'` throws out of the step's close is
  an exception escaping the step, so it leaves the same black-box dump
  any other escaping exception does (`dump_on_exception`); the JAX
  guard raises it after its `try` and dumps nothing.
"""
import collections
import contextlib
import math
import threading
import time
import warnings

from .. import monitor

__all__ = ["HealthConfig", "HealthError", "Anomaly", "AnomalyDetector",
           "HealthMonitor", "as_monitor", "device_health_stats",
           "update_ratio", "health_rows", "sharded_health_stats",
           "HEALTH_STAT_FIELDS"]

# layout of the stacked device stats array (one (5,) f32 per step)
HEALTH_STAT_FIELDS = ("grad_norm", "update_ratio", "nan_count",
                      "inf_count", "loss")

_ACTIONS = ("warn", "record", "raise")


class HealthError(RuntimeError):
    """Raised by action='raise' when an anomaly fires (after counters
    and gauges are advanced, so the crash is still triagable)."""

    def __init__(self, anomalies):
        self.anomalies = list(anomalies)
        super().__init__("; ".join(a.message for a in self.anomalies))


class HealthConfig:
    """Knobs for the in-flight health monitor.

    every_k           fetch the device stats every k-th step (k>1: zero
                      per-step host transfer; the fetch is the only sync)
    action            'warn' (default) | 'record' | 'raise' on anomaly
    window            rolling-window length for the z-score rules
    min_points        points required before a z-rule may fire
    z_loss/z_grad     z-score thresholds for spike/explosion rules
    z_step_time       z threshold for the step-time regression rule
    rel_step_time     AND-guard: step time must also exceed this multiple
                      of the window median (kills micro-jitter flags)
    storm_compiles    recompile-storm rule: this many RECOMPILES (compile
                      records with n_compiles > 1) ...
    storm_window_steps ... within this many steps fire `recompile_storm`
    hbm_drift_tol     relative drift between a compile record's measured
                      hbm.total_bytes and its hbm_projected_bytes (the
                      sharding_lint SH206 projection) that fires
                      `hbm_projection_drift`
    flops_drift_tol   relative drift between a compile record's
                      cost.flops and its analytic_flops (the peak-FLOPs
                      table MFU claims ride on) that fires `flops_drift`
    kernel_drift_tol  multiplicative tolerance between a kernelbench
                      record's measured kernel_ms and its roofline-
                      predicted predicted_ms (telemetry/kernel_obs):
                      `kernel_time_drift` fires when the ratio leaves
                      [1/(1+tol), 1+tol] — symmetric in log space so
                      BOTH directions are reachable (slower: the
                      kernel lost its roofline position; faster than
                      the roofline floor: the KN503 counts the
                      prediction rides on are inflated). Latched per
                      kernel.
    comm_bw_tol       multiplicative tolerance between a commbench
                      record's measured time_ms and its best-known DB
                      latency db_ms (telemetry/comm_obs via
                      tools/comm_db.json): `comm_bw_degraded` fires when
                      measured exceeds (1+tol) x db_ms — ONE-SIDED,
                      faster than the DB is good news the next
                      --update-db rolls in. Latched per op. Records
                      without db_ms (flag off, or no DB row for the
                      key) are exempt: no reference, no jurisdiction.
    straggler_rel     per-rank step-boundary skew rule: a rank whose
                      step_ms exceeds the step's fastest rank by this
                      relative fraction ...
    straggler_abs_ms  ... AND by at least this many absolute ms fires
                      `straggler` (latched per rank; silent when only
                      one rank reports — no skew to judge). A slow rank
                      holds every collective barrier open for the whole
                      mesh, which is why this lives with the comm rules.
    ckpt_stall_s      a kind=ckpt commit record whose save_ms exceeds
                      this many seconds fires `checkpoint_stall`
                      (resilience.CheckpointManager records)
    tail_cause_frac   a kind=reqtrace record whose dominant latency
                      cause is PATHOLOGICAL (queue_wait / preemption /
                      restart / cow_fork — telemetry.reqtrace) with at
                      least this fraction of the request's end-to-end
                      time counts toward `tail_latency`
    tail_cause_count  fire `tail_latency` once this many requests are
                      dominated by the SAME pathological cause (latched
                      per cause: one page per pathology, not per
                      request)
    hbm_pressure_frac memory-observatory records (kind='memsnap',
                      telemetry/mem_obs via tools/memwatch): a ledger
                      whose total_bytes exceeds this fraction of the
                      hbm_budget_bytes riding ON the record fires
                      `hbm_pressure` — ONE-SIDED and latched per
                      engine/rank. Records without a budget are
                      exempt: no budget declared, no jurisdiction.
    kv_thrash_ratio   `kv_thrash` fires when a memsnap record's
                      kv_eviction_rate exceeds this multiple of its
                      kv_admission_rate (evicting faster than the pool
                      admits means the cache is cannibalizing itself)
                      ...
    kv_thrash_min_rate ... AND the eviction rate is at least this many
                      blocks/step — an idle pool evicting a stray
                      block must not page. Latched per engine/rank;
                      records without rates (first snapshot — no
                      window yet) are exempt.
    mem_reconcile_tol multiplicative tolerance between a memsnap
                      record's live total_bytes and the compile
                      observatory's static projected_bytes riding on
                      the record: `mem_projection_drift` fires when the
                      ratio leaves [1/(1+tol), 1+tol] — either side
                      means the static planning numbers no longer
                      describe what the chip actually holds. Latched
                      per projection_family.
    hang_deadline_s   arm a HangWatchdog with this deadline (None: off)
    dump_dir          where black-box dumps go ('.' default)
    dump_on_exception fire the black-box dump when an exception escapes
                      a train step (default True)
    ring_size         last-N step-record ring kept for dumps / /steps
    """

    def __init__(self, every_k=8, action="warn", window=64, min_points=8,
                 z_loss=8.0, z_grad=8.0, z_step_time=8.0,
                 rel_step_time=1.5, storm_compiles=5, storm_window_steps=32,
                 hbm_drift_tol=0.15, flops_drift_tol=0.25,
                 kernel_drift_tol=3.0, comm_bw_tol=1.0,
                 straggler_rel=0.5, straggler_abs_ms=10.0,
                 ckpt_stall_s=300.0, tail_cause_frac=0.6,
                 tail_cause_count=4, hbm_pressure_frac=0.92,
                 kv_thrash_ratio=2.0, kv_thrash_min_rate=1.0,
                 mem_reconcile_tol=0.25, hang_deadline_s=None,
                 dump_dir=".", dump_on_exception=True, ring_size=64):
        if action not in _ACTIONS:
            raise ValueError(f"health action must be one of {_ACTIONS}, "
                             f"got {action!r}")
        if every_k < 1:
            raise ValueError(f"every_k must be >= 1, got {every_k}")
        self.every_k = int(every_k)
        self.action = action
        self.window = int(window)
        self.min_points = int(min_points)
        self.z_loss = float(z_loss)
        self.z_grad = float(z_grad)
        self.z_step_time = float(z_step_time)
        self.rel_step_time = float(rel_step_time)
        self.storm_compiles = int(storm_compiles)
        self.storm_window_steps = int(storm_window_steps)
        self.hbm_drift_tol = float(hbm_drift_tol)
        self.flops_drift_tol = float(flops_drift_tol)
        self.kernel_drift_tol = float(kernel_drift_tol)
        self.comm_bw_tol = float(comm_bw_tol)
        self.straggler_rel = float(straggler_rel)
        self.straggler_abs_ms = float(straggler_abs_ms)
        self.ckpt_stall_s = float(ckpt_stall_s)
        self.tail_cause_frac = float(tail_cause_frac)
        self.tail_cause_count = int(tail_cause_count)
        self.hbm_pressure_frac = float(hbm_pressure_frac)
        self.kv_thrash_ratio = float(kv_thrash_ratio)
        self.kv_thrash_min_rate = float(kv_thrash_min_rate)
        self.mem_reconcile_tol = float(mem_reconcile_tol)
        self.hang_deadline_s = hang_deadline_s
        self.dump_dir = dump_dir
        self.dump_on_exception = bool(dump_on_exception)
        self.ring_size = int(ring_size)

    def __repr__(self):
        return (f"HealthConfig(every_k={self.every_k}, "
                f"action={self.action!r}, window={self.window})")


class Anomaly:
    """One detected anomaly: kind + where + how far out of band."""

    def __init__(self, kind, step, value, message, expected=None, z=None):
        self.kind = kind
        self.step = step
        self.value = value
        self.message = message
        self.expected = expected
        self.z = z

    def to_dict(self):
        d = {"kind": self.kind, "step": self.step,
             "value": _json_safe(self.value), "message": self.message}
        if self.expected is not None:
            d["expected"] = _json_safe(self.expected)
        if self.z is not None:
            d["z"] = _json_safe(self.z)
        return d

    def __repr__(self):
        return f"Anomaly({self.kind} @ step {self.step}: {self.message})"


def _json_safe(v):
    if isinstance(v, float) and not math.isfinite(v):
        return repr(v)
    return v


def _finite(v):
    return isinstance(v, (int, float)) and math.isfinite(v)


class _Window:
    """Rolling mean/std/median window with a relative std floor (a
    near-constant series must not turn noise into infinite z-scores)."""

    def __init__(self, size):
        self._buf = collections.deque(maxlen=size)

    def __len__(self):
        return len(self._buf)

    def add(self, v):
        self._buf.append(float(v))

    def stats(self):
        n = len(self._buf)
        mean = sum(self._buf) / n
        var = sum((v - mean) ** 2 for v in self._buf) / n
        std = max(math.sqrt(var), abs(mean) * 0.01, 1e-9)
        med = sorted(self._buf)[n // 2]
        return mean, std, med

    def z(self, v):
        mean, std, _ = self.stats()
        return (v - mean) / std


class AnomalyDetector:
    """Stateful rule engine over a stream of records.

    `observe(record)` takes one step-record dict (the JSONL schema, or
    the partial dict HealthMonitor assembles in flight — only keys that
    are present are judged) and returns the anomalies it triggered.
    Rules:

    - nan                  nan_count/inf_count > 0, or a non-finite
                           loss/grad_norm/update_ratio value
    - loss_spike           loss z-score above z_loss vs the rolling
                           window (upward only — a falling loss is the
                           point of training)
    - grad_explosion       grad_norm z-score above z_grad (upward)
    - step_time_regression step time z above z_step_time AND above
                           rel_step_time x window median; records with
                           compile_ms > 0 are exempt (recompiles are
                           legitimately slow) and never enter the window
    - phase_error          a bench phase record carrying an 'error' key
                           or a non-finite metric value
    - recompile_storm      compile records (kind='compile',
                           telemetry.compile_obs): storm_compiles
                           RECOMPILES (n_compiles > 1 — first compiles
                           of distinct programs are legitimate) within
                           storm_window_steps steps
    - hbm_projection_drift a compile record whose measured
                           hbm.total_bytes drifts more than
                           hbm_drift_tol from its hbm_projected_bytes
                           (the sharding_lint SH206 static projection)
    - flops_drift          a compile record whose cost.flops drifts more
                           than flops_drift_tol from its analytic_flops
                           (the MFU peak-FLOPs accounting)
    - checkpoint_failed    a ckpt record (kind='ckpt', resilience
                           runtime) with event='failed' (retries
                           exhausted) or event='fallback' (a corrupt
                           checkpoint was skipped at restore)
    - checkpoint_stall     a ckpt commit whose save_ms exceeds
                           ckpt_stall_s — saves that slow eat the
                           preemption grace window
    - comm_bw_degraded     mesh-observatory records (kind='commbench',
                           telemetry/comm_obs via tools/commlab): a
                           measured collective more than (1+comm_bw_tol)x
                           SLOWER than its best-known DB latency db_ms.
                           One-sided + latched per op; records without
                           db_ms are exempt (no DB reference riding the
                           record — flag off or no row for the key)
    - straggler            per-rank step-boundary skew over step records
                           from >= 2 ranks: a rank whose step_ms exceeds
                           the step's fastest rank by straggler_rel AND
                           straggler_abs_ms — it is holding every
                           collective barrier open for the mesh. Latched
                           per rank; compile steps exempt (a recompiling
                           rank is legitimately slow); silent with one
                           rank reporting
    - tail_latency         request-trace records (kind='reqtrace',
                           telemetry.reqtrace): tail_cause_count
                           requests dominated (>= tail_cause_frac of
                           their end-to-end latency) by the same
                           PATHOLOGICAL cause — queue_wait, preemption,
                           restart, or cow_fork; decode/prefill
                           dominating is the work the user asked for.
                           Latched per cause so one pathology pages
                           once, not once per request
    - hbm_pressure         memory-observatory records (kind='memsnap',
                           telemetry/mem_obs via tools/memwatch): a
                           live ledger whose total_bytes exceeds
                           hbm_pressure_frac of the hbm_budget_bytes
                           riding ON the record. One-sided + latched
                           per engine/rank; records without a budget
                           are exempt (none declared, no jurisdiction)
    - kv_thrash            a memsnap record whose kv_eviction_rate
                           exceeds kv_thrash_ratio x its
                           kv_admission_rate AND kv_thrash_min_rate
                           blocks/step — the KV pool is evicting
                           faster than it admits (the cache is
                           cannibalizing itself to feed churn).
                           Latched per engine/rank; first snapshots
                           (no rate window yet) are exempt
    - mem_projection_drift a memsnap record whose live total_bytes
                           leaves the [1/(1+mem_reconcile_tol),
                           1+mem_reconcile_tol] band around the compile
                           observatory's static projected_bytes —
                           either side means the planning numbers no
                           longer describe the chip. Latched per
                           projection_family

    Clean values enter their windows AFTER judgment, so a spike does not
    vaccinate the window against itself; anomalous values are excluded
    from the windows entirely.
    """

    def __init__(self, config=None):
        self.config = config or HealthConfig()
        c = self.config
        self._loss = _Window(c.window)
        self._grad = _Window(c.window)
        self._step_t = _Window(c.window)
        self._recompiles = {}         # fn -> deque of (step, cause)
        self._storm_muzzle = {}       # fn -> muzzled-until step
        self._drift_latched = set()   # (kind, fn) already flagged
        self._tail_counts = {}        # cause -> dominated-request count
        self._tail_latched = set()    # causes already paged
        self._step_ranks = {}         # step -> {rank: step_ms} (skew)
        self.anomalies = []
        self._n = 0

    # -- helpers ------------------------------------------------------------
    def _z_rule(self, win, value, z_thresh, step, kind, label,
                rel_guard=None):
        if not _finite(value):
            return None
        fired = None
        if len(win) >= self.config.min_points:
            mean, std, med = win.stats()
            z = (value - mean) / std
            rel_ok = True if rel_guard is None else \
                value > rel_guard * max(med, 1e-9)
            if z > z_thresh and rel_ok:
                fired = Anomaly(
                    kind, step, value,
                    f"{label} {value:.6g} is {z:.1f} sigma above the "
                    f"rolling mean {mean:.6g} (window {len(win)})",
                    expected=mean, z=round(z, 2))
        if fired is None:
            win.add(value)
        return fired

    # -- the rule pass ------------------------------------------------------
    def observe(self, record):
        """Judge one record; returns [Anomaly, ...] ([] == healthy)."""
        self._n += 1
        rec = record or {}
        if rec.get("kind") == "phase":
            found = self._observe_phase(rec)
            self.anomalies.extend(found)
            return found
        if rec.get("kind") == "compile":
            found = self._observe_compile(rec)
            self.anomalies.extend(found)
            return found
        if rec.get("kind") == "ckpt":
            found = self._observe_ckpt(rec)
            self.anomalies.extend(found)
            return found
        if rec.get("kind") == "reqtrace":
            found = self._observe_reqtrace(rec)
            self.anomalies.extend(found)
            return found
        if rec.get("kind") == "kernelbench":
            found = self._observe_kernelbench(rec)
            self.anomalies.extend(found)
            return found
        if rec.get("kind") == "commbench":
            found = self._observe_commbench(rec)
            self.anomalies.extend(found)
            return found
        if rec.get("kind") == "memsnap":
            found = self._observe_memsnap(rec)
            self.anomalies.extend(found)
            return found
        step = rec.get("step", self._n - 1)
        found = []

        # straggler first: per-rank skew is judged on the raw step
        # boundary, independently of what the z-rules think of the
        # value; compile steps are exempt like step_time_regression
        # (a recompiling rank is legitimately slow)
        if _finite(rec.get("step_ms")) and rec.get("rank") is not None \
                and not rec.get("compile_ms"):
            found.extend(self._observe_straggler(
                step, int(rec["rank"]), float(rec["step_ms"])))

        # hard NaN/Inf first: a poisoned step must not feed the windows
        nan_n = rec.get("nan_count") or 0
        inf_n = rec.get("inf_count") or 0
        bad_vals = [k for k in ("loss", "grad_norm", "update_ratio")
                    if isinstance(rec.get(k), float)
                    and not math.isfinite(rec[k])]
        if nan_n or inf_n or bad_vals:
            parts = []
            if nan_n:
                parts.append(f"{int(nan_n)} NaN value(s)")
            if inf_n:
                parts.append(f"{int(inf_n)} Inf value(s)")
            if bad_vals:
                parts.append("non-finite " + "/".join(bad_vals))
            found.append(Anomaly(
                "nan", step, float(nan_n + inf_n) or float("nan"),
                f"step {step}: " + ", ".join(parts)
                + " in loss/grads — updates from this step are suspect"))
            self.anomalies.extend(found)
            return found   # no window feeding, no further rules

        a = self._z_rule(self._loss, rec.get("loss"),
                         self.config.z_loss, step, "loss_spike", "loss")
        if a:
            found.append(a)
        a = self._z_rule(self._grad, rec.get("grad_norm"),
                         self.config.z_grad, step, "grad_explosion",
                         "grad norm")
        if a:
            found.append(a)

        st = rec.get("step_time_ms")
        if st is None:
            st = rec.get("execute_ms")
        if st is None:
            st = rec.get("step_ms")
        if st is not None and not rec.get("compile_ms"):
            a = self._z_rule(self._step_t, st, self.config.z_step_time,
                             step, "step_time_regression", "step time (ms)",
                             rel_guard=self.config.rel_step_time)
            if a:
                found.append(a)
        self.anomalies.extend(found)
        return found

    def _observe_phase(self, rec):
        name = rec.get("phase", "?")
        found = []
        metrics = rec.get("metrics") or {}
        if "error" in metrics or "error" in rec:
            found.append(Anomaly(
                "phase_error", name, None,
                f"phase {name!r} recorded an error: "
                f"{metrics.get('error') or rec.get('error')}"))
        bad = [k for k, v in metrics.items()
               if isinstance(v, float) and not math.isfinite(v)]
        if bad:
            found.append(Anomaly(
                "phase_error", name, None,
                f"phase {name!r} carries non-finite metric(s): {bad}"))
        return found

    def _observe_compile(self, rec):
        """Rules over one compile-event record (telemetry.compile_obs):
        the storm window plus the two static-vs-compiled cross-checks.
        The record carries everything the rules need (measured AND
        projected/analytic values), so the same pass runs in-flight and
        in offline replays (tools/compile_report.py)."""
        c = self.config
        found = []
        step = rec.get("step", self._n - 1)
        fn = rec.get("fn", "?")

        # recompile storm: only RECOMPILES count — the first compile of
        # each distinct program (and records marked untracked, which
        # cannot tell first from Nth) is legitimate work, not thrash.
        # Windows and muzzles are PER FAMILY: a planned bump that
        # recompiles several distinct programs at once is not a storm,
        # and one family's storm must not silence another's.
        if not rec.get("untracked") and rec.get("n_compiles", 1) > 1:
            win = self._recompiles.get(fn)
            if win is None:
                win = self._recompiles[fn] = collections.deque(
                    maxlen=c.storm_compiles)
            win.append((step, rec.get("cause")))
            span = step - win[0][0]
            muzzled = step <= self._storm_muzzle.get(fn, -1)
            if (len(win) >= c.storm_compiles
                    and span <= c.storm_window_steps and not muzzled):
                causes = [cc for _, cause in win for cc in (cause or [])]
                hint = f"; last cause: {causes[-1]}" if causes else ""
                found.append(Anomaly(
                    "recompile_storm", step, float(len(win)),
                    f"{fn}: {len(win)} recompiles within "
                    f"{span} step(s) (threshold {c.storm_compiles} in "
                    f"{c.storm_window_steps}){hint}",
                    expected=c.storm_compiles))
                self._storm_muzzle[fn] = step + c.storm_window_steps

        # drift rules are LATCHED per family: a drifting program fires
        # once (it recompiles many times in a storm — one page, not N),
        # and re-arms only after a compile comes back inside tolerance
        hbm = rec.get("hbm") or {}
        actual = hbm.get("total_bytes")
        projected = rec.get("hbm_projected_bytes")
        if actual and projected:
            drift = (float(actual) - float(projected)) / float(projected)
            if abs(drift) <= c.hbm_drift_tol:
                self._drift_latched.discard(("hbm_projection_drift", fn))
            elif ("hbm_projection_drift", fn) not in self._drift_latched:
                self._drift_latched.add(("hbm_projection_drift", fn))
                found.append(Anomaly(
                    "hbm_projection_drift", step, float(actual),
                    f"{fn}: compiled HBM {actual / 1e6:.2f} MB is "
                    f"{drift * 100:+.0f}% off the static projection "
                    f"{projected / 1e6:.2f} MB (tolerance "
                    f"{c.hbm_drift_tol * 100:.0f}%) — the SH206 "
                    "pre-flight budget no longer describes this program",
                    expected=projected, z=round(drift, 3)))

        compiled_flops = (rec.get("cost") or {}).get("flops")
        analytic = rec.get("analytic_flops")
        from .mfu import flops_drift
        drift = flops_drift(compiled_flops, analytic)
        if drift is not None:
            if abs(drift) <= c.flops_drift_tol:
                self._drift_latched.discard(("flops_drift", fn))
            elif ("flops_drift", fn) not in self._drift_latched:
                self._drift_latched.add(("flops_drift", fn))
                found.append(Anomaly(
                    "flops_drift", step, float(compiled_flops),
                    f"{fn}: compiled FLOPs {float(compiled_flops):.3e} "
                    f"drift {drift * 100:+.0f}% from the analytic "
                    f"{float(analytic):.3e} the MFU accounting assumes "
                    f"(tolerance {c.flops_drift_tol * 100:.0f}%)",
                    expected=analytic, z=round(drift, 3)))
        return found

    def _observe_kernelbench(self, rec):
        """The kernel_time_drift rule over one kernel-observatory
        measurement record (telemetry/kernel_obs via tools/kernellab):
        measured kernel_ms vs the roofline-predicted predicted_ms,
        latched per kernel like the compile drift rules — a drifting
        kernel fires once (a sweep measures it at many shapes — one
        page, not N) and re-arms only after a measurement comes back
        inside tolerance. Records without predicted_ms (CPU backends,
        where the peak tables answer None) are exempt: no roofline, no
        drift to judge. Same records in flight and offline
        (tools/healthwatch.py, kernellab --selfcheck), so replays
        agree."""
        c = self.config
        found = []
        kernel = rec.get("kernel", "?")
        measured = rec.get("kernel_ms")
        predicted = rec.get("predicted_ms")
        if not isinstance(measured, (int, float)) or measured <= 0 \
                or not isinstance(predicted, (int, float)) \
                or predicted <= 0:
            return found
        # Multiplicative band: relative drift is bounded below by -1,
        # so a subtractive |drift| > tol test with tol >= 1 could NEVER
        # fire in the too-fast direction. The ratio test is symmetric
        # in log space and both sides stay reachable at any tolerance.
        ratio = float(measured) / float(predicted)
        band = 1.0 + c.kernel_drift_tol
        if 1.0 / band <= ratio <= band:
            self._drift_latched.discard(("kernel_time_drift", kernel))
        elif ("kernel_time_drift", kernel) not in self._drift_latched:
            self._drift_latched.add(("kernel_time_drift", kernel))
            if ratio > band:
                side = (f"{ratio:.1f}x slower than")
            else:
                side = (f"{1.0 / ratio:.1f}x faster than")
            found.append(Anomaly(
                "kernel_time_drift", rec.get("step", self._n - 1),
                float(measured),
                f"{kernel}: measured {float(measured):.3f} ms is "
                f"{side} the roofline-predicted "
                f"{float(predicted):.3f} ms (band {1.0 / band:.2f}x"
                f"–{band:.2f}x) — the KN503 counts or the peak tables "
                "no longer describe this kernel",
                expected=predicted, z=round(ratio, 3)))
        return found

    def _observe_commbench(self, rec):
        """The comm_bw_degraded rule over one mesh-observatory
        measurement record (telemetry/comm_obs via tools/commlab):
        measured time_ms vs the best-known DB latency db_ms riding ON
        the record — the same reference in flight and in offline replay
        (tools/healthwatch.py, commlab --selfcheck), so they agree.
        ONE-SIDED: only slower-than-(1+comm_bw_tol)x-the-DB fires;
        faster is good news the next --update-db rolls into the DB.
        Latched per op (a sweep measures one op at many payloads — one
        page, not N) and re-armed by an in-band measurement. Records
        without db_ms (PADDLE_TPU_COMM_DB off, or no row for this key)
        are exempt: no reference, no jurisdiction."""
        c = self.config
        found = []
        op = rec.get("op", "?")
        measured = rec.get("time_ms")
        reference = rec.get("db_ms")
        if not isinstance(measured, (int, float)) or measured <= 0 \
                or not isinstance(reference, (int, float)) \
                or reference <= 0:
            return found
        ratio = float(measured) / float(reference)
        band = 1.0 + c.comm_bw_tol
        if ratio <= band:
            self._drift_latched.discard(("comm_bw_degraded", op))
        elif ("comm_bw_degraded", op) not in self._drift_latched:
            self._drift_latched.add(("comm_bw_degraded", op))
            found.append(Anomaly(
                "comm_bw_degraded", rec.get("step", self._n - 1),
                float(measured),
                f"{op} over axis {rec.get('axis', '?')!r} "
                f"(n={rec.get('axis_size', '?')}, "
                f"{rec.get('payload_bytes', '?')} B): measured "
                f"{float(measured):.3f} ms is {ratio:.1f}x slower than "
                f"the best-known {float(reference):.3f} ms "
                f"(band {band:.2f}x) — an ICI link or a peer is "
                "degraded, or the DB row no longer describes this mesh",
                expected=reference, z=round(ratio, 3)))
        return found

    def _observe_memsnap(self, rec):
        """The hbm_pressure / kv_thrash / mem_projection_drift rules
        over one memory-observatory ledger record (kind='memsnap',
        telemetry/mem_obs via tools/memwatch): every reference judged
        against — the declared budget, the eviction/admission rates,
        the static projection — rides ON the record, so the in-flight
        detector and offline replay (tools/healthwatch.py, memwatch
        --selfcheck) see identical numbers. Records without a
        reference are exempt per rule: no budget -> no pressure
        jurisdiction, no rate window yet -> no thrash jurisdiction, no
        projection -> no drift jurisdiction (the commbench stance).
        All three latch: pressure/thrash per engine (falling back to
        rank), drift per projection_family."""
        c = self.config
        found = []
        step = rec.get("step", self._n - 1)
        engine = rec.get("engine")
        fam = f"engine{engine}" if engine is not None \
            else f"rank{rec.get('rank', 0)}"
        total = rec.get("total_bytes")
        budget = rec.get("hbm_budget_bytes")
        if isinstance(total, (int, float)) and total >= 0 \
                and isinstance(budget, (int, float)) and budget > 0:
            frac = float(total) / float(budget)
            key = ("hbm_pressure", fam)
            if frac <= c.hbm_pressure_frac:
                self._drift_latched.discard(key)
            elif key not in self._drift_latched:
                self._drift_latched.add(key)
                found.append(Anomaly(
                    "hbm_pressure", step, float(total),
                    f"{fam}: live HBM ledger holds "
                    f"{float(total) / 2**20:.1f} MiB — "
                    f"{frac * 100:.0f}% of the declared "
                    f"{float(budget) / 2**20:.1f} MiB budget (band "
                    f"{c.hbm_pressure_frac * 100:.0f}%) — the next "
                    "allocation spike is an OOM, shed load or raise "
                    "the budget",
                    expected=budget, z=round(frac, 3)))
        ev = rec.get("kv_eviction_rate")
        adm = rec.get("kv_admission_rate")
        if isinstance(ev, (int, float)) and ev >= 0 \
                and isinstance(adm, (int, float)) and adm >= 0:
            key = ("kv_thrash", fam)
            thrash = ev >= c.kv_thrash_min_rate \
                and ev > c.kv_thrash_ratio * adm
            if not thrash:
                self._drift_latched.discard(key)
            elif key not in self._drift_latched:
                self._drift_latched.add(key)
                found.append(Anomaly(
                    "kv_thrash", step, float(ev),
                    f"{fam}: KV pool evicting {float(ev):.2f} "
                    f"blocks/step against {float(adm):.2f} "
                    f"admitted/step (ratio threshold "
                    f"{c.kv_thrash_ratio:.1f}x, floor "
                    f"{c.kv_thrash_min_rate:.1f}/step) — the cache is "
                    "cannibalizing itself to feed churn; admission is "
                    "outrunning the block budget",
                    expected=adm, z=round(ev / max(adm, 1e-9), 3)))
        proj = rec.get("projected_bytes")
        pfam = rec.get("projection_family", "default")
        if isinstance(total, (int, float)) and total > 0 \
                and isinstance(proj, (int, float)) and proj > 0:
            ratio = float(total) / float(proj)
            band = 1.0 + c.mem_reconcile_tol
            key = ("mem_projection_drift", pfam)
            if 1.0 / band <= ratio <= band:
                self._drift_latched.discard(key)
            elif key not in self._drift_latched:
                self._drift_latched.add(key)
                side = f"{ratio:.2f}x above" if ratio > band \
                    else f"{1.0 / ratio:.2f}x below"
                found.append(Anomaly(
                    "mem_projection_drift", step, float(total),
                    f"{pfam}: live ledger total "
                    f"{float(total) / 2**20:.1f} MiB is {side} the "
                    f"static projection "
                    f"{float(proj) / 2**20:.1f} MiB (band "
                    f"{1.0 / band:.2f}x–{band:.2f}x) — the compile "
                    "observatory's planning numbers no longer "
                    "describe what the chip holds",
                    expected=proj, z=round(ratio, 3)))
        return found

    def _observe_straggler(self, step, rank, step_ms):
        """Per-rank step-boundary skew: collect step_ms by rank per
        step, judge every rank of the step against its fastest — a rank
        persistently past BOTH the relative and absolute bands is
        holding every collective barrier open for the whole mesh.
        Latched per rank (one page per straggling host, not one per
        step) and re-armed when the rank comes back in band. With one
        rank reporting there is no skew to judge — silent."""
        c = self.config
        ranks = self._step_ranks.setdefault(step, {})
        ranks[rank] = step_ms
        # settle old steps: ranks report a step at most a few steps
        # apart (the skew being measured IS that gap), so anything 8+
        # steps behind the newest is closed bookkeeping
        if len(self._step_ranks) > 8:
            for s in [s for s in self._step_ranks if s < step - 8]:
                del self._step_ranks[s]
        found = []
        if len(ranks) < 2:
            return found
        fastest = min(ranks.values())
        for r, ms in sorted(ranks.items()):
            slow = ms > fastest * (1.0 + c.straggler_rel) \
                and (ms - fastest) >= c.straggler_abs_ms
            if not slow:
                self._drift_latched.discard(("straggler", r))
            elif ("straggler", r) not in self._drift_latched:
                self._drift_latched.add(("straggler", r))
                found.append(Anomaly(
                    "straggler", step, float(ms),
                    f"rank {r}: step {step} took {ms:.1f} ms vs the "
                    f"fastest rank's {fastest:.1f} ms "
                    f"(+{ms - fastest:.1f} ms; threshold "
                    f"+{c.straggler_rel * 100:.0f}% and >= "
                    f"{c.straggler_abs_ms:.0f} ms) — every collective "
                    "barrier waits for this rank",
                    expected=fastest,
                    z=round(ms / max(fastest, 1e-9), 3)))
        return found

    def _observe_ckpt(self, rec):
        """Rules over one checkpoint-event record (kind='ckpt',
        paddle_tpu.resilience): failed saves/restores and corrupt-
        checkpoint fallbacks page as `checkpoint_failed`; a commit
        slower than ckpt_stall_s pages as `checkpoint_stall` (the
        preemption grace window is the budget a save must fit). Same
        records in flight (CheckpointManager health=) and offline
        (tools/healthwatch.py), so replays agree."""
        found = []
        step = rec.get("step", self._n - 1)
        event = rec.get("event")
        if event == "failed":
            found.append(Anomaly(
                "checkpoint_failed", step, None,
                f"step {step}: checkpoint {rec.get('op', 'operation')} "
                f"failed permanently: {rec.get('error', 'unknown error')}"))
        elif event == "fallback":
            probs = rec.get("problems") or []
            hint = f" ({probs[0]})" if probs else ""
            found.append(Anomaly(
                "checkpoint_failed", step, None,
                f"checkpoint at step {step} failed integrity "
                f"verification{hint}; restore fell back to an older one"))
        elif event == "commit":
            save_ms = rec.get("save_ms")
            limit_ms = self.config.ckpt_stall_s * 1000.0
            if _finite(save_ms) and save_ms > limit_ms:
                found.append(Anomaly(
                    "checkpoint_stall", step, float(save_ms),
                    f"step {step}: checkpoint save took "
                    f"{save_ms / 1000.0:.1f}s (budget "
                    f"{self.config.ckpt_stall_s:.0f}s) — a preemption "
                    "during a save this slow loses the step",
                    expected=limit_ms))
        return found

    def _observe_reqtrace(self, rec):
        """The tail-latency rule over one request-trace record
        (kind='reqtrace', telemetry.reqtrace): requests whose latency
        is DOMINATED by a serving mechanism (queue wait, preemption,
        warm restart, CoW forking) rather than by the prefill/decode
        work they asked for are counted per cause; past
        tail_cause_count the cause pages once (latched). Same records
        in flight (the engine's sink) and offline (tools/healthwatch.py
        + tools/tail_report.py), so replays agree with production."""
        from .reqtrace import PATHOLOGICAL_CAUSES, dominant_cause

        c = self.config
        cause, ms, frac = dominant_cause(rec)
        if cause not in PATHOLOGICAL_CAUSES or frac < c.tail_cause_frac:
            return []
        n = self._tail_counts.get(cause, 0) + 1
        self._tail_counts[cause] = n
        if n < c.tail_cause_count or cause in self._tail_latched:
            return []
        self._tail_latched.add(cause)
        return [Anomaly(
            "tail_latency", rec.get("rid", self._n - 1), float(ms),
            f"{n} request(s) dominated by {cause} (latest: request "
            f"{rec.get('rid')} spent {ms:.1f}ms / {frac * 100:.0f}% of "
            f"its {rec.get('e2e_ms')}ms end-to-end in {cause}; "
            f"threshold {c.tail_cause_count} requests at "
            f">={c.tail_cause_frac * 100:.0f}%)",
            expected=c.tail_cause_frac, z=round(frac, 3))]

    def kinds(self):
        """Distinct anomaly kinds seen so far (healthwatch --expect)."""
        return sorted({a.kind for a in self.anomalies})


class HealthMonitor:
    """In-flight glue: taps -> detector -> action, plus the watchdog.

    A train step with `health=` brackets its body with `guard()`:

        with mon.guard(window) as g:     # arms the hang watchdog
            out = dispatch(...)          # raise -> black-box dump
            g.stage(stats_dev)           # device stats, still lazy
        # on success guard ran step_close: disarm + fetch every k +
        # note the fetched fields into the telemetry step window

    `stats_dev` is the device-side (5,) array from
    `device_health_stats` (or None on a step that built no taps, or for
    record-only integrations, which pass host values via `loss=`).
    `step_close` returns None on non-fetch steps, else the dict of
    health fields merged into the step's JSONL record; the watchdog is
    disarmed even when action='raise' turns an anomaly into a
    HealthError mid-close.
    """

    def __init__(self, config=None):
        if isinstance(config, dict):
            config = HealthConfig(**config)
        self.config = config or HealthConfig()
        self.detector = AnomalyDetector(self.config)
        self.ring = collections.deque(maxlen=self.config.ring_size)
        self.watchdog = None
        self._wd_started = False
        self._mu = threading.Lock()
        self._step = 0
        self._pending = None          # latest un-fetched device stats
        self._staged = None           # stats handed over via guard/stage
        self._t_last_fetch = None
        self._steps_since_fetch = 0
        if self.config.hang_deadline_s:
            from .watchdog import HangWatchdog
            self.watchdog = HangWatchdog(
                deadline_s=self.config.hang_deadline_s,
                dump_dir=self.config.dump_dir, ring=self.ring)

    # -- step lifecycle -----------------------------------------------------
    @contextlib.contextmanager
    def guard(self, window=None):
        """Bracket one train step. Arms the watchdog; an escaping
        exception triggers the black-box dump (then re-raises); on
        success runs step_close with whatever the body `stage()`d and
        notes the fetched fields into `window` (a telemetry step
        window with .note, e.g. from auto_step). A HealthError out of
        the close dumps too (see the module docstring)."""
        self.step_open()
        try:
            yield self
        except Exception as e:
            self.on_exception(e)
            raise
        else:
            stats, self._staged = self._staged, None
            try:
                fields = self.step_close(stats)
            except HealthError as e:
                # the anomaly escapes the step: the same dump as any
                # other escaping exception (step_close disarmed already)
                self.on_exception(e)
                raise
            if fields and window is not None:
                window.note(**fields)

    def stage(self, stats_dev):
        """Hand the step's device-side stats array to the enclosing
        guard() (kept lazy; fetched on the every_k cadence)."""
        self._staged = stats_dev

    def will_fetch(self):
        """True when the NEXT step_close will fetch+judge — lets eager
        (non-jit) integrations skip building tap values that would
        only be discarded on non-fetch steps."""
        return self._steps_since_fetch + 1 >= self.config.every_k

    def step_open(self):
        if self.watchdog is not None:
            if not self._wd_started:
                self.watchdog.start()
                self._wd_started = True
            self.watchdog.step_opened()

    def step_close(self, stats_dev=None, loss=None, step_ms=None):
        """Close one step. Fetches + judges every `every_k`-th call;
        otherwise just rotates the pending device handle (no sync).
        The watchdog is disarmed even when action='raise' escalates an
        anomaly to HealthError out of the judge."""
        self._step += 1
        self._steps_since_fetch += 1
        fields = None
        if stats_dev is not None:
            self._pending = stats_dev
        if self._pending is not None:
            # device stats pending: honor the every_k fetch cadence (the
            # fetch is the only host transfer the taps ever make)
            fetch = self._steps_since_fetch >= self.config.every_k
        else:
            # record-level integration (host values only): judging is
            # free, so every step goes through the rules
            fetch = loss is not None or step_ms is not None
        try:
            if fetch:
                fields = self._fetch_and_judge(loss=loss, step_ms=step_ms)
        finally:
            if self.watchdog is not None:
                # ring is shared with the watchdog, so no record= here —
                # _fetch_and_judge already appended the full record
                self.watchdog.step_closed()
        return fields

    def observe_record(self, record):
        """Record-level entry (an offline replay through a live
        monitor): judge a full step-record dict immediately."""
        self.ring.append(record)
        found = self.detector.observe(record)
        if found:
            self._act(found)
        return found

    def on_exception(self, exc):
        """An exception escaped the train step: count it, dump the
        black box (same dump the hang watchdog writes), disarm."""
        monitor.incr("health.step_exceptions")
        path = None
        if self.config.dump_on_exception:
            from . import watchdog as _wd
            path = _wd.dump_black_box(
                reason=f"exception escaped train step: "
                       f"{type(exc).__name__}: {exc}",
                dump_dir=self.config.dump_dir, ring=list(self.ring))
        if self.watchdog is not None:
            self.watchdog.step_closed()
        return path

    def close(self):
        if self.watchdog is not None and self._wd_started:
            self.watchdog.stop()
            self._wd_started = False

    # -- internals ----------------------------------------------------------
    def _fetch_and_judge(self, loss=None, step_ms=None):
        import numpy as np
        now = time.perf_counter()
        fields = {}
        if self._pending is not None:
            vals = self._pending
            if hasattr(vals, "detach"):
                vals = vals.detach().cpu()     # the every-k sync
            vals = np.asarray(vals, dtype=np.float64)
            self._pending = None
            monitor.incr("health.fetches")
            fields = {
                "grad_norm": float(vals[0]),
                "update_ratio": float(vals[1]),
                "nan_count": int(vals[2]) if math.isfinite(
                    float(vals[2])) else 1,
                "inf_count": int(vals[3]) if math.isfinite(
                    float(vals[3])) else 1,
            }
            if loss is None:
                loss = float(vals[4])
        rec = dict(fields)
        rec["step"] = self._step - 1
        if loss is not None:
            rec["loss"] = float(loss)
            fields["loss"] = float(loss)
        if step_ms is not None:
            rec["step_time_ms"] = float(step_ms)
        elif self._t_last_fetch is not None:
            # the fetch synced the device, so wall time since the LAST
            # fetch covers every step in the window; the average is an
            # honest per-step time with zero extra syncs. The first
            # window is skipped (it pays compile).
            rec["step_time_ms"] = ((now - self._t_last_fetch) * 1000.0
                                   / max(1, self._steps_since_fetch))
        self._t_last_fetch = now
        self._steps_since_fetch = 0

        for k, v in fields.items():
            if isinstance(v, (int, float)) and math.isfinite(float(v)):
                monitor.set_gauge(f"health.{k}", float(v))
        self.ring.append(rec)
        found = self.detector.observe(rec)
        if found:
            self._act(found)
        # loss rode along only for the detector; the recorder already
        # owns the loss field of the JSONL record
        fields.pop("loss", None)
        return fields or None

    def _act(self, anomalies):
        monitor.incr("health.anomalies", len(anomalies))
        nan_hits = [a for a in anomalies if a.kind == "nan"]
        if nan_hits:
            monitor.incr("health.nan_steps", len(nan_hits))
        if self.config.action == "record":
            return
        if self.config.action == "warn":
            for a in anomalies:
                warnings.warn(f"[health] {a.message}", RuntimeWarning,
                              stacklevel=3)
            return
        raise HealthError(anomalies)

    @property
    def anomalies(self):
        return self.detector.anomalies


def as_monitor(health):
    """Normalize the `health=` argument of TrainStep: None/False ->
    None, True -> default HealthMonitor,
    dict/HealthConfig -> wrapped, HealthMonitor -> itself (shared across
    steps so the windows/watchdog are one per job)."""
    if health is None or health is False:
        return None
    if isinstance(health, HealthMonitor):
        return health
    if health is True:
        return HealthMonitor()
    if isinstance(health, (dict, HealthConfig)):
        return HealthMonitor(health)
    raise TypeError(
        f"health= expects True/dict/HealthConfig/HealthMonitor, "
        f"got {type(health).__name__}")


# ---------------------------------------------------------------------------
# device-side taps (torch, no host sync)
# ---------------------------------------------------------------------------

def update_ratio(new_vals, param_vals):
    """||new - old|| / max(||old||, 1e-12) over every parameter, in f32,
    as a 0-dim tensor on the parameters' device (no sync)."""
    n = len(param_vals)
    return _ratio(health_rows(n, range(n), new_vals=new_vals,
                              param_vals=param_vals).sum(dim=0))


def device_health_stats(loss_val, grads, new_vals, param_vals):
    """The (5,) f32 health stats tensor of one step, on the loss's
    device: [global grad-norm, update/param norm ratio, NaN count, Inf
    count, loss]. `grads` are the raw grads (before any clip),
    `param_vals` the parameter values before the update and `new_vals`
    after it (either None/empty: a ratio of 0, as in the JAX taps).
    Device ops only — no `.item()`, no transfer — so nothing waits for
    the card until the monitor fetches the tensor. Norms and counts
    accumulate in f32, as the JAX taps do. `sharded_health_stats` of
    the whole parameters' rows, with nothing to sum over."""
    n = len(grads or param_vals or ())
    rows = health_rows(n, range(n), grads=grads or None)
    if new_vals and param_vals:
        rows = rows + health_rows(n, range(n), new_vals=new_vals,
                                  param_vals=param_vals).to(rows.device)
    return sharded_health_stats(loss_val, rows, lambda r: r)


def health_rows(n_params, index, grads=None, new_vals=None,
                param_vals=None):
    """[n_params, 5] f32 per-parameter partial sums of this rank's
    pieces, for `sharded_health_stats`: piece i belongs to parameter
    `index[i]`; columns 0-2 are the f32 sum of squares, NaN count and
    Inf count of `grads` (the raw grads, before any clip), columns 3-4
    the f32 sums of squares of new - old and of old (`new_vals` after
    the update, `param_vals` before it). Columns not given stay 0, so
    two calls' rows add. Device ops only."""
    import torch

    f32 = torch.float32
    pieces = grads if grads is not None else param_vals
    dev = pieces[0].device if pieces else torch.device("cpu")
    rows = torch.zeros((n_params, 5), dtype=f32, device=dev)
    if not pieces:
        return rows
    idx = torch.tensor(list(index), device=dev)
    if grads is not None:
        vals = torch.stack([torch.stack([
            torch.sum(torch.square(g.to(f32))), torch.isnan(g).sum().to(f32),
            torch.isinf(g).sum().to(f32)]) for g in grads])
        rows[:, :3].index_add_(0, idx, vals)
    if new_vals is not None and param_vals is not None:
        vals = torch.stack([torch.stack([
            torch.sum(torch.square(n.to(f32) - o.to(f32))),
            torch.sum(torch.square(o.to(f32)))])
            for n, o in zip(new_vals, param_vals)])
        rows[:, 3:].index_add_(0, idx, vals)
    return rows


def sharded_health_stats(loss_val, rows, sum_cuts):
    """`device_health_stats` of a model whose parameters lie in pieces
    over ranks: `rows` the `health_rows` of this rank's pieces,
    `sum_cuts` the caller's collective that sums them over the ranks
    holding each parameter's other pieces, a tied weight once (the
    sharded clip's rule, `distributed.sharded_train.sum_over_cuts`),
    `loss_val` the global loss. -> the same (5,) f32 stats on every
    rank: [global grad-norm, update/param norm ratio (0 when no update
    columns were given), NaN count, Inf count, loss]. No host sync."""
    import torch

    f32 = torch.float32
    tot = sum_cuts(rows.to(loss_val.device)).sum(dim=0)
    return torch.stack([
        torch.sqrt(tot[0]), _ratio(tot),
        tot[1] + torch.isnan(loss_val).sum().to(f32),
        tot[2] + torch.isinf(loss_val).sum().to(f32),
        loss_val.detach().to(f32).reshape(())])


def _ratio(tot):
    """The update/param norm ratio of `health_rows` column totals."""
    import torch
    return torch.sqrt(tot[3]) / torch.clamp(torch.sqrt(tot[4]), min=1e-12)
