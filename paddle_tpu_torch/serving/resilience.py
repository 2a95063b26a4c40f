"""Serving policy: deadlines, priorities, admission control, typed failures.

The part of paddle_tpu/serving/resilience.py the scheduler and engine of
this port need, copied unchanged: per-request server-side deadlines
reaped at step boundaries (`expired_reason`), per-class priorities over
the waiting queue, SLO-aware load shedding at submit time
(`AdmissionController`), the typed errors a stream can end with or
`submit` can raise (draining, stopped, dead), and `restart_backoff`,
the warm-restart schedule of the background serve loop, and
`MemoryPressureError`, the memory observatory's shed.
"""

__all__ = [
    "PRIORITIES", "Deadlines", "AdmissionController", "ServingError",
    "ShedError", "QueueFullError", "MemoryPressureError",
    "EngineDrainingError",
    "EngineStoppedError", "EngineDeadError", "RequestCancelledError",
    "DeadlineExceededError", "expired_reason", "restart_backoff",
]

# lower value = served first; the waiting queue is FIFO within a class
PRIORITIES = {"interactive": 0, "normal": 1, "batch": 2}


class Deadlines:
    """Server-side time budgets for one request, all in seconds from
    submit time. Any subset may be set:

    queue_wait_s  max time in the waiting queue before admission;
    ttft_s        max time to the FIRST streamed token;
    total_s       max wall time for the whole request.
    """

    def __init__(self, queue_wait_s=None, ttft_s=None, total_s=None):
        for name, v in (("queue_wait_s", queue_wait_s),
                        ("ttft_s", ttft_s), ("total_s", total_s)):
            if v is not None and (not isinstance(v, (int, float))
                                  or v <= 0):
                raise ValueError(f"{name} must be a positive number, "
                                 f"got {v!r}")
        self.queue_wait_s = queue_wait_s
        self.ttft_s = ttft_s
        self.total_s = total_s

    def admission_budget_s(self):
        """The tightest bound on how long this request can afford to
        wait in the queue (what shed prediction compares against)."""
        vals = [v for v in (self.queue_wait_s, self.total_s)
                if v is not None]
        return min(vals) if vals else None

    def __repr__(self):
        return (f"Deadlines(queue_wait_s={self.queue_wait_s}, "
                f"ttft_s={self.ttft_s}, total_s={self.total_s})")


def expired_reason(req, now):
    """Which deadline `req` has blown at time `now` (monotonic seconds),
    or None. Queue-wait binds only while the request has NEVER been
    admitted (a preempted request already met its queue budget — its
    first `admit_time` is kept precisely so this cannot re-arm), TTFT
    only until the first token streamed, total always."""
    d = getattr(req, "deadlines", None)
    if d is None:
        return None
    waited = now - req.submit_time
    if req.state == "waiting" and req.admit_time is None \
            and d.queue_wait_s is not None and waited > d.queue_wait_s:
        return "queue_wait"
    if d.ttft_s is not None and req.first_token_time is None \
            and waited > d.ttft_s:
        return "ttft"
    if d.total_s is not None and waited > d.total_s:
        return "total"
    return None


class ServingError(RuntimeError):
    """Base of every typed serving failure (a RuntimeError so
    `except RuntimeError` stream consumers keep working)."""


class ShedError(ServingError):
    """Admission rejected the request up front: it was predicted to blow
    its deadline before starting, or the bounded queue is full.
    `retry_after_s` is the server's estimate of when the queue will have
    drained enough to try again."""

    reason = "predicted_deadline"

    def __init__(self, message, retry_after_s=1.0, queue_depth=0,
                 predicted_wait_ms=None):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)
        self.queue_depth = int(queue_depth)
        self.predicted_wait_ms = predicted_wait_ms


class QueueFullError(ShedError):
    """The bounded waiting queue is at capacity."""

    reason = "queue_full"


class MemoryPressureError(ShedError):
    """The memory observatory's ledger shows the declared HBM budget
    fully consumed: admitting more work would walk the engine into an
    allocation failure mid-decode, so the request bounces at the door
    instead (HTTP 429 + Retry-After, like every other shed)."""

    reason = "mem_pressure"


class EngineDrainingError(ServingError):
    """Admission is stopped for a graceful drain (HTTP 503 +
    Retry-After): running requests finish, new ones go elsewhere."""

    def __init__(self, message, retry_after_s=5.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class EngineStoppedError(ServingError):
    """The engine was stopped; queued submitters fail with this instead
    of blocking on their handles forever."""


class EngineDeadError(ServingError):
    """Warm-restart attempts exhausted: the engine declared itself dead
    and failed all outstanding work."""


class RequestCancelledError(ServingError):
    """The request was cancelled (`RequestHandle.cancel`); its slot and
    KV blocks were released at once."""


class DeadlineExceededError(ServingError):
    """A server-side deadline expired; `which` names the blown budget
    ('queue_wait' | 'ttft' | 'total')."""

    def __init__(self, message, which="total"):
        super().__init__(message)
        self.which = which


class AdmissionController:
    """Bounded queue + SLO shed prediction for `ServingEngine.submit`.

    The predictor is deliberately crude — queue depth x measured TPOT
    (EMA over finished requests), scaled by the mean generation length
    of the queue over the slot count — because it only has to be right
    about ORDER OF MAGNITUDE. Until the first request finishes there is
    no TPOT measurement and prediction abstains (the queue bound still
    holds).
    """

    def __init__(self, max_queue, max_slots, tpot_alpha=0.2):
        self.max_queue = None if max_queue is None else int(max_queue)
        self.max_slots = max(1, int(max_slots))
        self.tpot_alpha = float(tpot_alpha)
        self.tpot_ema_ms = None

    def note_tpot_ms(self, tpot_ms):
        if tpot_ms is None or tpot_ms < 0:
            return
        if self.tpot_ema_ms is None:
            self.tpot_ema_ms = float(tpot_ms)
        else:
            a = self.tpot_alpha
            self.tpot_ema_ms = (1 - a) * self.tpot_ema_ms + a * tpot_ms

    def predicted_queue_wait_ms(self, waiting):
        """Estimated wait for a request joining the back of `waiting`
        now; None when no TPOT has been measured yet."""
        if self.tpot_ema_ms is None:
            return None
        if not waiting:
            return 0.0
        mean_toks = sum(r.params.max_new_tokens for r in waiting) \
            / len(waiting)
        return len(waiting) * mean_toks * self.tpot_ema_ms \
            / self.max_slots

    def admit_or_raise(self, req, waiting):
        """Raise `QueueFullError`/`ShedError` when `req` must be shed;
        return the predicted queue wait (ms or None) when admitted. The
        deadline prediction counts only the requests that would sit
        AHEAD of `req` in the class-ordered queue."""
        depth = len(waiting)
        predicted = self.predicted_queue_wait_ms(waiting)
        if self.max_queue is not None and depth >= self.max_queue:
            retry = 1.0 if predicted is None else max(0.1,
                                                      predicted / 1000.0)
            raise QueueFullError(
                f"waiting queue full ({depth} >= max_queue "
                f"{self.max_queue})", retry_after_s=retry,
                queue_depth=depth, predicted_wait_ms=predicted)
        d = getattr(req, "deadlines", None)
        budget_s = d.admission_budget_s() if d is not None else None
        if budget_s is None:
            return predicted
        ahead = [r for r in waiting
                 if getattr(r, "priority", 1) <= req.priority]
        predicted_ahead = self.predicted_queue_wait_ms(ahead)
        if predicted_ahead is not None and \
                predicted_ahead > budget_s * 1000.0:
            raise ShedError(
                f"predicted queue wait {predicted_ahead:.0f}ms "
                f"({len(ahead)} request(s) ahead of priority "
                f"{req.priority_class!r}) exceeds the request's "
                f"{budget_s * 1000.0:.0f}ms budget (measured TPOT "
                f"{self.tpot_ema_ms:.2f}ms)",
                retry_after_s=max(0.1, predicted_ahead / 1000.0),
                queue_depth=depth, predicted_wait_ms=predicted_ahead)
        return predicted


def restart_backoff(attempt, base_s, cap_s=30.0):
    """Warm-restart backoff before retry #`attempt` (1-based): bounded
    doubling, deterministic (the engine's restart cap bounds total
    attempts, so jitter buys nothing here and determinism keeps a drill
    reproducible)."""
    return min(float(cap_s), float(base_s) * (2.0 ** (max(1, attempt)
                                                      - 1)))
