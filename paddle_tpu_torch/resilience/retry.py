"""Transient-vs-permanent failure classification and the retry
combinator.

The port's copy of paddle_tpu/resilience/retry.py, unchanged: the
classifier (`is_transient`, `classify_failure`, `classify_http_status`,
`tag_transient`, `retry_after_hint`, `HTTPStatusError` and their type
tables) and the combinator (`RetryError`, `RetryBudget`, `RetryPolicy`,
`with_retry`, `retrying`): exponential backoff with full jitter (delay
~ U[0, min(cap, base * mult^n)]) from a seeded `random.Random`,
deadlines over the whole loop, budgets shared across calls, permanent
errors raised at once, a Retry-After hint as the backoff's floor, and
an injectable clock and sleep. The checkpoint manager runs every I/O
operation through `with_retry` (resilience/ckpt.py). The fleet router
speaks the HTTP half: an `HTTPReplica` raises `HTTPStatusError` for a
non-2xx reply, and `classify_failure` reads its status (429/503/504
transient, other 4xx permanent, 5xx infra). The serving engine's
background loop rides `classify_failure` after a failed step: a
'permanent' failure (a programming error: ValueError, TypeError, ...)
fails the in-flight requests, anything else warm-restarts. Under this
taxonomy `torch.OutOfMemoryError` and a kernel wrapper's CUDA launch
error, both `RuntimeError`s, are 'infra': a warm restart.
"""
import errno
import functools
import random
import threading
import time

__all__ = ["RetryPolicy", "RetryBudget", "RetryError", "with_retry",
           "retrying", "is_transient", "classify_failure", "tag_transient",
           "classify_http_status", "retry_after_hint", "HTTPStatusError",
           "TRANSIENT_HTTP_STATUSES"]

# errno values worth retrying: transient kernel/FS/network conditions.
# Deliberately NOT here: ENOSPC/EDQUOT (disk full stays full), EACCES/
# EPERM (permissions don't heal), ENOENT (missing stays missing).
_TRANSIENT_ERRNOS = frozenset({
    errno.EIO, errno.EAGAIN, errno.EBUSY, errno.EINTR, errno.ETIMEDOUT,
    errno.ECONNRESET, errno.ECONNREFUSED, errno.ECONNABORTED,
    errno.ENETUNREACH, errno.ENETRESET, errno.EHOSTUNREACH,
    errno.ESTALE,           # NFS handle went stale — a remount heals it
})

_PERMANENT_TYPES = (FileNotFoundError, PermissionError, IsADirectoryError,
                    NotADirectoryError, ValueError, TypeError, KeyError)

# programming errors: bugs in OUR code, not weather — restarting replays
# the same traceback
_PROGRAMMING_TYPES = (ValueError, TypeError, KeyError, IndexError,
                      AttributeError, AssertionError, NameError,
                      NotImplementedError, ZeroDivisionError,
                      RecursionError, UnboundLocalError)

# HTTP statuses worth retrying — the serving tier's own refusal
# vocabulary (serving/http.py): 429 is an admission shed and 503 a
# drain, both of which ship a Retry-After; 504 is a server-side
# deadline. Every other 4xx is the request's own fault.
TRANSIENT_HTTP_STATUSES = frozenset({429, 503, 504})


def classify_http_status(status):
    """Three-way taxonomy for an HTTP status from a serving replica:
    429/503/504 'transient', other 4xx 'permanent', anything else
    'infra'."""
    status = int(status)
    if status in TRANSIENT_HTTP_STATUSES:
        return "transient"
    if 400 <= status < 500:
        return "permanent"
    return "infra"


def retry_after_hint(exc):
    """The server's Retry-After hint carried on `exc` (seconds, float),
    or None."""
    hint = getattr(exc, "retry_after_s", None)
    if hint is None:
        return None
    try:
        hint = float(hint)
    except (TypeError, ValueError):
        return None
    return hint if hint >= 0 else None


class HTTPStatusError(RuntimeError):
    """A non-2xx reply from a serving replica, classified by status.
    `http_status` drives `classify_failure`; `retry_after_s` carries the
    reply's Retry-After header when it had one."""

    def __init__(self, message, http_status, retry_after_s=None):
        super().__init__(message)
        self.http_status = int(http_status)
        self.retry_after_s = None if retry_after_s is None \
            else float(retry_after_s)


class RetryError(Exception):
    """All attempts exhausted (or deadline/budget hit). `last` carries
    the final underlying exception; `attempts` how many were made."""

    def __init__(self, message, last=None, attempts=0):
        super().__init__(message)
        self.last = last
        self.attempts = attempts


def is_transient(exc):
    """Transient: timeouts, connection errors, OSError with a transient
    errno (EIO/EAGAIN/ESTALE/...), and anything explicitly tagged
    `exc.transient = True`. Permanent: missing files, permissions,
    type/value errors — retrying those only delays the real traceback.
    """
    tagged = getattr(exc, "transient", None)
    if tagged is not None:
        return bool(tagged)
    status = getattr(exc, "http_status", None)
    if status is not None:
        return int(status) in TRANSIENT_HTTP_STATUSES
    if isinstance(exc, (TimeoutError, ConnectionError)):
        return True
    if isinstance(exc, _PERMANENT_TYPES):
        return False
    if isinstance(exc, OSError):
        return exc.errno in _TRANSIENT_ERRNOS
    # subprocess.TimeoutExpired without importing subprocess eagerly
    if type(exc).__name__ == "TimeoutExpired":
        return True
    return False


def tag_transient(exc, transient=True):
    """Stamp the explicit `.transient` tag on an exception and return
    it. The tag OVERRIDES type-based classification in `is_transient` /
    `classify_failure` (how injected faults say "this one is weather",
    or with transient=False, "fail loudly now")."""
    exc.transient = bool(transient)
    return exc


def classify_failure(exc):
    """Three-way failure taxonomy:

    'transient'  — weather (per `is_transient`), or tagged
                   `.transient = True`;
    'permanent'  — a programming or environment error (ValueError,
                   TypeError, missing file, permissions, an explicit
                   `.transient = False` tag) — retrying replays the
                   identical traceback, so fail loudly NOW;
    'infra'      — everything else (RuntimeError, a CUDA error, an
                   out-of-memory): can't prove it's a bug, so the
                   restart protocol gets the benefit of the doubt.
    """
    tagged = getattr(exc, "transient", None)
    if tagged is True:
        return "transient"
    if tagged is False:
        return "permanent"
    status = getattr(exc, "http_status", None)
    if status is not None:
        return classify_http_status(status)
    if is_transient(exc):
        return "transient"
    if isinstance(exc, _PERMANENT_TYPES) or isinstance(exc,
                                                      _PROGRAMMING_TYPES):
        return "permanent"
    return "infra"


class RetryBudget:
    """A shared, thread-safe allowance of retries for a subsystem.

    Every RETRY (not first attempts) spends one token; an empty budget
    makes with_retry fail fast after the first error. N calls then cost
    N + budget attempts in all, not N * max_attempts.
    """

    def __init__(self, tokens=64):
        self._mu = threading.Lock()
        self._tokens = int(tokens)
        self.spent = 0

    def take(self):
        with self._mu:
            if self._tokens <= 0:
                return False
            self._tokens -= 1
            self.spent += 1
            return True

    def remaining(self):
        with self._mu:
            return self._tokens


class RetryPolicy:
    """Backoff schedule + limits.

    max_attempts   total tries (1 == no retry)
    base_delay_s   first backoff cap (full jitter draws from [0, cap])
    max_delay_s    backoff cap ceiling
    multiplier     cap growth per retry
    deadline_s     total wall-time bound across attempts (None: unbounded)
    budget         optional RetryBudget shared across calls
    classify       predicate(exc) -> transient? (default `is_transient`)
    jitter         False: deterministic caps (tests); True: full jitter
    seed           seed of the jitter's random.Random
    """

    def __init__(self, max_attempts=4, base_delay_s=0.5, max_delay_s=30.0,
                 multiplier=2.0, deadline_s=None, budget=None,
                 classify=None, jitter=True, seed=None):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        self.max_attempts = int(max_attempts)
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.multiplier = float(multiplier)
        self.deadline_s = deadline_s
        self.budget = budget
        self.classify = classify or is_transient
        self.jitter = bool(jitter)
        self._rand = random.Random(seed)

    def delay(self, attempt):
        """Backoff before retry #`attempt` (1-based). Full jitter:
        U[0, cap]; cap = base * multiplier^(attempt-1), clipped."""
        cap = min(self.max_delay_s,
                  self.base_delay_s * (self.multiplier ** (attempt - 1)))
        return self._rand.uniform(0.0, cap) if self.jitter else cap

    def __repr__(self):
        return (f"RetryPolicy(max_attempts={self.max_attempts}, "
                f"base={self.base_delay_s}s, cap={self.max_delay_s}s, "
                f"deadline={self.deadline_s})")


def with_retry(fn, policy=None, on_retry=None, clock=None, sleep=None,
               label=None):
    """Call `fn()` under `policy`; returns fn's value or raises.

    Permanent errors (per policy.classify) raise immediately, untouched.
    Transient errors back off and retry until attempts, deadline, or the
    shared budget run out — then `RetryError` wraps the last one.

    on_retry(attempt, exc, delay_s) fires before each backoff sleep (the
    checkpoint manager advances `ckpt.retries` here). `clock`/`sleep`
    default to time.monotonic/time.sleep and are injectable for tests.
    """
    policy = policy or RetryPolicy()
    clock = clock or time.monotonic
    sleep = sleep or time.sleep
    name = label or getattr(fn, "__name__", "fn")
    t0 = clock()
    last = None
    attempt = 0
    while attempt < policy.max_attempts:
        attempt += 1
        try:
            return fn()
        except Exception as e:
            if not policy.classify(e):
                raise
            last = e
        if attempt >= policy.max_attempts:
            break
        if policy.budget is not None and not policy.budget.take():
            raise RetryError(
                f"{name}: retry budget exhausted after attempt {attempt}: "
                f"{type(last).__name__}: {last}", last=last,
                attempts=attempt)
        delay = policy.delay(attempt)
        # a Retry-After hint is a backoff floor: coming back sooner
        # than the server said just re-sheds
        hint = retry_after_hint(last)
        if hint is not None:
            delay = max(delay, hint)
        if policy.deadline_s is not None and \
                (clock() - t0) + delay > policy.deadline_s:
            raise RetryError(
                f"{name}: deadline {policy.deadline_s}s would be exceeded "
                f"after attempt {attempt}: {type(last).__name__}: {last}",
                last=last, attempts=attempt)
        if on_retry is not None:
            on_retry(attempt, last, delay)
        sleep(delay)
    raise RetryError(
        f"{name}: {policy.max_attempts} attempt(s) failed; last: "
        f"{type(last).__name__}: {last}", last=last, attempts=attempt)


def retrying(policy=None, **kwargs):
    """Decorator form: @retrying(RetryPolicy(max_attempts=5))."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            return with_retry(lambda: fn(*a, **kw), policy=policy, **kwargs)
        return wrapped
    return deco
