"""Transient-vs-permanent failure classification.

The port's copy of the classifier half of paddle_tpu/resilience/retry.py
(`is_transient`, `classify_failure`, `classify_http_status`,
`tag_transient`, `retry_after_hint`, `HTTPStatusError` and their type
tables, unchanged). The fleet router speaks the HTTP half: an
`HTTPReplica` raises `HTTPStatusError` for a non-2xx reply, and
`classify_failure` reads its status (429/503/504 transient, other 4xx
permanent, 5xx infra). The serving engine's
background loop rides `classify_failure` after a failed step: a
'permanent' failure (a programming error: ValueError, TypeError, ...)
fails the in-flight requests, anything else warm-restarts. Under this
taxonomy `torch.OutOfMemoryError` and a kernel wrapper's CUDA launch
error, both `RuntimeError`s, are 'infra': a warm restart. The retry
combinator of the JAX module (backoff policies, budgets) has no user in
the port yet and is not copied.
"""
import errno

__all__ = ["is_transient", "classify_failure", "tag_transient",
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
