"""Cross-rank collective order checker — the port of
paddle_tpu/analysis/collective_order.py.

Ranks that issue mismatched collective sequences (different op order,
different shapes, one rank skipping a conditional all-reduce) do not
crash — they hang inside the mismatched collective until a deadline.
The port's collectives all open a span (`distributed/collective.py`
`_comm_span`), and that span calls `note()`, so each rank can capture
its ordered signature list — (op, axis, shape, dtype, call-site) — and
the lists can be compared across ranks.

The port executes a step where JAX traces one: a capture records the
collectives a rank really issued while it was open.

    with collective_order.capture(rank=r) as trace:
        ...run the rank's step...
    findings = collective_order.verify_ranks([trace0, trace1, ...])

Rules (family CO):

- CO301 order-mismatch — first position where two ranks' signatures
                         disagree (op/axis/shape/dtype).
- CO302 length-mismatch— one rank issues more collectives than another.
"""
import collections
import contextlib
import os
import traceback

from . import Finding, SEV_ERROR

__all__ = ["CollectiveSig", "CollectiveTrace", "note", "capture",
           "verify_ranks"]

CollectiveSig = collections.namedtuple(
    "CollectiveSig", ("op", "axis", "shape", "dtype", "site"))

# the single active capture; collective.py's span checks this and is a
# no-op (one attribute load) when no capture is open
_ACTIVE = None


class CollectiveTrace:
    """Ordered per-rank collective signature list."""

    def __init__(self, rank=0):
        self.rank = int(rank)
        self.sigs = []

    def append(self, sig):
        self.sigs.append(sig)

    def __len__(self):
        return len(self.sigs)

    def __iter__(self):
        return iter(self.sigs)


def _call_site():
    """First stack frame outside this package / collective.py."""
    skip = (os.sep + "analysis" + os.sep, os.sep + "collective.py",
            "contextlib.py")
    for frame in reversed(traceback.extract_stack(limit=16)):
        if not any(s in frame.filename for s in skip):
            return f"{os.path.basename(frame.filename)}:{frame.lineno}"
    return "?"


def note(op, axis=None, shape=None, dtype=None):
    """Record one collective into the active capture (no-op otherwise).
    Called by the collective span of `distributed/collective.py`."""
    trace = _ACTIVE
    if trace is None:
        return
    trace.append(CollectiveSig(
        op=str(op),
        axis=None if axis is None else str(axis),
        shape=None if shape is None else tuple(int(s) for s in shape),
        dtype=None if dtype is None else str(dtype),
        site=_call_site()))


@contextlib.contextmanager
def capture(rank=0):
    """Open a recording window; every collective issued while it is
    active lands in the yielded CollectiveTrace. An empty capture means
    "nothing observed", never "verified"."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("collective_order.capture is not reentrant")
    trace = CollectiveTrace(rank)
    _ACTIVE = trace
    try:
        yield trace
    finally:
        _ACTIVE = None


def _sig_key(sig):
    # call-site is reported but not part of equality: identical SPMD
    # code on two ranks may run through different wrappers
    return (sig.op, sig.axis, sig.shape, sig.dtype)


def _fmt(sig):
    out = sig.op
    if sig.axis is not None:
        out += f"(axis={sig.axis})"
    if sig.shape is not None:
        out += f" {sig.shape}/{sig.dtype}"
    return out + f" at {sig.site}"


def verify_ranks(traces):
    """Compare ordered collective signatures across ranks.

    `traces`: list of CollectiveTrace (or (rank, [sigs]) pairs). All
    ranks are compared against the lowest-numbered rank. Returns
    findings; [] means the recorded sequences cannot order-deadlock (for
    empty traces that statement is vacuous)."""
    norm = []
    for t in traces:
        if isinstance(t, CollectiveTrace):
            norm.append((t.rank, list(t.sigs)))
        else:
            rank, sigs = t
            norm.append((int(rank), list(sigs)))
    if len(norm) < 2:
        return []
    norm.sort(key=lambda rs: rs[0])
    ref_rank, ref = norm[0]
    findings = []
    for rank, sigs in norm[1:]:
        n = min(len(ref), len(sigs))
        diverged = False
        for i in range(n):
            if _sig_key(ref[i]) != _sig_key(sigs[i]):
                findings.append(Finding(
                    "CO301", SEV_ERROR,
                    f"rank {ref_rank} vs rank {rank}, collective #{i}",
                    f"collective order mismatch: rank {ref_rank} issues "
                    f"{_fmt(ref[i])} while rank {rank} issues "
                    f"{_fmt(sigs[i])} — both ranks block inside the "
                    "mismatched collective",
                    suggestion="make the collective sequence "
                               "rank-invariant (no data- or "
                               "rank-dependent branches around "
                               "collectives)"))
                diverged = True
                break
        if not diverged and len(ref) != len(sigs):
            longer_rank, longer = (ref_rank, ref) \
                if len(ref) > len(sigs) else (rank, sigs)
            findings.append(Finding(
                "CO302", SEV_ERROR,
                f"rank {ref_rank} vs rank {rank}, collective #{n}",
                f"rank {longer_rank} issues {abs(len(ref) - len(sigs))} "
                f"extra collective(s) starting with {_fmt(longer[n])} "
                "that the other rank never joins — the extra call hangs "
                "waiting for peers",
                suggestion="hoist the conditional collective out of "
                           "rank-dependent control flow"))
    return findings
