"""Capture records: the port's counterpart of the compile observatory's
record-keeping half.

The JAX package compiles each serving and generation step into one XLA
program and records every (re)compile as a kind=compile record with the
cause diff (paddle_tpu/telemetry/compile_obs.py). The port's compiled
step is a CUDA graph captured over static buffers (`jit.CapturedStep`):
a capture is its compile, and each becomes the same kind=compile record,
so a steady state without a recapture is checkable from the telemetry
in both packages. This module is the port's own copy of the pure-Python
part of that observatory, unchanged in what it computes:

- `CompileSignature` / `signature_of` — one (name, shape, dtype,
  weak_type, sharding) descriptor per argument leaf plus the static
  values and the donate set; here the leaves are tensors, their "weak
  type" is always False and their sharding facet is the device they
  live on;
- `diff_signatures` — the human-readable causes of a recapture, e.g.
  "static `arenas` 0→1" after a warm restart rebuilt the KV arenas;
- `RecompileTracker` — the per-family ledger: the ordinal, the cause
  diff against the family's last signature, the record.

XLA's memory, cost and HLO analyses have no counterpart for a captured
graph and are not ported; a capture record carries the graph pool's
bytes instead (telemetry/sink.make_compile_record's `extra`).
"""
import hashlib

import torch

from .sink import make_compile_record

__all__ = ["CompileSignature", "signature_of", "diff_signatures",
           "RecompileTracker"]


def _leaf_desc(x):
    """(shape, dtype, weak_type, sharding) of one argument leaf: for a
    tensor its shape, dtype name ("float32", "bfloat16", "int32", as
    numpy names them) and device."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype).split(".")[-1], False,
                str(x.device))
    shape = tuple(getattr(x, "shape", ()))
    dtype = str(getattr(x, "dtype", type(x).__name__))
    return shape, dtype, False, None


def _flatten(x, path, out):
    """Leaves of nested lists, tuples and dicts with jax's key paths
    (`[0]`, `['k']`)."""
    if isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            _flatten(v, f"{path}[{i}]", out)
    elif isinstance(x, dict):
        for k in sorted(x, key=repr):
            _flatten(x[k], f"{path}[{k!r}]", out)
    elif x is not None:
        out.append((path, x))


class CompileSignature:
    """What a jit cache key is MADE OF, kept human-addressable: one
    descriptor per argument leaf (name derived from the arg tree path,
    e.g. `batch[0]` or `opt_states[1]['m']`), the static values the
    caller declares, and the donate set. Equality of `.key` means the
    jit cache would hit; a changed key plus `diff_signatures` names the
    recompile cause."""

    def __init__(self, leaves, static=None, donate=None):
        self.leaves = tuple(leaves)          # [(name, shape, dtype, wt, sh)]
        self.static = dict(static or {})
        self.donate = tuple(donate or ())
        self.key = (self.leaves,
                    tuple(sorted((k, repr(v))
                                 for k, v in self.static.items())),
                    self.donate)

    def summary(self):
        """Compact JSONL form (the full leaf list would bloat every
        record; the diff is precomputed into `cause` instead). The
        digest is a stable content hash — NOT Python hash(), which is
        per-process randomized — so identical programs digest equal
        across ranks and runs (multi-rank merge / replay correlation)."""
        digest = hashlib.sha1(repr(self.key).encode()).hexdigest()[:8]
        return {"n_leaves": len(self.leaves), "digest": digest}

    def __eq__(self, other):
        return isinstance(other, CompileSignature) and self.key == other.key

    def __hash__(self):
        return hash(self.key)

    def __repr__(self):
        return (f"CompileSignature({len(self.leaves)} leaves, "
                f"static={self.static}, donate={self.donate})")


def signature_of(args, arg_names=None, static=None, donate=None):
    """Build the signature of a positional-args tuple. `arg_names` (one
    per top-level arg) roots the leaf paths — causes then read
    "arg `batch[0]` ..." instead of "arg `[5][0]` ..."."""
    leaves = []
    for i, arg in enumerate(args):
        root = arg_names[i] if arg_names and i < len(arg_names) else f"[{i}]"
        flat = []
        _flatten(arg, "", flat)
        for path, leaf in flat:
            leaves.append((root + path, *_leaf_desc(leaf)))
    return CompileSignature(leaves, static=static, donate=donate)


def _shape_cause(name, old_shape, new_shape):
    if len(old_shape) == len(new_shape):
        changed = [i for i, (a, b) in enumerate(zip(old_shape, new_shape))
                   if a != b]
        axes = ", ".join(f"axis {i}: {old_shape[i]}→{new_shape[i]}"
                         for i in changed)
        return (f"arg `{name}` {axes} "
                f"(shape {old_shape}→{new_shape})")
    return (f"arg `{name}` rank {len(old_shape)}→{len(new_shape)} "
            f"(shape {old_shape}→{new_shape})")


def diff_signatures(old, new):
    """Human-readable causes for why `new` missed where `old` compiled.
    Returns a list of strings, one per changed facet; empty only when
    the signatures are equal (a recompile with an empty diff means the
    jit key involves something the signature cannot see — reported as
    such rather than silently)."""
    if old is None:
        return []
    causes = []
    olds = {name: rest for name, *rest in old.leaves}
    news = {name: rest for name, *rest in new.leaves}
    added = [n for n in news if n not in olds]
    removed = [n for n in olds if n not in news]
    if added or removed:
        causes.append(
            f"arg set changed: {len(old.leaves)}→{len(new.leaves)} "
            f"leaves"
            + (f", added {added[:4]}" if added else "")
            + (f", removed {removed[:4]}" if removed else ""))
    for name in news:
        if name not in olds:
            continue
        (oshape, odt, owt, osh) = olds[name]
        (nshape, ndt, nwt, nsh) = news[name]
        if oshape != nshape:
            causes.append(_shape_cause(name, oshape, nshape))
        if odt != ndt:
            causes.append(f"arg `{name}` dtype {odt}→{ndt}")
        if owt != nwt:
            causes.append(f"weak_type flip on `{name}` ({owt}→{nwt})")
        if osh != nsh and oshape == nshape:
            causes.append(f"arg `{name}` sharding {osh}→{nsh}")
    for k in sorted(set(old.static) | set(new.static)):
        ov, nv = old.static.get(k), new.static.get(k)
        if repr(ov) != repr(nv):
            causes.append(f"static `{k}` {ov!r}→{nv!r}")
    if old.donate != new.donate:
        causes.append(f"new donate set {old.donate}→{new.donate}")
    if not causes:
        causes.append("signature unchanged (cache miss from outside the "
                      "observed facets — e.g. a fresh jit object)")
    return causes


class RecompileTracker:
    """Per-family compile ledger: remembers each family's last
    signature, assigns the per-family ordinal (n_compiles), produces
    the cause diff, and builds the JSONL record. Pure bookkeeping: the
    caller owns dispatch and counters. `backend` names the device type
    ("cuda", or "cpu" where a step runs its body eagerly and nothing is
    captured)."""

    def __init__(self, rank=0, backend=None):
        self.rank = int(rank)
        self.backend = backend
        self.families = {}           # family -> (last signature, count)
        self._last_step = {}         # family -> last recorded step
        self.records = []

    def observe(self, family, signature, compile_ms, step, **extra):
        """Account one capture; returns the record dict (kind='compile').

        The step clock is clamped non-decreasing PER FAMILY: sources
        with instance-local clocks (a fresh StepTimer restarting at 0
        under a family name an earlier instance used) must not make the
        ledger run backwards — trace_check validates monotonicity."""
        step = max(int(step), self._last_step.get(family, 0))
        self._last_step[family] = step
        prev, count = self.families.get(family, (None, 0))
        cause = diff_signatures(prev, signature) \
            if signature is not None else None
        if signature is not None:
            self.families[family] = (signature, count + 1)
        else:
            self.families[family] = (prev, count + 1)
        rec = make_compile_record(
            fn=family, step=step, compile_ms=compile_ms, rank=self.rank,
            n_compiles=count + 1, backend=self.backend,
            cause=cause or None,
            signature=signature.summary() if signature is not None else None,
            **extra)
        self.records.append(rec)
        return rec
