"""Program lint: rules over one executed training step — the port's
counterpart of paddle_tpu/analysis/jaxpr_lint.py.

JAX traces a step into a jaxpr and walks it without running it. An
eager PyTorch step has no such program, so the port runs the step once
and records what it does: every aten op, through a
`torch.utils._python_dispatch.TorchDispatchMode`, and every collective,
through the spans of `distributed/collective.py` (an observer of
`_comm_span`). The CUDA kernels launch through ctypes and are invisible
to the dispatcher; none of the rules concerns them. Unlike the JAX
trace, the step is executed: linting it updates the model (the first
step of a trainer is linted while it trains).

Rules (family PT, each standing for the JAX rule named beside it, with
its severity):

- PT101 state-out-of-place (JX101 undonated-state, warning) — a
  parameter or optimizer slot whose storage (`data_ptr`) changes across
  the step: the update allocated a second copy of the state instead of
  writing in place.
- PT102 host-sync (JX102 host-callback, error) — a device-to-host sync
  inside the step: `aten._local_scalar_dense` (what `.item()`,
  `float(t)` and `bool(t)` call) or a copy of a CUDA tensor to the CPU.
- PT103 silent-upcast (JX103, warning) — a bf16/f16 tensor of at least
  UPCAST_MIN_ELEMENTS elements copied to f32/f64 (`aten._to_copy`).
- PT104 64-bit-value (JX104 x64-hazard, warning) — a float64 tensor
  anywhere, and an int64 tensor that is not an index operand. torch's
  index ops take int64 indices by rule, so an int64 value is exempt when
  it flows, through any chain of ops, into the index argument of an
  index op (INDEX_OPS: embedding, gather, scatter, index, nll_loss, ...).
- PT105 degenerate-collective (JX105, warning) — a collective span over
  a group of size 1 (or over an axis that the mesh sizes given to
  `lint_record` put at 1).
- PT106 reduce-then-broadcast (JX106, info) — a reduce-scatter whose
  result the same axis all-gathers next: the pair is an all-reduce.

`record_step(fn, *args, state=...)` runs `fn(*args)` under the recorder
and returns a `StepRecord`; `lint_record(record, mesh_axis_sizes=...)`
applies the rules to it (cheap, so the planner lints one cached record
per candidate layout); `train_step_state(step)` lists a trainer's
persistent state for PT101.
"""
import os
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from . import Finding, SEV_ERROR, SEV_INFO, SEV_WARNING

__all__ = ["UPCAST_MIN_ELEMENTS", "INDEX_OPS", "StepRecord", "record_step",
           "lint_record", "train_step_state"]

# PT103 floor (JAX's UPCAST_MIN_ELEMENTS): below this many elements an
# upcast is noise, not a bandwidth problem
UPCAST_MIN_ELEMENTS = 65536

# the ops whose int64 tensor operands are indices (PT104's exemption)
INDEX_OPS = frozenset({
    "embedding", "embedding_dense_backward", "embedding_backward",
    "_embedding_bag", "_embedding_bag_backward", "index", "index_put",
    "index_put_", "_index_put_impl_", "index_select", "index_add",
    "index_add_", "index_copy", "index_copy_", "index_fill", "index_fill_",
    "gather", "scatter", "scatter_", "scatter_add", "scatter_add_",
    "scatter_reduce", "scatter_reduce_", "take", "take_along_dim",
    "nll_loss_forward", "nll_loss_backward", "nll_loss2d_forward",
    "nll_loss2d_backward", "index_reduce", "index_reduce_",
})

_WIDE = (torch.int64, torch.float64)
_NARROW_FLOAT = (torch.bfloat16, torch.float16)
_SKIP_DIRS = (os.sep + "torch" + os.sep, os.sep + "analysis" + os.sep,
              os.sep + "collective.py", "contextlib.py")


def _site():
    """The first frame outside torch and this package's analysis."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if not any(s in name for s in _SKIP_DIRS):
            return f"{os.path.basename(name)}:{f.f_lineno}"
        f = f.f_back
    return "?"


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class StepRecord:
    """What one recorded step did: `hits` [(rule, site, detail)] of the
    per-op rules PT102/PT103, `wide` the ops that touched an int64 or
    float64 tensor (op, site, dtypes, ids of their int64 tensors and
    whether they are index operands — decided after the step), `spans`
    the collectives [(name, axis, group size, site)], `regathers` the
    PT106 pairs [(axis, site)], `moved` the state names whose storage
    changed (PT101), `n_ops` the aten ops seen."""

    def __init__(self, fn_name="step"):
        self.fn_name = fn_name
        self.hits = []
        self.wide = []
        self.spans = []
        self.regathers = []
        self.moved = []
        self.moved_bytes = 0
        self.n_ops = 0


class _Recorder(TorchDispatchMode):
    def __init__(self, record):
        super().__init__()
        self.rec = record
        self._keep = []          # int64/bool tensors, alive until the end
        self._graph = []         # (op, input ids, output ids) on them
        self._last_rs = {}       # axis -> storage ptr of a reduce-scatter

    # ---- aten ops --------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        rec = self.rec
        rec.n_ops += 1
        op = func._overloadpacket.__name__
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if op == "_local_scalar_dense":
            rec.hits.append(("PT102", _site(), (
                f"`aten._local_scalar_dense` reads a {tuple(ins[0].shape)} "
                f"{str(ins[0].dtype)[6:]} value on the host (.item(), "
                "float(t) or bool(t))")))
        elif op in ("_to_copy", "copy_", "_copy_from"):
            src = ins[1] if op == "copy_" and len(ins) > 1 else ins[0]
            dst = ins[0] if op == "copy_" else (outs[0] if outs else None)
            if dst is not None and src.is_cuda and dst.device.type == "cpu":
                rec.hits.append(("PT102", _site(), (
                    f"`aten.{op}` copies a {tuple(src.shape)} tensor from "
                    f"{src.device} to the CPU")))
            if dst is not None and src.dtype in _NARROW_FLOAT \
                    and dst.dtype in (torch.float32, torch.float64) \
                    and src.numel() >= UPCAST_MIN_ELEMENTS:
                rec.hits.append(("PT103", _site(), (
                    f"large tensor {tuple(src.shape)} silently upcast "
                    f"{str(src.dtype)[6:]} -> {str(dst.dtype)[6:]}: doubles "
                    "its memory and bandwidth mid-step")))
        ti = [t for t in ins if t.dtype in (torch.int64, torch.bool)]
        to = [t for t in outs if t.dtype in (torch.int64, torch.bool)]
        if ti or to:
            self._keep.extend(ti + to)
            self._graph.append((op, [id(t) for t in ti],
                                [id(t) for t in to]))
        wide = [t for t in ins + outs if t.dtype in _WIDE]
        if wide:
            rec.wide.append([op, _site(), sorted({str(t.dtype)[6:]
                                                  for t in wide}),
                             {id(t) for t in wide
                              if t.dtype == torch.int64},
                             any(t.dtype == torch.float64 for t in wide)])
        return out

    # ---- collectives -------------------------------------------------
    def observe(self, event, name, axis, size, tensor):
        ptr = None
        if tensor is not None and tensor.numel():
            ptr = tensor.untyped_storage().data_ptr()
        if event == "result":
            if name == "reduce_scatter":
                self._last_rs[axis] = ptr
            return
        self.rec.spans.append((name, axis, int(size), _site()))
        prev = self._last_rs.pop(axis, None)
        if name == "all_gather" and prev is not None and ptr == prev:
            self.rec.regathers.append((axis, _site()))

    def finish(self):
        """Decide which int64 tensors are index operands: the int64
        operands of an index op, and (backwards) every input of an op
        whose output is one."""
        index = set()
        for op, ins, outs in reversed(self._graph):
            if op in INDEX_OPS:
                index.update(ins)
            elif any(o in index for o in outs):
                index.update(ins)
        for w in self.rec.wide:
            w[3] = bool(w[3] - index)
        self._keep.clear()
        self._graph.clear()


def _state_ptrs(state):
    return {n: (t.untyped_storage().data_ptr(), t.numel() * t.element_size())
            for n, t in state if isinstance(t, torch.Tensor)}


def record_step(fn, *args, state=None, fn_name="step", **kwargs):
    """Run `fn(*args, **kwargs)` once under the recorder; `state` a
    callable -> [(name, tensor)] of the persistent state (PT101), read
    before and after. -> (fn's result, StepRecord)."""
    from ..distributed import collective
    rec = StepRecord(fn_name)
    before = _state_ptrs(state()) if state is not None else None
    mode = _Recorder(rec)
    collective._OBSERVERS.append(mode.observe)
    try:
        with mode:
            out = fn(*args, **kwargs)
    finally:
        collective._OBSERVERS.remove(mode.observe)
        mode.finish()
    if before is not None:
        after = _state_ptrs(state())
        for n, (ptr, nbytes) in before.items():
            if n in after and after[n][0] != ptr and nbytes:
                rec.moved.append(n)
                rec.moved_bytes += nbytes
    return out, rec


def lint_record(rec, mesh_axis_sizes=None, fn_name=None):
    """The PT rules over a StepRecord. `mesh_axis_sizes` ({axis: size})
    judges PT105 by a layout's sizes instead of the recorded groups'."""
    name = fn_name or rec.fn_name
    sizes = dict(mesh_axis_sizes or {})
    findings = []
    if rec.moved:
        head = ", ".join(rec.moved[:4])
        if len(rec.moved) > 4:
            head += f", +{len(rec.moved) - 4} more"
        findings.append(Finding(
            "PT101", SEV_WARNING, f"{name}({head})",
            f"{len(rec.moved)} persistent state buffer(s) "
            f"({rec.moved_bytes / 1e6:.1f} MB) were replaced by new storage "
            "in the step: the update allocated fresh memory next to the old "
            "copies instead of writing in place",
            suggestion="update parameters and optimizer slots in place "
                       "(torch._foreach_*_ / copy_), never rebind them"))
    for rule, site, detail in rec.hits:
        if rule == "PT102":
            findings.append(Finding(
                "PT102", SEV_ERROR, f"{name} @ {site}",
                f"device-to-host sync inside the step: {detail}; every "
                "call stalls the host on the device",
                suggestion="keep the value on the device (torch.where, "
                           "tensor arithmetic) or read it after the step"))
        else:
            findings.append(Finding(
                "PT103", SEV_WARNING, f"{name} @ {site}", detail,
                suggestion="keep the compute dtype, or accumulate in f32 "
                           "inside the op (out_dtype / a fused kernel)"))
    for op, site, dtypes, unindexed, f64 in rec.wide:
        if f64 or unindexed:
            findings.append(Finding(
                "PT104", SEV_WARNING, f"{name} @ {site}",
                f"64-bit value ({'/'.join(dtypes)}) in `aten.{op}`"
                + ("" if f64 else " that is not an index operand")
                + ": 64-bit arithmetic in the step is almost never intended",
                suggestion="keep floats in float32 and integers that are "
                           "not indices in int32"))
    for op, axis, size, site in rec.spans:
        n = sizes.get(axis, size) if axis is not None else size
        if n == 1:
            findings.append(Finding(
                "PT105", SEV_WARNING, f"{name} @ {site}",
                f"collective `{op}` over "
                + (f"axis {axis!r}" if axis is not None else "a group")
                + " of size 1: a no-op that still pays a collective "
                  "launch every step",
                suggestion="drop the collective or gate it on the mesh "
                           "axis size"))
    for axis, site in rec.regathers:
        findings.append(Finding(
            "PT106", SEV_INFO, f"{name} @ {site}",
            f"reduce-scatter followed by all_gather over axis {axis!r}: "
            "the pair is an all-reduce issued as two collectives",
            suggestion="replace the reduce_scatter + all_gather pair "
                       "with a single all_reduce"))
    return findings


def train_step_state(step):
    """[(name, tensor)] of a trainer's persistent state: its parameters
    (a ZeRO-3 step's own pieces instead) and every optimizer slot."""
    out = []
    shards = getattr(step, "_shards", None)
    if getattr(step, "zero_stage", 0) == 3 and shards:
        out += [(f"own:{k}", sh.own) for k, sh in enumerate(shards)
                if sh.own is not None]
    else:
        out += [(f"param:{n}", p) for n, p in
                zip(getattr(step, "param_names",
                            [str(k) for k in range(len(step.params))]),
                    step.params)]
    states = getattr(step, "_states", None)
    if states is None or getattr(step, "zero_stage", 1) == 0:
        opt = step.optimizer
        states = [opt._states.get(id(p), {}) for p in step.params]
    for k, st in enumerate(states):
        for slot, v in sorted(st.items()):
            if isinstance(v, torch.Tensor):
                out.append((f"opt:{k}.{slot}", v))
    return out
