"""Pipeline parallelism — the port of paddle_tpu/distributed/pipeline.py
(reference `fleet/meta_parallel/pp_layers.py`: LayerDesc/SharedLayerDesc
:49, SegmentLayers:63, PipelineLayer:132; `pipeline_parallel.py:30`,
train_batch:80; the C++ SectionWorker, `section_worker.cc:143`).

The JAX package runs every stage in one program: the block parameters
are stacked along a leading axis cut over pp, and a schedule is one
`lax.scan` over pipeline ticks in which every stage computes every tick
(an idle tick is masked, not skipped) and activations hop between
stages by `lax.ppermute`. The port runs a process a rank, as the
reference does, so a stage's idle ticks really idle and the schedules
are real send/receive schedules over the pp axis (`collective.exchange`,
each message matched by a tag, sends posted asynchronously):

- 1F1B (`pipeline_train_step_1f1b`, `PipelineParallel.train_batch`):
  warmup (pp - 1 - stage forwards), steady (one forward, one backward),
  cooldown; at most pp micro-batches in flight on stage 0, each kept as
  its autograd graph (the JAX schedule saves stage inputs and
  recomputes).
- interleaved (`pipeline_train_step_interleaved`, a PipelineLayer with
  `num_virtual_pipeline_stages` > 1): vpp chunks a rank, chunk l of
  stage s being virtual stage l * pp + s; Megatron's interleaved order,
  which needs the micro-batch count to divide by pp.
- GPipe (`pipeline_apply`, `eval_batch`): every micro-batch through
  every stage; `pipeline_apply`'s backward (`_GPipe`) reruns each
  stage's micro-batches in reverse from their kept inputs, as JAX
  differentiates its scan.
`pipeline_schedule_model` is the JAX tick model of the masked scan,
copied as the same arithmetic; it does not describe these schedules.

`PipelineParallel` plans a `PipelineLayer` as JAX does (`_plan_pipeline`:
the longest run of layers of one signature, `_stackable_sig` /
`_config_sig`, cut to a multiple of pp * vpp, split [front | blocks |
tail]); stage 0 runs the front, the last stage the tail and the loss,
and each stage keeps only the parameters it runs (the others keep their
shapes and give up their storage, as the reference builds only its
stage's layers; `stage_parameters()` names the ones kept). A
weight tied between the first and the last stage by a SharedLayerDesc
gets the sum of both stages' gradients (the shared-embedding
all-reduce, `pipeline_parallel.py:162`); the gradients are averaged over
dp (the batch is cut over dp); the tensor-parallel layers place their
own mp collectives. The port does not stack weights, so JAX's
stacked-copy freshness check (`_stack_is_fresh`) has nothing to guard:
every train_batch reads the live parameters, and a write to one between
batches is what the next batch uses.

Dropout inside a stage draws from the rank's own torch generator, not
from JAX's per-step key folded per block (ROADMAP Queue 3).
"""
import contextlib
import warnings

import torch
import torch.distributed as dist

from .. import monitor
from ..nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                       ClipGradByValue, clip_by_norm, need_clip)
from ..telemetry.health import health_rows, sharded_health_stats
from ..telemetry.recorder import auto_step
from . import env
from .collective import ReduceOp, _all_reduce_, _axis, exchange
from .recompute import RecomputeSequential

__all__ = ["pipeline_apply", "pipeline_apply_tensors",
           "pipeline_train_step_1f1b", "pipeline_schedule_model",
           "pipeline_train_step_interleaved", "schedule", "LayerDesc",
           "SharedLayerDesc", "SegmentLayers", "PipelineLayer",
           "PipelineParallel"]


# ---------------------------------------------------------------------------
# the schedules: each rank's order of forward (F) and backward (B) steps
# ---------------------------------------------------------------------------

def schedule(pp, vpp, n_micro, stage):
    """[(kind "F" | "B", chunk, micro-batch)] of `stage` in the order it
    runs them: 1F1B at vpp 1, Megatron's interleaved order above."""
    if vpp == 1:
        warm = min(pp - stage - 1, n_micro)
        ops = [("F", 0, m) for m in range(warm)]
        for i in range(n_micro - warm):
            ops += [("F", 0, warm + i), ("B", 0, i)]
        return ops + [("B", 0, m) for m in range(n_micro - warm, n_micro)]
    if n_micro % pp:
        raise ValueError(f"the interleaved schedule needs the micro-batch "
                         f"count ({n_micro}) to divide by pp ({pp})")
    total = n_micro * vpp
    warm = min((pp - stage - 1) * 2 + (vpp - 1) * pp, total)

    def chunk(k, forward):
        c = (k % (pp * vpp)) // pp
        return c if forward else vpp - 1 - c

    def micro(k):
        return (k // (pp * vpp)) * pp + k % pp

    ops = [("F", chunk(k, True), micro(k)) for k in range(warm)]
    for i in range(total - warm):
        k = warm + i
        ops += [("F", chunk(k, True), micro(k)),
                ("B", chunk(i, False), micro(i))]
    return ops + [("B", chunk(k, False), micro(k))
                  for k in range(total - warm, total)]


def pipeline_schedule_model(pp, vpp, n_micro):
    """The JAX package's analytic tick model of its masked-scan
    schedules (ticks = n + 2 (pp vpp - 1), waste = 1 - n / ticks), the
    same arithmetic. The port's schedules skip idle ticks, so this
    describes the JAX program, not theirs."""
    V = pp * vpp
    ticks = n_micro + 2 * (V - 1)
    return {"ticks": ticks, "waste": 1.0 - n_micro / ticks}


class _Meta:
    """Shape and dtype of the activations crossing stage boundaries."""

    def __init__(self, shape, dtype, device):
        self.shape, self.dtype, self.device = tuple(shape), dtype, device

    def empty(self):
        return torch.empty(self.shape, dtype=self.dtype, device=self.device)


def _run(ops, pp, vpp, stage, n_micro, meta, feed, chunk, head, train=True):
    """Run this rank's `ops` (see `schedule`). feed(m) -> virtual stage
    0's input of micro-batch m (stage 0 only); chunk(l, h) -> chunk l's
    output; head(out, m) -> (loss to backpropagate, loss to report) at
    the last virtual stage. A stage's input arrives from the previous
    virtual stage's rank and its input gradient goes back there; every
    send is posted without waiting and waited for at the end. Returns
    (the reported losses summed on the last stage, else None; the
    tensors `head` returned with train=False, by micro-batch)."""
    V = pp * vpp
    sends, saved, outs = [], {}, {}
    total = None

    def tag(kind, k, m):
        return (kind * V + k) * n_micro + m

    def post(t, k_to, kind, k, m):
        sends.append(exchange(t.detach(), "pp", k_to % pp, None,
                              tag=tag(kind, k, m)))

    def recv(k_from, kind, k, m):
        return exchange(None, "pp", None, k_from % pp, like=meta.empty(),
                        tag=tag(kind, k, m)).wait()

    for kind, l, m in ops:
        k = l * pp + stage
        if kind == "F":
            if k == 0:
                h = feed(m)
            else:
                h = recv(k - 1, 0, k - 1, m)
                if train:
                    h.requires_grad_()
            out = chunk(l, h)
            if k == V - 1:
                back, rep = head(out, m)
                if rep is not None:
                    total = rep if total is None else total + rep
                if train:
                    saved[(l, m)] = (h, back)
                else:
                    outs[m] = back
            else:
                post(out, k + 1, 0, k, m)
                if train:
                    saved[(l, m)] = (h, out)
        else:
            h, out = saved.pop((l, m))
            if k == V - 1:
                torch.autograd.backward(out)
            else:
                g = recv(k + 1, 1, k, m)
                torch.autograd.backward(out, g)
            if k > 0:
                post(h.grad if h.grad is not None else torch.zeros_like(h),
                     k - 1, 1, k - 1, m)
    for s in sends:
        s.wait()
    return total, outs


def _pp(mesh):
    return env.axis_size("pp", mesh)


def _with_mesh(mesh):
    """Install `mesh` (when given) for the call; -> the previous mesh."""
    prev = env.current_mesh()
    if mesh is not None:
        env.set_mesh(mesh)
    return prev


def _psum_pp(t):
    """Sum over the pp axis (a raw all-reduce, no autograd)."""
    if _pp(None) > 1:
        _all_reduce_(t, ReduceOp.SUM, _axis("pp")[0], axis="pp")
    return t


def _leaf(t):
    return t.detach().requires_grad_()


def _rng_state(device):
    """The host generator's state and, for a CUDA `device`, its
    generator's: what a rerun restores to draw the same numbers."""
    cuda = torch.cuda.get_rng_state(device) if device.type == "cuda" \
        else None
    return torch.get_rng_state(), cuda


@contextlib.contextmanager
def _rng_restored(state, device):
    """Run the block under `state` (`_rng_state`), leaving the
    generators as they were outside it."""
    cpu, cuda = state
    with torch.random.fork_rng(
            devices=[device] if cuda is not None else []):
        torch.set_rng_state(cpu)
        if cuda is not None:
            torch.cuda.set_rng_state(cuda, device)
        yield


def _micro(t, n):
    if t.shape[0] % n:
        raise ValueError(f"batch size {t.shape[0]} not divisible by "
                         f"num_microbatches {n}")
    return t.reshape((n, t.shape[0] // n) + tuple(t.shape[1:]))


# ---------------------------------------------------------------------------
# the functional executors (the JAX signatures)
# ---------------------------------------------------------------------------

def pipeline_apply(stage_fn, stacked_params, x, num_microbatches, mesh=None,
                   extra_inputs=()):
    """GPipe forward of x through `pp * blocks_per_stage` stacked blocks.
    stage_fn(local_params, x_mb, *extra) -> y_mb, where local_params are
    this stage's rows of `stacked_params` (a list of tensors whose
    leading dim is the total block count, the same on every rank). x:
    [B, ...] on every rank. -> y [B, ...] on every rank, differentiable
    in x, `stacked_params` and `extra_inputs` (`_GPipe`): the backward
    runs the micro-batches in reverse, a cotangent hop a stage boundary,
    and hands every rank the whole gradients, as the forward hands out
    y. At pp 1: stage_fn over the whole batch."""
    prev = _with_mesh(mesh)
    try:
        if _pp(None) == 1:
            return stage_fn(list(stacked_params), x, *extra_inputs)
        return _GPipe.apply(stage_fn, num_microbatches, env.current_mesh(),
                            len(stacked_params), x, *stacked_params,
                            *extra_inputs)
    finally:
        env.set_mesh(prev)


class _GPipe(torch.autograd.Function):
    """The GPipe executor as one autograd node. Forward: every
    micro-batch through every stage (no graph kept), each stage keeping
    its micro-batches' inputs; y summed over pp from the last stage.
    Backward, micro-batches in reverse: a stage receives its output's
    cotangent from the next stage (the last stage slices it from y's),
    reruns its forward from the kept input with a graph, under the
    random state that micro-batch's forward ran with (dropout draws the
    same masks, so the gradients are those of the forward that gave y),
    backpropagates, and sends its input's cotangent to the previous
    stage; the stage's
    parameter and extra-input gradients sum over its micro-batches. The
    stack's gradients (a stage's rows), dx (stage 0) and the extra
    inputs' gradients are then summed over pp, so every rank holds the
    whole gradients."""

    @staticmethod
    def forward(ctx, stage_fn, n_micro, mesh, n_params, x, *rest):
        params, extra = list(rest[:n_params]), list(rest[n_params:])
        pp = _pp(None)
        stage = env.axis_index("pp")
        rows = params[0].shape[0] // pp
        local = [p[stage * rows:(stage + 1) * rows] for p in params]
        xm = _micro(x, n_micro)
        meta = _Meta(xm.shape[1:], x.dtype, x.device)
        kept = []       # this stage's inputs, in micro-batch order
        rng = []        # the random state each micro-batch ran under

        def chunk(l, h):
            kept.append(h)
            rng.append(_rng_state(x.device))
            return stage_fn(local, h, *extra)

        ops = [("F", 0, m) for m in range(n_micro)]
        with torch.no_grad():
            _, outs = _run(ops, pp, 1, stage, n_micro, meta,
                           lambda m: xm[m], chunk,
                           lambda out, m: (out, None), train=False)
            y = torch.cat([outs[m] for m in range(n_micro)]) \
                if stage == pp - 1 else torch.zeros_like(x)
            y = _psum_pp(y.contiguous())
        ctx.stage_fn, ctx.n_micro, ctx.mesh = stage_fn, n_micro, mesh
        ctx.n_params, ctx.meta = n_params, meta
        ctx.kept, ctx.rng = kept, rng
        ctx.save_for_backward(*params, *extra)
        return y

    @staticmethod
    def backward(ctx, gy):
        prev = _with_mesh(ctx.mesh)
        try:
            saved = ctx.saved_tensors
            params = list(saved[:ctx.n_params])
            extra = list(saved[ctx.n_params:])
            n, meta = ctx.n_micro, ctx.meta
            pp = _pp(None)
            stage = env.axis_index("pp")
            rows = params[0].shape[0] // pp
            local = [_leaf(p[stage * rows:(stage + 1) * rows])
                     for p in params]
            ex = [_leaf(e) if e.is_floating_point() else e for e in extra]
            gym = _micro(gy, n) if stage == pp - 1 else None
            dxs, sends = {}, []
            for m in reversed(range(n)):
                h = _leaf(ctx.kept[m])
                with _rng_restored(ctx.rng[m], meta.device), \
                        torch.enable_grad():
                    out = ctx.stage_fn(local, h, *ex)
                # the tags of `_run`'s cotangents: (pp + receiver) n + m
                g = gym[m] if stage == pp - 1 else exchange(
                    None, "pp", None, stage + 1, like=meta.empty(),
                    tag=(pp + stage) * n + m).wait()
                torch.autograd.backward(out, g)
                dh = h.grad if h.grad is not None else torch.zeros_like(h)
                if stage > 0:
                    sends.append(exchange(dh.detach(), "pp", stage - 1,
                                          None,
                                          tag=(pp + stage - 1) * n + m))
                else:
                    dxs[m] = dh
            for snd in sends:
                snd.wait()
            grads = []
            for p, leaf in zip(params, local):
                g = torch.zeros_like(p)
                if leaf.grad is not None:
                    g[stage * rows:(stage + 1) * rows] = leaf.grad
                grads.append(_psum_pp(g))
            egrads = [_psum_pp(e.grad.clone() if e.grad is not None
                               else torch.zeros_like(e))
                      if e.is_floating_point() else None for e in ex]
            dx = torch.cat([dxs[m] for m in range(n)]) if stage == 0 \
                else torch.zeros((n * meta.shape[0],) + meta.shape[1:],
                                 dtype=meta.dtype, device=meta.device)
            return (None, None, None, None, _psum_pp(dx.contiguous()),
                    *grads, *egrads)
        finally:
            env.set_mesh(prev)


def pipeline_apply_tensors(stage_fn, stacked_param_tensors, x_tensor,
                           num_microbatches, mesh=None):
    """`pipeline_apply` over tensors: one autograd node for the
    pipelined region, as the JAX wrapper records."""
    return pipeline_apply(stage_fn, list(stacked_param_tensors), x_tensor,
                          num_microbatches, mesh=mesh)


def _train_step(stage_fn, head_loss_fn, stacked_params, head_params, x, y,
                n_micro, vpp, mesh):
    """The 1F1B (vpp 1) and interleaved executors: -> (loss, the whole
    stack's gradients, head grads, dx), all on every rank."""
    prev = _with_mesh(mesh)
    try:
        pp = _pp(None)
        stage = env.axis_index("pp")
        total_rows = stacked_params[0].shape[0]
        V = pp * vpp
        if total_rows % V:
            raise ValueError(
                f"{total_rows} stacked blocks not divisible by pp*vpp={V}; "
                "pad or change the chunking")
        bpc = total_rows // V
        # this rank's chunks: chunk l holds rows of virtual stage l*pp+s
        leaves = [[_leaf(p[(l * pp + stage) * bpc:(l * pp + stage + 1) * bpc])
                   for p in stacked_params] for l in range(vpp)]
        hp = [_leaf(p) for p in head_params]
        xm, ym = _micro(x, n_micro), _micro(y, n_micro)
        xs = {}

        def feed(m):
            xs[m] = _leaf(xm[m])
            return xs[m]

        def head(out, m):
            loss = head_loss_fn(hp, out, ym[m]) / n_micro
            return loss, loss.detach().float()

        meta = _Meta(xm.shape[1:], x.dtype, x.device)
        total, _ = _run(schedule(pp, vpp, n_micro, stage), pp, vpp, stage,
                        n_micro, meta, feed,
                        lambda l, h: stage_fn(leaves[l], h), head)
        loss = _psum_pp(total if total is not None else
                        torch.zeros((), dtype=torch.float32,
                                    device=x.device))
        grads = []
        for j, p in enumerate(stacked_params):
            g = torch.zeros_like(p)
            for l in range(vpp):
                k = l * pp + stage
                leaf = leaves[l][j]
                if leaf.grad is not None:
                    g[k * bpc:(k + 1) * bpc] = leaf.grad
            grads.append(_psum_pp(g))
        hg = [_psum_pp(h.grad.clone() if h.grad is not None
                       else torch.zeros_like(h)) for h in hp]
        dx = torch.cat([xs[m].grad if m in xs and xs[m].grad is not None
                        else torch.zeros_like(xm[m])
                        for m in range(n_micro)])
        return loss, grads, hg, _psum_pp(dx.contiguous())
    finally:
        env.set_mesh(prev)


def _single(stage_fn, head_loss_fn, stacked_params, head_params, x, y):
    """pp 1: one backward over the whole batch (as JAX's pp 1 path)."""
    params = [_leaf(p) for p in stacked_params]
    hp = [_leaf(p) for p in head_params]
    xl = _leaf(x)
    loss = head_loss_fn(hp, stage_fn(params, xl), y)
    gs = torch.autograd.grad(loss, params + hp + [xl], allow_unused=True)
    gs = [torch.zeros_like(t) if g is None else g
          for t, g in zip(params + hp + [xl], gs)]
    n = len(params)
    return loss.detach(), gs[:n], gs[n:n + len(hp)], gs[-1]


def pipeline_train_step_1f1b(stage_fn, head_loss_fn, stacked_params,
                             head_params, x, y, num_microbatches, mesh=None):
    """One 1F1B forward and backward over the pp axis.

    stage_fn(local_params, h_mb) -> h_mb (local_params: this stage's rows
    of `stacked_params`, whose leading dim is the total block count, the
    same tensors on every rank); head_loss_fn(head_params, h_mb, y_mb) ->
    the micro-batch's mean loss (on the last stage). x [B, ...] (already
    embedded) and y [B, ...] on every rank. Returns (loss, the stack's
    gradients, head_params' gradients, dx = d loss / dx), each on every
    rank (summed over pp: a stage fills its own rows, the last stage the
    head's, stage 0 dx). At pp 1: one backward over the whole batch."""
    if _pp(mesh) == 1:
        return _single(stage_fn, head_loss_fn, stacked_params, head_params,
                       x, y)
    return _train_step(stage_fn, head_loss_fn, stacked_params, head_params,
                       x, y, num_microbatches, 1, mesh)


def pipeline_train_step_interleaved(stage_fn, head_loss_fn, stacked_params,
                                    head_params, x, y, num_microbatches,
                                    vpp, mesh=None):
    """Interleaved 1F1B: `vpp` chunks a rank, chunk l of stage s the
    rows of virtual stage l * pp + s (`stacked_params` in the GLOBAL
    layer order, stage_fn(chunk_params, h) over total / (pp vpp) rows).
    Returns as `pipeline_train_step_1f1b`, the stack's gradients in the
    global order. vpp 1 is 1F1B; pp 1 runs the vpp chunks back to back
    in one backward."""
    if vpp == 1:
        return pipeline_train_step_1f1b(
            stage_fn, head_loss_fn, stacked_params, head_params, x, y,
            num_microbatches, mesh=mesh)
    if _pp(mesh) > 1:
        return _train_step(stage_fn, head_loss_fn, stacked_params,
                           head_params, x, y, num_microbatches, vpp, mesh)
    n_rows = stacked_params[0].shape[0]
    if n_rows % vpp:
        raise ValueError(f"{n_rows} stacked blocks not divisible by vpp={vpp}")
    rows = n_rows // vpp

    def full_fn(params, h):
        for l in range(vpp):
            h = stage_fn([p[l * rows:(l + 1) * rows] for p in params], h)
        return h
    return _single(full_fn, head_loss_fn, stacked_params, head_params, x, y)


# ---------------------------------------------------------------------------
# the PipelineLayer API (reference pp_layers.py)
# ---------------------------------------------------------------------------

class LayerDesc:
    def __init__(self, layer_func, *inputs, **kwargs):
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_func(*self.inputs, **self.kwargs)


class SharedLayerDesc(LayerDesc):
    def __init__(self, key, layer_func, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class SegmentLayers:
    """Uniform layer -> stage assignment (reference `pp_layers.py:63`)."""

    def __init__(self, layers_desc, num_parts, method="uniform"):
        self.layers_desc = layers_desc
        self.num_parts = num_parts
        self.method = method

    def do_segment(self):
        n = len(self.layers_desc)
        if self.method == "uniform":
            return self.uniform(n, self.num_parts)
        raise NotImplementedError(self.method)

    @staticmethod
    def uniform(num_items, num_parts):
        result = [0] * (num_parts + 1)
        part_size = num_items // num_parts
        extra = num_items % num_parts
        for i in range(1, num_parts + 1):
            result[i] = result[i - 1] + part_size + (1 if i <= extra else 0)
        return result


def _call(kind, item, shared):
    """The callable of one item of a PipelineLayer."""
    if kind == "shared":
        layer = shared[item.layer_name]
        if item.forward_func is not None:
            return lambda h: item.forward_func(layer, h)
        return layer
    return item


def _run_items(items, h, shared, interval=0):
    fns = [_call(k, it, shared) for k, it in items]
    if interval:
        return RecomputeSequential(fns, interval)(h)
    for f in fns:
        h = f(h)
    return h


class PipelineLayer(torch.nn.Module):
    """The layer list and its segmentation (reference `pp_layers.py:132`).
    Every rank builds every layer, as in JAX (the same seed gives the
    same weights); `PipelineParallel` keeps only the rank's stage's.
    `recompute_interval` runs every interval-th layer under
    `distributed.recompute` (`RecomputeSequential`);
    `num_virtual_pipeline_stages` (vpp) gives each rank vpp chunks of the
    block run under `PipelineParallel` (the interleaved schedule)."""

    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seg_method="uniform", recompute_interval=0,
                 num_virtual_pipeline_stages=None, **kwargs):
        super().__init__()
        self._loss_fn = loss_fn
        self._num_stages = num_stages or 1
        self._recompute_interval = int(recompute_interval or 0)
        self._num_virtual_stages = int(num_virtual_pipeline_stages or 1)
        self.layers_desc = layers
        built = []
        self.shared_layers = {}
        for d in layers:
            if isinstance(d, SharedLayerDesc):
                if d.layer_name in self.shared_layers:
                    built.append(("shared", d))
                    continue
                layer = d.build_layer()
                self.shared_layers[d.layer_name] = layer
                built.append(("layer", layer))
            elif isinstance(d, LayerDesc):
                built.append(("layer", d.build_layer()))
            elif isinstance(d, torch.nn.Module):
                built.append(("layer", d))
            else:       # a callable such as lambda x: ...
                built.append(("func", d))
        self._items = built
        self.run_function = torch.nn.ModuleList(
            [l for kind, l in built if kind == "layer"])
        self.segment_parts = SegmentLayers(
            layers, self._num_stages, seg_method).do_segment()

    def forward(self, x):
        return _run_items(self._items, x, self.shared_layers,
                          self._recompute_interval)

    def get_stage_from_index(self, layer_idx):
        for stage in range(self._num_stages):
            if self.segment_parts[stage] <= layer_idx < \
                    self.segment_parts[stage + 1]:
                return stage
        return self._num_stages - 1


# ---------------------------------------------------------------------------
# the plan: [front | homogeneous block run | tail]
# ---------------------------------------------------------------------------

_UNREP = object()           # a config value the signature cannot represent
# torch.nn.Module's own bookkeeping, which is not configuration
_MODULE_INTERNALS = frozenset(vars(torch.nn.Module()))


def _sig_value(v, depth=0):
    """Hashable representation of a scalar or recursively scalar
    container, or _UNREP (the JAX function)."""
    if isinstance(v, (int, float, bool, str, type(None))):
        return v
    if depth > 8:
        return _UNREP
    if isinstance(v, (tuple, list)):
        parts = tuple(_sig_value(e, depth + 1) for e in v)
        if any(p is _UNREP for p in parts):
            return _UNREP
        return ("seq", type(v).__name__, parts)
    if isinstance(v, dict):
        items = []
        for k in sorted(v, key=repr):
            kv, vv = _sig_value(k, depth + 1), _sig_value(v[k], depth + 1)
            if kv is _UNREP or vv is _UNREP:
                return _UNREP
            items.append((kv, vv))
        return ("map", tuple(items))
    return _UNREP


def _config_sig(layer, prefix=""):
    """Every scalar (or recursively scalar container) attribute of the
    layer and its sublayers: two same-class blocks whose forwards differ
    through parameterless config must not share a stage plan. A
    container the signature cannot represent contributes a per-object
    entry (the JAX rule)."""
    out = []
    for k in sorted(vars(layer)):
        if k in _MODULE_INTERNALS:
            continue
        v = vars(layer)[k]
        if isinstance(v, (int, float, bool, str, type(None))):
            out.append((prefix + k, v))
        elif isinstance(v, (tuple, list, dict)):
            sv = _sig_value(v)
            out.append((prefix + k, ("unrep", id(v)) if sv is _UNREP
                        else sv))
    for n, sub in layer._modules.items():
        if sub is not None:
            out.extend(_config_sig(sub, prefix + n + "."))
    return tuple(out)


def _stackable_sig(kind, item):
    """Homogeneity signature: type, the (name, shape, dtype) parameter
    tree and the scalar config. Layers with buffers or no parameters,
    shared references and bare callables have none."""
    if kind != "layer":
        return None
    if any(b is not None for _, b in item.named_buffers()):
        return None
    sig = tuple((n, tuple(p.shape), str(p.dtype))
                for n, p in item.named_parameters())
    if not sig:
        return None
    return (type(item), sig, _config_sig(item))


def _unique(params):
    seen, out = set(), []
    for p in params:
        if id(p) not in seen:
            seen.add(id(p))
            out.append(p)
    return out


# ---------------------------------------------------------------------------
# PipelineParallel
# ---------------------------------------------------------------------------

# the tags of the tied weights' gradient exchange, above the schedules'
_TIED_TAG = 1 << 30


def _unported(what, item):
    raise NotImplementedError(f"PipelineParallel.{what} is not ported: "
                              f"ROADMAP Queue 1 item {item}")


class PipelineParallel(torch.nn.Module):
    """The wrapper of `meta_parallel/pipeline_parallel.py:30` (see the
    module docstring). With an installed mesh whose pp axis is above 1
    and a plan, `train_batch` runs 1F1B (interleaved when the
    PipelineLayer has vpp > 1); without a plan (warned once) or pp of 1
    it runs the sequential accumulation, as JAX does. The batch is cut
    over dp when the mesh has a dp axis above 1. `lint`, `plan`,
    `health` and `resilience` are attributes as in JAX. `resilience`
    (a ResilienceManager, CheckpointManager, directory or kwargs) is
    attached to the PipelineLayer and the optimizer at the first
    train_batch and its `step_boundary` runs after each; under a
    pipelined plan each rank checkpoints and restores its stage's
    parameters. `health` (True, a dict, a HealthConfig or a
    HealthMonitor) arms the hang watchdog around each train_batch and,
    on the batches the monitor fetches, taps the loss's NaN/Inf and the
    raw gradients' norm over every stage (JAX's values: no update
    ratio; JAX's 1F1B path taps no gradient, the port taps them all,
    the sequential path's numbers). Setting `lint` or `plan` makes
    train_batch raise NotImplementedError naming its ROADMAP item, and
    `apply_plan` raises."""

    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        acc = 1
        if strategy is not None:
            acc = strategy.pipeline_configs.get("accumulate_steps", 1)
        self._num_micro = acc
        self._pipe_plan = None
        self._pipe_pp = None
        self._meta = {}
        if env.current_mesh() is not None:
            from .sharded_train import shard_model
            shard_model(layers)
        self.lint = False
        self.health = None
        self._health_mon = None
        self._health_key = None
        self._last_health = None
        self.resilience = None
        self._resilience_mgr = None
        self._resilience_key = None
        self.plan = None

    def _resilience_manager(self):
        """Normalize and cache the `resilience` attribute."""
        if self.resilience is None or self.resilience is False:
            self._resilience_mgr = None
            self._resilience_key = self.resilience
            return None
        if self._resilience_mgr is None or \
                self._resilience_key is not self.resilience:
            from ..resilience.preempt import as_resilience
            self._resilience_mgr = as_resilience(self.resilience)
            self._resilience_key = self.resilience
        return self._resilience_mgr

    def _health_monitor(self):
        """Normalize and cache the `health` attribute."""
        if self.health is None or self.health is False:
            self._health_mon = None
            self._health_key = self.health
            return None
        if self._health_mon is None or self._health_key is not self.health:
            from ..telemetry.health import as_monitor
            self._health_mon = as_monitor(self.health)
            self._health_key = self.health
        return self._health_mon

    def stage_parameters(self):
        """[(name, parameter)] this rank holds: every parameter, or under
        a pipelined plan its stage's."""
        plan = self._pipe_plan
        named = list(self._layers.named_parameters())
        if not isinstance(plan, dict) or "local_ids" not in plan:
            return named
        return [(n, p) for n, p in named if id(p) in plan["local_ids"]]

    def apply_plan(self, plan):
        _unported("apply_plan", "6.4 (the planner and cost model)")

    def forward(self, x):
        return self._layers(x)

    # ---- the plan ------------------------------------------------------
    def _collect_params(self, items):
        out = []
        for kind, item in items:
            if kind == "layer":
                out.extend(item.parameters())
            elif kind == "shared":
                out.extend(self._layers.shared_layers[item.layer_name]
                           .parameters())
        return _unique(out)

    def _plan_pipeline(self, pp, vpp=1):
        """The longest run of consecutive layers of one signature, cut to
        its largest multiple of pp * vpp; the rest of the run joins the
        tail (the JAX rule)."""
        items = list(self._layers._items)
        sigs = [_stackable_sig(k, it) for k, it in items]
        best_start, best_len = 0, 0
        i = 0
        while i < len(items):
            if sigs[i] is None:
                i += 1
                continue
            j = i
            while j < len(items) and sigs[j] == sigs[i]:
                j += 1
            if j - i > best_len:
                best_start, best_len = i, j - i
            i = j
        V = pp * vpp
        usable = (best_len // V) * V
        if usable < V or usable < 2:
            return None
        front = items[:best_start]
        blocks = [it for _, it in items[best_start:best_start + usable]]
        tail = items[best_start + usable:]
        front_params = self._collect_params(front)
        tail_params = self._collect_params(tail)
        tail_ids = {id(p) for p in tail_params}
        return dict(front=front, blocks=blocks, tail=tail, vpp=vpp,
                    front_params=front_params, tail_params=tail_params,
                    tied=[p for p in front_params if id(p) in tail_ids])

    def _resolve_plan(self, pp, mesh):
        """The plan for this mesh (cached); warns once when there is
        none."""
        vpp = self._layers._num_virtual_stages
        if self._pipe_plan is None or self._pipe_pp != (pp, vpp, mesh):
            self._pipe_plan = self._plan_pipeline(pp, vpp) or "none"
            self._pipe_pp = (pp, vpp, mesh)
            if self._pipe_plan == "none":
                warnings.warn(
                    f"PipelineParallel: mesh has pp={pp} but the "
                    "PipelineLayer has no run of >= pp consecutive "
                    "identical-architecture layers to pipeline; "
                    "train_batch/eval_batch run SEQUENTIALLY on every "
                    "device (no pipeline parallelism)")
            else:
                self._place(self._pipe_plan, pp)
        return None if self._pipe_plan == "none" else self._pipe_plan

    def _place(self, plan, pp):
        """This stage's chunks; the parameters of the layers it never
        runs give up their storage (their shapes stay)."""
        stage = env.axis_index("pp")
        vpp = plan["vpp"]
        bpc = len(plan["blocks"]) // (pp * vpp)
        plan["chunks"] = [plan["blocks"][(l * pp + stage) * bpc:
                                         (l * pp + stage + 1) * bpc]
                          for l in range(vpp)]
        keep = {id(p) for c in plan["chunks"] for b in c
                for p in b.parameters()}
        if stage == 0:
            keep |= {id(p) for p in plan["front_params"]}
        if stage == pp - 1:
            keep |= {id(p) for p in plan["tail_params"]}
        for p in self._layers.parameters():
            if id(p) not in keep:
                p.data.untyped_storage().resize_(0)
        plan["local"] = [p for p in self._layers.parameters()
                         if id(p) in keep]
        plan["local_ids"] = keep
        plan["stage"] = stage

    # ---- helpers ----------------------------------------------------------
    def _mesh_pp(self):
        mesh = env.current_mesh()
        return mesh, env.axis_size("pp", mesh)

    def _dp_cut(self, t):
        dp = env.axis_size("dp")
        if dp == 1:
            return t
        if t.shape[0] % dp:
            raise ValueError(f"batch size {t.shape[0]} does not divide by "
                             f"the dp mesh size {dp}")
        return t.chunk(dp)[env.axis_index("dp")]

    def _act_meta(self, plan, x, feed0):
        """Shape and dtype of the boundary activations: stage 0 runs the
        front of micro-batch 0 and tells the other stages (cached by the
        micro-batch's shape and the amp state)."""
        from ..amp import amp_state
        a = amp_state()
        key = (tuple(x.shape), x.dtype, a.enabled, a.dtype)
        h0 = feed0() if plan["stage"] == 0 else None
        if key not in self._meta:
            box = [None if h0 is None else (tuple(h0.shape), h0.dtype)]
            group, _, ranks = _axis("pp")
            dist.broadcast_object_list(box, src=ranks[0], group=group)
            self._meta[key] = box[0]
        shape, dtype = self._meta[key]
        return _Meta(shape, dtype, x.device), h0

    def _chunk_fn(self, plan):
        interval = self._layers._recompute_interval

        def chunk(l, h):
            return _run_items([("layer", b) for b in plan["chunks"][l]], h,
                              self._layers.shared_layers, interval)
        return chunk

    # ---- training ----------------------------------------------------------
    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """One gradient-accumulated step over `accumulate_steps`
        micro-batches (reference `pipeline_parallel.py:80`): 1F1B (or
        interleaved) on a pp mesh with a plan, else the sequential
        accumulation; one optimizer step at the end. Returns the batch's
        mean loss (a detached f32 scalar), the same on every rank."""
        if self.lint:
            _unported("lint", "6.4 (the planner and cost model)")
        if self.plan is not None:
            _unported("plan", "6.4 (the planner and cost model)")
        monitor.incr("pipeline.train_batches")
        hm = self._health_monitor()
        with auto_step() as win:
            if hm is not None:
                with hm.guard(win) as g:
                    out = self._train_batch_impl(data, optimizer,
                                                 lr_scheduler, scaler,
                                                 hm.will_fetch())
                    g.stage(self._last_health)
            else:
                out = self._train_batch_impl(data, optimizer, lr_scheduler,
                                             scaler, False)
            win.note(loss=out)
        res = self._resilience_manager()
        if res is not None:
            plan = self._pipe_plan
            # a pipelined rank holds (and checkpoints) its stage's layers
            self._layers._ckpt_param_ids = plan["local_ids"] \
                if isinstance(plan, dict) and "local_ids" in plan else None
            if res.ckpt.model is None:
                res.attach(self._layers, optimizer)
            res.step_boundary(loss=out)
        return out

    def _train_batch_impl(self, data, optimizer, lr_scheduler, scaler,
                          taps):
        self._layers.train()
        x, y = data
        loss_fn = self._layers._loss_fn
        if loss_fn is None:
            raise ValueError(
                "PipelineParallel.train_batch requires the PipelineLayer to "
                "be built with loss_fn=... (labels are otherwise unused)")
        n_micro = max(1, self._num_micro)
        x, y = self._dp_cut(x), self._dp_cut(y)
        bsz = x.shape[0]
        if bsz % n_micro != 0:
            raise ValueError(f"batch size {bsz} not divisible by "
                             f"accumulate_steps {n_micro}")
        if scaler is not None and not scaler.is_enable():
            scaler = None
        mesh, pp = self._mesh_pp()
        plan = self._resolve_plan(pp, mesh) if pp > 1 else None
        if plan is not None:
            total = self._pipelined_grads(plan, x, y, n_micro, scaler)
        else:
            total = self._sequential_grads(x, y, n_micro, scaler)
        params = plan["local"] if plan is not None else _unique(
            self._layers.parameters())
        self._average_dp(params)
        total = total.detach().float().reshape(())
        if env.axis_size("dp") > 1:
            _all_reduce_(total, ReduceOp.SUM, _axis("dp")[0], axis="dp")
            total /= env.axis_size("dp")
        self._last_health = None
        if taps:
            # the raw gradients, before the scaler's unscale and the clip
            # (JAX's taps: loss NaN/Inf and the gradient norm, no update
            # ratio)
            with torch.no_grad():
                n, idx, grads, sum_cuts = self._counted(plan, params)
                self._last_health = sharded_health_stats(
                    total, health_rows(n, idx, grads=grads), sum_cuts)
        self._step(optimizer, scaler, params, plan)
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return total

    def _sequential_grads(self, x, y, n_micro, scaler):
        loss_fn = self._layers._loss_fn
        mb = x.shape[0] // n_micro
        total = None
        for i in range(n_micro):
            xm, ym = x[i * mb:(i + 1) * mb], y[i * mb:(i + 1) * mb]
            loss = loss_fn(self._layers(xm), ym) / n_micro
            (scaler.scale(loss) if scaler is not None else loss).backward()
            total = loss.detach() if total is None else \
                total + loss.detach()
        return total

    def _pipelined_grads(self, plan, x, y, n_micro, scaler):
        pp = env.axis_size("pp")
        vpp = plan["vpp"]
        stage = plan["stage"]
        loss_fn = self._layers._loss_fn
        shared = self._layers.shared_layers
        xm, ym = _micro(x, n_micro), _micro(y, n_micro)

        def feed(m):
            return _run_items(plan["front"], xm[m], shared)

        meta, h0 = self._act_meta(plan, xm[0], lambda: feed(0))

        def first(m):
            return h0 if m == 0 else feed(m)

        def head(out, m):
            loss = loss_fn(_run_items(plan["tail"], out, shared), ym[m]) \
                / n_micro
            back = scaler.scale(loss) if scaler is not None else loss
            return back, loss.detach().float()

        total, _ = _run(schedule(pp, vpp, n_micro, stage), pp, vpp, stage,
                        n_micro, meta, first, self._chunk_fn(plan), head)
        if total is None:
            total = torch.zeros((), dtype=torch.float32, device=x.device)
        self._sum_tied(plan, pp)
        return _psum_pp(total)

    def _sum_tied(self, plan, pp):
        """A weight tied between stage 0 and the last stage: each sends
        its gradient to the other and adds the one it receives."""
        stage = plan["stage"]
        if not plan["tied"] or stage not in (0, pp - 1):
            return
        peer = pp - 1 - stage
        for j, p in enumerate(plan["tied"]):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            got = exchange(g.contiguous(), "pp", peer, peer,
                           tag=_TIED_TAG + j).wait()
            p.grad = g + got

    def _average_dp(self, params):
        dp = env.axis_size("dp")
        if dp == 1:
            return
        by_dtype = {}
        for p in params:
            if p.grad is not None:
                by_dtype.setdefault(p.dtype, []).append(p)
        group = _axis("dp")[0]
        for ps in by_dtype.values():
            flat = torch.cat([p.grad.reshape(-1) for p in ps])
            _all_reduce_(flat, ReduceOp.SUM, group, axis="dp")
            flat /= dp
            o = 0
            for p in ps:
                n = p.numel()
                p.grad = flat[o:o + n].view(p.shape).clone()
                o += n

    def _step(self, optimizer, scaler, params, plan):
        """Unscale (the inf agreed by every rank), clip over the mesh,
        then the optimizer's step."""
        split = env.get_world_size() > 1 and (
            plan is not None or env.axis_size("mp") > 1)
        if scaler is not None:
            scaler.unscale_(optimizer)
            if env.get_world_size() > 1:
                bad = torch.tensor([float(scaler._found_inf)],
                                   device=params[0].device)
                _all_reduce_(bad, ReduceOp.MAX, None)
                scaler._found_inf = bool(bad.item())
            if scaler._found_inf:
                scaler._update()
                return
        clip = optimizer._grad_clip
        if clip is not None and split:
            self._clip(clip, params, plan)
            optimizer._grad_clip = None
            try:
                optimizer.step()
            finally:
                optimizer._grad_clip = clip
        else:
            optimizer.step()
        if scaler is not None:
            scaler._update()

    def _counted(self, plan, params):
        """The gradients of `params` that count on this rank, placed in
        one order of the model's parameters that every rank shares (a
        weight tied between stage 0 and the last stage counts on stage
        0 only) -> (the parameter count, their indices, the gradients,
        a function that sums [count, ...] rows over the ranks holding
        each parameter: over mp for an mp-cut one, over pp for every one
        under a pipelined plan)."""
        from .sharded_train import param_cuts, sum_over_cuts
        named = list(self._layers.named_parameters())
        cuts = param_cuts(self._layers)
        extra = {"pp"} if plan is not None else set()
        axes = [({a for _, a in cuts[n][0]} if n in cuts else set()) | extra
                for n, _ in named]
        skip = {id(p) for p in plan["tied"]} \
            if plan is not None and plan["stage"] != 0 else set()
        where = {id(p): k for k, (_, p) in enumerate(named)}
        counted = [p for p in params
                   if p.grad is not None and id(p) not in skip]
        return (len(named), [where[id(p)] for p in counted],
                [p.grad for p in counted],
                lambda rows: sum_over_cuts(rows, axes))

    def _clip(self, clip, params, plan):
        """Clip this rank's gradients by the global norm over every
        stage, or each by its own norm (`ClipGradByNorm`), the squares
        of an mp-cut tensor summed over mp and a tied weight counted
        once (`_rows`); or by value."""
        live = [p for p in params if p.grad is not None and need_clip(p)]
        if isinstance(clip, ClipGradByValue):
            for p in live:
                p.grad.clamp_(clip.min, clip.max)
            return
        if not isinstance(clip, (ClipGradByGlobalNorm, ClipGradByNorm)):
            raise NotImplementedError(
                f"PipelineParallel: grad_clip {type(clip).__name__} over a "
                "pp or mp mesh")
        dev = params[0].device
        n, idx, grads, sum_cuts = self._counted(plan, live)
        sq = torch.zeros(n, dtype=torch.float32, device=dev)
        if grads:
            norms = torch._foreach_norm(grads, 2.0, dtype=torch.float32)
            sq.index_add_(0, torch.tensor(idx, device=dev),
                          torch.stack(norms).square())
        sq = sum_cuts(sq)
        if isinstance(clip, ClipGradByGlobalNorm):
            scale = clip.clip_norm / torch.clamp(sq.sum().sqrt(),
                                                 min=clip.clip_norm)
            for p in live:
                p.grad.mul_(scale.to(p.grad.dtype))
            return
        where = {id(p): k for k, p in enumerate(self._layers.parameters())}
        for p in live:
            p.grad.copy_(clip_by_norm(p.grad, sq[where[id(p)]].sqrt(),
                                      clip.clip_norm))

    # ---- evaluation -------------------------------------------------------
    def eval_batch(self, data, compute_loss=False):
        """Forward-only micro-batched pass (reference
        `pipeline_parallel.py:170`) in eval mode: the batch loss when
        `compute_loss` (the loss of the concatenated outputs), else the
        outputs, on every rank; pipelined (GPipe) on a pp mesh with a
        plan. Draws nothing from the training generators."""
        self._layers.eval()
        if isinstance(data, (tuple, list)):
            x = data[0]
            y = data[1] if len(data) > 1 else None
        else:
            x, y = data, None
        if compute_loss and y is None:
            raise ValueError("eval_batch(compute_loss=True) needs (x, y)")
        if compute_loss and self._layers._loss_fn is None:
            raise ValueError(
                "eval_batch(compute_loss=True) requires the PipelineLayer "
                "to be built with loss_fn=...")
        n_micro = max(1, self._num_micro)
        bsz = x.shape[0]
        if bsz % n_micro != 0:
            raise ValueError(f"batch size {bsz} not divisible by "
                             f"accumulate_steps {n_micro}")
        mesh, pp = self._mesh_pp()
        plan = self._resolve_plan(pp, mesh) if pp > 1 else None
        devices = [x.device] if x.device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices), torch.no_grad():
            if plan is None:
                mb = bsz // n_micro
                out = torch.cat([self._layers(x[i * mb:(i + 1) * mb])
                                 for i in range(n_micro)])
                return self._layers._loss_fn(out, y) if compute_loss \
                    else out
            return self._eval_pipelined(plan, pp, x, y, n_micro,
                                        compute_loss)

    def _eval_pipelined(self, plan, pp, x, y, n_micro, compute_loss):
        stage = plan["stage"]
        shared = self._layers.shared_layers
        xm = _micro(x, n_micro)

        def feed(m):
            return _run_items(plan["front"], xm[m], shared)

        meta, h0 = self._act_meta(plan, xm[0], lambda: feed(0))
        ops = [("F", l, m) for m in range(n_micro)
               for l in range(plan["vpp"])]
        _, outs = _run(ops, pp, plan["vpp"], stage, n_micro, meta,
                       lambda m: h0 if m == 0 else feed(m),
                       self._chunk_fn(plan),
                       lambda out, m: (_run_items(plan["tail"], out,
                                                  shared), None),
                       train=False)
        group, _, ranks = _axis("pp")
        last = ranks[pp - 1]
        if stage == pp - 1:
            out = torch.cat([outs[m] for m in range(n_micro)])
            res = self._layers._loss_fn(out, y) if compute_loss else out
            box = [(tuple(res.shape), res.dtype)]
        else:
            box = [None]
        dist.broadcast_object_list(box, src=last, group=group)
        if stage != pp - 1:
            res = torch.empty(box[0][0], dtype=box[0][1], device=x.device)
        from .collective import _broadcast_
        return _broadcast_(res.contiguous(), last, group, axis="pp")
