"""The hybrid-parallel training step — the port of
paddle_tpu/distributed/sharded_train.py.

The JAX step is one pjit over the global mesh: GSPMD places the
parameters by their `mesh_axes` tags, shards the batch over (dp, sp)
and inserts every collective. The port runs a process a rank and does
each of those by hand:

- `shard_model` cuts each parameter tagged in its module's `mesh_axes`
  (local name -> (axes, groups)) to this rank's piece along every dim
  tagged "mp" or "ep" whose axis is above 1: a contiguous 1/n, or, with
  groups g, the rank's 1/n of each of g equal blocks (the fused qkv's
  q | k | v thirds are cut by heads). An expert weight is cut twice,
  its expert dim over ep and its f dim over mp. The counterpart of
  `device_put` with a NamedSharding; every rank builds the same full
  model (the same seed) and cuts its own.
- `shard_batch` cuts the global batch each rank is given to its rows
  (dim 0 over dp) and, with `seq_axis`, its sequence block (dim 1 over
  sp); a dim that does not divide raises (the JAX rule replicates it,
  which here would count those rows twice).
- `ShardedTrainStep` runs the model's loss on the rank's piece under
  the mesh (`env.set_mesh`) — the model shards its activations and
  places the tensor-, sequence- and expert-parallel collectives itself
  (models/gpt.py, mp_layers.py, ops/ring_attention.py, moe/layer.py) —
  backpropagates, and then, on flat gradient buffers (one a dtype):
  sums them over sp and averages them over dp (the loss is each rank's
  share of the global token mean, `models.gpt._mesh_mean`; the ranks of
  an ep group hold the same rows and each keeps the whole share, so no
  gradient is reduced over ep here: the MoE layer sums its gate's
  gradient over ep itself, and the experts' gradients arrive whole);
  clips (`ClipGradByGlobalNorm` and `ClipGradByNorm` count each cut
  parameter's squares over the axes it is cut over and each replicated
  one once; `ClipGradByValue` is elementwise); and applies the
  optimizer's rule. The reported loss is the global mean (the shares
  summed over sp and dp, over dp). ep with sp or pp above 1 raises
  NotImplementedError (ROADMAP Queue 1 item 6.6).

ZeRO (`zero_stage`, default the fleet strategy's `sharding_configs
["stage"]` when `strategy.sharding` is on, else 1, as in JAX):
- 0: every rank keeps the optimizer states of its whole (mp- and
  ep-cut) parameters and updates them (the rule's `update`, as
  jit.TrainStep);
- 1: dp rank k owns the k-th 1/dp of every parameter's elements, keeps
  the states of only those (1/dp of stage 0's bytes) and updates them
  from the all-reduced gradients; the pieces are then all-gathered over
  dp into every rank's parameters;
- 2: as 1, but the gradients are reduce-scattered over dp, so each
  rank only ever holds its 1/dp of the summed gradients;
- 3: as 2, and between steps a rank keeps only its pieces of the
  parameters too (`_Shards.own`; the parameters' storage is freed,
  `untyped_storage().resize_(0)`). The gather unit is one child of the
  model's `blocks` ModuleList (a GPTBlock); the rest of the trainable
  parameters (the embeddings, the final LayerNorm, the tied head) are
  one unit, gathered from the step's start to its backward's end. A
  block's parameters are all-gathered over dp before its forward and
  freed after it, gathered again when the gradient of its output
  arrives, and once its last parameter's gradient has accumulated
  (`register_post_accumulate_grad_hook`) its gradients are
  reduce-scattered into this rank's sections and freed with the
  parameters. Under remat (`config.remat`: each block run by
  `recompute`) the block's rerun in the backward finds the unit
  gathered by its output's gradient and keeps it so through the
  block's backward, so a block is still gathered twice a step. The
  update on the pieces is stage 2's, so the two give the same
  numbers. `gathered()` makes every parameter whole for reading the
  model outside a step (`convert.gather_params` uses it).
The update runs on views of the parameters' own storage (stage 3: of
the pieces), in the groups of (learning-rate scale, decay) the
optimizer's `update` forms, so every rule and option of the optimizer
applies; with dp 1 the stages are the same arithmetic as
jit.TrainStep.

`offload=True` (any stage; default the strategy's
`sharding_configs["offload"]`) keeps the states of the update's
operands (the whole parameters at stage 0, the pieces at stages 1-3) in
pinned host memory between steps: copied in on a side stream before the
update and back after it, under the `sharded.offload_h2d` and
`sharded.offload_d2h` spans (`_Offload`); the numbers are those of the
same stage without it.

`optimizer.state_dict()` under the step returns every logical slot
under the JAX key "<param name>_<slot>" as a `SlotPiece` (this rank's
piece and its cut and range), and `set_state_dict` takes those or whole
logical slots. A checkpoint (`resilience=`, distributed/checkpoint.py)
writes each rank's pieces and restores them onto the live layout, so a
ZeRO-3 resume comes back sharded. `resilience=` calls the manager's
`step_boundary` after each step and stamps the step's layout (mesh and
stage) into its checkpoints. `health=` arms the monitor of
`jit.TrainStep`: on a fetch step the taps read the raw gradient pieces
before the clip and the parameter pieces before and after the update,
and `sum_over_cuts` (the clip's rule) makes the stats global.

`plan=` (a `planner.Plan`, or anything with `.layout` and `.rules`)
checks the mesh against the plan's layout before it touches the model
(a mismatch raises and leaves no tag behind), takes `zero_stage` and
`seq_shard_batch` from the layout unless they are given, and tags the
model from the plan's partition rules (existing tags win; JAX's order).
`lint=` (True, or "strict" to raise on an error finding) runs the first
step under the program lint (`analysis.program_lint`: the step is
executed, not traced as in JAX) and the sharding lint over the mesh and
the modules' tags, and keeps the findings in `lint_findings`. `donate`
is accepted and has no meaning in an eager step.
"""
import contextlib
import weakref

import torch

from ..nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                       ClipGradByValue, clip_by_norm, need_clip)
from ..telemetry.health import (as_monitor, health_rows,
                                sharded_health_stats)
from ..telemetry.recorder import auto_step, span
from . import env
from .collective import (ReduceOp, _all_gather, _all_reduce_, _axis,
                         _reduce_scatter)
from .recompute import recomputing

__all__ = ["shard_model", "shard_batch", "ShardedTrainStep", "param_cuts",
           "cut_piece", "join_pieces", "cut_full", "gather_full",
           "sum_over_cuts"]

# the mesh axes a parameter may be cut over
CUT_AXES = ("mp", "ep")


# ---------------------------------------------------------------------------
# parameter cuts
# ---------------------------------------------------------------------------

def _tags(model):
    """[(full name, module, local name, axes, groups)] of every tagged
    parameter of `model`."""
    out = []
    for prefix, mod in model.named_modules():
        for local, (axes, groups) in getattr(mod, "mesh_axes", {}).items():
            full = f"{prefix}.{local}" if prefix else local
            out.append((full, mod, local, tuple(axes), int(groups)))
    return out


def _cut_dims(name, axes, shape, mesh):
    """((dim, axis), ...) of the dims tagged with a mesh axis of size
    > 1, in dim order (empty when none)."""
    dims = tuple((i, a) for i, a in enumerate(axes[:len(shape)])
                 if a is not None and env.axis_size(a, mesh) > 1)
    bad = [a for _, a in dims if a not in CUT_AXES]
    if bad or len({a for _, a in dims}) < len(dims):
        raise NotImplementedError(
            f"parameter {name!r}: tag {axes}: only cuts over "
            f"{' and '.join(CUT_AXES)}, each axis once, are ported")
    return dims


def cut_piece(full, dim, n, idx, groups=1):
    """Piece `idx` of `n` of `full` along `dim` (each of `groups` equal
    blocks cut alike)."""
    if full.shape[dim] % (n * groups):
        raise ValueError(f"dim {dim} of {tuple(full.shape)} does not divide "
                         f"into {groups} x {n} pieces")
    blocks = full.chunk(groups, dim=dim)
    return torch.cat([b.chunk(n, dim=dim)[idx] for b in blocks], dim=dim)


def join_pieces(pieces, dim, groups=1):
    """The inverse of `cut_piece` over all its pieces, in index order."""
    blocks = [torch.cat([p.chunk(groups, dim=dim)[g] for p in pieces],
                        dim=dim) for g in range(groups)]
    return torch.cat(blocks, dim=dim)


def param_cuts(model):
    """{full name: (((dim, axis), ...), groups, full shape)} of the
    parameters `shard_model` cut."""
    out = {}
    for full, mod, local, _, groups in _tags(model):
        cut = getattr(mod, "_mesh_cut", {}).get(local)
        if cut is not None:
            out[full] = cut
    return out


def cut_full(full, cut, mesh=None):
    """This rank's piece of the full tensor `full` of a parameter cut as
    `cut` (a `param_cuts` value) says."""
    dims, groups, _ = cut
    for dim, axis in dims:
        full = cut_piece(full, dim, env.axis_size(axis, mesh),
                         env.axis_index(axis, mesh), groups)
    return full


def gather_full(piece, cut):
    """The full tensor from this rank's piece of a parameter cut as `cut`
    says: all-gathered over each axis it is cut over and joined (a
    collective over those axes of the installed mesh)."""
    dims, groups, _ = cut
    for dim, axis in reversed(dims):
        piece = join_pieces(_all_gather(piece.contiguous(), _axis(axis)[0],
                                        axis=axis), dim, groups)
    return piece


def sum_over_cuts(rows, cut_axes, mesh=None, dp_pieces=False):
    """Per-parameter sums of this rank's pieces -> whole-parameter sums,
    by collectives over the installed mesh: `rows` [n params, ...] f32
    (a row a parameter), `cut_axes[i]` the mesh axes parameter i's value
    is split over (its `param_cuts` axes; a pipeline adds "pp" for a
    parameter that one stage holds). A row is summed over dp when the
    rows are of ZeRO's dp pieces (`dp_pieces`), then over each axis of
    its set; a replicated parameter's row stays as it is, so it counts
    once. The one rule of the sharded clips (`ShardedTrainStep`,
    `PipelineParallel`) and of the sharded health taps."""
    if dp_pieces and env.axis_size("dp", mesh) > 1:
        _all_reduce_(rows, ReduceOp.SUM, _axis("dp")[0], axis="dp")
    for axis in CUT_AXES + ("pp",):
        flags = [axis in a for a in cut_axes]
        if env.axis_size(axis, mesh) == 1 or not any(flags):
            continue
        cut = torch.tensor(flags, device=rows.device).reshape(
            (-1,) + (1,) * (rows.dim() - 1))
        part = torch.where(cut, rows, 0.0)
        _all_reduce_(part, ReduceOp.SUM, _axis(axis)[0], axis=axis)
        rows = torch.where(cut, part, rows)
    return rows


def shard_model(model, mesh=None, rules=None):
    """Cut every tagged parameter of `model` to this rank's piece (see
    the module docstring); parameters cut before are left as they are.
    `rules` (the planner's regex partition rules) tag the model first
    (`planner.rules.apply_partition_rules`: existing tags win). Returns
    the model."""
    if rules is not None:
        from ..planner.rules import apply_partition_rules
        apply_partition_rules(model, rules)
    mesh = mesh if mesh is not None else env.current_mesh()
    if mesh is None:
        return model
    with torch.no_grad():
        for full, mod, local, axes, groups in _tags(model):
            cuts = mod.__dict__.setdefault("_mesh_cut", {})
            try:
                p = mod.get_parameter(local)
            except AttributeError:
                p = None
            if p is None or local in cuts:
                continue
            dims = _cut_dims(full, axes, p.shape, mesh)
            if not dims:
                continue
            cut = (dims, groups, tuple(p.shape))
            p.data = cut_full(p.data, cut, mesh).contiguous()
            cuts[local] = cut
    return model


def shard_batch(batch, mesh=None, seq_axis=False):
    """This rank's piece of each global batch tensor: dim 0 over dp,
    and with `seq_axis` dim 1 over sp (a 1-D tensor only over dp)."""
    mesh = mesh if mesh is not None else env.current_mesh()
    out = []
    for b in batch:
        t = b if isinstance(b, torch.Tensor) else torch.as_tensor(b)
        for dim, axis in ((0, "dp"), (1, "sp")):
            if dim == 1 and (not seq_axis or t.dim() < 2):
                continue
            n = env.axis_size(axis, mesh)
            if n == 1:
                continue
            if t.shape[dim] % n:
                raise ValueError(
                    f"shard_batch: dim {dim} of {tuple(t.shape)} does not "
                    f"divide by the '{axis}' mesh size {n}")
            t = t.chunk(n, dim=dim)[env.axis_index(axis, mesh)]
        out.append(t.contiguous())
    return out


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def _unported(what, item):
    raise NotImplementedError(f"ShardedTrainStep({what}) is not ported: "
                              f"ROADMAP Queue 1 item 6 ({item})")


class _Shards:
    """The trainable parameters of one dtype (of one gather unit under
    ZeRO-3) cut for ZeRO: dp rank k owns piece k of every parameter's
    flat elements (ceil(n / dp) of them, the last piece shorter or
    empty). A "section" is one rank's pieces laid end to end, each padded
    to its full length; the flat gradient is the dp sections in rank
    order, so that chunk k of a reduce-scatter is rank k's section.
    Under ZeRO-3 `own` holds this rank's pieces end to end (the only
    copy of the parameters between steps) and `views` its piece of each
    parameter, in `owned()`'s order."""

    def __init__(self, params, dp, dp_rank):
        self.params = params
        self.dp, self.rank = dp, dp_rank
        self.numels = [p.numel() for p in params]
        self.pieces = [-(-n // dp) for n in self.numels]
        self.offsets = []
        off = 0
        for c in self.pieces:
            self.offsets.append(off)
            off += c
        self.section = off
        self.own = None
        self.views = []

    def owned(self):
        """[(param index, a, b)]: the elements [a, b) of the parameter's
        flat view this rank owns."""
        out = []
        for k, (n, c) in enumerate(zip(self.numels, self.pieces)):
            a, b = self.rank * c, min((self.rank + 1) * c, n)
            if a < b:
                out.append((k, a, b))
        return out

    def _sections(self, flats):
        """[dp, section] from one flat tensor a parameter."""
        cols = []
        for t, n, c in zip(flats, self.numels, self.pieces):
            t = t.reshape(-1)
            if c * self.dp > n:
                t = torch.cat([t, t.new_zeros(c * self.dp - n)])
            cols.append(t.view(self.dp, c))
        return torch.cat(cols, dim=1)

    def grads(self):
        """The flat gradient: dp sections (zeros for a parameter without
        a gradient)."""
        return self._sections([p.grad if p.grad is not None
                               else torch.zeros_like(p)
                               for p in self.params]).reshape(-1)

    def mine(self, section, owned):
        """This rank's pieces (views) of `section` ([section] elements),
        in `owned`'s order."""
        return [section[self.offsets[k]:self.offsets[k] + (b - a)]
                for k, a, b in owned]

    def my_section(self):
        """This rank's current pieces of the parameters as one section."""
        if self.own is not None:
            sec = self.own.new_zeros(self.section)
            for (k, a, b), v in zip(self.owned(), self.views):
                sec[self.offsets[k]:self.offsets[k] + (b - a)].copy_(v)
            return sec
        return self._sections([p.detach() for p in self.params])[self.rank]

    def scatter_back(self, sections):
        """Write every rank's section ([dp, section]) into the
        parameters."""
        for p, n, c, o in zip(self.params, self.numels, self.pieces,
                              self.offsets):
            p.data.view(-1).copy_(sections[:, o:o + c].reshape(-1)[:n])

    def keep_own(self):
        """ZeRO-3: copy this rank's pieces out of the parameters into
        `own` (allocated on the first call)."""
        owned = self.owned()
        if self.own is None:
            p0 = self.params[0]
            self.own = torch.empty(sum(b - a for _, a, b in owned),
                                   dtype=p0.dtype, device=p0.device)
            off = 0
            for _, a, b in owned:
                self.views.append(self.own[off:off + b - a])
                off += b - a
        with torch.no_grad():
            for (k, a, b), v in zip(owned, self.views):
                v.copy_(self.params[k].data.view(-1)[a:b])


class _Unit:
    """ZeRO-3's gather unit: a module's trainable parameters (one
    GPTBlock), or the rest of the model's (`module` None)."""

    def __init__(self, module, shards):
        self.module = module
        self.shards = shards
        self.params = [p for sh in shards for p in sh.params]
        self.gathered = True        # as built: every parameter whole
        self.pending = 0


def _free(p):
    p.data.untyped_storage().resize_(0)


def _grad_hook(step, k):
    """The post-accumulate-grad hook of a parameter of `step`'s unit k.
    The tensor keeps it on the C++ side, where the collector cannot see
    it: a hook that held the step (or the unit, which holds the
    parameter) would close a cycle the collector never frees, and every
    ZeRO-3 step would keep its model, pieces and states for the life of
    the process. So it holds the step weakly and the unit by index."""
    ref = weakref.ref(step)

    def hook(p):
        s = ref()
        if s is not None:
            s._grad_ready(s._units[k])
    return hook


def _materialize(p):
    st = p.data.untyped_storage()
    need = p.numel() * p.element_size()
    if st.nbytes() < need:
        st.resize_(need)


class _Offload:
    """The optimizer states of the update's operands kept in pinned host
    memory between steps: `to_device()` copies them in on a side stream
    before the update (the dicts then hold the device copies), and
    `to_host()` copies them back on that stream after it (the dicts hold
    the pinned buffers again; read them on the host only after
    `torch.cuda.synchronize()`). On the CPU the states stay where they
    are and both are no-ops."""

    def __init__(self, states, device):
        self.cuda = device.type == "cuda"
        self.device = device
        self.slots = []             # (state dict, key, host tensor)
        for st in states:
            for k, v in st.items():
                if not isinstance(v, torch.Tensor):
                    continue
                if self.cuda:
                    h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    h.copy_(v)
                    st[k] = h
                self.slots.append((st, k, st[k]))
        self.nbytes = sum(h.numel() * h.element_size()
                          for _, _, h in self.slots)
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self._events = None

    def to_device(self):
        if not self.cuda:
            return
        cur = torch.cuda.current_stream(self.device)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            ev[0].record(self.stream)
            devs = [h.to(self.device, non_blocking=True)
                    for _, _, h in self.slots]
            ev[1].record(self.stream)
        cur.wait_stream(self.stream)
        for (st, k, _), d in zip(self.slots, devs):
            d.record_stream(cur)
            st[k] = d
        self._events = ev

    def to_host(self):
        if not self.cuda:
            return
        cur = torch.cuda.current_stream(self.device)
        ev = self._events
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            ev[2].record(self.stream)
            for st, k, h in self.slots:
                h.copy_(st[k], non_blocking=True)
            ev[3].record(self.stream)
        for st, k, h in self.slots:
            st[k] = h

    def last_ms(self):
        """(h2d ms, d2h ms) of the last step's copies (synchronises on
        them), or None."""
        if self._events is None:
            return None
        ev = self._events
        ev[3].synchronize()
        return ev[0].elapsed_time(ev[1]), ev[2].elapsed_time(ev[3])


class SlotPiece:
    """One logical optimizer slot as this rank holds it (an entry of the
    sharded step's `optimizer.state_dict()`): `value` this rank's piece
    (a tensor, a host scalar, or an empty tensor where the rank owns no
    element), `shape` the slot's logical shape, `cut` the rank's mp/ep
    cut ([[dim, index, n, groups], ...]), `flat` its ZeRO element range
    of that cut piece (None: all of it), `rank` the global rank — the
    piece metadata a checkpoint's manifest keeps."""

    __slots__ = ("value", "shape", "cut", "flat", "rank")

    def __init__(self, value, shape, cut, flat, rank):
        self.value, self.shape, self.cut = value, tuple(shape), cut
        self.flat, self.rank = flat, rank

    def __repr__(self):
        return (f"SlotPiece(shape={self.shape}, cut={self.cut}, "
                f"flat={self.flat}, rank={self.rank})")


class ShardedTrainStep:
    """loss_fn(*local batch) -> backward -> gradient exchange -> update,
    over the mesh (see the module docstring). `step(*global batch)`
    returns the global mean loss (a detached scalar on the rank's
    device)."""

    def __init__(self, model, loss_fn, optimizer, mesh=None, zero_stage=None,
                 seq_shard_batch=None, donate=True, offload=None,
                 lint=False, health=None, resilience=None, plan=None):
        self.plan = plan
        if plan is not None:
            # validate the mesh BEFORE touching the model: a rejected
            # plan must not leave its tags behind
            m = mesh if mesh is not None else env.current_mesh()
            if m is not None:
                have = {a: env.axis_size(a, m) for a in env.MESH_AXES}
                bad = {a: (s, have[a]) for a, s in
                       plan.layout.mesh_shape().items() if have[a] != s}
                if bad:
                    raise ValueError(
                        f"mesh does not match the plan's layout "
                        f"{plan.layout.describe()}: axis sizes differ on "
                        f"{bad} — build the mesh with plan.build_mesh() "
                        "or pass the matching mesh")
            if zero_stage is None:
                zero_stage = int(plan.layout.zero_stage)
            if seq_shard_batch is None:
                seq_shard_batch = plan.layout.sp > 1
            from ..planner.rules import apply_partition_rules
            apply_partition_rules(model, plan.rules)
        self._lint = lint
        self.lint_findings = None
        strat = getattr(optimizer, "user_defined_strategy", None)
        scfg = (strat.sharding_configs
                if strat is not None and getattr(strat, "sharding", False)
                else {})
        if zero_stage is None:
            zero_stage = int(scfg.get("stage", 1))
        if offload is None:
            offload = bool(scfg.get("offload", False))
        if not 0 <= zero_stage <= 3:
            raise ValueError(f"zero_stage {zero_stage}")
        self.mesh = mesh if mesh is not None else env.current_mesh()
        if self.mesh is None:
            raise ValueError("ShardedTrainStep needs a mesh "
                             "(env.build_mesh or mesh=)")
        self.zero_stage = zero_stage
        self.offload = bool(offload)
        self.dp = env.axis_size("dp", self.mesh)
        self.sp = env.axis_size("sp", self.mesh)
        self.mp = env.axis_size("mp", self.mesh)
        self.ep = env.axis_size("ep", self.mesh)
        if self.ep > 1 and (self.sp > 1 or env.axis_size("pp", self.mesh) > 1):
            _unported("an ep axis with sp or pp above 1",
                      "6.6: ep x sp and ep x pp")
        if seq_shard_batch is None:
            seq_shard_batch = self.sp > 1
        if self.sp > 1 and not seq_shard_batch:
            raise ValueError(
                "ShardedTrainStep: an sp axis above 1 needs the batch cut "
                "along the sequence (seq_shard_batch=True): the port shards "
                "its activations explicitly")
        self.seq_shard = seq_shard_batch
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        shard_model(model, self.mesh)
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        optimizer._bind_names(named)
        self.param_names = [n for n, _ in named]
        self.params = [p for _, p in named]
        cuts = param_cuts(model)
        # the axes each parameter is cut over (its squares sum over them)
        self._cut_axes = [{a for _, a in cuts[n][0]} if n in cuts else set()
                          for n in self.param_names]
        self._index = {id(p): k for k, p in enumerate(self.params)}
        self._units = []
        self._gsec = {}
        self._in_step = False
        if zero_stage == 3:
            self._shards = self._build_units()
        else:
            self._shards = self._by_dtype(self.params)
        if zero_stage == 0:
            for p in self.params:
                optimizer._get_state(p)
            op_states = [optimizer._states[id(p)] for p in self.params]
        else:
            # this rank's views of its pieces and their states
            self._owned = []        # (shards, owned entry, param, view)
            for sh in self._shards:
                if zero_stage == 3:
                    sh.keep_own()
                for i, (k, a, b) in enumerate(sh.owned()):
                    p = sh.params[k]
                    view = sh.views[i] if zero_stage == 3 \
                        else p.data.view(-1)[a:b]
                    self._owned.append((sh, (k, a, b), p, view))
            self._states = [optimizer._get_state(v)
                            for _, _, _, v in self._owned]
            op_states = self._states
            if zero_stage == 3:
                for u in self._units:
                    self._free_unit(u)
        dev = self.params[0].device if self.params else torch.device("cpu")
        self._offload = _Offload(op_states, dev) if self.offload else None
        # the model's checkpoint places and the optimizer's state dict
        # come from this step (distributed/checkpoint.py)
        model._sharded_step = weakref.ref(self)
        optimizer._sharded_view = weakref.ref(self)
        self.health = as_monitor(health)
        self._last_health = None
        self.tap_bytes = 0      # the last fetch step's pre-update copy
        from ..resilience.preempt import as_resilience
        self.resilience = as_resilience(resilience)
        if self.resilience is not None:
            self.resilience.attach(model, optimizer, layout=self.layout())

    def layout(self):
        """This step's layout (mesh axis sizes and ZeRO stage)."""
        out = {a: env.axis_size(a, self.mesh) for a in env.MESH_AXES}
        out["zero_stage"] = self.zero_stage
        return out

    def _by_dtype(self, params):
        dp_rank = env.axis_index("dp", self.mesh)
        by_dtype = {}
        for p in params:
            by_dtype.setdefault(p.dtype, []).append(p)
        return [_Shards(ps, self.dp, dp_rank) for ps in by_dtype.values()]

    # ---- ZeRO-3 ----------------------------------------------------------
    def _build_units(self):
        """Gather units: each child of the model's `blocks` ModuleList
        (GPT, GPT-MoE), and the rest of the trainable parameters (the
        embeddings, the final LayerNorm and the tied head), which stay
        gathered from the step's start to its backward's end. The
        parameters get storage of their own, freed between uses."""
        blocks = None
        for name, mod in self.model.named_modules():
            if isinstance(mod, torch.nn.ModuleList) and \
                    name.rsplit(".", 1)[-1] == "blocks":
                blocks = mod
                break
        with torch.no_grad():
            for p in self.params:
                p.data = p.data.clone()
        taken = set()
        shards = []
        for mod in (blocks if blocks is not None else ()):
            ids = {id(p) for p in mod.parameters()}
            ps = [p for p in self.params if id(p) in ids]
            if not ps:
                continue
            taken |= ids
            u = _Unit(mod, self._by_dtype(ps))
            mod.register_forward_pre_hook(
                lambda m, args, u=u: self._gather_unit(u))
            mod.register_forward_hook(
                lambda m, args, out, u=u: self._after_forward(u, out))
            for p in ps:
                p.register_post_accumulate_grad_hook(
                    _grad_hook(self, len(self._units)))
            self._units.append(u)
            shards += u.shards
        rest = [p for p in self.params if id(p) not in taken]
        if rest:
            u = _Unit(None, self._by_dtype(rest))
            self._units.append(u)
            shards += u.shards
        return shards

    def _gather_unit(self, u):
        """All-gather a unit's parameters over dp into their storage."""
        if u.gathered:
            return
        with torch.no_grad():
            for sh in u.shards:
                sec = sh.my_section()
                parts = _all_gather(sec, _axis("dp")[0], axis="dp") \
                    if self.dp > 1 else [sec]
                for p in sh.params:
                    _materialize(p)
                sh.scatter_back(torch.stack(parts))
        u.gathered = True

    def _free_unit(self, u):
        for p in u.params:
            _free(p)
        u.gathered = False

    def _after_forward(self, u, out):
        if recomputing():
            # the backward's rerun of a remat block: the gather that the
            # output's gradient made serves the rerun and the backward;
            # the unit is freed once its gradients are reduced
            return
        self._free_unit(u)
        if torch.is_grad_enabled() and isinstance(out, torch.Tensor) \
                and out.requires_grad:
            def regather(g, u=u):
                self._gather_unit(u)
            out.register_hook(regather)

    def _grad_ready(self, u):
        if not self._in_step:
            return
        u.pending -= 1
        if u.pending == 0:
            self._reduce_unit(u)

    def _reduce_unit(self, u):
        """A unit's gradients complete: reduce-scatter them into this
        rank's sections, then free them and the parameters."""
        with torch.no_grad():
            for sh in u.shards:
                self._gsec[id(sh)] = self._reduce(sh.grads(), sh.section)
        for p in u.params:
            p.grad = None
        self._free_unit(u)

    @contextlib.contextmanager
    def gathered(self, write_back=False):
        """Every parameter whole (this rank's mp/ep piece) inside the
        block, for reading the model outside a step (under ZeRO-3 a
        collective over dp: every rank enters it); with `write_back`,
        this rank's pieces are taken back from the parameters at the
        end (after loading values into them). Other stages: a no-op."""
        if self.zero_stage != 3:
            yield self
            return
        prev = env.current_mesh()
        env.set_mesh(self.mesh)
        try:
            for u in self._units:
                self._gather_unit(u)
            yield self
            if write_back:
                for sh in self._shards:
                    sh.keep_own()
        finally:
            for u in self._units:
                self._free_unit(u)
            env.set_mesh(prev)

    # ---- the step ------------------------------------------------------
    def __call__(self, *batch):
        if self._lint and self.lint_findings is None:
            return self._linted_call(batch)
        return self._call(batch)

    def _linted_call(self, batch):
        """The first step under the program lint, then the sharding lint
        over the mesh and the tags (`lint=`); -> the step's loss."""
        from ..analysis import emit
        from ..analysis.program_lint import (lint_record, record_step,
                                             train_step_state)
        from ..analysis.sharding_lint import (lint_model_sharding,
                                              mesh_axis_sizes)
        loss, rec = record_step(self._call, batch,
                                state=lambda: train_step_state(self),
                                fn_name="ShardedTrainStep")
        findings = lint_record(rec, mesh_axis_sizes(self.mesh))
        findings += lint_model_sharding(self.model, self.mesh,
                                        zero_stage=self.zero_stage)
        self.lint_findings = emit(findings, mode=self._lint,
                                  title="graph doctor [ShardedTrainStep]")
        return loss

    def _call(self, batch):
        with auto_step() as win:
            if self.health is not None:
                with self.health.guard(win) as g:
                    loss = self._run_step(batch, self.health.will_fetch())
                    g.stage(self._last_health)
            else:
                loss = self._run_step(batch, False)
            win.note(loss=loss)
        if self.resilience is not None:
            self.resilience.step_boundary(loss=loss)
        return loss

    def _run_step(self, batch, taps):
        from ..generation import release
        release(self.model)
        for p in self.params:
            p.grad = None
        prev = env.current_mesh()
        env.set_mesh(self.mesh)
        try:
            local = shard_batch(batch, self.mesh, self.seq_shard)
            if self.zero_stage == 3:
                self._gsec = {}
                for u in self._units:
                    u.pending = len(u.params) if u.module is not None else -1
                self._in_step = True
                for u in self._units:
                    if u.module is None:
                        self._gather_unit(u)
            loss = self.loss_fn(*local)
            loss.backward()
            if self.zero_stage == 3:
                self._in_step = False
                for u in self._units:
                    if u.pending != 0:
                        self._reduce_unit(u)
            self._last_health = None
            rows = self._update_replicated(taps) if self.zero_stage == 0 \
                else self._update_sharded(taps)
            loss = self._global_loss(loss.detach())
            if taps:
                self._last_health = sharded_health_stats(
                    loss, rows, lambda r: sum_over_cuts(
                        r, self._cut_axes, self.mesh, self.zero_stage > 0))
            return loss
        finally:
            self._in_step = False
            if self.zero_stage == 3:
                for u in self._units:
                    if u.gathered:
                        self._free_unit(u)
            env.set_mesh(prev)

    def _global_loss(self, share):
        rep = share.float().clone()
        if self.sp > 1:
            _all_reduce_(rep, ReduceOp.SUM, _axis("sp")[0], axis="sp")
        if self.dp > 1:
            _all_reduce_(rep, ReduceOp.SUM, _axis("dp")[0], axis="dp")
            rep /= self.dp
        return rep

    def _reduce(self, flat_grad, section=None):
        """Sum over sp and average over dp, in place; with `section`
        (stages 1-3) -> this rank's section of the result (stages 2-3 by
        a reduce-scatter)."""
        if self.sp > 1:
            _all_reduce_(flat_grad, ReduceOp.SUM, _axis("sp")[0], axis="sp")
        if self.dp > 1:
            dpg = _axis("dp")[0]
            if section is not None and self.zero_stage >= 2:
                return _reduce_scatter(list(flat_grad.chunk(self.dp)), dpg,
                                       axis="dp").div_(self.dp)
            _all_reduce_(flat_grad, ReduceOp.SUM, dpg, axis="dp")
            flat_grad.div_(self.dp)
        if section is None:
            return flat_grad
        return flat_grad.view(self.dp, section)[
            env.axis_index("dp", self.mesh)]

    @contextlib.contextmanager
    def _states_on_device(self):
        """The update's states on the device (offload: copied in before,
        back to pinned host memory after, under the
        sharded.offload_h2d / sharded.offload_d2h spans)."""
        if self._offload is None:
            yield
            return
        with span("sharded.offload_h2d", cat="h2d",
                  bytes=self._offload.nbytes):
            self._offload.to_device()
        try:
            yield
        finally:
            with span("sharded.offload_d2h", cat="d2h",
                      bytes=self._offload.nbytes):
                self._offload.to_host()

    def _update_replicated(self, taps):
        """Stage 0: the whole gradients, then the optimizer's update; with
        `taps`, -> the health taps' rows (`health_rows`) of the whole
        parameters (else None)."""
        grads = {}
        for sh in self._shards:
            if self.sp == 1 and self.dp == 1:
                for p in sh.params:
                    grads[id(p)] = p.grad if p.grad is not None \
                        else torch.zeros_like(p)
                continue
            g = self._reduce(torch.cat([
                (p.grad if p.grad is not None else torch.zeros_like(p))
                .reshape(-1) for p in sh.params]))
            o = 0
            for p, n in zip(sh.params, sh.numels):
                grads[id(p)] = g[o:o + n].view(p.shape)
                o += n
        gl = [(k, grads[id(p)]) for k, p in enumerate(self.params)]
        tap = self._tap(gl, [p.detach() for p in self.params]) \
            if taps else None
        gl = self._clip(gl, sharded=False)
        with self._states_on_device():
            self.optimizer.update(self.params, [g for _, g in gl])
        return None if tap is None else tap()

    def _update_sharded(self, taps):
        """Stages 1-3: this rank's section of the reduced gradients
        (ZeRO-3's were reduce-scattered in the backward, a unit at a
        time), the rule on its pieces, then (stages 1-2) the sections
        all-gathered over dp into the parameters; with `taps`, -> the
        health taps' rows of this rank's pieces (else None)."""
        gpieces = {}
        for sh in self._shards:
            sec = self._gsec.pop(id(sh)) if self.zero_stage == 3 \
                else self._reduce(sh.grads(), sh.section)
            owned = [e for s_, e, _, _ in self._owned if s_ is sh]
            for e, g in zip(owned, sh.mine(sec, owned)):
                gpieces[(id(sh), e)] = g
        items = [(self._index[id(p)], gpieces[(id(sh), e)])
                 for sh, e, p, _ in self._owned]
        tap = self._tap(items, [v for _, _, _, v in self._owned]) \
            if taps else None
        items = self._clip(items, sharded=True)
        opt = self.optimizer
        groups = {}
        for (sh, e, p, view), st, (_, g) in zip(self._owned, self._states,
                                                items):
            key = (opt._param_lr(p), opt._effective_decay(p))
            lists = groups.setdefault(key, ([], [], []))
            for lst, x in zip(lists, (view, g, st)):
                lst.append(x)
        lr = opt.get_lr()
        with torch.no_grad():
            with self._states_on_device():
                for (scale, wd), (views, gs, sts) in groups.items():
                    opt._update_group(views, gs, sts, lr * scale, wd)
            if self.dp > 1 and self.zero_stage < 3:
                dpg = _axis("dp")[0]
                for sh in self._shards:
                    parts = _all_gather(sh.my_section(), dpg, axis="dp")
                    sh.scatter_back(torch.stack(parts))
        return None if tap is None else tap()

    def _tap(self, items, values):
        """The health taps of [(param index, raw grad piece)] before the
        clip, and a copy of the parameters' `values` (the same pieces)
        before the update: -> a function that, after the update, gives
        the rows `sharded_health_stats` sums."""
        with torch.no_grad():
            idx = [k for k, _ in items]
            rows = health_rows(len(self.params), idx,
                               grads=[g for _, g in items])
            old = [v.detach().clone() for v in values]
        self.tap_bytes = sum(t.numel() * t.element_size() for t in old)

        def after():
            with torch.no_grad():
                return rows + health_rows(len(self.params), idx,
                                          new_vals=list(values),
                                          param_vals=old)
        return after

    # ---- clipping --------------------------------------------------------
    def _clip(self, items, sharded):
        """Apply the optimizer's grad_clip to [(param index, grad piece)]:
        the pieces cover each parameter once on this rank (its whole
        gradient, or with `sharded` this rank's dp chunk of it)."""
        clip = self.optimizer._grad_clip
        if clip is None or not items:
            return items
        if isinstance(clip, ClipGradByValue):
            return [(k, g.clamp(clip.min, clip.max)
                     if need_clip(self.params[k]) else g) for k, g in items]
        if not isinstance(clip, (ClipGradByGlobalNorm, ClipGradByNorm)):
            raise NotImplementedError(
                f"ShardedTrainStep: grad_clip {type(clip).__name__}")
        sq = self._square_sums(items, sharded)
        live = torch.tensor([need_clip(p) for p in self.params],
                            device=sq.device)
        if isinstance(clip, ClipGradByGlobalNorm):
            norm = torch.where(live, sq, 0.0).sum().sqrt()
            scale = clip.clip_norm / torch.clamp(norm, min=clip.clip_norm)
            return [(k, g * scale.to(g.dtype) if live[k] else g)
                    for k, g in items]
        norms = sq.sqrt()
        return [(k, clip_by_norm(g, norms[k], clip.clip_norm)
                 if live[k] else g) for k, g in items]

    def _square_sums(self, items, sharded):
        """f32 sums of squares of each parameter's whole gradient: the
        pieces' squares, summed by `sum_over_cuts` (over dp when the
        pieces are dp chunks, and over mp and ep for the parameters cut
        over them)."""
        dev = items[0][1].device
        sq = torch.zeros(len(self.params), dtype=torch.float32, device=dev)
        norms = torch._foreach_norm([g for _, g in items], 2.0,
                                    dtype=torch.float32)
        idx = torch.tensor([k for k, _ in items], device=dev)
        sq.index_add_(0, idx, torch.stack(norms).square())
        return sum_over_cuts(sq, self._cut_axes, self.mesh, sharded)

    # ---- checkpoint places and the optimizer's view ---------------------
    def _places(self, optimizer, prime=False):
        """This rank's checkpoint places (distributed/checkpoint.py) of
        the model's state dict and `optimizer`'s slots: at stage 0 each
        whole (mp/ep-cut) piece, at stages 1-3 the ZeRO piece this rank
        owns (a parameter comes back whole at stages 1-2)."""
        from .checkpoint import (Place, _copy_into, cut_coords,
                                 first_holder, slot_places)
        mesh = self.mesh
        cuts = param_cuts(self.model)
        owned = {}
        if self.zero_stage >= 1:
            for (sh, (k, a, b), p, view), st in zip(self._owned,
                                                     self._states):
                owned[id(p)] = (a, b, view, st)
        rank = env.axis_index("dp", mesh)
        places = []
        for key, t in self.model.state_dict(keep_vars=True).items():
            cut = cuts.get(key)
            axes = [a for _, a in cut[0]] if cut else []
            coords = cut_coords(cut, mesh)
            logical = cut[2] if cut else t.shape
            if id(t) not in self._index or self.zero_stage == 0:
                places.append(Place(
                    f"model.{key}", logical, t.dtype, coords, None, None,
                    first_holder(axes, False, mesh),
                    (lambda t=t: t.detach()), _copy_into(t)))
                continue
            n = t.numel()
            a, b, view, _ = owned.get(id(t), (min(rank * -(-n // self.dp),
                                                  n),) * 2 + (None, None))
            if self.zero_stage == 3:
                get = (lambda v=view: v)
                set_ = _copy_into(view) if view is not None \
                    else (lambda v: None)
                load = (a, b)
            else:
                get = (lambda t=t, a=a, b=b: t.detach().reshape(-1)[a:b])
                set_, load = _copy_into(t), None
            places.append(Place(f"model.{key}", logical, t.dtype, coords,
                                (a, b), load, first_holder(axes, True, mesh),
                                get, set_))
        if optimizer is None:
            return places
        for name, p in zip(self.param_names, self.params):
            cut = cuts.get(name)
            axes = [a for _, a in cut[0]] if cut else []
            logical = cut[2] if cut else p.shape
            if self.zero_stage == 0:
                w = first_holder(axes, False, mesh)
                first = w and all(c[1] == 0 for c in cut_coords(cut, mesh))
                places += slot_places(name, logical, p.shape,
                                      optimizer._states[id(p)], cut, None,
                                      None, w, first, mesh)
                continue
            ent = owned.get(id(p))
            w = first_holder(axes, True, mesh)
            if ent is None:
                n = p.numel()
                a = min(rank * -(-n // self.dp), n)
                st = self._empty_slots(p)
                places += slot_places(name, logical, (0,), st, cut,
                                      (a, a), (a, a), False, False, mesh)
                continue
            a, b, view, st = ent
            first = w and a == 0 and all(
                c[1] == 0 for c in cut_coords(cut, mesh))
            places += slot_places(name, logical, view.shape, st, cut,
                                  (a, b), (a, b), w, first, mesh)
        return places

    def _empty_slots(self, p):
        """A state dict of `p`'s slot names over no elements (a rank that
        owns none of `p`)."""
        st = self.optimizer._init_state(p.new_empty(0))
        if self.optimizer._multi_precision and p.dtype in (torch.bfloat16,
                                                           torch.float16):
            st["master"] = p.new_empty(0, dtype=torch.float32)
        return st

    def optimizer_state_dict(self):
        """What `optimizer.state_dict()` returns under this step: every
        logical slot under the JAX key "<param name>_<slot>", each a
        `SlotPiece` (this rank's piece with its piece metadata), and the
        scheduler's state under "LR_Scheduler". Under offload the pieces
        are the pinned host buffers (read them after
        `torch.cuda.synchronize()`)."""
        from ..optimizer.lr import LRScheduler
        out = {}
        opt = self.optimizer
        if isinstance(opt._learning_rate, LRScheduler):
            out["LR_Scheduler"] = opt._learning_rate.state_dict()
        rank = env.get_rank()
        for pl in self._places(opt):
            if not pl.name.startswith("optimizer."):
                continue
            pname, slot = pl.name[len("optimizer."):].rsplit(".", 1)
            out[f"{pname}_{slot}"] = SlotPiece(
                pl.get(), pl.shape, pl.cut, pl.load_flat, rank)
        return out

    def set_optimizer_state_dict(self, state_dict):
        """Load what `optimizer_state_dict()` gave (pieces of this
        layout), or whole logical slots (tensors or arrays of the slot's
        logical shape, cut here to this rank's piece), or host scalars."""
        import numpy as np
        from ..optimizer.lr import LRScheduler
        from .checkpoint import cut_for
        opt = self.optimizer
        if "LR_Scheduler" in state_dict and isinstance(opt._learning_rate,
                                                       LRScheduler):
            opt._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        for pl in self._places(opt):
            if not pl.name.startswith("optimizer."):
                continue
            pname, slot = pl.name[len("optimizer."):].rsplit(".", 1)
            v = state_dict.get(f"{pname}_{slot}")
            if v is None:
                continue
            if isinstance(v, SlotPiece):
                if (v.cut, v.flat) != (pl.cut, pl.load_flat):
                    raise ValueError(
                        f"{pname}_{slot}: a piece of cut {v.cut} range "
                        f"{v.flat}, this rank holds cut {pl.cut} range "
                        f"{pl.load_flat}")
                v = v.value
            elif not pl.scalar:
                t = v if isinstance(v, torch.Tensor) else \
                    torch.from_numpy(np.asarray(v))
                if tuple(t.shape) != pl.shape:
                    raise ValueError(f"{pname}_{slot}: shape "
                                     f"{tuple(t.shape)} != {pl.shape}")
                v = cut_for(t, pl.cut, pl.load_flat)
            if pl.scalar:
                pl.set(np.asarray(v))
            elif pl.load_flat is None or pl.load_flat[0] < pl.load_flat[1]:
                pl.set(v.to(pl.dtype))

    # ---- readings --------------------------------------------------------
    def state_bytes(self):
        """Bytes of optimizer-state tensors this rank holds (wherever
        they are)."""
        sts = self._states if self.zero_stage >= 1 else [
            self.optimizer._states[id(p)] for p in self.params]
        return sum(v.numel() * v.element_size() for st in sts
                   for v in st.values() if isinstance(v, torch.Tensor))

    def memory(self):
        """This rank's bytes, between steps: `param_storage` (the
        trainable parameters' own storage: 0 under ZeRO-3), `owned` (the
        ZeRO-3 pieces), `state` (the optimizer's state tensors),
        `state_device` and `state_pinned` (where they are)."""
        sts = self._states if self.zero_stage >= 1 else [
            self.optimizer._states[id(p)] for p in self.params]
        tens = [v for st in sts for v in st.values()
                if isinstance(v, torch.Tensor)]
        nb = [v.numel() * v.element_size() for v in tens]
        return {
            "param_storage": sum(p.data.untyped_storage().nbytes()
                                 for p in self.params),
            "owned": sum(sh.own.numel() * sh.own.element_size()
                         for sh in self._shards if sh.own is not None),
            "state": sum(nb),
            "state_device": sum(n for n, v in zip(nb, tens)
                                if v.device.type != "cpu"),
            "state_pinned": sum(n for n, v in zip(nb, tens)
                                if v.device.type == "cpu" and v.is_pinned()),
        }

    def offload_ms(self):
        """(h2d ms, d2h ms) of the last step's offload copies on the
        card, or None."""
        return None if self._offload is None else self._offload.last_ms()
