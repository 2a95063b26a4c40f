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
  rank only ever holds its 1/dp of the summed gradients.
The update runs on views of the parameters' own storage, in the groups of
(learning-rate scale, decay) the optimizer's `update` forms, so every
rule and option of the optimizer applies; with dp 1 the three stages
are the same arithmetic as jit.TrainStep. Stage 3, `offload=`, `plan=`,
`lint=`, `health=` and `resilience=` raise NotImplementedError naming
their ROADMAP item; `donate` is accepted and has no meaning in an eager
step.
"""
import torch

from ..nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                       ClipGradByValue, need_clip)
from ..telemetry.recorder import auto_step
from . import env
from .collective import (ReduceOp, _all_gather, _all_reduce_, _axis,
                         _reduce_scatter)

__all__ = ["shard_model", "shard_batch", "ShardedTrainStep", "param_cuts",
           "cut_piece", "join_pieces", "cut_full", "gather_full"]

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


def shard_model(model, mesh=None, rules=None):
    """Cut every tagged parameter of `model` to this rank's piece (see
    the module docstring); parameters cut before are left as they are.
    Returns the model."""
    if rules is not None:
        raise NotImplementedError(
            "shard_model(rules=): the planner's partition rules wait "
            "(ROADMAP Queue 1 item 6: the planner and cost model)")
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
    """The trainable parameters of one dtype cut for ZeRO: dp rank k
    owns piece k of every parameter's flat elements (ceil(n / dp) of
    them, the last piece shorter or empty). A "section" is one rank's
    pieces laid end to end, each padded to its full length; the flat
    gradient is the dp sections in rank order, so that chunk k of a
    reduce-scatter is rank k's section."""

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
        return self._sections([p.detach() for p in self.params])[self.rank]

    def scatter_back(self, sections):
        """Write every rank's section ([dp, section]) into the
        parameters."""
        for p, n, c, o in zip(self.params, self.numels, self.pieces,
                              self.offsets):
            p.data.view(-1).copy_(sections[:, o:o + c].reshape(-1)[:n])


class ShardedTrainStep:
    """loss_fn(*local batch) -> backward -> gradient exchange -> update,
    over the mesh (see the module docstring). `step(*global batch)`
    returns the global mean loss (a detached scalar on the rank's
    device)."""

    def __init__(self, model, loss_fn, optimizer, mesh=None, zero_stage=None,
                 seq_shard_batch=None, donate=True, offload=None,
                 lint=False, health=None, resilience=None, plan=None):
        if plan is not None:
            _unported("plan=", "the planner and cost model")
        if offload:
            _unported("offload=", "ZeRO-3, offload and checkpoint")
        if lint:
            _unported("lint=", "the planner and cost model")
        if health is not None:
            _unported("health=", "the runtime around the sharded step")
        if resilience is not None:
            _unported("resilience=", "elastic, launch restarts")
        strat = getattr(optimizer, "user_defined_strategy", None)
        scfg = (strat.sharding_configs
                if strat is not None and getattr(strat, "sharding", False)
                else {})
        if zero_stage is None:
            zero_stage = int(scfg.get("stage", 1))
        if zero_stage >= 3:
            _unported(f"zero_stage={zero_stage}",
                      "ZeRO-3, offload and checkpoint")
        if zero_stage < 0:
            raise ValueError(f"zero_stage {zero_stage}")
        self.mesh = mesh if mesh is not None else env.current_mesh()
        if self.mesh is None:
            raise ValueError("ShardedTrainStep needs a mesh "
                             "(env.build_mesh or mesh=)")
        self.zero_stage = zero_stage
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
        dp_rank = env.axis_index("dp", self.mesh)
        by_dtype = {}
        for p in self.params:
            by_dtype.setdefault(p.dtype, []).append(p)
        self._shards = [_Shards(ps, self.dp, dp_rank)
                        for ps in by_dtype.values()]
        self._index = {id(p): k for k, p in enumerate(self.params)}
        if zero_stage == 0:
            for p in self.params:
                optimizer._get_state(p)
        else:
            # this rank's views of its pieces and their states
            self._owned = []        # (shards, owned entry, param, view)
            for sh in self._shards:
                for k, a, b in sh.owned():
                    p = sh.params[k]
                    self._owned.append((sh, (k, a, b), p,
                                        p.data.view(-1)[a:b]))
            self._states = [optimizer._get_state(v)
                            for _, _, _, v in self._owned]

    # ---- the step ------------------------------------------------------
    def __call__(self, *batch):
        with auto_step() as win:
            loss = self._run_step(batch)
            win.note(loss=loss)
        return loss

    def _run_step(self, batch):
        from ..generation import release
        release(self.model)
        for p in self.params:
            p.grad = None
        prev = env.current_mesh()
        env.set_mesh(self.mesh)
        try:
            local = shard_batch(batch, self.mesh, self.seq_shard)
            loss = self.loss_fn(*local)
            loss.backward()
            if self.zero_stage == 0:
                self._update_replicated()
            else:
                self._update_sharded()
            return self._global_loss(loss.detach())
        finally:
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
        (stages 1-2) -> this rank's section of the result (stage 2 by a
        reduce-scatter)."""
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

    def _update_replicated(self):
        """Stage 0: the whole gradients, then the optimizer's update."""
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
        gl = self._clip([(k, grads[id(p)])
                         for k, p in enumerate(self.params)], sharded=False)
        self.optimizer.update(self.params, [g for _, g in gl])

    def _update_sharded(self):
        """Stages 1-2: this rank's section of the reduced gradients, the
        rule on its pieces, then the sections all-gathered over dp."""
        gpieces = {}
        for sh in self._shards:
            sec = self._reduce(sh.grads(), sh.section)
            owned = [e for s_, e, _, _ in self._owned if s_ is sh]
            for e, g in zip(owned, sh.mine(sec, owned)):
                gpieces[(id(sh), e)] = g
        items = [(self._index[id(p)], gpieces[(id(sh), e)])
                 for sh, e, p, _ in self._owned]
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
            for (scale, wd), (views, gs, sts) in groups.items():
                opt._update_group(views, gs, sts, lr * scale, wd)
            if self.dp > 1:
                dpg = _axis("dp")[0]
                for sh in self._shards:
                    parts = _all_gather(sh.my_section(), dpg, axis="dp")
                    sh.scatter_back(torch.stack(parts))

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
        cn = clip.clip_norm
        return [(k, torch.where(norms[k] > cn,
                                g * (cn / norms[k].clamp(min=1e-12)), g)
                 if live[k] else g) for k, g in items]

    def _square_sums(self, items, sharded):
        """f32 sums of squares of each parameter's whole gradient: the
        pieces' squares, summed over dp when the pieces are dp chunks,
        and over mp and ep for the parameters cut over them."""
        dev = items[0][1].device
        sq = torch.zeros(len(self.params), dtype=torch.float32, device=dev)
        norms = torch._foreach_norm([g for _, g in items], 2.0,
                                    dtype=torch.float32)
        idx = torch.tensor([k for k, _ in items], device=dev)
        sq.index_add_(0, idx, torch.stack(norms).square())
        if sharded and self.dp > 1:
            _all_reduce_(sq, ReduceOp.SUM, _axis("dp")[0], axis="dp")
        for axis in CUT_AXES:
            flags = [axis in a for a in self._cut_axes]
            if env.axis_size(axis, self.mesh) == 1 or not any(flags):
                continue
            cut = torch.tensor(flags, device=dev)
            part = torch.where(cut, sq, 0.0)
            _all_reduce_(part, ReduceOp.SUM, _axis(axis)[0], axis=axis)
            sq = torch.where(cut, part, sq)
        return sq

    # ---- readings --------------------------------------------------------
    def state_bytes(self):
        """Bytes of optimizer-state tensors this rank holds."""
        sts = self._states if self.zero_stage >= 1 else [
            self.optimizer._states[id(p)] for p in self.params]
        return sum(v.numel() * v.element_size() for st in sts
                   for v in st.values() if isinstance(v, torch.Tensor))
