"""Distributed checkpoints — the port of
paddle_tpu/distributed/checkpoint.py.

The JAX module writes an orbax tree, each host its shards, and restores
onto each live array's sharding. The port writes one `torch.save` file
a leaf piece and keeps, with every leaf, where each piece sits in the
logical array:

- A leaf is one logical array of the training state under the JAX
  package's names (its `resilience.ckpt.flatten_leaves`):
  `model.<state_dict key>` and `optimizer.<parameter name>.<slot>`.
- A piece is what one rank holds of it: the rank's mp/ep cut
  (`sharded_train.param_cuts`: for each cut dim its index, piece count
  and groups) and, under ZeRO, the flat element range of that cut piece
  the rank owns. A rank writes a piece only where it is the first rank
  holding it: index 0 on every mesh axis the leaf is not cut over (pp
  stages write their own layers).
- `state_leaves(model, optimizer)` lists this rank's `Place`s: the
  leaf's logical shape and dtype, the piece this rank writes and the
  piece it needs back, and how to read and write the live storage. A
  model driven by a `ShardedTrainStep` gets its places from the step
  (its ZeRO pieces); any other model from its parameters as they are.
- `load_places(step_dir, places, manifest, direct)` restores leaf by
  leaf through host memory. `direct` reads only the pieces of this
  rank's cut and raises `LayoutMismatch` where the checkpoint holds
  none (another mesh); otherwise each leaf is assembled whole from its
  pieces and cut again for this rank (`resilience.reshard`), so no more
  than one logical leaf is held at a time.

`save_checkpoint` / `load_checkpoint` are the JAX functions over one
self-contained directory (`arrays/` and a manifest, written through the
commit protocol of resilience/ckpt.py); `load_checkpoint` routes a
layout mismatch to the resharding loader where JAX falls back on a
sharding error, and corruption (a truncated or missing file) raises.
`TrainEpochRange` / `train_epoch_range` are the epoch-granular
auto-checkpoint, walking back past a lost or corrupt epoch checkpoint.
"""
import json
import os
import tempfile
import warnings

import numpy as np
import torch

from . import env
from .sharded_train import cut_piece, join_pieces, param_cuts

__all__ = ["save_checkpoint", "load_checkpoint", "TrainEpochRange",
           "train_epoch_range", "state_leaves", "load_places", "Place",
           "LayoutMismatch", "assemble_leaf", "cut_for", "dtype_name"]


class LayoutMismatch(RuntimeError):
    """The checkpoint holds no piece of this rank's cut of a leaf: it was
    saved under another mesh (the reshard loader takes it)."""


def dtype_name(dtype):
    """The numpy name of a torch or numpy dtype ('float32', 'bfloat16')."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(np.dtype(dtype))


def _numel(shape):
    n = 1
    for s in shape:
        n *= int(s)
    return n


class Place:
    """One logical leaf as this rank holds it.

    name       the leaf's dotted name
    shape      its logical shape; dtype its dtype (torch, or a numpy
               dtype for a host scalar)
    cut        this rank's cut: [[dim, index, n, groups], ...] ([] whole)
    save_flat  (a, b): the flat range of the cut piece this rank writes
               (None: all of it)
    load_flat  (a, b): the flat range it needs back (None: all of it)
    writes     whether this rank writes its piece
    get()      -> this rank's piece (a tensor, or the scalar)
    set(v)     writes a restored piece (load_flat's elements) back
    scalar     a host scalar (a beta power, a step count)
    """

    __slots__ = ("name", "shape", "dtype", "cut", "save_flat", "load_flat",
                 "writes", "get", "set", "scalar")

    def __init__(self, name, shape, dtype, cut, save_flat, load_flat,
                 writes, get, set, scalar=False):  # noqa: A002
        self.name = name
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.cut = [list(c) for c in cut]
        n = _numel(self.cut_shape())
        self.save_flat = _norm_flat(save_flat, n)
        self.load_flat = _norm_flat(load_flat, n)
        self.writes = bool(writes)
        self.get = get
        self.set = set
        self.scalar = bool(scalar)

    def cut_shape(self):
        return cut_shape(self.shape, self.cut)

    def meta(self):
        """The manifest's leaf entry (JAX's keys)."""
        if isinstance(self.dtype, torch.dtype):
            item = torch.empty((), dtype=self.dtype).element_size()
        else:
            item = np.dtype(self.dtype).itemsize
        return {"shape": list(self.shape), "dtype": dtype_name(self.dtype),
                "nbytes": _numel(self.shape) * item}

    def piece_meta(self, rank):
        return {"rank": int(rank), "cut": self.cut,
                "flat": None if self.save_flat is None
                else list(self.save_flat)}


def _norm_flat(flat, n):
    """(a, b) or None; a range covering the whole piece is None."""
    if flat is None:
        return None
    a, b = int(flat[0]), int(flat[1])
    if a == 0 and b == n:
        return None
    return (a, b)


def cut_shape(shape, cut):
    out = list(shape)
    for dim, _, n, _ in cut:
        out[dim] //= n
    return tuple(out)


def cut_coords(cut, mesh=None):
    """[[dim, index, n, groups], ...] of this rank's piece of a parameter
    cut as `cut` (a `param_cuts` value, or None) says."""
    if cut is None:
        return []
    dims, groups, _ = cut
    return [[int(d), env.axis_index(a, mesh), env.axis_size(a, mesh),
             int(groups)] for d, a in dims]


def holds_first(coords, cut_axes, flat):
    """Whether the rank at mesh coordinates `coords` ({axis: index})
    writes its piece of a leaf cut over `cut_axes`: index 0 on every
    other mesh axis (dp counts as cut when the piece is a ZeRO flat
    range; pp stages hold their own layers)."""
    skip = set(cut_axes) | {"pp"}
    if flat:
        skip.add("dp")
    return all(coords[a] == 0 for a in env.MESH_AXES if a not in skip)


def first_holder(cut_axes, flat, mesh=None):
    """`holds_first` for this rank under `mesh` (default the installed
    one; without a mesh, global rank 0 writes)."""
    m = mesh if mesh is not None else env.current_mesh()
    if m is None:
        return env.get_rank() == 0
    return holds_first({a: env.axis_index(a, m) for a in env.MESH_AXES},
                       cut_axes, flat)


def _copy_into(t):
    def set_(v):
        with torch.no_grad():
            t.data.copy_(v.reshape(t.shape))
    return set_


def _scalar_set(st, k):
    def set_(v):
        from ..optimizer.optimizer import host_scalar
        st[k] = host_scalar(st[k], v)
    return set_


def slot_places(pname, p_logical, p_shape, st, cut, save_flat, load_flat,
                writes, scalar_writes, mesh=None):
    """The places of one parameter's optimizer slots `st` (a state dict
    whose tensors have the shape `p_shape` of the parameter's piece, or
    not): tensor slots are cut like the parameter, host scalars are
    whole and written once."""
    out = []
    coords = cut_coords(cut, mesh)
    for k, v in st.items():
        name = f"optimizer.{pname}.{k}"
        if isinstance(v, torch.Tensor):
            shaped = tuple(v.shape) == tuple(p_shape)
            out.append(Place(
                name, p_logical if shaped else v.shape, v.dtype,
                coords if shaped else [], save_flat if shaped else None,
                load_flat if shaped else None,
                writes if shaped else env.get_rank() == 0,
                (lambda v=v: v.detach()), _copy_into(v)))
        else:
            a = np.asarray(v)
            out.append(Place(name, (), a.dtype, [], None, None,
                             scalar_writes, (lambda st=st, k=k: st[k]),
                             _scalar_set(st, k), scalar=True))
    return out


def _plain_places(model, optimizer, prime):
    mesh = env.current_mesh()
    cuts = param_cuts(model)
    # a pipeline stage's parameters (PipelineParallel sets them); the
    # other stages' copies are stale on this rank
    own = getattr(model, "_ckpt_param_ids", None)
    params = {id(p) for p in model.parameters()}
    out = []
    for key, t in model.state_dict(keep_vars=True).items():
        if own is not None and id(t) in params and id(t) not in own:
            continue
        cut = cuts.get(key)
        axes = [a for _, a in cut[0]] if cut else []
        out.append(Place(f"model.{key}", cut[2] if cut else t.shape,
                         t.dtype, cut_coords(cut, mesh), None, None,
                         first_holder(axes, False, mesh),
                         (lambda t=t: t.detach()), _copy_into(t)))
    if optimizer is not None:
        for pname, p in model.named_parameters():
            if own is not None and id(p) not in own:
                continue
            st = optimizer._get_state(p) if prime and p.requires_grad \
                else optimizer._states.get(id(p))
            if not st:
                continue
            cut = cuts.get(pname)
            axes = [a for _, a in cut[0]] if cut else []
            w = first_holder(axes, False, mesh)
            first = w and all(c[1] == 0 for c in cut_coords(cut, mesh))
            out += slot_places(pname, cut[2] if cut else p.shape, p.shape,
                               st, cut, None, None, w, first, mesh)
    return out


def state_leaves(model, optimizer=None, prime=False):
    """This rank's `Place`s of `model`'s state dict and `optimizer`'s
    slots (see the module docstring). `prime` creates the optimizer's
    slots first (a fresh process restoring before its first step)."""
    step = getattr(model, "_sharded_step", None)
    step = step() if step is not None else None
    if step is not None:
        return step._places(optimizer, prime)
    return _plain_places(model, optimizer, prime)


# ---------------------------------------------------------------------------
# reading pieces
# ---------------------------------------------------------------------------

def _load_file(step_dir, piece):
    path = os.path.join(step_dir, *piece["file"].split("/"))
    return torch.load(path, map_location="cpu", weights_only=True)


def _norm_cut(cut):
    return [list(map(int, c)) for c in (cut or [])]


def _join_flat(load, pieces, shape, want=None):
    """One cut piece of `shape` from the pieces of that cut (a whole one,
    or flat ranges laid end to end that cover it), or with `want` = (a,
    b) only those elements, reading only the pieces that hold them."""
    n = _numel(shape)
    for pc in pieces:
        if _norm_flat(pc.get("flat"), n) is None:
            t = load(pc).reshape(shape)
            return t if want is None else t.reshape(-1)[want[0]:want[1]]
    lo, hi = (0, n) if want is None else want
    parts, at = [], 0
    for pc in sorted(pieces, key=lambda pc: pc["flat"][0]):
        a, b = pc["flat"]
        if a < at:          # a duplicate holder
            continue
        if a != at:
            break
        if b > lo and a < hi:
            parts.append(load(pc).reshape(-1)[max(lo, a) - a:min(hi, b) - a])
        at = b
    if at != n:
        raise ValueError(f"pieces {[pc['file'] for pc in pieces]} cover "
                         f"{at} of {n} elements of a cut piece")
    out = torch.cat(parts)
    return out.reshape(shape) if want is None else out


def assemble_leaf(step_dir, meta, load=None):
    """The logical array of one manifest leaf entry, from its pieces
    (`load(piece)` reads one; default its file under `step_dir`)."""
    if load is None:
        def load(pc):
            return _load_file(step_dir, pc)
    shape = tuple(meta["shape"])
    pieces = meta.get("pieces") or []
    if not pieces:
        raise ValueError("leaf has no pieces")
    if not shape:
        return load(pieces[0])
    by_cut = {}
    for pc in pieces:
        by_cut.setdefault(json.dumps(_norm_cut(pc.get("cut"))),
                          []).append(pc)
    proto = json.loads(next(iter(by_cut)))
    if not proto:
        return _join_flat(load, pieces, shape)
    cshape = cut_shape(shape, proto)
    table = {tuple(c[1] for c in json.loads(k)): v
             for k, v in by_cut.items()}

    def join(level, idx):
        if level == len(proto):
            if idx not in table:
                raise ValueError(f"no piece at cut index {idx}")
            return _join_flat(load, table[idx], cshape)
        dim, _, n, groups = proto[level]
        parts = [join(level + 1, idx + (i,)) for i in range(n)]
        return join_pieces(parts, dim, groups)

    return join(0, ())


def cut_for(full, cut, flat):
    """This rank's piece of the logical `full` for the cut coordinates
    `cut` and flat range `flat` (None: the whole cut piece)."""
    for dim, idx, n, groups in cut:
        full = cut_piece(full, dim, n, idx, groups)
    if flat is not None:
        full = full.reshape(-1)[flat[0]:flat[1]]
    return full.contiguous()


def _read_place(step_dir, meta, place, direct):
    if place.scalar:
        return _load_file(step_dir, meta["pieces"][0])
    cshape = place.cut_shape()
    same = [pc for pc in meta.get("pieces") or []
            if _norm_cut(pc.get("cut")) == place.cut]
    if same:
        n = _numel(cshape)
        for pc in same:
            if _norm_flat(pc.get("flat"), n) == place.load_flat:
                return _load_file(step_dir, pc)
        return _join_flat(lambda pc: _load_file(step_dir, pc), same, cshape,
                          place.load_flat)
    if direct:
        raise LayoutMismatch(
            f"leaf {place.name}: the checkpoint holds no piece of cut "
            f"{place.cut} (saved under another mesh)")
    return cut_for(assemble_leaf(step_dir, meta), place.cut, place.load_flat)


def load_places(step_dir, places, manifest, direct=True):
    """Restore `places` from the checkpoint at `step_dir` whose manifest
    is `manifest`, leaf by leaf (see the module docstring). A model leaf
    the checkpoint lacks raises CheckpointError and a logical shape that
    differs ValueError, each naming the leaf; an optimizer slot the
    checkpoint lacks stays as it is."""
    from ..resilience.ckpt import CheckpointError
    saved = manifest.get("leaves") or {}
    missing = [p.name for p in places
               if p.name.startswith("model.") and p.name not in saved]
    if missing:
        raise CheckpointError(
            f"checkpoint at {step_dir} lacks model leaves the live model "
            f"requires: {missing[:4]}"
            + (f" (+{len(missing) - 4} more)" if len(missing) > 4 else ""))
    for place in places:
        meta = saved.get(place.name)
        if meta is None:
            continue
        want = tuple(int(s) for s in meta.get("shape", ()))
        if want != place.shape:
            raise ValueError(
                f"checkpoint shape mismatch for leaf {place.name}: saved "
                f"{want} vs live {place.shape}")
        if not place.scalar and place.load_flat is not None \
                and place.load_flat[0] == place.load_flat[1]:
            continue
        v = _read_place(step_dir, meta, place, direct)
        if isinstance(v, torch.Tensor) and isinstance(place.dtype,
                                                      torch.dtype):
            v = v.to(place.dtype)
        place.set(v if not place.scalar else np.asarray(v))


# ---------------------------------------------------------------------------
# the JAX surface
# ---------------------------------------------------------------------------

class _SaveHandle:
    """An async `save_checkpoint`: `wait_until_finished()` joins it and
    raises what it raised."""

    def __init__(self, fut):
        self._fut = fut

    def wait_until_finished(self):
        if self._fut is not None:
            fut, self._fut = self._fut, None
            fut.result()


_EXECUTOR = None


def _executor():
    # one thread for the process, as the JAX module keeps one
    # AsyncCheckpointer: saves queue on it in order
    global _EXECUTOR
    if _EXECUTOR is None:
        from concurrent.futures import ThreadPoolExecutor
        _EXECUTOR = ThreadPoolExecutor(1, thread_name_prefix="ckpt_save")
    return _EXECUTOR


def save_checkpoint(path, model, optimizer=None, step=None, async_save=True):
    """Checkpoint `model` (and `optimizer`) into the directory `path`
    (arrays/, run_state.json, manifest.json; committed by one rename of
    `path`.tmp). The leaves are copied to host memory before it returns;
    with `async_save` a background thread writes and commits them, and
    the returned handle's `wait_until_finished()` joins it. Every rank
    of a job calls it."""
    from ..resilience import ckpt
    path = os.path.abspath(path)
    snap = ckpt.snapshot(state_leaves(model, optimizer))
    rs = ckpt.RunState(step=step or 0).capture_rng()
    job = ckpt.SaveJob(path, path + ckpt.TMP_SUFFIX, snap, rs, step)
    job.prepare()
    if not async_save:
        job.run()
        return None
    return _SaveHandle(_executor().submit(job.run))


def _arrays_parent(path):
    path = os.path.abspath(path)
    if os.path.basename(path) == "arrays":
        return os.path.dirname(path)
    return path


def load_checkpoint(path, model, optimizer=None, reshard=False):
    """Restore `model` (and `optimizer`'s slots) in place from a
    checkpoint directory (a step directory or its `arrays/`). Each rank
    reads the pieces of its own cut; where the checkpoint was saved
    under another mesh (`LayoutMismatch`), or with `reshard`, the leaves
    are assembled and cut again for this rank (resilience.reshard's
    loader). Corruption (an unreadable, truncated or missing piece)
    raises. Returns the manifest."""
    from ..resilience.ckpt import load_manifest
    step_dir = _arrays_parent(path)
    manifest = load_manifest(step_dir)
    places = state_leaves(model, optimizer, prime=True)
    if not reshard:
        try:
            load_places(step_dir, places, manifest, direct=True)
            return manifest
        except LayoutMismatch:
            pass
    load_places(step_dir, places, manifest, direct=False)
    return manifest


class TrainEpochRange:
    """Epoch-granular auto-checkpoint/resume bookkeeping (reference
    `fluid/incubate/checkpoint/auto_checkpoint.py`): a directory keyed
    by the job id (PADDLE_JOB_ID or `name`), a JSON status of the last
    completed epoch beside one checkpoint a saved epoch, and a generator
    that skips the completed epochs after a restart, restoring the
    model and optimizer from the newest epoch checkpoint that verifies.
    """

    def __init__(self, max_epoch_num, name=None, checkpoint_dir=None,
                 model=None, optimizer=None, save_interval=1):
        self.max_epoch_num = int(max_epoch_num)
        self.name = name or os.environ.get("PADDLE_JOB_ID", "job_default")
        root = checkpoint_dir or os.environ.get(
            "PADDLE_CHECKPOINT_DIR", os.path.join(
                tempfile.gettempdir(), "paddle_tpu_auto_checkpoint"))
        self.dir = os.path.join(root, self.name)
        os.makedirs(self.dir, exist_ok=True)
        self.model = model
        self.optimizer = optimizer
        self.save_interval = int(save_interval)
        self._status_path = os.path.join(self.dir, "status.json")
        self.restored_from = None
        if os.path.exists(self._status_path):
            with open(self._status_path) as f:
                self._status = json.load(f)
        else:
            self._status = {"epoch_no": -1}
        self._pending = None

    @property
    def epoch_no(self):
        return self._status["epoch_no"]

    def _commit_status(self, epoch):
        """Durably record `epoch` as completed, once its checkpoint is
        committed: a crash before resumes from the previous epoch."""
        from ..resilience.ckpt import _atomic_write_json
        self._status = {"epoch_no": epoch}
        if env.get_rank() == 0:
            _atomic_write_json(self._status_path, self._status)

    def _drain_pending(self):
        if self._pending is not None:
            handle, epoch = self._pending
            self._pending = None
            handle.wait_until_finished()
            self._commit_status(epoch)

    def _save(self, epoch):
        # at most one async save in flight
        self._drain_pending()
        if self.model is not None:
            ckpt_dir = os.path.join(self.dir, f"epoch_{epoch}")
            h = save_checkpoint(ckpt_dir, self.model, self.optimizer,
                                step=epoch, async_save=True)
            if h is not None:
                self._pending = (h, epoch)
                return
        self._commit_status(epoch)

    def _epoch_checkpoint_valid(self, epoch):
        from ..resilience.ckpt import MANIFEST_NAME, verify_checkpoint
        path = os.path.join(self.dir, f"epoch_{epoch}")
        if not os.path.exists(os.path.join(path, MANIFEST_NAME)):
            return False
        return not verify_checkpoint(path)

    def __iter__(self):
        start = self.epoch_no + 1
        if start > 0 and self.model is not None:
            # the status names the newest committed epoch, but its
            # checkpoint may be lost or corrupt since: walk back to the
            # newest one that verifies
            restored = None
            for e in range(self.epoch_no, -1, -1):
                if self._epoch_checkpoint_valid(e):
                    ck = os.path.join(self.dir, f"epoch_{e}")
                    load_checkpoint(ck, self.model, self.optimizer)
                    self.restored_from = ck
                    restored = e
                    break
                if e == self.epoch_no or os.path.isdir(
                        os.path.join(self.dir, f"epoch_{e}")):
                    warnings.warn(
                        f"auto-checkpoint: epoch_{e} checkpoint is missing "
                        "or invalid; walking back to the previous "
                        "committed epoch", RuntimeWarning, stacklevel=2)
            if restored is None:
                warnings.warn(
                    "auto-checkpoint: no valid epoch checkpoint found; "
                    "restarting from epoch 0 with current weights",
                    RuntimeWarning, stacklevel=2)
                self._status = {"epoch_no": -1}
                start = 0
            elif restored != self.epoch_no:
                self._status = {"epoch_no": restored}
                start = restored + 1
        try:
            for epoch in range(start, self.max_epoch_num):
                yield epoch
                if (epoch + 1) % self.save_interval == 0 or \
                        epoch == self.max_epoch_num - 1:
                    self._save(epoch)
        finally:
            # also on GeneratorExit: the in-flight save still lands
            self._drain_pending()


def train_epoch_range(max_epoch_num, save_checkpoint_inter=1, **kwargs):
    """`acp.train_epoch_range` analog (reference
    `auto_checkpoint.py:train_epoch_range`)."""
    return TrainEpochRange(max_epoch_num,
                           save_interval=save_checkpoint_inter, **kwargs)
