"""Cross-layout checkpoint resharding — the port of
paddle_tpu/resilience/reshard.py.

A checkpoint saved under one layout (mesh sizes and ZeRO stage) restores
into a job running under another: a smaller or larger world, other
axes, another stage.

- `normalize_layout`, `layout_from_mesh`, `layouts_differ` and
  `stored_layout` are JAX's layout identity, over the port's mesh
  (`distributed.env.build_mesh`).
- `reshard_restore(ckpt_dir, step, target_layout, mesh)` restores
  through `CheckpointManager.restore` (its verification, fallback past
  corrupt checkpoints, retries and records) with the resharding loader:
  leaf by leaf through host memory, each leaf assembled whole from its
  saved pieces and cut for this rank under the live layout
  (`distributed.checkpoint.load_places(direct=False)`), so no more than
  one logical leaf is held at a time (the largest of GPT-3 1.3B is its
  412 MB embedding). Optimizer slots and each rank's RNG states come
  back as in a same-layout resume; every restore emits the JAX
  `kind=elastic` reshard_restore record with both layouts.
- `piece_spec`, `rank_coords` and `layout_pieces` are the placement
  rule as a pure function of a layout and a rank (no process group):
  what a rank of a layout writes and needs of one leaf.

The planner's layouts (`plan=`) stay with ROADMAP Queue 1 item 6.4.
"""
import json
import os

from .. import monitor
from .ckpt import CheckpointManager

__all__ = ["reshard_restore", "normalize_layout", "layout_from_mesh",
           "layouts_differ", "stored_layout", "rank_coords", "piece_spec",
           "layout_pieces"]

MESH_AXES = ("dp", "pp", "mp", "sp", "ep")


# ---------------------------------------------------------------------------
# layout identity
# ---------------------------------------------------------------------------

def normalize_layout(layout):
    """Canonical layout dict from a dict (or anything with `to_dict`), or
    None: every mesh axis (missing ones 1) and `zero_stage` when the
    source declares one."""
    if layout is None:
        return None
    if hasattr(layout, "to_dict"):
        layout = layout.to_dict()
    if not isinstance(layout, dict):
        raise TypeError(
            f"layout must be a planner Layout or an axis dict, got "
            f"{type(layout).__name__}")
    out = {}
    for a in MESH_AXES:
        v = int(layout.get(a, 1))
        if v < 1:
            raise ValueError(f"layout axis {a} size {v} < 1")
        out[a] = v
    if layout.get("zero_stage") is not None:
        out["zero_stage"] = int(layout["zero_stage"])
    return out


def layout_from_mesh(mesh):
    """The live mesh's layout dict (axes absent from the mesh are 1)."""
    if mesh is None:
        return None
    from ..distributed import env
    return {a: env.axis_size(a, mesh) for a in MESH_AXES}


def layouts_differ(a, b):
    """Do two layouts place state differently? Mesh axes always count;
    zero_stage counts only when BOTH sides declare one."""
    a, b = normalize_layout(a), normalize_layout(b)
    if a is None or b is None:
        return False
    if any(a[ax] != b[ax] for ax in MESH_AXES):
        return True
    if "zero_stage" in a and "zero_stage" in b and \
            a["zero_stage"] != b["zero_stage"]:
        return True
    return False


def stored_layout(manager, step=None):
    """The layout stamped into a committed checkpoint's RunState (the
    newest committed step by default), or None."""
    from .ckpt import RUN_STATE_NAME
    if step is None:
        step = manager.latest_step()
    if step is None:
        return None
    path = os.path.join(manager.step_dir(step), RUN_STATE_NAME)
    try:
        with open(path) as f:
            d = json.load(f)
    except (OSError, ValueError):
        return None
    layout = d.get("layout")
    return normalize_layout(layout) if layout else None


# ---------------------------------------------------------------------------
# the placement rule as a pure function
# ---------------------------------------------------------------------------

def rank_coords(layout, rank):
    """{axis: index} of global rank `rank` in `layout`'s mesh (row-major
    over dp, pp, mp, sp, ep, as distributed.env.build_mesh lays it)."""
    lay = normalize_layout(layout)
    out = {}
    for a in reversed(MESH_AXES):
        out[a] = rank % lay[a]
        rank //= lay[a]
    return out


def piece_spec(shape, tags, layout, rank, groups=1, zero=None):
    """(cut, flat, writes) of one leaf of logical `shape` for `rank` of
    `layout`: `tags` names the mesh axis of each dim ("mp", "ep" or
    None), `groups` the blocks each cut dim is cut within; `zero`
    ("save" or "load") takes the ZeRO flat range of a stage >= 1 piece
    (params and slots write their dp range; stage 3 and the slots also
    load it, stages 1-2 load their parameters whole)."""
    lay = normalize_layout(layout)
    co = rank_coords(lay, rank)
    cut = [[d, co[a], lay[a], int(groups)]
           for d, a in enumerate(tags or ()) if a is not None and lay[a] > 1]
    n = 1
    for s in shape:
        n *= int(s)
    for d, _, k, _ in cut:
        n //= k
    flat = None
    if zero is not None and lay.get("zero_stage", 0) >= 1:
        dp, k = lay["dp"], co["dp"]
        c = -(-n // dp)
        a, b = min(k * c, n), min((k + 1) * c, n)
        flat = (a, b) if (a, b) != (0, n) else None
    from ..distributed.checkpoint import holds_first
    writes = holds_first(co, [a for a in tags or () if a is not None],
                         flat is not None)
    return cut, flat, writes


def layout_pieces(full, tags, layout, groups=1, zero=True):
    """[(piece meta, tensor)] that the ranks of `layout` write of the
    logical `full` (a leaf cut by `tags`), each meta as the manifest
    keeps it (rank, cut, flat, and a `file` key naming the piece)."""
    from ..distributed.checkpoint import cut_for
    lay = normalize_layout(layout)
    world = 1
    for a in MESH_AXES:
        world *= lay[a]
    out = []
    for r in range(world):
        cut, flat, writes = piece_spec(full.shape, tags, lay, r, groups,
                                       zero="save" if zero else None)
        if not writes or (flat is not None and flat[0] == flat[1]):
            continue
        meta = {"rank": r, "cut": cut,
                "flat": None if flat is None else list(flat),
                "file": f"piece/{r}"}
        out.append((meta, cut_for(full, cut, flat)))
    return out


# ---------------------------------------------------------------------------
# the public entry
# ---------------------------------------------------------------------------

def _load_resharded(path, model, optimizer):
    """The loader `CheckpointManager.restore(loader=...)` dispatches to:
    every leaf assembled from its pieces and cut for this rank."""
    from ..distributed.checkpoint import load_checkpoint
    return load_checkpoint(path, model, optimizer, reshard=True)


def reshard_restore(ckpt_dir, step=None, target_layout=None, mesh=None,
                    model=None, optimizer=None, manager=None, rank=None,
                    sink=None, retry=None):
    """Restore a manifest checkpoint saved under ANY layout into the
    live model under `target_layout` (default the live mesh's). Returns
    the checkpoint's RunState (RNG re-seeded), or None when no
    checkpoint exists.

    ckpt_dir       CheckpointManager root (step_N subdirectories)
    step           exact step (corruption raises) or None for the
                   newest VALID checkpoint
    mesh           the live mesh (default the installed one)
    manager        reuse an existing CheckpointManager (its retries,
                   sink and rank) instead of building one

    Emits the `kind=ckpt` restore/fallback records and one `kind=elastic`
    reshard_restore record with the committed step and both layouts,
    and advances `elastic.reshard_restores`.
    """
    from ..distributed import env
    if mesh is None:
        mesh = env.current_mesh()
    target_layout = normalize_layout(target_layout) \
        if target_layout is not None else layout_from_mesh(mesh)
    mgr = manager
    owns = mgr is None
    if owns:
        mgr = CheckpointManager(ckpt_dir, model=model, optimizer=optimizer,
                                retry=retry, rank=rank, sink=sink)
    model = model if model is not None else mgr.model
    optimizer = optimizer if optimizer is not None else mgr.optimizer
    prev = env.current_mesh()
    env.set_mesh(mesh)
    try:
        rs = mgr.restore(step=step, model=model, optimizer=optimizer,
                         loader=_load_resharded)
    finally:
        env.set_mesh(prev)
        if owns:
            mgr.close()
    if rs is None:
        return None
    monitor.incr("elastic.reshard_restores")
    from ..telemetry.sink import emit_record, make_elastic_record
    rec = make_elastic_record(
        "reshard_restore", rank=mgr.rank, step=rs.step,
        layout_from=rs.layout or {"unknown": 1},
        layout_to=target_layout or {"unknown": 1})
    emit_record(rec, sink, mgr.sink if not owns else None)
    mgr.records.append(rec)
    return rs
