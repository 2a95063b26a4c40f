"""`paddle.distributed.utils` — the expert-parallel exchange API, the
port of paddle_tpu/distributed/dist_utils.py:33-92 (reference
`python/paddle/distributed/utils.py:56` global_scatter and `:123`
global_gather, over `operators/collective/global_scatter_op.cc`).

The JAX package keeps the count-driven API for its global-array regime
(one array holds every rank's tokens, and the exchange is a row
permutation) because XLA has no all-to-all of data-dependent sizes. The
port runs a process a rank, so the exchange is the reference's own: an
uneven all-to-all (`all_to_all_single` with split sizes) of this rank's
rows, then the received rows put in expert-major order. With a group of
one rank it is the JAX permutation (the identity).

Layout (the reference's): `local_count[r * ne + e]` rows of `x`, in
that index order, go to expert e of rank r (ne experts a rank);
`global_count[r * ne + e]` rows arrive from rank r for this rank's
expert e, and the result holds, for each local expert e, the rows from
rank 0, 1, ... in turn. `global_gather` is the inverse exchange. Both
are differentiable (each one's backward is the other).

The launch helpers of the JAX module (Hdfs, Cluster, Pod, Trainer,
TrainerProc, start/watch/terminate_local_procs, ...) are not ported:
ROADMAP Queue 1 item 6.5.
"""
import numpy as np
import torch

from . import env
from .collective import Group, _AllToAllUneven, _axis

__all__ = ["global_scatter", "global_gather"]


def _counts(c):
    """The counts as a flat int64 ndarray (a tensor, list or array)."""
    if isinstance(c, torch.Tensor):
        c = c.detach().cpu().numpy()
    return np.asarray(c, np.int64).ravel()


def _group_size(group):
    if group is None:
        return env.get_world_size()
    if isinstance(group, str):
        return env.axis_size(group)
    return getattr(group, "nranks", 1)


def _pg(group):
    """The process group of `group`: a Group, a mesh axis name, or None
    (every rank)."""
    if isinstance(group, Group):
        return group.pg
    if isinstance(group, str):
        return _axis(group)[0]
    return group


def _exchange_perm(gc, world):
    """Rows received rank-major (rank r's rows for experts 0..ne-1 in
    turn) -> the expert-major order: for each expert e, rank 0, 1, ..."""
    if gc.size % world:
        raise ValueError(f"count length {gc.size} not divisible by world "
                         f"{world}")
    ne = gc.size // world
    starts = np.concatenate([[0], np.cumsum(gc)[:-1]]).astype(np.int64)
    order = []
    for e in range(ne):
        for r in range(world):
            b = r * ne + e
            order.extend(range(starts[b], starts[b] + gc[b]))
    return np.asarray(order, np.int64)


def _plan(x, local_count, global_count, group):
    lc, gc = _counts(local_count), _counts(global_count)
    world = _group_size(group)
    if lc.sum() != x.shape[0]:
        raise ValueError(
            f"local_count sums to {lc.sum()} but x has {x.shape[0]} rows")
    if lc.size != gc.size:
        raise ValueError("local_count/global_count length mismatch")
    if lc.size % world:
        raise ValueError(f"count length {lc.size} not divisible by world "
                         f"{world}")
    send = lc.reshape(world, -1).sum(axis=1).tolist()
    recv = gc.reshape(world, -1).sum(axis=1).tolist()
    perm = torch.from_numpy(_exchange_perm(gc, world)).to(x.device)
    return world, send, recv, perm


def global_scatter(x, local_count, global_count, group=None,
                   use_calc_stream=True):
    """Send this rank's bucketed rows to their experts' ranks; -> the
    rows received, expert-major (see the module docstring). `group`: a
    `Group`, a mesh axis name (e.g. "ep"), or None for every rank."""
    world, send, recv, perm = _plan(x, local_count, global_count, group)
    got = x if world == 1 else _AllToAllUneven.apply(
        x.contiguous(), _pg(group), None, send, recv)
    return got[perm]


def global_gather(x, local_count, global_count, group=None,
                  use_calc_stream=True):
    """The inverse exchange: x holds the expert-major rows
    `global_scatter` returned (or results of the same layout); -> the
    rows back at their senders, in local_count order.
    global_gather(global_scatter(x, lc, gc), lc, gc) == x."""
    lc = _counts(local_count)
    if _counts(global_count).sum() != x.shape[0]:
        raise ValueError(f"global_count sums to "
                         f"{_counts(global_count).sum()} but x has "
                         f"{x.shape[0]} rows")
    world, send, recv, perm = _plan(
        x.new_empty((int(lc.sum()),) + tuple(x.shape[1:])), local_count,
        global_count, group)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.numel(), device=perm.device)
    back = x[inv]
    if world == 1:
        return back
    return _AllToAllUneven.apply(back.contiguous(), _pg(group), None, recv,
                                 send)
