"""Collective communication — the port of paddle_tpu/distributed/collective.py.

The JAX package has two regimes: global-view calls on one controller,
and the `*_axis` lax primitives inside `shard_map`. The port runs a
process a rank, so both regimes are message passing over
`torch.distributed`:

1. The eager API (reference `distributed/collective.py`: Group:79,
   new_group:209, all_reduce:415, broadcast:348, all_gather:589,
   alltoall:1395, send/recv, barrier): in-place calls on this rank's
   tensors over a `Group` (default: every rank).
2. The axis layer: `psum`, `pmean`, `pmax`, `all_gather_axis`,
   `reduce_scatter_axis`, `ppermute` and `all_to_all_axis` over the
   process group of a mesh axis (`env.axis_group`), each a
   `torch.autograd.Function` whose backward is the adjoint collective
   (psum's is psum, all_gather's reduce_scatter, ppermute's the inverse
   permutation, all_to_all's the swapped all_to_all, the uneven
   all_to_all's the exchange back). Beside them the reference's two
   tensor-parallel operators, `c_identity` (identity forward, all-reduce
   backward) and `mp_allreduce` (all-reduce forward, identity backward),
   which `mp_layers` builds on, and the pair for a tensor whose ranks
   hold the same rows and each count the whole loss (the expert-parallel
   token blocks, `moe/layer.py`): `split_axis` (this rank's chunk
   forward, the chunks' gradients all-gathered backward) and
   `gather_axis` (all-gather forward, this rank's chunk of the gradient
   backward). An axis of size 1 makes every one of them the identity,
   without a call.

Every collective runs under the deadline machinery: with a deadline
armed (`set_collective_deadline` / `collective_deadline`) the backend's
wait is bounded by it and raises `CollectiveTimeoutError`; with none,
the wait is the backend's own (gloo's ends at the process group's
timeout). A killed peer closes its sockets, so gloo fails such a wait
at once ("Connection closed by peer") where an XLA collective on a pod
hangs until the deadline: under an armed deadline that lost-peer error
is the same event and raises the same CollectiveTimeoutError (with
`peer_lost_after_s`, the seconds it waited). `elastic.collective_timeouts`
counts both: waits past the deadline and peers lost before it. Every one
opens a telemetry span `collective.<name>` of cat "collective" that
carries the payload's `bytes` (the tensor handed to the collective),
`shape` and `axis`/`axis_size`, which the step recorder sums into a
step record's `collectives`, `comm_ms` and `comm_frac`; `comm_stats()`
keeps the same bytes and calls by name for a run without a recorder.

Transport. Under NCCL every tensor stays on its card. Under gloo (the
caller's choice, `env.init_distributed`), a CUDA tensor of a collective
that gloo cannot carry (outside `GLOO_CUDA_NATIVE`: point-to-point) is
copied into pinned host memory, exchanged there and copied back; the
staged bytes (both directions) are counted by name in `comm_stats()
["staged_bytes"]`. A collective that fails raises; nothing retries.
"""
import contextlib
import copy
import datetime
import threading
import time

import torch
import torch.distributed as dist

from .. import monitor
from ..analysis import collective_order as _co
from ..telemetry.recorder import span as _span
from . import env

__all__ = ["CollectiveTimeoutError", "set_collective_deadline",
           "collective_deadline", "guarded_wait", "comm_stats",
           "reset_comm_stats", "ReduceOp", "Group", "new_group",
           "get_group", "is_initialized", "get_world_size", "get_rank",
           "barrier", "wait", "all_reduce", "broadcast", "reduce",
           "all_gather", "all_gather_object", "scatter", "alltoall", "send",
           "recv", "psum", "pmean", "pmax", "all_gather_axis",
           "reduce_scatter_axis", "ppermute", "all_to_all_axis",
           "c_identity", "mp_allreduce", "split_axis", "gather_axis",
           "all_to_all_uneven", "exchange", "split", "GLOO_CUDA_NATIVE"]


# ---------------------------------------------------------------------------
# the deadline guard
# ---------------------------------------------------------------------------

class CollectiveTimeoutError(RuntimeError):
    """A collective did not complete within the armed deadline: a peer
    is dead or wedged. `transient = True`, as in the JAX package, for
    the elastic relaunch path."""

    transient = True

    def __init__(self, op, deadline_s, axis=None, shape=None,
                 peer_lost_after_s=None):
        self.op = op
        self.deadline_s = float(deadline_s)
        self.axis = axis
        self.peer_lost_after_s = peer_lost_after_s
        tag = f" over axis {axis!r}" if axis else ""
        tag += f" payload {shape}" if shape is not None else ""
        if peer_lost_after_s is None:
            what = (f"did not complete within {deadline_s:.1f}s — a peer "
                    "is dead or wedged")
        else:
            what = (f"lost its peer after {peer_lost_after_s:.1f}s of its "
                    f"{deadline_s:.1f}s deadline — the backend saw the "
                    "connection close")
        super().__init__(f"collective {op!r}{tag} {what}; escalating to "
                         "the elastic relaunch path")


_DEADLINE_S = [None]


def set_collective_deadline(seconds):
    """Arm (or with None, disarm) the process-wide collective deadline.
    Returns the previous value."""
    prev = _DEADLINE_S[0]
    _DEADLINE_S[0] = float(seconds) if seconds is not None else None
    return prev


@contextlib.contextmanager
def collective_deadline(seconds):
    """`with collective_deadline(30): train()` — every collective wait
    inside raises CollectiveTimeoutError instead of hanging past it."""
    prev = set_collective_deadline(seconds)
    try:
        yield
    finally:
        set_collective_deadline(prev)


# the words of a backend whose peer closed the connection mid-collective
# (gloo's tcp pair fails at once where XLA's collective hangs)
_PEER_LOST = ("closed by peer", "reset by peer")


def _peer_lost(exc):
    text = str(exc).lower()
    return any(w in text for w in _PEER_LOST)


def guarded_wait(name, work, axis_name=None, deadline_s=None, shape=None):
    """Wait for an issued collective (`work`, a torch.distributed Work).
    No deadline armed: the backend's wait. Armed: the backend's wait
    bounded by `deadline_s` (default the armed deadline); past it,
    CollectiveTimeoutError (the abandoned work cannot be cancelled, so
    the process is expected to exit). A backend error that says the peer
    closed the connection before the deadline is the same dead peer seen
    sooner: CollectiveTimeoutError too, with `peer_lost_after_s` set.
    Both count in `elastic.collective_timeouts`. Any other error before
    the deadline is the backend's own."""
    if work is None:
        return
    deadline = deadline_s if deadline_s is not None else _DEADLINE_S[0]
    if deadline is None:
        work.wait()
        return
    t0 = time.monotonic()
    try:
        work.wait(timeout=datetime.timedelta(seconds=deadline))
    except Exception as e:      # noqa: BLE001 — classified below
        waited = time.monotonic() - t0
        early = waited < deadline
        if early and not _peer_lost(e):
            raise
        monitor.incr("elastic.collective_timeouts")
        raise CollectiveTimeoutError(
            name, deadline, axis=axis_name, shape=shape,
            peer_lost_after_s=waited if early else None) from e


# ---------------------------------------------------------------------------
# telemetry: spans and counts
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_STATS = {"bytes": {}, "calls": {}, "staged_bytes": {}}


def comm_stats():
    """{"bytes": {name: payload bytes}, "calls": {name: n},
    "staged_bytes": {name: bytes copied to and from pinned host memory}}
    since the last `reset_comm_stats()`."""
    with _LOCK:
        return copy.deepcopy(_STATS)


def reset_comm_stats():
    with _LOCK:
        for d in _STATS.values():
            d.clear()


def _count(kind, name, n):
    with _LOCK:
        _STATS[kind][name] = _STATS[kind].get(name, 0) + int(n)


def _nbytes(t):
    return t.numel() * t.element_size()


# the observers of every collective (analysis/program_lint's recorder):
# each is called as obs(event, name, axis, group size, tensor), event
# "span" when a collective opens its span and "result" with the output
# of a reduce-scatter
_OBSERVERS = []


def _observe(event, name, axis, group, tensor):
    if event == "span" and _co._ACTIVE is not None:
        _co.note(name, axis, None if tensor is None else tuple(tensor.shape),
                 None if tensor is None else tensor.dtype)
    if _OBSERVERS:
        size = dist.get_world_size(_pg(group)) if dist.is_initialized() \
            else 1
        for obs in list(_OBSERVERS):
            obs(event, name, axis, size, tensor)


def _comm_span(name, tensor=None, axis_name=None, nbytes=None, staged=False,
               group=None, like=None):
    """The span every collective opens (see the module docstring), and
    the `comm.<name>` monitor counter; it notes the collective to an open
    `analysis.collective_order` capture and to the observers (`like`
    stands for the payload where `tensor` is not given)."""
    monitor.incr(f"comm.{name}")
    if _co._ACTIVE is not None or _OBSERVERS:
        _observe("span", name, axis_name, group,
                 tensor if tensor is not None else like)
    attrs = {}
    if axis_name is not None:
        attrs["axis"] = str(axis_name)
        attrs["axis_size"] = env.axis_size(axis_name)
    if tensor is not None:
        attrs["shape"] = str(tuple(tensor.shape))
        if nbytes is None:
            nbytes = _nbytes(tensor)
    if nbytes is not None:
        attrs["bytes"] = int(nbytes)
        _count("bytes", name, nbytes)
    if staged:
        attrs["staged"] = True
    _count("calls", name, 1)
    return _span(f"collective.{name}", cat="collective", **attrs)


# ---------------------------------------------------------------------------
# transport: pinned-host staging of CUDA tensors under gloo
# ---------------------------------------------------------------------------

# the collectives gloo carries over CUDA tensors itself, with the right
# values (probed under torch 2.11 on the card: chip_smoke.py's
# distributed phase runs and prints the probe, tools/dist_drill.py's
# gloo_probe job); point-to-point is staged: gloo hands the CUDA
# pointer to the socket and the process aborts
GLOO_CUDA_NATIVE = frozenset({"all_reduce", "broadcast", "reduce",
                              "all_gather", "reduce_scatter", "all_to_all",
                              "all_to_all_uneven"})


def _pg(group):
    return group.pg if isinstance(group, Group) else group


def _staged(op, tensors, group):
    """Whether collective `op` (a GLOO_PROBES name) over `tensors` goes
    through pinned host memory: CUDA tensors under gloo, `op` not one
    gloo carries itself."""
    return (any(t.is_cuda for t in tensors)
            and dist.get_backend(_pg(group)) == "gloo"
            and op not in GLOO_CUDA_NATIVE)


def _to_host(name, tensors):
    """Pinned host copies of CUDA `tensors`, complete on return."""
    hosts = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        _count("staged_bytes", name, _nbytes(t))
        hosts.append(h)
    if tensors:
        torch.cuda.current_stream(tensors[0].device).synchronize()
    return hosts


def _host_empty(like):
    return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)


def _to_dev(name, host, dev):
    """Copy `host` (pinned) into the CUDA tensor `dev`, ordered on the
    current stream; the host allocator keeps `host` until it is done."""
    dev.copy_(host, non_blocking=True)
    _count("staged_bytes", name, _nbytes(dev))
    return dev


# ---------------------------------------------------------------------------
# raw collectives over a process group (no autograd)
# ---------------------------------------------------------------------------

class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
              "min": dist.ReduceOp.MIN, "prod": dist.ReduceOp.PRODUCT}


def _shape(t):
    return tuple(t.shape) if t is not None else None


def _all_reduce_(t, op, group, name="all_reduce", axis=None):
    """In-place reduction of `t` over `group` (op a ReduceOp value)."""
    avg = op == ReduceOp.AVG
    top = _TORCH_OPS["sum" if avg else op]
    stage = _staged("all_reduce", [t], group)
    with _comm_span(name, t, axis, staged=stage, group=group):
        buf = _to_host(name, [t])[0] if stage else t
        work = dist.all_reduce(buf, op=top, group=_pg(group), async_op=True)
        guarded_wait(name, work, axis, shape=_shape(t))
        if stage:
            _to_dev(name, buf, t)
    if avg:
        t.div_(dist.get_world_size(_pg(group)))
    return t


def _broadcast_(t, src, group, name="broadcast", axis=None):
    stage = _staged("broadcast", [t], group)
    with _comm_span(name, t, axis, staged=stage, group=group):
        buf = _to_host(name, [t])[0] if stage else t
        work = dist.broadcast(buf, src, group=_pg(group), async_op=True)
        guarded_wait(name, work, axis, shape=_shape(t))
        if stage:
            _to_dev(name, buf, t)
    return t


def _reduce_(t, dst, op, group, name="reduce", axis=None):
    stage = _staged("reduce", [t], group)
    with _comm_span(name, t, axis, staged=stage, group=group):
        buf = _to_host(name, [t])[0] if stage else t
        work = dist.reduce(buf, dst, op=_TORCH_OPS[op], group=_pg(group),
                           async_op=True)
        guarded_wait(name, work, axis, shape=_shape(t))
        if stage:
            _to_dev(name, buf, t)
    return t


def _all_gather(t, group, name="all_gather", axis=None):
    """-> [every rank's `t`] in group order."""
    t = t.contiguous()
    n = dist.get_world_size(_pg(group))
    stage = _staged("all_gather", [t], group)
    with _comm_span(name, t, axis, staged=stage, group=group):
        src = _to_host(name, [t])[0] if stage else t
        outs = [_host_empty(t) if stage else torch.empty_like(t)
                for _ in range(n)]
        work = dist.all_gather(outs, src, group=_pg(group), async_op=True)
        guarded_wait(name, work, axis, shape=_shape(t))
        if stage:
            outs = [_to_dev(name, o, torch.empty_like(t)) for o in outs]
    return outs


def _reduce_scatter(chunks, group, name="reduce_scatter", axis=None):
    """Sum `chunks` (one a rank, equal shapes) over `group`; -> this
    rank's chunk of the sum."""
    chunks = [c.contiguous() for c in chunks]
    like = chunks[0]
    stage = _staged("reduce_scatter", chunks, group)
    total = sum(_nbytes(c) for c in chunks)
    with _comm_span(name, nbytes=total, axis_name=axis, staged=stage,
                    group=group, like=like):
        ins = _to_host(name, chunks) if stage else chunks
        out = _host_empty(like) if stage else torch.empty_like(like)
        work = dist.reduce_scatter(out, ins, group=_pg(group), async_op=True)
        guarded_wait(name, work, axis, shape=_shape(like))
        if stage:
            out = _to_dev(name, out, torch.empty_like(like))
    if _OBSERVERS:
        _observe("result", name, axis, group, out)
    return out


def _all_to_all(chunks, group, name="all_to_all", axis=None):
    """Send chunk k (equal shapes) to the group's rank k; -> the chunks
    received, in group order. One `all_to_all_single` over the chunks
    laid end to end (gloo has no list all_to_all)."""
    like = chunks[0]
    flat = torch.cat([c.reshape(-1) for c in chunks])
    stage = _staged("all_to_all", [flat], group)
    with _comm_span(name, nbytes=_nbytes(flat), axis_name=axis,
                    staged=stage, group=group, like=like):
        src = _to_host(name, [flat])[0] if stage else flat
        out = _host_empty(flat) if stage else torch.empty_like(flat)
        work = dist.all_to_all_single(out, src, group=_pg(group),
                                      async_op=True)
        guarded_wait(name, work, axis, shape=_shape(like))
        if stage:
            out = _to_dev(name, out, torch.empty_like(flat))
    return list(out.view(len(chunks), *like.shape).unbind(0))


def _all_to_all_uneven(x, in_splits, out_splits, group,
                       name="all_to_all_uneven", axis=None):
    """Send rows [sum(in_splits[:k]), +in_splits[k]) of `x` to the
    group's rank k; -> the rows received, out_splits[k] of them from
    rank k, in group order (`all_to_all_single` with split sizes)."""
    x = x.contiguous()
    in_splits = [int(c) for c in in_splits]
    out_splits = [int(c) for c in out_splits]
    if sum(in_splits) != x.shape[0]:
        raise ValueError(f"all_to_all: the input splits {in_splits} do not "
                         f"sum to the {x.shape[0]} rows given")
    shape = (sum(out_splits),) + tuple(x.shape[1:])
    stage = _staged("all_to_all_uneven", [x], group)
    with _comm_span(name, x, axis, staged=stage, group=group):
        src = _to_host(name, [x])[0] if stage else x
        out = torch.empty(shape, dtype=x.dtype,
                          pin_memory=True) if stage else \
            torch.empty(shape, dtype=x.dtype, device=x.device)
        work = dist.all_to_all_single(out, src, output_split_sizes=out_splits,
                                      input_split_sizes=in_splits,
                                      group=_pg(group), async_op=True)
        guarded_wait(name, work, axis, shape=_shape(x))
        if stage:
            out = _to_dev(name, out, torch.empty(shape, dtype=x.dtype,
                                                 device=x.device))
    return out


class Exchange:
    """A posted point-to-point exchange: `send` to global rank `dst`
    and a tensor like it from global rank `src` (either may be None),
    issued on creation so that work queued between it and `wait()`
    overlaps the transfer; `wait()` returns the received tensor (or
    None). Its span runs from the post to the end of the wait."""

    def __init__(self, name, send, group, dst, src, axis=None,
                 like=None, tag=0):
        self.name, self.axis = name, axis
        like = send if like is None else like
        self.stage = _staged("p2p", [like], group)
        self._span = _comm_span(name, send, axis, staged=self.stage,
                                nbytes=0 if send is None else None,
                                group=group, like=like)
        self._span.__enter__()
        try:
            ops = []
            if send is not None:
                buf = _to_host(name, [send.contiguous()])[0] if self.stage \
                    else send.contiguous()
                ops.append(dist.P2POp(dist.isend, buf, dst, _pg(group),
                                      tag))
                self._send = buf
            self.recv = None
            if src is not None:
                self.recv = torch.empty(like.shape, dtype=like.dtype,
                                        device=like.device)
                self._rbuf = _host_empty(like) if self.stage else self.recv
                ops.append(dist.P2POp(dist.irecv, self._rbuf, src,
                                      _pg(group), tag))
            self.works = dist.batch_isend_irecv(ops) if ops else []
        except BaseException:
            self._span.__exit__(None, None, None)
            raise

    def wait(self):
        try:
            for w in self.works:
                guarded_wait(self.name, w, self.axis)
            if self.recv is not None and self.stage:
                _to_dev(self.name, self._rbuf, self.recv)
        finally:
            self._span.__exit__(None, None, None)
        return self.recv


def exchange(send, axis_name, dst, src, like=None, tag=0):
    """Post a send of `send` to axis index `dst` and a receive from axis
    index `src` (like `like`, default `send`) over mesh axis
    `axis_name` (None: no send / no receive); -> an `Exchange` to
    `wait()` on. Its span is the ppermute's. Under gloo a message goes
    to the receive of the same `tag` (NCCL matches in posting order)."""
    group, _, ranks = _axis(axis_name)
    return Exchange("ppermute", send, group,
                    None if dst is None else ranks[dst],
                    None if src is None else ranks[src], axis=axis_name,
                    like=like, tag=tag)


# ---------------------------------------------------------------------------
# the eager API
# ---------------------------------------------------------------------------

class Group:
    """A process group: `ranks` are global ranks, `rank` this rank's
    index in them (-1 when it is not a member), `pg` the torch group
    (None for the default group)."""

    def __init__(self, rank=0, ranks=None, axis_name=None, id=0,  # noqa: A002
                 pg=None):
        self.rank = rank
        self.ranks = list(ranks or [0])
        self.nranks = len(self.ranks)
        self.axis_name = axis_name
        self.id = id
        self.pg = pg

    @property
    def world_size(self):
        return self.nranks

    def __repr__(self):
        return f"Group(axis={self.axis_name}, ranks={self.ranks})"


_GROUPS = {}


def _world():
    n = env.get_world_size()
    return Group(env.get_rank(), list(range(n)), axis_name=None, id=0)


def new_group(ranks=None, backend=None, axis_name=None):
    """A group over the global `ranks` (default all); every rank of the
    job must call it, members or not, in the same order. `backend`
    defaults to the job's."""
    ranks = list(range(env.get_world_size())) if ranks is None \
        else sorted(int(r) for r in ranks)
    pg = dist.new_group(ranks, backend=backend)
    me = env.get_rank()
    gid = len(_GROUPS) + 1
    g = Group(ranks.index(me) if me in ranks else -1, ranks,
              axis_name=axis_name, id=gid, pg=pg)
    _GROUPS[gid] = g
    return g


def get_group(id=0):  # noqa: A002 — reference param name
    return _GROUPS.get(id, _world())


def is_initialized():
    return dist.is_initialized()


def get_world_size(group=None):
    return group.nranks if group is not None else env.get_world_size()


def get_rank(group=None):
    return group.rank if group is not None else env.get_rank()


def barrier(group=None):
    name = "barrier"
    with _comm_span(name, group=group):
        work = dist.barrier(group=_pg(group), async_op=True)
        guarded_wait(name, work)


def wait(tensor, group=None, use_calc_stream=True):
    """Every call above has completed when it returns; on the card this
    also waits for the current stream's work on `tensor`."""
    if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()


def _global(group, idx):
    """Group index -> global rank (the reference takes group ranks)."""
    return idx if group is None or group.pg is None else group.ranks[idx]


def all_reduce(tensor, op=ReduceOp.SUM, group=None, use_calc_stream=True,
               sync_op=None):
    """In-place reduction over `group`; returns `tensor`. The stream
    arguments of both reference generations are accepted; every call
    completes before it returns (under the deadline guard)."""
    return _all_reduce_(tensor, op, group)


def broadcast(tensor, src=0, group=None, use_calc_stream=True,
              sync_op=None):
    return _broadcast_(tensor, _global(group, src), group)


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None,  # noqa: A001
           use_calc_stream=True, sync_op=None):
    return _reduce_(tensor, _global(group, dst), op, group)


def all_gather(tensor_list, tensor, group=None, use_calc_stream=True,
               sync_op=None):
    """Append every rank's `tensor` to `tensor_list`, in group order."""
    tensor_list.extend(_all_gather(tensor, group))
    return tensor_list


def all_gather_object(object_list, obj, group=None):
    n = get_world_size(group)
    out = [None] * n
    with _comm_span("all_gather_object"):
        dist.all_gather_object(out, obj, group=_pg(group))
    object_list.extend(out)
    return object_list


def scatter(tensor, tensor_list=None, src=0, group=None,
            use_calc_stream=True, sync_op=None):
    """`tensor` gets chunk `rank` of `src`'s `tensor_list` (a broadcast
    of the list, read at this rank's index: gloo scatters only CPU
    tensors, so the list travels whole)."""
    n = get_world_size(group)
    me = get_rank(group)
    if get_rank(group) == src:
        full = torch.stack([t.to(tensor.dtype) for t in tensor_list])
    else:
        full = torch.empty((n, *tensor.shape), dtype=tensor.dtype,
                           device=tensor.device)
    _broadcast_(full, _global(group, src), group, name="scatter")
    with torch.no_grad():
        tensor.copy_(full[me])
    return tensor


def alltoall(in_tensor_list, out_tensor_list=None, group=None,
             use_calc_stream=True, sync_op=None):
    outs = _all_to_all(list(in_tensor_list), group, name="alltoall")
    if out_tensor_list is not None:
        out_tensor_list.extend(outs)
        return out_tensor_list
    return outs


def send(tensor, dst=0, group=None, use_calc_stream=True, sync_op=None):
    Exchange("send", tensor, group, _global(group, dst), None).wait()
    return tensor


def recv(tensor, src=0, group=None, use_calc_stream=True, sync_op=None):
    got = Exchange("recv", None, group, None, _global(group, src),
                   like=tensor).wait()
    with torch.no_grad():
        tensor.copy_(got)
    return tensor


# ---------------------------------------------------------------------------
# the axis layer (the shard_map primitives' counterparts), autograd-aware
# ---------------------------------------------------------------------------

def _axis(axis_name):
    """(group, size, global ranks in axis order) of this rank's row."""
    size = env.axis_size(axis_name)
    if size == 1:
        return None, 1, [env.get_rank()]
    group = env.axis_group(axis_name)
    return group, size, dist.get_process_group_ranks(group)


def _psum_raw(x, axis_name, name="psum", op=ReduceOp.SUM):
    group, n, _ = _axis(axis_name)
    out = x.clone()
    if n > 1:
        _all_reduce_(out, op, group, name=name, axis=axis_name)
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.axis_name = axis_name
        return _psum_raw(x, axis_name)

    @staticmethod
    def backward(ctx, g):
        return _psum_raw(g.contiguous(), ctx.axis_name), None


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.axis_name = axis_name
        return _psum_raw(x, axis_name, "pmean") / env.axis_size(axis_name)

    @staticmethod
    def backward(ctx, g):
        return (_psum_raw(g.contiguous(), ctx.axis_name, "pmean")
                / env.axis_size(ctx.axis_name)), None


class _PMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.axis_name = axis_name
        out = _psum_raw(x, axis_name, "pmax", op=ReduceOp.MAX)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        # the adjoint: every rank's cotangent summed, to the ranks that
        # hold the maximum, shared among ties
        x, out = ctx.saved_tensors
        hit = (x == out).to(g.dtype)
        ties = _psum_raw(hit, ctx.axis_name, "pmax")
        return _psum_raw(g.contiguous(), ctx.axis_name, "pmax") * hit \
            / ties.clamp(min=1), None


def _gather_cat(x, axis_name, dim, tiled, name="all_gather"):
    group, n, _ = _axis(axis_name)
    parts = [x] if n == 1 else _all_gather(x, group, name=name,
                                           axis=axis_name)
    return torch.cat(parts, dim=dim) if tiled else torch.stack(parts,
                                                               dim=dim)


def _scatter_sum(x, axis_name, dim, tiled, name="reduce_scatter"):
    group, n, _ = _axis(axis_name)
    if tiled and x.shape[dim] % n:
        raise ValueError(f"reduce_scatter over {axis_name!r}: dim {dim} of "
                         f"{tuple(x.shape)} does not divide by {n}")
    chunks = list(x.chunk(n, dim=dim)) if tiled else list(x.unbind(dim))
    if n == 1:
        return chunks[0].clone()
    return _reduce_scatter(chunks, group, name=name, axis=axis_name)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, dim, tiled):
        ctx.args = (axis_name, dim, tiled)
        return _gather_cat(x, axis_name, dim, tiled)

    @staticmethod
    def backward(ctx, g):
        axis_name, dim, tiled = ctx.args
        return _scatter_sum(g, axis_name, dim, tiled), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, dim):
        ctx.args = (axis_name, dim)
        return _scatter_sum(x, axis_name, dim, True)

    @staticmethod
    def backward(ctx, g):
        axis_name, dim = ctx.args
        return _gather_cat(g.contiguous(), axis_name, dim, True), None, None


def _permute_raw(x, axis_name, perm):
    """JAX ppermute semantics over axis indices: the rank at s sends to
    d for each (s, d) in `perm`; a rank nobody sends to gets zeros."""
    _, n, _ = _axis(axis_name)
    me = env.axis_index(axis_name)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if n == 1:
        return x.clone() if (0, 0) in perm else torch.zeros_like(x)
    got = exchange(x if dst else None, axis_name, dst[0] if dst else None,
                   src[0] if src else None, like=x).wait()
    return got if got is not None else torch.zeros_like(x)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, perm):
        perm = [(int(s), int(d)) for s, d in perm]
        ctx.args = (axis_name, perm)
        return _permute_raw(x.contiguous(), axis_name, perm)

    @staticmethod
    def backward(ctx, g):
        axis_name, perm = ctx.args
        return _permute_raw(g.contiguous(), axis_name,
                            [(d, s) for s, d in perm]), None, None


def _a2a_raw(x, axis_name, split, concat, name="all_to_all"):
    group, n, _ = _axis(axis_name)
    if x.shape[split] % n:
        raise ValueError(f"all_to_all over {axis_name!r}: dim {split} of "
                         f"{tuple(x.shape)} does not divide by {n}")
    if n == 1:
        return x.clone()
    outs = _all_to_all(list(x.chunk(n, dim=split)), group, name=name,
                       axis=axis_name)
    return torch.cat(outs, dim=concat)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, split, concat):
        ctx.args = (axis_name, split, concat)
        return _a2a_raw(x, axis_name, split, concat)

    @staticmethod
    def backward(ctx, g):
        axis_name, split, concat = ctx.args
        return _a2a_raw(g, axis_name, concat, split), None, None, None


class _AllToAllUneven(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis_name, in_splits, out_splits):
        ctx.args = (group, axis_name, in_splits, out_splits)
        return _all_to_all_uneven(x, in_splits, out_splits, group,
                                  axis=axis_name)

    @staticmethod
    def backward(ctx, g):
        group, axis_name, in_splits, out_splits = ctx.args
        return _all_to_all_uneven(g, out_splits, in_splits, group,
                                  axis=axis_name), None, None, None, None


class _SplitAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, dim):
        n = env.axis_size(axis_name)
        ctx.args = (axis_name, dim)
        return x.chunk(n, dim=dim)[env.axis_index(axis_name)].contiguous()

    @staticmethod
    def backward(ctx, g):
        axis_name, dim = ctx.args
        return _gather_cat(g.contiguous(), axis_name, dim, True,
                           name="split_axis"), None, None


class _GatherAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, dim):
        ctx.args = (axis_name, dim)
        return _gather_cat(x.contiguous(), axis_name, dim, True,
                           name="gather_axis")

    @staticmethod
    def backward(ctx, g):
        axis_name, dim = ctx.args
        n = env.axis_size(axis_name)
        return g.chunk(n, dim=dim)[env.axis_index(axis_name)].contiguous(), \
            None, None


class _CIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.axis_name = axis_name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _psum_raw(g.contiguous(), ctx.axis_name, "c_identity"), None


class _MpAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        return _psum_raw(x.contiguous(), axis_name, "mp_allreduce")

    @staticmethod
    def backward(ctx, g):
        return g, None


def _trivial(axis_name):
    return env.axis_size(axis_name) == 1


def psum(tensor, axis_name):
    """Sum over the mesh axis (backward: psum)."""
    return tensor if _trivial(axis_name) else _PSum.apply(tensor, axis_name)


def pmean(tensor, axis_name):
    return tensor if _trivial(axis_name) else _PMean.apply(tensor, axis_name)


def pmax(tensor, axis_name):
    return tensor if _trivial(axis_name) else _PMax.apply(tensor, axis_name)


def all_gather_axis(tensor, axis_name, axis=0, tiled=True):
    """Every rank's `tensor` along dim `axis` (tiled: concatenated, else
    stacked on a new dim); backward: reduce_scatter."""
    if _trivial(axis_name):
        return tensor if tiled else tensor.unsqueeze(axis)
    return _AllGather.apply(tensor, axis_name, axis, tiled)


def reduce_scatter_axis(tensor, axis_name, axis=0):
    """This rank's chunk (dim `axis`) of the sum over the axis;
    backward: all_gather."""
    if _trivial(axis_name):
        return tensor
    return _ReduceScatter.apply(tensor, axis_name, axis)


def ppermute(tensor, axis_name, perm):
    """Send along `perm` ((src, dst) axis-index pairs); backward: the
    inverse permutation."""
    if _trivial(axis_name):
        return _permute_raw(tensor, axis_name, list(perm))
    return _PPermute.apply(tensor, axis_name, perm)


def all_to_all_axis(tensor, axis_name, split_axis, concat_axis):
    """Chunk k of dim `split_axis` to axis rank k, the received chunks
    concatenated along `concat_axis`; backward: the swapped all_to_all."""
    if _trivial(axis_name):
        return tensor
    return _AllToAll.apply(tensor, axis_name, split_axis, concat_axis)


def all_to_all_uneven(tensor, axis_name, in_splits, out_splits):
    """Rows of `tensor` in blocks of `in_splits` to the axis ranks in
    order, `out_splits[k]` rows received from axis rank k, concatenated
    in axis order; backward: the exchange back."""
    if _trivial(axis_name):
        return tensor
    return _AllToAllUneven.apply(tensor, _axis(axis_name)[0], axis_name,
                                 list(in_splits), list(out_splits))


def split_axis(tensor, axis_name, axis=0):
    """This rank's chunk (dim `axis`) of a tensor every rank of the axis
    holds alike; backward: the chunks' gradients all-gathered. The
    adjoint when each rank's loss counts every chunk (its consumers
    downstream are replicated over the axis): the split of the
    expert-parallel token blocks."""
    if _trivial(axis_name):
        return tensor
    n = env.axis_size(axis_name)
    if tensor.shape[axis] % n:
        raise ValueError(f"split over {axis_name!r}: dim {axis} of "
                         f"{tuple(tensor.shape)} does not divide by {n}")
    return _SplitAxis.apply(tensor, axis_name, axis)


def gather_axis(tensor, axis_name, axis=0):
    """Every rank's `tensor` concatenated along dim `axis`; backward:
    this rank's chunk of the gradient (the consumers are replicated over
    the axis, so every rank's cotangent is the whole one). The inverse
    of `split_axis`."""
    if _trivial(axis_name):
        return tensor
    return _GatherAxis.apply(tensor, axis_name, axis)


def c_identity(tensor, axis_name="mp"):
    """Identity forward, all-reduce of the gradient backward (reference
    `c_identity`): the input of a column-parallel product."""
    return tensor if _trivial(axis_name) else _CIdentity.apply(tensor,
                                                                axis_name)


def mp_allreduce(tensor, axis_name="mp"):
    """All-reduce forward, identity backward (reference
    `mp_allreduce`): the output of a row-parallel product, whose
    consumers are replicated over the axis."""
    return tensor if _trivial(axis_name) else _MpAllReduce.apply(tensor,
                                                                  axis_name)


# ---- model-parallel split op (reference collective.py:1233) ---------------

def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """paddle.distributed.split: a row/column-parallel linear or a
    vocab-parallel embedding over the mp axis, built for this call on
    x's device with full-size weights cut to this rank's piece."""
    from .mp_layers import (ColumnParallelLinear, RowParallelLinear,
                            VocabParallelEmbedding)
    if operation == "linear":
        if axis == 0:
            layer = RowParallelLinear(size[0], size[1],
                                      has_bias=bias_attr is not False,
                                      input_is_parallel=True,
                                      device=x.device)
        else:
            layer = ColumnParallelLinear(size[0], size[1],
                                         has_bias=bias_attr is not False,
                                         gather_output=gather_out,
                                         device=x.device)
        return layer(x)
    if operation == "embedding":
        return VocabParallelEmbedding(size[0], size[1], device=x.device)(x)
    raise ValueError(f"unknown split operation {operation}")
