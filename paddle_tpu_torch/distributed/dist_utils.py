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

The launch helpers are JAX's (dist_utils.py:95-403): the job model
(Hdfs, JobServer, Trainer, Pod, Cluster, `get_cluster`), the host and
port helpers (`get_host_name_ip`, `find_free_ports`, `add_arguments`,
`get_logger`) and the local trainer processes (TrainerProc,
`start_local_trainers`, `terminate_local_procs`,
`watch_local_trainers`, `pull_worker_log`), with the same fields,
`__str__` and `__eq__`. `distributed.launch` is the port's launcher;
these are the reference's building blocks for a caller's own.
"""
import copy
import os
import socket
import subprocess
import sys
import time
from contextlib import closing

import numpy as np
import torch

from . import env
from .collective import Group, _AllToAllUneven, _axis

__all__ = ["global_scatter", "global_gather", "Hdfs", "JobServer",
           "Trainer", "Pod", "Cluster", "get_cluster", "get_host_name_ip",
           "find_free_ports", "add_arguments", "TrainerProc",
           "start_local_trainers", "terminate_local_procs",
           "watch_local_trainers", "get_logger", "pull_worker_log"]


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


# ---------------------------------------------------------------------------
# Launcher data model + process helpers (the port of
# paddle_tpu/distributed/dist_utils.py:95-403; reference
# `python/paddle/distributed/utils.py:320-740`): Cluster/Pod/Trainer
# describe the job topology; start/watch/terminate drive local trainer
# processes. The port runs a process a rank, so a Trainer's `gpus` are
# the card ordinals its rank uses.
# ---------------------------------------------------------------------------

class Hdfs:
    def __init__(self):
        self.hdfs_ugi = None
        self.hdfs_name = None
        self.hdfs_path = None

    def is_valid(self):
        return (self.hdfs_ugi is not None and self.hdfs_name is not None
                and self.hdfs_path is not None)

    def __str__(self):
        return (f"hdfs_ugi:{self.hdfs_ugi} hdfs_name:{self.hdfs_name} "
                f"hdfs_path:{self.hdfs_path}")

    def __eq__(self, n):
        return (self.hdfs_ugi == n.hdfs_ugi
                and self.hdfs_name == n.hdfs_name
                and self.hdfs_path == n.hdfs_path)

    def __ne__(self, n):
        return not self == n


class JobServer:
    def __init__(self):
        self.endpoint = None

    def __str__(self):
        return f"{self.endpoint}"

    def __eq__(self, j):
        return self.endpoint == j.endpoint

    def __ne__(self, j):
        return not self == j


class Trainer:
    def __init__(self):
        self.gpus = []
        self.endpoint = None
        self.rank = None

    def __str__(self):
        return f"gpu:{self.gpus} endpoint:{self.endpoint} rank:{self.rank}"

    def __eq__(self, t):
        return (self.gpus == t.gpus and self.endpoint == t.endpoint
                and self.rank == t.rank)

    def __ne__(self, t):
        return not self == t


class Pod:
    def __init__(self):
        self.rank = None
        self.id = None
        self.addr = None
        self.port = None
        self.trainers = []
        self.gpus = []

    def __str__(self):
        return (f"rank:{self.rank} id:{self.id} addr:{self.addr} "
                f"port:{self.port} trainers:"
                f"{[str(t) for t in self.trainers]}")

    def __eq__(self, pod):
        if (self.rank != pod.rank or self.id != pod.id
                or self.addr != pod.addr or self.port != pod.port
                or len(self.trainers) != len(pod.trainers)):
            return False
        return all(a == b for a, b in zip(self.trainers, pod.trainers))

    def __ne__(self, pod):
        return not self == pod

    def parse_response(self, res_pods):
        pass

    def get_visible_gpus(self):
        return ",".join(str(g) for g in self.gpus)


class Cluster:
    def __init__(self, hdfs):
        self.job_server = None
        self.pods = []
        self.hdfs = hdfs
        self.job_stage_flag = None

    def __str__(self):
        return (f"job_server:{self.job_server} "
                f"pods:{[str(p) for p in self.pods]} "
                f"job_stage_flag:{self.job_stage_flag} hdfs:{self.hdfs}")

    def __eq__(self, cluster):
        if len(self.pods) != len(cluster.pods):
            return False
        if any(a != b for a, b in zip(self.pods, cluster.pods)):
            return False
        return self.job_stage_flag == cluster.job_stage_flag

    def __ne__(self, cluster):
        return not self == cluster

    def update_pods(self, cluster):
        self.pods = copy.copy(cluster.pods)

    def trainers_nranks(self):
        return len(self.trainers_endpoints())

    def pods_nranks(self):
        return len(self.pods)

    def trainers_endpoints(self):
        return [t.endpoint for p in self.pods for t in p.trainers]

    def pods_endpoints(self):
        return [f"{p.addr}:{p.port}" for p in self.pods]

    def get_pod_by_id(self, pod_id):
        for pod in self.pods:
            if str(pod_id) == str(pod.id):
                return pod
        return None


def get_cluster(node_ips, node_ip, trainer_endpoints, selected_gpus):
    """Build the Cluster/Pod/Trainer model (reference `utils.py:519`)."""
    assert isinstance(trainer_endpoints, list), \
        "trainer_endpoints must be list"
    cluster = Cluster(hdfs=None)
    trainer_rank = 0
    for node_rank, ip in enumerate(node_ips):
        pod = Pod()
        pod.rank = node_rank
        pod.addr = ip
        pod.id = node_rank
        cur = trainer_endpoints[node_rank]
        assert len(cur) >= len(selected_gpus), \
            "trainer_endpoints per node must cover selected devices"
        for i in range(len(selected_gpus)):
            trainer = Trainer()
            trainer.gpus.append(selected_gpus[i])
            trainer.endpoint = str(cur[i])
            trainer.rank = trainer_rank
            trainer_rank += 1
            pod.trainers.append(trainer)
        cluster.pods.append(pod)
    pod_rank = node_ips.index(node_ip)
    return cluster, cluster.pods[pod_rank]


def get_host_name_ip():
    try:
        host_name = socket.gethostname()
        host_ip = socket.gethostbyname(host_name)
        return host_name, host_ip
    except Exception:
        return None


def find_free_ports(num):
    """`num` distinct currently-free TCP ports (reference `utils.py:599`)."""
    ports = set()
    step = 0
    while len(ports) < num:
        with closing(socket.socket(socket.AF_INET,
                                   socket.SOCK_STREAM)) as s:
            s.bind(("", 0))
            ports.add(s.getsockname()[1])
        step += 1
        if step > num * 100:
            return None
    return ports


def add_arguments(argname, type, default, help, argparser, **kwargs):  # noqa: A002
    """argparse helper kept verbatim from the reference (`utils.py:582`)."""
    bool_t = lambda v: str(v).lower() in ("1", "true", "yes")  # noqa: E731
    type = bool_t if type == bool else type  # noqa: A001
    argparser.add_argument(
        "--" + argname, default=default, type=type, help=help + " Default: "
        f"{default}.", **kwargs)


class TrainerProc:
    def __init__(self):
        self.proc = None
        self.log_fn = None
        self.log_offset = None
        self.rank = None
        self.local_rank = None
        self.cmd = None


def start_local_trainers(cluster, pod, training_script,
                         training_script_args, log_dir=None):
    """Spawn one process per trainer in `pod` with the reference's env
    contract (`utils.py:657`); returns [TrainerProc]."""
    current_env = dict(os.environ)
    procs = []
    n = cluster.trainers_nranks()
    eps = ",".join(cluster.trainers_endpoints())
    for idx, t in enumerate(pod.trainers):
        env = dict(current_env)
        env.update({
            "PADDLE_TRAINER_ID": str(t.rank),
            "PADDLE_CURRENT_ENDPOINT": str(t.endpoint),
            "PADDLE_TRAINERS_NUM": str(n),
            "PADDLE_TRAINER_ENDPOINTS": eps,
        })
        cmd = [sys.executable, "-u", training_script] + \
            list(training_script_args)
        log_fn = None
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            log_fn = open(os.path.join(log_dir,
                                       f"workerlog.{idx}"), "a")
        proc = subprocess.Popen(cmd, env=env, stdout=log_fn or None,
                                stderr=subprocess.STDOUT if log_fn else None)
        tp = TrainerProc()
        tp.proc = proc
        tp.rank = t.rank
        tp.local_rank = idx
        tp.log_fn = log_fn
        tp.cmd = cmd
        procs.append(tp)
    return procs


def terminate_local_procs(procs):
    for p in procs:
        if p.proc is not None and p.proc.poll() is None:
            p.proc.terminate()
            if p.log_fn:
                p.log_fn.close()
    deadline = time.time() + 10
    for p in procs:
        if p.proc is None:
            continue
        try:
            p.proc.wait(timeout=max(0.1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            p.proc.kill()


def watch_local_trainers(procs, nranks):
    """Poll ONCE and return the still-alive procs (empty when the job is
    done); terminate the pod and raise on first failure. The caller loops
    and pulls worker logs between polls — the reference contract
    (`utils.py:717` watch_local_trainers returns alive_trainers per call,
    and launch.py's loop calls pull_worker_log each iteration)."""
    try:
        alive = [p for p in procs
                 if p.proc is not None and p.proc.poll() is None]
        failed = [p for p in procs
                  if p.proc is not None and p.proc.poll()
                  not in (None, 0)]
        if failed:
            terminate_local_procs(procs)
            raise SystemExit(failed[0].proc.returncode)
        return alive
    except KeyboardInterrupt:
        terminate_local_procs(procs)
        raise


def get_logger(log_level, name="root"):
    """Stream logger with the reference's format (`utils.py:506`)."""
    import logging
    logger = logging.getLogger(name)
    logger.setLevel(log_level)
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter(
        "%(levelname)s %(asctime)s %(filename)s:%(lineno)d] %(message)s"))
    logger.addHandler(handler)
    return logger


def pull_worker_log(tp):
    """Stream a TrainerProc's log file increment to stdout
    (`utils.py:702`); tracks the offset on the TrainerProc."""
    if tp.log_fn:
        with open(tp.log_fn.name, "r") as fin:
            fin.seek(tp.log_offset or 0, 0)
            for line in fin:
                try:
                    sys.stdout.write(line)
                except UnicodeEncodeError:
                    sys.stdout.write(
                        "UnicodeEncodeError occurs at this line. Please "
                        f'refer to the original log file "{tp.log_fn.name}"\n')
            tp.log_offset = fin.tell()
