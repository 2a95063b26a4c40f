"""The distributed environment: the process group and the global mesh.

Counterpart of paddle_tpu/distributed/env.py. The JAX package drives
every chip from one controller and lets GSPMD place the collectives on a
`jax.sharding.Mesh`; the port runs one process a rank, as the reference
does, and the mesh is a `torch.distributed.device_mesh.DeviceMesh` over
the same axes, (dp, pp, mp, sp, ep), in the same order, with one process
group an axis (`axis_group`).

`init_distributed` reads the JAX package's env contract
(`PADDLE_TRAINERS_NUM`, `PADDLE_TRAINER_ID`, `PADDLE_TRAINER_ENDPOINTS`)
and torchrun's (`WORLD_SIZE`, `RANK`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`,
`MASTER_ADDR`/`MASTER_PORT`). The backend is the caller's choice and
nothing switches it, or the device, by itself:

- "nccl" (the default) gives each local rank its own CUDA device,
  `cuda:<local rank>`, and raises when a host has more local ranks than
  cards (NCCL refuses two ranks on one device);
- "gloo" runs on the device the caller names (`device=`, else
  `cuda:$PADDLE_DEVICE_ID` as the launcher's `--ranks-per-device` sets
  it, else the current CUDA device, raising without one; "cpu" for the
  CPU), so
  several ranks may share one card. Collectives over CUDA tensors that
  gloo cannot carry are staged through pinned host memory
  (`collective.py`).

The rendezvous is `init_method` (a "tcp://host:port" or
"file:///path" URL), else `PADDLE_DIST_INIT_METHOD`, else the first of
`PADDLE_TRAINER_ENDPOINTS`, else torchrun's MASTER_ADDR/MASTER_PORT.
"""
import datetime
import os

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["MESH_AXES", "init_distributed", "build_mesh", "set_mesh",
           "current_mesh", "clear_mesh", "get_world_size", "get_rank",
           "get_local_rank", "current_device", "backend", "axis_size",
           "axis_index", "axis_group", "axis_ranks", "is_initialized"]

MESH_AXES = ("dp", "pp", "mp", "sp", "ep")

_MESH = None
_STATE = {"backend": None, "device": None, "local_rank": 0}
BACKENDS = ("nccl", "gloo")
# how long a rank waits for its peers at the rendezvous and inside a
# gloo collective before the process group raises
DEFAULT_TIMEOUT_S = 300.0


def _env_int(*names, default=None):
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return default


def _init_method(init_method):
    if init_method:
        return init_method
    m = os.environ.get("PADDLE_DIST_INIT_METHOD")
    if m:
        return m
    eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").split(",")
    if eps and eps[0]:
        return f"tcp://{eps[0]}"
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return "env://"
    raise ValueError(
        "init_distributed: no rendezvous given: pass init_method= or set "
        "PADDLE_DIST_INIT_METHOD, PADDLE_TRAINER_ENDPOINTS or "
        "MASTER_ADDR/MASTER_PORT")


def init_distributed(backend="nccl", init_method=None, world_size=None,
                     rank=None, device=None, timeout_s=None):
    """Join the process group of this job and pick this rank's device;
    returns the device. `world_size`/`rank` default to the env contract
    (PADDLE_TRAINERS_NUM / PADDLE_TRAINER_ID, else WORLD_SIZE / RANK,
    else a one-rank world). "nccl" takes `cuda:<local rank>` (LOCAL_RANK
    or PADDLE_LOCAL_RANK, else rank mod LOCAL_WORLD_SIZE) and raises
    when LOCAL_WORLD_SIZE (PADDLE_LOCAL_SIZE; default the world size)
    exceeds the cards; "gloo" takes `device` (default the current CUDA
    device; "cpu" must be asked for). A second call raises."""
    if backend not in BACKENDS:
        raise ValueError(f"init_distributed: backend {backend!r} not in "
                         f"{BACKENDS}")
    if dist.is_initialized():
        raise RuntimeError("init_distributed: the process group is "
                           "already initialized")
    if world_size is None:
        world_size = _env_int("PADDLE_TRAINERS_NUM", "WORLD_SIZE",
                              default=1)
    if rank is None:
        rank = _env_int("PADDLE_TRAINER_ID", "RANK", default=0)
    local_size = _env_int("PADDLE_LOCAL_SIZE", "LOCAL_WORLD_SIZE",
                          default=world_size)
    local_rank = _env_int("PADDLE_LOCAL_RANK", "LOCAL_RANK",
                          default=rank % local_size)
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if local_size > cards:
            raise RuntimeError(
                f"init_distributed(backend='nccl'): {local_size} local "
                f"ranks but {cards} CUDA device(s); NCCL takes one device "
                "a rank. Several ranks on one card need backend='gloo'")
        if device is not None and torch.device(device) != torch.device(
                "cuda", local_rank):
            raise ValueError(f"init_distributed(backend='nccl'): local rank "
                             f"{local_rank} runs on cuda:{local_rank}, not "
                             f"{device}")
        dev = torch.device("cuda", local_rank)
    else:
        if device is None and os.environ.get("PADDLE_DEVICE_ID"):
            # the launcher's --ranks-per-device placement
            device = f"cuda:{int(os.environ['PADDLE_DEVICE_ID'])}"
        dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=float(
        timeout_s if timeout_s is not None else DEFAULT_TIMEOUT_S))
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=_init_method(init_method),
                            world_size=world_size, rank=rank,
                            timeout=timeout, **kw)
    _STATE.update(backend=backend, device=dev, local_rank=local_rank)
    return dev


def is_initialized():
    return dist.is_initialized()


def backend():
    """The process group's backend ("nccl" | "gloo"), None before init."""
    return _STATE["backend"] if dist.is_initialized() else None


def current_device():
    """This rank's device (init_distributed's), or the CPU before init."""
    return _STATE["device"] or torch.device("cpu")


def get_world_size():
    return dist.get_world_size() if dist.is_initialized() else 1


def get_rank():
    return dist.get_rank() if dist.is_initialized() else 0


def get_local_rank():
    return _STATE["local_rank"]


def build_mesh(dp=1, pp=1, mp=1, sp=1, ep=1):
    """Create and install the global mesh over every rank of the job:
    a DeviceMesh of shape (dp, pp, mp, sp, ep) named MESH_AXES, rank r at
    the coordinate r has in that row-major grid (mp and sp innermost but
    one, as in the JAX mesh). Every rank must call it, in the same order
    as its other group creations."""
    global _MESH
    from torch.distributed.device_mesh import DeviceMesh
    sizes = (dp, pp, mp, sp, ep)
    total = 1
    for s in sizes:
        total *= int(s)
    world = get_world_size()
    if total != world:
        raise ValueError(f"mesh {sizes} needs {total} ranks, the job has "
                         f"{world}")
    if not dist.is_initialized():
        raise RuntimeError("build_mesh: call init_distributed first")
    grid = torch.arange(world).reshape(sizes)
    _MESH = DeviceMesh(current_device().type, grid,
                       mesh_dim_names=MESH_AXES)
    return _MESH


def set_mesh(mesh):
    global _MESH
    _MESH = mesh
    return mesh


def current_mesh():
    return _MESH


def clear_mesh():
    global _MESH
    _MESH = None


def _mesh(mesh):
    return mesh if mesh is not None else _MESH


def axis_size(axis, mesh=None):
    """The size of mesh axis `axis` (1 without a mesh or that axis)."""
    m = _mesh(mesh)
    if m is None or axis not in (m.mesh_dim_names or ()):
        return 1
    return int(m.size(m.mesh_dim_names.index(axis)))


def axis_index(axis, mesh=None):
    """This rank's coordinate on mesh axis `axis` (0 without it)."""
    m = _mesh(mesh)
    if m is None or axis not in (m.mesh_dim_names or ()):
        return 0
    return int(m.get_local_rank(axis))


def axis_group(axis, mesh=None):
    """The process group of this rank's row along `axis`."""
    m = _mesh(mesh)
    if m is None:
        raise RuntimeError(f"axis_group({axis!r}): no mesh is installed")
    return m.get_group(axis)


def axis_ranks(axis, mesh=None):
    """The global ranks of this rank's row along `axis`, in axis order."""
    return dist.get_process_group_ranks(axis_group(axis, mesh))
