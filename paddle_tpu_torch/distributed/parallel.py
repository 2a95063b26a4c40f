"""Process and data-parallel entry points — the port of
paddle_tpu/distributed/parallel.py (reference `distributed/parallel.py:85`
init_parallel_env, `fluid/dygraph/parallel.py:383` DataParallel,
`spawn.py:333` spawn).

`DataParallel` is `torch.nn.parallel.DistributedDataParallel` over the
mesh's dp group (the whole job when `init_parallel_env` built a pure-dp
mesh): its bucketed all-reduce averages the gradients over dp during
the backward, the reference Reducer's job. No TPU kernel sits there.
"""
import torch

from . import env

__all__ = ["ParallelEnv", "init_parallel_env", "get_rank", "get_world_size",
           "DataParallel", "spawn"]


class ParallelEnv:
    """Reference `parallel.py` ParallelEnv (env-var contract
    PADDLE_TRAINER_ID etc.)."""

    def __init__(self):
        self.rank = env.get_rank()
        self.world_size = env.get_world_size()
        self.device_id = env.current_device().index or 0

    @property
    def local_rank(self):
        return env.get_local_rank()

    @property
    def nranks(self):
        return self.world_size


def init_parallel_env(backend="nccl", device=None):
    """Join the job (`env.init_distributed`, unless already joined) and
    install a pure-dp mesh over every rank when none is installed.
    `backend` "nccl" or "gloo" (the reference's "auto" means nccl)."""
    if backend == "auto":
        backend = "nccl"
    if not env.is_initialized():
        env.init_distributed(backend=backend, device=device)
    if env.current_mesh() is None:
        env.build_mesh(dp=env.get_world_size())
    return ParallelEnv()


def get_rank(group=None):
    return env.get_rank()


def get_world_size(group=None):
    return env.get_world_size()


class DataParallel(torch.nn.parallel.DistributedDataParallel):
    """`layers` with its gradients averaged over the mesh's dp group
    (reference DataParallel); `scale_loss` and `apply_collective_grads`
    are the reference's no-ops."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        if env.current_mesh() is None:
            env.build_mesh(dp=env.get_world_size())
        pg = group.pg if group is not None else env.axis_group("dp")
        dev = env.current_device()
        super().__init__(layers, process_group=pg,
                         device_ids=[dev] if dev.type == "cuda" else None,
                         bucket_cap_mb=comm_buffer_size,
                         find_unused_parameters=find_unused_parameters)

    @property
    def _layers(self):
        return self.module

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        pass

    def state_dict(self, *a, **k):
        return self.module.state_dict(*a, **k)

    def set_state_dict(self, state_dict):
        return self.module.load_state_dict(state_dict)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """The reference spawn: with nprocs -1 or 1, `func(*args)` here (as
    the JAX package's spawn always does). Several processes are started
    by `python -m paddle_tpu_torch.distributed.launch`, which gives each
    its rank's env contract and kills the job when one fails."""
    if nprocs not in (-1, 1):
        raise NotImplementedError(
            "spawn(nprocs > 1): start the ranks with python -m "
            "paddle_tpu_torch.distributed.launch --nproc_per_node N")
    return func(*args)
