"""Fleet facade, collective mode — the port of the collective half of
paddle_tpu/distributed/fleet.py (reference `fleet/base/fleet_base.py:101`:
init, distributed_optimizer:828, distributed_model:881, minimize:1341;
`hybrid_parallel_optimizer.py:118`).

`init` builds the hybrid mesh from the strategy's `hybrid_configs`
(the dp degree absorbs what the others leave of the world, as fleet's
auto dp_degree does; `ep_degree` gives the mesh's ep axis);
`distributed_model` cuts the model to this rank (`shard_model`) and
wraps a `PipelineLayer` in `PipelineParallel` when the mesh's pp axis
is above 1 (JAX fleet.py:60-78; `pipeline_configs["accumulate_steps"]`
is its micro-batch count, the topology gives the stage and the pipe
group); `distributed_optimizer` wraps the optimizer with the strategy,
which `ShardedTrainStep` reads for its ZeRO stage. The parameter-server
mode (`ps.py`, `heter.py`, `kvstore.py`) is not ported (ROADMAP Queue 1
item 6.5).
"""
import os

from . import env
from .parallel import DataParallel, init_parallel_env  # noqa: F401
from .sharded_train import ShardedTrainStep, shard_model  # noqa: F401
from .strategy import DistributedStrategy
from .topology import CommunicateTopology, HybridCommunicateGroup  # noqa: F401

__all__ = ["init", "get_hybrid_communicate_group", "distributed_model",
           "distributed_optimizer", "minimize", "worker_index", "worker_num",
           "is_first_worker", "worker_endpoints", "barrier_worker",
           "HybridParallelOptimizer", "DistributedStrategy",
           "CommunicateTopology", "HybridCommunicateGroup"]


class _FleetState:
    def __init__(self):
        self.initialized = False
        self.strategy = None
        self.hcg = None
        self.is_collective = True


_state = _FleetState()


def init(role_maker=None, is_collective=False, strategy=None,
         backend="nccl"):
    """Join the job (`env.init_distributed(backend)` unless joined) and
    build the hybrid mesh of `strategy.hybrid_configs`."""
    _state.strategy = strategy or DistributedStrategy()
    _state.is_collective = is_collective
    if not env.is_initialized():
        env.init_distributed(backend=backend)
    hb = _state.strategy.hybrid_configs
    n = env.get_world_size()
    dp = hb.get("dp_degree", 1)
    mp = hb.get("mp_degree", 1)
    pp = hb.get("pp_degree", 1)
    sh = hb.get("sharding_degree", 1)
    sp = hb.get("sep_degree", 1)
    ep = hb.get("ep_degree", 1)
    specified = dp * mp * pp * sh * sp * ep
    if specified == 1 and n > 1:
        dp = n
    elif specified != n:
        rest = mp * pp * sh * sp * ep
        if n % rest == 0:
            dp = n // rest
    _state.hcg = HybridCommunicateGroup(dp=dp, mp=mp, pp=pp, sharding=sh,
                                        sp=sp, ep=ep)
    _state.initialized = True
    return _state.hcg


def get_hybrid_communicate_group():
    return _state.hcg


def distributed_model(model):
    """Cut `model` to this rank's piece of the mesh (`init` first, or an
    installed mesh); a PipelineLayer under a pp axis above 1 comes back
    wrapped in PipelineParallel."""
    from .pipeline import PipelineLayer, PipelineParallel
    mesh = env.current_mesh()
    if mesh is None:
        raise RuntimeError("distributed_model: call fleet.init first")
    shard_model(model, mesh)
    if isinstance(model, PipelineLayer) and env.axis_size("pp", mesh) > 1:
        return PipelineParallel(model, hcg=_state.hcg,
                                strategy=_state.strategy)
    return model


class _DistributedOptimizer:
    """The inner optimizer's API, with the strategy ShardedTrainStep
    reads (`user_defined_strategy`)."""

    def __init__(self, inner, strategy):
        self._inner = inner
        self._strategy = strategy
        self.user_defined_strategy = strategy

    def __getattr__(self, name):
        if name == "_inner":
            raise AttributeError(name)
        return getattr(self._inner, name)

    def step(self):
        self._inner.step()

    def clear_grad(self):
        self._inner.clear_grad()

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self._inner.step()


def distributed_optimizer(optimizer, strategy=None):
    return _DistributedOptimizer(optimizer, strategy or _state.strategy or
                                 DistributedStrategy())


def minimize(optimizer, loss):
    return optimizer.minimize(loss)


def worker_index():
    return env.get_rank()


def worker_num():
    return env.get_world_size()


def is_first_worker():
    return env.get_rank() == 0


def worker_endpoints(to_string=False):
    eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").split(",")
    return ",".join(eps) if to_string else eps


def barrier_worker():
    from .collective import barrier
    barrier()


class HybridParallelOptimizer:
    """Dygraph hybrid-parallel optimizer wrapper (reference
    `hybrid_parallel_optimizer.py:118`). The dp gradient exchange and
    the mp-aware global-norm clip live in ShardedTrainStep, which reads
    the inner optimizer's clip; the wrapper delegates, so fleet scripts
    run unchanged."""

    def __init__(self, optimizer, hcg=None, strategy=None):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy

    def __getattr__(self, item):
        if item == "_inner_opt":
            raise AttributeError(item)
        return getattr(self._inner_opt, item)

    def step(self):
        self._inner_opt.step()

    def clear_grad(self):
        self._inner_opt.clear_grad()

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self._inner_opt.step()
