"""The port's distributed package (paddle_tpu/distributed counterparts).

One process a rank over `torch.distributed`, where the JAX package
drives every chip from one controller through GSPMD: the process group
and the (dp, pp, mp, sp, ep) DeviceMesh (`env`), the topology and
strategy (`topology`, `strategy`), the collectives with their deadline
guard, comm spans and the axis layer's autograd Functions
(`collective`), DataParallel (`parallel`), the tensor-parallel layers
(`mp_layers`), the hybrid-parallel training step with ZeRO-1/2/3,
optimizer-state offload and expert parallelism (`sharded_train`; the
MoE layer's ep body is `moe/layer.py`), the pipeline (`pipeline`: PipelineLayer, GPipe, 1F1B,
interleaved, PipelineParallel), the expert exchange
(`utils.global_scatter`/`global_gather`) and the deprecated `MoELayer`
(`moe`), the collective half of `fleet`, the launcher (`launch`;
`python -m paddle_tpu_torch.distributed.launch`), the distributed
checkpoints (`checkpoint`: a piece a rank, restored onto any layout;
`TrainEpochRange`), and on one card activation recompute and the
host-offloaded `OffloadTrainStep`. Elastic restarts: the TCP KV store
(`kvstore`: KVServer, KVClient), the membership manager and the
declared-dead coordinator (`elastic`), the launcher's 101/102 relaunch
and `dist_utils`' launch helpers. Not ported yet (ROADMAP Queue 1): the
planner, ep with sp or pp and the parameter-server mode. The filesystem
layer (`fs`: LocalFS, HDFSClient over the hadoop CLI) is JAX's.
"""
from . import env  # noqa: F401
from . import fleet  # noqa: F401
from .env import (  # noqa: F401
    build_mesh, clear_mesh, current_mesh, init_distributed, set_mesh,
)
from .topology import CommunicateTopology, HybridCommunicateGroup  # noqa: F401
from .strategy import DistributedStrategy  # noqa: F401
from .collective import (  # noqa: F401
    CollectiveTimeoutError, Group, ReduceOp, all_gather, all_gather_axis,
    all_gather_object, all_reduce, all_to_all_axis, alltoall, barrier,
    broadcast, collective_deadline, get_group, is_initialized, new_group,
    pmax, pmean, ppermute, psum, recv, reduce, reduce_scatter_axis, scatter,
    send, set_collective_deadline, split, wait, split_axis, gather_axis,
    all_to_all_uneven,
)
from .parallel import (  # noqa: F401
    DataParallel, ParallelEnv, get_rank, get_world_size, init_parallel_env,
    spawn,
)
from .sharded_train import ShardedTrainStep, shard_batch, shard_model  # noqa: F401
from .mp_layers import (  # noqa: F401
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding,
)
from .offload_train import OffloadTrainStep  # noqa: F401
from . import checkpoint  # noqa: F401
from .checkpoint import (  # noqa: F401
    TrainEpochRange, load_checkpoint, save_checkpoint, train_epoch_range,
)
from .pipeline import (  # noqa: F401
    LayerDesc, PipelineLayer, PipelineParallel, SegmentLayers,
    SharedLayerDesc, pipeline_apply, pipeline_train_step_1f1b,
    pipeline_train_step_interleaved,
)
from .moe import MoELayer  # noqa: F401
from . import kvstore  # noqa: F401
from .kvstore import KVClient, KVServer  # noqa: F401
from . import fs  # noqa: F401
from .fs import HDFSClient, LocalFS  # noqa: F401
from . import dist_utils as utils  # noqa: F401
from .dist_utils import global_gather, global_scatter  # noqa: F401
import sys as _sys
# reference parity: `import paddle.distributed.utils` is a module path
_sys.modules[__name__ + ".utils"] = utils
from .recompute import RecomputeSequential, recompute  # noqa: F401
from . import launch as _launch_module  # noqa: E402
from . import elastic  # noqa: F401,E402

# reference parity: paddle.distributed.launch is the callable; the
# module stays importable for `python -m ...distributed.launch`
launch = _launch_module.launch
fleet.DistributedStrategy = DistributedStrategy
