"""The port's distributed package (paddle_tpu/distributed counterparts),
so far on one card: activation recompute and the host-offloaded,
gradient-accumulating train step. Meshes, sharding, pipelines and
collectives are not ported yet (ROADMAP Queue 1 item 6)."""
from .offload_train import OffloadTrainStep
from .recompute import RecomputeSequential, recompute

__all__ = ["OffloadTrainStep", "recompute", "RecomputeSequential"]
