"""Optimizers and learning-rate schedules of the port
(paddle_tpu/optimizer counterparts)."""
from . import lr
from .lr import LRScheduler
from .optimizer import SGD, Adam, AdamW, L1Decay, L2Decay, Momentum, Optimizer

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "L1Decay",
           "L2Decay", "LRScheduler", "lr"]
