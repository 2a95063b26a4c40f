"""Optimizers, their wrappers and learning-rate schedules of the port
(paddle_tpu/optimizer counterparts)."""
from . import lr
from .extras import (ExponentialMovingAverage, GradientMerge, Lookahead,
                     ModelAverage)
from .lr import LRScheduler
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
                        DGCMomentum, L1Decay, L2Decay, Lamb, LarsMomentum,
                        Momentum, Optimizer, RMSProp)

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "LarsMomentum",
           "DGCMomentum", "ExponentialMovingAverage", "ModelAverage",
           "Lookahead", "GradientMerge", "L1Decay", "L2Decay",
           "LRScheduler", "lr"]
