"""Optimizers of the port (paddle_tpu/optimizer counterparts)."""
from .optimizer import Adam, AdamW, Optimizer

__all__ = ["Optimizer", "Adam", "AdamW"]
