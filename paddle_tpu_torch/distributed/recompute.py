"""Activation recompute — the port of paddle_tpu/distributed/recompute.py.

`recompute(function, *args)` runs `function` so that its activations are
not kept for the backward: the backward runs it again from its inputs
(`torch.utils.checkpoint.checkpoint` without reentry, the counterpart of
`jax.checkpoint`). The numbers are those of the plain call. Parameters
reached by `function` get their gradients as usual.

The port's amp is thread-local state (`amp.py`), which
`torch.utils.checkpoint` does not know: on a CUDA device the backward,
and so the recompute, runs on the autograd engine's own thread, where
amp is off. `recompute` captures the caller's amp policy when the
forward runs and re-enters it around the recomputation, so the block is
recomputed in the dtypes it first ran in. `preserve_rng_state` keeps the
recompute's random draws (dropout) those of the forward;
`use_reentrant` is the reference's argument and is kept for its API
only: the checkpoint never reenters. `recomputing()` tells code that
runs inside `function` (a module's hooks) whether this call is the
backward's rerun: ZeRO-3's gather hooks keep a recomputed block's
parameters gathered through its backward instead of freeing them after
the rerun (distributed/sharded_train.py).
"""
import threading

import torch.utils.checkpoint

from ..amp import current_policy, use_policy

__all__ = ["recompute", "recomputing", "RecomputeSequential"]

_RERUN = threading.local()      # the depth of reruns on this thread


def recomputing():
    """Whether the calling thread is inside a recompute's rerun (the
    backward's second forward of a `recompute`d function)."""
    return getattr(_RERUN, "depth", 0) > 0


def recompute(function, *args, preserve_rng_state=True, use_reentrant=True,
              **kwargs):
    """function(*args, **kwargs), recomputed in the backward instead of
    kept, under the amp policy in force at this call."""
    policy = current_policy()
    calls = [0]

    def run(*a):
        calls[0] += 1
        rerun = calls[0] > 1
        if rerun:
            _RERUN.depth = getattr(_RERUN, "depth", 0) + 1
        try:
            with use_policy(policy):
                return function(*a, **kwargs)
        finally:
            if rerun:
                _RERUN.depth -= 1

    return torch.utils.checkpoint.checkpoint(
        run, *args, use_reentrant=False,
        preserve_rng_state=preserve_rng_state)


class RecomputeSequential:
    """Run `layers` in turn, every `interval`-th one under `recompute`
    (the reference's recompute_interval)."""

    def __init__(self, layers, interval=1):
        self.layers = layers
        self.interval = interval

    def __call__(self, x):
        for i, layer in enumerate(self.layers):
            if self.interval and i % self.interval == 0:
                x = recompute(layer, x)
            else:
                x = layer(x)
        return x
