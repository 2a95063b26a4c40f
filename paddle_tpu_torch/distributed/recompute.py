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
only: the checkpoint never reenters.
"""
import torch.utils.checkpoint

from ..amp import current_policy, use_policy

__all__ = ["recompute", "RecomputeSequential"]


def recompute(function, *args, preserve_rng_state=True, use_reentrant=True,
              **kwargs):
    """function(*args, **kwargs), recomputed in the backward instead of
    kept, under the amp policy in force at this call."""
    policy = current_policy()

    def run(*a):
        with use_policy(policy):
            return function(*a, **kwargs)

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
