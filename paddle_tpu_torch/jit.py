"""TrainStep — the port of paddle_tpu/jit/__init__.py::TrainStep.

The JAX TrainStep traces forward, backward and the optimizer update into
one jitted program. Here the step is eager: clear the gradients, run the
loss, backpropagate, and apply the optimizer's rule to every trainable
parameter of the model (a parameter that received no gradient is
updated with a zero one, as in the JAX step). It returns the loss tensor
without reading it back, so a caller that times a run of steps syncs
once at its end. A model with `collect_moe_stats` (moe.GPTMoE) leaves
its routing-health vector of the step, detached and unread, in
`_last_moe`, as the JAX step does. `torch.compile`, CUDA graphs and the
JAX step's lint, health and resilience options are not carried over.
"""
import torch

__all__ = ["TrainStep"]


class TrainStep:
    def __init__(self, model, loss_fn, optimizer):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.params = [p for p in model.parameters() if p.requires_grad]
        for p in self.params:
            optimizer._get_state(p)
        self._last_moe = None

    def __call__(self, *batch):
        for p in self.params:
            p.grad = None
        loss = self.loss_fn(*batch)
        collect = getattr(self.model, "collect_moe_stats", None)
        mstats = collect() if collect is not None else None
        self._last_moe = None if mstats is None else mstats.detach()
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        self.optimizer.update(self.params, grads)
        return loss.detach()
