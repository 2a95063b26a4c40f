"""Optimizers — the port of paddle_tpu/optimizer/optimizer.py (the base,
Adam and AdamW).

The update rule is the JAX package's, in the same order of operations:
f32 gradients and moments; a per-parameter `beta_pow` that starts at
beta and is multiplied by beta after each step (an f32 scalar, kept on
the host so the bias correction needs no device sync); L2 decay added to
the gradient (Adam) or decoupled decay `p * (1 - lr * wd)` applied to
the parameter before the Adam update (AdamW), to every parameter. The
update runs over all parameters at once with `torch._foreach_*` ops.

Not carried over yet: learning-rate schedules (`optimizer/lr.py`; the
rate is a float), gradient clipping, per-parameter groups and decay
filters, and f32 master copies of low-precision parameters (a bf16
parameter is updated in f32 and rounded back).
"""
import numpy as np
import torch

__all__ = ["Optimizer", "Adam", "AdamW"]


class Optimizer:
    # True for decoupled decay (AdamW)
    _decoupled_weight_decay = False

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None):
        self._parameter_list = list(parameters) \
            if parameters is not None else None
        self._learning_rate = float(learning_rate)
        self._weight_decay = float(weight_decay or 0.0)
        self._states = {}

    def get_lr(self):
        return self._learning_rate

    def _get_state(self, p):
        st = self._states.get(id(p))
        if st is None:
            st = self._states[id(p)] = self._init_state(p)
        return st

    def _init_state(self, p):
        return {}

    def _apply(self, params, grads, states, lr):
        """The update rule over f32 parameter and gradient lists,
        in place on `params`; subclasses define it."""
        raise NotImplementedError

    @torch.no_grad()
    def update(self, params, grads):
        """One step over `params` with `grads` (same order): the JAX
        package's `_functional_apply`."""
        lr = self.get_lr()
        wd = self._weight_decay
        work = [p if p.dtype == torch.float32 else p.float()
                for p in params]
        g32 = [g if g.dtype == torch.float32 else g.float() for g in grads]
        if wd and not self._decoupled_weight_decay:
            g32 = torch._foreach_add(g32, work, alpha=wd)
        if wd and self._decoupled_weight_decay:
            torch._foreach_mul_(work, 1.0 - lr * wd)
        self._apply(work, g32, [self._get_state(p) for p in params], lr)
        for p, w in zip(params, work):
            if w is not p:
                p.copy_(w)

    def step(self):
        """Eager step over the parameters that have a gradient."""
        pairs = [(p, p.grad) for p in self._parameter_list or ()
                 if p.grad is not None]
        if pairs:
            self.update(*map(list, zip(*pairs)))

    def clear_grad(self):
        for p in self._parameter_list or ():
            p.grad = None


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None):
        super().__init__(learning_rate, parameters, weight_decay)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _init_state(self, p):
        z = dict(dtype=torch.float32, device=p.device)
        return {"moment1": torch.zeros(p.shape, **z),
                "moment2": torch.zeros(p.shape, **z),
                "beta1_pow": np.float32(self._beta1),
                "beta2_pow": np.float32(self._beta2)}

    def _apply(self, params, grads, states, lr):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m = [st["moment1"] for st in states]
        v = [st["moment2"] for st in states]
        # m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, grads, grads, value=1 - b2)
        one = np.float32(1)
        mhat = torch._foreach_div(
            m, [float(one - st["beta1_pow"]) for st in states])
        vhat = torch._foreach_div(
            v, [float(one - st["beta2_pow"]) for st in states])
        # p -= lr * mhat / (sqrt(vhat) + eps)
        torch._foreach_sqrt_(vhat)
        torch._foreach_add_(vhat, eps)
        torch._foreach_mul_(mhat, lr)
        torch._foreach_div_(mhat, vhat)
        torch._foreach_sub_(params, mhat)
        for st in states:
            st["beta1_pow"] = st["beta1_pow"] * np.float32(b1)
            st["beta2_pow"] = st["beta2_pow"] * np.float32(b2)


class AdamW(Adam):
    """Adam with decoupled weight decay."""

    _decoupled_weight_decay = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay)
