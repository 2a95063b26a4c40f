"""Optimizer wrappers — the port of paddle_tpu/optimizer/extras.py:
ExponentialMovingAverage, ModelAverage, Lookahead and GradientMerge.

Each is the JAX package's eager state machine over the parameters'
values, with the same signatures, errors and arithmetic (f32 shadows,
sums and slow weights). Where JAX rebinds a parameter's value, the port
copies into the same tensor under `no_grad`, so `jit.TrainStep`,
`distributed.OffloadTrainStep` and the optimizer's state (keyed by the
parameter) keep holding the parameters they were given. A bf16 parameter that Lookahead writes and that has an f32
master restarts its master at the next step (the optimizer's
self-heal), as in the JAX package.
"""
import contextlib

import torch

__all__ = ["ExponentialMovingAverage", "ModelAverage", "Lookahead",
           "GradientMerge"]


def _iterable_not_number(x):
    return isinstance(x, (list, tuple)) or (
        hasattr(x, "__iter__") and not hasattr(x, "__float__"))


@torch.no_grad()
def _write(params, values):
    """Copy `values` into `params` in place, in each parameter's dtype."""
    for p, v in zip(params, values):
        p.copy_(v)


class _Swap:
    """apply() / restore() of averaged weights for evaluation."""

    _backup = None

    @contextlib.contextmanager
    def apply(self, need_restore=True):
        """Swap the averaged weights in; restore on exit."""
        self._backup = [p.detach().clone() for p in self._params]
        _write(self._params, self._averaged())
        try:
            yield self
        finally:
            if need_restore:
                self.restore()

    def restore(self):
        if self._backup is not None:
            _write(self._params, self._backup)
            self._backup = None


class ExponentialMovingAverage(_Swap):
    """Shadow copies: ema = decay ema + (1 - decay) param, with the
    reference's optional bias correction and `thres_steps` scheduling
    (decay = min(decay, (1 + t) / (10 + t))); `update()` after each
    optimizer step. `parameters` is required (there is no default
    program to collect them from)."""

    def __init__(self, decay=0.999, thres_steps=None, name=None,
                 parameters=None, bias_correction=True):
        if _iterable_not_number(decay):
            raise TypeError(
                "ExponentialMovingAverage now follows the reference "
                "signature (decay first); pass the parameter list as "
                "ExponentialMovingAverage(decay, "
                "parameters=model.parameters()) — see MIGRATION.md")
        if parameters is None:
            raise ValueError(
                "ExponentialMovingAverage(parameters=...) is required: "
                "pass model.parameters() (no default-Program var list "
                "exists in the eager/trace world)")
        self._params = list(parameters)
        self._decay = float(decay)
        self._thres_steps = thres_steps
        self._bias = bias_correction
        self._step = 0
        # the product of the decays applied: the bias correction divides
        # by 1 - prod(d_t), which is 1 - decay**step only unscheduled
        self._decay_prod = 1.0
        with torch.no_grad():
            # zero init + debias gives the true average for any initial
            # value; without correction the shadow starts at the params,
            # so apply() before any update() gives the params themselves
            self._shadow = [torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device) if bias_correction
                            else p.detach().float().clone()
                            for p in self._params]

    def _decay_now(self):
        if self._thres_steps is None:
            return self._decay
        t = self._thres_steps
        t = float(t.item() if hasattr(t, "item") else t)
        return min(self._decay, (1.0 + t) / (10.0 + t))

    @torch.no_grad()
    def update(self):
        self._step += 1
        d = self._decay_now()
        self._decay_prod *= d
        torch._foreach_mul_(self._shadow, d)
        torch._foreach_add_(self._shadow, torch._foreach_mul(
            [p.detach().float() for p in self._params], 1.0 - d))

    def _averaged(self):
        if not self._bias:
            return self._shadow
        c = 1.0 - self._decay_prod
        if c <= 0.0:    # apply() before any update(): the raw init
            return self._shadow
        return torch._foreach_div(self._shadow, c)


class ModelAverage(_Swap):
    """Running average of the parameters over a sliding window
    (min/max_average_window, the window growing with
    average_window_rate); `accumulate()` each step, `apply()` swaps the
    averaged weights in for evaluation."""

    def __init__(self, average_window_rate=0.15, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        if _iterable_not_number(average_window_rate):
            raise TypeError(
                "ModelAverage now follows the reference signature (rate "
                "first); pass the parameter list as ModelAverage(rate, "
                "parameters=model.parameters()) — see MIGRATION.md")
        if parameters is None:
            raise ValueError("ModelAverage requires parameters")
        self._params = list(parameters)
        self._rate = average_window_rate
        self._min_w = int(min_average_window)
        self._max_w = int(max_average_window)
        self._sum = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in self._params]
        self._count = 0

    @torch.no_grad()
    def accumulate(self):
        self._count += 1
        window = max(self._min_w,
                     min(self._max_w, int(self._count * self._rate) or 1))
        if self._count > window:
            # the window restarts from half the sum and half the count
            torch._foreach_mul_(self._sum, 0.5)
            self._count = max(1, self._count // 2)
        torch._foreach_add_(self._sum,
                            [p.detach().float() for p in self._params])

    def _averaged(self):
        return torch._foreach_div(self._sum, float(max(self._count, 1)))


class Lookahead:
    """k steps forward, one back: every k `step()`s of the inner
    optimizer the slow weights move slow += alpha (fast - slow) and the
    fast weights are set to them."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        self.inner = inner_optimizer
        self._alpha = float(alpha)
        self._k = int(k)
        self._steps = 0
        self._params = list(inner_optimizer._parameter_list or [])
        # the parameter-list surface of an optimizer, so wrappers nest
        # (GradientMerge(Lookahead(sgd)))
        self._parameter_list = self._params
        self._slow = [p.detach().float().clone() for p in self._params]

    def step(self):
        self.inner.step()
        self._steps += 1
        if self._steps % self._k == 0:
            with torch.no_grad():
                diff = torch._foreach_sub(
                    [p.detach().float() for p in self._params], self._slow)
                torch._foreach_mul_(diff, self._alpha)
                torch._foreach_add_(self._slow, diff)
            _write(self._params, self._slow)

    def clear_grad(self):
        self.inner.clear_grad()

    def get_lr(self):
        return self.inner.get_lr()


class GradientMerge:
    """Gradients summed over k micro-steps, then the inner optimizer
    steps once on their mean (`avg`, else their sum). Call `step()`
    after every backward; the inner optimizer runs on multiples of k."""

    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        self.inner = inner_optimizer
        self._k = int(k_steps)
        self._avg = avg
        self._steps = 0
        self._params = list(inner_optimizer._parameter_list or [])
        self._parameter_list = self._params
        self._acc = [None] * len(self._params)

    @torch.no_grad()
    def step(self):
        self._steps += 1
        for i, p in enumerate(self._params):
            if p.grad is None:
                continue
            g = p.grad
            self._acc[i] = g if self._acc[i] is None else self._acc[i] + g
            p.grad = None
        if self._steps % self._k != 0:
            return
        scale = (1.0 / self._k) if self._avg else 1.0
        for p, a in zip(self._params, self._acc):
            if a is not None:
                p.grad = a * scale
        self.inner.step()
        self.inner.clear_grad()
        self._acc = [None] * len(self._params)

    def clear_grad(self):
        for p in self._params:
            p.grad = None

    def get_lr(self):
        return self.inner.get_lr()
