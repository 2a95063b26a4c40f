"""Gradient clipping — the port of paddle_tpu/nn/clip.py.

The clips take and return (param, grad) lists, as the optimizer and
`jit.TrainStep` hand them over; a None gradient passes through. A
parameter whose `need_clip` attribute is False keeps its gradient and
stays out of the global norm. `ClipGradByGlobalNorm` sums the squares of
every gradient in f32 and scales each by `clip / max(norm, clip)` cast
to the gradient's dtype; `ClipGradByNorm` clips each gradient by its own
norm, in the gradient's dtype; `ClipGradByValue` clamps. The norms come
from `torch._foreach_norm` (one fused reduction over the list), whose
square differs from the reference's f32 sum of squares by at most an
ulp. `clip_grad_norm_` scales `p.grad` of the given parameters in place
and returns the total norm.
"""
import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "GradientClipByValue",
           "GradientClipByNorm", "GradientClipByGlobalNorm", "need_clip",
           "clip_by_norm", "clip_grad_norm_"]


def clip_by_norm(g, norm, clip_norm):
    """`g` scaled by clip_norm / norm where its norm exceeds clip_norm:
    ClipGradByNorm's rule for one gradient (or one piece of it) whose
    whole norm is `norm` (a 0-dim tensor)."""
    return torch.where(norm > clip_norm,
                       g * (clip_norm / norm.clamp(min=1e-12)), g)


def need_clip(p):
    """Whether the clips touch `p`'s gradient (`p.need_clip`, default
    True)."""
    return getattr(p, "need_clip", True)


class ClipGradBase:
    def __call__(self, params_grads):
        return self._dygraph_clip(list(params_grads))


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):  # noqa: A002
        self.max = max
        self.min = -max if min is None else min

    def _dygraph_clip(self, params_grads):
        return [(p, g if g is None else g.clamp(self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def _dygraph_clip(self, params_grads):
        live = [g for _, g in params_grads if g is not None]
        norms = iter(torch._foreach_norm(live, 2.0)) if live else iter(())
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            out.append((p, clip_by_norm(g, next(norms), self.clip_norm)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def _global_norm(self, grads):
        """sqrt of the f32 sum of every gradient's sum of squares."""
        norms = torch._foreach_norm(grads, 2.0, dtype=torch.float32)
        return torch.stack(norms).square().sum().sqrt()

    def _dygraph_clip(self, params_grads):
        grads = [g for p, g in params_grads
                 if g is not None and need_clip(p)]
        if not grads:
            return params_grads
        norm = self._global_norm(grads)
        scale = self.clip_norm / torch.clamp(norm, min=self.clip_norm)
        return [(p, g) if g is None or not need_clip(p)
                else (p, g * scale.to(g.dtype)) for p, g in params_grads]


GradientClipByValue = ClipGradByValue
GradientClipByNorm = ClipGradByNorm
GradientClipByGlobalNorm = ClipGradByGlobalNorm


def clip_grad_norm_(parameters, max_norm, norm_type=2.0):
    """Scale the gradients of `parameters` so that their total
    `norm_type`-norm is at most `max_norm` (coefficient
    min(max_norm / (total + 1e-6), 1)); returns the total norm."""
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    parameters = list(parameters)
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max() for g in grads]).max()
    else:
        total = torch.stack([(g.abs() ** norm_type).sum()
                             for g in grads]).sum() ** (1.0 / norm_type)
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    with torch.no_grad():
        for g in grads:
            g.mul_(coef.to(g.dtype))
    return total
