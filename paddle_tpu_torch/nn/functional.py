"""Functionals of the port's nn layer, numerically the JAX package's.

Counterparts: `paddle_tpu/nn/functional/common.py` (linear, embedding),
`activation.py` (gelu) and `norm.py` (layer_norm, fused_add_layer_norm).
"""
import math

import torch

__all__ = ["linear", "embedding", "gelu", "layer_norm",
           "fused_add_layer_norm", "dropout"]


def linear(x, weight, bias=None):
    """y = x @ W + b with W shaped [in, out] (the paddle convention)."""
    y = torch.matmul(x, weight)
    return y if bias is None else y + bias


def embedding(ids, weight):
    """Row lookup. Indices are clipped into range like the JAX gather
    (`jnp.take` on a clipped index), so a padded position past the
    table reads its last row instead of faulting."""
    idx = ids.long().clamp(0, weight.shape[0] - 1)
    return weight[idx]


def gelu(x):
    """Tanh-approximate GELU, as jax.nn.gelu(approximate=True) computes
    it (the form GPT's MLP uses)."""
    c = math.sqrt(2.0 / math.pi)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * x * x)))))


def _normalize(h, epsilon):
    # f32 moments, elementwise math in the input dtype — the composed
    # path of nn/functional/norm.py (no f32 copy of the stream)
    mean = h.mean(dim=-1, keepdim=True, dtype=torch.float32)
    d = h - mean.to(h.dtype)
    var = (d * d).mean(dim=-1, keepdim=True, dtype=torch.float32)
    return d * torch.rsqrt(var + epsilon).to(h.dtype)


def _scale_shift(x, weight, bias):
    return x * weight.to(x.dtype) + bias.to(x.dtype)


def layer_norm(x, weight, bias, epsilon=1e-5):
    """LayerNorm over the last dim with the JAX package's numerics."""
    return _scale_shift(_normalize(x, epsilon), weight, bias)


def fused_add_layer_norm(x, residual, weight, bias, epsilon=1e-5):
    """(LayerNorm(x + residual), x + residual): the pre-LN residual site
    in one call, the composed math of nn/functional/norm.py:256-263."""
    h = x + residual
    return _scale_shift(_normalize(h, epsilon), weight, bias), h


def dropout(x, p=0.5, training=True):
    if not training or p == 0.0:
        return x
    return torch.nn.functional.dropout(x, p=p, training=True)
