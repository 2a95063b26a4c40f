"""Functionals of the port's nn layer, numerically the JAX package's.

Counterparts: `paddle_tpu/nn/functional/common.py` (linear, embedding),
`activation.py` (gelu), `norm.py` (layer_norm, fused_add_layer_norm) and
`loss.py` (cross_entropy).
"""
import math

import torch

from ..amp import amp_op_dtype, amp_state, maybe_cast_to_compute
from ..ops.layernorm import FusedAddLayerNormPair, layernorm_fused_pair

__all__ = ["linear", "embedding", "gelu", "layer_norm",
           "fused_add_layer_norm", "dropout", "cross_entropy"]


def linear(x, weight, bias=None):
    """y = x @ W + b with W shaped [in, out] (the paddle convention).
    Under amp the operands are cast to the compute dtype first."""
    y = torch.matmul(maybe_cast_to_compute(x, "linear"),
                     maybe_cast_to_compute(weight, "linear"))
    return y if bias is None else y + maybe_cast_to_compute(bias, "linear")


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
    in one call, through the add+LayerNorm kernels of `ops/layernorm.py`
    (the counterpart of the JAX package's `use_pallas_layernorm` route,
    norm.py:248-252). With a gradient wanted it runs the saving kernel
    inside `FusedAddLayerNormPair`; otherwise one launch of the inference
    kernel gives both. f32 moments, one rounding of each output."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, residual, weight, bias)):
        lead, d = x.shape[:-1], x.shape[-1]
        y, h = FusedAddLayerNormPair.apply(
            x.reshape(-1, d).contiguous(),
            residual.reshape(-1, d).contiguous(), weight, bias, epsilon)
        return y.reshape(*lead, d), h.reshape(*lead, d)
    return layernorm_fused_pair(x.contiguous(), residual.contiguous(),
                                weight, bias, epsilon)


def dropout(x, p=0.5, training=True):
    if not training or p == 0.0:
        return x
    return torch.nn.functional.dropout(x, p=p, training=True)


def _log_softmax_amp(logits, dim, op):
    """log_softmax whose sum accumulates in the amp dtype for `op` (f32
    for the black-listed losses) without an f32 copy of the logits."""
    acc = amp_op_dtype(op, logits.dtype)
    if not amp_state().enabled or acc == logits.dtype:
        return torch.log_softmax(logits, dim=dim)
    m = logits.amax(dim=dim, keepdim=True).detach()
    s = torch.sum(torch.exp(logits - m), dim=dim, keepdim=True, dtype=acc)
    return logits - m - torch.log(s).to(logits.dtype)


def cross_entropy(input, label, ignore_index=-100, reduction="mean",  # noqa: A002
                  axis=-1):
    """Hard-label softmax cross entropy (nn/functional/loss.py): labels
    equal to `ignore_index` contribute 0 and are left out of the mean.
    Per-token losses are f32 whatever the logits' dtype."""
    ax = axis % input.dim()
    logp = _log_softmax_amp(input, ax, "cross_entropy")
    idx = label.long()
    if idx.dim() == input.dim() and idx.shape[ax] == 1:
        idx = idx.squeeze(ax)
    valid = idx != ignore_index
    safe = torch.where(valid, idx, 0)
    picked = logp.gather(ax, safe.unsqueeze(ax)).squeeze(ax)
    loss = torch.where(valid, -picked.float(), 0.0)
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp(min=1).to(loss.dtype)
    if reduction == "sum":
        return loss.sum()
    return loss
