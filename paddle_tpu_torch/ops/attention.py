"""Attention: the dense entry points and the composed math every plain
path of the port shares.

Counterpart of paddle_tpu/ops/attention.py. `flash_attention` and
`scaled_dot_product_attention` keep the reference's dispatch: without
dropout (and without an explicit mask) they run the flash kernels of
`ops/flash_attention.py`, through their autograd Function; with dropout
in training they take the composed path, as the JAX package does for
its kernels, which have no dropout. `composed_attention` is
`_composed_attention`, and also the plain version the paged kernels'
gather+dense fallbacks reduce to.
"""
import math

import torch

from .flash_attention import flash_attention_fwd

__all__ = ["composed_attention", "flash_attention",
           "scaled_dot_product_attention"]


def composed_attention(q, k, v, valid=None, dropout_p=0.0, bias=None):
    """q [b, sq, n, h], k/v [b, sk, n, h] -> [b, sq, n, h] in q's dtype.

    `valid` (bool, broadcastable to [b, n, sq, sk]) marks the keys each
    query may see; `bias` is added to the logits. Logits are q-dtype
    products accumulated in f32 and scaled by 1/sqrt(h); invalid ones
    become -1e30; the softmax runs in f32 and the probs are cast back to
    q's dtype (and dropped out with `dropout_p`) for the value product."""
    k, v = k.to(q.dtype), v.to(q.dtype)
    logits = torch.einsum("bqnh,bknh->bnqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(q.shape[-1]))
    if valid is not None:
        logits = torch.where(valid, logits, -1e30)
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_p > 0.0:
        probs = torch.nn.functional.dropout(probs, p=dropout_p,
                                            training=True)
    return torch.einsum("bnqk,bknh->bqnh", probs, v)


def _causal_valid(q, k):
    sq, sk = q.shape[1], k.shape[1]
    return torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril(
        sk - sq)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    training=True):
    """paddle.nn.functional.flash_attention: q [b, sq, n, h], k/v
    [b, sk, n, h] -> [b, sq, n, h]. The flash kernels when dropout is 0;
    the composed path otherwise (dropout applied only in training)."""
    if dropout == 0.0:
        return flash_attention_fwd(query, key, value, causal=causal)
    return composed_attention(
        query, key, value, _causal_valid(query, key) if causal else None,
        dropout_p=dropout if training else 0.0)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """The flash kernels when there is no mask and no dropout; the
    composed path otherwise (a bool mask marks visible keys, a float
    mask is added to the logits)."""
    if attn_mask is None and dropout_p == 0.0:
        return flash_attention_fwd(query, key, value, causal=is_causal)
    valid = _causal_valid(query, key) if is_causal else None
    bias = None
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            valid = attn_mask if valid is None else valid & attn_mask
        else:
            bias = attn_mask
    return composed_attention(query, key, value, valid,
                              dropout_p=dropout_p if training else 0.0,
                              bias=bias)
