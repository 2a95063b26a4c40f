"""Composed attention: the math every plain path of the port shares.

Counterpart of paddle_tpu/ops/attention.py::_composed_attention and of
the gather+dense fallbacks in paddle_tpu/ops/pallas_decode.py. The dense
GPT forward and the plain versions of the paged kernels all reduce to it.
"""
import math

import torch

__all__ = ["composed_attention"]


def composed_attention(q, k, v, valid):
    """q [b, sq, n, h], k/v [b, sk, n, h] -> [b, sq, n, h] in q's dtype.

    `valid` (bool, broadcastable to [b, n, sq, sk]) marks the keys each
    query may see. Logits are q-dtype products accumulated in f32 and
    scaled by 1/sqrt(h); invalid ones become -1e30; the softmax runs in
    f32 and the probs are cast back to q's dtype for the value product."""
    k, v = k.to(q.dtype), v.to(q.dtype)
    logits = torch.einsum("bqnh,bknh->bnqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(q.shape[-1]))
    logits = torch.where(valid, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bnqk,bknh->bqnh", probs, v)
