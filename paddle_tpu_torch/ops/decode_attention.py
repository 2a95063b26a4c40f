"""Decode attention over the dense, flat KV cache: `generate`'s kernel.

`decode_attention` (registry "decode_fused") is q_len == 1 attention of
every batch row over keys 0..off of a flat [B, L, N*H] cache, with one
`off` for all rows; CUDA source `csrc/decode_attention.cu`. It keeps the
JAX signature (paddle_tpu/ops/pallas_decode.py:606) with `off` a host
integer, since the port's decode loop runs on the host. On a CPU tensor
it runs its plain version, `_decode_fallback`'s dense masked attention
in f32; on a CUDA tensor it launches its kernel or raises.
"""
import ctypes
import math
import operator

import torch

from . import _build
from .kernel_registry import get_kernel, register_kernel
from .paged_attention import _DTYPE_CODES, _check_cuda

__all__ = ["decode_attention", "decode_attention_plain",
           "decode_attention_supported"]

_HEAD_DIMS = (64, 128)      # the kernel's template instances
# f32: the JAX registry's declared tolerance; bf16: the port's rule for
# bf16 inputs (8-bit mantissa) against a plain version in f32
_TOL = {"float32": (1e-3, 1e-3), "bfloat16": (2e-2, 2e-2)}


def decode_attention_supported(hidden, n_heads):
    """Whether the card kernel takes this head geometry (head_dim 64 or
    128). `GPTModel.init_cache` refuses a cache off the CPU without it,
    so no decode step on the card can go around the kernel."""
    return hidden % n_heads == 0 and hidden // n_heads in _HEAD_DIMS


def decode_attention_plain(q, k_buf, v_buf, off, n_heads):
    """Dense masked attention in f32 (`_decode_fallback`): q [B, 1, N*H],
    flat k_buf/v_buf [B, L, N*H]; keys 0..off are valid. Returns f32
    [B, 1, N*H]."""
    B, _, nh = q.shape
    N, H = n_heads, nh // n_heads
    L = k_buf.shape[1]
    q4 = q.reshape(B, 1, N, H).float()
    k4 = k_buf.reshape(B, L, N, H).float()
    v4 = v_buf.reshape(B, L, N, H).float()
    logits = torch.einsum("bqnh,bknh->bnqk", q4, k4) * (1.0 / math.sqrt(H))
    key_pos = torch.arange(L, device=q.device)
    logits = logits + torch.where(key_pos <= off, 0.0,
                                  -1e30)[None, None, None, :]
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnqk,bknh->bqnh", probs, v4)
    return out.reshape(B, 1, nh)


@register_kernel(
    "decode_fused", plain=decode_attention_plain, tol=_TOL,
    source="paddle_tpu_torch/csrc/decode_attention.cu",
    replaces="paddle_tpu/ops/pallas_decode.py:606")
def decode_attention(q, k_buf, v_buf, off, n_heads):
    """q [B, 1, N*H]; k_buf/v_buf FLAT [B, L, N*H] (f32 or bf16, each
    independent of q's dtype); off — q's position, a host integer (keys
    0..off are valid). Returns [B, 1, N*H] f32. Does NOT write the cache:
    callers write position off first."""
    off = operator.index(off)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_buf, v_buf, off, n_heads)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    B, one, nh = q.shape
    if one != 1:
        raise ValueError("decode_attention is q_len==1 only")
    for arg, t in (("q", q), ("k_buf", k_buf)):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"decode_attention: {arg} dtype {t.dtype} not "
                            "supported (float32 or bfloat16)")
    if nh % n_heads or nh // n_heads not in _HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {nh / n_heads} not in "
                         f"{_HEAD_DIMS}")
    if k_buf.dim() != 3 or k_buf.shape != v_buf.shape \
            or k_buf.shape[0] != B or k_buf.shape[2] != nh:
        raise ValueError(f"decode_attention: k_buf and v_buf must both be "
                         f"[{B}, L, {nh}], got {tuple(k_buf.shape)} and "
                         f"{tuple(v_buf.shape)}")
    if off < 0:
        raise ValueError(f"decode_attention: off {off} < 0")
    _check_cuda("decode_attention",
                [("q", q), ("k_buf", k_buf), ("v_buf", v_buf)],
                {"v_buf": k_buf.dtype})
    fn, err = _build.launcher(
        "decode_attention", "decode_attention_launch",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_void_p])
    L = k_buf.shape[1]
    H = nh // n_heads
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    rc = fn(q.data_ptr(), k_buf.data_ptr(), v_buf.data_ptr(), out.data_ptr(),
            B, L, n_heads, H, min(off, L - 1), _DTYPE_CODES[q.dtype],
            _DTYPE_CODES[k_buf.dtype], 1.0 / math.sqrt(H),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch("decode_fused", rc, err)
    get_kernel("decode_fused").launches += 1
    return out
