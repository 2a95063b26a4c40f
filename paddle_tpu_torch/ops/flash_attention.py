"""Flash attention, forward and backward: the training path's kernels.

Counterpart of paddle_tpu/ops/pallas_attention.py. Two kernel wrappers:

- `flash_fwd` (registry "flash_fwd", source `csrc/flash_attention_fwd.cu`)
  replaces the TPU forwards `_flash_fwd` (rectangular grid) and
  `_flash_fwd_tri` (triangle grid): (out, lse) of causal or non-causal
  attention;
- `flash_bwd` (registry "flash_bwd", source `csrc/flash_attention_bwd.cu`)
  replaces the three TPU backwards `_flash_bwd_merged`,
  `_flash_bwd_merged_tri` and `_flash_bwd` (split, above the dq-scratch
  cap): (dq, dk, dv) recomputed from the saved lse.

`FlashAttention` ties them together as an autograd Function, and
`flash_attention_fwd` is the entry the model calls.

Layout is the JAX API's, q [b, sq, n, h] and k/v [b, sk, n, h]; the
kernels read q, k, v and dout through their strides, so the `unbind`
views of a fused qkv projection need no copy. lse is f32 [b*n, sq] (the
TPU kernels' [BN, 8, S] sublane replication is a tiling artifact and is
not carried over). The domain: non-causal with any sk, causal with
offset = sk - sq >= 0 (query i sees keys 0..i+offset, the bottom-right
mask of `attention._composed_attention`), head_dim 64 or 128, f32 or
bf16, any sequence length.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises. The plain versions are the JAX package's
`_ref_fwd_flat` / `_ref_bwd_flat` formulas in f32.
"""
import ctypes
import math

import torch

from . import _build
from .kernel_registry import get_kernel, register_kernel

__all__ = ["flash_attention_fwd", "FlashAttention", "flash_fwd",
           "flash_bwd", "flash_attention_fwd_plain",
           "flash_attention_bwd_plain", "flash_delta_plain"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
# f32: the JAX registry's tolerance for these kernels
# (pallas_attention.py:390, :770); bf16: the kernels round the
# probabilities (and dS in the backward) to bf16 before their products,
# where the plain versions stay in f32 (relative step 2^-8)
_TOL = {"float32": (2e-3, 2e-3), "bfloat16": (2e-2, 2e-2)}


def _causal_mask(sq, sk, device):
    """[sq, sk] bool: query i sees keys 0..i + (sk - sq)."""
    return torch.ones((sq, sk), dtype=torch.bool, device=device).tril(
        sk - sq)


def _logits(q, k, causal, scale):
    s = torch.einsum("bqnh,bknh->bnqk", q.float(), k.float()) * scale
    if causal:
        s = s.masked_fill(~_causal_mask(q.shape[1], k.shape[1], q.device),
                          -1e30)
    return s


def flash_attention_fwd_plain(q, k, v, causal, scale):
    """-> (out [b, sq, n, h] in q's dtype, lse f32 [b*n, sq])."""
    b, sq, n, _ = q.shape
    s = _logits(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bnqk,bknh->bqnh", p / l, v.float())
    lse = (m + torch.log(l))[..., 0].reshape(b * n, sq)
    return out.to(q.dtype), lse


def flash_delta_plain(out, dout):
    """delta = rowsum(dO * O) in f32 -> [b*n, sq], laid out like lse."""
    b, sq, n, _ = out.shape
    return (dout.float() * out.float()).sum(dim=-1).transpose(1, 2) \
        .reshape(b * n, sq)


def flash_attention_bwd_plain(q, k, v, out, lse, dout, causal, scale):
    """Recompute-from-lse backward -> (dq, dk, dv) in the inputs' dtypes:
    delta = rowsum(dO*O), P = exp(S - lse), dV = P^T dO,
    dS = P*(dO V^T - delta), dQ = dS K*scale, dK = dS^T Q*scale."""
    b, sq, n, _ = q.shape
    p = torch.exp(_logits(q, k, causal, scale)
                  - lse.reshape(b, n, sq, 1))
    if causal:
        p = p.masked_fill(~_causal_mask(sq, k.shape[1], q.device), 0.0)
    do = dout.float()
    delta = flash_delta_plain(out, dout).reshape(b, n, sq, 1)
    dv = torch.einsum("bnqk,bqnh->bknh", p, do)
    dp = torch.einsum("bqnh,bknh->bnqk", do, v.float())
    ds = p * (dp - delta)
    dq = torch.einsum("bnqk,bknh->bqnh", ds, k.float()) * scale
    dk = torch.einsum("bnqk,bqnh->bknh", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _argtypes(n_ptrs, n_strides):
    """pointers; b, sq, sk, n, h; strides; causal, dtype, scale, stream"""
    return ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * n_strides
            + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


def _aligned(t):
    """`t` itself when the kernels can read it through its strides (unit
    last stride, 16-byte aligned rows and base, strides falling from the
    batch axis to the head axis as the backward's TMA maps take them),
    else a contiguous copy."""
    st = t.stride()
    ok = (st[-1] == 1 and t.data_ptr() % 16 == 0
          and all(s % 8 == 0 for s in st[:-1]) and st[0] >= st[1] >= st[2])
    return t if ok else t.contiguous()


def _check(name, q, k, v, causal, extra=()):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors are on {q.device} but the "
                         f"current CUDA device is "
                         f"{torch.cuda.current_device()}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {q.dtype} not supported (float32 "
                        "or bfloat16)")
    for arg, t in (("k", k), ("v", v)) + tuple(extra):
        if t.device != q.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected "
                             f"{q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, "
                            f"expected {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or (q.shape[0], q.shape[2], q.shape[3]) \
            != (k.shape[0], k.shape[2], k.shape[3]):
        raise ValueError(f"{name}: q must be [b, sq, n, h] and k, v "
                         f"[b, sk, n, h]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[3] not in _HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {q.shape[3]} not in "
                         f"{_HEAD_DIMS}")
    if causal and k.shape[1] < q.shape[1]:
        raise ValueError(f"{name}: causal attention needs sk >= sq, got "
                         f"sq={q.shape[1]} sk={k.shape[1]}")


def _strides(*ts):
    return [s for t in ts for s in t.stride()[:3]]


@register_kernel(
    "flash_fwd", plain=flash_attention_fwd_plain, tol=_TOL,
    source="paddle_tpu_torch/csrc/flash_attention_fwd.cu",
    replaces="paddle_tpu/ops/pallas_attention.py:461 (K2) and :393 (K1)")
def flash_fwd(q, k, v, causal, scale):
    """Attention forward -> (out [b, sq, n, h] in q's dtype, lse f32
    [b*n, sq])."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, scale)
    _check("flash_fwd", q, k, v, causal)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    b, sq, n, h = q.shape
    sk = k.shape[1]
    out = torch.empty((b, sq, n, h), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * n, sq), dtype=torch.float32, device=q.device)
    fn, err = _build.launcher("flash_attention_fwd",
                              "flash_attention_fwd_launch", _argtypes(5, 9))
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, sq, sk, n, h, *_strides(q, k, v),
            int(bool(causal)), _DTYPE_CODES[q.dtype], float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch("flash_fwd", rc, err)
    get_kernel("flash_fwd").launches += 1
    return out, lse


@register_kernel(
    "flash_bwd", plain=flash_attention_bwd_plain, tol=_TOL,
    source="paddle_tpu_torch/csrc/flash_attention_bwd.cu",
    replaces="paddle_tpu/ops/pallas_attention.py:855 (K4), :774 (K3) "
             "and :922 (K5)")
def flash_bwd(q, k, v, out, lse, dout, causal, scale):
    """Attention backward from the forward's out and lse -> (dq, dk, dv)
    shaped and typed like q, k, v."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, causal,
                                         scale)
    _check("flash_bwd", q, k, v, causal,
           extra=(("out", out), ("dout", dout)))
    b, sq, n, h = q.shape
    sk = k.shape[1]
    if out.shape != q.shape or dout.shape != q.shape \
            or tuple(lse.shape) != (b * n, sq) \
            or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("flash_bwd: out and dout must be shaped like q and "
                         f"lse a contiguous f32 [{b * n}, {sq}]")
    q, k, v, out, dout = (_aligned(t) for t in (q, k, v, out, dout))
    # delta = rowsum(dO * O), f32 [b*n, sq]: the launch's first kernel
    # fills it
    delta = torch.empty((b * n, sq), dtype=torch.float32, device=q.device)
    dq = torch.empty((b, sq, n, h), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, n, h), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, sk, n, h), dtype=q.dtype, device=q.device)
    fn, err = _build.launcher("flash_attention_bwd",
                              "flash_attention_bwd_launch", _argtypes(10, 15))
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, sq, sk, n, h,
            *_strides(q, k, v, dout, out),
            int(bool(causal)), _DTYPE_CODES[q.dtype], float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch("flash_bwd", rc, err)
    get_kernel("flash_bwd").launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """out = attention(q, k, v); saves q, k, v, out and lse, and
    backpropagates through `flash_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, dout, ctx.causal,
                               ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """q [b, sq, n, h], k/v [b, sk, n, h] -> out [b, sq, n, h]; through
    the autograd Function when a gradient is wanted, else the forward
    kernel alone."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, scale)
    return flash_fwd(q, k, v, causal, scale)[0]
