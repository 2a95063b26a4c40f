"""Residual add + LayerNorm: the transformer block's `_add_ln2` site.

Counterpart of paddle_tpu/ops/pallas_layernorm.py. Two kernel wrappers
over one CUDA source (`csrc/add_layer_norm.cu`):

- `layernorm_fwd_saved` (registry "layernorm_fwd_saved") replaces the
  TPU kernel `_fwd`: (out, the f32 sum x + r, f32 rstd [rows, 1]), the
  forward the backward needs;
- `layernorm_fused` (registry "layernorm_fused") replaces the TPU kernel
  `fused_add_layer_norm`: out only, for inference.

`FusedAddLayerNormPair` is the autograd Function of
`fused_add_layer_norm_pair`: it returns (LayerNorm(x + r), x + r) from the
saving kernel, and its backward is the JAX package's `_pair_vjp_bwd` in
plain torch (the JAX backward is jnp, not a kernel).

The plain version copies `_ln_ref`: f32 moments and one rounding of the
output to x's dtype. x and residual are [rows, d] (any row count, d up
to 4096), each f32 or bf16; weight and bias [d]. On a CPU tensor the
wrappers run the plain version; on a CUDA tensor they launch the kernel
or raise.
"""
import ctypes

import torch

from . import _build
from .kernel_registry import get_kernel, register_kernel

__all__ = ["layernorm_fwd_saved", "layernorm_fused", "layernorm_plain",
           "layernorm_fused_plain", "FusedAddLayerNormPair"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 4096
# f32: the JAX registry's tolerance (pallas_layernorm.py:97, :146); bf16:
# the output rounds to bf16 once, so a 1-ulp flip (relative 2^-8) between
# two f32 orders of summation is the largest expected difference
_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (1e-2, 1e-2)}


def layernorm_plain(x, residual, weight, bias, eps=1e-5):
    """-> (out [rows, d] in x's dtype, sum f32 [rows, d], rstd f32
    [rows, 1])."""
    s = x.float() + residual.float()
    mean = s.mean(dim=-1, keepdim=True)
    var = (s - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    out = (s - mean) * rstd * weight.float() + bias.float()
    return out.to(x.dtype), s, rstd


def layernorm_fused_plain(x, residual, weight, bias, eps=1e-5):
    return layernorm_plain(x, residual, weight, bias, eps)[0]


def _launch(name, x, residual, weight, bias, eps, save):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors are on {x.device} but the "
                         f"current CUDA device is "
                         f"{torch.cuda.current_device()}")
    rows, d = x.shape
    for arg, t in (("x", x), ("residual", residual), ("weight", weight),
                   ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected "
                             f"{x.device}")
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype} (float32 "
                            "or bfloat16 expected)")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if x.dim() != 2 or residual.shape != x.shape \
            or tuple(weight.shape) != (d,) or tuple(bias.shape) != (d,) \
            or weight.dtype != bias.dtype or not 0 < d <= _MAX_D:
        raise ValueError(f"{name}: x and residual must be [rows, d] with "
                         f"d <= {_MAX_D}, weight and bias [d] of one "
                         f"dtype; got {tuple(x.shape)}, "
                         f"{tuple(residual.shape)}, {tuple(weight.shape)}, "
                         f"{tuple(bias.shape)}")
    fn, err = _build.launcher(
        "add_layer_norm", "add_layer_norm_launch",
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p])
    out = torch.empty_like(x)
    s = rstd = None
    if save:
        s = torch.empty((rows, d), dtype=torch.float32, device=x.device)
        rstd = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    rc = fn(x.data_ptr(), residual.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), out.data_ptr(), s.data_ptr() if save else None,
            rstd.data_ptr() if save else None, rows, d,
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[residual.dtype],
            _DTYPE_CODES[weight.dtype], float(eps),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(name, rc, err)
    get_kernel(name).launches += 1
    return out, s, rstd


@register_kernel(
    "layernorm_fwd_saved", plain=layernorm_plain, tol=_TOL,
    source="paddle_tpu_torch/csrc/add_layer_norm.cu",
    replaces="paddle_tpu/ops/pallas_layernorm.py:90")
def layernorm_fwd_saved(x, residual, weight, bias, eps=1e-5):
    """LayerNorm(x + residual) with what the backward needs -> (out in
    x's dtype, sum f32 [rows, d], rstd f32 [rows, 1])."""
    if x.device.type == "cpu":
        return layernorm_plain(x, residual, weight, bias, eps)
    return _launch("layernorm_fwd_saved", x, residual, weight, bias, eps,
                   save=True)


@register_kernel(
    "layernorm_fused", plain=layernorm_fused_plain, tol=_TOL,
    source="paddle_tpu_torch/csrc/add_layer_norm.cu",
    replaces="paddle_tpu/ops/pallas_layernorm.py:141")
def layernorm_fused(x, residual, weight, bias, eps=1e-5):
    """LayerNorm(x + residual) * weight + bias -> [rows, d] in x's
    dtype."""
    if x.device.type == "cpu":
        return layernorm_fused_plain(x, residual, weight, bias, eps)
    return _launch("layernorm_fused", x, residual, weight, bias, eps,
                   save=False)[0]


class FusedAddLayerNormPair(torch.autograd.Function):
    """(LayerNorm(x + r) * w + b, x + r) for x, r [rows, d]; the carry is
    the saved f32 sum in x's dtype."""

    @staticmethod
    def forward(ctx, x, residual, weight, bias, eps):
        out, s, rstd = layernorm_fwd_saved(x, residual, weight, bias, eps)
        ctx.save_for_backward(s, rstd, weight)
        ctx.dtypes = (x.dtype, residual.dtype, bias.dtype)
        return out, s.to(x.dtype)

    @staticmethod
    def backward(ctx, g_out, g_sum):
        s, rstd, weight = ctx.saved_tensors
        x_dt, r_dt, b_dt = ctx.dtypes
        g32 = g_out.float()
        mean = s.mean(dim=-1, keepdim=True)
        norm = (s - mean) * rstd
        d_norm = g32 * weight.float()
        ds = (d_norm - d_norm.mean(dim=-1, keepdim=True)
              - norm * (d_norm * norm).mean(dim=-1, keepdim=True)) * rstd
        # the carry's cotangent flows straight into the sum
        ds = ds + g_sum.float()
        dw = (g32 * norm).sum(dim=0)
        db = g32.sum(dim=0)
        dx = ds.to(g_out.dtype)
        return (dx.to(x_dt), dx.to(r_dt), dw.to(weight.dtype), db.to(b_dt),
                None)
