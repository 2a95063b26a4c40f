"""Residual add + LayerNorm: the transformer block's `_add_ln2` site.

Counterpart of paddle_tpu/ops/pallas_layernorm.py. Two kernels in one
CUDA source (`csrc/add_layer_norm.cu`):

- `layernorm_fwd_saved` (registry "layernorm_fwd_saved") replaces the
  TPU kernel `_fwd`: (out, the f32 sum x + r, f32 rstd [rows, 1]), the
  forward the backward needs, and with `carry=True` also the residual
  carry x + r in x's dtype, written by the same launch;
- `layernorm_fused` (registry "layernorm_fused") replaces the TPU kernel
  `fused_add_layer_norm`: out only, for inference. Its kernel also
  writes the residual carry: `layernorm_fused_pair` returns (out,
  x + r) from that one launch, the inference form of the JAX pair
  `fused_add_layer_norm_pair`, and counts as one `layernorm_fused`
  launch.

`FusedAddLayerNormPair` is the autograd Function of
`fused_add_layer_norm_pair`: it returns (LayerNorm(x + r), x + r) from one
launch of the saving kernel, and its backward is the JAX package's
`_pair_vjp_bwd` in plain torch (the JAX backward is jnp, not a kernel).

The plain version copies `_ln_ref`: f32 moments and one rounding of the
output to x's dtype; the carry is the f32 sum rounded once to x's dtype,
bit for bit `(x + residual).to(x.dtype)`. x and residual are [rows, d]
(any row count; d up to 4096 for the saving kernel and up to 5120 for
the inference kernel, which gives a row wider than 4096 a CTA; the pair
also takes [..., d]), each f32 or bf16; weight and bias [d]. On a CPU
tensor the wrappers run the plain version; on a CUDA tensor they launch
the kernel or raise.
"""
import ctypes

import torch

from . import _build
from .kernel_registry import get_kernel, randn, register_kernel

__all__ = ["layernorm_fwd_saved", "layernorm_fused", "layernorm_fused_pair",
           "layernorm_plain", "layernorm_fused_plain",
           "layernorm_fused_pair_plain", "pair_warps",
           "FusedAddLayerNormPair"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the widest row each kernel takes: the saving form (training) 4096, the
# inference form 5120 (GPT-3 13B's hidden size)
_MAX_D = {"layernorm_fwd_saved": 4096, "layernorm_fused": 5120}
# f32: the JAX registry's tolerance (pallas_layernorm.py:97, :146); bf16:
# the output rounds to bf16 once, so a 1-ulp flip (relative 2^-8) between
# two f32 orders of summation is the largest expected difference
_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (1e-2, 1e-2)}


def layernorm_plain(x, residual, weight, bias, eps=1e-5, carry=False):
    """-> (out [rows, d] in x's dtype, sum f32 [rows, d], rstd f32
    [rows, 1]), and with `carry` the sum in x's dtype (the sum itself
    for an f32 x) after them."""
    s = x.float() + residual.float()
    mean = s.mean(dim=-1, keepdim=True)
    var = (s - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    out = (s - mean) * rstd * weight.float() + bias.float()
    if carry:
        return out.to(x.dtype), s, rstd, s.to(x.dtype)
    return out.to(x.dtype), s, rstd


def layernorm_fused_plain(x, residual, weight, bias, eps=1e-5):
    return layernorm_plain(x, residual, weight, bias, eps)[0]


def layernorm_fused_pair_plain(x, residual, weight, bias, eps=1e-5):
    """-> (out, the carry x + residual), both in x's dtype."""
    out, s, _ = layernorm_plain(x, residual, weight, bias, eps)
    return out, s.to(x.dtype)


# The inference kernel's launch: rows a CTA (one warp a row) and whether
# it is launched as a programmatic dependent of the kernel before it.
# Module globals read at every launch, so kernel_ab.py can sweep them.
PDL = True


def pair_warps(rows):
    """Rows a CTA of the inference kernel: one while the rows fit the
    card's 132 SMs a warp each, so a decode step's 8-16 rows spread over
    8-16 SMs; four above that, so long row counts keep whole SMs busy.
    A row wider than 4096 takes a CTA of its own whatever this says."""
    return 1 if rows <= 132 else 4


_ARGTYPES = {
    "add_layer_norm_launch": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_void_p],
    "add_layer_norm_pair_launch": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}
_launchers = {}     # symbol -> (launch function, error string)


def _launcher(symbol):
    """The source's launch function `symbol`, looked up once a process."""
    got = _launchers.get(symbol)
    if got is None:
        got = _launchers[symbol] = _build.launcher(
            "add_layer_norm", symbol, _ARGTYPES[symbol])
    return got


def _raw_stream(index):
    """The current CUDA stream of device `index` as an int (cudaStream_t),
    without building a torch.cuda.Stream object."""
    return torch._C._cuda_getCurrentRawStream(index)


def _check(name, x, residual, weight, bias, rows_2d):
    """Raise unless the arguments are what the kernels take: x and
    residual [rows, d] (with `rows_2d` False, [..., d]) of one shape,
    weight and bias [d] of one dtype, all contiguous, f32 or bf16, on
    the current CUDA device; -> its index. One expression answers the
    common case; `_explain` finds what failed."""
    index = torch.cuda.current_device() if x.is_cuda else None
    d = x.shape[-1] if x.dim() else 0
    if (x.is_cuda and x.get_device() == index
            and residual.get_device() == index
            and weight.get_device() == index and bias.get_device() == index
            and x.dtype in _DTYPE_CODES and residual.dtype in _DTYPE_CODES
            and weight.dtype in _DTYPE_CODES and bias.dtype == weight.dtype
            and x.is_contiguous() and residual.is_contiguous()
            and weight.is_contiguous() and bias.is_contiguous()
            and residual.shape == x.shape and weight.shape == (d,)
            and bias.shape == (d,) and 0 < d <= _MAX_D[name]
            and (x.dim() == 2 if rows_2d else x.dim() >= 2)):
        return index
    _explain(name, x, residual, weight, bias, index, rows_2d)


def _explain(name, x, residual, weight, bias, index, rows_2d):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if dev.index != index:
        raise ValueError(f"{name}: tensors are on {dev} but the current "
                         f"CUDA device is {index}")
    for arg, t in (("x", x), ("residual", residual), ("weight", weight),
                   ("bias", bias)):
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected "
                             f"{dev}")
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype} (float32 "
                            "or bfloat16 expected)")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    raise ValueError(f"{name}: x and residual must be "
                     f"{'[rows, d]' if rows_2d else '[..., d]'} of one "
                     f"shape with d <= {_MAX_D[name]}, weight and bias [d] "
                     f"of one dtype; got {tuple(x.shape)}, "
                     f"{tuple(residual.shape)}, "
                     f"{tuple(weight.shape)} {weight.dtype}, "
                     f"{tuple(bias.shape)} {bias.dtype}")


def _launch_saved(x, residual, weight, bias, eps, carry):
    """The saving kernel (K6) -> (out, sum, rstd), and with `carry` the
    carry after them: written by the same launch for a bf16 x, the sum
    itself for an f32 x."""
    name = "layernorm_fwd_saved"
    index = _check(name, x, residual, weight, bias, rows_2d=True)
    rows, d = x.shape
    fn, err = _launcher("add_layer_norm_launch")
    out = torch.empty_like(x)
    s = torch.empty((rows, d), dtype=torch.float32, device=x.device)
    rstd = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    h = torch.empty_like(x) if carry and x.dtype != torch.float32 else None
    rc = fn(x.data_ptr(), residual.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), out.data_ptr(), s.data_ptr(), rstd.data_ptr(),
            None if h is None else h.data_ptr(), rows, d,
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[residual.dtype],
            _DTYPE_CODES[weight.dtype], float(eps), _raw_stream(index))
    _build.check_launch(name, rc, err)
    get_kernel(name).launches += 1
    if carry:
        return out, s, rstd, s if h is None else h
    return out, s, rstd


def _launch_pair(x, residual, weight, bias, eps, carry):
    """The inference kernel (K7) -> (out, the carry or None), each shaped
    as x."""
    name = "layernorm_fused"
    index = _check(name, x, residual, weight, bias, rows_2d=False)
    fn, err = _launcher("add_layer_norm_pair_launch")
    d = x.shape[-1]
    rows = x.numel() // d
    out = torch.empty_like(x)
    h = torch.empty_like(x) if carry else None
    rc = fn(x.data_ptr(), residual.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), out.data_ptr(), h.data_ptr() if carry else None,
            rows, d, _DTYPE_CODES[x.dtype], _DTYPE_CODES[residual.dtype],
            _DTYPE_CODES[weight.dtype], float(eps), pair_warps(rows),
            1 if PDL else 0, _raw_stream(index))
    _build.check_launch(name, rc, err)
    get_kernel(name).launches += 1
    return out, h


# the kernel observatory's examples: the main paths' shapes — GPT-3
# 125M training's saving site (24 x 1024 rows of 768, x f32, residual
# bf16, f32 weights under amp) and the serving decode step's pair (16
# rows of 768 in bf16); `small` cuts the rows
def _ln_example(rng, device, rows, dts):
    d = 768
    x, r = (randn(rng, (rows, d), dt, device) for dt in dts[:2])
    w = (1.0 + 0.1 * randn(rng, (d,), torch.float32, device)).to(dts[2])
    b = (0.1 * randn(rng, (d,), torch.float32, device)).to(dts[2])
    return (x, r, w, b)


def layernorm_saved_example(rng, device="cpu", small=False):
    return _ln_example(rng, device, 64 if small else 24576,
                       (torch.float32, torch.bfloat16, torch.float32))


def layernorm_fused_example(rng, device="cpu", small=False):
    return _ln_example(rng, device, 16, (torch.bfloat16,) * 3)


def ln_work(rows, d, x_size, r_size, w_size, save, carry=False):
    """(operations, bytes) of add + LayerNorm: x, r, w, b in, out in x's
    dtype (and the f32 sum and rstd, or the carry in x's dtype) out;
    ~8 operations per element."""
    nbytes = rows * d * (2 * x_size + r_size) + 2 * d * w_size
    if save:
        nbytes += rows * d * 4 + rows * 4
    if carry:
        nbytes += rows * d * x_size
    return 8 * rows * d, nbytes


def _ln_cost(args, save):
    x, r, w = args[:3]
    carry = save and len(args) > 5 and bool(args[5])
    return ln_work(x.shape[0], x.shape[1], x.element_size(),
                   r.element_size(), w.element_size(), save, carry)


def layernorm_saved_cost(args):
    return _ln_cost(args, True)


def layernorm_fused_cost(args):
    return _ln_cost(args, False)


@register_kernel(
    "layernorm_fwd_saved", plain=layernorm_plain, tol=_TOL,
    source="paddle_tpu_torch/csrc/add_layer_norm.cu",
    replaces="paddle_tpu/ops/pallas_layernorm.py:90",
    example=layernorm_saved_example, cost=layernorm_saved_cost)
def layernorm_fwd_saved(x, residual, weight, bias, eps=1e-5, carry=False):
    """LayerNorm(x + residual) with what the backward needs -> (out in
    x's dtype, sum f32 [rows, d], rstd f32 [rows, 1]), and with `carry`
    the residual carry x + residual in x's dtype after them, from the
    same launch."""
    if x.device.type == "cpu":
        return layernorm_plain(x, residual, weight, bias, eps, carry)
    return _launch_saved(x, residual, weight, bias, eps, carry)


@register_kernel(
    "layernorm_fused", plain=layernorm_fused_plain, tol=_TOL,
    source="paddle_tpu_torch/csrc/add_layer_norm.cu",
    replaces="paddle_tpu/ops/pallas_layernorm.py:141",
    example=layernorm_fused_example, cost=layernorm_fused_cost)
def layernorm_fused(x, residual, weight, bias, eps=1e-5):
    """LayerNorm(x + residual) * weight + bias -> [rows, d] in x's
    dtype."""
    if x.device.type == "cpu":
        return layernorm_fused_plain(x, residual, weight, bias, eps)
    return _launch_pair(x, residual, weight, bias, eps, carry=False)[0]


def layernorm_fused_pair(x, residual, weight, bias, eps=1e-5):
    """(LayerNorm(x + residual) * weight + bias, x + residual), both in
    x's dtype and shape, from one launch of the `layernorm_fused` kernel
    (counted as one launch of it). x and residual are [..., d], so the
    residual site passes its [batch, seq, d] tensors as they are."""
    if x.device.type == "cpu":
        return layernorm_fused_pair_plain(x, residual, weight, bias, eps)
    return _launch_pair(x, residual, weight, bias, eps, carry=True)


class FusedAddLayerNormPair(torch.autograd.Function):
    """(LayerNorm(x + r) * w + b, x + r) for x, r [rows, d], both from
    one launch of the saving kernel; the carry is the saved f32 sum in
    x's dtype."""

    @staticmethod
    def forward(ctx, x, residual, weight, bias, eps):
        out, s, rstd, h = layernorm_fwd_saved(x, residual, weight, bias, eps,
                                              carry=True)
        ctx.save_for_backward(s, rstd, weight)
        ctx.dtypes = (x.dtype, residual.dtype, bias.dtype)
        return out, h

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
