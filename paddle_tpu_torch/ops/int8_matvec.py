"""The int8-weight matvec of the weight-only-int8 LM head.

`int8_matvec` (registry "int8_matvec") computes h [B, D] times an int8
table wq [V, D] with per-row f32 scales, as f32 [B, V] logits, without
ever materializing the dequantized table; CUDA source
`csrc/int8_matvec.cu`. Counterpart of paddle_tpu/ops/pallas_int8.py:78.
On a CPU tensor it runs its plain version, `_matvec_fallback`'s
bf16-rounded product accumulated in f32; on a CUDA tensor it launches
its kernel or raises. Inference only: it has no backward, so the head
takes it only when no gradient can flow (models/gpt.py).
"""
import ctypes

import numpy as np
import torch

from . import _build
from .kernel_registry import get_kernel, randn, register_kernel
from .paged_attention import _DTYPE_CODES, _check_cuda

__all__ = ["int8_matvec", "int8_matvec_plain", "int8_matvec_preferred"]

# pad target of a quantized embedding table's rows (quant/wo8.py): part
# of the weights' shape, so tables quantized by the JAX package load
# as they are; the CUDA kernel itself takes any V
_BLOCK_V = 1024
# the rounding is the same in every dtype (h to bf16, exact products, f32
# sums); only the order of summation differs: the JAX registry's tol
_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-4, 1e-4)}


def int8_matvec_preferred(rows, device):
    """Whether the quantized head takes the kernel for `rows` rows on
    `device`: decode-sized row counts on the card. The 64 is the JAX
    package's v5e bound, kept as it is; PERF.md holds the kernel against
    the composed product and the dequantized bf16 matmul at 1..128 rows
    on the H100."""
    return torch.device(device).type == "cuda" and rows <= 64


def int8_matvec_plain(h, wq, scale):
    """h rounded to bf16, times the int8 table, accumulated in f32 and
    scaled per row (`_matvec_fallback`): products of bf16 values are
    exact in f32, so an f32 product is the same arithmetic."""
    hh = h.to(torch.bfloat16).float()
    return torch.matmul(hh, wq.float().t()) * scale.float()[None, :]


# the kernel observatory's example: generate's int8 head on GPT-3 125M
# (8 rows of 768 over the vocab padded to 51200, bf16 rows, f32
# scales); `small` cuts the vocab to 1024
def int8_matvec_example(rng, device="cpu", small=False):
    B, D, V = 8, 768, 1024 if small else 51200
    wq = torch.from_numpy(rng.integers(-127, 128, size=(V, D),
                                       dtype=np.int8)).to(device)
    scale = (0.01 * (1.0 + rng.random(V, dtype=np.float32)))
    return (randn(rng, (B, D), torch.bfloat16, device), wq,
            torch.from_numpy(scale).to(device))


def int8_matvec_cost(args):
    """The int8 table, the rows, the scales, the f32 logits; 2
    operations a product term."""
    h, wq, scale = args[:3]
    (B, D), V = h.shape, wq.shape[0]
    nbytes = V * D + B * D * h.element_size() + V * scale.element_size() \
        + B * V * 4
    return 2 * B * V * D, nbytes


@register_kernel(
    "int8_matvec", plain=int8_matvec_plain, tol=_TOL,
    source="paddle_tpu_torch/csrc/int8_matvec.cu",
    replaces="paddle_tpu/ops/pallas_int8.py:78",
    example=int8_matvec_example, cost=int8_matvec_cost)
def int8_matvec(h, wq, scale):
    """h [B, D] (f32 or bf16), wq int8 [V, D], scale [V] (any float
    dtype, used as f32) -> f32 [B, V] = bf16(h) @ (wq * scale[:, None]).T.
    On the card D must be a multiple of 64 and wq 16-byte aligned."""
    if h.device.type == "cpu":
        return int8_matvec_plain(h, wq, scale)
    if h.device.type != "cuda":
        raise ValueError(f"int8_matvec: unsupported device {h.device}")
    if h.dtype not in _DTYPE_CODES:
        raise TypeError(f"int8_matvec: h dtype {h.dtype} not supported "
                        "(float32 or bfloat16)")
    if h.dim() != 2 or wq.dim() != 2 or wq.shape[1] != h.shape[1] \
            or tuple(scale.shape) != (wq.shape[0],):
        raise ValueError(f"int8_matvec: need h [B, D], wq [V, D], scale "
                         f"[V]; got {tuple(h.shape)}, {tuple(wq.shape)}, "
                         f"{tuple(scale.shape)}")
    B, D = h.shape
    V = wq.shape[0]
    if D % 64:
        raise ValueError(f"int8_matvec: D {D} must be a multiple of 64")
    scale = scale.float()
    _check_cuda("int8_matvec", [("h", h), ("wq", wq), ("scale", scale)],
                {"wq": torch.int8})
    if wq.data_ptr() % 16:
        raise ValueError("int8_matvec: wq must be 16-byte aligned")
    if h.data_ptr() % 16:           # the kernel reads h 16 bytes at a time
        h = h.clone()
    fn, err = _build.launcher(
        "int8_matvec", "int8_matvec_launch",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    out = torch.empty((B, V), dtype=torch.float32, device=h.device)
    rc = fn(h.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(),
            B, D, V, _DTYPE_CODES[h.dtype],
            torch.cuda.current_stream(h.device).cuda_stream)
    _build.check_launch("int8_matvec", rc, err)
    get_kernel("int8_matvec").launches += 1
    return out
