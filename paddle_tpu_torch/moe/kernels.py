"""MoE dispatch and combine: the router's index maps applied to rows.

Counterpart of paddle_tpu/moe/kernels.py. Two kernel wrappers over one
CUDA source (`csrc/moe_kernels.cu`):

- `moe_gather_fwd` (registry "moe_gather") replaces the TPU kernel
  `_gather_pallas`: out[i] = src[idx[i]], a zero row where idx[i] is the
  sentinel n_src (an empty expert slot);
- `moe_combine_fwd` (registry "moe_combine") replaces `_combine_pallas`:
  out[i] = sum_s w[i, s] * src[idx[i, s]] in f32, in slot order, the
  sentinel (a choice dropped at capacity) adding nothing, rounded once
  to src's dtype.

`moe_gather` and `moe_combine` are the differentiable entry points, as
the JAX `custom_vjp` functions are. Their backwards are the JAX
package's index math (the JAX backwards are jnp, not kernels): the
gather's is a scatter-add, the combine's a scatter-add and a row-dot.
The scatter-adds are plain torch; both accumulate in f32 into one spare
row past the end, where sentinel indices land and which is then sliced
off. Starting from zero, a token row receives at most k adds and a slot
row at most one, so the result does not depend on the order of the
atomic adds. The row-dot's rows are the gather of src at the flat
choice map (`jnp.take(mode="fill")` in JAX's `_combine_bwd`), which is
`moe_gather_fwd`'s function: on the card it launches the gather kernel,
so the MoE step launches it twice a layer.

The gather kernel reads src under an L2 evict_last policy; the lines it
marks outlive later traffic (csrc/moe_kernels.cu), so timings that follow
a gather call `reset_persisting_l2` first.

The plain versions `gather_plain` / `combine_plain` are the index math
of `gather_fallback` / `combine_fallback` (jnp.take with mode="fill").
On a CPU tensor the wrappers run them; on a CUDA tensor they launch the
kernel or raise. Unlike the TPU kernels there is no size gate: the CUDA
kernels read src by index from device memory at any size.
"""
import ctypes

import torch

from ..ops import _build
from ..ops.kernel_registry import get_kernel, register_kernel

__all__ = ["moe_gather", "moe_combine", "moe_gather_fwd", "moe_combine_fwd",
           "gather_plain", "combine_plain", "MoEGather", "MoECombine",
           "reset_persisting_l2"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_K = 8          # the combine kernel's largest k
# the gather copies rows, so it is exact; the combine uses the JAX
# registry's f32 tolerance (kernels.py:242) and, in bf16, one rounding of
# the same f32 sum: a 1-ulp flip of the bf16 output at most
_GATHER_TOL = {"float32": (0.0, 0.0), "bfloat16": (0.0, 0.0)}
_COMBINE_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-2)}


def _safe_index(idx, n_src):
    """idx as int64 with every index outside [0, n_src) sent to n_src."""
    idx = idx.long()
    return torch.where((idx >= 0) & (idx < n_src), idx, n_src)


def gather_plain(src, idx):
    """out[i] = src[idx[i]], zeros for an index outside [0, n_src)."""
    n_src, d = src.shape
    padded = torch.cat([src, src.new_zeros((1, d))])
    return padded[_safe_index(idx, n_src)]


def combine_plain(src, idx, w):
    """out[i] = sum_s w[i, s] * src[idx[i, s]] in f32, sentinel rows zero,
    one rounding to src's dtype."""
    n, k = idx.shape
    rows = gather_plain(src, idx.reshape(-1)).reshape(n, k, -1).float()
    return (w.float()[..., None] * rows).sum(dim=1).to(src.dtype)


def _check(name, src, idx, *others):
    """Device, dtype, layout and alignment checks before a launch."""
    if src.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {src.device}")
    if src.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors are on {src.device} but the "
                         f"current CUDA device is "
                         f"{torch.cuda.current_device()}")
    if src.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: src has dtype {src.dtype} (float32 or "
                        "bfloat16 expected)")
    if src.dim() != 2 or src.shape[1] * src.element_size() % 16:
        raise ValueError(f"{name}: src must be [rows, d] with d * itemsize "
                         f"a multiple of 16 bytes, got {tuple(src.shape)} "
                         f"{src.dtype}")
    if src.data_ptr() % 16:
        raise ValueError(f"{name}: src is not 16-byte aligned")
    for arg, t in [("src", src), ("idx", idx), *others]:
        if t.device != src.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected "
                             f"{src.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if idx.dtype != torch.int32:
        raise TypeError(f"{name}: idx must be int32, got {idx.dtype}")


@register_kernel(
    "moe_gather", plain=gather_plain, tol=_GATHER_TOL,
    source="paddle_tpu_torch/csrc/moe_kernels.cu",
    replaces="paddle_tpu/moe/kernels.py:138")
def moe_gather_fwd(src, idx):
    """src [n_src, d] (f32 or bf16), idx int32 [m] -> [m, d]; an index
    equal to n_src gives a zero row."""
    if src.device.type == "cpu":
        return gather_plain(src, idx)
    _check("moe_gather", src, idx)
    if idx.dim() != 1:
        raise ValueError(f"moe_gather: idx must be [m], got "
                         f"{tuple(idx.shape)}")
    n_src, d = src.shape
    m = idx.shape[0]
    out = torch.empty((m, d), dtype=src.dtype, device=src.device)
    if m == 0:
        return out
    fn, err = _build.launcher(
        "moe_kernels", "moe_gather_launch",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    rc = fn(src.data_ptr(), idx.data_ptr(), out.data_ptr(), n_src, m,
            d * src.element_size(),
            torch.cuda.current_stream(src.device).cuda_stream)
    _build.check_launch("moe_gather", rc, err)
    get_kernel("moe_gather").launches += 1
    return out


@register_kernel(
    "moe_combine", plain=combine_plain, tol=_COMBINE_TOL,
    source="paddle_tpu_torch/csrc/moe_kernels.cu",
    replaces="paddle_tpu/moe/kernels.py:244")
def moe_combine_fwd(src, idx, w):
    """src [n_src, d] (f32 or bf16), idx int32 [n, k], w [n, k] (f32 or
    bf16) -> [n, d] in src's dtype; an index equal to n_src adds
    nothing."""
    if src.device.type == "cpu":
        return combine_plain(src, idx, w)
    _check("moe_combine", src, idx, ("w", w))
    if w.dtype not in _DTYPE_CODES:
        raise TypeError(f"moe_combine: w has dtype {w.dtype} (float32 or "
                        "bfloat16 expected)")
    if idx.dim() != 2 or w.shape != idx.shape \
            or not 1 <= idx.shape[1] <= _MAX_K:
        raise ValueError(f"moe_combine: idx and w must both be [n, k] with "
                         f"1 <= k <= {_MAX_K}, got {tuple(idx.shape)} and "
                         f"{tuple(w.shape)}")
    n_src, d = src.shape
    n, k = idx.shape
    out = torch.empty((n, d), dtype=src.dtype, device=src.device)
    if n == 0:
        return out
    fn, err = _build.launcher(
        "moe_kernels", "moe_combine_launch",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    rc = fn(src.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(),
            n_src, n, k, d, _DTYPE_CODES[src.dtype], _DTYPE_CODES[w.dtype],
            torch.cuda.current_stream(src.device).cuda_stream)
    _build.check_launch("moe_combine", rc, err)
    get_kernel("moe_combine").launches += 1
    return out


def reset_persisting_l2():
    """Wait for the card, then return the L2 lines that the gather kernel
    read under evict_last to normal priority (cudaCtxResetPersistingL2Cache,
    which acts on the whole context). They outlive other traffic, so a
    timing that follows a gather calls this first; the training path
    never does."""
    torch.cuda.synchronize()
    fn, err = _build.launcher("moe_kernels", "moe_gather_reset_l2", [])
    _build.check_launch("moe_gather_reset_l2", fn(), err)


def _scatter_add_rows(n_rows, idx, rows):
    """f32 [n_rows, d]: rows[j] added at idx[j]; sentinel indices land
    in a spare row past the end, which is sliced off."""
    out = torch.zeros((n_rows + 1, rows.shape[-1]), dtype=torch.float32,
                      device=rows.device)
    out.index_add_(0, _safe_index(idx, n_rows), rows)
    return out[:n_rows]


class MoEGather(torch.autograd.Function):
    """Dispatch gather; backward: scatter-add of the output's gradient
    back to the source rows (`_gather_bwd`)."""

    @staticmethod
    def forward(ctx, src, idx):
        ctx.save_for_backward(idx)
        ctx.src_meta = (src.shape[0], src.dtype)
        return moe_gather_fwd(src, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        n_src, dtype = ctx.src_meta
        return _scatter_add_rows(n_src, idx, g.float()).to(dtype), None


class MoECombine(torch.autograd.Function):
    """Weighted combine; backward (`_combine_bwd`): dsrc is the scatter-
    add of w[i, s] * g[i] at idx[i, s], dw[i, s] the dot of g[i] with the
    row `moe_gather_fwd` gathers for choice (i, s)."""

    @staticmethod
    def forward(ctx, src, idx, w):
        ctx.save_for_backward(src, idx, w)
        return moe_combine_fwd(src, idx, w)

    @staticmethod
    def backward(ctx, g):
        src, idx, w = ctx.saved_tensors
        n, k = idx.shape
        g32 = g.float()
        contrib = w.float()[..., None] * g32[:, None, :]
        dsrc = _scatter_add_rows(src.shape[0], idx.reshape(-1),
                                 contrib.reshape(n * k, -1))
        rows = moe_gather_fwd(src, idx.reshape(-1)).reshape(n, k, -1).float()
        dw = (rows * g32[:, None, :]).sum(dim=-1)
        return dsrc.to(src.dtype), None, dw.to(w.dtype)


def moe_gather(src, idx):
    """Differentiable dispatch gather: src [n, d], idx int32 [m] in
    [0, n] (n = empty) -> [m, d]."""
    return MoEGather.apply(src, idx)


def moe_combine(src, idx, w):
    """Differentiable weighted combine: src [m, d], idx int32 [n, k] in
    [0, m] (m = dropped), w [n, k] -> [n, d]."""
    return MoECombine.apply(src, idx, w)
