"""Decode attention over the dense, flat KV cache: `generate`'s kernel.

`decode_attention` (registry "decode_fused") is q_len == 1 attention of
every batch row over keys 0..off of a flat [B, L, N*H] cache, with one
`off` for all rows; CUDA source `csrc/decode_attention.cu`. It keeps the
JAX signature (paddle_tpu/ops/pallas_decode.py:606): `off` is a host
integer, or, as the JAX function takes a traced scalar, a 0-dim int32
tensor on q's device (generate's captured token step, whose position
advances on the device); the kernel then reads it from device memory
and the caller names the chunk count (`chunks`) the host picked from
the position it knows, so the launch's grid never depends on device
data. On a CPU tensor it runs its plain version, `_decode_fallback`'s
dense masked attention in f32; on a CUDA tensor it launches its kernel
or raises. The kernel
splits keys 0..off into `decode_split(off)` chunks, one CTA each for a
batch row and a group of heads, and merges them in chunk order;
`decode_attention_split_plain` is that split and merge in f32 on any
device.
"""
import ctypes
import math
import operator

import torch

from . import _build
from .kernel_registry import get_kernel, register_kernel
from .paged_attention import _DTYPE_CODES, _check_cuda

__all__ = ["decode_attention", "decode_attention_plain",
           "decode_attention_split_plain", "decode_attention_supported",
           "decode_split", "device_split"]

_HEAD_DIMS = (64, 128)      # the kernel's template instances
# f32: the JAX registry's declared tolerance; bf16: the port's rule for
# bf16 inputs (8-bit mantissa) against a plain version in f32
_TOL = {"float32": (1e-3, 1e-3), "bfloat16": (2e-2, 2e-2)}
DECODE_ONE_CHUNK = 128      # keys the kernel takes in one chunk
DECODE_SPLIT_KEYS = 32      # above that, keys a chunk at most...
_MAX_CHUNKS = 8             # ...in at most this many chunks (a cluster)


def decode_split(last):
    """(chunks, keys a chunk) of the kernel's split of keys 0..last: one
    chunk up to DECODE_ONE_CHUNK keys, else the fewest chunks, a power of
    two up to 8, that leave at most DECODE_SPLIT_KEYS keys a chunk, with
    the keys spread evenly over them. Every chunk holds at least one
    key."""
    keys = last + 1
    if keys <= DECODE_ONE_CHUNK:
        return 1, keys
    chunks = 2
    while chunks < _MAX_CHUNKS and chunks * DECODE_SPLIT_KEYS < keys:
        chunks *= 2
    return chunks, -(-keys // chunks)


def device_split(last, chunks):
    """Keys a chunk when the kernel splits keys 0..last into `chunks`
    itself (a position read from device memory): ceil((last + 1) /
    chunks), decode_split's formula. Raises unless every chunk holds a
    key, the check the launcher makes of a host split: the host loop
    that knows the position calls it before each captured step."""
    if not 1 <= chunks <= _MAX_CHUNKS or last < 0:
        raise ValueError(f"decode_attention: {chunks} chunks over keys "
                         f"0..{last}")
    chunk = -(-(last + 1) // chunks)
    if (chunks - 1) * chunk > last:
        raise ValueError(f"decode_attention: {chunks} chunks of {chunk} "
                         f"keys leave a chunk without a key at last {last}")
    return chunk


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


def decode_attention_split_plain(q, k_buf, v_buf, off, n_heads, chunk):
    """The kernel's split over the keys, in f32: keys 0..min(off, L - 1)
    are cut into chunks of `chunk` keys; each chunk keeps the (m, l, acc)
    of its own softmax, and the chunks merge in chunk order with weights
    exp(m_c - M). Same arguments and result as `decode_attention_plain`
    (plus `chunk`)."""
    B, _, nh = q.shape
    N, H = n_heads, nh // n_heads
    L = k_buf.shape[1]
    last = min(off, L - 1)
    k4 = k_buf.reshape(B, L, N, H).float()
    v4 = v_buf.reshape(B, L, N, H).float()
    s = torch.einsum("bnh,blnh->bnl", q.reshape(B, N, H).float(), k4) \
        / math.sqrt(H)
    ms, ls, accs = [], [], []
    for c0 in range(0, last + 1, chunk):
        c1 = min(c0 + chunk, last + 1)
        m = s[:, :, c0:c1].amax(dim=-1, keepdim=True)
        p = torch.exp(s[:, :, c0:c1] - m)
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("bnl,blnh->bnh", p, v4[:, c0:c1]))
    M = torch.stack(ms).amax(dim=0)
    wts = [torch.exp(m - M) for m in ms]
    out = sum(w * a for w, a in zip(wts, accs)) \
        / sum(w * l for w, l in zip(wts, ls))
    return out.reshape(B, 1, nh)


@register_kernel(
    "decode_fused", plain=decode_attention_plain, tol=_TOL,
    source="paddle_tpu_torch/csrc/decode_attention.cu",
    replaces="paddle_tpu/ops/pallas_decode.py:606")
def decode_attention(q, k_buf, v_buf, off, n_heads, chunks=None):
    """q [B, 1, N*H]; k_buf/v_buf FLAT [B, L, N*H] (f32 or bf16, each
    independent of q's dtype); off — q's position (keys 0..off are
    valid): a host integer, or a 0-dim int32 tensor on q's device, with
    `chunks` the kernel's chunk count for it (`decode_split(min(off,
    L - 1))[0]`, which the caller checks with `device_split`; ignored on
    the CPU). Returns [B, 1, N*H] f32. Does NOT write the cache: callers
    write position off first."""
    dev_off = isinstance(off, torch.Tensor)
    if not dev_off:
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
    if dev_off:
        if off.dim() != 0 or chunks is None or not 1 <= chunks <= _MAX_CHUNKS:
            raise ValueError("decode_attention: a device position is a "
                             "0-dim int32 tensor and needs its chunk count "
                             f"(1..{_MAX_CHUNKS}), got shape "
                             f"{tuple(off.shape)} and chunks {chunks}")
    elif off < 0:
        raise ValueError(f"decode_attention: off {off} < 0")
    _check_cuda("decode_attention",
                [("q", q), ("k_buf", k_buf), ("v_buf", v_buf)]
                + ([("off", off)] if dev_off else []),
                {"v_buf": k_buf.dtype, "off": torch.int32})
    if k_buf.data_ptr() % 16 or v_buf.data_ptr() % 16:
        raise ValueError("decode_attention: k_buf and v_buf must be "
                         "16-byte aligned")
    if q.data_ptr() % 16:           # the kernel reads q 16 bytes at a time
        q = q.clone()
    fn, err = _build.launcher(
        "decode_attention", "decode_attention_launch",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
        + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
    L = k_buf.shape[1]
    H = nh // n_heads
    if dev_off:     # the kernel reads the position and splits the keys
        last, chunk, off_ptr = 0, 0, off.data_ptr()
    else:
        last = min(off, L - 1)
        chunks, chunk = decode_split(last)
        off_ptr = None
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    rc = fn(q.data_ptr(), k_buf.data_ptr(), v_buf.data_ptr(), out.data_ptr(),
            B, L, n_heads, H, last, chunks, chunk, _DTYPE_CODES[q.dtype],
            _DTYPE_CODES[k_buf.dtype], 1.0 / math.sqrt(H), off_ptr,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch("decode_fused", rc, err)
    get_kernel("decode_fused").launches += 1
    return out
