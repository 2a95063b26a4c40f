"""Attention over the paged KV arenas: the serving path's two kernels.

- `paged_decode_attention` (registry "paged_decode") — q_len == 1
  attention for every decode slot, through per-slot block tables;
  CUDA source `csrc/paged_decode.cu`.
- `flash_prefill_chunk` (registry "flash_prefill_chunk") — one request's
  prefill chunk at positions p0.., causal, over its blocks; CUDA source
  `csrc/flash_prefill_chunk.cu`.

Each keeps the JAX signature (paddle_tpu/ops/pallas_decode.py) minus
`use_kernel`. On a CPU tensor it runs its plain version; on a CUDA
tensor it launches its kernel or raises — there is no path that runs the
plain version on the card. The plain versions copy the JAX gather+dense
fallbacks exactly (pallas_decode.py:329-345 and :522-538): gather the
pages into a dense view and run `attention.composed_attention` over it.
"""
import ctypes
import math
import operator

import torch

from . import _build
from .attention import composed_attention
from .kernel_registry import get_kernel, register_kernel

__all__ = ["paged_decode_attention", "flash_prefill_chunk",
           "paged_decode_plain", "paged_decode_split_plain",
           "flash_prefill_plain", "flash_prefill_split_plain"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)      # the kernels' template instances
# keys a paged_decode CTA covers, all heads (csrc/paged_decode.cu)
DECODE_CHUNK_KEYS = 32
# paged_decode's CTA holds at most 16 warps of 16-byte lanes across a row
_DECODE_MAX_COLS = {torch.float32: 2048, torch.bfloat16: 4096}
# f32: the JAX registry's declared kernel tolerance; bf16: probs and
# outputs round to bf16 (8-bit mantissa, relative step 2^-8) where the
# kernels keep f32 until the single final store
_TOL = {"float32": (1e-3, 1e-3), "bfloat16": (2e-2, 2e-2)}


def paged_decode_plain(q, k_pages, v_pages, block_tables, ctx_lens,
                       n_heads):
    """Gather+dense decode attention: q [S, 1, N*H]; pages
    [num_blocks, bs, N*H]; block_tables [S, mb]; ctx_lens [S] — keys at
    logical positions 0..ctx_lens[s] (inclusive) are valid."""
    S, one, nh = q.shape
    if one != 1:
        raise ValueError("paged_decode_attention is q_len==1 only")
    N = n_heads
    H = nh // N
    L = block_tables.shape[1] * k_pages.shape[1]
    tab = block_tables.long()
    key_pos = torch.arange(L, device=q.device)[None, None, None, :]
    out = composed_attention(
        q.reshape(S, 1, N, H), k_pages[tab].reshape(S, L, N, H),
        v_pages[tab].reshape(S, L, N, H),
        key_pos <= ctx_lens.long()[:, None, None, None])
    return out.reshape(S, 1, nh)


def paged_decode_split_plain(q, k_pages, v_pages, block_tables, ctx_lens,
                             n_heads, chunk_keys=DECODE_CHUNK_KEYS):
    """The kernel's split over the keys, in f32: each slot's keys
    0..min(ctx, mb*bs - 1) are cut into chunks of `chunk_keys`; each
    chunk keeps the (m, l, acc) of its own softmax, and the chunks merge
    with weights exp(m_c - M) / sum_c exp(m_c - M) l_c, where a chunk
    that holds no live key (m_c = -inf) weighs 0. Same arguments and
    result as `paged_decode_plain`."""
    S, one, nh = q.shape
    if one != 1:
        raise ValueError("paged_decode_attention is q_len==1 only")
    N = n_heads
    H = nh // N
    L = block_tables.shape[1] * k_pages.shape[1]
    tab = block_tables.long()
    k = k_pages[tab].reshape(S, L, N, H).float()
    v = v_pages[tab].reshape(S, L, N, H).float()
    s = torch.einsum("snh,slnh->snl", q.reshape(S, N, H).float(), k) \
        / math.sqrt(H)
    key = torch.arange(L, device=q.device)
    live = key[None, :] <= ctx_lens.long()[:, None]           # [S, L]
    ms, ls, accs = [], [], []
    for c0 in range(0, L, chunk_keys):
        inside = live & (key >= c0)[None, :] & (key < c0 + chunk_keys)[None]
        sc = s.masked_fill(~inside[:, None, :], -math.inf)
        m = sc.amax(dim=-1, keepdim=True)
        p = torch.exp(sc - torch.where(m == -math.inf, 0.0, m))
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("snl,slnh->snh", p, v))
    M = torch.stack(ms).amax(dim=0)
    wts = [torch.where(m == -math.inf, 0.0, torch.exp(m - M)) for m in ms]
    out = sum(w * a for w, a in zip(wts, accs)) \
        / sum(w * l for w, l in zip(wts, ls))
    return out.reshape(S, 1, nh).to(q.dtype)


def flash_prefill_plain(q, k_pages, v_pages, table_row, p0, n_heads):
    """Gather+dense chunked-prefill attention: q [1, C, N*H] at positions
    p0..p0+C-1; table_row [mb]; key j is valid for query i when
    j <= p0 + i."""
    one, C, nh = q.shape
    if one != 1:
        raise ValueError("flash_prefill_chunk takes one request's chunk")
    N = n_heads
    H = nh // N
    L = table_row.shape[0] * k_pages.shape[1]
    tab = table_row.long()
    key_pos = torch.arange(L, device=q.device)[None, None, None, :]
    q_pos = (p0 + torch.arange(C, device=q.device))[None, None, :, None]
    out = composed_attention(
        q.reshape(1, C, N, H), k_pages[tab].reshape(1, L, N, H),
        v_pages[tab].reshape(1, L, N, H), key_pos <= q_pos)
    return out.reshape(1, C, nh)


def flash_prefill_split_plain(q, k_pages, v_pages, table_row, p0, n_heads,
                              splits, step=16):
    """The bf16 kernel's key split, in f32: the 16-key steps of the keys
    go round-robin to `splits` partitions (the kernel's warps), each
    keeps the (m, l, acc) of its own online softmax, and the partials
    merge with weights exp(m_w - M) / sum_w exp(m_w - M) l_w, where a
    partition in which a row sees no key (m_w = -inf) weighs 0. Same
    arguments and result as `flash_prefill_plain`."""
    one, C, nh = q.shape
    N = n_heads
    H = nh // N
    L = table_row.shape[0] * k_pages.shape[1]
    tab = table_row.long()
    k = k_pages[tab].reshape(L, N, H).float()
    v = v_pages[tab].reshape(L, N, H).float()
    s = torch.einsum("qnh,knh->nqk", q.reshape(C, N, H).float(), k) \
        / math.sqrt(H)
    key = torch.arange(L, device=q.device)
    seen = key[None, :] <= (p0 + torch.arange(C, device=q.device))[:, None]
    ms, ls, accs = [], [], []
    for w in range(splits):
        sw = s.masked_fill(~(seen & ((key // step) % splits == w)),
                           -math.inf)
        m = sw.amax(dim=-1, keepdim=True)
        p = torch.exp(sw - torch.where(m == -math.inf, 0.0, m))
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("nqk,knh->nqh", p, v))
    M = torch.stack(ms).amax(dim=0)
    wts = [torch.where(m == -math.inf, 0.0, torch.exp(m - M)) for m in ms]
    out = sum(w * a for w, a in zip(wts, accs)) \
        / sum(w * l for w, l in zip(wts, ls))
    return out.transpose(0, 1).reshape(1, C, nh).to(q.dtype)


def _check_cuda(name, tensors, dtypes):
    """Device, dtype and contiguity checks shared by both wrappers."""
    dev = tensors[0][1].device
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors are on {dev} but the current "
                         f"CUDA device is {torch.cuda.current_device()}")
    for arg, t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    for arg, t in tensors:
        want = dtypes.get(arg)
        if want is not None and t.dtype != want:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, "
                            f"expected {want}")


def _check_pages(name, q, k_pages, v_pages, n_heads):
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {q.dtype} not supported (float32 "
                        "or bfloat16)")
    nh = q.shape[-1]
    if nh % n_heads or nh // n_heads not in _HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {nh / n_heads} not in "
                         f"{_HEAD_DIMS}")
    if k_pages.dim() != 3 or k_pages.shape != v_pages.shape \
            or k_pages.shape[2] != nh:
        raise ValueError(f"{name}: pages must both be [num_blocks, "
                         f"block_size, {nh}], got {tuple(k_pages.shape)} "
                         f"and {tuple(v_pages.shape)}")
    return nh // n_heads


@register_kernel(
    "paged_decode", plain=paged_decode_plain, tol=_TOL,
    source="paddle_tpu_torch/csrc/paged_decode.cu",
    replaces="paddle_tpu/ops/pallas_decode.py:296")
def paged_decode_attention(q, k_pages, v_pages, block_tables, ctx_lens,
                           n_heads):
    """Decode attention (q_len == 1) over a paged KV cache.

    q [S, 1, N*H]; k_pages/v_pages [num_blocks, block_size, N*H];
    block_tables [S, max_blocks] int32 (unallocated entries point at the
    null block 0); ctx_lens [S] int32 — keys at logical positions
    0..ctx_lens[s] are valid. Returns [S, 1, N*H] in q's dtype."""
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pages, v_pages, block_tables,
                                  ctx_lens, n_heads)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    S, one, nh = q.shape
    if one != 1:
        raise ValueError("paged_decode_attention is q_len==1 only")
    H = _check_pages("paged_decode_attention", q, k_pages, v_pages,
                     n_heads)
    _check_cuda("paged_decode_attention",
                [("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                 ("block_tables", block_tables), ("ctx_lens", ctx_lens)],
                {"k_pages": q.dtype, "v_pages": q.dtype,
                 "block_tables": torch.int32, "ctx_lens": torch.int32})
    if block_tables.dim() != 2 or block_tables.shape[0] != S \
            or tuple(ctx_lens.shape) != (S,):
        raise ValueError("paged_decode_attention: block_tables must be "
                         f"[{S}, max_blocks] and ctx_lens [{S}]")
    if nh > _DECODE_MAX_COLS[q.dtype]:
        raise ValueError(f"paged_decode_attention: n_heads * head_dim = "
                         f"{nh} exceeds {_DECODE_MAX_COLS[q.dtype]} for "
                         f"{q.dtype}")
    fn, err = _build.launcher(
        "paged_decode", "paged_decode_launch",
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_void_p])
    bs, mb = k_pages.shape[1], block_tables.shape[1]
    chunks = -(-mb * bs // DECODE_CHUNK_KEYS)
    out = torch.empty_like(q)
    # the chunks' partials (acc; m and l per head), f32
    part_acc = torch.empty((S, chunks, nh), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((S, chunks, n_heads, 2), dtype=torch.float32,
                          device=q.device)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(),
            part_acc.data_ptr(), part_ml.data_ptr(), S, n_heads, H, bs, mb,
            DECODE_CHUNK_KEYS, _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(H),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch("paged_decode", rc, err)
    get_kernel("paged_decode").launches += 1
    return out


@register_kernel(
    "flash_prefill_chunk", plain=flash_prefill_plain, tol=_TOL,
    source="paddle_tpu_torch/csrc/flash_prefill_chunk.cu",
    replaces="paddle_tpu/ops/pallas_decode.py:485")
def flash_prefill_chunk(q, k_pages, v_pages, table_row, p0, n_heads):
    """Chunked-prefill attention over a paged KV cache.

    q [1, C, N*H] — the chunk's queries at positions p0..p0+C-1;
    k_pages/v_pages [num_blocks, block_size, N*H], already holding this
    chunk's own K/V (callers write before attending); table_row
    [max_blocks] int32 — one request's logical->physical block map; p0 —
    the chunk's first position: a host integer, or a 0-dim int32 tensor
    on q's device, which the kernel reads from device memory (the
    engine's captured chunk; the grid does not depend on p0). Returns
    [1, C, N*H] in q's dtype."""
    dev_p0 = isinstance(p0, torch.Tensor)
    if not dev_p0:
        p0 = operator.index(p0)
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k_pages, v_pages, table_row, p0,
                                   n_heads)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill_chunk: unsupported device "
                         f"{q.device}")
    one, C, nh = q.shape
    if one != 1:
        raise ValueError("flash_prefill_chunk takes one request's chunk")
    H = _check_pages("flash_prefill_chunk", q, k_pages, v_pages, n_heads)
    _check_cuda("flash_prefill_chunk",
                [("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                 ("table_row", table_row)]
                + ([("p0", p0)] if dev_p0 else []),
                {"k_pages": q.dtype, "v_pages": q.dtype,
                 "table_row": torch.int32, "p0": torch.int32})
    bs = k_pages.shape[1]
    if bs % 8:
        raise ValueError(f"flash_prefill_chunk: block_size {bs} must be a "
                         "multiple of 8")
    # the f32 kernel stages a whole block of K and V as f32 in static
    # shared memory; the bf16 kernel's ring does not depend on bs
    if q.dtype == torch.float32 and 2 * bs * H * 4 > 48 * 1024:
        raise ValueError(f"flash_prefill_chunk: block_size {bs} needs "
                         "2*block_size*head_dim f32 values within 48 KB of "
                         "shared memory")
    if table_row.dim() != 1 or (p0.dim() != 0 if dev_p0 else p0 < 0):
        raise ValueError("flash_prefill_chunk: table_row must be "
                         "[max_blocks] and p0 >= 0 (or a 0-dim tensor)")
    fn, err = _build.launcher(
        "flash_prefill_chunk", "flash_prefill_chunk_launch",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            table_row.data_ptr(), out.data_ptr(), C, n_heads, H, bs,
            table_row.shape[0], 0 if dev_p0 else p0,
            p0.data_ptr() if dev_p0 else None, _DTYPE_CODES[q.dtype],
            1.0 / math.sqrt(H),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch("flash_prefill_chunk", rc, err)
    get_kernel("flash_prefill_chunk").launches += 1
    return out
