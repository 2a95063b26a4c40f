"""Ring and Ulysses attention — sequence parallelism over the mesh's sp
axis. The port of paddle_tpu/ops/ring_attention.py.

Each rank holds its sequence block of q, k and v ([b, s/sp, n, h]; the
blocks in axis order make the sequence), where the JAX functions take
global arrays and let `shard_map` cut them; `shard_seq` makes the cut
(and raises the JAX error when it does not divide).

- `ring_attention`: each rank keeps its query block and the k/v blocks
  travel round the sp ring (`collective.exchange`, each hop posted
  before that hop's compute, so that on NCCL the transfer overlaps it).
  Hop t holds block j = (i - t) mod sp. Every hop calls the flash
  forward kernel (`flash_fwd`, K1/K2): causal on the diagonal block
  (j == i), non-causal on the past (j < i); a future block (j > i) is
  skipped under the causal mask, as the JAX ring skips it, but still
  passed on. The hops' (out, lse) pairs are merged in f32 through the
  log-sum-exps, the JAX ring's num/den/max carry in another form. The
  backward (`RingAttention.backward`) makes the same trip and calls
  `flash_bwd` (K3-K5) once a hop with the MERGED out and lse (the
  kernel recomputes P from the global lse and delta from the global
  out, so each hop's part is exact); dq accumulates in f32 on the rank,
  and each block's dk/dv accumulate in f32 beside it and travel on with
  it, one hop further, home. The k/v blocks make sp - 1 hops each way
  (2 (sp - 1) blocks a layer forward), the f32 dk/dv sp hops.
- `ulysses_attention`: an all-to-all over sp turns the sequence blocks
  into head blocks ([b, s, n/sp, h]), the flash kernels attend over the
  whole sequence for those heads, and a second all-to-all turns them
  back (both `all_to_all_axis`, whose backward is the swapped
  all-to-all). It needs the rank's heads to divide by sp.

With no mesh or an sp of size 1 both are the port's flash attention
(`flash_attention_fwd`), as the JAX functions fall to the composed
attention.
"""
import math

import torch

from ..distributed import env
from ..distributed.collective import all_to_all_axis, exchange
from .flash_attention import flash_attention_fwd, flash_bwd, flash_fwd

__all__ = ["ring_attention", "ulysses_attention", "ring_attention_values",
           "ulysses_attention_values", "shard_seq", "RingAttention"]


def _sp(axis_name, mesh):
    if mesh is not None and mesh is not env.current_mesh():
        raise ValueError("ring/ulysses attention run over the installed "
                         "mesh (env.set_mesh); got another one")
    return env.axis_size(axis_name), env.axis_index(axis_name)


def shard_seq(x, axis_name="sp", dim=1):
    """This rank's block of the global `x` along `dim` (the sequence)
    over mesh axis `axis_name`; raises the JAX ValueError when the
    length does not divide."""
    sp, i = env.axis_size(axis_name), env.axis_index(axis_name)
    if x.shape[dim] % sp:
        raise ValueError(
            f"ring attention needs seq lengths ({x.shape[dim]}) divisible "
            f"by the '{axis_name}' mesh size {sp}")
    return x.chunk(sp, dim=dim)[i].contiguous() if sp > 1 else x


def _lse4(lse, b, n, s):
    """[b*n, s] -> [b, s, n, 1], broadcastable against [b, s, n, h]."""
    return lse.reshape(b, n, s).transpose(1, 2)[..., None]


def _merge(acc, lse, o, lse_j):
    """Fold one hop's (o, lse_j) into the f32 running (acc, lse)."""
    if acc is None:
        return o.float(), lse_j
    b, s, n, _ = o.shape
    new = torch.logaddexp(lse, lse_j)
    acc = acc * _lse4(torch.exp(lse - new), b, n, s) \
        + o.float() * _lse4(torch.exp(lse_j - new), b, n, s)
    return acc, new


class RingAttention(torch.autograd.Function):
    """out = attention of this rank's q block over the whole ring's k/v
    (see the module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, axis_name):
        sp, i = env.axis_size(axis_name), env.axis_index(axis_name)
        right, left = (i + 1) % sp, (i - 1) % sp
        kv = torch.stack([k, v])
        acc = lse = None
        for t in range(sp):
            j = (i - t) % sp
            nxt = exchange(kv, axis_name, right, left) if t < sp - 1 \
                else None
            if not causal or j <= i:
                o, l_j = flash_fwd(q, kv[0], kv[1], causal and j == i,
                                   scale)
                acc, lse = _merge(acc, lse, o, l_j)
            if nxt is not None:
                kv = nxt.wait()
        out = acc.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, axis_name)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, axis_name = ctx.args
        sp, i = env.axis_size(axis_name), env.axis_index(axis_name)
        right, left = (i + 1) % sp, (i - 1) % sp
        dout = dout.contiguous()
        kv = torch.stack([k, v])
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
        for t in range(sp):
            j = (i - t) % sp
            nxt = exchange(kv, axis_name, right, left) if t < sp - 1 \
                else None
            if not causal or j <= i:
                dq_j, dk_j, dv_j = flash_bwd(q, kv[0], kv[1], out, lse, dout,
                                             causal and j == i, scale)
                dq += dq_j.float()
                dkv[0] += dk_j.float()
                dkv[1] += dv_j.float()
            # block j's accumulators move on with it; after sp hops each
            # block's are at home
            dkv = exchange(dkv, axis_name, right, left).wait()
            if nxt is not None:
                kv = nxt.wait()
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None)


def ring_attention(query, key, value, causal=False, scale=None,
                   axis_name="sp", mesh=None):
    """Ring attention of this rank's sequence blocks [b, s/sp, n, h]."""
    sp, _ = _sp(axis_name, mesh)
    if scale is None:
        scale = 1.0 / math.sqrt(query.shape[-1])
    if sp == 1:
        return flash_attention_fwd(query, key, value, causal=causal,
                                   scale=scale)
    if key.shape[1] != query.shape[1] or value.shape != key.shape:
        raise ValueError(
            f"ring attention needs q, k and v blocks of one length; got "
            f"q {tuple(query.shape)}, k {tuple(key.shape)}, v "
            f"{tuple(value.shape)}")
    return RingAttention.apply(query, key, value, causal, scale, axis_name)


def ulysses_attention(query, key, value, causal=False, scale=None,
                      axis_name="sp", mesh=None):
    """Ulysses attention of this rank's sequence blocks [b, s/sp, n, h]:
    the rank's heads `n` must divide by sp."""
    sp, _ = _sp(axis_name, mesh)
    if scale is None:
        scale = 1.0 / math.sqrt(query.shape[-1])
    if sp == 1:
        return flash_attention_fwd(query, key, value, causal=causal,
                                   scale=scale)
    if query.shape[2] % sp != 0:
        raise ValueError(f"ulysses needs heads ({query.shape[2]}) divisible "
                         f"by sp ({sp}); use ring_attention instead")

    def seq_to_head(x):
        return all_to_all_axis(x, axis_name, split_axis=2, concat_axis=1)

    out = flash_attention_fwd(seq_to_head(query), seq_to_head(key),
                              seq_to_head(value), causal=causal, scale=scale)
    return all_to_all_axis(out, axis_name, split_axis=1, concat_axis=2)


# the JAX package's value-level names
ring_attention_values = ring_attention
ulysses_attention_values = ulysses_attention
