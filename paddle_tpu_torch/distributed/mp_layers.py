"""Tensor-parallel layers — the port of paddle_tpu/distributed/mp_layers.py
(reference `fleet/meta_parallel/parallel_layers/mp_layers.py`:
VocabParallelEmbedding:30, ColumnParallelLinear:97, RowParallelLinear:170,
ParallelCrossEntropy:249).

The JAX layers only tag their weights and let GSPMD place the
collectives. The port places them itself, Megatron-style, with the
reference's operators from `collective.py`:

- column-parallel (`column_parallel`): the input through `c_identity`
  (identity forward, all-reduce of the gradient over mp backward), then
  this rank's columns of W and b; `gather_output` concatenates the
  ranks' outputs (`c_concat`: all-gather forward, this rank's slice of
  the gradient backward);
- row-parallel (`row_parallel`): this rank's rows of W over its slice
  of the input (`c_split` cuts a replicated input), the partial sums
  all-reduced over mp (`mp_allreduce`: identity backward), the bias
  added after the sum;
- vocab-parallel embedding (`vocab_parallel_embedding`): ids clipped
  into the table (as the JAX gather clips), the ids outside this rank's
  rows masked to zero rows, the lookups all-reduced over mp;
- vocab-parallel cross entropy (`parallel_cross_entropy`): over logits
  cut along the vocab, in f32: the row max (all-reduce MAX), then the
  sum of exp and the target logit (one all-reduce SUM of both); the
  logits are never gathered. Its backward is local: (softmax - one-hot)
  times the loss gradient.

A layer's parameters are made at their full size with their `mesh_axes`
tags; `sharded_train.shard_model` cuts them to this rank's piece. With
mp of size 1 (or no mesh) every layer is its plain counterpart.
"""
import math

import torch

from ..amp import maybe_cast_to_compute
from ..nn import functional as F
from . import env
from .collective import (_all_gather, _axis, _psum_raw, ReduceOp,
                         c_identity, mp_allreduce)

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "column_parallel",
           "row_parallel", "vocab_parallel_embedding",
           "parallel_cross_entropy", "c_concat", "c_split",
           "COLUMN_PARALLEL_WEIGHT_AXES", "COLUMN_PARALLEL_BIAS_AXES",
           "ROW_PARALLEL_WEIGHT_AXES", "VOCAB_PARALLEL_WEIGHT_AXES"]

# the JAX planner's canonical Megatron placements (paddle_tpu/planner/
# rules.py), copied
COLUMN_PARALLEL_WEIGHT_AXES = (None, "mp")
COLUMN_PARALLEL_BIAS_AXES = ("mp",)
ROW_PARALLEL_WEIGHT_AXES = ("mp", None)
VOCAB_PARALLEL_WEIGHT_AXES = ("mp", None)


class _CConcat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        group, n, _ = _axis(axis_name)
        ctx.args = (axis_name, n, env.axis_index(axis_name))
        return torch.cat(_all_gather(x, group, name="c_concat",
                                     axis=axis_name), dim=-1)

    @staticmethod
    def backward(ctx, g):
        _, n, i = ctx.args
        return g.chunk(n, dim=-1)[i].contiguous(), None


class _CSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        group, n, _ = _axis(axis_name)
        ctx.args = (axis_name, group)
        return x.chunk(n, dim=-1)[env.axis_index(axis_name)].contiguous()

    @staticmethod
    def backward(ctx, g):
        axis_name, group = ctx.args
        return torch.cat(_all_gather(g, group, name="c_split",
                                     axis=axis_name), dim=-1), None


def c_concat(x, axis_name="mp"):
    """The ranks' last-dim slices concatenated (reference `c_concat`):
    backward keeps this rank's slice of the gradient."""
    return x if env.axis_size(axis_name) == 1 else _CConcat.apply(
        x, axis_name)


def c_split(x, axis_name="mp"):
    """This rank's slice of a replicated last dim (reference `c_split`):
    backward all-gathers the gradient."""
    return x if env.axis_size(axis_name) == 1 else _CSplit.apply(
        x, axis_name)


def column_parallel(x, weight, bias=None, axis_name="mp"):
    """x (replicated over mp) @ this rank's columns of W, + its b."""
    return F.linear(c_identity(x, axis_name), weight, bias)


def row_parallel(x, weight, bias=None, axis_name="mp"):
    """x (this rank's slice of the input) @ this rank's rows of W,
    summed over mp, + b (replicated) after the sum."""
    y = mp_allreduce(F.linear(x, weight), axis_name)
    return y if bias is None else y + maybe_cast_to_compute(bias, "linear")


def vocab_parallel_embedding(ids, weight, num_embeddings, axis_name="mp"):
    """Lookup in a table cut along its rows over mp (`weight` this
    rank's rows); ids are clipped into [0, num_embeddings)."""
    if env.axis_size(axis_name) == 1:
        return F.embedding(ids, weight)
    rows = weight.shape[0]
    lo = env.axis_index(axis_name) * rows
    idx = ids.long().clamp(0, num_embeddings - 1) - lo
    inside = (idx >= 0) & (idx < rows)
    got = weight[torch.where(inside, idx, 0)]
    return mp_allreduce(torch.where(inside[..., None], got, 0.0), axis_name)


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, label, axis_name, ignore_index):
        lf = logits.float()
        rows = lf.shape[-1]
        lo = env.axis_index(axis_name) * rows
        m = _psum_raw(lf.amax(dim=-1), axis_name, "parallel_ce",
                      op=ReduceOp.MAX)
        e = torch.exp(lf - m[..., None])
        idx = label.long()
        valid = idx != ignore_index
        local = idx - lo
        inside = valid & (local >= 0) & (local < rows)
        local = torch.where(inside, local, 0)
        tgt = torch.where(inside, lf.gather(-1, local[..., None])[..., 0],
                          0.0)
        sums = _psum_raw(torch.stack([e.sum(dim=-1), tgt]), axis_name,
                         "parallel_ce")
        loss = torch.where(valid, torch.log(sums[0]) + m - sums[1], 0.0)
        ctx.save_for_backward(e, sums[0], local, inside, valid)
        ctx.dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        e, s, local, inside, valid = ctx.saved_tensors
        p = e / s[..., None]
        p.scatter_add_(-1, local[..., None],
                       -inside.to(p.dtype)[..., None])
        grad = p * torch.where(valid, g, 0.0)[..., None]
        return grad.to(ctx.dtype), None, None, None


def parallel_cross_entropy(logits, label, ignore_index=-100,
                           axis_name="mp"):
    """Per-token f32 losses of logits cut along the vocab over mp
    (`logits` [..., vocab / mp], `label` global ids); a label equal to
    `ignore_index` gives 0. With mp of size 1, `cross_entropy`."""
    if env.axis_size(axis_name) == 1:
        return F.cross_entropy(logits, label, ignore_index=ignore_index,
                               reduction="none")
    return _VocabParallelCE.apply(logits, label, axis_name, ignore_index)


def _tagged(module, tags):
    """Record the `mesh_axes` tags (local name -> (axes, groups)) that
    shard_model reads."""
    module.mesh_axes = dict(tags)
    return module


def _check_cut(module, name):
    if env.axis_size("mp") > 1 and name not in getattr(module, "_mesh_cut",
                                                       {}):
        raise RuntimeError(f"{type(module).__name__}: mp > 1 but its "
                           f"{name!r} is not cut; call "
                           "distributed.shard_model(model) first")


class VocabParallelEmbedding(torch.nn.Module):
    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.num_embeddings = int(num_embeddings)
        self.weight = torch.nn.Parameter(torch.empty(
            (num_embeddings, embedding_dim), device=device, dtype=dtype))
        with torch.no_grad():
            self.weight.normal_(0.0, 0.02)
        _tagged(self, {"weight": (VOCAB_PARALLEL_WEIGHT_AXES, 1)})

    def forward(self, x):
        _check_cut(self, "weight")
        return vocab_parallel_embedding(x, self.weight, self.num_embeddings)


def _linear_params(module, in_features, out_features, has_bias, device,
                   dtype):
    module.weight = torch.nn.Parameter(torch.empty(
        (in_features, out_features), device=device, dtype=dtype))
    with torch.no_grad():
        bound = math.sqrt(6.0 / (in_features + out_features))
        module.weight.uniform_(-bound, bound)       # XavierUniform
    module.bias = torch.nn.Parameter(torch.zeros(
        (out_features,), device=device, dtype=dtype)) if has_bias else None


class ColumnParallelLinear(torch.nn.Module):
    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, mp_group=None,
                 fuse_matmul_bias=False, name=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        _linear_params(self, in_features, out_features, has_bias, device,
                       dtype)
        self.gather_output = gather_output
        tags = {"weight": (COLUMN_PARALLEL_WEIGHT_AXES, 1)}
        if has_bias:
            tags["bias"] = (COLUMN_PARALLEL_BIAS_AXES, 1)
        _tagged(self, tags)

    def forward(self, x):
        _check_cut(self, "weight")
        out = column_parallel(x, self.weight, self.bias)
        return c_concat(out) if self.gather_output else out


class RowParallelLinear(torch.nn.Module):
    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False, mp_group=None,
                 fuse_matmul_bias=False, name=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        _linear_params(self, in_features, out_features, has_bias, device,
                       dtype)
        self.input_is_parallel = input_is_parallel
        _tagged(self, {"weight": (ROW_PARALLEL_WEIGHT_AXES, 1)})

    def forward(self, x):
        _check_cut(self, "weight")
        if not self.input_is_parallel:
            x = c_split(x)
        return row_parallel(x, self.weight, self.bias)


class ParallelCrossEntropy(torch.nn.Module):
    """Per-token losses over vocab-parallel logits (reference
    `c_softmax_with_cross_entropy_op.cu`)."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, input, label):  # noqa: A002
        return parallel_cross_entropy(input, label,
                                      ignore_index=self.ignore_index)
