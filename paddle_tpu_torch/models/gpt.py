"""GPT decoder — the port of paddle_tpu/models/gpt.py.

Same parameter names as the JAX model (`gpt.wte.weight`,
`gpt.blocks.0.attn.qkv_proj.weight`, ...), same layouts (Linear W is
[in, out]) and the same composed numerics, so `convert.load_jax_params`
moves weights over by name and the two agree in f32.

The large products (qkv, out_proj, fc1/fc2, the tied head) are
`torch.matmul`: the JAX package leaves them to XLA outside any Pallas
kernel. Attention is `ops.attention.flash_attention` (the composed
attention with `use_flash_attention=False`) and the residual add + ln2
site `nn.fused_add_layer_norm`, which reach the flash and add+LayerNorm
kernels on the card. With `remat` each block of the dense forward runs
under `distributed.recompute` (its activations recomputed in the
backward); with the `use_fused_ce` flag the loss is
`ops.fused_ce.fused_linear_cross_entropy` over the tied table, which
never forms the [tokens, vocab] logits. `sequence_parallel` (ring or
Ulysses attention over a mesh) is not ported: a config that sets it can
be built, and running it raises. `GPTModel.forward` is a dense causal
forward over a whole sequence, the training path (`loss`), or, given
`caches=` and `offset=`, an incremental step over fixed-shape KV buffers
(`init_cache`), the decode path of `generate`: a one-token step attends
through the `decode_fused` kernel, a prompt through the composed
attention. `offset` is a host integer or, as the JAX forward takes a
traced scalar, a 0-dim int32 tensor on the model's device: the position
then stays device data end to end (the cache write is an `index_copy_`,
`decode_fused` reads it from device memory), so `generate`'s token step
can be captured once and replayed at every position. Under weight-only int8 (`quant.wo8`) the tied head reads the
int8 table, through the `int8_matvec` kernel at decode sizes on the
card. The serving engine drives the blocks itself over the paged cache
(serving/engine.py).
"""
import math
import operator

import torch

from .. import nn
from ..amp import amp_state, maybe_cast_to_compute
from ..device import resolve_device, resolve_dtype
from ..distributed.recompute import recompute
from ..flags import get_flag
from ..ops.attention import composed_attention, flash_attention
from ..ops.decode_attention import (decode_attention,
                                    decode_attention_supported)
from ..ops.fused_ce import fused_linear_cross_entropy
from ..ops.int8_matvec import int8_matvec, int8_matvec_preferred
from ..quant.wo8 import WeightOnlyInt8Embedding

__all__ = ["GPTConfig", "GPTAttention", "GPTMLP", "GPTBlock", "GPTModel",
           "GPTForPretraining"]


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, ffn_hidden_size=None, max_seq_len=1024,
                 dropout=0.0, attn_dropout=0.0, initializer_range=0.02,
                 use_flash_attention=True, sequence_parallel=None,
                 dtype="float32", remat=False):
        if hidden_size % num_heads:
            raise ValueError(f"hidden_size {hidden_size} is not a multiple "
                             f"of num_heads {num_heads}")
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.ffn_hidden_size = ffn_hidden_size or 4 * hidden_size
        self.max_seq_len = max_seq_len
        self.dropout = dropout
        self.attn_dropout = attn_dropout
        self.initializer_range = initializer_range
        # False: the composed attention instead of the flash kernels
        self.use_flash_attention = use_flash_attention
        # None | "ring" | "ulysses": context parallelism over a mesh's sp
        # axis, not ported (ROADMAP Queue 1 item 6); running it raises
        self.sequence_parallel = sequence_parallel
        self.dtype = dtype
        # per-block recompute: the backward keeps only block inputs
        self.remat = remat

    @staticmethod
    def _preset(defaults, kw):
        return GPTConfig(**{**defaults, **kw})

    @staticmethod
    def gpt3_125m(**kw):
        return GPTConfig._preset(
            dict(hidden_size=768, num_layers=12, num_heads=12), kw)

    @staticmethod
    def gpt3_350m(**kw):
        return GPTConfig._preset(
            dict(hidden_size=1024, num_layers=24, num_heads=16), kw)

    @staticmethod
    def gpt3_1_3b(**kw):
        return GPTConfig._preset(
            dict(hidden_size=2048, num_layers=24, num_heads=16), kw)

    @staticmethod
    def gpt3_13b(**kw):
        return GPTConfig._preset(
            dict(hidden_size=5120, num_layers=40, num_heads=40), kw)

    @staticmethod
    def gpt3_1_3b_128k(**kw):
        """The JAX package's >= 128k-context preset: ring attention over
        the sp mesh axis, per-block remat. Its sequence parallelism is
        not ported, so it can be built but not run."""
        return GPTConfig._preset(
            dict(hidden_size=2048, num_layers=24, num_heads=16,
                 max_seq_len=131072, sequence_parallel="ring",
                 remat=True), kw)


class GPTAttention(torch.nn.Module):
    def __init__(self, config, device=None, dtype=torch.float32):
        super().__init__()
        c = config
        self.num_heads = c.num_heads
        self.head_dim = c.hidden_size // c.num_heads
        self.hidden_size = c.hidden_size
        self.attn_dropout = c.attn_dropout
        self.use_flash = c.use_flash_attention
        self.qkv_proj = nn.Linear(c.hidden_size, 3 * c.hidden_size,
                                  device=device, dtype=dtype)
        self.out_proj = nn.Linear(c.hidden_size, c.hidden_size,
                                  device=device, dtype=dtype)

    def project_qkv(self, x):
        """[b, s, d] -> three [b, s, n, h] tensors: the single qkv
        reshape/split the dense forward and the serving engine share."""
        b, s = x.shape[0], x.shape[1]
        qkv = self.qkv_proj(x).reshape(b, s, 3, self.num_heads,
                                       self.head_dim)
        return qkv.unbind(dim=2)

    def forward(self, x, cache=None, offset=None, decode_chunks=None):
        """cache: optional (k_buf, v_buf) of fixed shape from
        `GPTModel.init_cache` — flat [b, max_len, n*h]; offset: how many
        positions are filled (a host integer, or a 0-dim int32 tensor on
        x's device, which a one-token step on the card reads with
        `decode_chunks`, its `decode_fused` chunk count). With a cache,
        returns (out, (k_buf, v_buf))."""
        b, s = x.shape[0], x.shape[1]
        q, k, v = self.project_qkv(x)
        if cache is not None:
            out, k_buf, v_buf = _cached_attention(
                q, k, v, cache[0], cache[1], _offset(offset), decode_chunks)
            return (self.out_proj(out.reshape(b, s, self.hidden_size)),
                    (k_buf, v_buf))
        if self.use_flash:
            out = flash_attention(q, k, v, dropout=self.attn_dropout,
                                  causal=True, training=self.training)
        else:
            valid = torch.ones((s, s), dtype=torch.bool,
                               device=x.device).tril()
            out = composed_attention(
                q, k, v, valid, dropout_p=self.attn_dropout
                if self.training else 0.0)
        return self.out_proj(out.reshape(b, s, self.hidden_size))


def _offset(offset):
    """A forward's `offset`: None -> 0, a tensor as it is (a device
    position), anything else as a host integer."""
    if offset is None:
        return 0
    if isinstance(offset, torch.Tensor):
        return offset
    return operator.index(offset)


def _cached_attention(q, k_new, v_new, k_buf, v_buf, off, chunks=None):
    """Incremental attention: write k/v at positions off..off+s-1 (in
    place: the buffers are the decode loop's own), then attend q (s
    tokens at those positions) over the valid prefix of the FLAT
    [b, L, n*h] buffers: a one-token step runs the `decode_fused` kernel,
    a prompt the composed attention over a [b, L, n, h] view. Neither
    path copies the buffers. A tensor `off` (0-dim int32, on the
    buffers' device) writes through `index_copy_` at device positions;
    the values written are the same."""
    b, s, n, h = q.shape
    L = k_buf.shape[1]
    if isinstance(off, torch.Tensor):
        at = off + torch.arange(s, device=off.device)
        k_buf.index_copy_(1, at, k_new.reshape(b, s, n * h).to(k_buf.dtype))
        v_buf.index_copy_(1, at, v_new.reshape(b, s, n * h).to(v_buf.dtype))
    else:
        k_buf[:, off:off + s] = k_new.reshape(b, s, n * h)
        v_buf[:, off:off + s] = v_new.reshape(b, s, n * h)
    if s == 1:
        out = decode_attention(q.reshape(b, 1, n * h).contiguous(),
                               k_buf, v_buf, off, n, chunks).to(q.dtype)
        return out.reshape(b, 1, n, h), k_buf, v_buf
    k4, v4 = k_buf.view(b, L, n, h), v_buf.view(b, L, n, h)
    key_pos = torch.arange(L, device=q.device)[None, None, None, :]
    q_pos = (off + torch.arange(s, device=q.device))[None, None, :, None]
    return composed_attention(q, k4, v4, key_pos <= q_pos), k_buf, v_buf


class GPTMLP(torch.nn.Module):
    def __init__(self, config, device=None, dtype=torch.float32):
        super().__init__()
        c = config
        self.fc1 = nn.Linear(c.hidden_size, c.ffn_hidden_size,
                             device=device, dtype=dtype)
        self.fc2 = nn.Linear(c.ffn_hidden_size, c.hidden_size,
                             device=device, dtype=dtype)

    def forward(self, x):
        return self.fc2(nn.gelu(self.fc1(x)))


class GPTBlock(torch.nn.Module):
    # FFN factory hook: the MoE family (moe.GPTMoEBlock) swaps the dense
    # MLP for the routed MoEFFN here
    mlp_cls = GPTMLP

    def __init__(self, config, device=None, dtype=torch.float32):
        super().__init__()
        h = config.hidden_size
        self.ln1 = nn.LayerNorm(h, device=device, dtype=dtype)
        self.attn = GPTAttention(config, device=device, dtype=dtype)
        self.ln2 = nn.LayerNorm(h, device=device, dtype=dtype)
        self.mlp = self.mlp_cls(config, device=device, dtype=dtype)
        self.dropout = nn.Dropout(config.dropout)

    def forward(self, x, cache=None, offset=None, decode_chunks=None):
        if cache is not None:
            a, new_cache = self.attn(self.ln1(x), cache=cache, offset=offset,
                                     decode_chunks=decode_chunks)
            y, h = self._add_ln2(x, self.dropout(a))
            return h + self.dropout(self.mlp(y)), new_cache
        y, h = self._add_ln2(x, self.dropout(self.attn(self.ln1(x))))
        return h + self.dropout(self.mlp(y))

    def _add_ln2(self, x, delta):
        """The residual-add + ln2 site in one op: (ln2(x+delta), x+delta)."""
        return nn.fused_add_layer_norm(x, delta, self.ln2.weight,
                                       self.ln2.bias, self.ln2.epsilon)


class GPTModel(torch.nn.Module):
    # block factory hook (the MoE family: moe.GPTMoEModel)
    block_cls = GPTBlock

    def __init__(self, config, device=None, dtype=torch.float32):
        super().__init__()
        c = self.config = config
        self.wte = nn.Embedding(c.vocab_size, c.hidden_size, device=device,
                                dtype=dtype)
        self.wpe = nn.Embedding(c.max_seq_len, c.hidden_size,
                                device=device, dtype=dtype)
        self.drop = nn.Dropout(c.dropout)
        self.blocks = torch.nn.ModuleList(
            [self.block_cls(c, device=device, dtype=dtype)
             for _ in range(c.num_layers)])
        self.ln_f = nn.LayerNorm(c.hidden_size, device=device, dtype=dtype)

    def init_cache(self, batch_size, max_len, dtype=None):
        """Fixed-shape KV buffers, one (k, v) pair per block, zeroed, in
        `dtype` (default: the config's dtype, as in the JAX package), FLAT
        [b, max_len, n*h]: the layout of `decode_fused`, which runs every
        one-token step. Off the CPU (where the plain version takes any
        head dim) a head dim the kernel has no instance for raises."""
        c = self.config
        dev = self.ln_f.weight.device
        dt = resolve_dtype(dtype or c.dtype)
        if dev.type != "cpu" and not decode_attention_supported(
                c.hidden_size, c.num_heads):
            raise ValueError(
                f"init_cache: head_dim {c.hidden_size / c.num_heads} has no "
                "decode_fused kernel on the card (head_dim 64 or 128)")
        shape = (batch_size, max_len, c.hidden_size)
        return [(torch.zeros(shape, dtype=dt, device=dev),
                 torch.zeros(shape, dtype=dt, device=dev))
                for _ in self.blocks]

    def forward(self, input_ids, caches=None, offset=None,
                decode_chunks=None):
        """Dense causal forward over positions 0..s-1 -> ln_f(h); with
        `caches` an incremental forward at positions offset..offset+s-1
        -> (ln_f(h), caches). `offset` is a host integer or a 0-dim int32
        tensor on the model's device; `decode_chunks` is the
        `decode_fused` chunk count a one-token step at a device offset
        launches with (ops.decode_attention.decode_split)."""
        if self.config.sequence_parallel is not None:
            raise NotImplementedError(
                f"sequence_parallel={self.config.sequence_parallel!r}: ring "
                "and Ulysses attention are not ported yet (ROADMAP Queue 1 "
                "item 6)")
        s = input_ids.shape[1]
        off = _offset(offset)
        pos = (off + torch.arange(s, device=input_ids.device))[None, :]
        h = self.drop(self.wte(input_ids) + self.wpe(pos))
        if caches is not None:
            new_caches = []
            for block, cache in zip(self.blocks, caches):
                h, nc = block(h, cache=cache, offset=off,
                              decode_chunks=decode_chunks)
                new_caches.append(nc)
            return self.ln_f(h), new_caches
        for block in self.blocks:
            h = recompute(block, h) if self.config.remat else block(h)
        return self.ln_f(h)


class GPTForPretraining(torch.nn.Module):
    """GPT with the LM head tied to `wte`.

    `device=None` builds on the CUDA card (raises without one); the
    weights are drawn from a `torch.Generator` seeded with `seed`, with
    the JAX model's initialisers: N(0, initializer_range) for the
    embeddings, qkv/out_proj and fc1, N(0, initializer_range /
    sqrt(2 * num_layers)) for fc2, zero biases, unit LayerNorm scales.
    On `device="meta"` the model is a skeleton with no values to draw:
    `tools.serve_13b_w8a16` materialises it a piece at a time, drawing
    each parameter with `init_parameter` in this order from one
    generator, which gives the values of a whole build.
    """

    # model factory hook (the MoE family: moe.GPTMoE)
    model_cls = GPTModel

    def __init__(self, config, device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        dtype = resolve_dtype(config.dtype)
        self.config = config
        self.gpt = self.model_cls(config, device=device, dtype=dtype)
        if device.type != "meta":
            self.init_weights(seed)

    @torch.no_grad()
    def init_weights(self, seed):
        dev = self.gpt.wte.weight.device
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        for name, p in self.named_parameters():
            self.init_parameter(name, p, gen)

    @torch.no_grad()
    def init_parameter(self, name, p, gen):
        """Give the parameter `name` of this model its initial value,
        drawing from `gen` where the initialiser is random."""
        c = self.config
        std = c.initializer_range
        if ".ln" in name:       # LayerNorm: unit scale, zero shift
            if name.endswith(".weight"):
                p.fill_(1.0)
            else:
                p.zero_()
        elif name.endswith(".bias"):
            p.zero_()
        else:
            p.normal_(0.0, std / math.sqrt(2 * c.num_layers)
                      if name.endswith("fc2.weight") else std, generator=gen)

    def forward(self, input_ids, caches=None, offset=None,
                decode_chunks=None):
        if caches is not None:
            h, new_caches = self.gpt(input_ids, caches=caches, offset=offset,
                                     decode_chunks=decode_chunks)
            return self.lm_head(h), new_caches
        return self.lm_head(self.gpt(input_ids))

    def lm_head(self, h):
        """Vocab projection of hidden states [b, s, d] over the tied
        `wte` table -> logits [b, s, vocab]. Under amp: a bf16 product
        accumulated in f32 and emitted in bf16 (an f32 [b, s, vocab]
        tensor would double the head's and the loss's traffic; the loss
        accumulates its log-sum-exp in f32 anyway). Otherwise f32
        logits: the JAX head emits its f32 accumulator
        (`preferred_element_type=f32`), and products of bf16 values are
        exact in f32, so the f32 product below is the same arithmetic.
        A weight-only-int8 table takes `_head_q`."""
        wte = self.gpt.wte
        if isinstance(wte, WeightOnlyInt8Embedding):
            return self._head_q(h, wte)
        w = wte.weight
        if amp_state().enabled:
            return torch.matmul(maybe_cast_to_compute(h, "matmul"),
                                maybe_cast_to_compute(w, "matmul").t())
        return torch.matmul(h.float(), w.float().t())

    @staticmethod
    def _head_q(h, wte):
        """The head over an int8 table padded to a multiple of 1024 rows:
        `int8_matvec` (h rounded to bf16, f32 sums, scaled per row) for
        decode-sized row counts on the card when no gradient can flow
        (the kernel has no backward); otherwise the composed product
        (h·wq^T)·scale accumulated in f32, h in the compute dtype. Logits
        are sliced to the true vocab, and cast to bf16 under amp."""
        b, s, d = h.shape
        amp_on = amp_state().enabled
        grad_live = torch.is_grad_enabled() and h.requires_grad
        if int8_matvec_preferred(b * s, h.device) and not grad_live:
            out = int8_matvec(h.reshape(b * s, d).contiguous(), wte.wq,
                              wte.w_scale).reshape(b, s, -1)
        else:
            cdt = torch.bfloat16 if amp_on else h.dtype
            out = torch.matmul(h.to(cdt).float(), wte.wq.float().t()) \
                * wte.w_scale.float()
        out = out[..., :wte.num_embeddings]
        return out.to(torch.bfloat16) if amp_on else out

    def generate(self, input_ids, max_new_tokens=32,
                 decode_strategy="greedy", top_k=0, top_p=1.0,
                 temperature=1.0, num_beams=1, length_penalty=0.0,
                 eos_token_id=None, pad_token_id=0, seed=None,
                 dtype="bfloat16", device=None):
        """Autoregressive decoding over a static KV cache: one prefill,
        then one token per step. decode_strategy "greedy" | "sampling"
        (top_k/top_p/temperature) | "beam_search" (num_beams,
        length_penalty). dtype: decode compute dtype ("bfloat16", or
        None for the parameters' own). device=None decodes on the card
        (raises without one). Returns (ids [b, prompt + max_new_tokens],
        scores [b]); see `generation.run_generate`."""
        from ..generation import run_generate
        return run_generate(
            self, input_ids, max_new_tokens=max_new_tokens,
            decode_strategy=decode_strategy, top_k=top_k, top_p=top_p,
            temperature=temperature, num_beams=num_beams,
            length_penalty=length_penalty, eos_token_id=eos_token_id,
            pad_token_id=pad_token_id, seed=seed, dtype=dtype, device=device)

    def loss(self, input_ids, labels, loss_mask=None):
        """Mean next-token cross entropy against `labels`, over the
        positions `loss_mask` keeps when it is given. With the
        `use_fused_ce` flag: the fused projection + cross entropy over the
        tied table (h cast as the head casts it under amp, the table in
        its own dtype); otherwise the logits and `cross_entropy`."""
        if get_flag("use_fused_ce"):
            h = self.gpt(input_ids)
            losses = fused_linear_cross_entropy(
                maybe_cast_to_compute(h, "matmul").reshape(-1, h.shape[-1]),
                self.gpt.wte.weight, labels.reshape(-1))
        else:
            logits = self(input_ids)
            losses = nn.functional.cross_entropy(
                logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
                reduction="none")
        if loss_mask is not None:
            m = loss_mask.reshape(-1)
            return (losses * m).sum() / m.sum()
        return losses.mean()
