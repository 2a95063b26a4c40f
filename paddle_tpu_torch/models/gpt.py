"""GPT decoder — the port of paddle_tpu/models/gpt.py.

Same parameter names as the JAX model (`gpt.wte.weight`,
`gpt.blocks.0.attn.qkv_proj.weight`, ...), same layouts (Linear W is
[in, out]) and the same composed numerics, so `convert.load_jax_params`
moves weights over by name and the two agree in f32.

The large products (qkv, out_proj, fc1/fc2, the tied head) are
`torch.matmul`: the JAX package leaves them to XLA outside any Pallas
kernel. Attention is `ops.attention.flash_attention` and the residual
add + ln2 site `nn.fused_add_layer_norm`, which reach the flash and
add+LayerNorm kernels on the card. `GPTModel.forward` is a dense causal
forward over a whole sequence, the training path (`loss`); the serving
engine drives the blocks itself over the paged cache
(serving/engine.py).
"""
import math

import torch

from .. import nn
from ..amp import amp_state, maybe_cast_to_compute
from ..device import resolve_device, resolve_dtype
from ..ops.attention import flash_attention

__all__ = ["GPTConfig", "GPTAttention", "GPTMLP", "GPTBlock", "GPTModel",
           "GPTForPretraining"]


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, ffn_hidden_size=None, max_seq_len=1024,
                 dropout=0.0, attn_dropout=0.0, initializer_range=0.02,
                 dtype="float32"):
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
        self.dtype = dtype

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


class GPTAttention(torch.nn.Module):
    def __init__(self, config, device=None, dtype=torch.float32):
        super().__init__()
        c = config
        self.num_heads = c.num_heads
        self.head_dim = c.hidden_size // c.num_heads
        self.hidden_size = c.hidden_size
        self.attn_dropout = c.attn_dropout
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

    def forward(self, x):
        b, s = x.shape[0], x.shape[1]
        q, k, v = self.project_qkv(x)
        out = flash_attention(q, k, v, dropout=self.attn_dropout,
                              causal=True, training=self.training)
        return self.out_proj(out.reshape(b, s, self.hidden_size))


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
    def __init__(self, config, device=None, dtype=torch.float32):
        super().__init__()
        h = config.hidden_size
        self.ln1 = nn.LayerNorm(h, device=device, dtype=dtype)
        self.attn = GPTAttention(config, device=device, dtype=dtype)
        self.ln2 = nn.LayerNorm(h, device=device, dtype=dtype)
        self.mlp = GPTMLP(config, device=device, dtype=dtype)
        self.dropout = nn.Dropout(config.dropout)

    def forward(self, x):
        y, h = self._add_ln2(x, self.dropout(self.attn(self.ln1(x))))
        return h + self.dropout(self.mlp(y))

    def _add_ln2(self, x, delta):
        """The residual-add + ln2 site in one op: (ln2(x+delta), x+delta)."""
        return nn.fused_add_layer_norm(x, delta, self.ln2.weight,
                                       self.ln2.bias, self.ln2.epsilon)


class GPTModel(torch.nn.Module):
    def __init__(self, config, device=None, dtype=torch.float32):
        super().__init__()
        c = self.config = config
        self.wte = nn.Embedding(c.vocab_size, c.hidden_size, device=device,
                                dtype=dtype)
        self.wpe = nn.Embedding(c.max_seq_len, c.hidden_size,
                                device=device, dtype=dtype)
        self.drop = nn.Dropout(c.dropout)
        self.blocks = torch.nn.ModuleList(
            [GPTBlock(c, device=device, dtype=dtype)
             for _ in range(c.num_layers)])
        self.ln_f = nn.LayerNorm(c.hidden_size, device=device, dtype=dtype)

    def forward(self, input_ids):
        """Dense causal forward over positions 0..s-1 -> ln_f(h)."""
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)[None, :]
        h = self.drop(self.wte(input_ids) + self.wpe(pos))
        for block in self.blocks:
            h = block(h)
        return self.ln_f(h)


class GPTForPretraining(torch.nn.Module):
    """GPT with the LM head tied to `wte`.

    `device=None` builds on the CUDA card (raises without one); the
    weights are drawn from a `torch.Generator` seeded with `seed`, with
    the JAX model's initialisers: N(0, initializer_range) for the
    embeddings, qkv/out_proj and fc1, N(0, initializer_range /
    sqrt(2 * num_layers)) for fc2, zero biases, unit LayerNorm scales.
    """

    def __init__(self, config, device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        dtype = resolve_dtype(config.dtype)
        self.config = config
        self.gpt = GPTModel(config, device=device, dtype=dtype)
        self.init_weights(seed)

    @torch.no_grad()
    def init_weights(self, seed):
        c = self.config
        dev = self.gpt.wte.weight.device
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        std = c.initializer_range
        out_std = std / math.sqrt(2 * c.num_layers)
        for name, p in self.named_parameters():
            if ".ln" in name:
                continue        # LayerNorm: unit scale, zero shift
            if name.endswith(".bias"):
                p.zero_()
            else:
                p.normal_(0.0, out_std if name.endswith("fc2.weight")
                          else std, generator=gen)

    def forward(self, input_ids):
        return self.lm_head(self.gpt(input_ids))

    def lm_head(self, h):
        """Vocab projection of hidden states [b, s, d] over the tied
        `wte` table -> logits [b, s, vocab]. Under amp: a bf16 product
        accumulated in f32 and emitted in bf16 (an f32 [b, s, vocab]
        tensor would double the head's and the loss's traffic; the loss
        accumulates its log-sum-exp in f32 anyway). Otherwise f32
        logits: the JAX head emits its f32 accumulator
        (`preferred_element_type=f32`), and products of bf16 values are
        exact in f32, so the f32 product below is the same arithmetic."""
        w = self.gpt.wte.weight
        if amp_state().enabled:
            return torch.matmul(maybe_cast_to_compute(h, "matmul"),
                                maybe_cast_to_compute(w, "matmul").t())
        return torch.matmul(h.float(), w.float().t())

    def loss(self, input_ids, labels, loss_mask=None):
        """Mean next-token cross entropy of the logits against `labels`
        (the JAX model's non-fused branch), over the positions
        `loss_mask` keeps when it is given."""
        logits = self(input_ids)
        losses = nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
            reduction="none")
        if loss_mask is not None:
            m = loss_mask.reshape(-1)
            return (losses * m).sum() / m.sum()
        return losses.mean()
