"""Weight-only int8 — the port of paddle_tpu/quant/wo8.py.

Decode re-reads every weight for a handful of tokens, so storing Linear
weights as int8 with per-output-channel f32 scales halves the bytes a
step reads while activations and accumulation stay in their own dtype.
The int8 codes and scales are bit-identical to the JAX package's on the
same weights (`channelwise_int8`), and the names are the same —
`wq`/`w_scale` buffers, the bias a parameter — so a quantized state
loads across by name (`convert.load_jax_params`).

Usage:
    model = GPTForPretraining(cfg)
    quantize_weights_int8(model)               # in-place Linear swap
    ids, scores = model.generate(prompt, max_new_tokens=...)
"""
import torch

from .. import nn
from ..ops.int8_matvec import _BLOCK_V

__all__ = ["WeightOnlyInt8Linear", "WeightOnlyInt8Embedding",
           "quantize_weights_int8", "quantize_for_decode",
           "channelwise_int8"]


def channelwise_int8(w, bits=8):
    """Per-OUTPUT-channel (last axis) symmetric int8 of an f32 tensor:
    (wq int8, scale f32) with w ~= wq * scale. The JAX package's numpy
    arithmetic in f32: the scale is max|w| over the first axis floored
    at 1e-8 over qmax, the codes round half to even and clip to
    [-qmax, qmax]."""
    qmax = 2.0 ** (bits - 1) - 1
    w = w.detach().float()
    scale = w.abs().amax(dim=0).clamp(min=1e-8) / qmax
    wq = torch.round(w / scale).clamp(-qmax, qmax).to(torch.int8)
    return wq, scale


class WeightOnlyInt8Linear(torch.nn.Module):
    """Drop-in Linear replacement: int8 wq [in, out] and f32 w_scale
    [out] as persistent buffers, the bias kept as a parameter. forward
    converts wq to x's dtype, a dequantized-copy-per-call product as in
    the JAX package, which leaves this product to XLA."""

    def __init__(self, layer, bits=8):
        super().__init__()
        wq, ws = channelwise_int8(layer.weight, bits)
        self.register_buffer("w_scale", ws)
        self.register_buffer("wq", wq)
        self.bias = layer.bias

    def forward(self, x):
        out = torch.matmul(x, self.wq.to(x.dtype)) * self.w_scale.to(x.dtype)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out


class WeightOnlyInt8Embedding(torch.nn.Module):
    """Embedding with int8 rows and per-ROW f32 scales. One quantization
    serves both uses of a tied LM-head table: the lookup dequantizes the
    gathered rows, and the vocab projection (`GPTForPretraining.lm_head`)
    reads the same int8 table and scales after the contraction. Rows are
    padded with zero codes and zero scales to a multiple of 1024 (the JAX
    head kernel's block, kept as part of the weights' shape); ids clip to
    the TRUE vocab, so an out-of-range id maps to the last real row."""

    def __init__(self, layer, bits=8):
        super().__init__()
        w = layer.weight.detach()                    # [V, H]
        wq_t, ws = channelwise_int8(w.t(), bits)     # per ROW of w
        wq, V = wq_t.t(), w.shape[0]
        pad = (-V) % _BLOCK_V
        if pad:
            wq = torch.cat([wq, wq.new_zeros((pad, w.shape[1]))])
            ws = torch.cat([ws, ws.new_zeros((pad,))])
        self.num_embeddings = V
        self.register_buffer("wq", wq.contiguous())  # int8 [Vp, H]
        self.register_buffer("w_scale", ws)          # f32 [Vp]

    def forward(self, ids):
        # dequantize into the scale's dtype: a bf16 decode casts the
        # scale buffer to bf16, so the rows enter the stack in bf16 as an
        # unquantized embedding's would
        idx = ids.long().clamp(0, self.num_embeddings - 1)
        return self.wq[idx].to(self.w_scale.dtype) * self.w_scale[idx][..., None]


def _holds_wo8(layer):
    return any(isinstance(m, (WeightOnlyInt8Linear, WeightOnlyInt8Embedding))
               for m in layer.modules())


def quantize_for_decode(model, bits=8, min_features=0):
    """The weight-only-int8 entry for decode consumers (the serving
    engine's `weights="wo8"`): idempotent — an already-quantized model is
    left as it is (returns 0), so its scales are never quantized again —
    and loud: a model with nothing to quantize raises instead of serving
    full-precision weights under a "wo8" label. Linears only. Returns
    the number of swapped layers."""
    if _holds_wo8(model):
        return 0
    swapped = quantize_weights_int8(model, bits=bits,
                                    min_features=min_features)
    if swapped == 0:
        raise ValueError(
            "quantize_for_decode: model holds no quantizable nn.Linear "
            "layers — refusing to serve full-precision weights as wo8")
    return swapped


def quantize_weights_int8(layer, bits=8, min_features=0, embeddings=False):
    """Replace every `nn.Linear` under `layer` with a
    WeightOnlyInt8Linear in place (norms are untouched); with
    embeddings=True every `nn.Embedding` too, per row — the tied LM head
    then reads the int8 table (through `int8_matvec` at decode sizes on
    the card). `min_features` skips layers whose smaller dimension is
    below it. Returns the count of swapped layers."""
    swapped = 0
    for name, child in list(layer.named_children()):
        if isinstance(child, nn.Linear):
            if min(child.weight.shape) >= min_features:
                setattr(layer, name, WeightOnlyInt8Linear(child, bits))
                swapped += 1
        elif embeddings and isinstance(child, nn.Embedding):
            if min(child.weight.shape) >= min_features:
                setattr(layer, name, WeightOnlyInt8Embedding(child, bits))
                swapped += 1
        else:
            swapped += quantize_weights_int8(child, bits, min_features,
                                             embeddings)
    return swapped
