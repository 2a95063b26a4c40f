"""The port's nn layers: the JAX package's parameter layouts and
numerics as `torch.nn.Module`s.

`Linear` keeps W as [in, out] (paddle_tpu/nn/layer/common.py:21-37) so
JAX parameters load with no transpose. Parameters are created empty on
the given device; the model that owns them initialises them from an
explicit `torch.Generator`.
"""
import torch

from . import clip, functional
from .functional import fused_add_layer_norm, gelu

__all__ = ["Linear", "Embedding", "LayerNorm", "Dropout", "clip",
           "functional", "fused_add_layer_norm", "gelu"]


def _param(shape, device, dtype):
    return torch.nn.Parameter(torch.empty(shape, device=device,
                                          dtype=dtype))


class Linear(torch.nn.Module):
    """y = x W + b, W: [in, out]."""

    def __init__(self, in_features, out_features, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        self.weight = _param((in_features, out_features), device, dtype)
        self.bias = _param((out_features,), device, dtype)

    def forward(self, x):
        return functional.linear(x, self.weight, self.bias)


class Embedding(torch.nn.Module):
    def __init__(self, num_embeddings, embedding_dim, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.num_embeddings = int(num_embeddings)
        self.embedding_dim = int(embedding_dim)
        self.weight = _param((num_embeddings, embedding_dim), device, dtype)

    def forward(self, ids):
        return functional.embedding(ids, self.weight)


class LayerNorm(torch.nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-5, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.epsilon = float(epsilon)
        self.weight = _param((normalized_shape,), device, dtype)
        self.bias = _param((normalized_shape,), device, dtype)
        self.reset_parameters()

    def reset_parameters(self):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        return functional.layer_norm(x, self.weight, self.bias,
                                     self.epsilon)


class Dropout(torch.nn.Module):
    def __init__(self, p=0.5):
        super().__init__()
        self.p = float(p)

    def forward(self, x):
        return functional.dropout(x, self.p, self.training)
