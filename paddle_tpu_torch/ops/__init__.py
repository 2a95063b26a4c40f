"""Kernels of the port and their plain PyTorch versions.

`kernel_registry` lists every hand-written kernel with its launch
counter; `_build` compiles the CUDA sources under `csrc/` with nvcc at
first use; `paged_attention` holds the serving path's two kernels,
`flash_attention` the training path's attention forward and backward,
`layernorm` the residual-add + LayerNorm; `attention` the dense entry
points and the composed math.
"""
from .attention import flash_attention, scaled_dot_product_attention
from .flash_attention import FlashAttention, flash_attention_fwd
from .layernorm import FusedAddLayerNormPair
from .paged_attention import flash_prefill_chunk, paged_decode_attention

__all__ = ["paged_decode_attention", "flash_prefill_chunk",
           "flash_attention", "scaled_dot_product_attention",
           "flash_attention_fwd", "FlashAttention", "FusedAddLayerNormPair"]
