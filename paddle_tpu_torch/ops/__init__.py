"""Kernels of the port and their plain PyTorch versions.

`kernel_registry` lists every hand-written kernel with its launch
counter; `_build` compiles the CUDA sources under `csrc/` with nvcc at
first use; `paged_attention` holds the serving path's two kernels.
"""
from .paged_attention import flash_prefill_chunk, paged_decode_attention

__all__ = ["paged_decode_attention", "flash_prefill_chunk"]
