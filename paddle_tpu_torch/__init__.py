"""paddle_tpu_torch — the PyTorch + CUDA port of `paddle_tpu`.

The JAX package stays the reference; this package is its counterpart for
an NVIDIA H100, ported slice by slice along the system's main paths. The
first slice is the serving path: GPT served through the continuous-
batching engine over the paged KV cache, with hand-written CUDA kernels
for the two attention kernels that path runs (`ops/paged_attention.py`).

Layout mirrors the JAX package so a reader finds each counterpart:

- `device`        — default-device resolution (CUDA, or raise);
- `nn`            — Linear ([in, out] weights), Embedding, LayerNorm,
                    Dropout, tanh-gelu, fused residual-add + LayerNorm;
- `models.gpt`    — GPTConfig presets and the GPT decoder;
- `convert`       — load JAX-package parameters into a port model;
- `ops`           — the kernel registry, the nvcc/ctypes build step and the
                    paged-attention kernels with their plain versions;
- `serving`       — BlockPool/PrefixIndex/PagedKVCache, the scheduler,
                    admission control and `ServingEngine`.

Entry points run on CUDA unless the caller passes `device="cpu"`; with
no GPU and no explicit CPU request they raise. This package never
imports `jax` or `paddle_tpu`.
"""
from .device import resolve_device, resolve_dtype

__all__ = ["resolve_device", "resolve_dtype"]
