"""The port's kernel registry: one entry per hand-written kernel.

Counterpart of paddle_tpu/ops/kernel_registry.py, under the same kernel
names. Each entry holds the kernel's wrapper (launches the CUDA kernel
on a CUDA tensor, takes the plain version on a CPU tensor), the plain
PyTorch version it is held against, the tolerance per dtype, where its
source lives, which TPU kernel it replaces, and a launch counter: a plain
integer the wrapper increments on every launch, and nowhere else, so a
run can show that its main path went through the kernel.

Like the JAX registry's `example`, each entry also carries what the
kernel observatory (telemetry/kernel_obs.py) measures it with:

- `example(rng, device="cpu", small=False)` — the wrapper's positional
  arguments at the main path's shape the smoke times (PERF.md §6's row),
  drawn from the numpy Generator `rng` and put on `device`; `small`
  gives the same structure at a size the CPU tests can run;
- `cost(args)` — (operations, bytes) of one call on these arguments:
  each input read once and each output written once, each distinct byte
  counted once, and where the work depends on the data (context
  lengths, routing maps) what these inputs need. `cost(args)` over the
  peaks is the bound column of PERF.md §6, computed in code.
"""
import numpy as np

__all__ = ["Kernel", "register_kernel", "get_kernel", "kernels",
           "reset_launches", "randn"]


class Kernel:
    __slots__ = ("name", "wrapper", "plain", "tol", "source", "replaces",
                 "launches", "example", "cost")

    def __init__(self, name, wrapper, plain, tol, source, replaces,
                 example=None, cost=None):
        self.name = name
        self.wrapper = wrapper
        self.plain = plain
        self.tol = dict(tol)        # dtype name -> (rtol, atol)
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self.example = example
        self.cost = cost

    def __repr__(self):
        return f"Kernel({self.name!r}, launches={self.launches})"


_KERNELS = {}


def register_kernel(name, plain, tol, source, replaces, example=None,
                    cost=None):
    """Decorator registering a kernel wrapper; returns it unchanged."""
    def deco(fn):
        if name in _KERNELS:
            raise ValueError(f"kernel {name!r} registered twice")
        _KERNELS[name] = Kernel(name, fn, plain, tol, source, replaces,
                                example, cost)
        return fn
    return deco


def get_kernel(name):
    return _KERNELS[name]


def kernels():
    """Every registered kernel (importing the modules that define them,
    which registers them)."""
    from . import (decode_attention, flash_attention, int8_matvec,  # noqa: F401
                   layernorm, paged_attention)
    from ..moe import kernels as moe_kernels  # noqa: F401
    return list(_KERNELS.values())


def reset_launches():
    for k in kernels():
        k.launches = 0


def randn(rng, shape, dtype, device):
    """Standard normals from the numpy Generator `rng` as a torch tensor
    of `dtype` on `device` (drawn in f32, so a seed gives the same
    values on every device)."""
    import torch
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    return x.to(device=device, dtype=dtype)
