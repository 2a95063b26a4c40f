"""The port's kernel registry: one entry per hand-written kernel.

Counterpart of paddle_tpu/ops/kernel_registry.py, under the same kernel
names. Each entry holds the kernel's wrapper (launches the CUDA kernel
on a CUDA tensor, takes the plain version on a CPU tensor), the plain
PyTorch version it is held against, the tolerance per dtype, where its
source lives, which TPU kernel it replaces, and a launch counter: a plain
integer the wrapper increments on every launch, and nowhere else, so a
run can show that its main path went through the kernel.
"""

__all__ = ["Kernel", "register_kernel", "get_kernel", "kernels",
           "reset_launches"]


class Kernel:
    __slots__ = ("name", "wrapper", "plain", "tol", "source", "replaces",
                 "launches")

    def __init__(self, name, wrapper, plain, tol, source, replaces):
        self.name = name
        self.wrapper = wrapper
        self.plain = plain
        self.tol = dict(tol)        # dtype name -> (rtol, atol)
        self.source = source
        self.replaces = replaces
        self.launches = 0

    def __repr__(self):
        return f"Kernel({self.name!r}, launches={self.launches})"


_KERNELS = {}


def register_kernel(name, plain, tol, source, replaces):
    """Decorator registering a kernel wrapper; returns it unchanged."""
    def deco(fn):
        if name in _KERNELS:
            raise ValueError(f"kernel {name!r} registered twice")
        _KERNELS[name] = Kernel(name, fn, plain, tol, source, replaces)
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
