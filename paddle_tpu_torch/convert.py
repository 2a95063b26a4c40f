"""Load JAX-package parameters into a port model.

The port keeps the JAX model's parameter names and layouts, so moving
weights over is a by-name copy with no transpose. The caller extracts
the arrays on the JAX side (this package never imports it):

    arrays = [(n, np.asarray(p._value))
              for n, p in jax_model.named_parameters()]
    load_jax_params(torch_model, arrays)
"""
import numpy as np
import torch

__all__ = ["load_jax_params"]


def load_jax_params(model, arrays):
    """Copy `arrays` ({name: ndarray} or (name, ndarray) pairs) into
    `model`'s parameters of the same names, casting to each parameter's
    dtype on its device. Raises KeyError on a missing or extra name and
    ValueError on a shape mismatch; nothing is copied unless every name
    and shape checks out."""
    src = dict(arrays)
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(src))
    extra = sorted(set(src) - set(params))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"unexpected {extra}")
    for name, p in params.items():
        shape = tuple(np.shape(src[name]))
        if shape != tuple(p.shape):
            raise ValueError(f"{name}: source shape {shape} != model "
                             f"shape {tuple(p.shape)}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(torch.from_numpy(np.array(src[name], copy=True)))
    return model
