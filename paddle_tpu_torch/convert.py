"""Load JAX-package weights into a port model.

The port keeps the JAX model's parameter and buffer names and layouts,
so moving weights over is a by-name copy with no transpose. The caller
extracts the arrays on the JAX side (this package never imports it);
a model quantized with weight-only int8 carries its `wq`/`w_scale` as
persistable buffers, which travel the same way:

    arrays = [(n, np.asarray(t._value))
              for n, t in [*jax_model.named_parameters(),
                           *jax_model.named_buffers()]]
    load_jax_params(torch_model, arrays)
"""
import numpy as np
import torch

__all__ = ["load_jax_params"]


def load_jax_params(model, arrays):
    """Copy `arrays` ({name: ndarray} or (name, ndarray) pairs) into
    `model`'s parameters and persistent buffers of the same names,
    casting floats to each target's dtype on its device; integer arrays
    (int8 codes) go only into integer targets and stay as they are.
    Raises KeyError on a missing or extra name, ValueError on a shape
    mismatch and TypeError on a float/integer mismatch; nothing is
    copied unless every name, shape and kind checks out."""
    src = dict(arrays)
    targets = model.state_dict(keep_vars=True)
    missing = sorted(set(targets) - set(src))
    extra = sorted(set(src) - set(targets))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"unexpected {extra}")
    for name, t in targets.items():
        a = np.asarray(src[name])
        if a.shape != tuple(t.shape):
            raise ValueError(f"{name}: source shape {a.shape} != model "
                             f"shape {tuple(t.shape)}")
        if (a.dtype.kind in "iub") == t.is_floating_point():
            raise TypeError(f"{name}: source dtype {a.dtype} cannot load "
                            f"into {t.dtype}")
    with torch.no_grad():
        for name, t in targets.items():
            t.copy_(torch.from_numpy(np.array(src[name], copy=True)))
    return model
