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

`load_jax_optimizer_state` does the same for an optimizer in the middle
of training: the JAX optimizer's per-parameter states (moments,
velocities, f32 masters, beta powers) and its scheduler's state, by
parameter name, so that both packages can go on from one state.
"""
import numpy as np
import torch

from .optimizer.optimizer import host_scalar

__all__ = ["load_jax_params", "load_jax_optimizer_state"]


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


def load_jax_optimizer_state(opt, params, jax_opt, jax_params):
    """Copy `jax_opt`'s state into the port optimizer `opt` by name.

    `params` are the port model's `named_parameters()` and `jax_params`
    the JAX model's, under the same names (`load_jax_params`). Every
    state the JAX optimizer holds for a parameter goes into the port
    optimizer's state of the parameter of the same name: tensors are
    copied in place (keeping their device or pinned placement), scalars
    (`beta1_pow`, `beta2_pow`, Lamb's `_wd`, DGC's `step`) become host
    scalars of the port's type (f32, or int for a step count). The JAX
    scheduler's state goes into the port's when both have one. Raises
    KeyError on a name or state key the port lacks and ValueError on a
    shape mismatch; nothing is copied unless all of them check out."""
    port = dict(params)
    opt._bind_names(port.items())
    moves = []
    for name, jp in jax_params:
        jst = jax_opt._states.get(id(jp))
        if not jst:
            continue
        if name not in port:
            raise KeyError(f"{name}: no port parameter of that name")
        st = opt._get_state(port[name])
        for k, v in jst.items():
            if k not in st:
                raise KeyError(f"{name}: the port optimizer keeps no {k!r}")
            a = np.asarray(v, dtype=np.float32)
            if isinstance(st[k], torch.Tensor) \
                    and a.shape != tuple(st[k].shape):
                raise ValueError(f"{name}_{k}: source shape {a.shape} != "
                                 f"{tuple(st[k].shape)}")
            moves.append((st, k, a))
    with torch.no_grad():
        for st, k, a in moves:
            if isinstance(st[k], torch.Tensor):
                st[k].copy_(torch.from_numpy(np.array(a, copy=True)))
            else:
                st[k] = host_scalar(st[k], a)
    sched, jsched = opt._learning_rate, jax_opt._learning_rate
    if hasattr(sched, "set_state_dict") and hasattr(jsched, "state_dict"):
        sched.set_state_dict(jsched.state_dict())
    return opt
