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

For a model cut over a mesh (`distributed.shard_model`),
`shard_jax_params` loads the full JAX arrays and keeps each rank's piece
by the same rule, and `gather_params` rebuilds the full arrays from the
ranks' pieces (every rank calls it), so a test compares them with the
JAX parameters by name. Under a ZeRO-3 `ShardedTrainStep`, whose
parameters are only this rank's flat pieces between steps, both run
inside the step's `gathered()` (the pieces all-gathered over dp first;
`shard_jax_params` keeps the loaded values' pieces after).

`load_jax_optimizer_state` does the same for an optimizer in the middle
of training: the JAX optimizer's per-parameter states (moments,
velocities, f32 masters, beta powers) and its scheduler's state, by
parameter name, so that both packages can go on from one state.
"""
import numpy as np
import torch

from .optimizer.optimizer import host_scalar

__all__ = ["load_jax_params", "load_jax_optimizer_state",
           "shard_jax_params", "gather_params"]


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


def shard_jax_params(model, arrays, mesh=None):
    """`load_jax_params` for a model cut over `mesh` (default the
    installed one): each full array is checked against the parameter's
    full shape and cut to this rank's piece as `shard_model` cut the
    parameter; a model not cut yet is cut first."""
    from .distributed import env
    from .distributed.sharded_train import shard_model
    mesh = mesh if mesh is not None else env.current_mesh()
    shard_model(model, mesh)
    with _gathered(model, write_back=True):
        return _shard_jax_params(model, arrays, mesh)


def _gathered(model, write_back=False):
    import contextlib
    step = getattr(model, "_sharded_step", None)
    step = step() if step is not None else None
    return step.gathered(write_back) if step is not None \
        else contextlib.nullcontext()


def _shard_jax_params(model, arrays, mesh):
    from .distributed.sharded_train import cut_full, param_cuts
    cuts = param_cuts(model)
    src = dict(arrays)
    out = {}
    for name, t in model.state_dict(keep_vars=True).items():
        a = src.get(name)
        if a is None or name not in cuts:
            out[name] = a
            continue
        full = cuts[name][2]
        a = np.asarray(a)
        if a.shape != full:
            raise ValueError(f"{name}: source shape {a.shape} != full "
                             f"shape {full}")
        out[name] = cut_full(torch.from_numpy(np.array(a, copy=True)),
                             cuts[name], mesh).numpy()
    out.update({n: a for n, a in src.items() if n not in out})
    return load_jax_params(model, [(n, a) for n, a in out.items()
                                   if a is not None])


def gather_params(model, mesh=None):
    """{name: full ndarray} of `model`'s parameters: a parameter cut
    over mp (or ep) is all-gathered from the ranks of this rank's rows
    along those axes and joined (a collective: every rank calls it);
    bf16 comes back as f32."""
    from .distributed import env
    from .distributed.sharded_train import gather_full, param_cuts
    mesh = mesh if mesh is not None else env.current_mesh()
    cuts = param_cuts(model)
    prev = env.current_mesh()
    env.set_mesh(mesh)
    try:
        out = {}
        with _gathered(model):
            for name, p in model.named_parameters():
                t = p.detach()
                if name in cuts:
                    t = gather_full(t, cuts[name])
                # a copy: numpy would pin a ZeRO-3 parameter's storage
                out[name] = t.float().cpu().clone().numpy()
        return out
    finally:
        env.set_mesh(prev)
