"""Optimizers — the port of paddle_tpu/optimizer/optimizer.py (the base,
SGD, Momentum, Adam and AdamW).

The update rule is the JAX package's, in the same order of operations:
f32 gradients, moments and velocities; a per-parameter `beta_pow` that
starts at beta and is multiplied by beta after each step (an f32 scalar,
kept on the host so the bias correction needs no device sync); L2 (or,
with `L1Decay`, L1) decay added to the gradient, or, for AdamW, the
decoupled decay `p * (1 - lr * wd)` applied before the Adam update.

- The learning rate is a float or an `lr.LRScheduler`, read at every
  step (`get_lr`, `set_lr`, `set_lr_scheduler`).
- `grad_clip` (an `nn.clip` clip) is applied to the gradients in
  `step()` and in `jit.TrainStep`, before the update.
- `parameters` may be parameters, (name, parameter) pairs, or groups
  (dicts with "params" and optional "learning_rate", a scale of the
  base rate, and "weight_decay"). A parameter's `optimize_attr`
  {"learning_rate": scale} and `regularizer` (`L2Decay`/`L1Decay`)
  attributes are read as in the reference. AdamW's
  `apply_decay_param_fun` is called with the parameter's name in
  `model.named_parameters()` (the JAX model's names, see
  `convert.load_jax_params`); `jit.TrainStep` tells the optimizer those
  names.
- `multi_precision` (Momentum, Adam, AdamW; on by default as in the
  reference) keeps an f32 `master` of every bf16 or f16 parameter in its
  state: the rule updates the master and the parameter is its rounding.
  A parameter written outside the optimizer wins over a stale master
  (the reference's self-heal: where the parameter differs from the
  master's rounding, the master restarts from the parameter). The
  decoupled decay acts on the master.
- `state_dict` / `set_state_dict` carry every state under
  "<name>_<key>" and the scheduler's state under "LR_Scheduler".

The update runs with `torch._foreach_*` ops, one call per group of
parameters that share an effective learning rate and decay.
"""
import numpy as np
import torch

from .lr import LRScheduler

__all__ = ["L1Decay", "L2Decay", "Optimizer", "SGD", "Momentum", "Adam",
           "AdamW"]

_LOW_PRECISION = (torch.bfloat16, torch.float16)


class L2Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


class L1Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


class Optimizer:
    # True for decoupled decay (AdamW)
    _decoupled_weight_decay = False

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None):
        self._names = {}            # id(p) -> name in named_parameters()
        self._group_lr = {}         # id(p) -> the group's rate scale
        self._group_decay = {}      # id(p) -> the group's weight decay
        self._parameter_list = None if parameters is None \
            else self._flatten(parameters)
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        if isinstance(weight_decay, (L2Decay, L1Decay)):
            self._weight_decay = weight_decay.coeff
            self._decay_is_l1 = isinstance(weight_decay, L1Decay)
        else:
            self._weight_decay = float(weight_decay or 0.0)
            self._decay_is_l1 = False
        self._states = {}
        # f32 masters of low-precision parameters; the subclasses that
        # take the knob set it
        self._multi_precision = False

    def _flatten(self, parameters):
        flat = []
        for item in parameters:
            if isinstance(item, dict):
                for p in self._flatten(item["params"]):
                    if "learning_rate" in item:
                        self._group_lr[id(p)] = float(item["learning_rate"])
                    if item.get("weight_decay") is not None:
                        self._group_decay[id(p)] = item["weight_decay"]
                    flat.append(p)
            elif isinstance(item, tuple):
                name, p = item
                self._names[id(p)] = name
                flat.append(p)
            else:
                flat.append(item)
        return flat

    def _bind_names(self, named_parameters):
        """Learn the parameters' names (what `apply_decay_param_fun` and
        the state dict's keys read) from `model.named_parameters()`."""
        for name, p in named_parameters:
            self._names[id(p)] = name

    def _param_name(self, p):
        name = self._names.get(id(p))
        if name is None:
            raise KeyError("the optimizer does not know this parameter's "
                           "name: pass parameters=model.named_parameters() "
                           "or drive it with jit.TrainStep")
        return name

    # ---- lr --------------------------------------------------------------
    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate()
        return float(self._learning_rate)

    def set_lr(self, value):
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    # ---- state -----------------------------------------------------------
    def _get_state(self, p):
        st = self._states.get(id(p))
        if st is None:
            st = self._init_state(p)
            if self._multi_precision and p.dtype in _LOW_PRECISION:
                st["master"] = p.detach().float()
            self._states[id(p)] = st
        return st

    def _init_state(self, p):
        return {}

    def state_dict(self):
        """{"<name>_<key>": state} for every parameter that has state,
        and the scheduler's state under "LR_Scheduler". Tensors are the
        optimizer's own (read them after the step's work is done)."""
        out = {}
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        for p in self._parameter_list or ():
            for k, v in self._states.get(id(p), {}).items():
                out[f"{self._param_name(p)}_{k}"] = v
        return out

    def set_state_dict(self, state_dict):
        """Load what `state_dict` gave: tensors are copied into the
        existing states (keeping their device or pinned host placement),
        scalars replace them."""
        if "LR_Scheduler" in state_dict and isinstance(
                self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        with torch.no_grad():
            for p in self._parameter_list or ():
                st = self._get_state(p)
                for k in list(st):
                    key = f"{self._param_name(p)}_{k}"
                    if key not in state_dict:
                        continue
                    v = state_dict[key]
                    if isinstance(st[k], torch.Tensor):
                        st[k].copy_(v if isinstance(v, torch.Tensor)
                                    else torch.from_numpy(np.asarray(v)))
                    else:
                        st[k] = np.float32(v)

    # ---- per-parameter settings ------------------------------------------
    def _effective_decay(self, p):
        wd = self._group_decay.get(id(p), self._weight_decay)
        if isinstance(wd, (L2Decay, L1Decay)):
            wd = wd.coeff
        # a parameter's regularizer overrides the optimizer's decay
        reg = getattr(p, "regularizer", None)
        if reg is not None:
            wd = reg.coeff if isinstance(reg, (L2Decay, L1Decay)) else wd
        return float(wd)

    def _param_lr(self, p):
        scale = self._group_lr.get(id(p))
        if scale is not None:
            return scale
        attr = getattr(p, "optimize_attr", None) or {}
        return float(attr.get("learning_rate", 1.0))

    # ---- the update ------------------------------------------------------
    def _apply(self, params, grads, states, lr):
        """The update rule over f32 parameter (or master) and gradient
        lists, in place on `params` and the states; subclasses define
        it."""
        raise NotImplementedError

    @torch.no_grad()
    def update(self, params, grads, states=None):
        """One step over `params` with `grads` (same order): the JAX
        package's `_functional_apply`. `states` (default: the
        optimizer's own) are the parameters' state dicts, updated in
        place."""
        lr = self.get_lr()
        if states is None:
            states = [self._get_state(p) for p in params]
        groups = {}
        for item in zip(params, grads, states):
            key = (self._param_lr(item[0]), self._effective_decay(item[0]))
            groups.setdefault(key, []).append(item)
        for (scale, wd), items in groups.items():
            self._update_group(*map(list, zip(*items)), lr * scale, wd)

    def _update_group(self, params, grads, states, lr, wd):
        masters = [st.get("master") for st in states]
        # the rule works on the master where there is one, else on the
        # parameter itself (f32) or an f32 copy of it
        work = [m if m is not None else
                p if p.dtype == torch.float32 else p.float()
                for p, m in zip(params, masters)]
        g32 = [g if g.dtype == torch.float32 else g.float() for g in grads]
        if wd and not self._decoupled_weight_decay:
            g32 = torch._foreach_add(
                g32, torch._foreach_sign(work) if self._decay_is_l1
                else work, alpha=wd)
        decayed = bool(wd) and self._decoupled_weight_decay
        if decayed:
            torch._foreach_mul_(work, 1.0 - lr * wd)
            # a low-precision parameter without a master is decayed in
            # its own dtype before the rule reads it
            for p, w, m in zip(params, work, masters):
                if m is None and w is not p:
                    w.copy_(w.to(p.dtype))
        else:
            # the self-heal: a master whose rounding is not the parameter
            # restarts from the parameter (after a decoupled decay the
            # parameter is the decayed master's rounding, always in sync)
            for p, m in zip(params, masters):
                if m is not None:
                    in_sync = (p == m.to(p.dtype)).all()
                    m.copy_(torch.where(in_sync, m, p.float()))
        self._apply(work, g32, states, lr)
        for p, w in zip(params, work):
            if w is not p:
                p.copy_(w)

    def step(self):
        """Eager step over the parameters that have a gradient, clipped
        by `grad_clip` first."""
        pairs = [(p, p.grad) for p in self._parameter_list or ()
                 if p.requires_grad and p.grad is not None]
        if self._grad_clip is not None:
            pairs = [(p, g) for p, g in self._grad_clip(pairs)
                     if g is not None]
        if pairs:
            self.update(*map(list, zip(*pairs)))

    def clear_grad(self):
        for p in self._parameter_list or ():
            p.grad = None


class SGD(Optimizer):
    """p -= lr * g."""

    def _apply(self, params, grads, states, lr):
        torch._foreach_sub_(params, torch._foreach_mul(grads, lr))


class Momentum(Optimizer):
    """v = momentum v + g; p -= lr v, or with Nesterov
    p -= lr (g + momentum v). `rescale_grad` scales g first."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=True, rescale_grad=1.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._multi_precision = bool(multi_precision)
        self._momentum = momentum
        self._use_nesterov = use_nesterov
        self._rescale_grad = float(rescale_grad)

    def _init_state(self, p):
        return {"velocity": torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device)}

    def _apply(self, params, grads, states, lr):
        if self._rescale_grad != 1.0:
            grads = torch._foreach_mul(grads, self._rescale_grad)
        v = [st["velocity"] for st in states]
        torch._foreach_mul_(v, self._momentum)
        torch._foreach_add_(v, grads)
        if self._use_nesterov:
            step = torch._foreach_mul(v, self._momentum)
            torch._foreach_add_(step, grads)
            torch._foreach_mul_(step, lr)
        else:
            step = torch._foreach_mul(v, lr)
        torch._foreach_sub_(params, step)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None, *,
                 grad_clip=None, multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._multi_precision = bool(multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _init_state(self, p):
        z = dict(dtype=torch.float32, device=p.device)
        return {"moment1": torch.zeros(p.shape, **z),
                "moment2": torch.zeros(p.shape, **z),
                "beta1_pow": np.float32(self._beta1),
                "beta2_pow": np.float32(self._beta2)}

    def _apply(self, params, grads, states, lr):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m = [st["moment1"] for st in states]
        v = [st["moment2"] for st in states]
        # m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, grads, grads, value=1 - b2)
        one = np.float32(1)
        mhat = torch._foreach_div(
            m, [float(one - st["beta1_pow"]) for st in states])
        vhat = torch._foreach_div(
            v, [float(one - st["beta2_pow"]) for st in states])
        # p -= lr * mhat / (sqrt(vhat) + eps)
        torch._foreach_sqrt_(vhat)
        torch._foreach_add_(vhat, eps)
        torch._foreach_mul_(mhat, lr)
        torch._foreach_div_(mhat, vhat)
        torch._foreach_sub_(params, mhat)
        for st in states:
            st["beta1_pow"] = st["beta1_pow"] * np.float32(b1)
            st["beta2_pow"] = st["beta2_pow"] * np.float32(b2)


class AdamW(Adam):
    """Adam with decoupled weight decay; `apply_decay_param_fun(name)`
    False exempts a parameter from the decay."""

    _decoupled_weight_decay = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01, *,
                 apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=True):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip=grad_clip,
                         multi_precision=multi_precision)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _effective_decay(self, p):
        if self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(self._param_name(p)):
            return 0.0
        return super()._effective_decay(p)
