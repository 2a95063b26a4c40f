"""Optimizers — the port of paddle_tpu/optimizer/optimizer.py: the base
and its eleven rules (SGD, Momentum, Adam, AdamW, Adamax, Adagrad,
Adadelta, RMSProp, Lamb, LarsMomentum, DGCMomentum).

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
- The seven rules after AdamW take no `multi_precision`, as in the
  reference: a bf16 parameter is updated in f32 and rounded each step.
  Each keeps the JAX constructor's parameters in their order (`name` is
  accepted for that and unused).
- `state_dict` / `set_state_dict` carry every state under
  "<name>_<key>" and the scheduler's state under "LR_Scheduler".

The update runs with `torch._foreach_*` ops, one call per group of
parameters that share an effective learning rate and decay.
"""
import numpy as np
import torch

from .lr import LRScheduler

__all__ = ["L1Decay", "L2Decay", "Optimizer", "SGD", "Momentum", "Adam",
           "AdamW", "Adamax", "Adagrad", "Adadelta", "RMSProp", "Lamb",
           "LarsMomentum", "DGCMomentum"]

_LOW_PRECISION = (torch.bfloat16, torch.float16)


def host_scalar(like, v):
    """`v` as a host scalar of `like`'s type (an f32 `beta_pow`, an int
    step count)."""
    return type(like)(np.asarray(v).item())


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

    def _sharded(self):
        view = getattr(self, "_sharded_view", None)
        return view() if view is not None else None

    def state_dict(self):
        """{"<name>_<key>": state} for every parameter that has state,
        and the scheduler's state under "LR_Scheduler". Tensors are the
        optimizer's own (read them after the step's work is done). Under
        a `distributed.ShardedTrainStep` every logical slot is a
        `SlotPiece`: this rank's piece with its piece metadata
        (`ShardedTrainStep.optimizer_state_dict`)."""
        step = self._sharded()
        if step is not None:
            return step.optimizer_state_dict()
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
        scalars replace them. Under a `distributed.ShardedTrainStep`,
        pieces of this layout or whole logical slots
        (`ShardedTrainStep.set_optimizer_state_dict`)."""
        step = self._sharded()
        if step is not None:
            return step.set_optimizer_state_dict(state_dict)
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
                        st[k] = host_scalar(st[k], v)

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


def _zeros(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


class Adamax(Optimizer):
    """m = b1 m + (1 - b1) g; u = max(b2 u, |g| + eps);
    p -= lr / (1 - beta1_pow) * m / u."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_state(self, p):
        return {"moment": _zeros(p), "inf_norm": _zeros(p),
                "beta1_pow": np.float32(self._beta1)}

    def _apply(self, params, grads, states, lr):
        b1, b2 = self._beta1, self._beta2
        m = [st["moment"] for st in states]
        u = [st["inf_norm"] for st in states]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1 - b1)
        ag = torch._foreach_abs(grads)
        torch._foreach_add_(ag, self._epsilon)
        torch._foreach_mul_(u, b2)
        torch._foreach_maximum_(u, ag)
        # lr / (1 - beta1_pow) in f32 on the host, then * m / u
        step = torch._foreach_mul(m, [
            float(np.float32(lr) / (np.float32(1) - st["beta1_pow"]))
            for st in states])
        torch._foreach_div_(step, u)
        torch._foreach_sub_(params, step)
        for st in states:
            st["beta1_pow"] = st["beta1_pow"] * np.float32(b1)


class Adagrad(Optimizer):
    """moment += g^2; p -= lr g / (sqrt(moment) + eps); the moment starts
    at `initial_accumulator_value`."""

    def __init__(self, learning_rate, epsilon=1e-06, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _init_state(self, p):
        return {"moment": torch.full(p.shape, self._init_acc,
                                     dtype=torch.float32, device=p.device)}

    def _apply(self, params, grads, states, lr):
        mom = [st["moment"] for st in states]
        torch._foreach_addcmul_(mom, grads, grads)
        den = torch._foreach_sqrt(mom)
        torch._foreach_add_(den, self._epsilon)
        step = torch._foreach_mul(grads, lr)
        torch._foreach_div_(step, den)
        torch._foreach_sub_(params, step)


class Adadelta(Optimizer):
    """asg = rho asg + (1 - rho) g^2;
    update = g sqrt(asu + eps) / sqrt(asg + eps);
    asu = rho asu + (1 - rho) update^2; p -= lr update."""

    def __init__(self, learning_rate=0.001, epsilon=1e-06, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon, self._rho = epsilon, rho

    def _init_state(self, p):
        return {"avg_squared_grad": _zeros(p),
                "avg_squared_update": _zeros(p)}

    def _apply(self, params, grads, states, lr):
        rho, eps = self._rho, self._epsilon
        asg = [st["avg_squared_grad"] for st in states]
        asu = [st["avg_squared_update"] for st in states]
        torch._foreach_mul_(asg, rho)
        torch._foreach_addcmul_(asg, grads, grads, value=1 - rho)
        num = torch._foreach_add(asu, eps)
        torch._foreach_sqrt_(num)
        update = torch._foreach_mul(grads, num)
        den = torch._foreach_add(asg, eps)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(update, den)
        torch._foreach_mul_(asu, rho)
        torch._foreach_addcmul_(asu, update, update, value=1 - rho)
        torch._foreach_mul_(update, lr)
        torch._foreach_sub_(params, update)


class RMSProp(Optimizer):
    """ms = rho ms + (1 - rho) g^2; centered: mg = rho mg + (1 - rho) g
    and denom = sqrt(ms - mg^2 + eps), else sqrt(ms + eps);
    momentum = momentum_coeff momentum + lr g / denom; p -= momentum."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-06, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_state(self, p):
        st = {"mean_square": _zeros(p), "momentum": _zeros(p)}
        if self._centered:
            st["mean_grad"] = _zeros(p)
        return st

    def _apply(self, params, grads, states, lr):
        rho = self._rho
        ms = [st["mean_square"] for st in states]
        mom = [st["momentum"] for st in states]
        torch._foreach_mul_(ms, rho)
        torch._foreach_addcmul_(ms, grads, grads, value=1 - rho)
        if self._centered:
            mg = [st["mean_grad"] for st in states]
            torch._foreach_mul_(mg, rho)
            torch._foreach_add_(mg, grads, alpha=1 - rho)
            den = torch._foreach_addcmul(ms, mg, mg, value=-1)
            torch._foreach_add_(den, self._epsilon)
        else:
            den = torch._foreach_add(ms, self._epsilon)
        torch._foreach_sqrt_(den)
        step = torch._foreach_mul(grads, lr)
        torch._foreach_div_(step, den)
        torch._foreach_mul_(mom, self._momentum)
        torch._foreach_add_(mom, step)
        torch._foreach_sub_(params, mom)


class Lamb(Optimizer):
    """Adam's moments with bias correction, r = mhat / (sqrt(vhat) + eps)
    + wd p, and p -= lr trust r, where trust = |p| / |r| over the whole
    tensor (1 where either norm is 0). `exclude_from_weight_decay_fn` is
    called once per parameter, when its state is made, with the
    parameter's name in `model.named_parameters()` (the JAX package
    passes its own Parameter); True sets its decay `_wd` to 0."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9,
                 beta2=0.999, epsilon=1e-06, parameters=None, grad_clip=None,
                 exclude_from_weight_decay_fn=None, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._lamb_weight_decay = lamb_weight_decay
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_state(self, p):
        excluded = self._exclude_fn is not None \
            and self._exclude_fn(self._param_name(p))
        return {"moment1": _zeros(p), "moment2": _zeros(p),
                "beta1_pow": np.float32(self._beta1),
                "beta2_pow": np.float32(self._beta2),
                "_wd": np.float32(0.0 if excluded
                                  else self._lamb_weight_decay)}

    def _apply(self, params, grads, states, lr):
        b1, b2 = self._beta1, self._beta2
        m = [st["moment1"] for st in states]
        v = [st["moment2"] for st in states]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, grads, grads, value=1 - b2)
        one = np.float32(1)
        r = torch._foreach_div(m, [float(one - st["beta1_pow"])
                                   for st in states])
        den = torch._foreach_div(v, [float(one - st["beta2_pow"])
                                     for st in states])
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self._epsilon)
        torch._foreach_div_(r, den)
        wd = [float(st["_wd"]) for st in states]
        if any(wd):
            torch._foreach_add_(r, torch._foreach_mul(params, wd))
        w_norm = torch.stack(torch._foreach_norm(params))
        r_norm = torch.stack(torch._foreach_norm(r))
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        torch._foreach_mul_(r, list((lr * trust).unbind()))
        torch._foreach_sub_(params, r)
        for st in states:
            st["beta1_pow"] = st["beta1_pow"] * np.float32(b1)
            st["beta2_pow"] = st["beta2_pow"] * np.float32(b2)


class LarsMomentum(Optimizer):
    """local_lr = lr coeff |p| / (|g| + wd |p| + eps) over the whole
    tensor (lr where either norm is 0); v = momentum v + local_lr
    (g + wd p); p -= v."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 epsilon=0, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay
        self._eps = epsilon

    def _init_state(self, p):
        return {"velocity": _zeros(p)}

    def _apply(self, params, grads, states, lr):
        wd = self._lars_weight_decay
        p_norm = torch.stack(torch._foreach_norm(params))
        g_norm = torch.stack(torch._foreach_norm(grads))
        local = torch.where((p_norm > 0) & (g_norm > 0),
                            lr * self._lars_coeff * p_norm
                            / (g_norm + wd * p_norm + self._eps), lr)
        step = torch._foreach_mul(params, wd)
        torch._foreach_add_(step, grads)
        torch._foreach_mul_(step, list(local.unbind()))
        v = [st["velocity"] for st in states]
        torch._foreach_mul_(v, self._momentum)
        torch._foreach_add_(v, step)
        torch._foreach_sub_(params, v)


class DGCMomentum(Optimizer):
    """Deep Gradient Compression momentum: the gradient is added to a
    residual, and only the residual's entries at or above its k-th
    largest magnitude (k = max(1, round(n (1 - sparsity)))) step; they
    leave the residual, the rest stays. Before `rampup_begin_step` steps
    it is plain momentum over the whole residual. Then v = momentum v +
    g_eff, and p -= lr v (Nesterov: p -= lr (g_eff + momentum v)). The
    step count is a host int, so the choice costs no device sync."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 sparsity=0.999, rampup_begin_step=0, use_nesterov=False,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._use_nesterov = use_nesterov
        self._sparsity = float(sparsity)
        self._rampup_begin = int(rampup_begin_step)

    def _init_state(self, p):
        return {"velocity": _zeros(p), "residual": _zeros(p), "step": 0}

    def _apply(self, params, grads, states, lr):
        res = [st["residual"] for st in states]
        eff = torch._foreach_add(res, grads)
        for acc, r, st in zip(eff, res, states):
            if st["step"] < self._rampup_begin:
                r.zero_()
            else:
                n = acc.numel()
                k = max(1, int(round(n * (1.0 - self._sparsity))))
                mag = acc.abs()
                thresh = torch.topk(mag.reshape(-1), k).values[-1]
                r.copy_(acc)
                acc.mul_(mag >= thresh)
                r.sub_(acc)
            st["step"] += 1
        v = [st["velocity"] for st in states]
        torch._foreach_mul_(v, self._momentum)
        torch._foreach_add_(v, eff)
        if self._use_nesterov:
            step = torch._foreach_mul(v, self._momentum)
            torch._foreach_add_(step, eff)
            torch._foreach_mul_(step, lr)
        else:
            step = torch._foreach_mul(v, lr)
        torch._foreach_sub_(params, step)
