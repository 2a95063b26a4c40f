"""Mixed precision — the port of paddle_tpu/amp/__init__.py (auto_cast
and GradScaler).

The same white and black op lists and the same casting rules as the JAX
package: white ops (the products) cast their f32 operands down to the
amp dtype, black ops keep their statistics and accumulators in f32, and
everything else runs in its input dtype. The functionals consult this
state themselves (`nn.functional.linear`, `cross_entropy`, the GPT
head). `torch.autocast` is not used: its CUDA lists run layer_norm and
softmax with f32 outputs and cast at other places than the JAX package,
so the port's numerics would drift from the reference step.

`GradScaler` is the JAX package's dynamic loss scaling (needed for fp16,
a pass-through for bf16), with the same arithmetic and bookkeeping:
`scale(loss)`, `unscale_(optimizer)` (divides the gradients, notes
whether any is inf or nan: one host read), `step(optimizer)` (skips
the update on an inf and moves the scale), `state_dict()`.
"""
import contextlib
import threading

import torch

from .device import resolve_dtype

__all__ = ["auto_cast", "amp_state", "amp_op_dtype",
           "maybe_cast_to_compute", "white_black_list", "current_policy",
           "use_policy", "GradScaler", "AmpScaler"]

_DEFAULT_WHITE = frozenset({
    "matmul", "conv", "linear", "mul", "einsum", "attention", "bmm",
})
_DEFAULT_BLACK = frozenset({
    "softmax_with_cross_entropy", "cross_entropy", "layer_norm", "exp",
    "log", "mean", "sum", "cos_sim", "norm", "reduce_sum",
})


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.white = _DEFAULT_WHITE
        self.black = _DEFAULT_BLACK


_state = _AmpState()


def amp_state():
    return _state


def current_policy():
    """The calling thread's amp settings, for `use_policy` to re-enter
    on another thread (the autograd engine's, where a recompute runs)."""
    return (_state.enabled, _state.dtype, _state.level, _state.white,
            _state.black)


@contextlib.contextmanager
def use_policy(policy):
    """Run the enclosed ops under `policy` (from `current_policy`) on
    this thread, restoring the thread's own settings afterwards."""
    prev = current_policy()
    (_state.enabled, _state.dtype, _state.level, _state.white,
     _state.black) = policy
    try:
        yield
    finally:
        (_state.enabled, _state.dtype, _state.level, _state.white,
         _state.black) = prev


def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """Run the enclosed ops under the amp policy. Custom white entries
    are removed from black and vice versa (the reference's rule)."""
    white = set(_DEFAULT_WHITE) | set(custom_white_list or ())
    black = set(_DEFAULT_BLACK) | set(custom_black_list or ())
    white -= set(custom_black_list or ())
    black -= set(custom_white_list or ())
    return use_policy((bool(enable), resolve_dtype(dtype), level,
                       frozenset(white), frozenset(black)))


def white_black_list():
    """Active (white, black) op-name sets."""
    return _state.white, _state.black


def amp_op_dtype(op, input_dtype):
    """Accumulation dtype for `op`'s internal math: f32 when the op is
    black, the amp dtype when it is white, the input dtype otherwise
    (and always when amp is off)."""
    if not _state.enabled:
        return input_dtype
    if op in _state.black:
        return torch.float32
    if op in _state.white:
        return _state.dtype
    return input_dtype


def maybe_cast_to_compute(x, op="matmul"):
    """Under amp: white ops cast f32 operands down to the amp dtype,
    black ops cast up to f32; anything else keeps its dtype."""
    if not _state.enabled:
        return x
    if op in _state.black:
        return x if x.dtype == torch.float32 else x.float()
    if op in _state.white and x.dtype == torch.float32:
        return x.to(_state.dtype)
    return x


class GradScaler:
    """Dynamic loss scaling (paddle_tpu/amp/__init__.py:116-205):
    `init_loss_scaling` multiplies the loss; after `decr_every_n_nan_or_inf`
    steps with an inf/nan gradient the scale shrinks by `decr_ratio`
    (not below 1), after `incr_every_n_steps` clean ones it grows by
    `incr_ratio`. A step with an inf/nan gradient is skipped."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    def unscale_(self, optimizer):
        """Divide every gradient of the optimizer's parameters by the
        scale, in place, and note whether any is inf or nan."""
        if not self._enable:
            return
        inv = 1.0 / self._scale
        grads = [p.grad for p in optimizer._parameter_list or []
                 if p.grad is not None]
        found = False
        if grads:
            torch._foreach_mul_(grads, inv)
            finite = torch.stack([torch.isfinite(g).all() for g in grads])
            found = not bool(finite.all())
        self._found_inf = found

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._update()

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)

    def update(self):
        pass

    def _update(self):
        if not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "good_steps": self._good_steps, "bad_steps": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)


AmpScaler = GradScaler
