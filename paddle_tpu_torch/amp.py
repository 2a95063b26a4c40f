"""Mixed precision — the port of paddle_tpu/amp/__init__.py (auto_cast).

The same white and black op lists and the same casting rules as the JAX
package: white ops (the products) cast their f32 operands down to the
amp dtype, black ops keep their statistics and accumulators in f32, and
everything else runs in its input dtype. The functionals consult this
state themselves (`nn.functional.linear`, `cross_entropy`, the GPT
head). `torch.autocast` is not used: its CUDA lists run layer_norm and
softmax with f32 outputs and cast at other places than the JAX package,
so the port's numerics would drift from the reference step.
"""
import contextlib
import threading

import torch

from .device import resolve_dtype

__all__ = ["auto_cast", "amp_state", "amp_op_dtype",
           "maybe_cast_to_compute", "white_black_list", "current_policy",
           "use_policy"]

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
