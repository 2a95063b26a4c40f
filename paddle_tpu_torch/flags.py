"""Runtime flags — the port's copy of paddle_tpu/flags.py, for the flags
the port reads.

One registry of typed, documented switches, read at use time through
`get_flag`, set with `set_flags({name: value})` (a `FLAGS_` prefix is
accepted) and initialised from `FLAGS_<name>` environment variables
when the module is imported. An unknown name raises: a setting silently
ignored would pass for tuning. The defaults are the JAX package's.
"""
import os
import threading

__all__ = ["set_flags", "get_flag"]


class _Flag:
    __slots__ = ("name", "value", "type", "help")

    def __init__(self, name, default, type_, help_):
        self.name = name
        self.value = default
        self.type = type_
        self.help = help_


_lock = threading.Lock()
_registry = {}


def _register(name, default, type_, help_):
    _registry[name] = _Flag(name, default, type_, help_)


def _coerce(flag, value):
    if flag.type is bool:
        if isinstance(value, str):
            return value.strip().lower() in ("1", "true", "yes", "on")
        return bool(value)
    return flag.type(value)


_register(
    "use_fused_ce", False, bool,
    "Use the chunked fused projection + cross entropy for the GPT loss "
    "(ops/fused_ce.py): the full-vocab logits tensor is never formed; "
    "the backward recomputes each chunk's logits. Off: logits + "
    "nn.functional.cross_entropy.")


def _init_from_env():
    for name, flag in _registry.items():
        env = os.environ.get("FLAGS_" + name)
        if env is not None:
            try:
                flag.value = _coerce(flag, env)
            except (TypeError, ValueError):
                raise ValueError(f"FLAGS_{name}={env!r} is not a valid "
                                 f"{flag.type.__name__}") from None


_init_from_env()


def _key(name):
    key = name[6:] if name.startswith("FLAGS_") else name
    if key not in _registry:
        raise ValueError(f"unknown flag {name!r}; known: {sorted(_registry)}")
    return key


def set_flags(flags):
    """Update registered flags from a {name: value} dict."""
    if not isinstance(flags, dict):
        raise TypeError("set_flags expects a dict of {name: value}")
    with _lock:
        for name, value in flags.items():
            flag = _registry[_key(name)]
            flag.value = _coerce(flag, value)


def get_flag(name):
    """One flag's value, for hot paths."""
    return _registry[name].value
