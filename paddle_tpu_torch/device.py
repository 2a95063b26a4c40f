"""Default-device and dtype resolution for the port's entry points.

Every entry point (`GPTForPretraining(...)`, `ServingEngine(...)`) takes
`device=None` to mean "the CUDA card". Without a card that is an error,
never a silent fall back to the CPU: a CPU run must be asked for with
`device="cpu"`, as the tests do.
"""
import subprocess

import torch

__all__ = ["resolve_device", "resolve_dtype", "card_line"]

# the dtypes the port's kernels take
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device=None):
    """`None` -> the current CUDA device (raises when CUDA is absent);
    anything else -> `torch.device(device)`."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def resolve_dtype(dtype):
    """A dtype name as the JAX package spells it ("float32",
    "bfloat16", ...) or a torch dtype -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r} (expected one of "
                         f"{sorted(_DTYPES)})") from None


def card_line():
    """The first card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them:
    every time measured on the card is reported beside it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]
