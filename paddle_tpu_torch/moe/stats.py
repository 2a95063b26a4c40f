"""MoE routing-health fields of a training step's record.

Counterpart of paddle_tpu/moe/stats.py: turns the step's (5,) stats
vector (`GPTMoE.collect_moe_stats`, router.STATS_FIELDS order) into the
`moe_*` fields of the telemetry step record, with the same clamp of
float-accumulation jitter at the bounds, and sets the five `moe.*`
gauges of the port's monitor (`moe.entropy`, `moe.dropped_frac`,
`moe.overflow`, `moe.aux_loss`, `moe.z_loss`) as the JAX package does.
"""
import math

import numpy as np
import torch

from .. import monitor

__all__ = ["note_step_stats"]

# float32-accumulation jitter the boundary clamp may absorb; anything
# beyond it is a producer bug and reaches the record unclamped
_EPS = 1e-4


def _clamp_jitter(v, lo=None, hi=None):
    if lo is not None and lo - _EPS <= v < lo:
        return lo
    if hi is not None and hi < v <= hi + _EPS:
        return hi
    return v


def note_step_stats(win, stats, num_experts):
    """Read the (5,) stats vector (one host transfer) and return the
    `moe_*` field dict, noting it into `win` (anything with `.note(**kw)`)
    when one is given and setting the `moe.*` gauges. Returns None (and
    sets nothing) when the vector is unusable or no expert count was
    given. Values are clamped to their bounds only within the jitter
    band; a value genuinely outside (entropy above log E, dropped_frac
    above 1) is kept as it is."""
    if stats is None or not num_experts:
        return None
    if isinstance(stats, torch.Tensor):
        stats = stats.detach().cpu()
    try:
        vals = np.asarray(stats, dtype=np.float64)
    except (TypeError, ValueError):
        return None
    if vals.shape != (5,) or not np.all(np.isfinite(vals)):
        return None
    entropy, dropped, overflow, aux, z = (float(v) for v in vals)
    dropped = _clamp_jitter(dropped, lo=0.0, hi=1.0)
    entropy = _clamp_jitter(entropy, lo=0.0, hi=math.log(num_experts))
    overflow = _clamp_jitter(overflow, lo=0.0)
    fields = {
        "moe_entropy": round(entropy, 6),
        "moe_dropped_frac": round(dropped, 6),
        "moe_overflow": round(overflow, 6),
        "moe_aux_loss": round(aux, 6),
        "moe_num_experts": int(num_experts),
    }
    if win is not None:
        win.note(**fields)
    monitor.set_gauge("moe.entropy", fields["moe_entropy"])
    monitor.set_gauge("moe.dropped_frac", fields["moe_dropped_frac"])
    monitor.set_gauge("moe.overflow", fields["moe_overflow"])
    monitor.set_gauge("moe.aux_loss", fields["moe_aux_loss"])
    monitor.set_gauge("moe.z_loss", round(z, 6))
    return fields
