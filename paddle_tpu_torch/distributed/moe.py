"""Mixture-of-Experts with expert parallelism — the DEPRECATED einsum
layer, the port of paddle_tpu/distributed/moe.py.

`moe.MoEFFN` (index-form dispatch and combine through the K12/K13
kernels, the expert all-to-all, aux/z losses and the `moe.*` gauges) is
the production path; this layer stays for compatibility, as in the JAX
package, with the same routing math and no kernel there either: the
dispatch and combine are [n, E, C] mask einsums.

Weights: w_gate [d, E] replicated, w_in [E, d, f] tagged ("ep", None,
"mp"), w_out [E, f, d] tagged ("ep", "mp", None). Under an ep axis above
1 (after `distributed.shard_model`) the JAX layer is one function that
GSPMD splits; here every rank of an ep group routes all its rows alike
(the ranks hold the same rows), dispatches them into its own E/ep
experts' buckets, runs those experts and all-gathers the experts'
outputs (`gather_axis`, whose backward keeps this rank's experts'
rows), then combines. The adjoint convention is `moe/layer.py`'s: each
rank keeps the whole loss of its rows; the tokens enter the dispatch
through `c_identity(·, "ep")`, which sums over ep the parts of their
gradient that each rank's experts give. Under mp the expert products
are the column/row pair over f.
"""
import math

import torch

from . import env
from .collective import c_identity, gather_axis

__all__ = ["MoELayer", "ExpertFFN"]


class ExpertFFN:
    pass


def _xavier_uniform_(p, gen):
    """paddle's XavierUniform: fan_in / fan_out of a [in, out] matrix,
    or of dims 1 and 0 times the receptive field above two dims."""
    shape = p.shape
    rec = math.prod(shape[2:]) if len(shape) > 2 else 1
    fan_in, fan_out = (shape[0], shape[1]) if len(shape) == 2 else \
        (shape[1] * rec, shape[0] * rec)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        p.uniform_(-limit, limit, generator=gen)


class MoELayer(torch.nn.Module):
    """Switch/GShard-style MoE FFN: x [tokens..., d_model] -> the same
    shape, with the load-balancing aux loss of the last forward."""

    def __init__(self, d_model, d_ff, num_experts, k=2, capacity_factor=1.25,
                 gate_noise=0.0, name=None, device=None, dtype=torch.float32,
                 seed=0):
        super().__init__()
        self.num_experts = num_experts
        self.k = k
        self.capacity_factor = capacity_factor
        to = dict(device=device, dtype=dtype)
        self.w_gate = torch.nn.Parameter(torch.empty((d_model, num_experts),
                                                     **to))
        self.w_in = torch.nn.Parameter(torch.empty(
            (num_experts, d_model, d_ff), **to))
        self.w_out = torch.nn.Parameter(torch.empty(
            (num_experts, d_ff, d_model), **to))
        gen = torch.Generator(device=self.w_gate.device).manual_seed(seed)
        for p in (self.w_gate, self.w_in, self.w_out):
            _xavier_uniform_(p, gen)
        self.mesh_axes = {"w_in": (("ep", None, "mp"), 1),
                          "w_out": (("ep", "mp", None), 1)}
        self._aux_loss = None

    def forward(self, x):
        from ..moe.layer import _experts
        E, k, cf = self.num_experts, self.k, self.capacity_factor
        orig_shape = x.shape
        d = orig_shape[-1]
        tokens = x.reshape(-1, d)
        n = tokens.shape[0]
        dt = tokens.dtype
        capacity = max(1, int(cf * n * k / E))
        logits = tokens @ self.w_gate
        probs = torch.softmax(logits, dim=-1)
        gate_vals, gate_idx = torch.topk(probs, k, dim=-1)
        combine = torch.zeros((n, E, capacity), dtype=dt, device=x.device)
        dispatch = torch.zeros((n, E, capacity), dtype=torch.bool,
                               device=x.device)
        # slot-s positions start after every slot-<s choice of the same
        # expert (the GShard position offset)
        counts = torch.zeros((E,), dtype=torch.long, device=x.device)
        for slot in range(k):
            idx = gate_idx[:, slot]
            onehot = torch.nn.functional.one_hot(idx, E)
            pos = (torch.cumsum(onehot, dim=0) - 1) * onehot
            pos_in_e = pos.sum(dim=-1) + counts[idx]
            counts = counts + onehot.sum(dim=0)
            ok = pos_in_e < capacity
            g = gate_vals[:, slot] * ok.to(dt)
            pos_oh = torch.nn.functional.one_hot(
                torch.where(ok, pos_in_e, capacity),
                capacity + 1).to(dt)[:, :capacity]
            contrib = onehot.to(dt)[:, :, None] * pos_oh[:, None, :]
            combine = combine + g[:, None, None] * contrib
            dispatch = dispatch | (contrib > 0)
        ep = env.axis_size("ep")
        e_loc = E // ep
        lo = env.axis_index("ep") * e_loc
        expert_in = torch.einsum("nec,nd->ecd",
                                 dispatch[:, lo:lo + e_loc].to(dt),
                                 c_identity(tokens, "ep"))
        expert_out = gather_axis(_experts(expert_in, self.w_in, self.w_out),
                                 "ep", 0)
        out = torch.einsum("nec,ecd->nd", combine, expert_out)
        # the load-balancing aux loss (GShard): E * sum(frac * mean prob)
        frac = torch.nn.functional.one_hot(probs.argmax(dim=-1), E).to(
            probs.dtype).mean(dim=0)
        self._aux_loss = E * (frac * probs.mean(dim=0)).sum()
        return out.reshape(orig_shape)

    def aux_loss(self):
        return self._aux_loss
