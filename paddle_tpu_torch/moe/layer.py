"""MoE FFN layer: routed expert feed-forward on one device.

Counterpart of paddle_tpu/moe/layer.py at ep == 1 (`_local_moe`'s
single-device body): gate, route, dispatch through the `moe_gather`
kernel into [E, C, d] expert buckets, the two batched expert products
with tanh-gelu between them (`torch.bmm`: the JAX package leaves them to
XLA), and the weighted combine through the `moe_combine` kernel. The
body runs in the tokens' dtype with no amp casts, as the JAX body runs
raw jnp inside `apply`: in the GPT block its input is ln2's output in the
residual stream's f32, so under bf16 amp it stays f32.

Weights: w_gate [d, E], w_in [E, d, f], w_out [E, f, d], no biases.
Expert parallelism (shard_map over the ep axis with all_to_all) is not
ported.
"""
import torch

from ..nn import gelu
from .kernels import moe_combine, moe_gather
from .router import capacity_for, route_top_k

__all__ = ["MoEFFN", "moe_ffn_values"]


def moe_ffn_values(x, wg, wi, wo, *, num_experts, k=2,
                   capacity_factor=1.25):
    """x [..., d] -> (out [..., d] in x's dtype, aux, z, stats [5])."""
    orig_shape = x.shape
    d = orig_shape[-1]
    tokens = x.reshape(-1, d)
    n = tokens.shape[0]
    E = num_experts
    C = capacity_for(n, E, k, capacity_factor)

    logits = tokens @ wg.to(tokens.dtype)
    comb_w, comb_slot, slot_token, aux, z, stats = route_top_k(logits, k, C)
    grouped = moe_gather(tokens.contiguous(), slot_token).reshape(E, C, d)
    h = gelu(torch.bmm(grouped, wi.to(tokens.dtype)))
    eo = torch.bmm(h, wo.to(tokens.dtype)).reshape(E * C, d)
    out = moe_combine(eo, comb_slot, comb_w.to(tokens.dtype))
    return out.to(tokens.dtype).reshape(orig_shape), aux, z, stats


class MoEFFN(torch.nn.Module):
    """Drop-in FFN: x [..., d] -> the same shape, keeping the aux and z
    losses and the routing stats of the LAST forward (the model folds the
    losses into its training loss and reports the stats).

    config: GPTMoEConfig-shaped (hidden_size, ffn_hidden_size,
    num_experts, expert_top_k, capacity_factor). Parameters are created
    empty; the owning model initialises them.

    The forward makes no host sync and no shape that depends on data
    (capacity_for(n, E, k, cf) from the row count alone), so it runs
    inside the serving engine's and `generate`'s captured steps, which
    route every row they carry (idle slots, a chunk's padding) as the
    JAX engine's compiled step does. There the stashed aux, z and stats
    are outputs of the graph's memory pool: read them before the next
    replay of any graph of that step.
    """

    def __init__(self, config, device=None, dtype=torch.float32):
        super().__init__()
        c = config
        d, f, E = c.hidden_size, c.ffn_hidden_size, c.num_experts
        self.num_experts = E
        self.k = c.expert_top_k
        self.capacity_factor = c.capacity_factor
        to = dict(device=device, dtype=dtype)
        self.w_gate = torch.nn.Parameter(torch.empty((d, E), **to))
        self.w_in = torch.nn.Parameter(torch.empty((E, d, f), **to))
        self.w_out = torch.nn.Parameter(torch.empty((E, f, d), **to))
        self._aux_loss = None
        self._z_loss = None
        self._stats = None

    def forward(self, x):
        out, aux, z, stats = moe_ffn_values(
            x, self.w_gate, self.w_in, self.w_out,
            num_experts=self.num_experts, k=self.k,
            capacity_factor=self.capacity_factor)
        self._aux_loss = aux
        self._z_loss = z
        self._stats = stats
        return out

    def aux_loss(self):
        return self._aux_loss

    def z_loss(self):
        return self._z_loss

    def stats(self):
        """[entropy, dropped_frac, overflow, aux, z] of the last forward
        (router.STATS_FIELDS order), or None."""
        return self._stats
