"""MoE FFN layer: routed expert feed-forward, with expert parallelism.

Counterpart of paddle_tpu/moe/layer.py (`_local_moe`, `moe_ffn_values`,
`MoEFFN`): gate, route, dispatch through the `moe_gather` kernel into
[E, C, d] expert buckets, the two batched expert products with
tanh-gelu between them (`torch.bmm`: the JAX package leaves them to
XLA), and the weighted combine through the `moe_combine` kernel. The
body runs in the tokens' dtype with no amp casts, as the JAX body runs
raw jnp inside `apply`: in the GPT block its input is ln2's output in the
residual stream's f32, so under bf16 amp it stays f32.

Weights: w_gate [d, E] replicated, w_in [E, d, f] tagged ("ep", None,
"mp"), w_out [E, f, d] tagged ("ep", "mp", None), no biases;
`distributed.shard_model` cuts the expert dim over ep and f over mp.

Expert parallelism (an installed mesh with an ep axis above 1, the JAX
shard_map over ep): the ranks of an ep group hold the same rows. Each
takes its 1/ep block of the flattened tokens (`split_axis`), routes it
with the capacity of n/ep tokens, gathers it into its [E·C, d] buckets
(K12), sends bucket group k to ep rank k and receives its own e_loc =
E/ep experts' buckets from every rank (`all_to_all_axis`), runs its
experts, sends the rows back (a second all_to_all), combines its block
(K13) and all-gathers the blocks (`gather_axis`); aux, z and the stats
are averaged over ep. Under mp the expert products are Megatron's
column/row pair over the f dim (`c_identity`, `mp_allreduce`).

The adjoint convention over ep: every rank of an ep group keeps the
whole loss of its rows (as over mp), so the model's other parameters
get their whole gradients on every rank and nothing else is reduced
over ep. The split's backward all-gathers the blocks' gradients, the
gather's backward takes this rank's block, the mean of aux and z is an
all-reduce whose backward passes the cotangent on (then / ep), and
w_gate, which each rank uses only on its own block, has its gradient
summed over ep (`c_identity(w_gate, "ep")`: shard_map's transpose of a
replicated input). The experts' gradients come back whole through the
all_to_all's adjoint and are reduced over dp only.
"""
import torch

from ..distributed import env as dist_env
from ..distributed.collective import (_psum_raw, all_to_all_axis,
                                      c_identity, gather_axis, mp_allreduce,
                                      split_axis)
from ..nn import gelu
from .kernels import moe_combine, moe_gather
from .router import capacity_for, route_top_k

__all__ = ["MoEFFN", "moe_ffn_values"]


def _experts(grouped, wi, wo):
    """[e, c, d] buckets through the local experts: two bmm with gelu
    between; under mp, column- then row-parallel over the f dim."""
    dt = grouped.dtype
    h = gelu(torch.bmm(c_identity(grouped, "mp"), wi.to(dt)))
    return mp_allreduce(torch.bmm(h, wo.to(dt)), "mp")


def _local_moe(tokens, wg, wi, wo, *, num_experts, k, capacity_factor,
               ep, axis_name):
    """The per-rank body: tokens [n, d] (all the rank's rows; at ep > 1
    the same on every rank of the ep group), wi/wo this rank's experts
    (E/ep of them at ep > 1)."""
    E = num_experts
    d = tokens.shape[-1]
    if ep > 1:
        tokens = split_axis(tokens, axis_name, 0)
        wg = c_identity(wg, axis_name)
    n_loc = tokens.shape[0]
    e_loc = E // ep
    C = capacity_for(n_loc, E, k, capacity_factor)

    logits = tokens @ wg.to(tokens.dtype)
    comb_w, comb_slot, slot_token, aux, z, stats = route_top_k(logits, k, C)
    expert_in = moe_gather(tokens.contiguous(), slot_token)     # [E*C, d]
    if ep > 1:
        # my buckets split by destination rank (e_loc experts each);
        # each rank ends with its own experts' buckets from every source
        ei = all_to_all_axis(expert_in, axis_name, 0, 0)
        grouped = ei.reshape(ep, e_loc, C, d).transpose(0, 1) \
            .reshape(e_loc, ep * C, d)
    else:
        grouped = expert_in.reshape(E, C, d)
    eo = _experts(grouped, wi, wo)
    if ep > 1:
        eo = eo.reshape(e_loc, ep, C, d).transpose(0, 1) \
            .reshape(ep * e_loc * C, d)
        eo = all_to_all_axis(eo, axis_name, 0, 0)
        # routing health and the losses are means over the ep group
        both = mp_allreduce(torch.stack([aux, z]), axis_name) / ep
        aux, z = both[0], both[1]
        with torch.no_grad():
            stats = _psum_raw(stats, axis_name, "pmean") / ep
    out = moe_combine(eo.reshape(E * C, d), comb_slot,
                      comb_w.to(tokens.dtype)).to(tokens.dtype)
    if ep > 1:
        out = gather_axis(out, axis_name, 0)
    return out, aux, z, stats


def moe_ffn_values(x, wg, wi, wo, *, num_experts, k=2,
                   capacity_factor=1.25, axis_name="ep", mesh=None):
    """x [..., d] -> (out [..., d] in x's dtype, aux, z, stats [5]).
    With an ep axis above 1 on `mesh` (default the installed mesh) the
    expert-parallel body (see the module docstring); wi/wo are then this
    rank's expert pieces, and the flattened token count and the expert
    count must divide by ep (ValueError, as in JAX)."""
    prev = dist_env.current_mesh()
    if mesh is not None and mesh is not prev:
        dist_env.set_mesh(mesh)
    try:
        ep = dist_env.axis_size(axis_name)
        orig_shape = x.shape
        d = orig_shape[-1]
        tokens = x.reshape(-1, d)
        n = tokens.shape[0]
        if ep > 1 and (n % ep or num_experts % ep):
            raise ValueError(
                f"expert parallelism needs tokens ({n}) and num_experts "
                f"({num_experts}) divisible by the '{axis_name}' mesh axis "
                f"size {ep}")
        out, aux, z, stats = _local_moe(
            tokens, wg, wi, wo, num_experts=num_experts, k=k,
            capacity_factor=capacity_factor, ep=ep, axis_name=axis_name)
        return out.reshape(orig_shape), aux, z, stats
    finally:
        if mesh is not None and mesh is not prev:
            dist_env.set_mesh(prev)


class MoEFFN(torch.nn.Module):
    """Drop-in FFN: x [..., d] -> the same shape, keeping the aux and z
    losses and the routing stats of the LAST forward (the model folds the
    losses into its training loss and reports the stats).

    config: GPTMoEConfig-shaped (hidden_size, ffn_hidden_size,
    num_experts, expert_top_k, capacity_factor). Parameters are created
    empty; the owning model initialises them. `mesh_axes` are the JAX
    tags, which `distributed.shard_model` cuts by.

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
        self.mesh_axes = {"w_in": (("ep", None, "mp"), 1),
                          "w_out": (("ep", "mp", None), 1)}
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
