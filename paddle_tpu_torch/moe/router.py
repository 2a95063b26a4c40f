"""Top-k expert routing with GShard capacity bucketing.

Counterpart of paddle_tpu/moe/router.py, with the same math: softmax
gate in f32, top-k (ties to the lowest expert, as `lax.top_k`), per-slot
cumulative positions with the cross-slot count offset (a token's slot-s
choice queues behind every slot-<s choice of the same expert), and the
index form of the result:

  slot_token [E*C]  int32  token occupying slot (e, c), n = empty
  comb_slot  [n, k] int32  flat slot each choice landed in, E*C = dropped
  comb_w     [n, k] f32    gate weight (0 where dropped)

plus the load-balancing aux loss over the top-1 assignment, the router
z-loss and the health stats in `STATS_FIELDS` order. Dropped choices are
scattered into one spare slot past the end, which is sliced off (the
JAX scatter drops them with mode="drop"), so they never land in a real
slot; kept choices occupy distinct slots. Every shape follows from n, E,
k and C alone and nothing is read back to the host, so the serving
engine's and `generate`'s captured steps can replay the routing.
"""
import torch

from ..generation import _top_k_stable

__all__ = ["route_top_k", "router_stats_names", "capacity_for",
           "STATS_FIELDS"]

STATS_FIELDS = ("entropy", "dropped_frac", "overflow", "aux_loss",
                "z_loss")


def router_stats_names():
    return STATS_FIELDS


def capacity_for(n_tokens, num_experts, k, capacity_factor):
    """Per-expert capacity: the JAX package's formula."""
    return max(1, int(capacity_factor * n_tokens * k / num_experts))


def _one_hot_t(idx, E):
    """[E, n] int64 with a 1 at (idx[i], i): the transposed one-hot of
    idx, made by a comparison (one_hot checks its range on the host)."""
    experts = torch.arange(E, dtype=idx.dtype, device=idx.device)
    return (experts[:, None] == idx[None, :]).long()


def route_top_k(logits, k, capacity):
    """logits [n, E] -> (comb_w [n, k], comb_slot [n, k], slot_token
    [E*C], aux, z, stats [5]). Differentiable through comb_w, aux and z
    only; the positions are integer data."""
    n, E = logits.shape
    C = int(capacity)
    n_slots = E * C
    dev = logits.device
    probs = torch.softmax(logits.float(), dim=-1)
    # the beam search's stable top-k: ties go to the lowest expert, as
    # in lax.top_k (torch.topk leaves their order unspecified)
    gate_vals, gate_idx = _top_k_stable(probs, k)          # [n, k]

    counts = torch.zeros((E,), dtype=torch.long, device=dev)
    slot_token = torch.full((n_slots + 1,), n, dtype=torch.int32,
                            device=dev)
    token_ids = torch.arange(n, dtype=torch.int32, device=dev)
    comb_slot, comb_w = [], []
    kept_total = torch.zeros((), dtype=torch.float32, device=dev)
    for s in range(k):
        idx = gate_idx[:, s]
        # a token's rank in its expert's queue: the earlier tokens that
        # chose the same expert. The cumsum runs along the contiguous
        # token axis of the [E, n] one-hot: over the [n, E] layout, as
        # the JAX code writes it, CUDA's scan of an outer dimension 8
        # wide took ~1.4 ms at n 8192 on an H100
        onehot_t = _one_hot_t(idx, E)
        rank = torch.cumsum(onehot_t, dim=1).gather(0, idx[None])[0] - 1
        pos_in_e = rank + counts[idx]
        counts = counts + onehot_t.sum(dim=1)
        keep = pos_in_e < C
        dest = torch.where(keep, idx * C + torch.clamp(pos_in_e, max=C - 1),
                           n_slots)
        slot_token[dest] = token_ids
        comb_slot.append(dest)
        comb_w.append(gate_vals[:, s] * keep.float())
        kept_total = kept_total + keep.float().sum()
    slot_token = slot_token[:n_slots]
    comb_slot = torch.stack(comb_slot, dim=1).to(torch.int32)
    comb_w = torch.stack(comb_w, dim=1)

    # aux loss over the top-1 assignment (GShard): E * sum(f_e * p_e)
    frac = _one_hot_t(gate_idx[:, 0], E).float().mean(dim=1)
    aux = E * (frac * probs.mean(dim=0)).sum()
    # router z-loss (ST-MoE eq.(5))
    z = torch.logsumexp(logits.float(), dim=-1).square().mean()

    entropy = -(frac * torch.log(torch.clamp(frac, min=1e-9))).sum()
    dropped_frac = 1.0 - kept_total / float(n * k)
    overflow = counts.max().float() / float(C)
    stats = torch.stack([entropy, dropped_frac, overflow, aux.detach(),
                         z.detach()])
    return comb_w, comb_slot, slot_token, aux, z, stats
