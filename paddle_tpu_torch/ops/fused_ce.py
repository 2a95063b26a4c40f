"""Fused vocab projection + cross entropy — the port of
paddle_tpu/ops/fused_ce.py.

`fused_linear_cross_entropy(h, w, labels)` is the per-token loss
`logsumexp(h @ w.T) - (h @ w.T)[label]` computed over vocab chunks
(`_pick_chunks`: the largest count <= 16 that divides the vocab) with an
online max and log-sum-exp, so only one [N, V / chunks] block of logits
exists at a time and the [N, V] logits never do. The backward recomputes
each chunk's logits from (h, w, lse) and accumulates dh in f32 over the
chunks; dw comes chunk by chunk from f32 sums over the tokens, in w's
dtype. Labels outside [0, V) (the -100 padding) give loss 0 and no
gradient. The chunk products are `torch.mm`: the JAX package computes
them outside any Pallas kernel. Compute dtype: h's (the caller casts h
for amp; w stays full precision and each chunk is cast to h's dtype).
A chunk's logits are a product in h's dtype with f32 sums (the JAX
`preferred_element_type=h.dtype`); dh and dw are products with f32
results, which for bf16 operands on the card is `torch.mm(...,
out_dtype=torch.float32)` and elsewhere the product of the operands
widened to f32 (products of bf16 values are exact in f32: the same
arithmetic).
"""
import torch

__all__ = ["fused_linear_cross_entropy", "FusedLinearCrossEntropy"]


def _pick_chunks(vocab):
    """Largest chunk count <= 16 dividing vocab (fallback 1)."""
    for n in (16, 12, 8, 6, 4, 3, 2):
        if vocab % n == 0:
            return n
    return 1


def _mm_f32(a, b):
    """a @ b with f32 sums and an f32 result."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class FusedLinearCrossEntropy(torch.autograd.Function):
    """loss [N] f32 = CE(h [N, D] @ w [V, D].T, labels [N])."""

    @staticmethod
    def forward(ctx, h, w, labels, n_chunks=None):
        vocab = w.shape[0]
        nc = n_chunks or _pick_chunks(vocab)
        c = vocab // nc
        n = h.shape[0]
        labels = labels.long()
        f32 = dict(dtype=torch.float32, device=h.device)
        m = torch.full((n,), -float("inf"), **f32)
        s = torch.zeros((n,), **f32)
        picked = torch.zeros((n,), **f32)
        for j in range(nc):
            lf = torch.mm(h, w[j * c:(j + 1) * c].to(h.dtype).t()).float()
            new_m = torch.maximum(m, lf.amax(dim=1))
            s = s * torch.exp(m - new_m) \
                + torch.exp(lf - new_m[:, None]).sum(dim=1)
            rel = labels - j * c
            in_chunk = (rel >= 0) & (rel < c)
            pick = lf.gather(1, rel.clamp(0, c - 1)[:, None])[:, 0]
            picked = torch.where(in_chunk, pick, picked)
            m = new_m
        lse = m + torch.log(s)
        valid = (labels >= 0) & (labels < vocab)
        ctx.save_for_backward(h, w, labels, lse)
        ctx.nc = nc
        return torch.where(valid, lse - picked, 0.0)

    @staticmethod
    def backward(ctx, dloss):
        h, w, labels, lse = ctx.saved_tensors
        vocab, d = w.shape
        nc = ctx.nc
        c = vocab // nc
        valid = (labels >= 0) & (labels < vocab)
        dloss = torch.where(valid, dloss.float(), 0.0)
        dh = torch.zeros((h.shape[0], d), dtype=torch.float32,
                         device=h.device)
        dw = torch.empty_like(w)
        for j in range(nc):
            wc = w[j * c:(j + 1) * c].to(h.dtype)
            p = torch.exp(torch.mm(h, wc.t()).float() - lse[:, None])
            rel = labels - j * c
            in_chunk = (rel >= 0) & (rel < c)
            # p - onehot: -1 at the label's column, -0.0 (exact) elsewhere
            p.scatter_add_(1, rel.clamp(0, c - 1)[:, None],
                           -in_chunk.float()[:, None])
            dl = p.mul_(dloss[:, None]).to(h.dtype)
            dh += _mm_f32(dl, wc)
            dw[j * c:(j + 1) * c] = _mm_f32(dl.t(), h)
        return dh.to(h.dtype), dw, None, None


def fused_linear_cross_entropy(h, w, labels, n_chunks=None):
    """Per-token CE loss [N] (f32) of the projection `h @ w.T` against
    `labels`. h: [N, D] (any float dtype; bf16 under amp); w: [V, D],
    full precision (its gradient comes back in w's dtype); labels: [N]
    integers."""
    return FusedLinearCrossEntropy.apply(h, w, labels, n_chunks)
