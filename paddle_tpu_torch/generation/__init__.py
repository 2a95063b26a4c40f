"""Autoregressive generation: KV-cache decoding, sampling, beam search.

The port of paddle_tpu/generation/__init__.py's `run_generate`. The JAX
package compiles prefill and the whole token loop into one XLA program
(`lax.while_loop`); the port runs the same steps eagerly from a host
loop over the same fixed-shape buffers (`GPTModel.init_cache`): one
prefill of the prompt, then one forward of one token per step, each
attending through the `decode_fused` kernel on the card. The loop stops
early on EOS only when `eos_token_id` is set, so a run without EOS makes
no host round trip per step.

Token selection follows the JAX functions: greedy is the f32 argmax
(lowest index on ties), top-k keeps logits >= the k-th largest, top-p
keeps the smallest prefix of the stably sorted distribution whose mass
reaches p, and beam search takes the nb best of the nb·V candidates with
a stable sort, so ties resolve to the lowest index as `lax.top_k`'s do.
Sampling draws as the JAX loop does, from jax.random's own generator
(`prng`, threefry2x32 in torch): the base key is `PRNGKey(seed)`, every
step splits it into (next base, step key) and draws
`categorical(step key, logits)` over the whole batch, so a seeded run
samples the same tokens as the JAX package's. With `seed=None` the base
key's seed comes from torch's default generator (`torch.manual_seed`
makes it reproducible); no such stream is claimed to match JAX's.
`dynamic_decode`/`BeamSearchDecoder` (the RNN-cell API) are not ported.
"""
import contextlib
import itertools

import torch

from .. import prng
from ..device import resolve_device, resolve_dtype

__all__ = ["run_generate"]

_NEG_INF = -1e30


# ---------------------------------------------------------------------------
# token selection
# ---------------------------------------------------------------------------

def _apply_top_k(logits, k):
    # only the k-th largest VALUE is used, so how ties are ordered does
    # not matter here
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, _NEG_INF, logits)


def _apply_top_p(logits, p):
    # a stable descending sort orders ties by index, as jnp.argsort(-x)
    sorted_logits, sort_idx = torch.sort(logits, dim=-1, descending=True,
                                         stable=True)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < p    # always keeps the top token
    masked = torch.where(keep, sorted_logits, _NEG_INF)
    return torch.empty_like(masked).scatter_(-1, sort_idx, masked)


def _make_selector(decode_strategy, top_k, top_p, temperature):
    def select(logits, key):
        lg = logits.float()
        if temperature != 1.0:
            lg = lg / temperature
        if decode_strategy == "greedy":
            tok = torch.argmax(lg, dim=-1)
        else:
            if top_k and top_k > 0:
                lg = _apply_top_k(lg, int(top_k))
            if top_p is not None and top_p < 1.0:
                lg = _apply_top_p(lg, float(top_p))
            tok = prng.categorical(key, lg)
        logp = torch.log_softmax(logits.float(), dim=-1)
        return tok, logp.gather(-1, tok[:, None])[:, 0]
    return select


def _top_k_stable(x, k):
    """The k largest of each row, ties to the lowest index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


# ---------------------------------------------------------------------------
# model plumbing
# ---------------------------------------------------------------------------

def _model_core(model):
    core = getattr(model, "gpt", None)
    if core is None or not hasattr(core, "init_cache"):
        core = model
    if not hasattr(core, "init_cache"):
        raise TypeError(
            "generate() needs a model exposing init_cache(batch, max_len) "
            "and forward(ids, caches=, offset=) -> (logits, caches)")
    return core


@contextlib.contextmanager
def _decode_weights(model, dtype):
    """For the duration of one call, every floating parameter AND buffer
    (the wo8 `w_scale`s) of `model` holds its value cast to `dtype`
    (None: unchanged); int8 stays int8. The cast is made anew from the
    current weights on every call and undone after it, so nothing stale
    is kept across a training step or a quantization. Not thread-safe:
    the model is rebound in place while the call runs."""
    saved = []
    try:
        if dtype is not None:
            for t in itertools.chain(model.parameters(), model.buffers()):
                if t.is_floating_point() and t.dtype != dtype:
                    saved.append((t, t.data))
                    t.data = t.data.to(dtype)
        yield
    finally:
        for t, data in reversed(saved):
            t.data = data


# ---------------------------------------------------------------------------
# decode loops
# ---------------------------------------------------------------------------

def _sample_loop(model, ids, max_new, select, eos_token_id, pad_token_id,
                 rng):
    b, s0 = ids.shape
    total = s0 + max_new
    eos = -1 if eos_token_id is None else int(eos_token_id)
    caches = _model_core(model).init_cache(b, total)
    logits, caches = model(ids, caches=caches, offset=0)
    last = logits[:, -1]
    out = torch.cat([ids, ids.new_full((b, max_new), pad_token_id)], 1)
    done = torch.zeros((b,), dtype=torch.bool, device=ids.device)
    score = torch.zeros((b,), dtype=torch.float32, device=ids.device)
    for cur in range(s0, total):
        sub = None
        if rng is not None:                 # greedy draws nothing
            rng, sub = prng.split(rng)
        tok, tok_logp = select(last, sub)
        tok = torch.where(done, pad_token_id, tok)
        score = score + torch.where(done, 0.0, tok_logp)
        done = done | (tok == eos)
        out[:, cur] = tok
        logits, caches = model(tok[:, None], caches=caches, offset=cur)
        last = logits[:, -1]
        if eos_token_id is not None and bool(done.all()):
            break
    return out, score


def _beam_loop(model, ids, max_new, num_beams, length_penalty,
               eos_token_id, pad_token_id, temperature):
    b, s0 = ids.shape
    total = s0 + max_new
    nb = int(num_beams)
    flat_b = b * nb
    dev = ids.device
    eos = -1 if eos_token_id is None else int(eos_token_id)
    # prefill ONCE on [b, s0] (all beams share the prompt), then tile the
    # caches and logits across the beams
    caches = _model_core(model).init_cache(b, total)
    logits, caches = model(ids, caches=caches, offset=0)
    caches = [(k.repeat_interleave(nb, 0), v.repeat_interleave(nb, 0))
              for k, v in caches]
    last = logits[:, -1].repeat_interleave(nb, 0)          # [b*nb, V]
    V = last.shape[-1]
    out = torch.cat([ids.repeat_interleave(nb, 0),
                     ids.new_full((flat_b, max_new), pad_token_id)], 1)
    # only beam 0 is live initially, or every beam proposes the same
    # tokens and the top nb are duplicates
    scores = torch.tensor([0.0] + [_NEG_INF] * (nb - 1),
                          device=dev).repeat(b, 1)         # [b, nb]
    done = torch.zeros((b, nb), dtype=torch.bool, device=dev)
    lengths = torch.zeros((b, nb), dtype=torch.int32, device=dev)
    # continuation row of a finished beam: pad has logp 0, the rest -inf,
    # so a done beam survives the top nb with its score unchanged
    done_row = torch.full((V,), _NEG_INF, device=dev)
    done_row[pad_token_id] = 0.0
    brow = torch.arange(b, device=dev)[:, None]
    for cur in range(s0, total):
        lg = last.float()
        if temperature != 1.0:
            lg = lg / temperature
        logp = torch.log_softmax(lg, dim=-1).reshape(b, nb, V)
        logp = torch.where(done[..., None], done_row, logp)
        cand = (scores[..., None] + logp).reshape(b, nb * V)
        scores, top_idx = _top_k_stable(cand, nb)          # [b, nb]
        beam_idx = top_idx // V
        tok = top_idx % V
        out = out.reshape(b, nb, total)[brow, beam_idx].reshape(flat_b,
                                                                total)
        out[:, cur] = tok.reshape(flat_b)
        prev_done = done[brow, beam_idx]
        prev_len = lengths[brow, beam_idx]
        lengths = torch.where(prev_done, prev_len, prev_len + 1)
        done = prev_done | (tok == eos)
        src = (brow * nb + beam_idx).reshape(flat_b)
        caches = [(k[src], v[src]) for k, v in caches]
        logits, caches = model(tok.reshape(flat_b, 1), caches=caches,
                               offset=cur)
        last = logits[:, -1]
        if eos_token_id is not None and bool(done.all()):
            break
    if length_penalty != 0.0:
        # GNMT length penalty ((5 + len) / 6)^alpha (Wu et al. 2016)
        scores = scores / torch.pow((5.0 + lengths.float()) / 6.0,
                                    length_penalty)
    best = torch.argmax(scores, dim=-1)
    rows = torch.arange(b, device=dev)
    return out.reshape(b, nb, total)[rows, best], scores[rows, best]


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

def run_generate(model, input_ids, max_new_tokens=32,
                 decode_strategy="greedy", top_k=0, top_p=1.0,
                 temperature=1.0, num_beams=1, length_penalty=0.0,
                 eos_token_id=None, pad_token_id=0, seed=None,
                 dtype="bfloat16", device=None):
    """Decode `max_new_tokens` after the prompt `input_ids` [b, s0].

    dtype: the decode compute dtype; "bfloat16" (default) casts every
    floating parameter and buffer for the call, None decodes in the
    parameters' own dtype. The KV cache keeps the config's dtype, as in
    the JAX package. device: None is the CUDA card (raises without one);
    the model must already live on the device asked for. Returns (ids
    [b, s0 + max_new_tokens] int64 — pad_token_id past an EOS stop —,
    scores [b] f32: the summed logp of the chosen tokens, for beam search
    the length-penalized score of the best beam)."""
    if decode_strategy not in ("greedy", "sampling", "beam_search"):
        raise ValueError(f"unknown decode_strategy {decode_strategy!r}")
    if decode_strategy == "beam_search" and num_beams < 2:
        raise ValueError("beam_search needs num_beams >= 2")
    dev = resolve_device(device)
    wdev = next(model.parameters()).device
    if wdev.type != dev.type or (dev.index is not None
                                 and wdev.index != dev.index):
        raise ValueError(f"generate: the model lives on {wdev} but the "
                         f"call asks for {dev}; move it with "
                         f"model.to({str(dev)!r}) first")
    ids = torch.as_tensor(input_ids).to(device=wdev, dtype=torch.long)
    if ids.dim() != 2:
        raise ValueError("input_ids must be [batch, prompt_len]")
    cdt = None if dtype is None else resolve_dtype(dtype)
    with _decode_weights(model, cdt), torch.inference_mode():
        if decode_strategy == "beam_search":
            return _beam_loop(model, ids, int(max_new_tokens), num_beams,
                              length_penalty, eos_token_id, pad_token_id,
                              temperature)
        rng = None
        if decode_strategy == "sampling":
            rng = prng.prng_key(prng.fresh_seed() if seed is None
                                else seed, device=wdev)
        select = _make_selector(decode_strategy, top_k, top_p, temperature)
        return _sample_loop(model, ids, int(max_new_tokens), select,
                            eos_token_id, pad_token_id, rng)
