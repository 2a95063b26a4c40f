"""Autoregressive generation: KV-cache decoding, sampling, beam search.

The port of paddle_tpu/generation/__init__.py's `run_generate`. The JAX
package compiles prefill and the whole token loop into one XLA program
(`lax.while_loop`, its position a traced int32 in the loop carry). The
port runs one eager prefill of the prompt, then the loop's body — one
forward of one token, attending through the `decode_fused` kernel on the
card — as a CUDA graph (`jit.CapturedStep`) replayed once a token. The
body's state lives in static device buffers that it updates in place:
the position `cur` (a 0-dim int32 the forward reads as its offset, and
`decode_fused` from device memory; the graph advances it), the PRNG key,
`done`, the score, the last logits, the output ids and the KV cache.
`decode_fused`'s grid depends on the position only through its chunk
count (`ops.decode_attention.decode_split`), so the host, which knows
the position, replays one graph a chunk count. The loop stops early on
EOS only when `eos_token_id` is set, so a run without EOS makes no host
round trip per step.

Those buffers, the weights cast to the decode dtype and the graphs are
kept across calls, per model (a capture costs tens of ms, of the order
of a whole short decode): each call copies the current weights into the
cast storage, zeroes the caches (as the JAX `init_cache` does) and
resets the loop state, so a weight changed between two calls shows in
the second call's tokens. They are keyed by the model's parameter and
buffer identities (a re-quantized model gets new ones), the decode
dtype, the batch, the total length, the strategy and its knobs. A model
keeps the loop states of its last `KEPT_LOOP_STATES` keys (4), each
with its graphs, as the JAX package keeps a compiled program per shape:
requests that alternate among a few prompt lengths replay their graphs
instead of recapturing on every switch; a fifth key drops the least
recently used state and its graphs. `release(model)` drops all of it (the counterpart of
`jax.clear_caches()`), and a `jit.TrainStep` over the model does so at
every step, so the kept buffers never sit beside training's.
Captures are kind=compile records (families `generate` and `beam`;
`capture_records(model)`). On the CPU the same bodies run eagerly over
the same buffers.

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
import collections
import contextlib
import itertools
import weakref

import torch

from .. import prng
from ..device import resolve_device, resolve_dtype
from ..jit import CapturedStep
from ..ops.decode_attention import decode_split, device_split
from ..telemetry.compile_obs import signature_of

__all__ = ["run_generate", "capture_records", "release", "KEPT_LOOP_STATES"]

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
def _decode_weights(model, dtype, store=None):
    """For the duration of one call, every floating parameter AND buffer
    (the wo8 `w_scale`s) of `model` holds its value cast to `dtype`
    (None: unchanged); int8 stays int8. The cast is made anew from the
    current weights on every call and undone after it, so nothing stale
    is kept across a training step or a quantization. With `store` (a
    dict) the cast is copied into storage kept there, the same storage
    on every call, so a captured step that reads it stays valid. Not
    thread-safe: the model is rebound in place while the call runs."""
    saved = []
    try:
        if dtype is not None:
            for t in itertools.chain(model.parameters(), model.buffers()):
                if t.is_floating_point() and t.dtype != dtype:
                    saved.append((t, t.data))
                    if store is None:
                        t.data = t.data.to(dtype)
                        continue
                    cast = store.get(id(t))
                    if cast is None:
                        cast = store[id(t)] = torch.empty_like(t.data,
                                                               dtype=dtype)
                    cast.copy_(t.data)
                    t.data = cast
        yield
    finally:
        for t, data in reversed(saved):
            t.data = data


# ---------------------------------------------------------------------------
# the steps kept across calls
# ---------------------------------------------------------------------------

# loop states (with their graphs) a model keeps, least recently used
# dropped first
KEPT_LOOP_STATES = 4


class _ModelSteps:
    """One model's `generate` state: the weights cast to the decode dtype
    (`store`, refreshed in place every call), the loop states (static
    buffers) of its last few keys and the graphs of their token steps
    (one CapturedStep: one memory pool and capture stream)."""

    def __init__(self, device):
        self.weights_key = None
        self.weights_gen = -1       # bumped when the weights are others
        self.store = {}
        self.loops = collections.OrderedDict()     # key -> _LoopState
        self.steps = CapturedStep(device)
        self.calls = 0

    @property
    def loop_key(self):
        """The most recently used loop state's key (None: none kept)."""
        return next(reversed(self.loops), None)

    @property
    def loop(self):
        """The most recently used loop state (None: none kept)."""
        key = self.loop_key
        return None if key is None else self.loops[key]

    def state(self, key, make):
        """The loop state `key`: the kept one, or one made by `make()`;
        past `KEPT_LOOP_STATES` the least recently used state goes, with
        its graphs (the pool stays for the others)."""
        if key in self.loops:
            self.loops.move_to_end(key)
            return self.loops[key]
        while len(self.loops) >= KEPT_LOOP_STATES:
            old, _ = self.loops.popitem(last=False)  # freed before make()
            self.steps.discard(lambda gkey, old=old: gkey[0] == old)
        self.loops[key] = make()
        return self.loops[key]

    def clear(self):
        """Drop every loop state and graph (the weights changed)."""
        self.steps.invalidate(keep_pool=True)
        self.loops.clear()


_MODEL_STEPS = weakref.WeakKeyDictionary()


def _model_steps(model, dtype, device):
    """The model's kept `generate` state, emptied when its parameters or
    buffers are not the ones it was made for (rebound, re-quantized, or
    another decode dtype): its graphs read their storage."""
    key = (dtype, tuple((id(t), t.data_ptr(), t.dtype, tuple(t.shape))
                        for t in itertools.chain(model.parameters(),
                                                 model.buffers())))
    ms = _MODEL_STEPS.get(model)
    if ms is None:
        ms = _MODEL_STEPS[model] = _ModelSteps(device)
    if ms.weights_key != key:
        ms.clear()
        ms.store.clear()
        ms.weights_key = key
        ms.weights_gen += 1
    ms.calls += 1
    return ms


def release(model):
    """Drop `model`'s kept `generate` state: the cast weights, the loop
    buffers, the graphs and their records. The next call makes and
    captures them anew."""
    _MODEL_STEPS.pop(model, None)


def capture_records(model):
    """The kind=compile records of `model`'s `generate` captures ([] when
    it never ran on the card)."""
    ms = _MODEL_STEPS.get(model)
    return [] if ms is None else list(ms.steps.records)


class _LoopState:
    """Static buffers of one token loop: the KV cache, the position, the
    output ids, and the selection state; `last` (the last logits) and a
    beam loop's `done_row` are made at the first prefill, which gives
    their width. The token step's graphs read all of them."""

    def __init__(self, model, rows, total, device, beams=0, rng=False):
        self.caches = _model_core(model).init_cache(rows, total)
        self.cur = torch.zeros((), dtype=torch.int32, device=device)
        self.out = torch.zeros((rows, total), dtype=torch.long,
                               device=device)
        self.last = None
        self.done_row = None
        self.rng = (torch.zeros((2,), dtype=torch.long, device=device)
                    if rng else None)
        shape = (rows // beams, beams) if beams else (rows,)
        self.done = torch.zeros(shape, dtype=torch.bool, device=device)
        self.score = torch.zeros(shape, dtype=torch.float32, device=device)
        if beams:
            self.lengths = torch.zeros(shape, dtype=torch.int32,
                                       device=device)
            self.brow = torch.arange(rows // beams, device=device)[:, None]

    def take_last(self, logits):
        if self.last is None:
            self.last = torch.empty_like(logits)
        self.last.copy_(logits)

    def signature(self, static):
        return signature_of((self.out, self.last, self.caches[0][0]),
                            arg_names=("out", "last", "cache"),
                            static=static)


def _run_steps(ms, family, key, st, s0, total, body, static, eos_token_id):
    """Replay the token step at positions s0..total-1, the graph of each
    position's `decode_fused` chunk count (checked against the position
    the host knows), stopping after the step that finishes every row
    when `eos_token_id` is set."""
    for cur in range(s0, total):
        chunks = decode_split(cur)[0]
        device_split(cur, chunks)
        ms.steps.run(family, (key, chunks, ms.weights_gen),
                     lambda: body(chunks),
                     signature=lambda: st.signature(
                         {**static, "chunks": chunks,
                          "weights": ms.weights_gen}),
                     step=ms.calls)
        if eos_token_id is not None and bool(st.done.all()):
            break


# ---------------------------------------------------------------------------
# decode loops
# ---------------------------------------------------------------------------

def _sample_loop(model, ids, max_new, select, eos_token_id, pad_token_id,
                 rng, ms, knobs):
    b, s0 = ids.shape
    total = s0 + max_new
    eos = -1 if eos_token_id is None else int(eos_token_id)
    key = ("generate", b, total, eos, pad_token_id) + knobs
    st = ms.state(key, lambda: _LoopState(model, b, total, ids.device,
                                          rng=rng is not None))
    for k, v in st.caches:
        k.zero_()
        v.zero_()
    logits, _ = model(ids, caches=st.caches, offset=0)
    st.take_last(logits[:, -1])
    st.out[:, :s0] = ids
    st.out[:, s0:] = pad_token_id
    st.done.zero_()
    st.score.zero_()
    st.cur.fill_(s0)
    if rng is not None:
        st.rng.copy_(rng)

    def step(chunks):
        sub = None
        if st.rng is not None:              # greedy draws nothing
            keys = prng.split(st.rng)
            st.rng.copy_(keys[0])
            sub = keys[1]
        tok, tok_logp = select(st.last, sub)
        tok = torch.where(st.done, pad_token_id, tok)
        st.score.add_(torch.where(st.done, 0.0, tok_logp))
        st.done.logical_or_(tok == eos)
        st.out.index_copy_(1, st.cur.long().reshape(1), tok[:, None])
        logits, _ = model(tok[:, None], caches=st.caches, offset=st.cur,
                          decode_chunks=chunks)
        st.take_last(logits[:, -1])
        st.cur.add_(1)

    _run_steps(ms, "generate", key, st, s0, total, step,
               {"strategy": knobs[0], "batch": b, "total": total},
               eos_token_id)
    return st.out.clone(), st.score.clone()


def _beam_loop(model, ids, max_new, num_beams, length_penalty,
               eos_token_id, pad_token_id, temperature, ms):
    b, s0 = ids.shape
    total = s0 + max_new
    nb = int(num_beams)
    flat_b = b * nb
    dev = ids.device
    eos = -1 if eos_token_id is None else int(eos_token_id)
    key = ("beam", b, total, nb, eos, pad_token_id, float(temperature))
    st = ms.state(key, lambda: _LoopState(model, flat_b, total, dev,
                                          beams=nb))
    # prefill ONCE on [b, s0] (all beams share the prompt), then tile the
    # caches and logits across the beams
    caches = _model_core(model).init_cache(b, total)
    logits, caches = model(ids, caches=caches, offset=0)
    for (k, v), (pk, pv) in zip(st.caches, caches):
        k.copy_(pk.repeat_interleave(nb, 0))
        v.copy_(pv.repeat_interleave(nb, 0))
    del caches
    st.take_last(logits[:, -1].repeat_interleave(nb, 0))   # [b*nb, V]
    V = st.last.shape[-1]
    st.out[:, :s0] = ids.repeat_interleave(nb, 0)
    st.out[:, s0:] = pad_token_id
    # only beam 0 is live initially, or every beam proposes the same
    # tokens and the top nb are duplicates
    st.score.fill_(_NEG_INF)
    st.score[:, 0] = 0.0
    st.done.zero_()
    st.lengths.zero_()
    st.cur.fill_(s0)
    if st.done_row is None:
        # continuation row of a finished beam: pad has logp 0, the rest
        # -inf, so a done beam survives the top nb with its score
        # unchanged
        st.done_row = torch.full((V,), _NEG_INF, device=dev)
        st.done_row[pad_token_id] = 0.0
    done_row, brow = st.done_row, st.brow

    def step(chunks):
        lg = st.last.float()
        if temperature != 1.0:
            lg = lg / temperature
        logp = torch.log_softmax(lg, dim=-1).reshape(b, nb, V)
        logp = torch.where(st.done[..., None], done_row, logp)
        cand = (st.score[..., None] + logp).reshape(b, nb * V)
        scores, top_idx = _top_k_stable(cand, nb)          # [b, nb]
        beam_idx = top_idx // V
        tok = top_idx % V
        st.out.copy_(st.out.reshape(b, nb, total)[brow, beam_idx].reshape(
            flat_b, total))
        st.out.index_copy_(1, st.cur.long().reshape(1),
                           tok.reshape(flat_b, 1))
        prev_done = st.done[brow, beam_idx]
        prev_len = st.lengths[brow, beam_idx]
        st.lengths.copy_(torch.where(prev_done, prev_len, prev_len + 1))
        st.done.copy_(prev_done | (tok == eos))
        st.score.copy_(scores)
        # reorder the caches by the surviving beams, in place
        src = (brow * nb + beam_idx).reshape(flat_b)
        for k, v in st.caches:
            k.copy_(k[src])
            v.copy_(v[src])
        logits, _ = model(tok.reshape(flat_b, 1), caches=st.caches,
                          offset=st.cur, decode_chunks=chunks)
        st.take_last(logits[:, -1])
        st.cur.add_(1)

    _run_steps(ms, "beam", key, st, s0, total, step,
               {"beams": nb, "batch": b, "total": total}, eos_token_id)
    scores = st.score
    if length_penalty != 0.0:
        # GNMT length penalty ((5 + len) / 6)^alpha (Wu et al. 2016)
        scores = scores / torch.pow((5.0 + st.lengths.float()) / 6.0,
                                    length_penalty)
    best = torch.argmax(scores, dim=-1)
    rows = torch.arange(b, device=dev)
    return st.out.reshape(b, nb, total)[rows, best], scores[rows, best]


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
    ms = _model_steps(model, cdt, wdev)
    with _decode_weights(model, cdt, ms.store), torch.inference_mode():
        if decode_strategy == "beam_search":
            return _beam_loop(model, ids, int(max_new_tokens), num_beams,
                              length_penalty, eos_token_id, pad_token_id,
                              temperature, ms)
        rng = None
        if decode_strategy == "sampling":
            rng = prng.prng_key(prng.fresh_seed() if seed is None
                                else seed, device=wdev)
        select = _make_selector(decode_strategy, top_k, top_p, temperature)
        return _sample_loop(model, ids, int(max_new_tokens), select,
                            eos_token_id, pad_token_id, rng, ms,
                            (decode_strategy, top_k, top_p, temperature))
