"""Sampled decoding in the port's serving engine and run_generate, against
the JAX package on the same weights, on the CPU in f32.

The port draws with jax.random's own generator (`paddle_tpu_torch.prng`),
so sampled streams are held to token identity with the JAX
`ServingEngine` — greedy and sampled requests mixed in one batch, top-k,
top-p and temperature, with the prefix cache on and off, under
preemption, and over a head whose rows come in identical pairs (every
logit tied) — with per-token logp within 1e-4. `_select` matches the
JAX engine's selection on integer-valued logits full of exact ties, and
its stable descending sort orders ties as `jnp.argsort(-x)` does. A
sampled stream does not depend on what shares its batch, `replay_tokens`
resumes a stream exactly, and seeded `run_generate` sampling is
token-identical to the JAX `run_generate`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import ServingEngine as JaxServingEngine

from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
from paddle_tpu_torch.ops.kernel_registry import kernels, reset_launches
from paddle_tpu_torch.serving import SamplingParams, ServingEngine
from paddle_tpu_torch.serving.engine import _select

_MODEL = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
              max_seq_len=128, dropout=0.0, initializer_range=0.2)
_ENGINE = dict(max_slots=4, block_size=8, prefill_chunk=8,
               max_model_len=64, dtype=None)
_SAMPLED = dict(decode_strategy="sampling")
# one request's knobs each: greedy and sampled requests mixed in a batch
_KNOBS = (dict(), dict(_SAMPLED, seed=1), dict(_SAMPLED, seed=2, top_k=5),
          dict(_SAMPLED, seed=3, top_p=0.8),
          dict(_SAMPLED, seed=4, temperature=0.7, top_k=20, top_p=0.9),
          dict(), dict(_SAMPLED, seed=2 ** 32 + 5, top_k=1),
          dict(_SAMPLED, seed=6, temperature=1.5))


def _pair(tied_head=False):
    paddle.seed(11)
    jm = JaxGPT(JaxGPTConfig(use_flash_attention=False, **_MODEL))
    if tied_head:
        # the head is tied to wte: rows in identical pairs make every
        # logit tie with its twin's
        w = jm.gpt.wte.weight
        v = np.asarray(w._value).copy()
        v[256:] = v[:256]
        w._value = jnp.asarray(v)
    tm = GPTForPretraining(GPTConfig(**_MODEL), device="cpu")
    load_jax_params(tm, [(n, np.asarray(p._value))
                         for n, p in jm.named_parameters()])
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _pair()


def _record_logp(eng):
    logps = {}
    orig = eng._emit

    def emit(req, tok, logp, now=None):
        logps.setdefault(req.rid, []).append(float(logp))
        return orig(req, tok, logp, now=now)

    eng._emit = emit
    return logps


def _serve(eng, prompts, knobs, max_new, sampling_params):
    logps = _record_logp(eng)
    handles = [eng.submit(p, sampling_params(max_new_tokens=max_new, **k))
               for p, k in zip(prompts, knobs)]
    eng.run_until_idle(max_steps=5000)
    assert eng.pool.num_used == 0
    return ([h.output_tokens for h in handles],
            [logps[h.rid] for h in handles])


def _prompts(seed, lengths, template=None):
    rs = np.random.RandomState(seed)
    out = []
    for i, n in enumerate(lengths):
        tail = rs.randint(0, 512, (n,)).tolist()
        out.append(template + tail if template and i % 2 == 0 else tail)
    return out


def _compare(pair, prompts, knobs, max_new, **engine_kw):
    jm, tm = pair
    kw = {**_ENGINE, **engine_kw}
    jeng = JaxServingEngine(jm, **kw)
    teng = ServingEngine(tm, device="cpu", **kw)
    jtoks, jlogp = _serve(jeng, prompts, knobs, max_new, JaxSamplingParams)
    reset_launches()
    ttoks, tlogp = _serve(teng, prompts, knobs, max_new, SamplingParams)
    assert sum(len(set(s)) > 2 for s in jtoks) >= len(jtoks) // 2
    assert ttoks == jtoks
    np.testing.assert_allclose(np.concatenate(tlogp),
                               np.concatenate(jlogp), rtol=1e-4, atol=1e-4)
    assert all(k.launches == 0 for k in kernels())    # plain versions
    return jeng, teng


_LENGTHS = (5, 13, 40, 22, 9, 31, 17, 11)


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_mixed_batch_streams_match_jax(models, prefix_cache):
    template = _prompts(99, [12])[0]
    prompts = _prompts(1, _LENGTHS, template=template)
    jeng, teng = _compare(models, prompts, _KNOBS, 12,
                          enable_prefix_cache=prefix_cache)
    if prefix_cache:
        assert teng.prefix_stats()["hits"] > 0
        assert teng.prefix_stats() == jeng.prefix_stats()


def test_sampled_streams_match_jax_under_preemption(models):
    """An 11-block pool for four prompts that each grow to 34 positions:
    decode growth preempts, and the replay must draw the same tokens."""
    prompts = _prompts(2, [10, 10, 10, 10])
    knobs = [_KNOBS[1], _KNOBS[4], _KNOBS[0], _KNOBS[3]]
    jeng, teng = _compare(models, prompts, knobs, 24, num_blocks=11)
    assert teng.sched.preemptions > 0
    assert teng.sched.preemptions == jeng.sched.preemptions


def test_tied_head_streams_match_jax():
    """Every logit tied with its twin's: the order statistic, the stable
    top-p order and the argmax's first-index rule all decide."""
    prompts = _prompts(4, _LENGTHS)
    _compare(_pair(tied_head=True), prompts, _KNOBS, 10)


# ---------------------------------------------------------------------------
# _select against the JAX engine's selection, on tie-heavy logits
# ---------------------------------------------------------------------------

def _jax_select(last, keys, counts, temp, top_k, top_p, greedy):
    """paddle_tpu/serving/engine.py's `select` (sampling=True), as
    written there."""
    V = last.shape[-1]
    lg = last.astype(jnp.float32) / temp[:, None]
    greedy_tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
    sorted_desc = jnp.sort(lg, axis=-1)[:, ::-1]
    k_eff = jnp.where(top_k > 0, jnp.clip(top_k, 1, V), V)
    kth = jnp.take_along_axis(sorted_desc, (k_eff - 1)[:, None], 1)
    lg_s = jnp.where(lg < kth, -1e30, lg)
    sort_idx = jnp.argsort(-lg_s, axis=-1)
    sorted_logits = jnp.take_along_axis(lg_s, sort_idx, axis=-1)
    probs = jax.nn.softmax(sorted_logits, axis=-1)
    cum = jnp.cumsum(probs, axis=-1)
    keep = (cum - probs) < top_p[:, None]
    masked = jnp.where(keep, sorted_logits, -1e30)
    inv = jnp.argsort(sort_idx, axis=-1)
    lg_s = jnp.take_along_axis(masked, inv, axis=-1)
    rngs = jax.vmap(jax.random.fold_in)(keys, counts)
    sampled = jax.vmap(jax.random.categorical)(rngs, lg_s).astype(jnp.int32)
    tok = jnp.where(greedy, greedy_tok, sampled)
    logp = jax.nn.log_softmax(last.astype(jnp.float32), axis=-1)
    return tok, jnp.take_along_axis(logp, tok[:, None], 1)[:, 0]


@pytest.mark.parametrize("vocab", [16, 512])
def test_select_matches_jax_on_tied_logits(vocab):
    rs = np.random.RandomState(vocab)
    rows = 8
    # integer logits from a handful of values: ties everywhere
    last = rs.randint(-3, 4, (rows, vocab)).astype(np.float32)
    temp = np.array([1.0, 0.5, 2.0, 1.0, 0.8, 1.0, 1.0, 1.3], np.float32)
    top_k = np.array([0, 1, 3, 5, 0, vocab + 7, 2, 0], np.int32)
    top_p = np.array([1.0, 1.0, 0.5, 0.9, 0.3, 1.0, 1e-6, 0.7], np.float32)
    greedy = np.array([0, 0, 0, 0, 0, 0, 0, 1], bool)
    base = np.stack([np.asarray(jax.random.PRNGKey(s)) for s in
                     range(rows)])
    for count in (0, 1, 5, 40):
        counts = np.full((rows,), count, np.int32)
        jt, jl = _jax_select(*(jnp.asarray(a) for a in (
            last, base, counts, temp, top_k, top_p, greedy)))
        tt, tl = _select(torch.from_numpy(last),
                         torch.from_numpy(base.astype(np.int64)),
                         torch.from_numpy(counts), torch.from_numpy(temp),
                         torch.from_numpy(top_k), torch.from_numpy(top_p),
                         torch.from_numpy(greedy))
        assert np.array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6,
                                   atol=1e-6)
    # top_k=1 keeps every logit tied at the max; a tiny top_p keeps the
    # first of them in the stable order, the argmax
    lg = last / temp[:, None]
    assert lg[1, tt.numpy()[1]] == lg[1].max()
    assert tt.numpy()[6] == np.argmax(lg[6])


def test_stable_descending_sort_orders_ties_as_jnp_argsort():
    x = np.random.RandomState(0).randint(-2, 3, (4, 64)).astype(np.float32)
    x[0, 10:20] = -1e30
    idx = torch.sort(torch.from_numpy(x), dim=-1, descending=True,
                     stable=True).indices.numpy()
    assert np.array_equal(idx, np.asarray(jnp.argsort(-jnp.asarray(x),
                                                      axis=-1)))


# ---------------------------------------------------------------------------
# batch independence, replay, run_generate
# ---------------------------------------------------------------------------

def test_sampled_stream_independent_of_batch(models):
    """The port of tests/test_serving.py's batch-composition case: a
    seeded stream is the same alone and sharing the batch, and the same
    as the JAX engine's."""
    jm, tm = models
    prompts = _prompts(0, [10, 6, 14])
    sp = dict(max_new_tokens=8, decode_strategy="sampling", top_k=20,
              top_p=0.9, temperature=0.8, seed=42)
    eng = ServingEngine(tm, device="cpu", **_ENGINE)
    h = eng.submit(prompts[1], SamplingParams(**sp))
    eng.run_until_idle(max_steps=2000)
    alone = h.output_tokens
    assert len(alone) == 8
    eng.submit(prompts[0], SamplingParams(max_new_tokens=6))
    eng.submit(prompts[2], SamplingParams(**{**sp, "seed": 7}))
    h2 = eng.submit(prompts[1], SamplingParams(**sp))
    eng.run_until_idle(max_steps=2000)
    assert h2.output_tokens == alone
    jeng = JaxServingEngine(jm, **_ENGINE)
    j = jeng.submit(prompts[1], JaxSamplingParams(**sp))
    jeng.run_until_idle(max_steps=2000)
    assert j.output_tokens == alone


@pytest.mark.parametrize("knobs", [_KNOBS[0], _KNOBS[4]],
                         ids=["greedy", "sampled"])
def test_replay_tokens_resume_the_stream(models, knobs):
    _, tm = models
    prompt = _prompts(5, [9])[0]
    eng = ServingEngine(tm, device="cpu", **_ENGINE)
    full = eng.submit(prompt, SamplingParams(max_new_tokens=12, **knobs))
    eng.run_until_idle(max_steps=2000)
    ref = full.output_tokens
    for cut in (1, 5, 11):
        h = eng.submit(prompt, SamplingParams(max_new_tokens=12, **knobs),
                       replay_tokens=ref[:cut])
        eng.run_until_idle(max_steps=2000)
        assert h.result(timeout=5) == ref[cut:]
        assert h.output_tokens == ref
    assert eng.pool.num_used == 0


def test_replay_tokens_refusals(models):
    _, tm = models
    eng = ServingEngine(tm, device="cpu", **_ENGINE)
    with pytest.raises(ValueError, match="nothing left to stream"):
        eng.submit([1, 2, 3], SamplingParams(max_new_tokens=3),
                   replay_tokens=[4, 5, 6])
    with pytest.raises(ValueError, match="eos_token_id"):
        eng.submit([1, 2, 3], SamplingParams(max_new_tokens=8,
                                             eos_token_id=5),
                   replay_tokens=[4, 5])
    assert not eng.sched.has_work()


_GEN_KNOBS = (dict(), dict(top_k=5), dict(top_p=0.8, temperature=0.7),
              dict(top_k=20, top_p=0.9))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 32 + 3])
@pytest.mark.parametrize("knobs", _GEN_KNOBS,
                         ids=["plain", "top_k", "top_p_temp", "both"])
def test_run_generate_sampling_matches_jax(models, knobs, seed):
    jm, tm = models
    ids = np.random.RandomState(0).randint(0, 512, (3, 9)).astype(np.int32)
    kw = dict(max_new_tokens=12, decode_strategy="sampling", seed=seed,
              dtype=None, **knobs)
    jo, js = jm.generate(paddle.to_tensor(ids), **kw)
    to, ts = tm.generate(torch.from_numpy(ids), device="cpu", **kw)
    assert np.array_equal(to.numpy(), np.asarray(jo.numpy()))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js.numpy()),
                               rtol=1e-4, atol=1e-4)
