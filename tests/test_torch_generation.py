"""The port's `run_generate` (paddle_tpu_torch.generation) against the
JAX package's, on the same weights, on the CPU in f32.

Greedy and beam search (3 beams, length penalty 0 and 0.6) must give
token-identical ids, with scores within 1e-4, for the native weights,
weight-only int8 linears and int8 linears + embeddings; an EOS stop must
pad the same way. On the CPU both packages take the composed head and
the port's one-token steps run `decode_fused`'s plain version, which is
the JAX composed f32 attention. Sampling is also held to its own rules:
seeded determinism and every token inside the top-k set or the top-p
nucleus of its logits; `_apply_top_k`/`_apply_top_p` equal the JAX
functions on the same logits. Seeded sampling is token-identical to the
JAX package's (tests/test_torch_serving_sampling.py).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.generation import _apply_top_k as jax_top_k
from paddle_tpu.generation import _apply_top_p as jax_top_p
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.quant import quantize_weights_int8 as jax_quantize

from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.generation import _apply_top_k, _apply_top_p
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
from paddle_tpu_torch.ops.kernel_registry import kernels, reset_launches
from paddle_tpu_torch.quant import quantize_weights_int8

_MODEL = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
              max_seq_len=128, dropout=0.0, initializer_range=0.2)
_RECIPES = {"native": None, "wo8": False, "wo8_embeddings": True}


def _arrays(jm):
    return [(n, np.asarray(t._value)) for n, t in
            [*jm.named_parameters(), *jm.named_buffers()]]


@pytest.fixture(scope="module")
def pairs():
    """(JAX model, port model) with the same weights, per recipe."""
    out = {}
    for recipe, embeddings in _RECIPES.items():
        paddle.seed(3)
        jm = JaxGPT(JaxGPTConfig(use_flash_attention=False, **_MODEL))
        tm = GPTForPretraining(GPTConfig(**_MODEL), device="cpu")
        load_jax_params(tm, _arrays(jm))
        if embeddings is not None:
            jax_quantize(jm, embeddings=embeddings)
            quantize_weights_int8(tm, embeddings=embeddings)
        out[recipe] = (jm, tm)
    return out


def _ids(seed, b=2, s=9):
    return np.random.RandomState(seed).randint(0, 512, (b, s)).astype(
        np.int32)


def _generate_both(pair, ids, **kw):
    jm, tm = pair
    jo, js = jm.generate(paddle.to_tensor(ids), dtype=None, **kw)
    reset_launches()
    to, ts = tm.generate(torch.from_numpy(ids), dtype=None, device="cpu",
                         **kw)
    assert all(k.launches == 0 for k in kernels())    # plain versions
    return (np.asarray(jo.numpy()), np.asarray(js.numpy()), to.numpy(),
            ts.numpy())


_STRATEGIES = {
    "greedy": dict(),
    "beam": dict(decode_strategy="beam_search", num_beams=3),
    "beam_lp": dict(decode_strategy="beam_search", num_beams=3,
                    length_penalty=0.6),
}


@pytest.mark.parametrize("strategy", sorted(_STRATEGIES))
@pytest.mark.parametrize("recipe", sorted(_RECIPES))
def test_generate_matches_jax(pairs, recipe, strategy):
    jids, jsc, tids, tsc = _generate_both(pairs[recipe], _ids(0),
                                          max_new_tokens=12,
                                          **_STRATEGIES[strategy])
    assert tids.shape == (2, 21)
    # identity means something only if the streams are not one token
    assert len(set(jids[:, 9:].ravel().tolist())) > 4
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(tsc, jsc, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("strategy", ["greedy", "beam"])
def test_eos_stop_and_padding_match_jax(pairs, strategy):
    """EOS = the third token row 0 generates without one: that row stops
    there and pads the rest with pad_token_id, in both packages."""
    pair = pairs["native"]
    ids = _ids(1)
    kw = dict(max_new_tokens=10, **_STRATEGIES[strategy])
    _, _, free, _ = _generate_both(pair, ids, **kw)
    eos = int(free[0, 9 + 2])
    jids, jsc, tids, tsc = _generate_both(pair, ids, eos_token_id=eos,
                                          pad_token_id=7, **kw)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(tsc, jsc, rtol=1e-4, atol=1e-4)
    stop = list(tids[0, 9:]).index(eos)
    assert stop <= 2 and (tids[0, 9 + stop + 1:] == 7).all()


def _teacher_logits(tm, ids):
    with torch.no_grad():
        return tm(ids)[:, 8:-1].float()     # logits that chose each token


def test_sampling_is_seeded_and_inside_top_k(pairs):
    _, tm = pairs["native"]
    ids = torch.from_numpy(_ids(2))
    kw = dict(max_new_tokens=10, decode_strategy="sampling", top_k=5,
              dtype=None, device="cpu")
    a, _ = tm.generate(ids, seed=11, **kw)
    b, _ = tm.generate(ids, seed=11, **kw)
    c, _ = tm.generate(ids, seed=12, **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    logits = _teacher_logits(tm, a)
    kth = torch.topk(logits, 5, dim=-1).values[..., -1:]
    chosen = logits.gather(-1, a[:, 9:, None])
    assert torch.all(chosen >= kth - 1e-5)


def test_sampling_inside_top_p_nucleus(pairs):
    _, tm = pairs["native"]
    ids = torch.from_numpy(_ids(3))
    out, _ = tm.generate(ids, max_new_tokens=10, decode_strategy="sampling",
                         top_p=0.5, temperature=0.7, seed=5, dtype=None,
                         device="cpu")
    logits = _teacher_logits(tm, out) / 0.7
    probs = torch.softmax(logits, dim=-1)
    p_tok = probs.gather(-1, out[:, 9:, None])
    # the nucleus holds every token more probable than the one whose
    # cumulative mass first reaches p; the chosen token's own
    # exclusive-cumulative mass (of strictly more probable tokens) < p
    ahead = (probs * (probs > p_tok)).sum(-1, keepdim=True)
    assert torch.all(ahead < 0.5 + 1e-5)


def test_top_k_top_p_equal_jax():
    rs = np.random.RandomState(4)
    logits = rs.randn(3, 50).astype(np.float32)
    logits[0, 10:20] = logits[0, 5]         # ties
    t = torch.from_numpy(logits)
    for k in (1, 4, 17):
        np.testing.assert_array_equal(
            _apply_top_k(t, k).numpy(),
            np.asarray(jax_top_k(jnp.asarray(logits), k)))
    for p in (0.1, 0.5, 0.9):
        np.testing.assert_allclose(
            _apply_top_p(t, p).numpy(),
            np.asarray(jax_top_p(jnp.asarray(logits), p)), rtol=1e-6)


def test_decode_weights_are_cast_per_call_not_cached():
    """The bf16 cast is made anew from the current weights on every call
    and undone after it: quantizing in place or changing a weight after
    a call shows in the next call, and the model keeps its f32 weights
    (the JAX test_generate_cache_invalidates_on_param_tree_change)."""
    cfg = GPTConfig(**_MODEL)
    ids = torch.from_numpy(_ids(5))
    m = GPTForPretraining(cfg, device="cpu", seed=4)
    fresh = GPTForPretraining(cfg, device="cpu", seed=4)
    kw = dict(max_new_tokens=6, device="cpu")     # dtype bfloat16
    m.generate(ids, **kw)
    assert all(p.dtype == torch.float32 for p in m.parameters())
    quantize_weights_int8(m)
    quantize_weights_int8(fresh)
    after, _ = m.generate(ids, **kw)
    assert torch.equal(after, fresh.generate(ids, **kw)[0])
    assert m.gpt.blocks[0].attn.qkv_proj.w_scale.dtype == torch.float32
    with torch.no_grad():
        for blk in m.gpt.blocks:
            blk.mlp.fc1.wq.zero_()
    assert not torch.equal(m.generate(ids, **kw)[0], after)


def test_generate_refuses_a_model_elsewhere_and_bad_args(pairs):
    _, tm = pairs["native"]
    ids = torch.from_numpy(_ids(6))
    with pytest.raises(ValueError, match="lives on cpu"):
        tm.generate(ids, device="cuda")
    with pytest.raises(ValueError, match="num_beams"):
        tm.generate(ids, decode_strategy="beam_search", device="cpu")
    with pytest.raises(ValueError, match="decode_strategy"):
        tm.generate(ids, decode_strategy="nucleus", device="cpu")
