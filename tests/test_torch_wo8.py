"""Weight-only int8 in the port (paddle_tpu_torch.quant) against the JAX
package's (paddle_tpu.quant), on the same weights, on the CPU in f32.

The int8 codes and scales must be bit-identical; quantized models must
give the same logits (to 1e-5 of the logits' scale, the GPT parity
bound) for linears only and with the embeddings; the serving engine's
`weights="wo8"` streams must be token-identical to the JAX engine's; and
`load_jax_params` moves a quantized JAX state (int8 buffers included)
into a port model quantized the same way.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.quant import (channelwise_int8 as jax_channelwise,
                              quantize_weights_int8 as jax_quantize)
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import ServingEngine as JaxServingEngine

from paddle_tpu_torch import nn
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
from paddle_tpu_torch.quant import (WeightOnlyInt8Embedding,
                                    WeightOnlyInt8Linear, channelwise_int8,
                                    quantize_for_decode,
                                    quantize_weights_int8)
from paddle_tpu_torch.serving import SamplingParams, ServingEngine

_MODEL = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
              max_seq_len=128, dropout=0.0, initializer_range=0.2)


def _pair(seed):
    """A fresh JAX GPT and a port GPT holding the same weights."""
    paddle.seed(seed)
    jm = JaxGPT(JaxGPTConfig(use_flash_attention=False, **_MODEL))
    tm = GPTForPretraining(GPTConfig(**_MODEL), device="cpu")
    load_jax_params(tm, _arrays(jm))
    return jm, tm


def _arrays(jm):
    return [(n, np.asarray(t._value)) for n, t in
            [*jm.named_parameters(), *jm.named_buffers()]]


def _ids(seed, b=2, s=16):
    return np.random.RandomState(seed).randint(0, 512, (b, s)).astype(
        np.int32)


def _assert_logits_close(got, ref):
    # the GPT parity bound: 1e-5 of the logits' scale (tests/test_torch_gpt)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_channelwise_int8_is_bit_identical():
    """Random weights, a zero column (the 1e-8 scale floor) and exact
    half-steps (round half to even)."""
    rs = np.random.RandomState(0)
    w = rs.randn(64, 48).astype(np.float32)
    w[:, 3] = 0.0
    w[:5, 7] = [127.0, 0.5, 1.5, 2.5, -0.5]
    w[5:, 7] = 0.0
    ref_q, ref_s = jax_channelwise(w)
    got_q, got_s = channelwise_int8(torch.from_numpy(w))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), ref_q)
    np.testing.assert_array_equal(got_s.numpy().view(np.int32),
                                  ref_s.view(np.int32))
    assert list(got_q.numpy()[:5, 7]) == [127, 0, 2, 2, 0]


@pytest.mark.parametrize("embeddings", [False, True])
def test_quantized_buffers_and_names_match_jax(embeddings):
    jm, tm = _pair(1)
    n_j = jax_quantize(jm, embeddings=embeddings)
    n_t = quantize_weights_int8(tm, embeddings=embeddings)
    assert n_t == n_j == (10 if embeddings else 8)
    ref = dict(_arrays(jm))
    got = {n: t.detach().numpy() for n, t in tm.state_dict().items()}
    assert sorted(got) == sorted(ref)
    for name, a in ref.items():
        assert got[name].dtype == a.dtype, name
        np.testing.assert_array_equal(got[name], a, err_msg=name)
    if embeddings:
        wte = tm.gpt.wte
        assert isinstance(wte, WeightOnlyInt8Embedding)
        assert wte.num_embeddings == 512 and wte.wq.shape == (1024, 128)
        assert torch.all(wte.w_scale[512:] == 0)      # zero-scale pad rows


@pytest.mark.parametrize("embeddings", [False, True])
def test_quantized_logits_match_jax(embeddings):
    jm, tm = _pair(2)
    jax_quantize(jm, embeddings=embeddings)
    quantize_weights_int8(tm, embeddings=embeddings)
    ids = _ids(3)
    ref = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    assert got.shape == ref.shape == (2, 16, 512)     # sliced to true V
    _assert_logits_close(got, ref)


def test_quantized_embedding_clips_ids_to_the_true_vocab():
    emb = nn.Embedding(10, 8, device="cpu")
    with torch.no_grad():
        emb.weight.normal_()
    q = WeightOnlyInt8Embedding(emb)
    assert q.wq.shape == (1024, 8)
    rows = q(torch.tensor([9, 10, 5000]))
    assert torch.equal(rows[1], rows[0]) and torch.equal(rows[2], rows[0])


def test_wo8_linear_close_to_f32():
    lin = nn.Linear(64, 48, device="cpu")
    with torch.no_grad():
        lin.weight.normal_()
        lin.bias.normal_()
    q = WeightOnlyInt8Linear(lin)
    assert q.bias is lin.bias and q.wq.dtype == torch.int8
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 64).astype(
        np.float32))
    ref = lin(x)
    rel = ((q(x) - ref).abs().max() / ref.abs().max()).item()
    assert rel < 0.02, rel      # per-channel int8: ~0.4 % of the scale


def test_quantize_for_decode_is_idempotent_and_loud():
    _, tm = _pair(4)
    assert quantize_for_decode(tm) == 8
    wq = tm.gpt.blocks[0].attn.qkv_proj.wq.clone()
    assert quantize_for_decode(tm) == 0     # never quantizes the scales
    assert torch.equal(tm.gpt.blocks[0].attn.qkv_proj.wq, wq)
    assert not isinstance(tm.gpt.wte, WeightOnlyInt8Embedding)
    with pytest.raises(ValueError, match="no quantizable"):
        quantize_for_decode(torch.nn.Sequential(nn.LayerNorm(8)))


def test_load_jax_params_moves_quantized_buffers():
    """A JAX model quantized with embeddings=True loads into a port model
    quantized the same way from OTHER weights: equal logits."""
    jm, _ = _pair(5)
    jax_quantize(jm, embeddings=True)
    tm = GPTForPretraining(GPTConfig(**_MODEL), device="cpu", seed=9)
    quantize_weights_int8(tm, embeddings=True)
    load_jax_params(tm, _arrays(jm))
    assert tm.gpt.wte.wq.dtype == torch.int8
    ids = _ids(6)
    ref = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    _assert_logits_close(got, ref)
    bad = dict(_arrays(jm))
    name = "gpt.blocks.0.mlp.fc1.wq"
    bad[name] = bad[name].astype(np.float32)
    with pytest.raises(TypeError, match="fc1.wq"):
        load_jax_params(tm, bad)


@pytest.mark.parametrize("embeddings", [False, True])
def test_engine_wo8_streams_match_jax(embeddings):
    """`weights="wo8"` quantizes the linears of the caller's model in
    both engines (a model pre-quantized with the embeddings keeps them):
    greedy streams token-identical in f32."""
    jm, tm = _pair(7)
    if embeddings:
        jax_quantize(jm, embeddings=True)
        quantize_weights_int8(tm, embeddings=True)
    kw = dict(max_slots=4, block_size=8, prefill_chunk=8, max_model_len=64,
              dtype=None, weights="wo8")
    jeng = JaxServingEngine(jm, **kw)
    teng = ServingEngine(tm, device="cpu", **kw)
    assert isinstance(tm.gpt.blocks[1].mlp.fc2, WeightOnlyInt8Linear)
    rs = np.random.RandomState(8)
    prompts = [rs.randint(0, 512, (n,)).tolist() for n in (5, 13, 22, 9)]
    streams = []
    for eng, params in ((jeng, JaxSamplingParams), (teng, SamplingParams)):
        handles = [eng.submit(p, params(max_new_tokens=8)) for p in prompts]
        eng.run_until_idle(max_steps=1000)
        streams.append([h.output_tokens for h in handles])
    assert any(len(set(s)) > 2 for s in streams[0])
    assert streams[1] == streams[0]
