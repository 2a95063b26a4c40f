"""The port's GPT (paddle_tpu_torch.models.gpt) against the JAX model on
the same weights, on the CPU in f32: a 2-layer, hidden-128, 4-head,
vocab-512 model with initializer_range=0.2, moved over by
`load_jax_params`."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.ops.pallas_layernorm import fused_add_layer_norm_pair

from paddle_tpu_torch import nn
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining

_MODEL = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
              max_seq_len=128, dropout=0.0, initializer_range=0.2)


@pytest.fixture(scope="module")
def models():
    paddle.seed(5)
    jm = JaxGPT(JaxGPTConfig(use_flash_attention=False, **_MODEL))
    arrays = [(n, np.asarray(p._value)) for n, p in jm.named_parameters()]
    tm = GPTForPretraining(GPTConfig(**_MODEL), device="cpu")
    load_jax_params(tm, arrays)
    return jm, tm, arrays


def test_parameter_names_and_shapes_match(models):
    jm, tm, arrays = models
    names = [n for n, _ in tm.named_parameters()]
    assert names == [n for n, _ in arrays]
    assert len(names) == 28
    for (n, a), (_, p) in zip(arrays, tm.named_parameters()):
        assert tuple(p.shape) == a.shape, n
    # Linear keeps W as [in, out], so no tensor was transposed
    assert tuple(tm.gpt.blocks[0].attn.qkv_proj.weight.shape) == (128, 384)


@pytest.mark.parametrize("seq", [1, 9, 40])
def test_dense_logits_match_jax(models, seq):
    jm, tm, _ = models
    ids = np.random.RandomState(seq).randint(0, 512, (2, seq)).astype(
        np.int32)
    ref = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    assert got.dtype == np.float32
    # 1e-5 relative to the logits' scale: XLA and PyTorch's CPU GEMM sum
    # in different orders, and with initializer_range=0.2 the residual
    # stream reaches ~35, so the f32 rounding noise (~1e-6 relative) is
    # absolute, not proportional to each logit — a logit near 0 carries
    # the same ~2e-5 noise as one near 10
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_fused_add_layer_norm_matches_jax(dtype):
    """The port's residual site follows the JAX package's add+LayerNorm
    kernel route (`use_pallas_layernorm`: f32 moments and math, one
    rounding of the output), so its reference is the JAX pair kernel,
    run in interpret mode over the flattened rows."""
    rs = np.random.RandomState(0)
    x, r = (rs.randn(3, 5, 128).astype(np.float32) for _ in range(2))
    w = (1 + 0.1 * rs.randn(128)).astype(np.float32)
    b = (0.1 * rs.randn(128)).astype(np.float32)
    jx, jr = jnp.asarray(x, dtype), jnp.asarray(r, dtype)
    ref_y, ref_h = fused_add_layer_norm_pair(
        jx.reshape(15, 128), jr.reshape(15, 128), jnp.asarray(w),
        jnp.asarray(b), 1e-5)
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    y, h = nn.fused_add_layer_norm(
        torch.from_numpy(x).to(tdt), torch.from_numpy(r).to(tdt),
        torch.from_numpy(w), torch.from_numpy(b), 1e-5)
    assert y.dtype == tdt and h.dtype == tdt
    tol = dict(rtol=1e-5, atol=1e-5) if tdt == torch.float32 \
        else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(
        y.float().numpy().reshape(15, 128),
        np.asarray(ref_y.astype(jnp.float32)), **tol)
    np.testing.assert_allclose(
        h.float().numpy().reshape(15, 128),
        np.asarray(ref_h.astype(jnp.float32)), **tol)


def test_load_jax_params_rejects_missing_extra_and_misshaped(models):
    _, tm, arrays = models
    fresh = GPTForPretraining(GPTConfig(**_MODEL), device="cpu", seed=1)
    before = fresh.gpt.wte.weight.clone()
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(fresh, arrays[1:])
    with pytest.raises(KeyError, match="unexpected"):
        load_jax_params(fresh, arrays + [("gpt.extra", np.zeros(3))])
    bad = dict(arrays)
    bad["gpt.blocks.1.mlp.fc1.weight"] = np.zeros((512, 128), np.float32)
    with pytest.raises(ValueError, match="fc1.weight"):
        load_jax_params(fresh, bad)
    # a rejected load copies nothing
    assert torch.equal(fresh.gpt.wte.weight, before)


def test_init_follows_the_jax_initialisers():
    cfg = GPTConfig(**{**_MODEL, "initializer_range": 0.02})
    m = GPTForPretraining(cfg, device="cpu", seed=3)
    blk = m.gpt.blocks[0]
    assert abs(m.gpt.wte.weight.std().item() - 0.02) < 2e-3
    assert abs(blk.mlp.fc2.weight.std().item() - 0.01) < 1e-3  # 0.02/sqrt(4)
    assert torch.all(blk.attn.qkv_proj.bias == 0)
    assert torch.all(blk.ln1.weight == 1) and torch.all(blk.ln1.bias == 0)
    same = GPTForPretraining(cfg, device="cpu", seed=3)
    assert torch.equal(same.gpt.wte.weight, m.gpt.wte.weight)


def test_presets_match_the_jax_presets():
    for name in ("gpt3_125m", "gpt3_350m", "gpt3_1_3b", "gpt3_13b"):
        j, t = getattr(JaxGPTConfig, name)(), getattr(GPTConfig, name)()
        for field in ("vocab_size", "hidden_size", "num_layers",
                      "num_heads", "ffn_hidden_size", "max_seq_len"):
            assert getattr(t, field) == getattr(j, field), (name, field)
