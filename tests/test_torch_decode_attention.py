"""The port's decode attention (paddle_tpu_torch.ops.decode_attention,
registry "decode_fused") against the JAX package's, on the same numpy
inputs.

On the CPU the wrapper runs its plain version, which copies the JAX
`_decode_fallback` (dense masked attention in f32): it must match the
fallback at 1e-5 in f32 and the JAX Pallas kernel (interpret mode off
the TPU) at the JAX registry's declared tolerance, on the registry's
example generator and at GPT-3 125M head geometry with off at 0, mid and
L - 1; in bf16 within 2e-2. The plain mirror of the card kernel's split
over the keys (`decode_attention_split_plain`) matches both at the
chunk edges, and `decode_split` gives every chunk a key. The GPT's
`_cached_attention` over the flat cache (the kernel's layout) matches
dense masked attention, and `init_cache` refuses, off the CPU, a head
dim the kernel lacks.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.ops import pallas_decode as jax_pd
from paddle_tpu.ops.kernel_registry import get_kernel as jax_kernel

from paddle_tpu_torch.models.gpt import _cached_attention
from paddle_tpu_torch.ops.decode_attention import (
    DECODE_ONE_CHUNK, DECODE_SPLIT_KEYS, decode_attention,
    decode_attention_split_plain, decode_attention_supported, decode_split)
from paddle_tpu_torch.ops.kernel_registry import get_kernel, reset_launches

_EXACT = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    reset_launches()
    yield
    assert get_kernel("decode_fused").launches == 0


def _both(q, k, v, off, n_heads):
    """(JAX fallback, JAX kernel in interpret mode, port) as numpy."""
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    fb = jax_pd._decode_fallback(jq, jk, jv, np.int32(off), n_heads)
    kern = jax_pd.decode_attention(jq, jk, jv, np.int32(off), n_heads)
    got = decode_attention(_t(q), _t(k), _t(v), int(off), n_heads)
    assert got.dtype == torch.float32
    return (np.asarray(fb, np.float32), np.asarray(kern, np.float32),
            got.numpy())


@pytest.mark.parametrize("seed", range(4))
def test_registry_examples_match_jax(seed):
    """The JAX registry's `example(rng)` inputs (head_dim 32) through
    both packages."""
    jk = jax_kernel("decode_fused")
    args, _ = jk.example(np.random.default_rng(seed))
    fb, kern, got = _both(*args)
    np.testing.assert_allclose(got, fb, **_EXACT)
    rtol, atol = jk.tol
    np.testing.assert_allclose(got, kern, rtol=rtol, atol=atol)


_N, _H, _L = 12, 64, 32     # GPT-3 125M heads over a short cache


@pytest.mark.parametrize("off", [0, 13, _L - 1])
def test_125m_head_geometry_f32(off):
    rng = np.random.default_rng(off)
    q = rng.standard_normal((2, 1, _N * _H)).astype(np.float32)
    k = rng.standard_normal((2, _L, _N * _H)).astype(np.float32)
    v = rng.standard_normal((2, _L, _N * _H)).astype(np.float32)
    fb, kern, got = _both(q, k, v, off, _N)
    np.testing.assert_allclose(got, fb, **_EXACT)
    np.testing.assert_allclose(got, kern, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("off", [0, 13, _L - 1])
def test_bf16_inputs(off):
    """bf16 q and cache: both packages widen to f32 inside, so the f32
    outputs agree to the port's bf16 rule, 2e-2."""
    rng = np.random.default_rng(10 + off)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 1, 512), (2, _L, 512), (2, _L, 512)))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = jax_pd.decode_attention(jq, jk, jv, np.int32(off), 4)
    got = decode_attention(*(_t(a).to(torch.bfloat16) for a in (q, k, v)),
                           off, 4)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_head_dim_128():
    rng = np.random.default_rng(7)
    q = rng.standard_normal((1, 1, 4 * 128)).astype(np.float32)
    k = rng.standard_normal((1, 24, 4 * 128)).astype(np.float32)
    v = rng.standard_normal((1, 24, 4 * 128)).astype(np.float32)
    fb, kern, got = _both(q, k, v, 17, 4)
    np.testing.assert_allclose(got, fb, **_EXACT)
    np.testing.assert_allclose(got, kern, rtol=1e-3, atol=1e-3)


_SL = 64                    # cache length of the split cases


@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("off", [0, 15, 16, 17, 31, 32, 33, _SL - 1])
def test_key_split_matches_jax(off, head_dim):
    """The plain mirror of the kernel's split over the keys, at chunks of
    1, 8, 16 and 32 keys and at the kernel's own `decode_split`, against
    the JAX fallback (1e-5) and the Pallas kernel in interpret mode (the
    registry's 1e-3): off at 0, at a chunk's last key (15, 31), one past
    it (16, 32, 33) and at L - 1."""
    n = 256 // head_dim
    rng = np.random.default_rng(100 + off + head_dim)
    q = rng.standard_normal((2, 1, n * head_dim)).astype(np.float32)
    k, v = (rng.standard_normal((2, _SL, n * head_dim)).astype(np.float32)
            for _ in range(2))
    fb, kern, _ = _both(q, k, v, off, n)
    for chunk in sorted({1, 8, 16, 32, decode_split(off)[1]}):
        got = decode_attention_split_plain(_t(q), _t(k), _t(v), off, n,
                                           chunk)
        assert got.dtype == torch.float32 and got.shape == q.shape
        np.testing.assert_allclose(got.numpy(), fb, **_EXACT)
        np.testing.assert_allclose(got.numpy(), kern, rtol=1e-3, atol=1e-3)


def test_split_gives_every_chunk_a_key():
    """One chunk up to DECODE_ONE_CHUNK keys, else a power of two up to 8
    chunks of at most DECODE_SPLIT_KEYS keys; every chunk holds a key.
    GPT-3 125M at batch 8 and off >= 128 gets 8 chunks: with 3 groups
    of 4 heads, 192 CTAs for the card's 132 SMs."""
    for last in range(4096):
        chunks, chunk = decode_split(last)
        assert (chunks - 1) * chunk <= last < chunks * chunk
        assert chunks in (1, 2, 4, 8)
        if last < DECODE_ONE_CHUNK:
            assert chunks == 1
        elif chunks < 8:
            assert chunk <= DECODE_SPLIT_KEYS
    assert all(decode_split(last)[0] == 8 for last in range(128, 256))


def test_supported_is_the_card_kernels_head_dims():
    assert decode_attention_supported(768, 12)       # 125M: head 64
    assert decode_attention_supported(2048, 16)      # 1.3B: head 128
    assert not decode_attention_supported(128, 4)    # head 32
    assert not decode_attention_supported(100, 3)


def test_unsupported_device_is_refused():
    q = torch.empty((1, 1, 128), device="meta")
    k = torch.empty((1, 8, 128), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attention(q, k, k, 3, 2)


@pytest.mark.parametrize("s,off", [(5, 0), (1, 5), (3, 6)])
def test_cached_attention_matches_dense_reference(s, off):
    """`_cached_attention` writes the new keys at off..off+s-1 of the flat
    cache in place and attends each query (position off+i) over keys
    0..off+i: a prompt through the composed path, one token through
    decode_fused. Held against masked softmax attention in numpy."""
    rng = np.random.default_rng(s + off)
    b, n, h, L = 2, 4, 32, 16
    q, kn, vn = (rng.standard_normal((b, s, n, h)).astype(np.float32)
                 for _ in range(3))
    old_k, old_v = (rng.standard_normal((b, L, n, h)).astype(np.float32)
                    for _ in range(2))
    flat_k = _t(old_k).reshape(b, L, n * h)
    flat_v = _t(old_v).reshape(b, L, n * h)
    out, fk, fv = _cached_attention(_t(q), _t(kn), _t(vn), flat_k, flat_v,
                                    off)
    assert fk is flat_k and fv is flat_v        # updated in place
    k, v = old_k.copy(), old_v.copy()
    k[:, off:off + s], v[:, off:off + s] = kn, vn
    np.testing.assert_array_equal(fk.reshape(b, L, n, h).numpy(), k)
    np.testing.assert_array_equal(fv.reshape(b, L, n, h).numpy(), v)
    logits = np.einsum("bqnh,bknh->bnqk", q, k) / np.sqrt(h)
    valid = np.arange(L)[None, :] <= (off + np.arange(s))[:, None]
    logits = np.where(valid[None, None], logits, -np.inf)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    ref = np.einsum("bnqk,bknh->bqnh", p, v)
    np.testing.assert_allclose(out.numpy(), ref, **_EXACT)


@pytest.mark.parametrize("hidden,heads,ok", [(768, 12, True),
                                             (128, 4, False)])
def test_init_cache_off_cpu_needs_the_kernel(hidden, heads, ok):
    """Off the CPU the cache is flat for the kernel's head dims and
    refused for others, so no decode step on the card avoids the kernel
    (checked on the meta device, which stands for any non-CPU device)."""
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTModel
    cfg = GPTConfig(vocab_size=64, hidden_size=hidden, num_layers=1,
                    num_heads=heads, max_seq_len=16)
    model = GPTModel(cfg, device="meta")
    if ok:
        (k, v), = model.init_cache(2, 16)
        assert k.shape == v.shape == (2, 16, hidden)
    else:
        with pytest.raises(ValueError, match="no decode_fused kernel"):
            model.init_cache(2, 16)
