"""The port's flash attention (paddle_tpu_torch.ops.flash_attention)
against the JAX package's Pallas kernels, on the same numpy inputs.

On the CPU the port's `FlashAttention` runs the plain forward and the
plain recompute-from-lse backward; they must match the JAX
`flash_attention_fwd` (Pallas in interpret mode off the TPU) and its
`jax.vjp` at the JAX registry's tolerance in f32 (2e-3) and at 2e-2 in
bf16, over the three kernel families the training path reaches: the
rectangular grid at s = 256 with the default blocks (K2 forward, K4
merged backward), the triangle grid with forced 128 blocks (K1, K3),
cross lengths sq 128, sk 256 (causal with offset 128, and non-causal),
and ragged cross lengths sq 300, sk 700 (causal with offset 400).
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddle_tpu.ops import pallas_attention as jax_pa

from paddle_tpu_torch.ops import attention as port_attention
from paddle_tpu_torch.ops.flash_attention import (FlashAttention,
                                                  flash_attention_fwd,
                                                  flash_delta_plain,
                                                  flash_fwd)
from paddle_tpu_torch.ops.kernel_registry import get_kernel, reset_launches

_TOL = {"float32": dict(rtol=2e-3, atol=2e-3),
        "bfloat16": dict(rtol=2e-2, atol=2e-2)}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# (name, b, sq, sk, n, h, causal, blocks)
_CASES = [
    ("rect_s256", 1, 256, 256, 2, 64, True, (None, None)),
    ("tri_forced_128", 1, 256, 256, 2, 64, True, (128, 128)),
    ("cross_offset_128", 1, 128, 256, 2, 64, True, (None, None)),
    ("cross_noncausal", 1, 128, 256, 2, 64, False, (None, None)),
    ("rect_h128", 1, 128, 128, 2, 128, True, (None, None)),
    ("cross_ragged_300_700", 1, 300, 700, 2, 64, True, (None, None)),
]


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    reset_launches()
    yield
    assert get_kernel("flash_fwd").launches == 0
    assert get_kernel("flash_bwd").launches == 0


def _inputs(seed, b, sq, sk, n, h):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, sq, n, h).astype(np.float32)
    k = rs.randn(b, sk, n, h).astype(np.float32)
    v = rs.randn(b, sk, n, h).astype(np.float32)
    g = rs.randn(b, sq, n, h).astype(np.float32)
    return q, k, v, g


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_forward_and_backward_match_jax_kernels(case, dtype):
    _, b, sq, sk, n, h, causal, (bq, bk) = case
    q, k, v, g = _inputs(sq + sk + h, b, sq, sk, n, h)
    jdt, tdt = _JDT[dtype], _TDT[dtype]
    jq, jk, jv, jg = (jnp.asarray(a, jdt) for a in (q, k, v, g))
    scale = 1.0 / math.sqrt(h)

    def f(q_, k_, v_):
        return jax_pa.flash_attention_fwd(q_, k_, v_, causal, scale, bq, bk)

    ref, vjp = jax.vjp(f, jq, jk, jv)
    rdq, rdk, rdv = vjp(jg)

    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_()
                  for a in (q, k, v))
    out = FlashAttention.apply(tq, tk, tv, causal, scale)
    out.backward(torch.from_numpy(g).to(tdt))
    assert out.dtype == tdt and tq.grad.dtype == tdt
    tol = _TOL[dtype]
    for got, want in ((out, ref), (tq.grad, rdq), (tk.grad, rdk),
                      (tv.grad, rdv)):
        np.testing.assert_allclose(got.detach().float().numpy(), _f32(want),
                                   **tol)


@pytest.mark.parametrize("causal", [True, False])
def test_lse_matches_the_rectangular_kernel(causal):
    """The saved log-sum-exp, [b*n, sq] f32, against row 0 of the JAX
    kernel's [BN, 8, S] sublane-replicated lse."""
    b, sq, sk, n, h = 2, 128, 256, 2, 64
    q, k, v, _ = _inputs(7, b, sq, sk, n, h)
    scale = 1.0 / math.sqrt(h)
    _, jlse = jax_pa._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal, scale, 128, 128)
    out, lse = flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), causal, scale)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (b * n, sq)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, 0, :],
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_delta_matches_jax(dtype):
    """delta = rowsum(dO * O), f32 [b*n, sq], against the JAX backward's
    own formula over its flat forward output (pallas_attention.py:867)."""
    b, sq, sk, n, h = 2, 200, 200, 3, 64
    q, k, v, g = _inputs(13, b, sq, sk, n, h)
    jdt, tdt = _JDT[dtype], _TDT[dtype]
    jq, jk, jv, jg = (jnp.asarray(a, jdt) for a in (q, k, v, g))
    out, _ = jax_pa._flash_fwd(jq, jk, jv, True, 1.0 / math.sqrt(h), 200,
                               200)
    gr = jg.transpose(0, 2, 1, 3).reshape(b * n, sq, h)
    want = jnp.sum(gr.astype(jnp.float32) * out.astype(jnp.float32),
                   axis=-1)
    tout = torch.from_numpy(np.array(_f32(out))).to(tdt).reshape(b, n, sq, h) \
        .transpose(1, 2)
    got = flash_delta_plain(tout, torch.from_numpy(g).to(tdt))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b * n, sq)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_strided_unbind_views_and_noncontiguous_dout():
    """q/k/v as the `unbind` views of a fused qkv projection and a
    transposed dout give what contiguous copies give."""
    b, s, n, h = 2, 64, 2, 64
    rs = np.random.RandomState(3)
    qkv = torch.from_numpy(rs.randn(b, s, 3, n, h).astype(np.float32))
    q, k, v = (t.requires_grad_() for t in
               (x.clone() for x in qkv.unbind(dim=2)))
    views = [x.detach().requires_grad_() for x in (qkv.clone(),)]
    vq, vk, vv = views[0].unbind(dim=2)
    assert not vq.is_contiguous()
    dout = torch.from_numpy(rs.randn(b, n, s, h).astype(np.float32)) \
        .transpose(1, 2)
    assert not dout.is_contiguous()
    out_c = flash_attention_fwd(q, k, v, causal=True)
    out_c.backward(dout.contiguous())
    out_v = flash_attention_fwd(vq, vk, vv, causal=True)
    out_v.backward(dout)
    torch.testing.assert_close(out_v, out_c)
    grads = views[0].grad.unbind(dim=2)
    for got, want in zip(grads, (q.grad, k.grad, v.grad)):
        torch.testing.assert_close(got, want)


def test_every_row_sees_key_zero_so_outputs_are_finite():
    """Causal with a long offset and a query tile past the diagonal: no
    row is fully masked, every output and gradient is finite."""
    b, sq, sk, n, h = 1, 3, 70, 1, 64
    q, k, v, g = (torch.from_numpy(a).requires_grad_() if i < 3 else
                  torch.from_numpy(a) for i, a in
                  enumerate(_inputs(11, b, sq, sk, n, h)))
    out = flash_attention_fwd(q, k, v, causal=True)
    out.backward(g)
    for t in (out, q.grad, k.grad, v.grad):
        assert bool(torch.isfinite(t).all())
    # the last query sees every key, so no dk row is zero
    assert bool((k.grad.abs().sum(dim=-1) > 0).all())


def test_dispatch_takes_the_kernels_without_dropout(monkeypatch):
    calls = []

    def spy(q, k, v, causal=False, scale=None):
        calls.append(causal)
        return q

    monkeypatch.setattr(port_attention, "flash_attention_fwd", spy)
    q = torch.zeros(1, 8, 2, 64)
    port_attention.flash_attention(q, q, q, dropout=0.0, causal=True)
    port_attention.scaled_dot_product_attention(q, q, q, is_causal=False)
    assert calls == [True, False]
    # dropout in training, or an explicit mask: the composed path
    port_attention.flash_attention(q, q, q, dropout=0.1, causal=True)
    port_attention.scaled_dot_product_attention(
        q, q, q, attn_mask=torch.ones(8, 8, dtype=torch.bool))
    assert calls == [True, False]


def test_composed_path_matches_the_kernels_without_dropout():
    b, s, n, h = 1, 32, 2, 64
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(5, b, s, s, n, h))
    mask = torch.ones((s, s), dtype=torch.bool).tril()
    want = port_attention.flash_attention(q, k, v, causal=True)
    got = port_attention.scaled_dot_product_attention(q, k, v,
                                                      attn_mask=mask)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # in eval, dropout is not applied
    got = port_attention.flash_attention(q, k, v, dropout=0.5, causal=True,
                                         training=False)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
