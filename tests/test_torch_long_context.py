"""The long-context attention points of the JAX bench, on the CPU: the
port's `ops.attention.scaled_dot_product_attention(x, x, x,
is_causal=True)` and the gradient of sum(o^2) with respect to x (q = k =
v, so autograd sums the three gradients) against the JAX package's, and
the f32 evaluators that `chip_smoke.py`'s long_context phase holds the
card against.

- The bench's CPU points in f32 (bench.py:774-927): attn_16k's S 512,
  B 1, 2 heads of 128 and of 64, x = N(0, 1) from RandomState(0); and
  ringattn_128k's S 2048, 2 heads of 64, x = 0.3 N(0, 1). Out and
  gradient within the flash tolerance, 2e-3 relative + absolute (both
  are f32 attention on the CPU: the port's flash wrappers run their
  plain versions, the JAX package its composed attention).
- `chip_smoke.attention_ref_fwd` (query chunks that do not divide S)
  and `attention_ref_grad_rows` (every row in chunks, and sampled rows)
  against the plain flash forward and backward with dO = 2 o: 1e-5
  relative + 1e-6 absolute (the same f32 math summed in another order);
  `hold_rows` passes a row error at its bound and fails one above it.
- `chip_smoke.plain_by_batch`, the plain flash forward and backward a
  few batch rows a call (the 1.3B phase's reference at 8 x 4096),
  equal to one call over the whole batch.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddle_tpu.ops.attention import \
    scaled_dot_product_attention as jax_sdpa

import chip_smoke
from paddle_tpu_torch.ops.attention import scaled_dot_product_attention
from paddle_tpu_torch.ops.flash_attention import (flash_attention_bwd_plain,
                                                  flash_attention_fwd_plain)

_POINTS = [(512, 2, 128, 1.0), (512, 2, 64, 1.0), (2048, 2, 64, 0.3)]


@pytest.mark.parametrize("S,n,h,amp", _POINTS,
                         ids=["attn_16k-d128", "attn_16k-d64",
                              "ringattn_128k"])
def test_bench_points_match_jax(S, n, h, amp):
    x0 = (np.random.RandomState(0).randn(1, S, n, h) * amp).astype(
        np.float32)

    def f(x):
        o = jax_sdpa(x, x, x, is_causal=True)._value
        return jnp.sum(o.astype(jnp.float32) ** 2)

    jx = jnp.asarray(x0)
    jo = np.asarray(jax_sdpa(jx, jx, jx, is_causal=True)._value)
    jg = np.asarray(jax.grad(f)(jx))
    x = torch.from_numpy(x0.copy()).requires_grad_()
    o = scaled_dot_product_attention(x, x, x, is_causal=True)
    (o.float() ** 2).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), jo, rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(x.grad.numpy(), jg, rtol=2e-3, atol=2e-3)
    assert np.abs(jg).max() > 0.1        # a gradient worth comparing


def _plain(x, scale):
    out, lse = flash_attention_fwd_plain(x, x, x, True, scale)
    dq, dk, dv = flash_attention_bwd_plain(x, x, x, out, lse, 2 * out,
                                           True, scale)
    n, S = x.shape[2], x.shape[1]
    return (out[0].transpose(0, 1), lse.reshape(n, S),
            (dq + dk + dv)[0].transpose(0, 1))


@pytest.mark.parametrize("S,n,h,chunk", [(200, 2, 64, 64), (130, 3, 128, 48),
                                         (64, 1, 64, 64)])
def test_chunked_evaluators_match_the_plain_version(S, n, h, chunk):
    x = torch.from_numpy(np.random.RandomState(S).randn(1, S, n, h)
                         .astype(np.float32))
    scale = 1.0 / math.sqrt(h)
    out_p, lse_p, grad_p = _plain(x, scale)
    out, lse = chip_smoke.attention_ref_fwd(torch, x, scale, chunk)
    np.testing.assert_allclose(out.numpy(), out_p.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), lse_p.numpy(), rtol=1e-5,
                               atol=1e-6)
    # every row, in chunks of rows, as the 16k point checks
    grad = torch.cat([chip_smoke.attention_ref_grad_rows(
        torch, x, scale, out, lse, list(range(i, min(i + chunk, S))))
        for i in range(0, S, chunk)], dim=1)
    np.testing.assert_allclose(grad.numpy(), grad_p.numpy(), rtol=1e-5,
                               atol=1e-6)
    # sampled rows, as the 128k point checks: first, last, tile edges
    rows = sorted({0, 1, S // 2, S - 1} | {r for r in (63, 64) if r < S})
    got = chip_smoke.attention_ref_grad_rows(torch, x, scale, out, lse,
                                             rows)
    np.testing.assert_allclose(got.numpy(), grad_p[:, rows].numpy(),
                               rtol=1e-5, atol=1e-6)


def test_hold_rows_is_relative_per_row():
    ref = torch.tensor([[[1e-4, 0.0], [3.0, 4.0]]])
    ok = ref.clone()
    ok[0, 0, 0] *= 1.01                  # 1 % off on a tiny row
    assert chip_smoke.hold_rows("ok", ok, ref, 2e-2) == pytest.approx(
        0.01, rel=1e-3)
    bad = ref.clone()
    bad[0, 0, 0] *= 1.03                 # 3 %: far under any atol
    with pytest.raises(AssertionError):
        chip_smoke.hold_rows("bad", bad, ref, 2e-2)


@pytest.mark.parametrize("b,step", [(3, 1), (4, 2), (2, 2)])
def test_plain_by_batch_equals_one_call(b, step):
    """q, k, v as the GPT hands them over (views of one qkv tensor),
    causal: the outputs of `step` batch rows a call, joined, are the
    whole batch's call's."""
    gen = torch.Generator().manual_seed(b)
    q, k, v, dout = chip_smoke.flash_inputs(torch, gen, torch.float32,
                                            "cpu", b, 48, 48, 3, 32)
    scale = 1.0 / math.sqrt(32)
    out, lse = flash_attention_fwd_plain(q, k, v, True, scale)
    got = chip_smoke.plain_by_batch(torch, flash_attention_fwd_plain, b,
                                    step)(q, k, v, True, scale)
    for g, r in zip(got, (out, lse)):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-6,
                                   atol=1e-7)
    ref = flash_attention_bwd_plain(q, k, v, out, lse, dout, True, scale)
    got = chip_smoke.plain_by_batch(torch, flash_attention_bwd_plain, b,
                                    step)(q, k, v, out, lse, dout, True,
                                          scale)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-6,
                                   atol=1e-7)
