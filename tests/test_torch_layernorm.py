"""The port's residual-add + LayerNorm (paddle_tpu_torch.ops.layernorm)
against the JAX package's Pallas kernels, on the same numpy inputs.

On the CPU the wrappers run the plain version; it must match the JAX
`_fwd` (K6: out, f32 sum, rstd) and `fused_add_layer_norm` (K7: out) in
interpret mode at the JAX registry's tolerance (1e-4, 1e-5), and the
port's pair backward must match the vjp of `fused_add_layer_norm_pair`.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddle_tpu.ops import pallas_layernorm as jax_ln

from paddle_tpu_torch import nn
from paddle_tpu_torch.ops.kernel_registry import get_kernel, reset_launches
from paddle_tpu_torch.ops.layernorm import (FusedAddLayerNormPair,
                                            layernorm_fused,
                                            layernorm_fwd_saved)

_TOL = dict(rtol=1e-4, atol=1e-5)
# a bf16 output rounds once; two f32 summation orders may flip one ulp
_TOL_BF16 = dict(rtol=1e-2, atol=1e-2)


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    reset_launches()
    yield
    assert get_kernel("layernorm_fwd_saved").launches == 0
    assert get_kernel("layernorm_fused").launches == 0


def _inputs(seed, rows, d):
    rs = np.random.RandomState(seed)
    x = rs.randn(rows, d).astype(np.float32)
    r = rs.randn(rows, d).astype(np.float32)
    w = (1 + 0.1 * rs.randn(d)).astype(np.float32)
    b = (0.1 * rs.randn(d)).astype(np.float32)
    return x, r, w, b


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, copy=True)).to(dtype)


@pytest.mark.parametrize("rows,d", [(16, 128), (256, 768), (512, 256)])
def test_saving_forward_matches_jax_fwd(rows, d):
    x, r, w, b = _inputs(rows + d, rows, d)
    ref = jax_ln._fwd(jnp.asarray(x), jnp.asarray(r), jnp.asarray(w),
                      jnp.asarray(b), 1e-5)
    got = layernorm_fwd_saved(_t(x), _t(r), _t(w), _t(b), 1e-5)
    assert [tuple(t.shape) for t in got] == [(rows, d), (rows, d),
                                             (rows, 1)]
    assert got[1].dtype == torch.float32 and got[2].dtype == torch.float32
    for g, want in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **_TOL)


@pytest.mark.parametrize("x_dt,r_dt", [("float32", "bfloat16"),
                                       ("bfloat16", "bfloat16")])
def test_saving_forward_mixed_and_bf16_inputs(x_dt, r_dt):
    """The training step adds a bf16 branch output to the f32 residual
    stream; the serving engine runs everything in bf16."""
    x, r, w, b = _inputs(4, 64, 768)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    jx, jr = jnp.asarray(x, jd[x_dt]), jnp.asarray(r, jd[r_dt])
    ref = jax_ln._fwd(jx, jr, jnp.asarray(w), jnp.asarray(b), 1e-5)
    got = layernorm_fwd_saved(_t(np.asarray(jx.astype(jnp.float32)), td[x_dt]),
                              _t(np.asarray(jr.astype(jnp.float32)), td[r_dt]),
                              _t(w), _t(b), 1e-5)
    assert got[0].dtype == td[x_dt]
    np.testing.assert_allclose(
        got[0].float().numpy(), np.asarray(ref[0].astype(jnp.float32)),
        **(_TOL if x_dt == "float32" else _TOL_BF16))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), **_TOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), **_TOL)


@pytest.mark.parametrize("rows,d", [(16, 768), (256, 128)])
def test_output_only_forward_matches_jax_kernel(rows, d):
    x, r, w, b = _inputs(rows * 3 + d, rows, d)
    ref = jax_ln.fused_add_layer_norm(jnp.asarray(x), jnp.asarray(r),
                                      jnp.asarray(w), jnp.asarray(b), 1e-5)
    got = layernorm_fused(_t(x), _t(r), _t(w), _t(b), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **_TOL)


def test_any_row_count():
    """The JAX kernel's rows % 256 condition is a block-spec limit; the
    port takes any row count (here 300, and a single row)."""
    for rows in (300, 1):
        x, r, w, b = _inputs(rows, rows, 128)
        want = jax_ln._ln_ref(jnp.asarray(x), jnp.asarray(r),
                              jnp.asarray(w), jnp.asarray(b), 1e-5)[0]
        got = layernorm_fused(_t(x), _t(r), _t(w), _t(b))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **_TOL)


def test_pair_backward_matches_jax_vjp():
    rows, d = 256, 256
    x, r, w, b = _inputs(9, rows, d)
    rs = np.random.RandomState(10)
    g_out = rs.randn(rows, d).astype(np.float32)
    g_sum = rs.randn(rows, d).astype(np.float32)
    (ref_y, ref_h), vjp = jax.vjp(
        lambda *a: jax_ln.fused_add_layer_norm_pair(*a, 1e-5),
        jnp.asarray(x), jnp.asarray(r), jnp.asarray(w), jnp.asarray(b))
    ref_grads = vjp((jnp.asarray(g_out), jnp.asarray(g_sum)))
    ins = [_t(a).requires_grad_() for a in (x, r, w, b)]
    y, h = FusedAddLayerNormPair.apply(*ins, 1e-5)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref_y), **_TOL)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(ref_h), **_TOL)
    torch.autograd.backward((y, h), (_t(g_out), _t(g_sum)))
    for t, want in zip(ins, ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), **_TOL)


def test_residual_site_routes_by_grad_mode():
    """`nn.fused_add_layer_norm` takes the saving Function when a
    gradient is wanted and the output-only kernel otherwise; both give
    the same values, and the carry is x + residual."""
    x, r, w, b = _inputs(12, 24, 128)
    x3, r3 = _t(x).reshape(2, 12, 128), _t(r).reshape(2, 12, 128)
    wt, bt = _t(w).requires_grad_(), _t(b).requires_grad_()
    y_g, h_g = nn.fused_add_layer_norm(x3, r3, wt, bt)
    assert y_g.grad_fn is not None and y_g.shape == (2, 12, 128)
    with torch.no_grad():
        y_n, h_n = nn.fused_add_layer_norm(x3, r3, wt, bt)
    assert y_n.grad_fn is None
    torch.testing.assert_close(y_g.detach(), y_n)
    torch.testing.assert_close(h_g.detach(), x3 + r3)
    torch.testing.assert_close(h_n, x3 + r3)
