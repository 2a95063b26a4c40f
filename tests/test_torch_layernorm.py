"""The port's residual-add + LayerNorm (paddle_tpu_torch.ops.layernorm)
against the JAX package's Pallas kernels, on the same numpy inputs.

On the CPU the wrappers run the plain version; it must match the JAX
`_fwd` (K6: out, f32 sum, rstd) and `fused_add_layer_norm` (K7: out) in
interpret mode at the JAX registry's tolerance (1e-4, 1e-5), and the
port's pair backward must match the vjp of `fused_add_layer_norm_pair`.
The inference pair (K7's out and the residual carry from one launch)
must match the JAX pair: out within the registry's tolerance, the carry
bit for bit, and the no-grad residual site must call it once and add
nothing itself. The saving form's carry (x + r in x's dtype from the
same launch) must equal the JAX pair's bit for bit, and the residual
site with a gradient must call the saving wrapper once, cast nothing
itself and match the JAX pair's vjp.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddle_tpu.ops import pallas_layernorm as jax_ln

from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import functional as nn_functional
from paddle_tpu_torch.ops.kernel_registry import get_kernel, reset_launches
from paddle_tpu_torch.ops import layernorm as ln_ops
from paddle_tpu_torch.ops.layernorm import (FusedAddLayerNormPair,
                                            layernorm_fused,
                                            layernorm_fused_pair,
                                            layernorm_fused_pair_plain,
                                            layernorm_fwd_saved,
                                            layernorm_plain)

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


_JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_BITS = {torch.float32: (torch.int32, np.int32),
         torch.bfloat16: (torch.int16, np.int16)}


def _bits(t):
    return t.view(_BITS[t.dtype][0])


@pytest.mark.parametrize("d", [768, 770])       # 770: d % 8 != 0
@pytest.mark.parametrize("rows", [1, 8, 16, 128, 300])
@pytest.mark.parametrize("x_dt,r_dt", [("float32", "float32"),
                                       ("bfloat16", "bfloat16"),
                                       ("bfloat16", "float32")])
def test_inference_pair_matches_jax_pair(x_dt, r_dt, rows, d):
    """(out, carry) against the JAX pair `fused_add_layer_norm_pair`:
    its Pallas kernel in interpret mode where its block spec takes the
    rows, else its plain reference `_ln_ref` (300 rows is no multiple of
    its 256-row block). The carry is one rounding of the f32 sum, so it
    equals the JAX carry and torch's own `(x + r).to(x.dtype)` bit for
    bit, mixed dtypes (bf16 x, f32 r: two roundings in each) included."""
    x, r, w, b = _inputs(rows * 7 + d, rows, d)
    jx, jr = jnp.asarray(x, _JD[x_dt]), jnp.asarray(r, _JD[r_dt])
    jw, jb = jnp.asarray(w), jnp.asarray(b)
    if rows <= 256:
        ref_y, ref_h = jax_ln.fused_add_layer_norm_pair(jx, jr, jw, jb, 1e-5)
    else:
        ref_y, ref_s, _ = jax_ln._ln_ref(jx, jr, jw, jb, 1e-5)
        ref_h = ref_s.astype(jx.dtype)
    tx = _t(np.asarray(jx.astype(jnp.float32)), _TD[x_dt])
    tr = _t(np.asarray(jr.astype(jnp.float32)), _TD[r_dt])
    y, h = layernorm_fused_pair(tx, tr, _t(w), _t(b), 1e-5)
    assert y.dtype == h.dtype == tx.dtype
    assert y.shape == h.shape == (rows, d)
    np.testing.assert_allclose(
        y.float().numpy(), np.asarray(ref_y.astype(jnp.float32)),
        **(_TOL if x_dt == "float32" else _TOL_BF16))
    ref_bits = np.array(ref_h).view(_BITS[h.dtype][1])
    assert torch.equal(_bits(h), torch.from_numpy(ref_bits))
    assert torch.equal(_bits(h), _bits((tx + tr).to(tx.dtype)))
    # the y-only form is the pair's first output
    assert torch.equal(layernorm_fused(tx, tr, _t(w), _t(b), 1e-5), y)


def test_inference_pair_site_one_call_no_add(monkeypatch):
    """Without a gradient, `nn.fused_add_layer_norm` makes one call of
    the kernel wrapper for both outputs and no add of its own (the CPU
    launches nothing, so a counting stand-in takes the wrapper's place
    and every torch function the site calls is recorded)."""
    x, r, w, b = _inputs(13, 16, 128)
    x3, r3 = _t(x).reshape(2, 8, 128), _t(r).reshape(2, 8, 128)
    wt, bt = _t(w), _t(b)
    want = layernorm_fused_pair_plain(x3, r3, wt, bt)
    calls = []

    def stand_in(*args):
        calls.append(args)
        return want

    class Record(torch.overrides.TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            self.names.append(getattr(func, "__name__", str(func)))
            return func(*args, **(kwargs or {}))

    monkeypatch.setattr(nn_functional, "layernorm_fused_pair", stand_in)
    with torch.no_grad(), Record() as rec:
        y, h = nn.fused_add_layer_norm(x3, r3, wt, bt)
    assert len(calls) == 1
    assert not [n for n in rec.names if "add" in n], rec.names
    assert y is want[0] and h is want[1]
    assert y.shape == h.shape == (2, 8, 128)
    assert torch.equal(h, (x3 + r3).to(x3.dtype))


def test_inference_pair_keeps_leading_dims():
    """The pair takes [..., d] (the residual site's [batch, seq, d]) and
    returns both outputs in that shape: the rows are normalized one by
    one, as over the flattened [rows, d]."""
    x, r, w, b = _inputs(21, 6, 128)
    x3, r3 = _t(x).reshape(2, 3, 128), _t(r).reshape(2, 3, 128)
    y3, h3 = layernorm_fused_pair(x3, r3, _t(w), _t(b))
    y2, h2 = layernorm_fused_pair(_t(x), _t(r), _t(w), _t(b))
    assert y3.shape == h3.shape == (2, 3, 128)
    assert torch.equal(y3.reshape(6, 128), y2)
    assert torch.equal(h3.reshape(6, 128), h2)


def test_inference_pair_no_fallback_off_the_cpu():
    """On a tensor that is not on the CPU (meta stands for the card's
    here) the pair takes no plain version: it checks and raises."""
    x = torch.empty((16, 768), device="meta")
    w = torch.empty((768,), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        layernorm_fused_pair(x, x, w, w)


@pytest.mark.parametrize("x_dt,r_dt", [("float32", "float32"),
                                       ("float32", "bfloat16"),
                                       ("bfloat16", "bfloat16"),
                                       ("bfloat16", "float32")])
def test_saving_carry_matches_jax_pair(x_dt, r_dt):
    """With `carry`, the saving form also returns the residual carry:
    bit for bit the second output of the JAX pair (its Pallas `_fwd` in
    interpret mode, then `s.astype(x.dtype)`), the f32 sum itself for an
    f32 x; the other three outputs are those of the call without it."""
    x, r, w, b = _inputs(31, 64, 256)
    jx, jr = jnp.asarray(x, _JD[x_dt]), jnp.asarray(r, _JD[r_dt])
    jw, jb = jnp.asarray(w, _JD[x_dt]), jnp.asarray(b, _JD[x_dt])
    _, ref_h = jax_ln.fused_add_layer_norm_pair(jx, jr, jw, jb, 1e-5)
    tx = _t(np.asarray(jx.astype(jnp.float32)), _TD[x_dt])
    tr = _t(np.asarray(jr.astype(jnp.float32)), _TD[r_dt])
    tw, tb = _t(w, _TD[x_dt]), _t(b, _TD[x_dt])
    out, s, rstd, h = layernorm_fwd_saved(tx, tr, tw, tb, 1e-5, carry=True)
    assert h.dtype == tx.dtype and h.shape == (64, 256)
    ref_bits = np.array(ref_h).view(_BITS[h.dtype][1])
    assert torch.equal(_bits(h), torch.from_numpy(ref_bits))
    if x_dt == "float32":
        assert h is s
    for got, want in zip((out, s, rstd),
                         layernorm_fwd_saved(tx, tr, tw, tb, 1e-5)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("x_dt,r_dt", [("bfloat16", "bfloat16"),
                                       ("float32", "bfloat16")])
def test_saving_site_one_call_no_cast(monkeypatch, x_dt, r_dt):
    """With a gradient wanted, `nn.fused_add_layer_norm` makes one call
    of the saving wrapper, which returns the carry too, and casts and
    adds nothing itself (a counting stand-in takes the wrapper's place
    and every torch function the site calls is recorded)."""
    x, r, w, b = _inputs(17, 16, 128)
    x3 = _t(x, _TD[x_dt]).reshape(2, 8, 128).requires_grad_()
    r3 = _t(r, _TD[r_dt]).reshape(2, 8, 128).requires_grad_()
    wt = _t(w, _TD[x_dt]).requires_grad_()
    bt = _t(b, _TD[x_dt]).requires_grad_()
    with torch.no_grad():
        want = layernorm_plain(x3.reshape(16, 128), r3.reshape(16, 128),
                               wt, bt, 1e-5, carry=True)
    calls = []

    def stand_in(*args, **kwargs):
        calls.append((args, kwargs))
        return want

    class Record(torch.overrides.TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            self.names.append(getattr(func, "__name__", str(func)))
            return func(*args, **(kwargs or {}))

    monkeypatch.setattr(ln_ops, "layernorm_fwd_saved", stand_in)
    with Record() as rec:
        y, h = nn.fused_add_layer_norm(x3, r3, wt, bt)
    assert len(calls) == 1 and calls[0][1] == {"carry": True}
    assert not [n for n in rec.names
                if n in ("to", "type", "float", "bfloat16", "_to_copy")
                or "add" in n], rec.names
    assert y.grad_fn is not None and y.shape == h.shape == (2, 8, 128)
    assert h.dtype == x3.dtype
    assert torch.equal(h.detach().reshape(16, 128), want[3])
    assert torch.equal(h.detach(), (x3 + r3).detach().to(x3.dtype))


@pytest.mark.parametrize("x_dt,r_dt", [("float32", "float32"),
                                       ("float32", "bfloat16"),
                                       ("bfloat16", "bfloat16")])
def test_saving_site_matches_jax_pair_vjp(x_dt, r_dt):
    """The residual site with a gradient wanted (the saving kernel's
    plain version, its carry, the port's backward) against the JAX
    pair's `_pair_vjp_fwd` and `_pair_vjp_bwd` on the same inputs and
    cotangents: outputs and gradients within the tolerances above (bf16
    ones within the bf16 tolerance), the carry bit for bit."""
    rows, d = 128, 256
    x, r, w, b = _inputs(41, rows, d)
    rs = np.random.RandomState(42)
    g_out = rs.randn(rows, d).astype(np.float32)
    g_sum = rs.randn(rows, d).astype(np.float32)
    jx, jr = jnp.asarray(x, _JD[x_dt]), jnp.asarray(r, _JD[r_dt])
    jw, jb = jnp.asarray(w, _JD[x_dt]), jnp.asarray(b, _JD[x_dt])
    jg_out, jg_sum = (jnp.asarray(g, _JD[x_dt]) for g in (g_out, g_sum))
    (ref_y, ref_h), saved = jax_ln._pair_vjp_fwd(jx, jr, jw, jb, 1e-5)
    ref_grads = jax_ln._pair_vjp_bwd(1e-5, saved, (jg_out, jg_sum))
    ins = [_t(np.asarray(a.astype(jnp.float32)), _TD[dt]).requires_grad_()
           for a, dt in ((jx, x_dt), (jr, r_dt), (jw, x_dt), (jb, x_dt))]
    y, h = nn.fused_add_layer_norm(ins[0].reshape(2, rows // 2, d),
                                   ins[1].reshape(2, rows // 2, d), *ins[2:])
    tol = _TOL if x_dt == "float32" else _TOL_BF16
    np.testing.assert_allclose(
        y.detach().float().reshape(rows, d).numpy(),
        np.asarray(ref_y.astype(jnp.float32)), **tol)
    ref_bits = np.array(ref_h).view(_BITS[h.dtype][1])
    assert torch.equal(_bits(h.detach().reshape(rows, d)),
                       torch.from_numpy(ref_bits))
    torch.autograd.backward(
        (y, h), tuple(_t(np.asarray(g.astype(jnp.float32)), _TD[x_dt])
                      .reshape(2, rows // 2, d) for g in (jg_out, jg_sum)))
    for t, want in zip(ins, ref_grads):
        np.testing.assert_allclose(
            t.grad.float().numpy(), np.asarray(want.astype(jnp.float32)),
            **(_TOL if t.dtype == torch.float32 and x_dt == "float32"
               else _TOL_BF16))


@pytest.mark.parametrize("carry", [False, True])
def test_saving_no_fallback_off_the_cpu(carry):
    """On a tensor that is not on the CPU (meta stands for the card's
    here) the saving wrapper takes no plain version: it checks and
    raises, with or without the carry."""
    x = torch.empty((16, 768), device="meta")
    w = torch.empty((768,), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        layernorm_fwd_saved(x, x, w, w, carry=carry)
