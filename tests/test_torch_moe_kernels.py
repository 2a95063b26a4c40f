"""The port's MoE dispatch and combine (paddle_tpu_torch.moe.kernels)
against the JAX package's, on the same numpy inputs.

On the CPU the wrappers run their plain versions. They must match the
JAX Pallas kernels in interpret mode (`moe_gather(src, idx, True)`) at
d 128 and 256 and the jnp fallbacks at d 64, with the sentinel index
(an empty slot, a dropped choice) among the inputs: the gather exactly,
the combine within 1e-6. The gradients of the autograd Functions (the
JAX index-form backwards in torch) must match `jax.grad` within 5e-5 in
f32, as tests/test_moe.py holds kernel against fallback. In bf16 the
inputs are the same bf16 values on both sides; the combine's dw is a
dot over d rounded to bf16, where two f32 summation orders may differ by
one bf16 step (2^-8 relative).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddle_tpu.moe import kernels as jax_kernels

from paddle_tpu_torch.moe.kernels import (combine_plain, gather_plain,
                                          moe_combine, moe_combine_fwd,
                                          moe_gather, moe_gather_fwd)
from paddle_tpu_torch.ops.kernel_registry import (get_kernel, kernels,
                                                  reset_launches)

_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}
_GRAD_TOL = dict(rtol=0, atol=5e-5)


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    reset_launches()
    yield
    assert get_kernel("moe_gather").launches == 0
    assert get_kernel("moe_combine").launches == 0


def _pair(a, dname):
    """The same values as a JAX array and a torch tensor of `dname`."""
    jdt, tdt = _DTYPES[dname]
    j = jnp.asarray(a, jdt)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)
    return j, t


def _np(t):
    return t.detach().float().numpy()


def _gather_inputs(seed, n_src, m, d):
    rs = np.random.RandomState(seed)
    src = rs.randn(n_src, d).astype(np.float32)
    idx = rs.randint(0, n_src + 1, (m,)).astype(np.int32)
    idx[:3] = n_src                     # sentinels, certainly
    g = rs.randn(m, d).astype(np.float32)
    return src, idx, g


def _combine_inputs(seed, n_src, n, k, d):
    rs = np.random.RandomState(seed)
    src = rs.randn(n_src, d).astype(np.float32)
    idx = rs.randint(0, n_src + 1, (n, k)).astype(np.int32)
    idx[:2, 0] = n_src
    idx[-1, :] = n_src                  # a token whose every choice dropped
    w = rs.rand(n, k).astype(np.float32)
    g = rs.randn(n, d).astype(np.float32)
    return src, idx, w, g


def _check_gather(jax_fn, use_kernel, dname, d, seed):
    """Forward against `jax_fn`; gradients against the JAX custom_vjp
    (`moe_gather` with that `use_kernel`), whose backward accumulates in
    f32 (jax.grad of the bare fallback would scatter-add in bf16)."""
    src, idx, g = _gather_inputs(seed, 24, 37, d)
    jsrc, tsrc = _pair(src, dname)
    jg, tg = _pair(g, "float32")
    jidx, tidx = jnp.asarray(idx), torch.from_numpy(idx)
    want = jax_fn(jsrc, jidx)
    got = moe_gather(tsrc, tidx)
    assert got.dtype == tsrc.dtype and got.shape == (37, d)
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))
    assert np.all(_np(got)[idx == 24] == 0.0)

    jgrad = jax.grad(lambda s: jnp.sum(
        jax_kernels.moe_gather(s, jidx, use_kernel).astype(jnp.float32)
        * jg))(jsrc)
    ts = tsrc.clone().requires_grad_()
    (moe_gather(ts, tidx).float() * tg).sum().backward()
    assert ts.grad.dtype == tsrc.dtype
    np.testing.assert_allclose(_np(ts.grad), np.asarray(jgrad, np.float32),
                               **_GRAD_TOL)


def _check_combine(jax_fn, use_kernel, dname, d, k, seed):
    """As _check_gather, for the combine."""
    src, idx, w, g = _combine_inputs(seed, 20, 19, k, d)
    jsrc, tsrc = _pair(src, dname)
    jw, tw = _pair(w, dname)
    jg, tg = _pair(g, "float32")
    jidx, tidx = jnp.asarray(idx), torch.from_numpy(idx)
    want = jax_fn(jsrc, jidx, jw)
    got = moe_combine(tsrc, tidx, tw)
    assert got.dtype == tsrc.dtype and got.shape == (19, d)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=1e-6, atol=1e-6)
    assert np.all(_np(got)[-1] == 0.0)

    jds, jdw = jax.grad(
        lambda s, ww: jnp.sum(jax_kernels.moe_combine(
            s, jidx, ww, use_kernel).astype(jnp.float32) * jg),
        (0, 1))(jsrc, jw)
    ts, tw2 = tsrc.clone().requires_grad_(), tw.clone().requires_grad_()
    (moe_combine(ts, tidx, tw2).float() * tg).sum().backward()
    assert ts.grad.dtype == tsrc.dtype and tw2.grad.dtype == tw.dtype
    np.testing.assert_allclose(_np(ts.grad), np.asarray(jds, np.float32),
                               **_GRAD_TOL)
    dw_tol = _GRAD_TOL if dname == "float32" else dict(rtol=2 ** -8,
                                                       atol=5e-5)
    np.testing.assert_allclose(_np(tw2.grad), np.asarray(jdw, np.float32),
                               **dw_tol)
    # a dropped choice receives no gradient through its weight's row
    assert np.all(_np(tw2.grad)[idx == 20] == 0.0)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [128, 256])
def test_gather_matches_jax_interpret_kernel(dname, d):
    _check_gather(lambda s, i: jax_kernels.moe_gather(s, i, True), True,
                  dname, d, seed=d)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_gather_matches_jax_fallback(dname):
    _check_gather(jax_kernels.gather_fallback, False, dname, 64, seed=3)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("k", [1, 2])
def test_combine_matches_jax_interpret_kernel(dname, d, k):
    _check_combine(lambda s, i, w: jax_kernels.moe_combine(s, i, w, True),
                   True, dname, d, k, seed=d + k)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 2])
def test_combine_matches_jax_fallback(dname, k):
    _check_combine(jax_kernels.combine_fallback, False, dname, 64, k,
                   seed=5 + k)


def test_all_sentinels_give_zero_rows():
    src = torch.randn(6, 64)
    assert torch.equal(moe_gather_fwd(src, torch.full((5,), 6,
                                                      dtype=torch.int32)),
                       torch.zeros(5, 64))
    idx = torch.full((4, 2), 6, dtype=torch.int32)
    assert torch.equal(moe_combine_fwd(src, idx, torch.rand(4, 2)),
                       torch.zeros(4, 64))


def test_backward_accumulates_in_f32_and_drops_the_spare_row():
    """A bf16 source's gradient is summed in f32 and rounded once: 1 +
    2^-8 + 2^-8 is 1 + 2^-7 (a bf16 value), where bf16 accumulation
    would round 1 + 2^-8 back to 1 twice. The empty slot's gradient
    (index 3) lands in the spare row and is dropped."""
    src = torch.zeros(3, 64, dtype=torch.bfloat16, requires_grad=True)
    idx = torch.tensor([0, 0, 0, 3], dtype=torch.int32)
    g = torch.tensor([1.0, 2 ** -8, 2 ** -8, 5.0])[:, None].expand(4, 64)
    (moe_gather(src, idx).float() * g).sum().backward()
    assert src.grad.shape == (3, 64) and src.grad.dtype == torch.bfloat16
    assert torch.equal(src.grad[0].float(), torch.full((64,), 1 + 2 ** -7))
    assert torch.equal(src.grad[1:].float(), torch.zeros(2, 64))


def test_plain_versions_use_the_sentinel_index_math():
    src = torch.arange(12.0).reshape(3, 4)
    out = gather_plain(src, torch.tensor([2, 3, 0, -1], dtype=torch.int32))
    assert torch.equal(out, torch.stack([src[2], torch.zeros(4), src[0],
                                         torch.zeros(4)]))
    w = torch.tensor([[0.5, 2.0]])
    out = combine_plain(src, torch.tensor([[1, 3]], dtype=torch.int32), w)
    assert torch.equal(out, 0.5 * src[1:2])


@pytest.mark.parametrize("name,fn,replaces", [
    ("moe_gather", moe_gather_fwd, "paddle_tpu/moe/kernels.py:138"),
    ("moe_combine", moe_combine_fwd, "paddle_tpu/moe/kernels.py:244")])
def test_registry_entries(name, fn, replaces):
    k = get_kernel(name)
    assert k in kernels()
    assert k.wrapper is fn
    assert k.plain in (gather_plain, combine_plain)
    assert k.source == "paddle_tpu_torch/csrc/moe_kernels.cu"
    assert k.replaces == replaces
    assert set(k.tol) == {"float32", "bfloat16"}
    # the cited line is the TPU kernel's def
    path, line = replaces.split(":")
    with open(path) as f:
        assert f.read().splitlines()[int(line) - 1].startswith("def _")


def test_registry_tolerances():
    assert get_kernel("moe_gather").tol["float32"] == (0.0, 0.0)
    # the JAX registry's combine tolerance
    assert get_kernel("moe_combine").tol["float32"] == (1e-5, 1e-5)


def test_wrappers_never_fall_back_off_the_cpu():
    """Off the CPU a wrapper launches its kernel or raises; the meta
    device has no kernel, so it raises."""
    src = torch.empty((8, 64), device="meta")
    idx = torch.empty((4,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        moe_gather_fwd(src, idx)
    with pytest.raises(ValueError, match="unsupported device"):
        moe_combine_fwd(src, idx.reshape(2, 2),
                        torch.empty((2, 2), device="meta"))


class _GatherRecorder:
    """Stand-in for `moe_gather_fwd` that records its arguments and
    returns what the real wrapper returns (on the CPU, the plain
    version)."""

    def __init__(self, real):
        self.real, self.calls = real, []

    def __call__(self, src, idx):
        self.calls.append((src, idx))
        return self.real(src, idx)


@pytest.fixture
def gather_recorder(monkeypatch):
    from paddle_tpu_torch.moe import kernels as kmod
    rec = _GatherRecorder(kmod.moe_gather_fwd)
    monkeypatch.setattr(kmod, "moe_gather_fwd", rec)
    return rec


def test_combine_backward_gathers_through_the_kernel_wrapper(
        gather_recorder):
    """The combine's backward gathers its rows through `moe_gather_fwd`
    (K12 on the card) once, with src and the flat choice map, and never
    through `gather_plain` directly: a backward that called the plain
    version would record no call."""
    src, idx, w, g = _combine_inputs(11, 20, 19, 2, 64)
    ts = torch.from_numpy(src).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tidx = torch.from_numpy(idx)
    out = moe_combine(ts, tidx, tw)
    assert gather_recorder.calls == []          # the forward is K13 alone
    (out * torch.from_numpy(g)).sum().backward()
    assert len(gather_recorder.calls) == 1
    got_src, got_idx = gather_recorder.calls[0]
    assert torch.equal(got_src, ts.detach())
    assert got_idx.dtype == torch.int32 and got_idx.is_contiguous()
    assert torch.equal(got_idx, tidx.reshape(-1))


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("k", [1, 2])
def test_combine_backward_through_the_wrapper_matches_jax(
        gather_recorder, dname, use_kernel, k):
    """With the recording stand-in in place, the gradients still match
    the JAX custom_vjp (fallback and Pallas interpret mode) within the
    file's tolerances, and the backward made exactly one gather call."""
    jax_fn = (lambda s, i, w: jax_kernels.moe_combine(s, i, w, True)) \
        if use_kernel else jax_kernels.combine_fallback
    _check_combine(jax_fn, use_kernel, dname, 128, k, seed=31 + k)
    assert len(gather_recorder.calls) == 1
