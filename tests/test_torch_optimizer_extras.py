"""The port's optimizer wrappers (ExponentialMovingAverage, ModelAverage,
Lookahead, GradientMerge) against the JAX package's, on the CPU, from
the same numpy inputs and the same inner optimizer's steps.

- EMA with and without bias correction, with a fixed decay and with
  `thres_steps` (a counter the caller advances), and ModelAverage across
  its window restarts: shadows, sums and the averaged weights within
  1e-6 relative at every step (the same f32 operations); `apply()`
  writes the averages into the same parameter tensors and `restore()`
  puts the old values back bit for bit.
- Lookahead every k steps over SGD (f32) and over Momentum with bf16
  parameters and f32 masters: the parameters (and masters) within 1e-6
  / 1e-5 relative of JAX at every step; a Lookahead write leaves the
  master stale, and the next step restarts it from the parameter (the
  optimizer's self-heal), as in JAX.
- GradientMerge: no step and no gradient midway, the merged step equal
  to one step on the mean (or sum) gradient, JAX's parameters at every
  step, and nested as GradientMerge(Lookahead(SGD)).
- The wrappers' errors: a parameter list where the reference takes the
  decay or rate first, and no parameters.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu import optimizer as jax_opt
from paddle_tpu.core.tensor import Parameter, Tensor

from paddle_tpu_torch import optimizer as opt_mod

_SHAPES = [(4, 3), (7,), (2, 5)]


def _pairs(dtype=torch.float32, seed=3):
    rs = np.random.RandomState(seed)
    x0 = [rs.randn(*s).astype(np.float32) for s in _SHAPES]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return ([Parameter(jnp.asarray(x, jdt)) for x in x0],
            [torch.nn.Parameter(torch.from_numpy(x.copy()).to(dtype))
             for x in x0])


def _grads(jps, tps, seed):
    rs = np.random.RandomState(100 + seed)
    for jp, tp in zip(jps, tps):
        g = rs.randn(*tp.shape).astype(np.float32)
        jp.grad = Tensor(jnp.asarray(g, jp._value.dtype))
        tp.grad = torch.from_numpy(g).to(tp.dtype)


def _np(v):
    return np.asarray(jnp.asarray(v, jnp.float32))


def _same(ts, js, rtol=1e-6, atol=1e-7):
    for t, j in zip(ts, js):
        np.testing.assert_allclose(t.detach().float().numpy(), _np(j),
                                   rtol=rtol, atol=atol)


class _Counter:
    """A step count with `.item()`, as `thres_steps` is read."""

    def __init__(self):
        self.n = 0

    def item(self):
        return self.n


_AVERAGES = ["ema", "ema_plain", "ema_thres", "ema_plain_thres",
             "model_average"]


def _averager(mod, kind, params, counter):
    if kind == "model_average":
        # window max(2, min(3, int(0.5 count) or 1)): restarts at counts 3
        # and 4
        return mod.ModelAverage(0.5, parameters=params,
                                min_average_window=2, max_average_window=3)
    return mod.ExponentialMovingAverage(
        0.9, thres_steps=counter if "thres" in kind else None,
        parameters=params, bias_correction="plain" not in kind)


@pytest.mark.parametrize("kind", _AVERAGES)
def test_averages_match_jax_and_swap_in_place(kind):
    jps, tps = _pairs()
    jo = jax_opt.SGD(learning_rate=0.1, parameters=jps)
    to = opt_mod.SGD(learning_rate=0.1, parameters=tps)
    jc, tc = _Counter(), torch.zeros((), dtype=torch.int64)
    jw = _averager(jax_opt, kind, jps, jc)
    tw = _averager(opt_mod, kind, tps, tc)
    ptrs = [p.data_ptr() for p in tps]
    for step in range(6):
        _grads(jps, tps, step)
        jo.step()
        to.step()
        if kind == "model_average":
            jw.accumulate()
            tw.accumulate()
            assert tw._count == jw._count
            _same(tw._sum, jw._sum)
        else:
            jw.update()
            tw.update()
            _same(tw._shadow, jw._shadow)
        jc.n += 1
        tc.add_(1)
        before = [p.detach().clone() for p in tps]
        with tw.apply(), jw.apply():
            _same(tps, [p._value for p in jps])
            # (the average of one accumulation is the parameter itself)
            assert (kind == "model_average" and step == 0) or not all(
                torch.equal(a, b) for a, b in zip(before, tps))
        # restored bit for bit, into the same tensors
        assert all(torch.equal(a, b) for a, b in zip(before, tps))
        assert [p.data_ptr() for p in tps] == ptrs
    # apply without restore leaves the averages; restore() brings back
    with tw.apply(need_restore=False):
        pass
    averaged = [p.detach().clone() for p in tps]
    tw.restore()
    assert all(torch.equal(a, b) for a, b in zip(before, tps))
    assert not all(torch.equal(a, b) for a, b in zip(averaged, tps))


def test_ema_before_any_update():
    """With bias correction the shadow starts at zero and apply() before
    any update() writes it raw; without, the shadow is the parameters."""
    for bias in (True, False):
        jps, tps = _pairs()
        jw = jax_opt.ExponentialMovingAverage(0.9, parameters=jps,
                                              bias_correction=bias)
        tw = opt_mod.ExponentialMovingAverage(0.9, parameters=tps,
                                              bias_correction=bias)
        with tw.apply(), jw.apply():
            _same(tps, [p._value for p in jps])


@pytest.mark.parametrize("inner", ["sgd", "momentum_bf16"])
def test_lookahead_matches_jax(inner):
    dtype = torch.bfloat16 if inner == "momentum_bf16" else torch.float32
    jps, tps = _pairs(dtype)
    if inner == "sgd":
        jo = jax_opt.SGD(learning_rate=0.1, parameters=jps)
        to = opt_mod.SGD(learning_rate=0.1, parameters=tps)
    else:
        jo = jax_opt.Momentum(learning_rate=0.05, momentum=0.9,
                              parameters=jps)
        to = opt_mod.Momentum(learning_rate=0.05, momentum=0.9,
                              parameters=tps)
    jl, tl = jax_opt.Lookahead(jo, alpha=0.5, k=3), \
        opt_mod.Lookahead(to, alpha=0.5, k=3)
    ptrs = [p.data_ptr() for p in tps]
    for step in range(7):
        _grads(jps, tps, step)
        jl.step()
        tl.step()
        if dtype == torch.float32:
            _same(tl._slow, jl._slow)
            _same(tps, [p._value for p in jps])
            continue
        # bf16: the parameters and the slow weights (made from them)
        # within a bf16 step, the masters 1e-5
        _same(tl._slow, jl._slow, rtol=2.0 ** -7, atol=1e-6)
        _same(tps, [p._value for p in jps], rtol=2.0 ** -7, atol=1e-6)
        masters = [to._states[id(p)]["master"] for p in tps]
        _same(masters, [jo._states[id(p)]["master"] for p in jps],
              rtol=1e-5)
        in_sync = all(torch.equal(p.detach(), m.bfloat16())
                      for p, m in zip(tps, masters))
        # the k-th step writes the slow weights over the fast ones: the
        # master is stale until the next step restarts it
        assert in_sync == ((step + 1) % 3 != 0)
    assert [p.data_ptr() for p in tps] == ptrs
    assert tl.get_lr() == (0.1 if inner == "sgd" else 0.05)


@pytest.mark.parametrize("avg", [True, False])
def test_gradient_merge_matches_jax_and_the_big_batch(avg):
    jps, tps = _pairs()
    big = [torch.nn.Parameter(p.detach().clone()) for p in tps]
    jm = jax_opt.GradientMerge(jax_opt.SGD(learning_rate=0.1,
                                           parameters=jps), k_steps=3,
                               avg=avg)
    tm = opt_mod.GradientMerge(opt_mod.SGD(learning_rate=0.1,
                                           parameters=tps), k_steps=3,
                               avg=avg)
    sgd = opt_mod.SGD(learning_rate=0.1, parameters=big)
    gsum = [torch.zeros(p.shape) for p in tps]
    for step in range(6):
        before = [p.detach().clone() for p in tps]
        _grads(jps, tps, step)
        for s, p in zip(gsum, tps):
            s.add_(p.grad)
        jm.step()
        tm.step()
        _same(tps, [p._value for p in jps])
        assert all(p.grad is None for p in tps)
        if (step + 1) % 3:
            assert all(torch.equal(a, b) for a, b in zip(before, tps))
            continue
        for b, s in zip(big, gsum):
            b.grad = s / 3 if avg else s.clone()
        sgd.step()
        for s in gsum:
            s.zero_()
        for a, b in zip(tps, big):
            np.testing.assert_allclose(a.detach().numpy(),
                                       b.detach().numpy(), rtol=1e-6,
                                       atol=1e-7)


def test_gradient_merge_over_lookahead_matches_jax():
    jps, tps = _pairs()
    jw = jax_opt.GradientMerge(jax_opt.Lookahead(
        jax_opt.SGD(learning_rate=0.2, parameters=jps), alpha=0.5, k=2),
        k_steps=2)
    tw = opt_mod.GradientMerge(opt_mod.Lookahead(
        opt_mod.SGD(learning_rate=0.2, parameters=tps), alpha=0.5, k=2),
        k_steps=2)
    for step in range(8):
        _grads(jps, tps, step)
        jw.step()
        tw.step()
        _same(tps, [p._value for p in jps])
    assert tw.inner._steps == jw.inner._steps == 4
    assert tw.get_lr() == 0.2


@pytest.mark.parametrize("cls,args,kw,err", [
    ("ExponentialMovingAverage", ("params",), {}, TypeError),
    ("ExponentialMovingAverage", (0.9,), {}, ValueError),
    ("ModelAverage", ("params",), {}, TypeError),
    ("ModelAverage", (0.15,), {}, ValueError),
])
def test_wrapper_errors_match_jax(cls, args, kw, err):
    for mod, ps in ((jax_opt, _pairs()[0]), (opt_mod, _pairs()[1])):
        a = tuple(ps if x == "params" else x for x in args)
        with pytest.raises(err):
            getattr(mod, cls)(*a, **kw)
