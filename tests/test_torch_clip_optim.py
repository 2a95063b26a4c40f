"""Gradient clipping (paddle_tpu_torch.nn.clip) and the optimizer's
options (SGD, Momentum, groups, L1/L2 decay, AdamW's decay filter,
schedulers, f32 masters, state dicts) against the JAX package, on the
CPU, from the same numpy inputs.

- The three clips and `clip_grad_norm_` within 1e-6 relative: the same
  f32 sums in another order (the port's global norm squares
  `torch._foreach_norm`'s per-tensor norms, an ulp from the reference's
  f32 sums of squares).
- Five f32 `TrainStep`s of a tiny GPT (2 layers, hidden 128, vocab 512)
  with each optimizer recipe, with and without `ClipGradByGlobalNorm`,
  against the JAX `TrainStep`: losses 1e-5 relative, parameters 1e-4
  absolute, the bars of tests/test_torch_train.py.
- bf16 parameters with f32 masters, eager `step()` against the JAX
  optimizer: masters within 1e-5 relative, parameters the master's
  rounding, also after a write to the parameter outside the optimizer
  (the self-heal) and under the decoupled decay (which acts on the
  master).
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu import optimizer as jax_opt
from paddle_tpu.core.tensor import Parameter, Tensor
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.nn import clip as jax_clip
from paddle_tpu.optimizer import lr as jax_lr

from paddle_tpu_torch import optimizer as opt_mod
from paddle_tpu_torch.convert import load_jax_optimizer_state, load_jax_params
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
from paddle_tpu_torch.nn import clip
from paddle_tpu_torch.optimizer import lr

_SHAPES = [(4, 3), (7,), (2, 5, 3), (1,), (6, 6)]


def _grads(scale, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.randn(*s) * scale).astype(np.float32) for s in _SHAPES]


def _pairs(gs, skip=(), frozen=()):
    """(JAX pairs, port pairs) over the same grads; index in `skip` has
    no gradient, in `frozen` need_clip False."""
    jp, tp = [], []
    for i, g in enumerate(gs):
        jpar = Parameter(jnp.zeros(g.shape, jnp.float32))
        tpar = torch.nn.Parameter(torch.zeros(g.shape))
        if i in frozen:
            jpar.need_clip = tpar.need_clip = False
        jg = None if i in skip else Tensor(jnp.asarray(g))
        tg = None if i in skip else torch.from_numpy(g.copy())
        jp.append((jpar, jg))
        tp.append((tpar, tg))
    return jp, tp


def _same_grads(got, ref, rtol=1e-6):
    assert len(got) == len(ref)
    for (_, g), (_, r) in zip(got, ref):
        if r is None:
            assert g is None
            continue
        r = np.asarray(r._value)
        np.testing.assert_allclose(g.numpy(), r, rtol=rtol,
                                   atol=rtol * np.abs(r).max())


@pytest.mark.parametrize("name,args,scale", [
    ("ClipGradByValue", (0.3,), 1.0),
    ("ClipGradByValue", (0.5, -0.1), 1.0),
    ("ClipGradByNorm", (1.5,), 1.0),          # some clipped, some not
    ("ClipGradByNorm", (100.0,), 1.0),        # none clipped
    ("ClipGradByGlobalNorm", (1.0,), 1.0),    # clipped
    ("ClipGradByGlobalNorm", (100.0,), 1.0),  # not clipped
    ("ClipGradByGlobalNorm", (0.01,), 1e-3),  # small gradients
])
def test_clips_match_jax(name, args, scale):
    gs = _grads(scale)
    jpairs, tpairs = _pairs(gs, skip=(3,), frozen=(1,))
    ref = getattr(jax_clip, name)(*args)(jpairs)
    got = getattr(clip, name)(*args)(tpairs)
    _same_grads(got, ref)
    # a frozen parameter's gradient passes through untouched
    if name == "ClipGradByGlobalNorm":
        assert got[1][1] is tpairs[1][1]


def test_clip_aliases_and_need_clip():
    assert clip.GradientClipByGlobalNorm is clip.ClipGradByGlobalNorm
    assert clip.GradientClipByNorm is clip.ClipGradByNorm
    assert clip.GradientClipByValue is clip.ClipGradByValue
    p = torch.nn.Parameter(torch.zeros(2))
    assert clip.need_clip(p)
    p.need_clip = False
    assert not clip.need_clip(p)
    # nothing to clip: the pairs come back as they were
    pairs = [(p, torch.ones(2))]
    assert clip.ClipGradByGlobalNorm(1.0)(pairs) == pairs


@pytest.mark.parametrize("max_norm,norm_type", [(1.0, 2.0), (50.0, 2.0),
                                                (0.5, float("inf")),
                                                (2.0, 1.5)])
def test_clip_grad_norm_matches_jax(max_norm, norm_type):
    gs = _grads(1.0, seed=3)
    jps, tps = [], []
    for g in gs:
        jp = Parameter(jnp.zeros(g.shape, jnp.float32))
        jp.grad = Tensor(jnp.asarray(g))
        tp = torch.nn.Parameter(torch.zeros(g.shape))
        tp.grad = torch.from_numpy(g.copy())
        jps.append(jp)
        tps.append(tp)
    jt = jax_clip.clip_grad_norm_(jps, max_norm, norm_type)
    tt = clip.clip_grad_norm_(tps, max_norm, norm_type)
    np.testing.assert_allclose(float(tt), float(np.asarray(jt._value)),
                               rtol=1e-6)
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.grad.numpy(),
                                   np.asarray(jp.grad._value), rtol=1e-6,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# five TrainSteps of a tiny GPT per optimizer recipe

_MODEL = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
              max_seq_len=64, dropout=0.0, initializer_range=0.02)
_STEPS = 5


def _no_decay(name):
    """AdamW's decay filter: no decay on biases and LayerNorm."""
    return not (name.endswith(".bias") or ".ln" in name)


def _recipe(name, mod, lrm, params, named, clip_on, clip_mod):
    """The optimizer of recipe `name` built from one package's modules:
    `mod` the optimizer module, `lrm` its lr module, `params` the
    parameters in the model's order and `named` their names."""
    grad_clip = clip_mod.ClipGradByGlobalNorm(0.5) if clip_on else None
    if name == "sgd":
        return mod.SGD(learning_rate=0.5, parameters=params,
                       grad_clip=grad_clip)
    if name == "momentum":
        return mod.Momentum(learning_rate=0.1, momentum=0.9,
                            parameters=params, grad_clip=grad_clip,
                            weight_decay=mod.L2Decay(1e-3))
    if name == "nesterov":
        return mod.Momentum(
            learning_rate=lrm.StepDecay(0.1, step_size=2, gamma=0.5),
            momentum=0.8, parameters=params, use_nesterov=True,
            rescale_grad=0.5, grad_clip=grad_clip)
    if name == "adam_l2":
        return mod.Adam(learning_rate=1e-4, parameters=params,
                        weight_decay=mod.L2Decay(1e-3), grad_clip=grad_clip)
    if name == "adamw_groups":
        # blocks.0 at twice the rate and without decay, the rest filtered
        # by name; a warm-up into a cosine schedule
        first = [p for n, p in zip(named, params) if ".blocks.0." in n]
        rest = [p for n, p in zip(named, params) if ".blocks.0." not in n]
        sched = lrm.LinearWarmup(lrm.CosineAnnealingDecay(2e-3, T_max=4),
                                 warmup_steps=2, start_lr=5e-4,
                                 end_lr=2e-3)
        return mod.AdamW(learning_rate=sched, weight_decay=0.05,
                         parameters=[{"params": first, "learning_rate": 2.0,
                                      "weight_decay": 0.0},
                                     {"params": rest}],
                         apply_decay_param_fun=named_fun(named, params),
                         grad_clip=grad_clip)
    raise ValueError(name)


def named_fun(named, params):
    """The decay filter for one package: the port's optimizer passes the
    structural name, the JAX one the parameter's own (`p.name`)."""
    by_own = {getattr(p, "name", None): n for n, p in zip(named, params)}
    return lambda nm: _no_decay(by_own.get(nm, nm))


def _batch():
    rs = np.random.RandomState(0)
    ids = rs.randint(0, _MODEL["vocab_size"], (2, 64)).astype(np.int32)
    lbl = rs.randint(0, _MODEL["vocab_size"], (2, 64)).astype(np.int32)
    return ids, lbl


@functools.lru_cache(maxsize=None)
def _run_pair(recipe, clip_on):
    """Five steps of one recipe in both packages (kept: the trajectory
    test reads two of them again)."""
    paddle.seed(7)
    jm = JaxGPT(JaxGPTConfig(**_MODEL))
    jnamed = list(jm.named_parameters())
    arrays = [(n, np.asarray(p._value)) for n, p in jnamed]
    tm = load_jax_params(GPTForPretraining(GPTConfig(**_MODEL),
                                           device="cpu"), arrays)
    names = [n for n, _ in jnamed]
    jo = _recipe(recipe, jax_opt, jax_lr, [p for _, p in jnamed], names,
                 clip_on, jax_clip)
    to = _recipe(recipe, opt_mod, lr, list(tm.parameters()), names,
                 clip_on, clip)
    jstep = paddle.jit.TrainStep(jm, lambda a, b: jm.loss(a, b), jo)
    tstep = TrainStep(tm, lambda a, b: tm.loss(a, b), to)
    ids, lbl = _batch()
    jids, jlbl = paddle.to_tensor(ids, "int32"), paddle.to_tensor(lbl,
                                                                   "int32")
    tids, tlbl = torch.from_numpy(ids), torch.from_numpy(lbl)
    jl, tl = [], []
    for _ in range(_STEPS):
        jl.append(float(np.asarray(jstep(jids, jlbl).numpy())))
        tl.append(float(tstep(tids, tlbl)))
        for o in (jo, to):
            if hasattr(o._learning_rate, "step"):
                o._learning_rate.step()
    return jm, tm, jl, tl, dict(arrays)


_RECIPES = ["sgd", "momentum", "nesterov", "adam_l2", "adamw_groups"]


@pytest.mark.parametrize("clip_on", [False, True], ids=["noclip", "clip"])
@pytest.mark.parametrize("recipe", _RECIPES)
def test_train_steps_track_jax(recipe, clip_on):
    jm, tm, jl, tl, init = _run_pair(recipe, clip_on)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    assert tl[-1] < tl[0]
    ref = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    moved = 0.0
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[n], rtol=0,
                                   atol=1e-4, err_msg=n)
        moved = max(moved, float(np.abs(ref[n] - init[n]).max()))
    assert moved > 3e-4          # more than the parameter bar


def test_clip_changes_the_trajectory():
    """The global-norm clip is active in the clipped runs above (the
    gradient norm exceeds 0.5), so the two trajectories differ."""
    _, _, _, plain, _ = _run_pair("sgd", False)
    _, _, _, clipped, _ = _run_pair("sgd", True)
    assert plain[0] == clipped[0] and plain[-1] != clipped[-1]


def test_group_lr_and_decay_filter_reach_the_update():
    tm = GPTForPretraining(GPTConfig(**_MODEL), device="cpu")
    names = [n for n, _ in tm.named_parameters()]
    o = _recipe("adamw_groups", opt_mod, lr, list(tm.parameters()), names,
                False, clip)
    o._bind_names(tm.named_parameters())
    p = dict(tm.named_parameters())
    assert o._param_lr(p["gpt.blocks.0.attn.qkv_proj.weight"]) == 2.0
    assert o._effective_decay(p["gpt.blocks.0.attn.qkv_proj.weight"]) == 0
    assert o._param_lr(p["gpt.blocks.1.attn.qkv_proj.weight"]) == 1.0
    assert o._effective_decay(p["gpt.blocks.1.attn.qkv_proj.weight"]) \
        == 0.05
    assert o._effective_decay(p["gpt.blocks.1.attn.qkv_proj.bias"]) == 0.0
    # an unnamed parameter cannot be filtered by name
    with pytest.raises(KeyError):
        opt_mod.AdamW(parameters=[torch.nn.Parameter(torch.ones(1))],
                      apply_decay_param_fun=_no_decay)._effective_decay(
            torch.nn.Parameter(torch.ones(1)))


def test_state_dict_and_jax_state_carry_a_run_on():
    """Two JAX steps, then the port takes the JAX weights and optimizer
    state (moments, beta powers, the scheduler) and both take three more:
    the port follows JAX as if it had run from the start; and a port
    optimizer rebuilt from the port's state_dict continues identically."""
    paddle.seed(9)
    jm = JaxGPT(JaxGPTConfig(**_MODEL))
    jnamed = list(jm.named_parameters())
    names = [n for n, _ in jnamed]
    jo = _recipe("adamw_groups", jax_opt, jax_lr, [p for _, p in jnamed],
                 names, True, jax_clip)
    jstep = paddle.jit.TrainStep(jm, lambda a, b: jm.loss(a, b), jo)
    ids, lbl = _batch()
    jids, jlbl = paddle.to_tensor(ids, "int32"), paddle.to_tensor(lbl,
                                                                   "int32")
    for _ in range(2):
        jstep(jids, jlbl)
        jo._learning_rate.step()
    tm = load_jax_params(
        GPTForPretraining(GPTConfig(**_MODEL), device="cpu"),
        [(n, np.asarray(p._value)) for n, p in jnamed])
    to = _recipe("adamw_groups", opt_mod, lr, list(tm.parameters()), names,
                 True, clip)
    load_jax_optimizer_state(to, tm.named_parameters(), jo, jnamed)
    assert to.get_lr() == jo.get_lr()
    tstep = TrainStep(tm, lambda a, b: tm.loss(a, b), to)
    tids, tlbl = torch.from_numpy(ids), torch.from_numpy(lbl)
    jl, tl = [], []
    for _ in range(3):
        jl.append(float(np.asarray(jstep(jids, jlbl).numpy())))
        tl.append(float(tstep(tids, tlbl)))
        jo._learning_rate.step()
        to._learning_rate.step()
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    ref = {n: np.asarray(p._value) for n, p in jnamed}
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[n], atol=1e-4,
                                   err_msg=n)
    # the port's own state dict: a rebuilt optimizer continues the same
    sd = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
          for k, v in to.state_dict().items()}
    assert "LR_Scheduler" in sd
    assert "gpt.wte.weight_moment1" in sd and "gpt.wte.weight_beta1_pow" in sd
    twin = load_jax_params(
        GPTForPretraining(GPTConfig(**_MODEL), device="cpu"),
        [(n, p.detach().numpy()) for n, p in tm.named_parameters()])
    to2 = _recipe("adamw_groups", opt_mod, lr, list(twin.parameters()),
                  names, True, clip)
    to2._bind_names(twin.named_parameters())
    to2.set_state_dict(sd)
    s1 = TrainStep(tm, lambda a, b: tm.loss(a, b), to)
    s2 = TrainStep(twin, lambda a, b: twin.loss(a, b), to2)
    for _ in range(2):
        assert float(s1(tids, tlbl)) == float(s2(tids, tlbl))
    for (n, a), (_, b) in zip(tm.named_parameters(),
                              twin.named_parameters()):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("cls,kw", [
    ("SGD", dict(weight_decay=None)),
    ("SGD", dict(weight_decay="l1")),
    ("Momentum", dict(weight_decay="l1", momentum=0.7)),
    ("Momentum", dict(weight_decay="l2", use_nesterov=True,
                      rescale_grad=2.0)),
    ("Adam", dict(weight_decay="l1")),
    ("Adam", dict(weight_decay="l2")),
], ids=["sgd", "sgd_l1", "momentum_l1", "nesterov_l2", "adam_l1",
        "adam_l2"])
def test_decay_rules_match_jax_eagerly(cls, kw):
    """Each rule and decay kind over three eager steps on f32
    parameters away from 0 (L1's sign is then the same on both sides;
    near 0 it is f32 noise, which Adam's normalisation would amplify)."""
    rs = np.random.RandomState(5)
    x0 = [(rs.randn(*s) + np.sign(rs.randn(*s)) * 2).astype(np.float32)
          for s in _SHAPES]
    decay = {None: None, "l1": 0.01, "l2": 0.01}[kw["weight_decay"]]

    def make(mod, params):
        args = dict(kw)
        if decay is not None:
            args["weight_decay"] = (mod.L1Decay if kw["weight_decay"] == "l1"
                                    else mod.L2Decay)(decay)
        return getattr(mod, cls)(learning_rate=0.05, parameters=params,
                                 **args)

    jps = [Parameter(jnp.asarray(x)) for x in x0]
    tps = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in x0]
    jo, to = make(jax_opt, jps), make(opt_mod, tps)
    for step in range(3):
        g = _grads(1.0, seed=20 + step)
        for jp, tp, gi in zip(jps, tps, g):
            jp.grad = Tensor(jnp.asarray(gi))
            tp.grad = torch.from_numpy(gi.copy())
        jo.step()
        to.step()
        for jp, tp in zip(jps, tps):
            np.testing.assert_allclose(tp.detach().numpy(),
                                       np.asarray(jp._value), rtol=1e-6,
                                       atol=1e-6)


# ---------------------------------------------------------------------------
# bf16 parameters with f32 masters

def _bf16_pair(kind):
    rs = np.random.RandomState(11)
    x0 = [(rs.randn(*s) * 0.5).astype(np.float32) for s in _SHAPES]
    jps = [Parameter(jnp.asarray(x, jnp.bfloat16)) for x in x0]
    tps = [torch.nn.Parameter(torch.from_numpy(x).bfloat16()) for x in x0]
    kw = {"momentum": dict(learning_rate=0.05, momentum=0.9),
          "adam_l2": dict(learning_rate=0.01, weight_decay=0.01),
          "adamw": dict(learning_rate=0.01, weight_decay=0.1)}[kind]
    cls = {"momentum": "Momentum", "adam_l2": "Adam", "adamw": "AdamW"}[kind]
    jo = getattr(jax_opt, cls)(parameters=jps, **kw)
    to = getattr(opt_mod, cls)(parameters=tps, **kw)
    return jps, tps, jo, to


def _step_both(jps, tps, jo, to, seed):
    rs = np.random.RandomState(seed)
    for jp, tp in zip(jps, tps):
        g = rs.randn(*tp.shape).astype(np.float32)
        jp.grad = Tensor(jnp.asarray(g, jnp.bfloat16))
        tp.grad = torch.from_numpy(g).bfloat16()
    jo.step()
    to.step()


def _check_masters(jps, tps, jo, to):
    for jp, tp in zip(jps, tps):
        jm = np.asarray(jo._states[id(jp)]["master"])
        tmast = to._states[id(tp)]["master"]
        assert tmast.dtype == torch.float32
        np.testing.assert_allclose(tmast.numpy(), jm, rtol=1e-5,
                                   atol=1e-7)
        # the parameter is its master's rounding
        assert tp.dtype == torch.bfloat16
        assert torch.equal(tp.detach(), tmast.bfloat16())


@pytest.mark.parametrize("kind", ["momentum", "adam_l2", "adamw"])
def test_bf16_masters_match_jax_and_self_heal(kind):
    jps, tps, jo, to = _bf16_pair(kind)
    for seed in range(4):
        _step_both(jps, tps, jo, to, seed)
    _check_masters(jps, tps, jo, to)
    # the master moved by less than a bf16 ulp in places: the parameter
    # alone would have lost those updates
    lost = [(to._states[id(tp)]["master"] - tp.detach().float()).abs().max()
            for tp in tps]
    assert max(float(x) for x in lost) > 0
    # a write to the parameters outside the optimizer (a restore)
    stale = [to._states[id(tp)]["master"].clone() for tp in tps]
    rs = np.random.RandomState(99)
    written = []
    for jp, tp in zip(jps, tps):
        v = rs.randn(*tp.shape).astype(np.float32)
        jp._value = jnp.asarray(v, jnp.bfloat16)
        with torch.no_grad():
            tp.copy_(torch.from_numpy(v))
        written.append(tp.detach().float().clone())
    _step_both(jps, tps, jo, to, 7)
    _check_masters(jps, tps, jo, to)
    for tp, old, w in zip(tps, stale, written):
        new = to._states[id(tp)]["master"]
        to_written = float((new - w).abs().max())
        to_stale = float((new - old).abs().max())
        if kind == "adamw":
            # the decoupled decay rounds the stale master into the
            # parameter before the check, so the outside write is lost,
            # as in the reference
            assert to_stale < to_written
        else:
            # the master restarted from the written parameter
            assert to_written < to_stale


def test_masters_only_for_low_precision_and_when_asked():
    f32 = torch.nn.Parameter(torch.ones(3))
    bf = torch.nn.Parameter(torch.ones(3, dtype=torch.bfloat16))
    o = opt_mod.AdamW(parameters=[f32, bf])
    assert "master" not in o._get_state(f32)
    assert o._get_state(bf)["master"].dtype == torch.float32
    o2 = opt_mod.Momentum(parameters=[bf], multi_precision=False)
    assert "master" not in o2._get_state(bf)
    assert "master" not in opt_mod.SGD(parameters=[bf])._get_state(bf)
