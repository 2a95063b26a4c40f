"""The port's seven remaining update rules (Adamax, Adagrad, Adadelta,
RMSProp, Lamb, LarsMomentum, DGCMomentum) against the JAX package, on the
CPU, from the same numpy inputs.

- The constructors: the JAX signatures (names, order, defaults) for the
  seven rules and the four wrappers.
- Eager `step()`s of each rule over f32 and bf16 parameters with L2 and
  L1 decay and a parameter `regularizer` (Lamb and LarsMomentum take no
  `weight_decay`: the regularizer only), plus RMSProp centered with
  momentum, Adagrad's initial accumulator, Lamb's exclusion by name and
  DGC before and after its rampup and with Nesterov: f32 parameters
  within 1e-6 relative + 1e-6 absolute (the same f32 operations, fused
  differently); bf16 parameters within one bf16 step (2^-7 relative:
  an f32 result an ulp apart may round to the neighbouring bf16 value)
  and equal in at least 99 % of the elements.
- DGC at a sparsity whose threshold is tied: every tied magnitude
  steps, as in the JAX rule, so more than k entries leave the residual.
- Five f32 `TrainStep`s of a tiny GPT per rule, clip on and off, against
  the JAX `TrainStep`: losses 1e-5 relative, parameters 1e-4 absolute,
  the bars of tests/test_torch_clip_optim.py.
- Lamb through `OffloadTrainStep` against the JAX `OffloadTrainStep`:
  losses 1e-5 relative, parameters 1e-4.
- The JAX optimizer's state of each rule, taken after two steps, carries
  the port's run on for three more (1e-5 / 1e-4); the port's state dict
  has the JAX keys (`<name>_velocity`, `<name>_step`, `<name>__wd`, ...).
"""
import functools
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu import distributed as jax_dist
from paddle_tpu import optimizer as jax_opt
from paddle_tpu.core.tensor import Parameter, Tensor
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.nn import clip as jax_clip

from paddle_tpu_torch import optimizer as opt_mod
from paddle_tpu_torch.convert import load_jax_optimizer_state, load_jax_params
from paddle_tpu_torch.distributed import OffloadTrainStep
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
from paddle_tpu_torch.nn import clip

_NEW = ["Adamax", "Adagrad", "Adadelta", "RMSProp", "Lamb", "LarsMomentum",
        "DGCMomentum", "ExponentialMovingAverage", "ModelAverage",
        "Lookahead", "GradientMerge"]


@pytest.mark.parametrize("name", _NEW)
def test_signatures_are_the_jax_ones(name):
    def params(cls):
        return [(p.name, p.default, p.kind) for p in
                inspect.signature(cls.__init__).parameters.values()]

    assert params(getattr(opt_mod, name)) == params(getattr(jax_opt, name))
    assert name in opt_mod.__all__


# ---------------------------------------------------------------------------
# eager steps

_SHAPES = [(4, 3), (7,), (2, 5, 3), (1,), (6, 6)]
_NAMES = [f"w{i}" for i in range(len(_SHAPES))]


def _no_decay(name):
    return name in ("w1", "w3")


def _make(mod, case, decay, params, names):
    """The optimizer of `case` from one package; `params` in the order of
    `names`; the port gets (name, parameter) pairs."""
    cls, kw = _CASES[case]
    kw = dict(kw)
    if decay in ("l1", "l2"):
        kw["weight_decay"] = (mod.L1Decay if decay == "l1"
                              else mod.L2Decay)(0.01)
    if cls == "Lamb":
        if mod is jax_opt:
            by_id = {id(p): n for n, p in zip(names, params)}
            kw["exclude_from_weight_decay_fn"] = \
                lambda p: _no_decay(by_id[id(p)])
        else:
            kw["exclude_from_weight_decay_fn"] = _no_decay
    plist = params if mod is jax_opt else list(zip(names, params))
    return getattr(mod, cls)(parameters=plist, **kw)


_CASES = {
    "adamax": ("Adamax", dict(learning_rate=0.05, beta2=0.99)),
    "adagrad": ("Adagrad", dict(learning_rate=0.05,
                                initial_accumulator_value=0.1)),
    "adadelta": ("Adadelta", dict(learning_rate=1.0, rho=0.9)),
    "rmsprop": ("RMSProp", dict(learning_rate=0.01, rho=0.9)),
    "rmsprop_centered": ("RMSProp", dict(learning_rate=0.01, rho=0.9,
                                         momentum=0.5, centered=True)),
    "lamb": ("Lamb", dict(learning_rate=0.05, lamb_weight_decay=0.1)),
    "lars": ("LarsMomentum", dict(learning_rate=0.5, momentum=0.9,
                                  lars_coeff=0.02, lars_weight_decay=0.01)),
    "dgc": ("DGCMomentum", dict(learning_rate=0.05, momentum=0.9,
                                sparsity=0.75, rampup_begin_step=1)),
    "dgc_nesterov": ("DGCMomentum", dict(learning_rate=0.05, momentum=0.8,
                                         sparsity=0.6, rampup_begin_step=2,
                                         use_nesterov=True)),
}
_EAGER = [(c, d) for c in _CASES for d in
          (("reg",) if c in ("lamb", "lars") else ("l2", "l1", "reg"))]


def _set_grads(jps, tps, seed, dtype):
    rs = np.random.RandomState(seed)
    for jp, tp in zip(jps, tps):
        g = rs.randn(*tp.shape).astype(np.float32)
        jp.grad = Tensor(jnp.asarray(g, jp._value.dtype))
        tp.grad = torch.from_numpy(g).to(dtype)


def _eager_pair(case, decay, dtype, x0):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jps = [Parameter(jnp.asarray(x, jdt)) for x in x0]
    tps = [torch.nn.Parameter(torch.from_numpy(x.copy()).to(dtype))
           for x in x0]
    if decay == "reg":
        # a regularizer on two parameters overrides the optimizer's decay
        for i in (0, 2):
            jps[i].regularizer = jax_opt.L2Decay(0.05)
            tps[i].regularizer = opt_mod.L2Decay(0.05)
    return (jps, tps, _make(jax_opt, case, decay, jps, _NAMES),
            _make(opt_mod, case, decay, tps, _NAMES))


def _close(tps, jps, dtype):
    for jp, tp in zip(jps, tps):
        got = tp.detach().float().numpy()
        ref = np.asarray(jnp.asarray(jp._value, jnp.float32))
        if dtype == torch.float32:
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
        else:
            assert tp.dtype == torch.bfloat16
            np.testing.assert_allclose(got, ref, rtol=2.0 ** -7, atol=1e-6)
            assert np.mean(got == ref) >= 0.99


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case,decay", _EAGER,
                         ids=[f"{c}-{d}" for c, d in _EAGER])
def test_rules_match_jax_eagerly(case, decay, dtype):
    """Four eager steps on parameters away from 0 (L1's sign is then the
    same on both sides)."""
    rs = np.random.RandomState(5)
    x0 = [(rs.randn(*s) + np.sign(rs.randn(*s)) * 2).astype(np.float32)
          for s in _SHAPES]
    jps, tps, jo, to = _eager_pair(case, decay, dtype, x0)
    for step in range(4):
        _set_grads(jps, tps, 20 + step, dtype)
        jo.step()
        to.step()
        _close(tps, jps, dtype)
    moved = max(float(np.abs(tp.detach().float().numpy() - x).max())
                for tp, x in zip(tps, x0))
    assert moved > 1e-3
    # no master for these rules: the state is f32 and the parameter
    # keeps its dtype
    for tp in tps:
        st = to._states[id(tp)]
        assert "master" not in st and tp.dtype == dtype
        assert all(v.dtype == torch.float32 for v in st.values()
                   if isinstance(v, torch.Tensor))


def test_lamb_excludes_by_name_and_rmsprop_centered_keeps_mean_grad():
    _, tps, _, to = _eager_pair("lamb", "reg", torch.float32,
                                [np.ones(s, np.float32) for s in _SHAPES])
    wd = [to._get_state(p)["_wd"] for p in tps]
    assert wd == [np.float32(x) for x in (0.1, 0.0, 0.1, 0.0, 0.1)]
    # an exclusion function needs the parameter's name
    with pytest.raises(KeyError):
        opt_mod.Lamb(parameters=[torch.nn.Parameter(torch.ones(2))],
                     exclude_from_weight_decay_fn=_no_decay)._get_state(
            torch.nn.Parameter(torch.ones(2)))
    p = torch.nn.Parameter(torch.ones(3))
    assert set(opt_mod.RMSProp(0.1, centered=True, parameters=[p])
               ._get_state(p)) == {"mean_square", "momentum", "mean_grad"}
    assert set(opt_mod.RMSProp(0.1, parameters=[p])._get_state(p)) \
        == {"mean_square", "momentum"}
    acc = opt_mod.Adagrad(0.1, parameters=[p],
                          initial_accumulator_value=0.25)._get_state(p)
    assert torch.equal(acc["moment"], torch.full((3,), 0.25))


@pytest.mark.parametrize("nesterov", [False, True])
def test_dgc_ties_at_the_threshold_all_step(nesterov):
    """|g| = [3, 2, 2, 2, 1, 0.5, 0.25, 0.1] with k = 2 (sparsity 0.75):
    the threshold is 2 and all three 2s pass it, so four entries step
    and leave the residual; at the second step the residual's 1 has
    grown to a fifth 2."""
    g = np.array([3, -2, 2, -2, 1, -0.5, 0.25, 0.1], np.float32)
    jp = Parameter(jnp.zeros(8, jnp.float32))
    tp = torch.nn.Parameter(torch.zeros(8))
    kw = dict(learning_rate=0.1, momentum=0.9, sparsity=0.75,
              use_nesterov=nesterov)
    jo = jax_opt.DGCMomentum(parameters=[jp], **kw)
    to = opt_mod.DGCMomentum(parameters=[tp], **kw)
    stepped = []
    for _ in range(2):
        jp.grad = Tensor(jnp.asarray(g))
        tp.grad = torch.from_numpy(g.copy())
        jo.step()
        to.step()
        np.testing.assert_allclose(tp.detach().numpy(),
                                   np.asarray(jp._value), rtol=1e-6,
                                   atol=1e-7)
        res = to._states[id(tp)]["residual"]
        np.testing.assert_allclose(
            res.numpy(), np.asarray(jo._states[id(jp)]["residual"]),
            rtol=1e-6)
        stepped.append(int((res == 0).sum()))
    assert stepped == [4, 5]
    step = to._states[id(tp)]["step"]
    assert step == 2 and isinstance(step, int)


# ---------------------------------------------------------------------------
# five TrainSteps of a tiny GPT per rule

_MODEL = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
              max_seq_len=64, dropout=0.0, initializer_range=0.02)
_STEPS = 5


def _model_no_decay(name):
    return name.endswith(".bias") or ".ln" in name


def _recipe(name, mod, params, names, clip_on, clip_mod):
    """The optimizer of recipe `name` from one package's modules."""
    grad_clip = clip_mod.ClipGradByGlobalNorm(0.5) if clip_on else None
    if name == "adamax":
        # the keys' bias has an exactly zero gradient; its f32 rounding
        # noise differs between the frameworks, and a rule that steps by
        # m / max(b2 u, |g| + eps) amplifies it by lr / eps: eps 1e-6
        # keeps that under the parameter bar
        return mod.Adamax(learning_rate=2e-3, epsilon=1e-6,
                          parameters=params,
                          weight_decay=mod.L2Decay(1e-3),
                          grad_clip=grad_clip)
    if name == "adagrad":
        return mod.Adagrad(1e-2, parameters=params, grad_clip=grad_clip,
                           initial_accumulator_value=0.1)
    if name == "adadelta":
        return mod.Adadelta(learning_rate=1.0, rho=0.9, parameters=params,
                            grad_clip=grad_clip)
    if name == "rmsprop":
        return mod.RMSProp(1e-3, rho=0.9, momentum=0.9, centered=True,
                           parameters=params, grad_clip=grad_clip)
    if name == "lamb":
        if mod is jax_opt:
            by_id = {id(p): n for n, p in zip(names, params)}
            fn = lambda p: _model_no_decay(by_id[id(p)])    # noqa: E731
        else:
            fn = _model_no_decay
        return mod.Lamb(learning_rate=1e-2, lamb_weight_decay=0.01,
                        parameters=params, grad_clip=grad_clip,
                        exclude_from_weight_decay_fn=fn)
    if name == "lars":
        return mod.LarsMomentum(learning_rate=1.0, momentum=0.9,
                                lars_coeff=0.01, parameters=params,
                                grad_clip=grad_clip)
    if name == "dgc":
        return mod.DGCMomentum(learning_rate=0.2, momentum=0.9,
                               sparsity=0.9, rampup_begin_step=2,
                               use_nesterov=True, parameters=params,
                               grad_clip=grad_clip)
    raise ValueError(name)


_RECIPES = ["adamax", "adagrad", "adadelta", "rmsprop", "lamb", "lars",
            "dgc"]


def _batch():
    rs = np.random.RandomState(0)
    ids = rs.randint(0, _MODEL["vocab_size"], (2, 64)).astype(np.int32)
    lbl = rs.randint(0, _MODEL["vocab_size"], (2, 64)).astype(np.int32)
    return ids, lbl


def _pair(recipe, clip_on, seed):
    """The JAX model and optimizer, and the port's from the same weights."""
    paddle.seed(seed)
    jm = JaxGPT(JaxGPTConfig(**_MODEL))
    jnamed = list(jm.named_parameters())
    arrays = [(n, np.asarray(p._value)) for n, p in jnamed]
    tm = load_jax_params(GPTForPretraining(GPTConfig(**_MODEL),
                                           device="cpu"), arrays)
    names = [n for n, _ in jnamed]
    jo = _recipe(recipe, jax_opt, [p for _, p in jnamed], names, clip_on,
                 jax_clip)
    to = _recipe(recipe, opt_mod, list(tm.parameters()), names, clip_on,
                 clip)
    return jm, tm, jo, to, dict(arrays)


def _steps(jstep, tstep, n):
    ids, lbl = _batch()
    jids, jlbl = paddle.to_tensor(ids, "int32"), paddle.to_tensor(lbl,
                                                                   "int32")
    tids, tlbl = torch.from_numpy(ids), torch.from_numpy(lbl)
    jl, tl = [], []
    for _ in range(n):
        jl.append(float(np.asarray(jstep(jids, jlbl).numpy())))
        tl.append(float(tstep(tids, tlbl)))
    return jl, tl


def _params_close(jm, tm, atol=1e-4):
    ref = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[n], rtol=0,
                                   atol=atol, err_msg=n)
    return ref


@pytest.mark.parametrize("clip_on", [False, True], ids=["noclip", "clip"])
@pytest.mark.parametrize("recipe", _RECIPES)
def test_train_steps_track_jax(recipe, clip_on):
    jm, tm, jo, to, init = _pair(recipe, clip_on, 7)
    jl, tl = _steps(paddle.jit.TrainStep(jm, lambda a, b: jm.loss(a, b), jo),
                    TrainStep(tm, lambda a, b: tm.loss(a, b), to), _STEPS)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    assert tl[-1] < tl[0]
    ref = _params_close(jm, tm)
    moved = max(float(np.abs(ref[n] - init[n]).max()) for n in ref)
    assert moved > 3e-4          # more than the parameter bar


@functools.lru_cache(maxsize=None)
def _jax_state_keys(recipe):
    jm, _, jo, _, _ = _pair(recipe, False, 9)
    for p in jm.parameters():
        jo._get_state(p)
    return {n: set(jo._states[id(p)]) for n, p in jm.named_parameters()}


@pytest.mark.parametrize("recipe", _RECIPES)
def test_jax_state_carries_a_run_on(recipe):
    """Two JAX steps, then the port takes the JAX weights and optimizer
    state (moments, beta powers, Lamb's decays, DGC's residuals and step
    counts) and both take three more: the port follows JAX as if it had
    run from the start. The port's state dict has the JAX keys."""
    jm, _, jo, _, _ = _pair(recipe, True, 9)
    jnamed = list(jm.named_parameters())
    names = [n for n, _ in jnamed]
    jstep = paddle.jit.TrainStep(jm, lambda a, b: jm.loss(a, b), jo)
    ids, lbl = _batch()
    for _ in range(2):
        jstep(paddle.to_tensor(ids, "int32"), paddle.to_tensor(lbl, "int32"))
    tm = load_jax_params(
        GPTForPretraining(GPTConfig(**_MODEL), device="cpu"),
        [(n, np.asarray(p._value)) for n, p in jnamed])
    to = _recipe(recipe, opt_mod, list(tm.parameters()), names, True, clip)
    load_jax_optimizer_state(to, tm.named_parameters(), jo, jnamed)
    if recipe == "dgc":
        assert to._states[id(tm.gpt.wte.weight)]["step"] == 2
    jl, tl = _steps(jstep, TrainStep(tm, lambda a, b: tm.loss(a, b), to), 3)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _params_close(jm, tm)
    sd = to.state_dict()
    want = {f"{n}_{k}" for n, ks in _jax_state_keys(recipe).items()
            for k in ks}
    assert set(sd) == want
    # the port's own state dict rebuilds the same states, each host
    # scalar in its type (DGC's step an int, the rest f32)
    twin = _recipe(recipe, opt_mod, list(tm.parameters()), names, True,
                   clip)
    twin._bind_names(tm.named_parameters())
    twin.set_state_dict({k: (v.clone() if isinstance(v, torch.Tensor)
                             else v) for k, v in sd.items()})
    for k, v in twin.state_dict().items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, sd[k]), k
        else:
            assert v == sd[k] and type(v) is type(sd[k]), k


def test_lamb_through_the_offloaded_step_tracks_jax():
    """K = 2 micro-steps a round, two rounds, Lamb's whole-tensor norms
    over each chunk's parameters."""
    model = dict(vocab_size=256, hidden_size=64, num_layers=3, num_heads=4,
                 max_seq_len=64, dropout=0.0, use_flash_attention=False)
    paddle.seed(3)
    jm = JaxGPT(JaxGPTConfig(remat=True, **model))
    jnamed = list(jm.named_parameters())
    tm = load_jax_params(GPTForPretraining(GPTConfig(remat=True, **model),
                                           device="cpu"),
                         [(n, np.asarray(p._value)) for n, p in jnamed])
    names = [n for n, _ in jnamed]
    jo = _recipe("lamb", jax_opt, [p for _, p in jnamed], names, False,
                 jax_clip)
    to = _recipe("lamb", opt_mod, list(tm.parameters()), names, False, clip)
    js = jax_dist.OffloadTrainStep(jm, lambda a, b: jm.loss(a, b), jo,
                                   accumulate_steps=2, chunk_bytes=200_000)
    ts = OffloadTrainStep(tm, lambda a, b: tm.loss(a, b), to,
                          accumulate_steps=2, chunk_bytes=200_000)
    assert len(ts._chunks) > 3 and ts._chunks == js._chunks
    jl, tl = [], []
    for r in range(2):
        rs = np.random.RandomState(10 + r)
        ids = rs.randint(0, 256, (4, 32)).astype(np.int32)
        lbl = rs.randint(0, 256, (4, 32)).astype(np.int32)
        for i in range(2):
            a, b = ids[2 * i:2 * i + 2], lbl[2 * i:2 * i + 2]
            jl.append(float(np.asarray(js(paddle.to_tensor(a, "int32"),
                                          paddle.to_tensor(b, "int32"))
                                       .numpy())))
            tl.append(float(ts(torch.from_numpy(a), torch.from_numpy(b))))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _params_close(jm, tm)
    st = to._states[id(tm.gpt.wte.weight)]
    np.testing.assert_allclose(st["beta1_pow"], 0.9 ** 3, rtol=1e-6)
