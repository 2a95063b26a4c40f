"""The port's MoE training path (paddle_tpu_torch.moe: router, MoEFFN,
GPTMoE, the TrainStep's routing stats) against the JAX package's, on
the CPU, from the same numpy inputs and the same weights.

- `route_top_k` at a capacity tight enough to drop choices: the integer
  maps (comb_slot, slot_token) equal, the floats within 1e-6;
- `MoEFFN` against the JAX `MoEFFN` with its Pallas kernels (interpret
  mode) and with its jnp fallback: output 1e-5, gradients 2e-5, as
  tests/test_moe.py holds the JAX layer against its reference;
- `GPTMoE.loss` with the aux and z losses folded in, weight loading and
  the initialiser;
- five f32 AdamW `TrainStep`s of a tiny GPTMoE against the JAX
  TrainStep, without drops (cf 2.0) and with them (cf 1.0): losses 1e-5
  relative, parameters 1e-4 absolute (one step's learning rate, as in
  tests/test_torch_train.py), the final routing stats 1e-5; one bf16 amp
  step within 1e-2.

Routing is discrete: a near-tie in the top-k or at a capacity edge,
broken differently by the two frameworks' f32 sums, would move a token
to another expert. These seeds route identically on both sides (the
map tests check it directly).
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu import amp as jax_amp
from paddle_tpu import optimizer as jax_opt
from paddle_tpu.moe import GPTMoE as JaxGPTMoE
from paddle_tpu.moe import GPTMoEConfig as JaxGPTMoEConfig
from paddle_tpu.moe import MoEFFN as JaxMoEFFN
from paddle_tpu.moe import router as jax_router
from paddle_tpu.moe import stats as jax_stats

from paddle_tpu_torch import amp
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.gpt import GPTForPretraining
from paddle_tpu_torch.moe import (GPTMoE, GPTMoEConfig, MoEFFN,
                                  capacity_for, gpt_moe_tiny_config,
                                  note_step_stats, route_top_k)
from paddle_tpu_torch.moe.router import router_stats_names
from paddle_tpu_torch.optimizer import AdamW

_MODEL = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
              max_seq_len=64, dropout=0.0, initializer_range=0.02,
              num_experts=4, expert_top_k=2)
_STEPS = 5
_LR, _WD = 1e-4, 0.01


def _np(t):
    return t.detach().float().numpy()


def _jnp(t):
    return np.asarray(t._value if hasattr(t, "_value") else t)


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [1, 2])
def test_route_top_k_matches_jax_with_drops(seed, k):
    n, E, C = 64, 4, 12
    logits = (np.random.RandomState(seed).randn(n, E) * 2.0).astype(
        np.float32)
    want = jax_router.route_top_k(jnp.asarray(logits), k, C)
    got = route_top_k(torch.from_numpy(logits), k, C)
    comb_w, comb_slot, slot_token, aux, z, stats = got
    assert comb_slot.dtype == torch.int32 and slot_token.dtype == torch.int32
    assert comb_slot.shape == (n, k) and slot_token.shape == (E * C,)
    np.testing.assert_array_equal(comb_slot.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(slot_token.numpy(), np.asarray(want[2]))
    for g, w in zip((comb_w, aux, z, stats),
                    (want[0], want[3], want[4], want[5])):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    assert float(stats[1]) > 0.0            # the capacity dropped choices
    assert int((slot_token == n).sum()) > 0 or k * n >= E * C


def test_route_ties_go_to_the_lowest_expert():
    logits = torch.zeros((3, 4))
    comb_w, comb_slot = route_top_k(logits, 2, 8)[:2]
    # every token picks experts 0 and 1, in token order
    assert comb_slot.tolist() == [[0, 8], [1, 9], [2, 10]]
    assert torch.equal(comb_w, torch.full((3, 2), 0.25))


@pytest.mark.parametrize("n,E,k,cf", [(8192, 8, 2, 1.25), (512, 8, 2, 1.25),
                                      (24, 4, 2, 2.0), (5, 8, 1, 0.1)])
def test_capacity_for_matches_jax(n, E, k, cf):
    assert capacity_for(n, E, k, cf) == jax_router.capacity_for(n, E, k, cf)
    assert capacity_for(8192, 8, 2, 1.25) == 2560


def test_stats_names_match_jax():
    assert router_stats_names() == jax_router.router_stats_names()


# ---------------------------------------------------------------------------
# layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("cf", [2.0, 0.75])
def test_moe_ffn_matches_jax(use_kernel, cf):
    """d 128 so the JAX Pallas path is eligible; cf 0.75 drops choices."""
    paddle.seed(0)
    kw = dict(hidden_size=128, ffn_hidden_size=64, num_heads=4,
              num_experts=4, expert_top_k=2, capacity_factor=cf)
    jm = JaxMoEFFN(JaxGPTMoEConfig(**kw), use_kernel=use_kernel)
    tm = load_jax_params(MoEFFN(GPTMoEConfig(**kw)),
                         [(n, _jnp(p)) for n, p in jm.named_parameters()])
    rs = np.random.RandomState(7)
    x = (rs.randn(24, 128) * 0.5).astype(np.float32)
    g = rs.randn(24, 128).astype(np.float32)

    jx = paddle.to_tensor(x)
    jx.stop_gradient = False
    jout = jm(jx)
    ((jout * paddle.to_tensor(g)).sum() + jm.aux_loss()
     + jm.z_loss()).backward()

    tx = torch.from_numpy(x).requires_grad_()
    tout = tm(tx)
    ((tout * torch.from_numpy(g)).sum() + tm.aux_loss()
     + tm.z_loss()).backward()

    np.testing.assert_allclose(_np(tout), _jnp(jout), rtol=0, atol=1e-5)
    for a, b in ((tm.aux_loss(), jm.aux_loss()), (tm.z_loss(), jm.z_loss()),
                 (tm.stats(), jm.stats())):
        np.testing.assert_allclose(_np(a), _jnp(b), rtol=1e-6, atol=1e-6)
    if cf < 1:
        assert float(tm.stats()[1]) > 0.0
    for name in ("w_gate", "w_in", "w_out"):
        np.testing.assert_allclose(
            _np(getattr(tm, name).grad), _jnp(getattr(jm, name).grad),
            rtol=0, atol=2e-5, err_msg=name)
    np.testing.assert_allclose(_np(tx.grad), _jnp(jx.grad), rtol=0,
                               atol=2e-5)


def test_moe_ffn_keeps_its_input_dtype_and_shape():
    cfg = GPTMoEConfig(hidden_size=64, ffn_hidden_size=32, num_heads=4,
                       num_experts=4)
    m = MoEFFN(cfg)
    for p in m.parameters():
        torch.nn.init.normal_(p, 0.0, 0.02)
    x = torch.randn(2, 5, 64)
    out = m(x)
    assert out.shape == x.shape and out.dtype == torch.float32
    assert m.stats().shape == (5,) and not m.stats().requires_grad


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def _models(**over):
    cfg = {**_MODEL, **over}
    paddle.seed(5)
    jm = JaxGPTMoE(JaxGPTMoEConfig(**cfg))
    arrays = [(n, _jnp(p)) for n, p in jm.named_parameters()]
    tm = load_jax_params(GPTMoE(GPTMoEConfig(**cfg), device="cpu"), arrays)
    return jm, tm, dict(arrays)


def _batch():
    rs = np.random.RandomState(0)
    ids = rs.randint(0, _MODEL["vocab_size"], (2, 64)).astype(np.int32)
    lbl = rs.randint(0, _MODEL["vocab_size"], (2, 64)).astype(np.int32)
    return ids, lbl


def test_gpt_moe_loss_includes_aux_and_z_like_jax(f32_run):
    """The loss at the initial weights against the JAX TrainStep's first
    loss (taken before its first update), and its composition: LM loss
    + 0.01 x mean aux + 1e-3 x mean z over the layers."""
    cf, (_, _, _, _, jl, _, init) = f32_run
    tm = load_jax_params(
        GPTMoE(GPTMoEConfig(**_MODEL, capacity_factor=cf), device="cpu"),
        init.items())
    tids, tlbl = (torch.from_numpy(a) for a in _batch())
    with torch.no_grad():
        tloss = float(tm.loss(tids, tlbl))
        lm = float(GPTForPretraining.loss(tm, tids, tlbl))
    np.testing.assert_allclose(tloss, jl[0], rtol=1e-5)
    layers = tm._moe_layers()
    assert len(layers) == 2 and tm.moe_num_experts == 4
    aux = sum(float(m.aux_loss()) for m in layers) / 2
    z = sum(float(m.z_loss()) for m in layers) / 2
    np.testing.assert_allclose(tloss, lm + 0.01 * aux + 1e-3 * z, rtol=1e-6)
    assert aux > 0.5 and z > 0.0
    stats = tm.collect_moe_stats()
    np.testing.assert_allclose(
        stats.numpy(), (layers[0].stats() + layers[1].stats()).numpy() / 2)


def test_load_jax_params_and_the_initialiser():
    jm, tm, arrays = _models()
    names = sorted(n for n, _ in tm.named_parameters())
    assert names == sorted(arrays)
    assert "gpt.blocks.1.mlp.w_in" in names
    for n, p in tm.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), arrays[n])
    # the port's own init: the expert weights and the gate are
    # N(0, initializer_range), as the JAX MoEFFN's initialiser draws them
    big = GPTMoE(GPTMoEConfig(**{**_MODEL, "hidden_size": 256}),
                 device="cpu", seed=3)
    for name in ("w_gate", "w_in", "w_out"):
        for b in range(2):
            p = getattr(big.gpt.blocks[b].mlp, name).detach()
            assert abs(float(p.mean())) < 2e-3, name
            assert abs(float(p.std()) / 0.02 - 1) < 0.05, name
            jp = arrays[f"gpt.blocks.{b}.mlp.{name}"]
            assert abs(float(jp.std()) / 0.02 - 1) < 0.1, name


def test_tiny_config_and_hooks():
    cfg = gpt_moe_tiny_config()
    assert (cfg.hidden_size, cfg.num_experts, cfg.capacity_factor) == \
        (64, 4, 2.0)
    assert cfg.use_flash_attention is False     # the JAX tiny config's
    m = GPTMoE(cfg, device="cpu")
    assert all(isinstance(b.mlp, MoEFFN) for b in m.gpt.blocks)
    assert m.collect_moe_stats() is None
    dense = GPTForPretraining(cfg, device="cpu")
    assert not any(isinstance(b.mlp, MoEFFN) for b in dense.gpt.blocks)


# ---------------------------------------------------------------------------
# training step
# ---------------------------------------------------------------------------

def _steps(cf, amp_on, n_steps):
    jm, tm, init = _models(capacity_factor=cf)
    jo = jax_opt.AdamW(learning_rate=_LR, weight_decay=_WD,
                       parameters=jm.parameters())
    to = AdamW(learning_rate=_LR, weight_decay=_WD,
               parameters=tm.parameters())

    def jloss(ids, lbl):
        with jax_amp.auto_cast(enable=amp_on, dtype="bfloat16"):
            return jm.loss(ids, lbl)

    def tloss(ids, lbl):
        with amp.auto_cast(enable=amp_on, dtype="bfloat16"):
            return tm.loss(ids, lbl)

    jstep = paddle.jit.TrainStep(jm, jloss, jo)
    tstep = TrainStep(tm, tloss, to)
    ids, lbl = _batch()
    jb = (paddle.to_tensor(ids, "int32"), paddle.to_tensor(lbl, "int32"))
    tb = (torch.from_numpy(ids), torch.from_numpy(lbl))
    jl, tl = [], []
    for _ in range(n_steps):
        jl.append(float(np.asarray(jstep(*jb).numpy())))
        tl.append(float(tstep(*tb)))
    return jm, tm, jstep, tstep, jl, tl, init


@pytest.fixture(scope="module", params=[2.0, 1.0], ids=["cf2", "cf1-drops"])
def f32_run(request):
    return request.param, _steps(request.param, False, _STEPS)


def test_five_f32_steps_track_the_jax_losses(f32_run):
    cf, (_, _, _, tstep, jl, tl, _) = f32_run
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    assert tl[-1] < tl[0]
    dropped = float(tstep._last_moe[1])
    assert (dropped > 0.0) == (cf < 2.0)


def test_final_parameters_track_the_jax_parameters(f32_run):
    _, (jm, tm, _, _, _, _, init) = f32_run
    ref = {n: _jnp(p) for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[n], rtol=0,
                                   atol=1e-4, err_msg=n)
    for name in ("w_gate", "w_in", "w_out"):
        n = f"gpt.blocks.0.mlp.{name}"
        assert np.abs(ref[n] - init[n]).max() > 3e-4, n


def test_last_moe_stats_track_jax(f32_run):
    _, (_, _, jstep, tstep, _, _, _) = f32_run
    got = tstep._last_moe
    assert got.shape == (5,) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(jstep._last_moe),
                               rtol=1e-5, atol=1e-5)
    fields = note_step_stats(None, got, 4)
    want = jax_stats.note_step_stats(_Window(), np.asarray(jstep._last_moe),
                                     4)
    assert fields.keys() == want.keys()
    for key in fields:
        assert abs(fields[key] - want[key]) <= 1e-5, key


class _Window:
    def __init__(self):
        self.noted = {}

    def note(self, **kw):
        self.noted.update(kw)


def test_note_step_stats_clamps_jitter_only():
    win = _Window()
    f = note_step_stats(win, torch.tensor([math.log(4) + 5e-5, 1.00005, 1.2,
                                           1.1, 3.0]), 4)
    assert win.noted == f
    assert f["moe_entropy"] == round(math.log(4), 6)
    assert f["moe_dropped_frac"] == 1.0 and f["moe_num_experts"] == 4
    # a producer bug beyond the jitter band is kept as it is
    assert note_step_stats(None, [0.1, 1.5, 1, 1, 1], 4)[
        "moe_dropped_frac"] == 1.5
    assert note_step_stats(None, [0.1, float("nan"), 1, 1, 1], 4) is None
    assert note_step_stats(None, [1, 2, 3], 4) is None
    assert note_step_stats(None, None, 4) is None


def test_one_bf16_amp_step_tracks_jax_with_an_f32_moe_body():
    jm, tm, jstep, tstep, jl, tl, _ = _steps(1.0, True, 1)
    assert abs(tl[0] - jl[0]) < 1e-2
    # under amp the MoE body sees the residual stream's f32 (ln2's
    # output) and returns f32, as the JAX body runs raw jnp outside amp
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: seen.append((args[0].dtype, out.dtype)))
        for m in tm._moe_layers()]
    with torch.no_grad(), amp.auto_cast(dtype="bfloat16"):
        tm(torch.from_numpy(_batch()[0]))
    for h in hooks:
        h.remove()
    assert seen == [(torch.float32, torch.float32)] * 2
