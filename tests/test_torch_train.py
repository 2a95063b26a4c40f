"""The port's training step (paddle_tpu_torch.jit.TrainStep with AdamW
over GPTForPretraining.loss) against the JAX package's, on the CPU.

A tiny GPT (2 layers, hidden 128, 4 heads, vocab 512, seq 64, init 0.02)
gets the JAX model's weights through `load_jax_params`; both take five
AdamW(1e-4, weight decay 0.01) steps on the same ids and labels in f32.
Every step's loss must agree within 1e-5 relative, and the final
parameters within 1e-4 absolute — one step's learning rate: Adam turns
f32 noise in a near-zero gradient into up to one step of update, while a
wrong update rule misses by many steps. One bf16 amp step must give a
loss within 1e-2 of the JAX step's.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu import amp as jax_amp
from paddle_tpu import optimizer as jax_opt
from paddle_tpu.core.tensor import Parameter, Tensor
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.telemetry import mfu as jax_mfu

from paddle_tpu_torch import amp
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.telemetry import (device_peak_flops,
                                        gpt_train_flops_per_token)

_MODEL = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
              max_seq_len=64, dropout=0.0, initializer_range=0.02)
_STEPS = 5
_LR, _WD = 1e-4, 0.01


def _batch():
    rs = np.random.RandomState(0)
    ids = rs.randint(0, _MODEL["vocab_size"], (2, 64)).astype(np.int32)
    lbl = rs.randint(0, _MODEL["vocab_size"], (2, 64)).astype(np.int32)
    return ids, lbl


def _pair(amp_on):
    """Fresh JAX and port train steps over the same weights."""
    paddle.seed(5)
    jm = JaxGPT(JaxGPTConfig(**_MODEL))
    arrays = [(n, np.asarray(p._value)) for n, p in jm.named_parameters()]
    jo = jax_opt.AdamW(learning_rate=_LR, weight_decay=_WD,
                       parameters=jm.parameters())

    def jloss(ids, lbl):
        with jax_amp.auto_cast(enable=amp_on, dtype="bfloat16"):
            return jm.loss(ids, lbl)

    tm = load_jax_params(GPTForPretraining(GPTConfig(**_MODEL),
                                           device="cpu"), arrays)
    to = AdamW(learning_rate=_LR, weight_decay=_WD,
               parameters=tm.parameters())

    def tloss(ids, lbl):
        with amp.auto_cast(enable=amp_on, dtype="bfloat16"):
            return tm.loss(ids, lbl)

    return (jm, paddle.jit.TrainStep(jm, jloss, jo)), \
        (tm, TrainStep(tm, tloss, to)), dict(arrays)


@pytest.fixture(scope="module")
def f32_run():
    (jm, jstep), (tm, tstep), init = _pair(amp_on=False)
    ids, lbl = _batch()
    jids, jlbl = paddle.to_tensor(ids, "int32"), paddle.to_tensor(lbl,
                                                                   "int32")
    tids, tlbl = torch.from_numpy(ids), torch.from_numpy(lbl)
    jl, tl = [], []
    for _ in range(_STEPS):
        jl.append(float(np.asarray(jstep(jids, jlbl).numpy())))
        tl.append(tstep(tids, tlbl))
    return jm, tm, jl, [float(x) for x in tl], tl, init


def test_five_f32_steps_track_the_jax_losses(f32_run):
    _, _, jl, tl, _, _ = f32_run
    assert len(tl) == _STEPS
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    # the steps do train: the loss falls
    assert tl[-1] < tl[0]


def test_final_parameters_track_the_jax_parameters(f32_run):
    jm, tm, _, _, _, init = f32_run
    ref = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    assert sorted(ref) == sorted(init)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[n], rtol=0,
                                   atol=1e-4, err_msg=n)
        # every parameter moved by more than the tolerance (five steps of
        # 1e-4 each), so the comparison tells the rules apart
        assert np.abs(ref[n] - init[n]).max() > 3e-4, n


def test_train_step_returns_a_detached_scalar(f32_run):
    _, tm, _, _, raw, _ = f32_run
    assert all(t.dim() == 0 and not t.requires_grad for t in raw)
    assert all(p.grad is not None for p in tm.parameters())


def test_one_bf16_amp_step_tracks_jax():
    (jm, jstep), (tm, tstep), _ = _pair(amp_on=True)
    ids, lbl = _batch()
    jloss = float(np.asarray(jstep(paddle.to_tensor(ids, "int32"),
                                   paddle.to_tensor(lbl, "int32")).numpy()))
    tloss = tstep(torch.from_numpy(ids), torch.from_numpy(lbl))
    assert tloss.dtype == torch.float32
    assert abs(float(tloss) - jloss) < 1e-2
    # under amp the head emits bf16 logits; outside it, f32
    with torch.no_grad():
        with amp.auto_cast(dtype="bfloat16"):
            assert tm(torch.from_numpy(ids)).dtype == torch.bfloat16
        assert tm(torch.from_numpy(ids)).dtype == torch.float32


def test_amp_lists_equal_the_jax_lists():
    assert amp._DEFAULT_WHITE == jax_amp._DEFAULT_WHITE
    assert amp._DEFAULT_BLACK == jax_amp._DEFAULT_BLACK
    with amp.auto_cast(custom_white_list={"layer_norm"},
                       custom_black_list={"matmul"}), \
            jax_amp.auto_cast(custom_white_list={"layer_norm"},
                              custom_black_list={"matmul"}):
        assert amp.white_black_list() == jax_amp.white_black_list()
        assert amp.amp_op_dtype("layer_norm", torch.float32) \
            == torch.bfloat16
    assert not amp.amp_state().enabled
    x = torch.ones(2)
    assert amp.maybe_cast_to_compute(x, "linear") is x
    with amp.auto_cast():
        assert amp.maybe_cast_to_compute(x, "linear").dtype == torch.bfloat16
        assert amp.maybe_cast_to_compute(x.bfloat16(), "sum").dtype \
            == torch.float32
        assert amp.maybe_cast_to_compute(x, "gelu") is x


@pytest.mark.parametrize("opt_name,wd", [("AdamW", 0.01), ("Adam", 0.01),
                                         ("Adam", 0.0)])
def test_adam_bias_correction_matches_jax_over_three_steps(opt_name, wd):
    rs = np.random.RandomState(1)
    x0 = rs.randn(4, 3).astype(np.float32)
    grads = [rs.randn(4, 3).astype(np.float32) * s for s in (1.0, 1e-3, 5)]
    jp = Parameter(jnp.asarray(x0))
    jo = getattr(jax_opt, opt_name)(learning_rate=0.1, weight_decay=wd,
                                    parameters=[jp])
    tp = torch.nn.Parameter(torch.from_numpy(x0.copy()))
    to = {"AdamW": AdamW, "Adam": Adam}[opt_name](
        learning_rate=0.1, weight_decay=wd, parameters=[tp])
    for g in grads:
        jp.grad = Tensor(jnp.asarray(g))
        jo.step()
        tp.grad = torch.from_numpy(g)
        to.step()
        np.testing.assert_allclose(tp.detach().numpy(),
                                   np.asarray(jp._value), rtol=1e-6,
                                   atol=1e-7)
    st = to._states[id(tp)]
    np.testing.assert_allclose(st["beta1_pow"], 0.9 ** 4, rtol=1e-6)
    np.testing.assert_allclose(st["moment2"].numpy(),
                               np.asarray(jo._states[id(jp)]["moment2"]),
                               rtol=1e-6)


def test_mfu_formula_and_peaks():
    cfg = GPTConfig.gpt3_125m()
    n = 124_000_000
    assert gpt_train_flops_per_token(cfg, 1024, n) \
        == jax_mfu.model_flops_per_token(n, 12, 768, 1024)
    assert device_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert device_peak_flops("NVIDIA H100 PCIe") == 756e12
    assert device_peak_flops("cpu") is None
