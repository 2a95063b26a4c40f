"""The port's fused projection + cross entropy
(paddle_tpu_torch.ops.fused_ce) against the JAX op, on the CPU on one
device (no mesh), and the GPT loss behind the `use_fused_ce` flag.

- loss, dh and dw against `paddle_tpu.ops.fused_ce` within 1e-5 in f32
  (chunked online log-sum-exp; the same sums in another order), with
  ignored and out-of-range labels, several chunk counts and a vocab that
  no count > 1 divides;
- bf16 h over an f32 table: each chunk's logits round to bf16 in both
  (torch rounds each f32 sum once; XLA's CPU dot rounds on its own
  schedule), so loss, dh and dw agree within 2e-2 of their scale, one
  bf16 rounding;
- against the port's unfused `cross_entropy` over the full logits
  (1e-5);
- `GPTForPretraining.loss` with the flag on: the JAX model's fused loss
  (1e-5) and every parameter's gradient (1e-4 of its scale: the
  backward sums over tokens and blocks in another order), the unfused
  loss (1e-5);
- the flag registry's get/set rules and its environment variables.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.flags import set_flags as jax_set_flags
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.ops.fused_ce import _pick_chunks as jax_pick_chunks
from paddle_tpu.ops.fused_ce import fused_linear_cross_entropy as jax_fce

from paddle_tpu_torch import flags
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.fused_ce import (_pick_chunks,
                                           fused_linear_cross_entropy)


@pytest.fixture(scope="module", autouse=True)
def _no_jax_mesh():
    """The JAX references run on one device with no mesh; a JAX test
    file run earlier in this worker may have left its global mesh
    installed (`--dist loadfile`)."""
    from paddle_tpu.distributed import env as jax_env
    prev = jax_env.current_mesh()
    jax_env.set_mesh(None)
    yield
    jax_env.set_mesh(prev)


def _inputs(n, d, v, seed=0, bad=True):
    rs = np.random.RandomState(seed)
    h = rs.randn(n, d).astype(np.float32)
    w = (rs.randn(v, d) * 0.3).astype(np.float32)
    lbl = rs.randint(0, v, (n,)).astype(np.int32)
    if bad:
        lbl[3] = -100           # ignored
        lbl[7] = v + 5          # out of range: ignored too
    dl = rs.rand(n).astype(np.float32)
    return h, w, lbl, dl


def _jax_ref(h, w, lbl, dl, n_chunks=None, hdtype=jnp.float32):
    def f(hh, ww):
        return jnp.sum(jax_fce(hh, ww, jnp.asarray(lbl), n_chunks)
                       * jnp.asarray(dl))
    hh = jnp.asarray(h, hdtype)
    loss = jax_fce(hh, jnp.asarray(w), jnp.asarray(lbl), n_chunks)
    dh, dw = jax.grad(f, argnums=(0, 1))(hh, jnp.asarray(w))
    return (np.asarray(loss), np.asarray(dh.astype(jnp.float32)),
            np.asarray(dw))


def _port(h, w, lbl, dl, n_chunks=None, hdtype=torch.float32):
    th = torch.from_numpy(h).to(hdtype).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    loss = fused_linear_cross_entropy(th, tw, torch.from_numpy(lbl),
                                      n_chunks)
    (loss * torch.from_numpy(dl)).sum().backward()
    assert loss.dtype == torch.float32
    assert th.grad.dtype == hdtype and tw.grad.dtype == torch.float32
    return (loss.detach().numpy(), th.grad.float().numpy(),
            tw.grad.numpy())


def _close(got, ref, rtol):
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("n,d,v,n_chunks", [
    (64, 32, 96, None),     # 16 chunks of 6
    (64, 32, 96, 4),
    (48, 16, 50, None),     # 2 chunks of 25
    (40, 24, 97, None),     # prime vocab: one chunk
    (33, 8, 120, 12),
])
def test_f32_loss_and_grads_match_jax(n, d, v, n_chunks):
    args = _inputs(n, d, v, seed=n + v)
    ref = _jax_ref(*args, n_chunks)
    got = _port(*args, n_chunks)
    for g, r in zip(got, ref):
        _close(g, r, 1e-5)
    assert got[0][3] == 0.0 and got[0][7] == 0.0
    # an ignored token contributes no gradient
    assert not got[1][3].any() and not got[1][7].any()


def test_pick_chunks_is_the_reference_rule():
    for v in (50304, 50257, 32000, 96, 97, 1, 24, 36):
        assert _pick_chunks(v) == jax_pick_chunks(v)
    assert _pick_chunks(50304) == 16


def test_bf16_h_over_an_f32_table_matches_jax():
    args = _inputs(64, 32, 96, seed=1)
    ref = _jax_ref(*args, hdtype=jnp.bfloat16)
    got = _port(*args, hdtype=torch.bfloat16)
    for g, r in zip(got, ref):
        _close(g, r, 2e-2)


def test_matches_the_unfused_cross_entropy():
    h, w, lbl, dl = _inputs(64, 32, 96, seed=2)
    got = _port(h, w, lbl, dl)
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    logits = th @ tw.t()
    lab = torch.from_numpy(lbl).long()
    lab[7] = -100       # cross_entropy ignores only ignore_index
    loss = F.cross_entropy(logits, lab, reduction="none")
    (loss * torch.from_numpy(dl)).sum().backward()
    for g, r in zip(got, (loss.detach().numpy(), th.grad.numpy(),
                          tw.grad.numpy())):
        _close(g, r, 1e-5)


_MODEL = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
              max_seq_len=32, dropout=0.0, initializer_range=0.2)


@pytest.fixture
def fused_flag():
    flags.set_flags({"use_fused_ce": True})
    jax_set_flags({"use_fused_ce": True})
    try:
        yield
    finally:
        flags.set_flags({"use_fused_ce": False})
        jax_set_flags({"use_fused_ce": False})


def test_gpt_loss_under_the_flag_matches_jax_and_the_unfused_loss(
        fused_flag):
    paddle.seed(3)
    jm = JaxGPT(JaxGPTConfig(use_flash_attention=False, **_MODEL))
    arrays = [(n, np.asarray(p._value)) for n, p in jm.named_parameters()]
    tm = load_jax_params(GPTForPretraining(GPTConfig(**_MODEL),
                                           device="cpu"), arrays)
    rs = np.random.RandomState(4)
    ids = rs.randint(0, 512, (2, 32)).astype(np.int32)
    lbl = rs.randint(0, 512, (2, 32)).astype(np.int32)
    jloss = jm.loss(paddle.to_tensor(ids, "int32"),
                    paddle.to_tensor(lbl, "int32"))
    jloss.backward()
    tloss = tm.loss(torch.from_numpy(ids), torch.from_numpy(lbl))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(np.asarray(
        jloss.numpy())), rtol=1e-5)
    jgrads = {n: np.asarray(p.grad._value) for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        _close(p.grad.numpy(), jgrads[n], 1e-4)
    flags.set_flags({"use_fused_ce": False})
    with torch.no_grad():
        plain = tm.loss(torch.from_numpy(ids), torch.from_numpy(lbl))
    np.testing.assert_allclose(float(plain), float(tloss.detach()),
                               rtol=1e-5)


def test_flags_registry():
    assert flags.get_flag("use_fused_ce") is False
    flags.set_flags({"FLAGS_use_fused_ce": "true"})
    try:
        assert flags.get_flag("use_fused_ce") is True
    finally:
        flags.set_flags({"use_fused_ce": 0})
    with pytest.raises(ValueError):
        flags.set_flags({"no_such_flag": 1})
    with pytest.raises(TypeError):
        flags.set_flags([("use_fused_ce", 1)])



def test_flags_read_the_environment(monkeypatch):
    monkeypatch.setenv("FLAGS_use_fused_ce", "1")
    try:
        flags._init_from_env()
        assert flags.get_flag("use_fused_ce") is True
        monkeypatch.setenv("FLAGS_use_fused_ce", "off")
        flags._init_from_env()
        assert flags.get_flag("use_fused_ce") is False
    finally:
        flags.set_flags({"use_fused_ce": False})
