"""The port's GPT-3 13B weight-only-int8 recipe
(paddle_tpu_torch.tools.serve_13b_w8a16) against the JAX package's
tools/serve_13b_w8a16.py, on the CPU at a tiny width, from the same
weights and the same numpy inputs.

- `GPTConfig.gpt3_13b` field for field against the JAX preset;
- the piecewise build (a meta skeleton, each piece drawn, quantized,
  cast and moved in turn) against a whole f32 build prepared the same
  way: every parameter and buffer bit for bit;
- the recipe's route (2 layers, hidden 128, 4 heads of 32, vocab 512)
  in f32 through the port and through the JAX steps (`quantize_weights_
  int8` on the f32 model, `generate`): int8 codes and scales
  bit-identical, greedy tokens identical; in bf16 (floats cast, the f32
  scales kept, as the recipe moves them) the greedy tokens meet the
  teacher-forced bar against the JAX wo8 model's f32 forward;
- the depth witness of chip_smoke.py's serve_13b phase on the CPU: at
  width 512 (4 heads of 128) with 13B's per-layer gain at init 0.04
  (the same init times sqrt(5120 / 512)), the same weights at depths 1
  and 8 through the JAX steps and the port's plain versions: both bf16
  routes fall away from the f32 forward with depth, each within 0.1 of
  the other, while the port's f32 route holds the bar at depth 8;
- K7's plain version at the 13B width (8 rows of 5120, f32 and bf16)
  against the JAX `fused_add_layer_norm` and `fused_add_layer_norm_pair`
  in Pallas interpret mode: out at the registry's tolerance, the carry
  bit for bit.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.ops import pallas_layernorm as jax_ln
from paddle_tpu.quant import quantize_weights_int8 as jax_quantize

from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
from paddle_tpu_torch.ops.kernel_registry import (get_kernel, kernels,
                                                  reset_launches)
from paddle_tpu_torch.ops.layernorm import layernorm_fused_pair
from paddle_tpu_torch.quant import WeightOnlyInt8Linear
from paddle_tpu_torch.tools.serve_13b_w8a16 import (build_w8a16,
                                                    config_13b, decode,
                                                    prepare_w8a16,
                                                    prompt_ids,
                                                    serving_bytes)

_TINY = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
             max_seq_len=64, dropout=0.0)
# the teacher-forced bar of chip_smoke.py: the bf16 token is the f32
# argmax at >= 95 % of positions and never trails the f32 best logit by
# more than 0.25 standard deviations of that position's logits
_TF_AGREE, _TF_MARGIN_STD = 0.95, 0.25


def test_gpt3_13b_preset_matches_jax():
    kw = dict(max_seq_len=256, dropout=0.0, dtype="bfloat16")
    got = vars(GPTConfig.gpt3_13b(**kw))
    want = vars(JaxGPTConfig.gpt3_13b(**kw))
    assert got == want
    assert (got["hidden_size"], got["num_layers"], got["num_heads"],
            got["ffn_hidden_size"], got["vocab_size"]) == (5120, 40, 40,
                                                          20480, 50304)
    assert vars(config_13b()) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_piecewise_build_is_a_whole_build(dtype):
    cfg = GPTConfig(**_TINY, dtype="bfloat16")
    got, seconds = build_w8a16(cfg, seed=3, device="cpu", dtype=dtype)
    assert set(seconds) == {"build", "quantize", "move"}
    whole = GPTForPretraining(GPTConfig(**_TINY), device="cpu", seed=3)
    prepare_w8a16(whole, "cpu", dtype)
    want = whole.state_dict()
    have = got.state_dict()
    assert list(have) == list(want)
    for name, t in have.items():
        assert t.dtype == want[name].dtype and torch.equal(t, want[name]), \
            name
    # the serving set: int8 linears, floats in the decode dtype, the f32
    # scales as they are; the KV cache takes the config's dtype
    lin = [m for m in got.modules() if isinstance(m, WeightOnlyInt8Linear)]
    assert len(lin) == 4 * _TINY["num_layers"]
    assert all(m.wq.dtype == torch.int8 and m.w_scale.dtype == torch.float32
               for m in lin)
    assert all(p.dtype == getattr(torch, dtype) for p in got.parameters())
    assert got.gpt.init_cache(1, 8)[0][0].dtype == torch.bfloat16
    assert serving_bytes(got) == serving_bytes(whole)


def _pair(init_range):
    """The JAX model (f32, as the recipe builds it) and the port's with
    its weights."""
    paddle.seed(5)
    jm = JaxGPT(JaxGPTConfig(initializer_range=init_range, **_TINY))
    tm = GPTForPretraining(GPTConfig(initializer_range=init_range, **_TINY),
                           device="cpu")
    load_jax_params(tm, [(n, np.asarray(p._value))
                         for n, p in jm.named_parameters()])
    return jm, tm


@pytest.fixture(scope="module")
def route():
    jm, tm = _pair(0.2)
    assert jax_quantize(jm) == 4 * _TINY["num_layers"]
    prepare_w8a16(tm, "cpu", dtype=None)
    ids = prompt_ids(_TINY["vocab_size"], batch=2, length=16, seed=0)
    return jm, tm, ids


def test_recipe_route_codes_match_jax(route):
    jm, tm, _ = route
    jbufs = {n: np.asarray(b._value) for n, b in jm.named_buffers()}
    tbufs = dict(tm.named_buffers())
    assert sorted(jbufs) == sorted(tbufs) and len(jbufs) == 16
    for n, b in tbufs.items():
        assert b.dtype == (torch.int8 if n.endswith(".wq")
                           else torch.float32), n
        np.testing.assert_array_equal(b.numpy(), jbufs[n], err_msg=n)


def test_recipe_route_greedy_matches_jax_f32(route):
    jm, tm, ids = route
    jo, _ = jm.generate(paddle.to_tensor(ids.numpy().astype(np.int32)),
                        max_new_tokens=24, dtype=None)
    reset_launches()
    to, secs = decode(tm, ids, 24, dtype=None)
    assert all(k.launches == 0 for k in kernels())     # plain versions
    want = np.asarray(jo.numpy())
    assert len(set(want[:, 16:].ravel().tolist())) > 4  # streams vary
    np.testing.assert_array_equal(to.numpy(), want)
    assert secs > 0


def test_recipe_bf16_route_meets_teacher_forced_bar():
    """The recipe proper: floats cast to bf16 before the move, decoded
    in bf16, against the same wo8 weights' f32 forward (the JAX model)."""
    jm, tm = _pair(0.1)
    jax_quantize(jm)
    prepare_w8a16(tm, "cpu", dtype="bfloat16")
    assert tm.gpt.wte.weight.dtype == torch.bfloat16
    ids = prompt_ids(_TINY["vocab_size"], batch=4, length=16, seed=1)
    out, _ = decode(tm, ids, 32)
    full = out.numpy().astype(np.int32)
    logits = np.asarray(jm(paddle.to_tensor(full)).numpy())[:, 15:-1]
    toks = full[:, 16:]
    best = logits.max(axis=-1)
    mine = np.take_along_axis(logits, toks[..., None], -1)[..., 0]
    trail = (best - mine) / logits.std(axis=-1, ddof=1)
    agree = (logits.argmax(axis=-1) == toks).mean()
    assert len(set(toks.ravel().tolist())) > 8         # streams vary
    assert agree >= _TF_AGREE and trail.max() <= _TF_MARGIN_STD, (
        agree, trail.max())


def _teacher_forced(jm, out, s0):
    """(agreement, worst trail in std) of the tokens after `s0` in `out`
    against the JAX model's f32 forward: the teacher-forced bar's terms."""
    full = out.astype(np.int32)
    logits = np.asarray(jm(paddle.to_tensor(full)).numpy())[:, s0 - 1:-1]
    toks = full[:, s0:]
    best = logits.max(axis=-1)
    mine = np.take_along_axis(logits, toks[..., None], -1)[..., 0]
    trail = (best - mine) / logits.std(axis=-1, ddof=1)
    return (logits.argmax(axis=-1) == toks).mean(), trail.max()


def test_bf16_route_departs_with_depth_as_jax_does():
    """bf16 rounding grown through depth, in both frameworks alike: what
    the serve_13b witness separates from a fault of the port."""
    width, init = 512, 0.04 * (5120 / 512) ** 0.5
    agree = {}
    for depth in (1, 8):
        kw = dict(vocab_size=4096, hidden_size=width, num_layers=depth,
                  num_heads=4, max_seq_len=128, dropout=0.0,
                  initializer_range=init)
        paddle.seed(5)
        jm = JaxGPT(JaxGPTConfig(**kw))
        tm = GPTForPretraining(GPTConfig(**kw), device="cpu")
        load_jax_params(tm, [(n, np.asarray(p._value))
                             for n, p in jm.named_parameters()])
        jax_quantize(jm)
        prepare_w8a16(tm, "cpu", dtype=None)
        ids = prompt_ids(kw["vocab_size"], batch=4, length=32, seed=1)
        if depth == 8:
            f32, _ = decode(tm, ids, 32, dtype=None)
            a, t = _teacher_forced(jm, f32.numpy(), 32)
            assert a >= _TF_AGREE and t <= _TF_MARGIN_STD, (a, t)
        jo, _ = jm.generate(paddle.to_tensor(ids.numpy().astype(np.int32)),
                            max_new_tokens=32)
        to, _ = decode(tm, ids, 32)
        for name, out in (("jax", np.asarray(jo.numpy())), ("port",
                                                            to.numpy())):
            assert len(set(out[:, 32:].ravel().tolist())) > 64
            agree[name, depth] = _teacher_forced(jm, out, 32)[0]
    for name in ("jax", "port"):
        assert agree[name, 8] < agree[name, 1] - 0.25, agree
    for depth in (1, 8):
        assert abs(agree["port", depth] - agree["jax", depth]) <= 0.1, agree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k7_plain_at_13b_width_matches_jax(dtype):
    rows, d = 8, 5120
    rs = np.random.RandomState(13)
    x, r = (rs.randn(rows, d).astype(np.float32) for _ in range(2))
    w = (1 + 0.1 * rs.randn(d)).astype(np.float32)
    b = (0.1 * rs.randn(d)).astype(np.float32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jx, jr, jw, jb = (jnp.asarray(a, jd) for a in (x, r, w, b))
    ref_y = jax_ln.fused_add_layer_norm(jx, jr, jw, jb, 1e-5)
    ref_y2, ref_h = jax_ln.fused_add_layer_norm_pair(jx, jr, jw, jb, 1e-5)
    td = getattr(torch, dtype)
    tx, tr, tw, tb = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                      .to(td) for a in (jx, jr, jw, jb))
    reset_launches()
    y, h = layernorm_fused_pair(tx, tr, tw, tb, 1e-5)
    assert get_kernel("layernorm_fused").launches == 0
    rtol, atol = get_kernel("layernorm_fused").tol[dtype]
    for want in (ref_y, ref_y2):
        np.testing.assert_allclose(
            y.float().numpy(), np.asarray(want.astype(jnp.float32)),
            rtol=rtol, atol=atol)
    bits = np.int32 if dtype == "float32" else np.int16
    np.testing.assert_array_equal(
        h.view(torch.int32 if dtype == "float32" else torch.int16).numpy(),
        np.array(ref_h).view(bits))
