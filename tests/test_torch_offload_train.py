"""The port's OffloadTrainStep, per-block recompute and GPT options
against the JAX package, on the CPU (mirroring tests/test_offload_train.py).

A tiny GPT (3 layers, hidden 64, 4 heads, vocab 256, the composed
attention) gets the JAX model's weights; both packages take K = 2
micro-steps a round with AdamW, over two rounds (the second update reads
the states the first left):
- the port's `_chunks` equal the JAX step's (the same packing rule);
- f32, remat on: every micro-step's loss within 1e-5 relative of the
  JAX OffloadTrainStep's, the parameters within 1e-4 absolute (one
  step's learning rate, as in tests/test_torch_train.py); and against
  the port's full-batch `TrainStep`: the mean of the micro losses 1e-5,
  the parameters 1e-4;
- bf16 device parameters with f32 masters: every parameter bf16 and its
  master's rounding; losses within 1e-3 relative (a tenth of bf16's
  step: the bf16 forward rounds in other places in the two
  frameworks); masters: 99 % of the elements within a tenth of the
  rate, 1e-4, and all within 4e-3, four times the rate: where a
  gradient is near zero its bf16 rounding decides the sign of Adam's
  step, so each of the two updates can move an element one rate up on
  one side and one down on the other;
- no `grad_clip` in the offloaded step, as in the reference;
- remat changes no number on the CPU, and the recompute runs under the
  caller's amp policy also when the backward runs on another thread (as
  the autograd engine's device thread does on the card).
"""
import threading

import numpy as np
import pytest
import torch
import torch.utils.checkpoint

import paddle_tpu as paddle
from paddle_tpu import distributed as jax_dist
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.nn import clip as jax_clip

from paddle_tpu_torch import amp, nn
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.distributed import (OffloadTrainStep,
                                          RecomputeSequential, recompute)
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
from paddle_tpu_torch.optimizer import AdamW

_MODEL = dict(vocab_size=256, hidden_size=64, num_layers=3, num_heads=4,
              max_seq_len=64, dropout=0.0, use_flash_attention=False)
_K = 2
_LR = 1e-3


def _models(seed, remat=True):
    paddle.seed(seed)
    jm = JaxGPT(JaxGPTConfig(remat=remat, **_MODEL))
    arrays = [(n, np.asarray(p._value)) for n, p in jm.named_parameters()]
    tm = load_jax_params(GPTForPretraining(GPTConfig(remat=remat, **_MODEL),
                                           device="cpu"), arrays)
    return jm, tm


def _data(B=4, S=32, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, 256, (B, S)).astype(np.int32),
            rs.randint(0, 256, (B, S)).astype(np.int32))


def _offload_pair(seed, param_dtype=None, chunk_bytes=200_000, clip=None):
    jm, tm = _models(seed)
    jo = paddle.optimizer.AdamW(learning_rate=_LR, weight_decay=0.01,
                                parameters=jm.parameters(),
                                grad_clip=None if clip is None
                                else jax_clip.ClipGradByGlobalNorm(clip))
    to = AdamW(learning_rate=_LR, weight_decay=0.01,
               parameters=tm.parameters(), grad_clip=None if clip is None
               else nn.clip.ClipGradByGlobalNorm(clip))
    js = jax_dist.OffloadTrainStep(jm, lambda a, b: jm.loss(a, b), jo,
                                   accumulate_steps=_K,
                                   param_dtype=param_dtype,
                                   chunk_bytes=chunk_bytes)
    ts = OffloadTrainStep(tm, lambda a, b: tm.loss(a, b), to,
                          accumulate_steps=_K, param_dtype=param_dtype,
                          chunk_bytes=chunk_bytes)
    return (jm, jo, js), (tm, to, ts)


def _rounds(step, rounds, framework):
    """Two micro-batches of 2 a round, new data every round; -> the
    micro-steps' losses."""
    losses = []
    for r in range(rounds):
        ids, lbl = _data(seed=10 + r)
        for i in range(_K):
            a, b = ids[2 * i:2 * i + 2], lbl[2 * i:2 * i + 2]
            if framework == "jax":
                out = step(paddle.to_tensor(a, "int32"),
                           paddle.to_tensor(b, "int32"))
                losses.append(float(np.asarray(out.numpy())))
            else:
                losses.append(float(step(torch.from_numpy(a),
                                         torch.from_numpy(b))))
    return losses


def _params_close(jm, tm, atol):
    ref = {n: np.asarray(p._value, np.float32)
           for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().float().numpy(), ref[n],
                                   rtol=0, atol=atol, err_msg=n)


@pytest.mark.parametrize("param_dtype", [None, "bfloat16"])
def test_chunks_match_jax(param_dtype):
    (_, _, js), (_, _, ts) = _offload_pair(1, param_dtype)
    assert len(ts._chunks) > 3
    assert ts._chunks == js._chunks
    assert ts.pinned_bytes == 0          # the CPU: no pinned copy
    one = _offload_pair(1, param_dtype, chunk_bytes=1 << 30)[1][2]
    assert one._chunks == [list(range(len(one.params)))]


def test_f32_remat_matches_jax_offload_and_the_full_batch_step():
    (jm, _, js), (tm, to, ts) = _offload_pair(3)
    jl, tl = _rounds(js, 2, "jax"), _rounds(ts, 2, "torch")
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _params_close(jm, tm, 1e-4)
    # the accumulators are zero after each update
    assert all(not a.any() for a in ts._acc)
    # the port's full-batch TrainStep over the same data
    _, fm = _models(3)
    fs = TrainStep(fm, lambda a, b: fm.loss(a, b),
                   AdamW(learning_rate=_LR, weight_decay=0.01,
                         parameters=fm.parameters()))
    full = []
    for r in range(2):
        ids, lbl = _data(seed=10 + r)
        full.append(float(fs(torch.from_numpy(ids), torch.from_numpy(lbl))))
    np.testing.assert_allclose([np.mean(tl[:2]), np.mean(tl[2:])], full,
                               rtol=1e-5)
    for (n, a), (_, b) in zip(tm.named_parameters(), fm.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=0, atol=1e-4, err_msg=n)
    # the second round's update read the first's moments
    st = to._states[id(tm.gpt.wte.weight)]
    np.testing.assert_allclose(st["beta1_pow"], 0.9 ** 3, rtol=1e-6)


def test_an_update_only_every_kth_micro_step():
    (_, _, _), (tm, to, ts) = _offload_pair(4)
    before = [p.detach().clone() for p in ts.params]
    ids, lbl = _data()
    ts(torch.from_numpy(ids[:2]), torch.from_numpy(lbl[:2]))
    assert all(torch.equal(a, b) for a, b in zip(before, ts.params))
    assert any(a.any() for a in ts._acc)
    assert all(p.grad is None for p in ts.params)    # dropped once added
    ts(torch.from_numpy(ids[2:]), torch.from_numpy(lbl[2:]))
    assert not all(torch.equal(a, b) for a, b in zip(before, ts.params))


def test_bf16_params_with_masters_track_jax():
    (jm, jo, js), (tm, to, ts) = _offload_pair(7, "bfloat16")
    assert all(p.dtype == torch.bfloat16 for p in ts.params)
    assert all("master" in to._states[id(p)] for p in ts.params)
    jl, tl = _rounds(js, 2, "jax"), _rounds(ts, 2, "torch")
    assert all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    jnamed = dict(jm.named_parameters())
    gaps = []
    for n, p in tm.named_parameters():
        m = to._states[id(p)]["master"]
        assert m.dtype == torch.float32
        assert torch.equal(p.detach(), m.bfloat16()), n
        ref = np.asarray(jo._states[id(jnamed[n])]["master"])
        np.testing.assert_allclose(m.numpy(), ref, rtol=0, atol=4 * _LR,
                                   err_msg=n)
        gaps.append(np.abs(m.numpy() - ref).ravel())
    assert np.quantile(np.concatenate(gaps), 0.99) <= _LR / 10


def test_no_grad_clip_in_the_offloaded_step():
    """The reference's OffloadTrainStep leaves the optimizer's grad_clip
    unapplied; the port holds that: a clip that would bind changes
    nothing here, and the result still follows the JAX step."""
    (jm, _, js), (tm, _, ts) = _offload_pair(5, clip=1e-3)
    jl, tl = _rounds(js, 1, "jax"), _rounds(ts, 1, "torch")
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _params_close(jm, tm, 1e-4)
    (_, _, _), (um, _, us) = _offload_pair(5)
    _rounds(us, 1, "torch")
    for a, b in zip(tm.parameters(), um.parameters()):
        assert torch.equal(a, b)


def test_remat_changes_no_number_and_matches_jax():
    ids, lbl = _data(B=2, S=16, seed=4)
    grads, losses = [], []
    for remat in (False, True):
        jm, tm = _models(9, remat)
        loss = tm.loss(torch.from_numpy(ids), torch.from_numpy(lbl))
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append([p.grad.clone() for p in tm.parameters()])
    jl = jm.loss(paddle.to_tensor(ids, "int32"),      # the JAX remat loss
                 paddle.to_tensor(lbl, "int32"))
    np.testing.assert_allclose(losses[-1], float(np.asarray(jl.numpy())),
                               rtol=1e-5)
    assert losses[0] == losses[1]
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def _amp_block_grads(run_backward, wrap):
    """Gradients of one bf16-amp block applied through `wrap`, its
    backward run by `run_backward`."""
    torch.manual_seed(0)
    cfg = GPTConfig(**_MODEL)
    from paddle_tpu_torch.models.gpt import GPTBlock
    block = GPTBlock(cfg)
    with torch.no_grad():
        for n, p in block.named_parameters():
            if ".ln" not in n and not n.startswith("ln"):
                p.normal_(0.0, 0.2)
    x = torch.randn(2, 16, 64, requires_grad=True)
    with amp.auto_cast(dtype="bfloat16"):
        y = wrap(block, x)
    run_backward(y.float().square().sum())
    return [x.grad] + [p.grad for p in block.parameters()]


def _on_another_thread(loss):
    """loss.backward() on a new thread (where amp is off); its exception
    is raised here."""
    errors = []

    def run():
        try:
            loss.backward()
        except Exception as e:  # noqa: BLE001 — handed to the caller
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    if errors:
        raise errors[0]


def test_recompute_runs_under_the_callers_amp_policy():
    plain = _amp_block_grads(lambda l: l.backward(), lambda b, x: b(x))
    here = _amp_block_grads(lambda l: l.backward(), recompute)
    there = _amp_block_grads(_on_another_thread, recompute)
    for a, b, c in zip(plain, here, there):
        assert torch.equal(a, b) and torch.equal(a, c)
    # what the policy capture prevents: a bare checkpoint recomputes the
    # block in f32 on a thread where amp is off, which torch refuses
    with pytest.raises(torch.utils.checkpoint.CheckpointError,
                       match="different metadata"):
        _amp_block_grads(_on_another_thread, lambda b, x: (
            torch.utils.checkpoint.checkpoint(b, x, use_reentrant=False)))


def test_recompute_sequential_matches_the_plain_stack():
    torch.manual_seed(1)
    layers = [torch.nn.Linear(8, 8) for _ in range(4)]
    x = torch.randn(3, 8, requires_grad=True)
    y1 = RecomputeSequential(layers, interval=2)(x)
    y1.sum().backward()
    g1 = [x.grad.clone()] + [p.grad.clone() for m in layers
                             for p in m.parameters()]
    x.grad = None
    for m in layers:
        m.zero_grad()
    y2 = x
    for m in layers:
        y2 = m(y2)
    y2.sum().backward()
    g2 = [x.grad] + [p.grad for m in layers for p in m.parameters()]
    assert torch.equal(y1, y2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_flash_switch_and_the_128k_preset():
    cfg = dict(_MODEL, use_flash_attention=True)
    a = GPTForPretraining(GPTConfig(**cfg), device="cpu", seed=2)
    b = GPTForPretraining(GPTConfig(**_MODEL), device="cpu", seed=2)
    ids = torch.from_numpy(_data(B=2, S=24)[0])
    with torch.no_grad():
        np.testing.assert_allclose(a(ids).numpy(), b(ids).numpy(),
                                   rtol=1e-5, atol=1e-5)
    ref = JaxGPTConfig.gpt3_1_3b_128k()
    got = GPTConfig.gpt3_1_3b_128k(num_layers=1, vocab_size=64)
    for k in ("hidden_size", "num_heads", "max_seq_len",
              "sequence_parallel", "remat"):
        assert getattr(got, k) == getattr(ref, k), k
    small = dict(num_layers=1, vocab_size=64, hidden_size=64, num_heads=4,
                 max_seq_len=128)
    m = GPTForPretraining(GPTConfig.gpt3_1_3b_128k(**small), device="cpu",
                          seed=4)
    # with no mesh the preset's ring attention is the usual attention,
    # as the JAX model falls through when sp is 1
    plain = GPTForPretraining(GPTConfig.gpt3_1_3b_128k(
        sequence_parallel=None, **small), device="cpu", seed=4)
    with torch.no_grad():
        assert torch.equal(m(ids), plain(ids))
