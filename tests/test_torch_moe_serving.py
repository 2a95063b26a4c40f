"""GPT-MoE served through the port's engine and `generate` against the
JAX package's `ServingEngine` and `run_generate`, on the CPU in f32, from
the same weights (a tiny GPTMoE: 2 layers, 4 experts, top-2).

Both engines route every row their fixed-shape steps carry: idle slots
in a decode step, the padding of a prefill chunk. Capacity follows from
that padded row count, and the GShard order (first choices over the rows
in index order, then second choices) decides which real token is
dropped, so the streams are identical only if the port routes exactly
the rows the JAX engine routes. The bar is port engine = JAX engine and
port `generate` = JAX `run_generate`; the engine is not held to
`generate`, whose capacity comes from other row counts. The engines have
more slots than requests, and one case runs at a capacity factor that
drops choices (checked on the port's side; the small decode steps drop
some at 1.25 too). The five `moe.*` gauges
equal the JAX monitor's after each side's forward of the same batch.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import monitor as jax_monitor
from paddle_tpu.moe import GPTMoE as JaxGPTMoE
from paddle_tpu.moe import GPTMoEConfig as JaxGPTMoEConfig
from paddle_tpu.moe import stats as jax_stats
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import ServingEngine as JaxServingEngine

from paddle_tpu_torch import monitor
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.moe import GPTMoE, GPTMoEConfig, MoEFFN
from paddle_tpu_torch.moe import note_step_stats
from paddle_tpu_torch.ops.kernel_registry import kernels, reset_launches
from paddle_tpu_torch.serving import SamplingParams, ServingEngine

_MODEL = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
              max_seq_len=128, dropout=0.0, initializer_range=0.2,
              num_experts=4, expert_top_k=2)
# more slots than the requests below, so decode steps route idle rows
_ENGINE = dict(max_slots=6, block_size=8, prefill_chunk=8,
               max_model_len=64, dtype=None)
_GAUGES = ("moe.entropy", "moe.dropped_frac", "moe.overflow",
           "moe.aux_loss", "moe.z_loss")


def _pair(cf):
    paddle.seed(21)
    jm = JaxGPTMoE(JaxGPTMoEConfig(use_flash_attention=False,
                                   capacity_factor=cf, **_MODEL))
    tm = GPTMoE(GPTMoEConfig(capacity_factor=cf, **_MODEL), device="cpu")
    load_jax_params(tm, [(n, np.asarray(p._value))
                         for n, p in jm.named_parameters()])
    return jm, tm


@pytest.fixture(scope="module", params=[1.25, 0.5], ids=["cf1.25",
                                                          "cf0.5_drops"])
def pair(request):
    return request.param, _pair(request.param)


def _dropped_fracs(model):
    """Record every MoEFFN forward's dropped fraction of `model`."""
    seen = []
    for m in model.modules():
        if isinstance(m, MoEFFN):
            m.register_forward_hook(
                lambda mod, args, out: seen.append(float(mod.stats()[1])))
    return seen


def _prompts(seed, lengths):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 512, (n,)).tolist() for n in lengths]


def test_engine_streams_match_jax(pair):
    cf, (jm, tm) = pair
    prompts = _prompts(3, (5, 13, 9, 21))
    jeng = JaxServingEngine(jm, **_ENGINE)
    teng = ServingEngine(tm, device="cpu", **_ENGINE)
    assert teng._net is tm                  # no copy: the hook sees it
    dropped = _dropped_fracs(tm)
    out = []
    for eng, sp in ((jeng, JaxSamplingParams), (teng, SamplingParams)):
        reset_launches()
        hs = [eng.submit(p, sp(max_new_tokens=12)) for p in prompts]
        eng.run_until_idle(max_steps=2000)
        assert eng.pool.num_used == 0
        out.append([h.output_tokens for h in hs])
    assert all(k.launches == 0 for k in kernels())     # plain versions
    jtoks, ttoks = out
    assert any(len(set(s)) > 3 for s in jtoks)          # streams vary
    assert ttoks == jtoks
    if cf < 1.0:
        assert max(dropped) > 0.0


def test_generate_matches_jax(pair):
    cf, (jm, tm) = pair
    ids = np.random.RandomState(4).randint(0, 512, (3, 11)).astype(np.int32)
    dropped = _dropped_fracs(tm)
    jo, js = jm.generate(paddle.to_tensor(ids), max_new_tokens=12,
                         dtype=None)
    reset_launches()
    to, ts = tm.generate(torch.from_numpy(ids), max_new_tokens=12,
                         dtype=None, device="cpu")
    assert all(k.launches == 0 for k in kernels())
    want = np.asarray(jo.numpy())
    assert len(set(want[:, 11:].ravel().tolist())) > 3
    np.testing.assert_array_equal(to.numpy(), want)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js.numpy()),
                               rtol=1e-4, atol=1e-4)
    if cf < 1.0:
        assert max(dropped) > 0.0


class _Window:
    def note(self, **kw):
        self.noted = kw


def test_moe_gauges_match_jax(pair):
    _, (jm, tm) = pair
    rs = np.random.RandomState(5)
    ids = rs.randint(0, 512, (2, 32)).astype(np.int32)
    lbl = rs.randint(0, 512, (2, 32)).astype(np.int32)
    jm.loss(paddle.to_tensor(ids), paddle.to_tensor(lbl))
    with torch.no_grad():
        tm.loss(torch.from_numpy(ids).long(), torch.from_numpy(lbl).long())
    jstats = np.asarray(jm.collect_moe_stats()._value)
    tstats = tm.collect_moe_stats()
    assert jax_stats.note_step_stats(_Window(), jstats, 4) is not None
    fields = note_step_stats(None, tstats, 4)
    want = {g: jax_monitor.get_gauge(g, None) for g in _GAUGES}
    got = {g: monitor.get_gauge(g, None) for g in _GAUGES}
    assert None not in want.values() and None not in got.values()
    for g in _GAUGES:
        assert abs(got[g] - want[g]) <= 1e-6, (g, got[g], want[g])
    assert got["moe.dropped_frac"] == fields["moe_dropped_frac"]
    # the same vector gives the same gauges exactly
    note_step_stats(None, jstats, 4)
    assert {g: monitor.get_gauge(g) for g in _GAUGES} == want
