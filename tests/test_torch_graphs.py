"""The port's compiled step (paddle_tpu_torch.jit.CapturedStep) and the
position as device data, against the JAX package on the same numpy
inputs, on the CPU in f32.

On the card the serving engine's decode and prefill steps and
`generate`'s token step are CUDA graphs over static buffers; on the CPU
the same bodies run eagerly over the same buffers. Held here:

- `GPTModel.forward` with a 0-dim int32 tensor `offset` (prefill and
  one-token steps) is bit-identical to the host-integer offset, logits
  and caches;
- `decode_attention` with a tensor `off` equals the JAX kernel in
  interpret mode (the registry's 1e-3) and the int form bit for bit;
  `flash_prefill_chunk` with a tensor `p0` equals the int form bit for
  bit; `device_split` gives every chunk a key, as the launcher's check
  of a host split does;
- the engine's static-buffer bodies (greedy and seeded sampling mixed,
  native and wo8) and `generate`'s sample and beam steps give
  token-identical streams to the JAX `ServingEngine` and `run_generate`,
  also on a second call that reuses the kept buffers; a weight changed
  in place, or rebound, between two calls shows in the second call's
  tokens, which equal a fresh JAX run with the new weights;
- the helper's launch accounting against a stub graph: the capture's
  counts are taken back out and added on every replay; a failed capture
  raises and keeps no graph; a warm restart changes the engine's
  capture key and the recapture's record names the arenas;
- the port's `diff_signatures` / `RecompileTracker` give the JAX
  package's causes and records for the same sequence of signatures.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.ops import pallas_decode as jax_pd
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu.telemetry import compile_obs as jax_co

from paddle_tpu_torch import jit
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.generation import capture_records
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
from paddle_tpu_torch.ops.decode_attention import (decode_attention,
                                                   decode_split, device_split)
from paddle_tpu_torch.ops.kernel_registry import (get_kernel, kernels,
                                                  reset_launches)
from paddle_tpu_torch.ops.paged_attention import flash_prefill_chunk
from paddle_tpu_torch.serving import SamplingParams, ServingEngine
from paddle_tpu_torch.telemetry import compile_obs as port_co

_MODEL = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
              max_seq_len=128, dropout=0.0, initializer_range=0.2)
_ENGINE = dict(max_slots=4, block_size=8, prefill_chunk=8,
               max_model_len=64, dtype=None)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _pair(seed=3):
    paddle.seed(seed)
    jm = JaxGPT(JaxGPTConfig(use_flash_attention=False, **_MODEL))
    tm = GPTForPretraining(GPTConfig(**_MODEL), device="cpu")
    load_jax_params(tm, [(n, np.asarray(t._value)) for n, t in
                         [*jm.named_parameters(), *jm.named_buffers()]])
    return jm, tm


def _ids(seed, b=2, s=9):
    return np.random.RandomState(seed).randint(0, 512, (b, s)).astype(
        np.int32)


def _dev(i):
    return torch.tensor(i, dtype=torch.int32)


# ---------------------------------------------------------------------------
# the position as device data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s0", [1, 9])
def test_forward_with_a_device_offset_is_bit_identical(s0):
    """A prompt at offset 0 (and a second chunk at s0), then one-token
    steps: logits and caches equal bit for bit, int against tensor."""
    _, tm = _pair()
    ids = torch.from_numpy(_ids(1, s=s0)).long()
    total = s0 + 4 + 6
    runs = []
    for dev_off in (False, True):
        caches = tm.gpt.init_cache(2, total)
        pos = (lambda i: _dev(i)) if dev_off else (lambda i: i)
        with torch.no_grad():
            lg = [tm(ids, caches=caches, offset=pos(0))[0]]
            lg.append(tm(ids[:, :4], caches=caches, offset=pos(s0))[0])
            tok = lg[-1][:, -1].argmax(-1)
            for cur in range(s0 + 4, total):
                out, _ = tm(tok[:, None], caches=caches, offset=pos(cur),
                            decode_chunks=decode_split(cur)[0])
                lg.append(out)
                tok = out[:, -1].argmax(-1)
        runs.append((lg, caches))
    (la, ca), (lb, cb) = runs
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    assert all(torch.equal(x, y) for (k1, v1), (k2, v2) in zip(ca, cb)
               for x, y in ((k1, k2), (v1, v2)))


@pytest.mark.parametrize("off", [0, 7, 31, 32, 33, 63])
def test_decode_attention_device_off_matches_jax_and_the_int_form(off):
    rs = np.random.RandomState(off)
    B, N, H, L = 2, 4, 32, 64
    q = rs.randn(B, 1, N * H).astype(np.float32)
    k, v = (rs.randn(B, L, N * H).astype(np.float32) for _ in range(2))
    kern = jax_pd.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), np.int32(off), N)
    reset_launches()
    host = decode_attention(_t(q), _t(k), _t(v), off, N)
    dev = decode_attention(_t(q), _t(k), _t(v), _dev(off), N,
                           decode_split(off)[0])
    assert torch.equal(host, dev)
    np.testing.assert_allclose(dev.numpy(), np.asarray(kern, np.float32),
                               rtol=1e-3, atol=1e-3)
    assert get_kernel("decode_fused").launches == 0     # plain version


@pytest.mark.parametrize("p0", [0, 5, 8, 40])
def test_flash_prefill_device_p0_is_bit_identical(p0):
    rs = np.random.RandomState(p0)
    N, H, bs, mb, C = 4, 32, 8, 8, 8
    q = rs.randn(1, C, N * H).astype(np.float32)
    kp, vp = (rs.randn(2 * mb + 1, bs, N * H).astype(np.float32)
              for _ in range(2))
    row = rs.permutation(np.arange(1, 2 * mb + 1))[:mb].astype(np.int32)
    host = flash_prefill_chunk(_t(q), _t(kp), _t(vp), _t(row), p0, N)
    dev = flash_prefill_chunk(_t(q), _t(kp), _t(vp), _t(row), _dev(p0), N)
    assert torch.equal(host, dev)


def test_device_split_gives_every_chunk_a_key():
    for last in range(0, 600):
        chunks = decode_split(last)[0]
        assert device_split(last, chunks) == decode_split(last)[1]
    assert device_split(40, 2) == 21
    with pytest.raises(ValueError, match="without a key"):
        device_split(8, 8)          # 9 keys in chunks of 2: one is empty
    with pytest.raises(ValueError):
        device_split(100, 16)


# ---------------------------------------------------------------------------
# the static-buffer bodies against the JAX package
# ---------------------------------------------------------------------------

_SAMPLED = dict(decode_strategy="sampling")
_KNOBS = (dict(), dict(_SAMPLED, seed=1), dict(_SAMPLED, seed=2, top_k=5),
          dict(_SAMPLED, seed=3, top_p=0.8, temperature=0.7), dict())


def _serve(eng, prompts, sampling_params, max_new=10):
    hs = [eng.submit(p, sampling_params(max_new_tokens=max_new, **k))
          for p, k in zip(prompts, _KNOBS)]
    eng.run_until_idle(max_steps=5000)
    return [h.output_tokens for h in hs]


@pytest.mark.parametrize("weights", ["native", "wo8"])
def test_engine_bodies_match_the_jax_engine(weights):
    """Greedy and seeded sampled requests in one batch, twice through
    the same engine (the second run reuses its static buffers)."""
    jm, tm = _pair(5)
    rs = np.random.RandomState(8)
    prompts = [rs.randint(0, 512, (n,)).tolist() for n in (5, 19, 12, 26, 9)]
    jeng = JaxServingEngine(jm, weights=weights, **_ENGINE)
    teng = ServingEngine(tm, device="cpu", weights=weights, **_ENGINE)
    want = _serve(jeng, prompts, JaxSamplingParams)
    assert sum(len(set(s)) > 2 for s in want) >= 3
    assert _serve(teng, prompts, SamplingParams) == want
    teng.drain()                    # the prefix index: cold again
    teng.resume_admission()
    assert _serve(teng, prompts, SamplingParams) == want
    assert teng._graphs.records == []       # nothing captured on the CPU


_GEN = {"greedy": dict(),
        "sampling": dict(decode_strategy="sampling", top_k=20, top_p=0.9,
                         temperature=0.8, seed=7),
        "beam": dict(decode_strategy="beam_search", num_beams=3,
                     length_penalty=0.6)}


@pytest.mark.parametrize("strategy", sorted(_GEN))
def test_generate_steps_match_jax_twice(strategy):
    jm, tm = _pair(6)
    ids = _ids(2)
    jo, js = jm.generate(paddle.to_tensor(ids), dtype=None,
                         max_new_tokens=10, **_GEN[strategy])
    for _ in range(2):      # the second call runs over the kept buffers
        to, ts = tm.generate(torch.from_numpy(ids), dtype=None,
                             device="cpu", max_new_tokens=10,
                             **_GEN[strategy])
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo.numpy()))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js.numpy()),
                                   rtol=1e-4, atol=1e-4)
    assert capture_records(tm) == []


def _jax_with(tm):
    """A JAX model holding the port model's current weights."""
    paddle.seed(0)
    jm = JaxGPT(JaxGPTConfig(use_flash_attention=False, **_MODEL))
    state = tm.state_dict()
    for n, p in jm.named_parameters():
        p._value = jnp.asarray(state[n].numpy())
    return jm


@pytest.mark.parametrize("how", ["in_place", "rebound"])
def test_a_weight_changed_between_calls_shows_in_the_next(how):
    _, tm = _pair(7)
    ids = _ids(3)
    kw = dict(max_new_tokens=8, device="cpu")
    first, _ = tm.generate(torch.from_numpy(ids), dtype=None, **kw)
    first_bf16, _ = tm.generate(torch.from_numpy(ids), **kw)
    w = tm.gpt.blocks[0].mlp.fc1.weight
    with torch.no_grad():
        if how == "in_place":
            w.mul_(-1.0)
        else:
            w.data = w.data * -1.0
    second, _ = tm.generate(torch.from_numpy(ids), dtype=None, **kw)
    assert not torch.equal(second, first)
    jo, _ = _jax_with(tm).generate(paddle.to_tensor(ids), dtype=None,
                                   max_new_tokens=8)
    np.testing.assert_array_equal(second.numpy(), np.asarray(jo.numpy()))
    # the bf16 cast kept across calls is refreshed too: the same tokens
    # as a fresh model holding the new weights
    fresh = GPTForPretraining(GPTConfig(**_MODEL), device="cpu")
    fresh.load_state_dict(tm.state_dict())
    second_bf16, _ = tm.generate(torch.from_numpy(ids), **kw)
    assert torch.equal(second_bf16, fresh.generate(torch.from_numpy(ids),
                                                   **kw)[0])
    assert not torch.equal(second_bf16, first_bf16)
    assert all(p.dtype == torch.float32 for p in tm.parameters())


def test_one_loop_state_a_model_released_by_a_train_step():
    from paddle_tpu_torch import generation
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    _, tm = _pair(8)
    ids = torch.from_numpy(_ids(4))
    kw = dict(dtype=None, device="cpu", max_new_tokens=6)
    greedy, _ = tm.generate(ids, **kw)
    tm.generate(ids, decode_strategy="beam_search", num_beams=3, **kw)
    # one loop state a model: the beam loop's took the greedy one's place
    assert generation._MODEL_STEPS[tm].loop_key[0] == "beam"
    assert torch.equal(tm.generate(ids, **kw)[0], greedy)
    generation.release(tm)
    assert tm not in generation._MODEL_STEPS
    assert torch.equal(tm.generate(ids, **kw)[0], greedy)
    # a training step drops the kept state; the next call decodes the
    # trained weights as a fresh JAX run does
    opt = AdamW(learning_rate=1e-2, parameters=tm.parameters())
    TrainStep(tm, tm.loss, opt)(ids, ids)
    assert tm not in generation._MODEL_STEPS
    after, _ = tm.generate(ids, **kw)
    jo, _ = _jax_with(tm).generate(paddle.to_tensor(ids.numpy()),
                                   dtype=None, max_new_tokens=6)
    np.testing.assert_array_equal(after.numpy(), np.asarray(jo.numpy()))


# ---------------------------------------------------------------------------
# the capture helper
# ---------------------------------------------------------------------------

class _StubGraph:
    """Stands in for torch.cuda.CUDAGraph on the CPU: counts the calls;
    `fail_replay` makes replay raise."""
    made = []
    fail_replay = False

    def __init__(self, keep_graph=False):
        self.calls = []
        _StubGraph.made.append(self)

    def capture_begin(self, pool=None, capture_error_mode="global"):
        assert capture_error_mode == "thread_local"
        self.calls.append("begin")

    def capture_end(self):
        self.calls.append("end")

    def instantiate(self):
        self.calls.append("instantiate")

    def replay(self):
        if _StubGraph.fail_replay:
            raise RuntimeError("stub replay failed")
        self.calls.append("replay")


@pytest.fixture
def stub():
    _StubGraph.made = []
    _StubGraph.fail_replay = False
    reset_launches()
    yield _StubGraph
    reset_launches()


def test_launch_accounting_adds_the_capture_counts_on_each_replay(stub):
    k7, k10 = get_kernel("layernorm_fused"), get_kernel("paged_decode")
    runs = []

    def body():                 # a step that launches K7 twice, K10 once
        runs.append(1)
        k7.launches += 2
        k10.launches += 1
        return "out"

    steps = jit.CapturedStep("cpu", graph_cls=stub)
    assert steps.run("decode", "k", body) == "out"     # warm-up + capture
    assert len(runs) == 2 and (k7.launches, k10.launches) == (2, 1)
    g = stub.made[0]
    assert g.calls == ["begin", "end", "instantiate"]
    for n in range(1, 4):
        assert steps.run("decode", "k", body) == "out"
        assert (k7.launches, k10.launches) == (2 + 2 * n, 1 + n)
    assert len(runs) == 2 and g.calls.count("replay") == 3
    other = {k.name: k.launches for k in kernels()
             if k.name not in ("layernorm_fused", "paged_decode")}
    assert set(other.values()) == {0}
    rec = steps.records[0]
    assert (rec["kind"], rec["fn"], rec["n_compiles"]) == ("compile",
                                                         "decode", 1)
    assert rec["extra"]["pool_bytes"] == 0 and rec["backend"] == "cpu"
    with jit._eager_steps():                # the body, eagerly
        steps.run("decode", "k", body)
    assert len(runs) == 3 and (k7.launches, k10.launches) == (10, 5)


def test_a_failed_capture_raises_and_keeps_nothing(stub):
    k7 = get_kernel("layernorm_fused")
    calls = {"n": 0}

    def body():
        calls["n"] += 1
        k7.launches += 1
        if calls["n"] == 2:                 # the capture's run
            raise RuntimeError("operation not permitted when capturing")
        return 1

    steps = jit.CapturedStep("cpu", graph_cls=stub)
    with pytest.raises(RuntimeError, match="capturing"):
        steps.run("prefill", "k", body)
    assert steps.graphs == {} and k7.launches == 1
    assert stub.made[0].calls == ["begin", "end"]
    steps.run("prefill", "k", lambda: 2)
    stub.fail_replay = True
    with pytest.raises(RuntimeError, match="stub replay failed"):
        steps.run("prefill", "k", lambda: 3)


def test_dropped_graphs_hold_their_pool_until_the_next_capture(stub):
    steps = jit.CapturedStep("cpu", graph_cls=stub)
    steps.run("generate", "a", lambda: 1)
    first = steps.graphs["a"]
    steps.invalidate(keep_pool=True)        # new weights,
    steps.invalidate(keep_pool=True)        # then a new loop state
    assert steps.graphs == {} and steps._retired == [first]
    assert steps.run("generate", "a", lambda: 1) == 1     # eager, warm
    assert steps._retired == [] and steps.graphs["a"] is not first
    assert stub.made[1].calls == ["begin", "end", "instantiate"]
    steps.invalidate(keep_pool=True)
    steps.invalidate()                      # new arenas: the pool goes
    assert steps._retired == [] and steps.graphs == {}
    assert [r["n_compiles"] for r in steps.records] == [1, 2]


class _ListSink:
    def __init__(self):
        self.records = []

    def write(self, rec):
        self.records.append(rec)


def test_a_warm_restart_changes_the_capture_key(stub):
    """The engine's steps captured (stub graphs on the CPU): one record a
    family; a warm restart bumps the arenas' generation in the key, drops
    the graphs, and each family recaptures once with the cause."""
    _, tm = _pair(9)
    sink = _ListSink()
    eng = ServingEngine(tm, device="cpu", sink=sink, **_ENGINE)
    eng._graphs = jit.CapturedStep("cpu", sink=sink, graph_cls=stub)
    keys = []
    run = eng._graphs.run

    def spy(family, key, body, **kw):
        keys.append(key)
        return run(family, key, body, **kw)

    eng._graphs.run = spy
    rs = np.random.RandomState(1)
    for n in (6, 11):
        eng.submit(rs.randint(0, 512, (n,)).tolist(),
                   SamplingParams(max_new_tokens=4))
    eng.run_until_idle()
    before = set(keys)
    assert before == {("decode_greedy", 0), ("prefill", False, 0)}
    eng.submit(rs.randint(0, 512, (9,)).tolist(),
               SamplingParams(max_new_tokens=4))
    eng.step()
    eng._on_step_error(RuntimeError("device lost"))
    assert eng._arena_gen == 1 and eng._graphs.graphs == {}
    keys.clear()
    eng.run_until_idle()
    assert set(keys) == {("decode_greedy", 1), ("prefill", False, 1)}
    recs = [r for r in sink.records if r.get("kind") == "compile"]
    assert [(r["fn"], r["n_compiles"]) for r in recs] == [
        ("prefill", 1), ("decode_greedy", 1), ("prefill", 2),
        ("decode_greedy", 2)]
    assert recs[2]["cause"] == ["static `arenas` 0→1"]
    assert recs[3]["cause"] == ["static `arenas` 0→1"]


# ---------------------------------------------------------------------------
# the capture records against the JAX compile observatory's
# ---------------------------------------------------------------------------

def _sig(co, leaves, static=None, donate=None):
    return co.CompileSignature(leaves, static=static, donate=donate)


_SEQUENCE = (
    ("decode", [("inputs", (16, 41), "int32", False, None),
                ("arena", (513, 16, 768), "bfloat16", False, None)],
     {"sampling": False, "arenas": 0}, None),
    ("decode", [("inputs", (16, 41), "int32", False, None),
                ("arena", (513, 16, 768), "bfloat16", False, None)],
     {"sampling": False, "arenas": 1}, None),
    ("decode", [("inputs", (16, 42), "int32", False, None),
                ("arena", (513, 16, 768), "float32", False, None),
                ("extra", (1,), "int32", False, None)],
     {"sampling": True, "arenas": 1}, (1,)),
    ("prefill", [("inputs", (556,), "int32", False, "cuda:0")],
     {"sampling": True}, None),
    ("prefill", [("inputs", (556,), "int32", False, "cuda:1")],
     {"sampling": True}, None),
    ("prefill", [("inputs", (556,), "int32", False, "cuda:1")],
     {"sampling": True}, None),
    ("generate", [("out", (8, 256), "int64", False, None),
                  ("cache", (8, 256), "float32", False, None)],
     {"strategy": "greedy", "chunks": 1}, None),
    ("generate", [("out", (8, 256, 1), "int64", False, None)],
     {"strategy": "greedy", "chunks": 8}, None),
)


def test_capture_records_match_the_jax_compile_observatory():
    jt = jax_co.RecompileTracker(backend="cuda")
    pt = port_co.RecompileTracker(backend="cuda")
    prev = {}
    for step, (family, leaves, static, donate) in enumerate(_SEQUENCE):
        js = _sig(jax_co, leaves, static, donate)
        ps = _sig(port_co, leaves, static, donate)
        assert ps.key == js.key and ps.summary() == js.summary()
        assert port_co.diff_signatures(prev.get(family), ps) == \
            jax_co.diff_signatures(prev.get(family), js)
        prev[family] = ps
        assert pt.observe(family, ps, 1.5 + step, step) == \
            jt.observe(family, js, 1.5 + step, step)
    assert any(r.get("cause") for r in pt.records)


def test_signature_of_names_leaves_as_jax_does():
    arrays = [np.zeros((2, 3), np.float32), np.zeros((4,), np.int32),
              np.zeros((1, 5), np.float32)]
    jsig = jax_co.signature_of(
        ([jnp.asarray(arrays[0]), (jnp.asarray(arrays[1]),)],
         {"m": jnp.asarray(arrays[2])}), arg_names=("caches", "opt"))
    psig = port_co.signature_of(
        ([_t(arrays[0]), (_t(arrays[1]),)], {"m": _t(arrays[2])}),
        arg_names=("caches", "opt"))
    assert [leaf[:3] for leaf in psig.leaves] == \
        [leaf[:3] for leaf in jsig.leaves]
    assert [leaf[0] for leaf in psig.leaves] == \
        ["caches[0]", "caches[1][0]", "opt['m']"]
