"""The port's serving engine (paddle_tpu_torch.serving) against the JAX
engine (paddle_tpu.serving) on the same weights, on the CPU in f32.

Greedy streams must be token-identical and per-token logp must agree at
1e-4, with the prefix cache on and off and under an over-admitted pool
that forces preemption. The weights use initializer_range=0.2: with the
default 0.02 the tiny model's greedy streams are one token repeated, and
token identity would prove nothing, so the JAX streams are asserted to
vary. The host-logic cases of tests/test_serving.py (BlockPool,
Scheduler) run against the port's copies, plus PrefixIndex cases.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import ServingEngine as JaxServingEngine

from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
from paddle_tpu_torch.ops.kernel_registry import kernels, reset_launches
from paddle_tpu_torch.serving import (NULL_BLOCK, BlockPool, PagedKVCache,
                                      PrefixIndex, SamplingParams,
                                      ServingEngine, StaleIndexError)
from paddle_tpu_torch.serving.scheduler import Request, Scheduler

_MODEL = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
              max_seq_len=128, dropout=0.0, initializer_range=0.2)
_ENGINE = dict(max_slots=4, block_size=8, prefill_chunk=8,
               max_model_len=64, dtype=None)


@pytest.fixture(scope="module")
def models():
    paddle.seed(11)
    jm = JaxGPT(JaxGPTConfig(use_flash_attention=False, **_MODEL))
    tm = GPTForPretraining(GPTConfig(**_MODEL), device="cpu")
    load_jax_params(tm, [(n, np.asarray(p._value))
                         for n, p in jm.named_parameters()])
    return jm, tm


def _record_logp(eng):
    """Wrap an engine's `_emit` to keep every emitted token's logp per
    request (neither engine stores logp on the request)."""
    logps = {}
    orig = eng._emit

    def emit(req, tok, logp, now=None):
        logps.setdefault(req.rid, []).append(float(logp))
        return orig(req, tok, logp, now=now)

    eng._emit = emit
    return logps


def _serve(eng, prompts, max_new, sampling_params):
    logps = _record_logp(eng)
    handles = [eng.submit(p, sampling_params(max_new_tokens=max_new))
               for p in prompts]
    eng.run_until_idle(max_steps=5000)
    assert eng.pool.num_used == 0
    return ([h.output_tokens for h in handles],
            [logps[h.rid] for h in handles])


def _prompts(seed, lengths, template=None):
    rs = np.random.RandomState(seed)
    out = []
    for i, n in enumerate(lengths):
        tail = rs.randint(0, 512, (n,)).tolist()
        out.append(template + tail if template and i % 2 == 0 else tail)
    return out


def _compare(models, prompts, max_new, **engine_kw):
    jm, tm = models
    kw = {**_ENGINE, **engine_kw}
    jeng = JaxServingEngine(jm, **kw)
    teng = ServingEngine(tm, device="cpu", **kw)
    jtoks, jlogp = _serve(jeng, prompts, max_new, JaxSamplingParams)
    reset_launches()
    ttoks, tlogp = _serve(teng, prompts, max_new, SamplingParams)
    # identity means something only if the streams are not one token
    assert any(len(set(s)) > 2 for s in jtoks)
    assert ttoks == jtoks
    np.testing.assert_allclose(np.concatenate(tlogp),
                               np.concatenate(jlogp), rtol=1e-4, atol=1e-4)
    # on the CPU the wrappers run their plain versions: no launches
    assert all(k.launches == 0 for k in kernels())
    return jeng, teng


_MIXED = (5, 13, 40, 22, 9, 31, 17)


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_engine_streams_match_jax(models, prefix_cache):
    """Mixed prompt lengths (multi-chunk prefill, p0 > 0) with half the
    prompts sharing a 12-token template."""
    template = _prompts(99, [12])[0]
    prompts = _prompts(1, _MIXED, template=template)
    jeng, teng = _compare(models, prompts, 10,
                          enable_prefix_cache=prefix_cache)
    if prefix_cache:
        assert teng.prefix_stats()["hits"] > 0
        assert teng.prefix_stats() == jeng.prefix_stats()
    else:
        assert teng.prefix_index is None


def test_engine_streams_match_jax_under_preemption(models):
    """An 11-block pool for four 10-token prompts that each grow to 34
    positions: decode growth must preempt, and recompute must replay."""
    prompts = _prompts(2, [10, 10, 10, 10])
    jeng, teng = _compare(models, prompts, 24, num_blocks=11)
    assert teng.sched.preemptions > 0
    assert teng.sched.preemptions == jeng.sched.preemptions


def test_prefix_hit_mid_block_forks_and_matches(models):
    """A prefix hit that resumes inside a shared block (p0 not a multiple
    of the block size) forks the block copy-on-write before writing."""
    base = _prompts(3, [24])[0]             # three full blocks cached
    prompts = [base, base[:19] + [(base[19] + 1) % 512, 8, 9, 10]]
    jm, tm = models
    teng = ServingEngine(tm, device="cpu", **_ENGINE)
    logps = _record_logp(teng)
    h0 = teng.submit(prompts[0], SamplingParams(max_new_tokens=6))
    teng.run_until_idle()
    h1 = teng.submit(prompts[1], SamplingParams(max_new_tokens=6))
    teng.run_until_idle()
    assert teng.prefix_stats()["tokens_saved"] == 19    # p0 = 19, mid-block
    jeng = JaxServingEngine(jm, **_ENGINE)
    jl = _record_logp(jeng)
    j0 = jeng.submit(prompts[0], JaxSamplingParams(max_new_tokens=6))
    jeng.run_until_idle()
    j1 = jeng.submit(prompts[1], JaxSamplingParams(max_new_tokens=6))
    jeng.run_until_idle()
    assert [h0.output_tokens, h1.output_tokens] == \
        [j0.output_tokens, j1.output_tokens]
    np.testing.assert_allclose(logps[h1.rid], jl[j1.rid], rtol=1e-4,
                               atol=1e-4)


def test_engine_refuses_what_is_not_ported(models):
    _, tm = models
    eng = ServingEngine(tm, device="cpu", **_ENGINE)
    with pytest.raises(ValueError, match="'native' or 'wo8'"):
        ServingEngine(tm, device="cpu", weights="int4")
    with pytest.raises(ValueError):
        eng.submit(list(range(60)), SamplingParams(max_new_tokens=10))


def test_deadlines_and_queue_bound(models):
    """A blown TTFT budget is reaped at the next step with a typed error;
    a full waiting queue sheds at submit."""
    from paddle_tpu_torch.serving import (DeadlineExceededError, Deadlines,
                                          QueueFullError)
    _, tm = models
    eng = ServingEngine(tm, device="cpu", max_queue=1, **_ENGINE)
    h = eng.submit([1, 2, 3], SamplingParams(max_new_tokens=4),
                   deadlines=Deadlines(ttft_s=1e-9))
    with pytest.raises(QueueFullError):
        eng.submit([4, 5], SamplingParams(max_new_tokens=4))
    eng.step()
    with pytest.raises(DeadlineExceededError) as e:
        h.result(timeout=5)
    assert e.value.which == "ttft" and h.status == "expired"
    assert eng.pool.num_used == 0 and not eng.sched.has_work()


def test_cancel_releases_blocks_and_ends_stream(models):
    from paddle_tpu_torch.serving import RequestCancelledError
    _, tm = models
    eng = ServingEngine(tm, device="cpu", **_ENGINE)
    h = eng.submit(list(range(20)), SamplingParams(max_new_tokens=20))
    for _ in range(4):
        eng.step()
    assert eng.pool.num_used > 0
    assert h.cancel()
    assert eng.pool.num_used == 0
    with pytest.raises(RequestCancelledError):
        h.result(timeout=5)


# ---------------------------------------------------------------------------
# host logic: tests/test_serving.py's BlockPool/Scheduler cases and the
# PrefixIndex, against the port's copies
# ---------------------------------------------------------------------------

def _pool_roundtrip():
    pool = BlockPool(9)
    assert pool.capacity == 8 and pool.num_free == 8
    a = pool.alloc(3, owner="a")
    b = pool.alloc(2, owner="b")
    assert len(a) == 3 and len(b) == 2
    assert NULL_BLOCK not in a + b          # null block never handed out
    assert pool.num_used == 5
    assert pool.owner_of(a[0]) == "a"
    pool.free(a)
    assert pool.num_free == 6
    assert abs(pool.utilization() - 2 / 8) < 1e-9


def _pool_no_partial_allocation():
    pool = BlockPool(5)
    assert pool.alloc(3) is not None
    before = pool.num_free
    assert pool.alloc(2) is None            # only 1 left
    assert pool.num_free == before


def _pool_double_and_null_free_raise():
    pool = BlockPool(4)
    blocks = pool.alloc(2)
    pool.free(blocks)
    with pytest.raises(ValueError):
        pool.free(blocks)
    with pytest.raises(ValueError):
        pool.free([NULL_BLOCK])


def _pool_fragmentation_cannot_strand():
    pool = BlockPool(17)
    rs = np.random.RandomState(0)
    held = []
    for _ in range(200):
        if held and rs.rand() < 0.5:
            pool.free(held.pop(rs.randint(len(held))))
        else:
            got = pool.alloc(int(rs.randint(1, 4)))
            if got is not None:
                held.append(got)
    free = pool.num_free
    if free:
        got = pool.alloc(free)
        assert got is not None and len(got) == free


def _pool_deterministic_and_lifo():
    def run():
        pool = BlockPool(33)
        rs = np.random.RandomState(7)
        held, trace = [], []
        for _ in range(300):
            if held and rs.rand() < 0.45:
                blocks = held.pop(rs.randint(len(held)))
                pool.free(blocks)
                trace.append(("free", tuple(blocks)))
            else:
                got = pool.alloc(int(rs.randint(1, 5)))
                trace.append(("alloc", tuple(got or ())))
                if got:
                    held.append(got)
        return trace
    assert run() == run()
    pool = BlockPool(6)
    assert pool.alloc(2) == [1, 2]          # low ids first
    pool.free([2])
    assert pool.alloc(1) == [2]             # last freed, first reused


def _blocks_for_tokens():
    assert PagedKVCache.blocks_for_tokens(1, 8) == 1
    assert PagedKVCache.blocks_for_tokens(8, 8) == 1
    assert PagedKVCache.blocks_for_tokens(9, 8) == 2


def _pool_refcounts_and_quiesce():
    from paddle_tpu_torch.serving import BlockLeakError
    pool = BlockPool(6)
    (b,) = pool.alloc(1, owner="a")
    pool.incref([b], owner="b")
    assert pool.refcount(b) == 2 and pool.num_shared == 1
    with pytest.raises(ValueError):
        pool.free([b])                      # shared: owner required
    with pytest.raises(BlockLeakError):
        pool.assert_quiesced()
    pool.mark_cached(b)
    pool.free([b], owner="a")
    pool.free([b], owner="b")
    assert pool.num_used == 0 and pool.num_cached == 1
    pool.assert_quiesced()                  # cache is not a leak
    pool.release_cached(b)
    assert pool.num_free == 5


def _prefix_index_match_insert_evict():
    pool = BlockPool(8)
    idx = PrefixIndex(4, pool=pool)
    toks = list(range(10))
    blocks = pool.alloc(3, owner="w")
    idx.insert(toks, blocks, pool)          # two full chunks
    pool.free(blocks, owner="w")
    got, n = idx.match(toks[:6] + [99, 98], pool)
    assert got == blocks[:2] and n == 6     # full chunk + partial tail
    got, n = idx.match(toks[:8], pool)
    assert n == 7                           # capped at len - 1
    assert idx.evict(5, pool) == 2 and pool.num_free == 7
    idx.bind(BlockPool(8))
    with pytest.raises(StaleIndexError):
        idx.match(toks, pool)


def _scheduler_preempts_youngest_and_requeues_front():
    pool = BlockPool(7)                          # capacity 6
    sched = Scheduler(pool, block_size=8, max_slots=3, max_model_len=48)
    reqs = [Request([1] * 8, SamplingParams(max_new_tokens=8))
            for _ in range(3)]
    for r in reqs:
        sched.submit(r)
    sched.admit()
    assert len(sched.prefilling) == 3
    for r in reqs:
        assert sched.ensure_blocks(r, 16, evict=False)
    assert pool.num_free == 0
    assert sched.ensure_blocks(reqs[0], 17, evict=True)
    assert reqs[2].state == "waiting"
    assert sched.waiting[0] is reqs[2]
    assert reqs[2].blocks == [] and reqs[2].n_prefilled == 0
    assert sched.ensure_blocks(reqs[1], 48, evict=False) is False
    assert all(r.state != "waiting" for r in (reqs[0], reqs[1]))


def _scheduler_admission_bounded_by_slots():
    pool = BlockPool(64)
    sched = Scheduler(pool, block_size=8, max_slots=2, max_model_len=64)
    for _ in range(5):
        sched.submit(Request([1, 2], SamplingParams(max_new_tokens=4)))
    sched.admit()
    assert len(sched.prefilling) == 2
    assert len(sched.waiting) == 3


@pytest.mark.parametrize("case", [
    _pool_roundtrip, _pool_no_partial_allocation,
    _pool_double_and_null_free_raise, _pool_fragmentation_cannot_strand,
    _pool_deterministic_and_lifo, _blocks_for_tokens,
    _pool_refcounts_and_quiesce, _prefix_index_match_insert_evict,
    _scheduler_preempts_youngest_and_requeues_front,
    _scheduler_admission_bounded_by_slots,
], ids=lambda f: f.__name__.lstrip("_"))
def test_host_logic(case):
    case()


def test_no_leak_after_idle(models):
    _, tm = models
    eng = ServingEngine(tm, device="cpu", **_ENGINE)
    for p in _prompts(4, (9, 17, 30)):
        eng.submit(p, SamplingParams(max_new_tokens=5))
    eng.run_until_idle()
    eng.pool.assert_quiesced()
    assert eng.pool.num_shared == 0 and eng.sched.num_running() == 0
    assert eng.kv_peak_utilization > 0
