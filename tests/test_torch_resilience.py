"""The port's resilience runtime (paddle_tpu_torch/resilience,
distributed/checkpoint.py, the ckpt/elastic records) against the JAX
package's, on the CPU, in one process.

- retry: `with_retry`/`RetryBudget` sleep the same delays as JAX's under
  one seeded clock and sleep; permanent errors raise at once; deadlines
  stop early.
- the checkpoint protocol, mirroring the JAX cases: atomic commit,
  `latest` and the manifest; corrupt, truncated and missing files named
  with their leaf; husks ignored and reaped; retention leaving the same
  steps as JAX's manager; one save thread reused; restore falling back
  past corruption; a failed re-save never destroying a committed step; a
  stale `latest` marker; an empty directory; the RNG round trip; the
  records valid under the port's ledger checks and JAX's
  tools/trace_check.py; chaos faults retried, and failing past the
  retries.
- the JAX corrupt specimen gets the same problem strings from both
  verifiers; a tiny GPT after 2 AdamW steps gives manifests whose leaves
  agree in name, shape, dtype and bytes.
- preemption: SIGTERM arms the flag; TrainStep saves on schedule and
  exits 102 with a dump; a resume at dropout 0.1 gives the uninterrupted
  losses exactly, and at dropout 0 the stitched losses track JAX's
  stitched losses to 1e-5; `as_resilience` and PipelineParallel's
  attribute.
- distributed/checkpoint.py: the epoch walk-back, corruption raising.
- health: the checkpoint rules fire alike in both detectors; `ckpt.*` on
  /metrics; healthwatch replays the records.
- reshard, as pure functions: the layout identity against JAX's, and the
  pieces every rank of one layout writes, reassembled for every rank of
  another, equal to the direct cut, for the three layout pairs of the
  JAX reshard tests.
"""
import json
import os
import shutil
import signal
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jax_opt
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.resilience import ckpt as jax_ckpt
from paddle_tpu.resilience import preempt as jax_preempt
from paddle_tpu.resilience import reshard as jax_reshard
from paddle_tpu.resilience import retry as jax_retry
from paddle_tpu.telemetry import health as jax_health

from paddle_tpu_torch import monitor
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.distributed.checkpoint import (assemble_leaf, cut_for,
                                                     load_checkpoint,
                                                     save_checkpoint,
                                                     train_epoch_range)
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.optimizer import SGD, AdamW
from paddle_tpu_torch.resilience import (
    RESUMABLE_EXIT_CODE, ChaosConfig, ChaosMonkey, CheckpointCorruptError,
    CheckpointError, CheckpointManager, PreemptionHandler,
    ResilienceManager, RetryBudget, RetryError, RetryPolicy, RunState,
    corrupt_one_file, layouts_differ, normalize_layout,
    verify_checkpoint, with_retry)
from paddle_tpu_torch.resilience.ckpt import load_manifest
from paddle_tpu_torch.resilience.reshard import (layout_pieces, piece_spec,
                                                 rank_coords)
from paddle_tpu_torch.telemetry.health import AnomalyDetector, HealthConfig
from paddle_tpu_torch.telemetry.ledger_check import (check_jsonl,
                                                     validate_record)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECIMEN = os.path.join(REPO, "tools", "specimens", "ckpt_corrupt", "step_3")
TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=16)


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


class FakeClock:
    def __init__(self):
        self.t = 0.0
        self.sleeps = []

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.sleeps.append(s)
        self.t += s


def _init(net, seed):
    """Seeded values for every parameter (the port's layers allocate
    theirs uninitialised, for weights loaded by name)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    return net


def _mlp(seed=5):
    torch.manual_seed(seed)
    net = _init(torch.nn.Sequential(Linear(6, 8), torch.nn.ReLU(),
                                    Linear(8, 6)), seed)
    opt = SGD(learning_rate=0.05, parameters=list(net.named_parameters()))
    return net, opt


def _fast(**kw):
    kw.setdefault("max_attempts", 4)
    kw.setdefault("base_delay_s", 0.0005)
    kw.setdefault("max_delay_s", 0.001)
    return RetryPolicy(**kw)


def _w(net):
    return net[0].weight.detach().clone()


def _bump(net, v):
    with torch.no_grad():
        net[0].weight.add_(v)


# =========================================================================
# retry
# =========================================================================

def _schedule(mod, budget_tokens=None, **kw):
    clk = FakeClock()
    pol = mod.RetryPolicy(max_attempts=6, base_delay_s=0.5, max_delay_s=4.0,
                          seed=7, budget=None if budget_tokens is None
                          else mod.RetryBudget(budget_tokens), **kw)
    calls = []

    def boom():
        calls.append(1)
        raise TimeoutError("flaky")

    with pytest.raises(mod.RetryError) as e:
        mod.with_retry(boom, policy=pol, clock=clk, sleep=clk.sleep)
    return clk.sleeps, len(calls), e.value.attempts


@pytest.mark.parametrize("kw", [dict(), dict(jitter=False),
                                dict(budget_tokens=2),
                                dict(deadline_s=2.0)])
def test_retry_schedule_equals_jax(kw):
    import paddle_tpu_torch.resilience.retry as port_retry
    assert _schedule(port_retry, **kw) == _schedule(jax_retry, **kw)


def test_retry_permanent_raises_at_once_and_deadline_stops():
    clk = FakeClock()
    n = []

    def missing():
        n.append(1)
        raise FileNotFoundError("gone")

    with pytest.raises(FileNotFoundError):
        with_retry(missing, policy=_fast(), clock=clk, sleep=clk.sleep)
    assert n == [1] and clk.sleeps == []
    pol = RetryPolicy(max_attempts=50, base_delay_s=1.0, max_delay_s=1.0,
                      jitter=False, deadline_s=3.5)
    with pytest.raises(RetryError, match="deadline"):
        with_retry(lambda: (_ for _ in ()).throw(TimeoutError()), policy=pol,
                   clock=clk, sleep=clk.sleep)
    assert clk.sleeps == [1.0, 1.0, 1.0]
    budget = RetryBudget(1)
    assert budget.take() and not budget.take() and budget.spent == 1


# =========================================================================
# the checkpoint protocol
# =========================================================================

def test_atomic_commit_latest_marker_and_manifest(tmp_path):
    net, opt = _mlp()
    mgr = CheckpointManager(str(tmp_path), net, opt, retry=_fast())
    mgr.save(1, block=True)
    assert mgr.steps() == [1]
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    assert (tmp_path / "latest").read_text() == "1"
    assert mgr.verify(1) == []
    m = load_manifest(mgr.step_dir(1))
    w = m["leaves"]["model.0.weight"]
    assert w["dtype"] == "float32" and w["nbytes"] == 8 * 6 * 4
    assert w["pieces"] == [{"rank": 0, "cut": [], "flat": None,
                            "file": "arrays/model.0.weight/0"}]
    assert all("sha256" in e for e in m["files"].values())
    assert "run_state.json" in m["files"]
    mgr.close()


def test_verify_names_corrupt_truncated_missing_leaves(tmp_path):
    net, opt = _mlp()
    mgr = CheckpointManager(str(tmp_path), net, opt, retry=_fast())
    mgr.save(2, block=True)
    d = mgr.step_dir(2)
    bad = corrupt_one_file(d, seed=0, prefer="arrays/model")
    probs = verify_checkpoint(d)
    assert probs and "digest mismatch" in probs[0] and "leaf model." in \
        probs[0]
    leaf = next(n for n in ("model.2.bias", "model.0.bias")
                if os.path.join("arrays", n, "0") not in bad)
    other = os.path.join(d, "arrays", leaf, "0")
    with open(other, "rb+") as f:
        f.truncate(os.path.getsize(other) - 2)
    assert any("truncated" in p and f"(leaf {leaf})" in p
               for p in verify_checkpoint(d))
    os.remove(other)
    assert any(f"missing (leaf {leaf})" in p for p in verify_checkpoint(d))
    os.remove(os.path.join(d, "manifest.json"))
    probs = verify_checkpoint(d)
    assert probs and "never committed" in probs[0]
    mgr.close()


def test_crash_husk_is_ignored_and_reaped(tmp_path):
    net, opt = _mlp()
    mgr = CheckpointManager(str(tmp_path), net, opt, retry=_fast())
    mgr.save(1, block=True)
    mgr.close()
    husk = tmp_path / "step_2.tmp"
    (husk / "arrays").mkdir(parents=True)
    (husk / "arrays" / "junk").write_text("partial")
    mgr2 = CheckpointManager(str(tmp_path), net, opt, retry=_fast())
    assert mgr2.steps() == [1]
    assert not husk.exists()
    assert mgr2.restore().step == 1
    mgr2.close()


def test_retention_leaves_the_steps_jax_leaves(tmp_path):
    net, opt = _mlp()
    mgr = CheckpointManager(str(tmp_path / "port"), net, opt, keep_last=2,
                            keep_every=4, retry=_fast())
    for s in range(1, 10):
        mgr.save(s, block=True)
    import paddle_tpu.nn as jnn
    jnet = jnn.Sequential(jnn.Linear(6, 8), jnn.ReLU(), jnn.Linear(8, 6))
    jmgr = jax_ckpt.CheckpointManager(
        str(tmp_path / "jax"), jnet, None, keep_last=2, keep_every=4,
        async_save=False)
    for s in range(1, 10):
        jmgr.save(s, block=True)
    assert mgr.steps() == jmgr.steps() == [4, 8, 9]
    mgr.close()
    jmgr.close()


def test_one_save_thread_is_reused(tmp_path):
    net, opt = _mlp()
    mgr = CheckpointManager(str(tmp_path), net, opt, retry=_fast())
    mgr.save(1)
    first = mgr._writer
    mgr.save(2)
    mgr.drain()
    assert mgr._writer is first and mgr._pending is None
    assert len(first._threads) == 1
    mgr.close()


def test_restore_falls_back_past_corruption(tmp_path):
    net, opt = _mlp()
    mgr = CheckpointManager(str(tmp_path), net, opt, keep_last=3,
                            retry=_fast())
    marks = {}
    for s in (1, 2, 3):
        _bump(net, 1.0)
        marks[s] = _w(net)
        mgr.save(s, block=True)
    corrupt_one_file(mgr.step_dir(3), seed=1, prefer="arrays/model")
    before = monitor.get("ckpt.fallbacks")
    with pytest.warns(RuntimeWarning, match="falling back"):
        rs = mgr.restore()
    assert rs.step == 2 and torch.equal(_w(net), marks[2])
    assert monitor.get("ckpt.fallbacks") == before + 1
    assert any(r["event"] == "fallback" for r in mgr.records)
    with pytest.raises(CheckpointCorruptError) as e:
        mgr.restore(step=3)
    assert e.value.problems
    corrupt_one_file(mgr.step_dir(2), seed=2, prefer="arrays/model")
    corrupt_one_file(mgr.step_dir(1), seed=3, prefer="arrays/model")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(CheckpointCorruptError):
            mgr.restore()
    mgr.close()


def test_failed_resave_never_destroys_a_committed_step(tmp_path):
    net, opt = _mlp()
    mgr = CheckpointManager(str(tmp_path), net, opt,
                            retry=_fast(max_attempts=2))
    mgr.save(1, block=True)
    w1 = _w(net)
    _bump(net, 5.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with ChaosMonkey(ChaosConfig(seed=0, io_error_rate=1.0)).active():
            with pytest.raises(CheckpointError):
                mgr.save(1, block=True)
    assert mgr.steps() == [1] and mgr.verify(1) == []
    assert mgr.restore().step == 1 and torch.equal(_w(net), w1)
    _bump(net, 7.0)
    mgr.save(1, block=True)
    assert mgr.verify(1) == []
    assert not [n for n in os.listdir(tmp_path) if "." in n]
    mgr.restore()
    assert torch.equal(_w(net), w1 + 7.0)
    mgr.close()


def test_stale_latest_marker_and_empty_dir(tmp_path):
    net, opt = _mlp()
    mgr = CheckpointManager(str(tmp_path / "a"), net, opt, retry=_fast())
    mgr.save(1, block=True)
    _bump(net, 3.0)
    w2 = _w(net)
    mgr.save(2, block=True)
    (tmp_path / "a" / "latest").write_text("1")
    assert mgr.latest_step() == 2
    assert mgr.restore().step == 2 and torch.equal(_w(net), w2)
    mgr.close()
    empty = CheckpointManager(str(tmp_path / "b"), net, opt, retry=_fast())
    assert empty.restore() is None
    empty.close()


def test_run_state_rng_roundtrip(tmp_path):
    net, opt = _mlp()
    mgr = CheckpointManager(str(tmp_path), net, opt, retry=_fast())
    torch.manual_seed(77)
    torch.rand(5)
    rs = RunState(step=1, epoch=2, data_position={"batch": 17},
                  extra={"lr": 0.05}).capture_rng()
    mgr.save(1, run_state=rs, block=True)
    expected = [torch.rand(3) for _ in range(3)]
    torch.manual_seed(999)
    out = mgr.restore()
    assert (out.step, out.epoch, out.data_position, out.extra) == \
        (1, 2, {"batch": 17}, {"lr": 0.05})
    for e in expected:
        assert torch.equal(torch.rand(3), e)
    mgr.close()


def test_records_pass_both_ledger_checks(tmp_path):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from trace_check import check_pair
    net, opt = _mlp()
    ledger = str(tmp_path / "ckpt.jsonl")
    mgr = CheckpointManager(str(tmp_path / "ck"), net, opt, sink=ledger,
                            retry=_fast())
    mgr.save(1, block=True)
    mgr.save(2, block=True)
    mgr.restore()
    mgr.close()
    problems, stats = check_pair(ledger)
    assert problems == [] and stats["n_ckpt"] >= 5
    recs, problems = check_jsonl(ledger)
    assert problems == [] and len(recs) == stats["n_ckpt"]
    bad = str(tmp_path / "bad.jsonl")
    with open(bad, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
        f.write(json.dumps({"schema": 1, "kind": "ckpt", "rank": 0,
                            "step": 1, "event": "commit",
                            "save_ms": 1.0}) + "\n")
    assert any("non-monotonic" in p for p in check_pair(bad)[0])
    assert any("non-monotonic" in p for p in check_jsonl(bad)[1])
    assert validate_record({"schema": 1, "kind": "ckpt", "rank": 0,
                            "step": 1, "event": "vibe"})


def test_chaos_faults_are_retried_and_exhaust(tmp_path):
    net, opt = _mlp()
    mgr = CheckpointManager(str(tmp_path / "a"), net, opt,
                            retry=_fast(max_attempts=8))
    before = monitor.get("ckpt.retries")
    monkey = ChaosMonkey(ChaosConfig(seed=3, io_error_rate=0.6,
                                     max_faults=6))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with monkey.active():
            mgr.save(1, block=True)
    assert monkey.faults == 6
    assert monitor.get("ckpt.retries") >= before + 6
    assert mgr.steps() == [1]
    mgr.close()
    mgr2 = CheckpointManager(str(tmp_path / "b"), net, opt,
                             retry=_fast(max_attempts=2))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with ChaosMonkey(ChaosConfig(seed=0, io_error_rate=1.0)).active():
            with pytest.raises(CheckpointError):
                mgr2.save(1, block=True)
    assert any(r["event"] == "failed" for r in mgr2.records)
    mgr2.close()


def test_chaos_monkey_counts_faults_exactly_under_threads():
    """The checkpoint writes a rank's pieces on helper threads: a
    monkey's fault cap and count hold with more threads than cores."""
    import threading
    monkey = ChaosMonkey(ChaosConfig(seed=1, io_error_rate=0.5,
                                     max_faults=50))
    hits = []
    mu = threading.Lock()

    def work():
        for _ in range(200):
            try:
                monkey.visit("save")
            except OSError:
                with mu:
                    hits.append(1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work)
                   for _ in range(4 * (os.cpu_count() or 1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert monkey.faults == len(hits) == 50


# =========================================================================
# the JAX specimen and the manifest
# =========================================================================

def test_the_jax_specimen_gets_the_same_problems():
    port = verify_checkpoint(SPECIMEN)
    assert port and port == jax_ckpt.verify_checkpoint(SPECIMEN)
    assert any("leaf model.w" in p for p in port)
    assert verify_checkpoint(SPECIMEN, deep=False) == \
        jax_ckpt.verify_checkpoint(SPECIMEN, deep=False)


def _tiny_pair(dropout=0.0):
    cfg = dict(TINY, dropout=dropout)
    jm = JaxGPT(JaxGPTConfig(**cfg))
    pm = GPTForPretraining(GPTConfig(**cfg), device="cpu")
    load_jax_params(pm, [(n, np.asarray(p._value))
                         for n, p in jm.named_parameters()])
    return jm, pm


def _batch(i):
    rs = np.random.RandomState(50 + i)
    return [rs.randint(0, TINY["vocab_size"], (2, 16)).astype(np.int32)
            for _ in range(2)]


def test_manifest_leaves_equal_jax(tmp_path):
    jm, pm = _tiny_pair()
    jo = jax_opt.AdamW(learning_rate=1e-3, parameters=jm.parameters())
    po = AdamW(learning_rate=1e-3, parameters=pm.parameters())
    jstep = paddle.jit.TrainStep(jm, jm.loss, jo)
    pstep = TrainStep(pm, pm.loss, po)
    for i in range(2):
        ids, lbl = _batch(i)
        jstep(paddle.to_tensor(ids, "int32"), paddle.to_tensor(lbl, "int32"))
        pstep(torch.from_numpy(ids).long(), torch.from_numpy(lbl).long())
    jmgr = jax_ckpt.CheckpointManager(str(tmp_path / "jax"), jm, jo,
                                      async_save=False)
    jmgr.save(2, block=True)
    pmgr = CheckpointManager(str(tmp_path / "port"), pm, po)
    pmgr.save(2, block=True)
    jman = jax_ckpt.load_manifest(jmgr.step_dir(2))
    pman = load_manifest(pmgr.step_dir(2))
    assert sorted(jman) == sorted(pman)
    strip = {n: {k: v for k, v in m.items() if k != "pieces"}
             for n, m in pman["leaves"].items()}
    assert strip == jman["leaves"]
    assert len(strip) == 5 * len(list(pm.parameters()))
    rj = json.load(open(os.path.join(jmgr.step_dir(2), "run_state.json")))
    rp = json.load(open(os.path.join(pmgr.step_dir(2), "run_state.json")))
    assert sorted(rj) == sorted(rp)
    jmgr.close()
    pmgr.close()


# =========================================================================
# preemption and resume
# =========================================================================

def test_sigterm_arms_the_flag():
    h = PreemptionHandler().install()
    try:
        assert not h.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert h.requested and h.signal_name == "SIGTERM"
    finally:
        h.uninstall()
    assert signal.getsignal(signal.SIGTERM) is not h._on_signal


def test_train_step_saves_on_schedule_and_exits_102(tmp_path):
    net, opt = _mlp()
    res = ResilienceManager(str(tmp_path), save_every=2, preempt=True)
    step = TrainStep(net, lambda a, b: ((net(a) - b) ** 2).mean(), opt,
                     resilience=res)
    x, y = torch.randn(4, 6), torch.randn(4, 6)
    try:
        for _ in range(4):
            step(x, y)
        res.ckpt.drain()
        assert res.ckpt.steps() == [2, 4]
        res.handler.request()
        with pytest.raises(SystemExit) as e:
            step(x, y)
        assert e.value.code == RESUMABLE_EXIT_CODE
        assert 5 in CheckpointManager(str(tmp_path), net).steps()
        dumps = [f for f in os.listdir(tmp_path)
                 if f.startswith("health_blackbox")]
        box = json.load(open(tmp_path / dumps[0]))
        assert box["extra"]["ckpt_step"] == 5
        assert "preemption" in box["reason"]
        assert monitor.get("ckpt.preemptions") >= 1
    finally:
        if res.handler is not None:
            res.handler.uninstall()


def _port_run(ckdir, stop=None, seed=5, dropout=0.1, weights=None):
    torch.manual_seed(seed)
    cfg = GPTConfig(**dict(TINY, dropout=dropout))
    pm = GPTForPretraining(cfg, device="cpu", seed=seed)
    if weights is not None:
        load_jax_params(pm, weights)
    po = AdamW(learning_rate=1e-3, parameters=pm.parameters())
    res = ResilienceManager(str(ckdir), save_every=1, preempt=False)
    step = TrainStep(pm, pm.loss, po, resilience=res)
    start = res.resume() or 0
    losses = {}
    for i in range(start, stop or 6):
        ids, lbl = _batch(i)
        losses[i] = float(step(torch.from_numpy(ids).long(),
                               torch.from_numpy(lbl).long()))
    res.close()
    return losses, pm


def test_resume_gives_the_uninterrupted_losses_exactly(tmp_path):
    base, pa = _port_run(tmp_path / "base")
    first, _ = _port_run(tmp_path / "drill", stop=3)
    second, pb = _port_run(tmp_path / "drill", seed=123)
    assert {**first, **second} == base
    for (na, a), (nb, b) in zip(sorted(pa.state_dict().items()),
                                sorted(pb.state_dict().items())):
        assert na == nb and torch.equal(a, b)


def test_stitched_losses_track_the_jax_stitched_losses(tmp_path):
    jm, _ = _tiny_pair()
    weights = [(n, np.asarray(p._value)) for n, p in jm.named_parameters()]

    def jax_run(ckdir, stop=None):
        m = JaxGPT(JaxGPTConfig(**TINY))
        for (n, p), (_, w) in zip(m.named_parameters(), weights):
            p._value = paddle.to_tensor(w)._value
        o = jax_opt.AdamW(learning_rate=1e-3, parameters=m.parameters())
        res = jax_preempt.ResilienceManager(str(ckdir), save_every=1,
                                            preempt=False)
        step = paddle.jit.TrainStep(m, m.loss, o, resilience=res)
        start = res.resume(m, o) or 0
        out = {}
        for i in range(start, stop or 6):
            ids, lbl = _batch(i)
            out[i] = float(np.asarray(step(paddle.to_tensor(ids, "int32"),
                                           paddle.to_tensor(lbl, "int32"))
                                      .numpy()))
        res.close()
        return out

    jl = {**jax_run(tmp_path / "j", 3), **jax_run(tmp_path / "j")}
    pl = {**_port_run(tmp_path / "p", 3, dropout=0.0, weights=weights)[0],
          **_port_run(tmp_path / "p", dropout=0.0, seed=9)[0]}
    assert sorted(jl) == sorted(pl) == list(range(6))
    np.testing.assert_allclose([pl[i] for i in range(6)],
                               [jl[i] for i in range(6)], rtol=1e-5, atol=0)


def test_as_resilience_normalizes_like_jax(tmp_path):
    for mod, mgr_cls in ((jax_preempt, jax_ckpt.CheckpointManager),
                         (sys.modules["paddle_tpu_torch.resilience.preempt"],
                          CheckpointManager)):
        assert mod.as_resilience(None) is None
        assert mod.as_resilience(False) is None
        sub = tmp_path / mod.__name__
        res = mod.ResilienceManager(str(sub / "a"), preempt=False)
        assert mod.as_resilience(res) is res
        mgr = mgr_cls(str(sub / "b"))
        wrapped = mod.as_resilience(mgr)
        assert isinstance(wrapped, mod.ResilienceManager) and \
            wrapped.ckpt is mgr
        assert isinstance(mod.as_resilience(str(sub / "c")),
                          mod.ResilienceManager)
        kw = mod.as_resilience({"checkpoint_dir": str(sub / "d"),
                                "save_every": 7, "preempt": False})
        assert kw.save_every == 7
        with pytest.raises(TypeError, match="resilience="):
            mod.as_resilience(42)
    # elastic=: a coordinator attaches itself; anything else is kept
    for mod in (jax_preempt, sys.modules["paddle_tpu_torch.resilience.preempt"]):
        probe = object()
        res = mod.ResilienceManager(str(tmp_path / mod.__name__ / "e"),
                                    preempt=False, elastic=probe)
        assert res.elastic is probe


def test_pipeline_resilience_attribute(tmp_path):
    from paddle_tpu_torch.distributed import PipelineLayer, PipelineParallel
    torch.manual_seed(0)
    layer = PipelineLayer(
        [_init(Linear(4, 4), 0), torch.nn.ReLU(), _init(Linear(4, 2), 1)],
        num_stages=1,
        loss_fn=lambda out, y: torch.nn.functional.cross_entropy(out, y))
    pp = PipelineParallel(layer)
    opt = SGD(learning_rate=0.1, parameters=layer.parameters())
    pp.resilience = str(tmp_path)
    x, y = torch.randn(4, 4), torch.randint(0, 2, (4,))
    pp.train_batch((x, y), opt)
    res = pp._resilience_manager()
    res.save_every = 1
    pp.train_batch((x, y), opt)
    res.ckpt.drain()
    assert 2 in res.ckpt.steps() and res.ckpt.model is layer
    res.close()


# =========================================================================
# distributed/checkpoint.py
# =========================================================================

def test_train_epoch_range_walks_back_past_a_lost_checkpoint(tmp_path):
    net = _init(torch.nn.Sequential(Linear(4, 4)), 1)
    opt = SGD(learning_rate=0.1, parameters=list(net.named_parameters()))
    w = {}
    for epoch in train_epoch_range(3, name="job_wb",
                                   checkpoint_dir=str(tmp_path), model=net,
                                   optimizer=opt):
        _bump(net, 1.0)
        w[epoch] = _w(net)
    shutil.rmtree(os.path.join(str(tmp_path), "job_wb", "epoch_2"))
    net2 = _init(torch.nn.Sequential(Linear(4, 4)), 2)
    r2 = train_epoch_range(4, name="job_wb", checkpoint_dir=str(tmp_path),
                           model=net2, optimizer=opt)
    with pytest.warns(RuntimeWarning, match="walking back"):
        seen = list(r2)
    assert seen == [2, 3] and r2.restored_from.endswith("epoch_1")


def test_load_checkpoint_corruption_propagates(tmp_path):
    net, opt = _mlp()
    ck = str(tmp_path / "ck")
    save_checkpoint(ck, net, opt, async_save=False)
    assert verify_checkpoint(ck) == []
    piece = os.path.join(ck, "arrays", "model.0.weight", "0")
    with open(piece, "rb+") as f:
        f.truncate(10)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(Exception) as e:
            load_checkpoint(ck, net, opt)
    assert not isinstance(e.value, Warning)
    os.remove(piece)
    with pytest.raises(FileNotFoundError):
        load_checkpoint(ck, net, opt)


# =========================================================================
# health, /metrics, healthwatch
# =========================================================================

_HEALTH_RECS = [
    {"kind": "ckpt", "event": "save", "step": 1},
    {"kind": "ckpt", "event": "failed", "step": 2, "op": "save",
     "error": "RetryError: disk on fire"},
    {"kind": "ckpt", "event": "fallback", "step": 3,
     "problems": ["arrays/w/0: digest mismatch"]},
    {"kind": "ckpt", "event": "commit", "step": 4, "save_ms": 400.0},
    {"kind": "ckpt", "event": "commit", "step": 5, "save_ms": 5000.0},
]


def test_checkpoint_rules_fire_alike():
    jd = jax_health.AnomalyDetector(jax_health.HealthConfig(
        action="record", ckpt_stall_s=1.0))
    pd = AnomalyDetector(HealthConfig(action="record", ckpt_stall_s=1.0))
    for rec in _HEALTH_RECS:
        ja, pa = jd.observe(dict(rec)), pd.observe(dict(rec))
        assert [(a.kind, a.step, a.message) for a in pa] == \
            [(a.kind, a.step, a.message) for a in ja]
    assert pd.kinds() == jd.kinds() == ["checkpoint_failed",
                                        "checkpoint_stall"]


def test_the_port_records_fire_the_rules(tmp_path):
    net, opt = _mlp()
    pd = AnomalyDetector(HealthConfig(action="record", ckpt_stall_s=1e-9))
    mgr = CheckpointManager(str(tmp_path), net, opt,
                            retry=_fast(max_attempts=1))
    mgr.save(1, block=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with ChaosMonkey(ChaosConfig(io_error_rate=1.0)).active():
            with pytest.raises(CheckpointError):
                mgr.save(2, block=True)
    for rec in mgr.records:
        pd.observe(rec)
    assert sorted(pd.kinds()) == ["checkpoint_failed", "checkpoint_stall"]
    mgr.close()


def test_ckpt_metrics_on_the_http_endpoint(tmp_path):
    import urllib.request
    from paddle_tpu_torch.telemetry import MetricsServer
    net, opt = _mlp()
    mgr = CheckpointManager(str(tmp_path), net, opt, retry=_fast())
    mgr.save(1, block=True)
    with MetricsServer() as srv:
        text = urllib.request.urlopen(srv.url + "/metrics",
                                      timeout=5).read().decode()
        hz = json.loads(urllib.request.urlopen(
            srv.url + "/healthz", timeout=5).read().decode())
    for name in ("paddle_tpu_ckpt_saves", "paddle_tpu_ckpt_commits",
                 "paddle_tpu_ckpt_save_ms", "paddle_tpu_ckpt_bytes"):
        assert name in text
    assert hz["checkpoint"]["commits"] >= 1
    assert hz["checkpoint"]["last_step"] is not None
    mgr.close()


def test_healthwatch_replays_ckpt_records(tmp_path):
    bad = tmp_path / "ckpt_bad.jsonl"
    bad.write_text(json.dumps(
        {"schema": 1, "kind": "ckpt", "rank": 0, "step": 4,
         "event": "failed", "op": "restore", "error": "boom"}) + "\n")
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.healthwatch",
         str(bad), "--expect", "checkpoint_failed"],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stdout + r.stderr


# =========================================================================
# reshard, as pure functions
# =========================================================================

def test_layout_identity_equals_jax():
    cases = [None, {"dp": 2}, {"dp": 2, "mp": 1}, {"dp": 1, "mp": 2},
             {"dp": 2, "zero_stage": 1}, {"dp": 2, "zero_stage": 3}]
    for a in cases:
        assert normalize_layout(a) == jax_reshard.normalize_layout(a)
        for b in cases:
            assert layouts_differ(a, b) == jax_reshard.layouts_differ(a, b)
    with pytest.raises(ValueError):
        normalize_layout({"dp": 0})


def test_layout_from_mesh_equals_jax():
    import jax
    from paddle_tpu.distributed import env as jax_env
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.resilience import layout_from_mesh

    class _Mesh:     # the sizes a 4-rank dp 2 x mp 2 DeviceMesh reports
        mesh_dim_names = env.MESH_AXES

        def size(self, i):
            return (2, 1, 2, 1, 1)[i]

    jmesh = jax_env.build_mesh(dp=2, mp=2,
                               devices=np.asarray(jax.devices()[:4]))
    try:
        assert layout_from_mesh(_Mesh()) == \
            jax_reshard.layout_from_mesh(jmesh)
    finally:
        jax_env.set_mesh(None)


# the JAX reshard tests' (src, dst) pairs, as layouts and the 2-layer
# MLP's tags: dim 1 of the first weight and dim 0 of the second over mp
_PAIRS = [({"dp": 4}, {"dp": 2, "mp": 2}),
          ({"dp": 4, "zero_stage": 3}, {"dp": 2}),
          ({"mp": 2}, {"dp": 4, "zero_stage": 3})]
_LEAVES = [((8, 16), (None, "mp")), ((16, 8), ("mp", None)), ((16,), (None,)),
           ((3, 16, 10), (None, "mp", None))]


@pytest.mark.parametrize("src,dst", _PAIRS)
def test_pieces_of_one_layout_reassemble_for_another(src, dst):
    gen = torch.Generator().manual_seed(0)
    for shape, tags in _LEAVES:
        full = torch.randn(shape, generator=gen)
        pieces = layout_pieces(full, tags, src)
        table = {pc["file"]: t for pc, t in pieces}
        meta = {"shape": list(shape), "pieces": [pc for pc, _ in pieces]}
        whole = assemble_leaf(None, meta, load=lambda pc: table[pc["file"]])
        assert torch.equal(whole, full)
        lay = normalize_layout(dst)
        world = int(np.prod([lay[a] for a in ("dp", "pp", "mp", "sp",
                                                "ep")]))
        for rank in range(world):
            for zero in ("save", "load"):
                cut, flat, _ = piece_spec(shape, tags, dst, rank, zero=zero)
                direct = full
                for d, a in enumerate(tags):
                    if a is not None and lay[a] > 1:
                        direct = direct.chunk(lay[a], dim=d)[
                            rank_coords(dst, rank)[a]]
                if flat is not None:
                    direct = direct.reshape(-1)[flat[0]:flat[1]]
                assert torch.equal(cut_for(whole, cut, flat), direct)


def test_grouped_cuts_reassemble():
    full = torch.arange(2 * 24, dtype=torch.float32).reshape(2, 24)
    for lay in ({"mp": 2}, {"mp": 4, "zero_stage": 0}):
        pieces = layout_pieces(full, (None, "mp"), lay, groups=3)
        table = {pc["file"]: t for pc, t in pieces}
        meta = {"shape": [2, 24], "pieces": [pc for pc, _ in pieces]}
        assert torch.equal(assemble_leaf(
            None, meta, load=lambda pc: table[pc["file"]]), full)
