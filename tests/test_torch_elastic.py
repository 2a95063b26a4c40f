"""The port's elastic restarts (paddle_tpu_torch/distributed/elastic.py,
launch.py's relaunch policy, ResilienceManager(elastic=)) against the JAX
package's, on the CPU.

- managers: a port manager and a JAX manager share one registry
  directory and see each other's heartbeats; under one fake clock and
  sleep both give the same `alive_hosts` and `check` sequences, through
  the clock-skew and backoff cases of the JAX resilience tests;
- coordinators: the JAX and the port coordinator, under one fake clock
  and one registry script, emit equal event sequences (names, hosts,
  miss counts, detect_s, worlds, layouts) for the threshold, the reset
  on return, pod assembly that is not growth, and the drain with exit
  101 through each package's ResilienceManager;
- `elastic_run` classifies every failure as JAX's does, a collective
  timeout included;
- the launcher: `_restart_delay` is JAX's table, the 101 cap and
  backoff, a 102 resume, a 2-rank pod relaunched;
- a dead peer in a 2-rank gloo pod: rank 0's preemption all-reduce
  fails under the armed collective deadline, and rank 0 exits 101
  through `elastic_run` with `elastic.collective_timeouts` at 1;
- the host-loss drill (tools/elastic_drill.py) at a tiny width on the
  CPU.
"""
import importlib
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jax_nn
from paddle_tpu.distributed import collective as jax_collective
from paddle_tpu.distributed import elastic as jax_elastic
from paddle_tpu.resilience import preempt as jax_preempt

from paddle_tpu_torch import monitor
from paddle_tpu_torch.distributed import collective
from paddle_tpu_torch.distributed import elastic
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.resilience import (CheckpointManager, ResilienceManager,
                                         normalize_layout, stored_layout)

# the modules: each package's `distributed.launch` attribute is the function
jax_launch = importlib.import_module("paddle_tpu.distributed.launch")
launch = importlib.import_module("paddle_tpu_torch.distributed.launch")

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": jax_elastic, "port": elastic}


class FakeClock:
    def __init__(self):
        self.t = 0.0
        self.sleeps = []

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.sleeps.append(s)
        self.t += s


def _write_peer(reg, host, ts, np_=2):
    with open(os.path.join(reg, f"host-{host}.json"), "w") as f:
        f.write(json.dumps({"host": host, "ts": ts, "np": np_}))


# ---- managers -------------------------------------------------------------

def test_managers_share_a_registry_directory(tmp_path):
    reg = str(tmp_path)
    port = elastic.ElasticManager(reg, np=2, host_id="0", timeout=30.0,
                                  fault_tolerance_level=1).register()
    jax_m = jax_elastic.ElasticManager(reg, np=2, host_id="1", timeout=30.0,
                                       fault_tolerance_level=1).register()
    for m in (port, jax_m):
        assert m.alive_hosts() == ["0", "1"]
        assert m.check() == elastic.ElasticStatus.HOLD
    jax_m.deregister()
    assert port.alive_hosts() == ["0"]
    assert port.check() == elastic.ElasticStatus.RESTART
    port.level = 0
    assert port.check() == elastic.ElasticStatus.EXIT
    port.deregister()
    assert os.listdir(reg) == []


def _skew_script(mod, reg):
    """The clock-skew case: -> the alive_hosts sequence."""
    clk = FakeClock()
    m = mod.ElasticManager(reg, np=2, host_id="0", timeout=5.0,
                           fault_tolerance_level=1, clock=clk,
                           sleep=clk.sleep)
    seq = []
    m.heartbeat()
    _write_peer(reg, "1", ts=9_999_999_999.0)   # a clock an eon ahead
    seq.append((m.alive_hosts(), m.check()))
    clk.t += 4.0
    seq.append((m.alive_hosts(), m.check()))
    clk.t += 2.0                                # past the timeout
    seq.append((m.alive_hosts(), m.check()))
    _write_peer(reg, "1", ts=12.5)              # jumped backward: changed
    seq.append((m.alive_hosts(), m.check()))
    m.level = 0
    seq.append((m.alive_hosts(), m.check()))
    return seq


def test_manager_staleness_is_clock_skew_proof_like_jax(tmp_path):
    got = {k: _skew_script(mod, str(tmp_path / k))
           for k, mod in PACKAGES.items()}
    assert got["port"] == got["jax"]
    assert [a for a, _ in got["port"]] == [["0", "1"], ["0", "1"], [],
                                           ["1"], ["1"]]
    assert [c for _, c in got["port"]] == ["hold", "hold", "restart",
                                           "restart", "exit"]


@pytest.mark.parametrize("np_,backoff,checks", [(1, 2.0, 5), (2, 1.5, 3)])
def test_watch_sleeps_with_backoff_like_jax(tmp_path, np_, backoff, checks):
    got = {}
    for k, mod in PACKAGES.items():
        clk = FakeClock()
        m = mod.ElasticManager(str(tmp_path / k), np=np_, host_id="0",
                               timeout=8.0, heartbeat_interval=0.5,
                               fault_tolerance_level=1, clock=clk,
                               sleep=clk.sleep, backoff=backoff)
        got[k] = (m.watch(max_checks=checks), clk.sleeps)
    assert got["port"] == got["jax"]
    if np_ == 1:
        assert got["port"] == ("hold", [0.5, 1.0, 2.0, 4.0])
    else:       # alone in a pod of 2: not HOLD at once
        assert got["port"] == ("restart", [])


def test_manager_needs_one_backend():
    with pytest.raises(ValueError, match="exactly one"):
        elastic.ElasticManager()


# ---- coordinators ---------------------------------------------------------

def _events(coord):
    return [{k: v for k, v in e.items()} for e in coord.events]


def _coordinator(mod, reg, clk, **kw):
    m = mod.ElasticManager(reg, np=2, host_id="0", timeout=2.0,
                           fault_tolerance_level=1, clock=clk)
    kw.setdefault("exit_on_change", False)
    return mod.ElasticCoordinator(m, miss_threshold=3, clock=clk,
                                  poll_interval=0, **kw)


def _threshold_script(mod, reg):
    clk = FakeClock()
    coord = _coordinator(mod, reg, clk, plan_fn=lambda n: {"dp": n})
    _write_peer(reg, "1", ts=1.0)
    out = [coord.poll(step=1)]
    for t, step in ((3.0, 2), (3.5, 3), (4.0, 4)):
        clk.t = t
        out.append(coord.poll(step=step))
    out.append(coord.step_boundary(step=5))
    return out, _events(coord), coord.next_layout


def test_coordinator_declares_dead_after_threshold_like_jax(tmp_path):
    got = {k: _threshold_script(mod, str(tmp_path / k))
           for k, mod in PACKAGES.items()}
    assert got["port"] == got["jax"]
    polls, events, layout = got["port"]
    assert polls[:4] == [set(), set(), set(), {"1"}]
    assert [e["event"] for e in events] == ["heartbeat_miss"] * 3 + [
        "declared_dead", "replan", "relaunch"]
    dead = events[3]
    assert (dead["host"], dead["miss_count"], dead["detect_s"]) == \
        ("1", 3, 1.0)
    assert (events[4]["world_from"], events[4]["world_to"]) == (2, 1)
    assert layout == normalize_layout({"dp": 1}) == polls[4]


def _reset_script(mod, reg):
    clk = FakeClock()
    coord = _coordinator(mod, reg, clk)
    _write_peer(reg, "1", ts=1.0)
    coord.poll()
    clk.t = 3.0
    coord.poll()
    coord.poll()
    _write_peer(reg, "1", ts=3.0)              # the peer was only slow
    after_return = (coord.poll(), dict(coord._misses))
    clk.t = 6.0
    coord.poll()
    return after_return, dict(coord._misses), _events(coord)


def test_coordinator_miss_count_resets_on_return_like_jax(tmp_path):
    got = {k: _reset_script(mod, str(tmp_path / k))
           for k, mod in PACKAGES.items()}
    assert got["port"] == got["jax"]
    after_return, misses, events = got["port"]
    assert after_return == (set(), {})
    assert misses == {"1": 1}
    assert [e["miss_count"] for e in events] == [1, 2, 1]


def _assembly_script(mod, reg):
    clk = FakeClock()
    coord = _coordinator(mod, reg, clk, plan_fn=lambda n: {"dp": n})
    out = [coord.step_boundary(step=1)]          # alone: no change
    _write_peer(reg, "1", ts=1.0)
    out.append(coord.step_boundary(step=2))      # assembly: no change
    _write_peer(reg, "2", ts=1.0)                # beyond np 2: growth
    out.append(coord.step_boundary(step=3))
    return out, _events(coord)


def test_pod_assembly_is_not_growth_like_jax(tmp_path):
    got = {k: _assembly_script(mod, str(tmp_path / k))
           for k, mod in PACKAGES.items()}
    assert got["port"] == got["jax"]
    out, events = got["port"]
    assert out[:2] == [None, None]
    assert out[2] == normalize_layout({"dp": 3})
    assert [e["event"] for e in events] == ["replan", "relaunch"]


def _port_model():
    torch.manual_seed(11)
    net = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                              torch.nn.Linear(16, 8))
    return net, AdamW(learning_rate=0.01, parameters=net.parameters())


def _jax_model():
    paddle.seed(11)
    net = jax_nn.Sequential(jax_nn.Linear(8, 16), jax_nn.ReLU(),
                            jax_nn.Linear(16, 8))
    return net, paddle.optimizer.AdamW(learning_rate=0.01,
                                       parameters=net.parameters())


def _drain_script(mod, rm_cls, model, root, sink):
    clk = FakeClock()
    reg = os.path.join(root, "reg")
    os.makedirs(reg)
    net, opt = model()
    res = rm_cls(os.path.join(root, "ckpt"), model=net, optimizer=opt,
                 save_every=0, preempt=False, layout={"dp": 2}, sink=sink)
    m = mod.ElasticManager(reg, np=2, host_id="0", timeout=2.0,
                           fault_tolerance_level=1, clock=clk)
    coord = mod.ElasticCoordinator(m, miss_threshold=2, clock=clk,
                                   poll_interval=0,
                                   plan_fn=lambda n: {"dp": n},
                                   resilience=res)
    assert res.elastic is coord and coord.sink is res.ckpt.sink
    _write_peer(reg, "1", ts=1.0)
    res.step_boundary()             # sees the peer
    clk.t = 3.0
    res.step_boundary()             # miss 1
    with pytest.raises(SystemExit) as e:
        res.step_boundary()         # miss 2 -> dead -> drain -> exit
    return e.value.code, _events(coord), coord.next_layout


def test_coordinator_drains_and_exits_101_like_jax(tmp_path):
    sink = str(tmp_path / "ledger.jsonl")
    got = {
        "jax": _drain_script(jax_elastic, jax_preempt.ResilienceManager,
                             _jax_model, str(tmp_path / "jax"),
                             str(tmp_path / "jax_ledger.jsonl")),
        "port": _drain_script(elastic, ResilienceManager, _port_model,
                              str(tmp_path / "port"), sink)}
    assert got["port"] == got["jax"]
    code, events, layout = got["port"]
    assert code == elastic.ELASTIC_EXIT_CODE == 101
    assert [e["event"] for e in events] == [
        "heartbeat_miss", "heartbeat_miss", "declared_dead", "replan",
        "relaunch"]
    assert events[3]["layout_from"] == normalize_layout({"dp": 2})
    assert layout == normalize_layout({"dp": 1})
    # the drained checkpoint carries the old layout (the relaunch's
    # reshard route); the ledger holds both kinds and passes the checks
    mgr = CheckpointManager(str(tmp_path / "port" / "ckpt"))
    assert mgr.latest_step() == 3
    assert stored_layout(mgr) == normalize_layout({"dp": 2})
    from paddle_tpu_torch.telemetry.ledger_check import check_jsonl
    recs, problems = check_jsonl(sink)
    assert problems == []
    assert [r["event"] for r in recs if r["kind"] == "elastic"] == \
        [e["event"] for e in events]
    assert {"commit", "preempt"} <= {r["event"] for r in recs
                                     if r["kind"] == "ckpt"}


def test_coordinator_gauges_and_counters(tmp_path):
    before = {k: monitor.get(f"elastic.{k}") for k in (
        "heartbeat_miss", "declared_dead", "replan", "relaunch")}
    _threshold_script(elastic, str(tmp_path))
    for k, n in (("heartbeat_miss", 3), ("declared_dead", 1),
                 ("replan", 1), ("relaunch", 1)):
        assert monitor.get(f"elastic.{k}") == before[k] + n
    assert monitor.get_gauge("elastic.alive_hosts") == 1.0
    assert monitor.get_gauge("elastic.world_size") == 1.0


def test_coordinator_model_cfg_waits_for_the_planner(tmp_path):
    # the planner is ported: model_cfg= replans through planner.plan()
    from paddle_tpu_torch.models.gpt import GPTConfig
    m = elastic.ElasticManager(str(tmp_path), np=1)
    cfg = GPTConfig(vocab_size=256, hidden_size=64, num_layers=2,
                    num_heads=4, max_seq_len=64)
    coord = elastic.ElasticCoordinator(m, model_cfg=cfg)
    assert coord.plan_fn(2).layout.n_chips == 2
    with pytest.raises(ValueError, match="miss_threshold"):
        elastic.ElasticCoordinator(m, miss_threshold=0)


def test_resilience_elastic_polls_before_the_preemption_check(tmp_path):
    """step_boundary polls the coordinator with the advanced step, before
    the armed preemption request drains (the JAX order)."""
    calls = []

    class Probe:
        def attach(self, res):
            res.elastic = self
            return self

        def step_boundary(self, step):
            calls.append(("poll", step, handler.requested))

    from paddle_tpu_torch.resilience import PreemptionHandler
    net, opt = _port_model()
    probe, handler = Probe(), PreemptionHandler()
    res = ResilienceManager(str(tmp_path), model=net, optimizer=opt,
                            save_every=0, preempt=handler, elastic=probe)
    assert res.elastic is probe
    res.step_boundary()
    assert calls == [("poll", 1, False)]
    handler.request()
    with pytest.raises(SystemExit) as e:
        res.step_boundary()
    assert e.value.code == 102 and calls[-1] == ("poll", 2, True)


# ---- elastic_run ----------------------------------------------------------

def _tagged(exc, transient):
    exc.transient = transient
    return exc


def _failures(jax_side):
    cte = (jax_collective.CollectiveTimeoutError if jax_side
           else collective.CollectiveTimeoutError)
    return [RuntimeError("cuda"), ValueError("bug"), TypeError("bug"),
            KeyError("k"), FileNotFoundError("f"), PermissionError("p"),
            OSError(5, "eio"), TimeoutError(), ConnectionResetError(),
            _tagged(RuntimeError("chaos"), True),
            _tagged(RuntimeError("chaos"), False),
            cte("all_reduce", 5.0, axis="dp")]


def _outcome(mod, exc, manager=None):
    try:
        mod.elastic_run(lambda: (_ for _ in ()).throw(exc), manager=manager)
    except SystemExit as e:
        return ("exit", e.code)
    except Exception as e:      # noqa: BLE001 — the outcome is compared
        return ("raise", type(e).__name__)
    return ("returned",)


def test_elastic_run_classifies_like_jax(tmp_path):
    got = {k: [_outcome(mod, e) for e in _failures(k == "jax")]
           for k, mod in PACKAGES.items()}
    assert got["port"] == got["jax"]
    assert got["port"][0] == ("exit", 101)               # infra
    assert got["port"][1] == ("raise", "ValueError")     # a bug
    assert got["port"][-1] == ("exit", 101)              # dead peer
    # a level-0 manager whose pod changed re-raises instead
    for k, mod in PACKAGES.items():
        m = mod.ElasticManager(str(tmp_path / k), np=2, host_id="0",
                               fault_tolerance_level=0).register()
        assert _outcome(mod, RuntimeError("x"), m) == ("raise",
                                                       "RuntimeError")
        m.level = 1
        assert _outcome(mod, RuntimeError("x"), m) == ("exit", 101)
        assert mod.elastic_run(lambda: 7, manager=m) == 7
        assert m.alive_hosts() == []       # deregistered on success


# ---- the launcher ---------------------------------------------------------

def test_restart_delay_is_jax_table():
    for base in (0.0, 0.25, 0.5, 1.0, 40.0):
        for n in range(1, 12):
            assert launch._restart_delay(n, base) == \
                jax_launch._restart_delay(n, base)
    assert launch._restart_delay(30, 0.5) == 60.0
    assert launch.ELASTIC_EXIT_CODE == jax_launch.ELASTIC_EXIT_CODE == 101


def _counting_script(tmp_path, name, code_until):
    marker = tmp_path / f"{name}.n"
    script = tmp_path / f"{name}.py"
    script.write_text(
        "import os, sys\n"
        f"p = r'{marker}'\n"
        "if os.environ['PADDLE_TRAINER_ID'] != '0':\n"
        "    sys.exit(0)\n"
        "n = int(open(p).read()) if os.path.exists(p) else 0\n"
        "open(p, 'w').write(str(n + 1))\n"
        f"sys.exit({code_until[0]} if n < {code_until[1]} else 0)\n")
    return script, marker


def test_launch_relaunch_cap_and_backoff(tmp_path, monkeypatch):
    sleeps = []
    monkeypatch.setattr(launch, "_sleep", sleeps.append)
    script, marker = _counting_script(tmp_path, "cap", (101, 99))
    rc = launch.launch(["--elastic_level", "1", "--max_restarts", "2",
                        "--restart_backoff", "0.25", str(script)])
    assert rc == 101 and marker.read_text() == "3"
    assert sleeps == [0.25, 0.5]
    # level 0: a 101 is not relaunched
    sleeps.clear()
    script, marker = _counting_script(tmp_path, "lvl0", (101, 99))
    assert launch.launch([str(script)]) == 101
    assert marker.read_text() == "1" and sleeps == []
    # 102 resumes under its own cap
    script, marker = _counting_script(tmp_path, "resume", (102, 1))
    assert launch.launch(["--restart_backoff", "0.25", str(script)]) == 0
    assert marker.read_text() == "2" and sleeps == [0.25]


def test_launch_pod_relaunches_under_a_fresh_rendezvous(tmp_path,
                                                        monkeypatch):
    """A 2-rank pod whose rank 0 exits 101 is killed whole and started
    again; each attempt meets at a store of its own. (Rank 1 of the
    first attempt may be killed before it writes its line.)"""
    monkeypatch.setattr(launch, "_sleep", lambda s: None)
    stores = tmp_path / "stores.txt"
    script, marker = _counting_script(tmp_path, "pod", (101, 1))
    script.write_text(
        "import os\n"
        f"open(r'{stores}', 'a').write(os.environ['PADDLE_TRAINER_ID'] "
        "+ ' ' + os.environ['PADDLE_DIST_INIT_METHOD'] + '\\n')\n"
        + script.read_text())
    rc = launch.launch(["--nproc_per_node", "2", "--elastic_level", "1",
                        str(script)])
    assert rc == 0 and marker.read_text() == "2"
    lines = [ln.split() for ln in stores.read_text().splitlines()]
    rank0 = [init for r, init in lines if r == "0"]
    assert len(rank0) == 2 and len(set(rank0)) == 2
    assert {init for _, init in lines} == set(rank0)


# ---- a dead peer in a gloo pod --------------------------------------------

_DEAD_PEER = r'''
import json, os, sys, time
sys.path.insert(0, {root!r})
import torch
from paddle_tpu_torch import monitor
from paddle_tpu_torch.distributed import env
from paddle_tpu_torch.distributed.collective import collective_deadline
from paddle_tpu_torch.distributed.elastic import elastic_run
from paddle_tpu_torch.resilience import ResilienceManager
rank = int(sys.argv[1])
env.init_distributed(backend="gloo", init_method="tcp://127.0.0.1:{port}",
                     world_size=2, rank=rank, device="cpu")
net = torch.nn.Linear(4, 4)
res = ResilienceManager(os.path.join({out!r}, f"ckpt{{rank}}"), model=net,
                        save_every=0, preempt=False)
log = open(os.path.join({out!r}, f"rank{{rank}}.jsonl"), "a")

def train():
    for i in range(10_000):
        net(torch.ones(2, 4)).sum().backward()
        res.step_boundary()
        log.write(json.dumps({{"step": i + 1, "t": time.time()}}) + "\n")
        log.flush()
        time.sleep(0.05)

try:
    with collective_deadline({deadline}):
        elastic_run(train)
except SystemExit as e:
    log.write(json.dumps({{"exit": e.code, "t": time.time(),
        "timeouts": monitor.get("elastic.collective_timeouts")}}) + "\n")
    log.flush()
    raise
'''


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _lines(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(x) for x in f if x.strip()]


def test_dead_peer_in_a_gloo_pod_exits_101(tmp_path):
    deadline = 5.0
    script = tmp_path / "dead_peer.py"
    script.write_text(_DEAD_PEER.format(root=_ROOT, port=_free_port(),
                                        out=str(tmp_path),
                                        deadline=deadline))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen([sys.executable, str(script), str(r)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              start_new_session=True) for r in (0, 1)]
    try:
        end = time.monotonic() + 120
        while time.monotonic() < end:
            if len(_lines(tmp_path / "rank1.jsonl")) >= 2:
                break
            assert procs[0].poll() is None, procs[0].communicate()
            time.sleep(0.05)
        t_kill = time.time()
        os.killpg(procs[1].pid, signal.SIGKILL)
        _, err = procs[0].communicate(timeout=deadline + 30)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    assert procs[0].returncode == 101, err[-2000:]
    last = _lines(tmp_path / "rank0.jsonl")[-1]
    assert last["exit"] == 101 and last["timeouts"] == 1
    assert last["t"] - t_kill <= deadline + 10


def test_guarded_wait_escalates_a_lost_peer():
    class Lost:
        def wait(self, timeout=None):
            raise RuntimeError("[gloo/transport/tcp/pair.cc:553] Connection "
                               "closed by peer [127.0.0.1]:10118")
    before = monitor.get("elastic.collective_timeouts")
    with pytest.raises(collective.CollectiveTimeoutError,
                       match="'x' lost its peer") as ei:
        collective.guarded_wait("x", Lost(), deadline_s=30)
    assert ei.value.peer_lost_after_s < 30
    assert monitor.get("elastic.collective_timeouts") == before + 1

    class Refused:
        def wait(self, timeout=None):
            raise RuntimeError("Connection refused")
    with pytest.raises(RuntimeError, match="refused") as ei:
        collective.guarded_wait("x", Refused(), deadline_s=30)
    assert not isinstance(ei.value, collective.CollectiveTimeoutError)
    assert monitor.get("elastic.collective_timeouts") == before + 1
    with pytest.raises(RuntimeError, match="closed by peer"):
        collective.guarded_wait("x", Lost())       # no deadline armed


# ---- the drill ------------------------------------------------------------

def test_elastic_drill_tiny_on_the_cpu(tmp_path):
    report = tmp_path / "report.json"
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.elastic_drill",
         "--device", "cpu", "--tiny", "--dir", str(tmp_path / "d"),
         "--report", str(report), "--leg-timeout", "120"],
        cwd=_ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    rep = json.loads(report.read_text())
    assert rep["failures"] == []
    assert rep["exit_code"] == 101 and rep["resumed_via"] == "reshard"
    assert rep["resumed_from"] == rep["drained_step"]
    assert rep["events"][-3:] == ["declared_dead", "replan", "relaunch"]
    assert len(rep["relaunch_losses"]) == 2 and all(
        np.isfinite(rep["relaunch_losses"]))
    assert rep["ledger"]["elastic"] >= 5
