"""The port's TCP KV store (paddle_tpu_torch/csrc/kvstore.cc through
distributed/kvstore.py) and `dist_utils`' launch helpers against the
JAX package's, on the CPU.

- the store: every operation gives the same answers whichever package
  runs the server and whichever the client (the wire protocol is one);
  `wait` across two clients; `barrier` and `rank_assign` across 3
  processes;
- `ElasticManager(store=)`: a port manager and a JAX manager see each
  other's heartbeats through one store, either package's server; a lost
  store is tolerated alike;
- dist_utils: Hdfs, JobServer, Trainer, Pod, Cluster and `get_cluster`
  agree with JAX's field by field (`__str__`, `__eq__` both ways); the
  port, add_arguments and logger helpers; a local pod started, watched,
  its logs pulled, and a failing one terminated, with JAX's env
  contract.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import pytest

from paddle_tpu.distributed import dist_utils as jax_du
from paddle_tpu.distributed import elastic as jax_elastic
from paddle_tpu.distributed import kvstore as jax_kv

from paddle_tpu_torch.distributed import dist_utils as du
from paddle_tpu_torch.distributed import elastic
from paddle_tpu_torch.distributed import kvstore as kv

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KV = {"jax": jax_kv, "port": kv}
PAIRS = [("port", "port"), ("jax", "port"), ("port", "jax")]


def _session(cli):
    """One script of every operation; -> what each returned."""
    out = [cli.get("missing"), cli.get_str("missing", "dflt")]
    cli.set("a", "hello")
    out.append(cli.get_str("a"))
    cli.set("a", b"\x00\x01binary")
    out += [cli.get("a"), cli.add("ctr", 5), cli.add("ctr", -2),
            cli.add("ctr", 0)]
    for k in ("p/x", "p/y", "q/z"):
        cli.set(k, k.upper())
    out += [cli.list("p/"), cli.list(""), cli.delete("p/x"),
            cli.delete("p/x"), cli.list("p/"), cli.get("q/z")]
    cli.set("big", b"v" * (1 << 20))
    out.append(len(cli.get("big")))
    return out


@pytest.mark.parametrize("server,client", PAIRS)
def test_store_answers_alike_across_packages(server, client):
    with KV[server].KVServer() as srv, \
            KV[client].KVClient(port=srv.port) as cli:
        got = _session(cli)
    assert got == [None, "dflt", "hello", b"\x00\x01binary", 5, 3, 3,
                   ["p/x", "p/y"], ["a", "ctr", "p/x", "p/y", "q/z"],
                   True, False, ["p/y"], b"Q/Z", 1 << 20]


def test_store_wait_across_two_clients():
    with kv.KVServer() as srv:
        with kv.KVClient(port=srv.port) as a, \
                jax_kv.KVClient(port=srv.port) as b:
            a.set("shared", "from-a")
            assert b.wait("shared", timeout_s=5) == b"from-a"
            with pytest.raises(TimeoutError):
                a.wait("never", timeout_s=0.2)


def test_store_cannot_reach_a_closed_port():
    with kv.KVServer() as srv:
        port = srv.port
    with pytest.raises(ConnectionError, match="cannot reach"):
        kv.KVClient(port=port, retry_s=0.2)


def test_barrier_and_rank_assign_across_3_processes():
    world = 3
    with kv.KVServer() as srv:
        script = (
            "import sys, json\n"
            f"sys.path.insert(0, {_ROOT!r})\n"
            "from paddle_tpu_torch.distributed.kvstore import KVClient\n"
            f"kv = KVClient(port={srv.port})\n"
            f"rank = kv.rank_assign('t', {world}, timeout_s=60)\n"
            "kv.set(f'val/{rank}', str(rank * 10))\n"
            f"kv.barrier('done', {world}, timeout_s=60)\n"
            f"print(json.dumps([rank, sorted(kv.list('val/'))]))\n")
        procs = [subprocess.Popen([sys.executable, "-c", script],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for _ in range(world)]
        got = []
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
            got.append(json.loads(out.strip().splitlines()[-1]))
        # every process passed the barrier after all three had written
        assert sorted(r for r, _ in got) == [0, 1, 2]
        assert all(vals == ["val/0", "val/1", "val/2"] for _, vals in got)
        with kv.KVClient(port=srv.port) as c:
            assert c.add("__rank__/t", 0) == world
            with pytest.raises(RuntimeError, match="more than 3"):
                c.rank_assign("t", world)
            with pytest.raises(TimeoutError, match="1/2"):
                c.barrier("alone", 2, timeout_s=0.2)


# ---- ElasticManager over the store ----------------------------------------

@pytest.mark.parametrize("server", ["jax", "port"])
def test_managers_see_each_other_through_one_store(server):
    with KV[server].KVServer() as srv:
        # the port's manager on the port's client, the JAX manager on
        # JAX's, one store
        c0 = kv.KVClient(port=srv.port)
        c1 = jax_kv.KVClient(port=srv.port)
        m0 = elastic.ElasticManager(store=c0, np=2, host_id="0",
                                    timeout=30.0,
                                    fault_tolerance_level=1).register()
        m1 = jax_elastic.ElasticManager(store=c1, np=2, host_id="1",
                                        timeout=30.0,
                                        fault_tolerance_level=1).register()
        assert m0.alive_hosts() == m1.alive_hosts() == ["0", "1"]
        assert m0.check() == m1.check() == elastic.ElasticStatus.HOLD
        m1.deregister()
        assert m0.alive_hosts() == ["0"]
        assert m0.check() == elastic.ElasticStatus.RESTART
        m0.level = 0
        assert m0.check() == elastic.ElasticStatus.EXIT
        c0.close()
        c1.close()


def test_a_lost_store_is_tolerated_alike():
    got = {}
    for name, mod in (("jax", jax_elastic), ("port", elastic)):
        srv = kv.KVServer()
        cli = kv.KVClient(port=srv.port)
        m = mod.ElasticManager(store=cli, np=2, host_id="0",
                               fault_tolerance_level=1).register()
        before = m.alive_hosts()
        srv.stop()
        time.sleep(0.05)
        got[name] = (before, m.alive_hosts(), m.check())
        cli.close()
    assert got["port"] == got["jax"] == (["0"], [], "restart")


# ---- dist_utils' launch helpers -------------------------------------------

def _clusters(mod):
    return mod.get_cluster(["10.0.0.1", "10.0.0.2"], "10.0.0.2",
                           [["10.0.0.1:6170", "10.0.0.1:6171"],
                            ["10.0.0.2:6170", "10.0.0.2:6171"]], [0, 1])


def _fields(obj):
    if isinstance(obj, list):
        return [_fields(o) for o in obj]
    if hasattr(obj, "__dict__"):
        return {k: _fields(v) for k, v in vars(obj).items()}
    return obj


def test_get_cluster_agrees_with_jax_field_by_field():
    (c, pod), (jc, jpod) = _clusters(du), _clusters(jax_du)
    assert _fields(c) == _fields(jc) and _fields(pod) == _fields(jpod)
    assert str(c) == str(jc) and str(pod) == str(jpod)
    assert c == jc and jc == c and pod == jpod and not pod != jpod
    assert c.trainers_nranks() == jc.trainers_nranks() == 4
    assert c.pods_nranks() == 2
    assert c.trainers_endpoints() == jc.trainers_endpoints()
    assert c.pods_endpoints() == jc.pods_endpoints()
    assert c.get_pod_by_id(1) == pod and c.get_pod_by_id(7) is None
    assert pod.get_visible_gpus() == jpod.get_visible_gpus()
    pod.gpus = [0, 1]
    assert pod.get_visible_gpus() == "0,1"
    other = du.Cluster(hdfs=None)
    other.update_pods(c)
    assert other == c and other.pods is not c.pods
    c.pods[0].trainers[0].rank = 9
    assert c != jc and pod == jpod


def test_job_model_objects_agree_with_jax():
    for name in ("Hdfs", "JobServer", "Trainer", "Pod", "TrainerProc"):
        a, b = getattr(du, name)(), getattr(jax_du, name)()
        assert _fields(a) == _fields(b)
        if name != "TrainerProc":
            assert str(a) == str(b) and a == b
    h, jh = du.Hdfs(), jax_du.Hdfs()
    assert not h.is_valid()
    for obj in (h, jh):
        obj.hdfs_ugi, obj.hdfs_name, obj.hdfs_path = "u", "n", "/p"
    assert h.is_valid() and str(h) == str(jh) and h == jh
    j = du.JobServer()
    j.endpoint = "1.2.3.4:80"
    assert str(j) == "1.2.3.4:80" and j != du.JobServer()


def test_host_and_argument_helpers():
    ports = du.find_free_ports(3)
    assert len(ports) == 3 and all(isinstance(p, int) for p in ports)
    got = du.get_host_name_ip()
    assert got is None or (len(got) == 2 and all(got))
    for mod in (du, jax_du):
        ap = argparse.ArgumentParser()
        mod.add_arguments("use_x", bool, False, "flag.", ap)
        mod.add_arguments("n", int, 3, "count.", ap)
        ns = ap.parse_args(["--use_x", "yes", "--n", "7"])
        assert (ns.use_x, ns.n) == (True, 7)
        assert "Default: 3." in ap.format_help()
    lg = du.get_logger(20, name="paddle_tpu_torch.test_kvstore")
    assert lg.level == 20 and lg.handlers


_POD = ("import json, os, sys\n"
        "keys = ['PADDLE_TRAINER_ID', 'PADDLE_CURRENT_ENDPOINT', "
        "'PADDLE_TRAINERS_NUM', 'PADDLE_TRAINER_ENDPOINTS']\n"
        "print(json.dumps({k: os.environ[k] for k in keys}))\n"
        "sys.exit(int(os.environ.get('POD_EXIT_' + "
        "os.environ['PADDLE_TRAINER_ID'], '0')))\n")


def _run_pod(mod, tmp_path):
    script = tmp_path / "pod.py"
    script.write_text(_POD)
    c, pod = _clusters(mod)
    log_dir = tmp_path / mod.__name__
    procs = mod.start_local_trainers(c, pod, str(script), [],
                                     log_dir=str(log_dir))
    while mod.watch_local_trainers(procs, c.trainers_nranks()):
        time.sleep(0.05)
    envs = []
    for i in range(2):
        with open(log_dir / f"workerlog.{i}") as f:
            envs.append(json.loads(f.read().strip().splitlines()[-1]))
    return procs, envs


def test_local_pod_helpers_keep_jax_contract(tmp_path, capsys):
    procs, envs = _run_pod(du, tmp_path)
    _, jax_envs = _run_pod(jax_du, tmp_path)
    assert envs == jax_envs
    assert [e["PADDLE_TRAINER_ID"] for e in envs] == ["2", "3"]
    assert envs[0]["PADDLE_TRAINER_ENDPOINTS"].count(",") == 3
    assert [p.rank for p in procs] == [2, 3]
    assert [p.local_rank for p in procs] == [0, 1]
    capsys.readouterr()
    du.pull_worker_log(procs[0])
    assert '"PADDLE_TRAINER_ID": "2"' in capsys.readouterr().out
    du.pull_worker_log(procs[0])         # nothing new past the offset
    assert capsys.readouterr().out == ""
    du.terminate_local_procs(procs)


def test_watch_local_trainers_terminates_a_failed_pod(tmp_path,
                                                      monkeypatch):
    script = tmp_path / "pod.py"
    script.write_text(_POD.replace("sys.exit(", "import time\n"
                                   "time.sleep(60 if os.environ["
                                   "'PADDLE_TRAINER_ID'] == '3' else 0)\n"
                                   "sys.exit("))
    monkeypatch.setenv("POD_EXIT_2", "3")
    c, pod = _clusters(du)
    procs = du.start_local_trainers(c, pod, str(script), [])
    t0 = time.monotonic()
    with pytest.raises(SystemExit) as e:
        while du.watch_local_trainers(procs, c.trainers_nranks()):
            time.sleep(0.05)
    assert e.value.code == 3
    assert all(p.proc.poll() is not None for p in procs)
    assert time.monotonic() - t0 < 30
