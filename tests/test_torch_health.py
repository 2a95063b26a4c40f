"""The port's health monitor (paddle_tpu_torch.telemetry.health, the hang
watchdog, `TrainStep(health=)`, the training MetricsServer and the
healthwatch / memwatch tools) against the JAX package's, on the CPU.

- The detectors agree: every JAX specimen and a set of synthetic record
  sequences (one per rule family) go through the JAX `AnomalyDetector`
  and the port's; each record fires the same anomalies — kind, step,
  value, expected, message — with z within 1e-9.
- `TrainStep(health=)` on a tiny GPT, 5 f32 AdamW steps at every_k 1,
  against the JAX `TrainStep(health=)` on the same weights and batch:
  grad norm and update ratio within 1e-5 relative, NaN/Inf counts exact.
- The sharded taps' arithmetic (`health_rows`, `sharded_health_stats`)
  on tensors cut into pieces, summed with no collective, against the
  JAX `device_health_stats` on the whole tensors: finite and with NaN
  and Inf entries (the sharded steps' taps themselves are held against
  JAX in tests/test_torch_zero3.py and test_torch_pipeline.py).
- A NaN step raises `HealthError` in both (and, in the port, leaves the
  black-box dump an escaping exception leaves); a stalled step leaves
  one dump and a second stall in the same window none; an exception out
  of the step dumps; `MetricsServer` answers /healthz 503 while stalled.
- `healthwatch --selfcheck` and `memwatch --selfcheck` pass.
"""
import glob
import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jax_opt
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.telemetry import health as jax_health
from paddle_tpu.telemetry import watchdog as jax_watchdog

from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.optimizer import SGD, AdamW
from paddle_tpu_torch.telemetry import health, watchdog
from paddle_tpu_torch.telemetry.metrics_http import MetricsServer
from paddle_tpu_torch.telemetry.recorder import span
from paddle_tpu_torch.tools import healthwatch, memwatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECIMENS = sorted(glob.glob(os.path.join(REPO, "tools", "specimens",
                                          "*.jsonl")))


# ---------------------------------------------------------------------------
# the detectors agree
# ---------------------------------------------------------------------------

def _steps(n, loss=lambda i: 3.0 - 0.01 * i, grad=lambda i: 1.0,
           ms=lambda i: 100.0, rank=0, start=0, **extra):
    rs = np.random.RandomState(start + 7)
    out = []
    for i in range(start, start + n):
        out.append({"schema": 1, "kind": "step", "rank": rank, "step": i,
                    "step_ms": ms(i) + float(rs.rand()),
                    "compile_ms": 0.0,
                    "execute_ms": ms(i), "loss": loss(i) + 0.001 * rs.rand(),
                    "grad_norm": grad(i) + 0.01 * rs.rand(), **extra})
    return out


def _clean():
    return _steps(40)


def _loss_spike():
    return _steps(20) + _steps(1, loss=lambda i: 30.0, start=20) \
        + _steps(5, start=21)


def _grad_explosion():
    return _steps(20) + _steps(1, grad=lambda i: 500.0, start=20)


def _step_time_regression():
    recs = _steps(20)
    slow = _steps(2, ms=lambda i: 900.0, start=20)
    for r in slow[:1]:
        r["compile_ms"] = 800.0         # a recompile: exempt
    return recs + slow + _steps(1, ms=lambda i: 1000.0, start=22)


def _nan():
    recs = _steps(10)
    bad = _steps(1, start=10)[0]
    bad.update(loss=float("nan"), nan_count=3, inf_count=1)
    gn = _steps(1, start=11)[0]
    gn["grad_norm"] = float("inf")
    return recs + [bad, gn] + _steps(3, start=12)


def _phase():
    return [{"schema": 1, "kind": "phase", "rank": 0, "phase": "train",
             "metrics": {"tokens_per_sec": 1.0}},
            {"schema": 1, "kind": "phase", "rank": 0, "phase": "serve",
             "metrics": {"error": "boom"}},
            {"schema": 1, "kind": "phase", "rank": 0, "phase": "decode",
             "metrics": {"ms": float("nan")}}]


def _memsnap():
    def rec(step, total, budget=1000, ev=None, adm=None, engine=0,
            proj=None):
        r = {"schema": 1, "kind": "memsnap", "rank": 0, "event": "snapshot",
             "step": step, "total_bytes": total, "engine": engine,
             "hbm_budget_bytes": budget}
        if ev is not None:
            r.update(kv_eviction_rate=ev, kv_admission_rate=adm)
        if proj is not None:
            r.update(projected_bytes=proj, projection_family="f")
        return r
    return [rec(1, 500), rec(2, 950), rec(3, 960), rec(4, 600),
            rec(5, 990), rec(6, 100, ev=5.0, adm=1.0),
            rec(7, 100, ev=6.0, adm=1.0), rec(8, 100, ev=0.5, adm=0.0),
            rec(9, 100, ev=9.0, adm=2.0, engine=1),
            rec(10, 100, budget=None, proj=50),
            rec(11, 100, budget=None, proj=100),
            rec(12, 400, budget=None, proj=100)]


def _kernelbench():
    def rec(kernel, ms, pred):
        return {"schema": 1, "kind": "kernelbench", "rank": 0,
                "kernel": kernel, "sig": "f32[1]", "backend": "cuda",
                "kernel_ms": ms, "predicted_ms": pred}
    return [rec("a", 10.0, 1.0), rec("a", 20.0, 1.0), rec("a", 2.0, 1.0),
            rec("a", 30.0, 1.0), rec("b", 0.1, 1.0), rec("c", 1.0, None),
            rec("d", 1.5, 1.0)]


def _reqtrace():
    def rec(rid, queued, decode):
        return {"schema": 1, "kind": "reqtrace", "rank": 0, "rid": rid,
                "outcome": "finished", "e2e_ms": queued + decode,
                "spans": [{"kind": "queued", "t0_ms": 0.0,
                           "dur_ms": queued, "reason": "submit"},
                          {"kind": "decode", "t0_ms": queued,
                           "dur_ms": decode}]}
    return [rec(i, 900.0 if i % 2 else 10.0, 100.0) for i in range(12)]


def _ckpt():
    def rec(step, event, **kw):
        return {"schema": 1, "kind": "ckpt", "rank": 0, "step": step,
                "event": event, **kw}
    return [rec(1, "commit", save_ms=1000.0),
            rec(2, "commit", save_ms=400000.0),
            rec(3, "failed", op="save", error="disk full"),
            rec(4, "fallback", problems=["bad digest"]),
            rec(5, "save")]


def _straggler():
    recs = []
    for s in range(6):
        for rank, ms in ((0, 100.0), (1, 105.0), (2, 300.0 if s < 3
                                                  else 101.0)):
            recs.append({"schema": 1, "kind": "step", "rank": rank,
                         "step": s, "step_ms": ms, "compile_ms": 0.0,
                         "execute_ms": ms})
    return recs


def _recompile_storm():
    def rec(step, n, **kw):
        return {"schema": 1, "kind": "compile", "rank": 0,
                "fn": kw.pop("fn", "TrainStep"), "step": step,
                "compile_ms": 100.0, "n_compiles": n, **kw}
    recs = [rec(0, 1)] + [rec(s, s + 1, cause=[f"shape {s}"])
                          for s in range(1, 8)]
    recs.append(rec(9, 1, fn="Other", hbm={"total_bytes": 2000},
                    hbm_projected_bytes=1000))
    recs.append(rec(10, 2, fn="Other", cost={"flops": 100.0},
                    analytic_flops=200.0))
    return recs


def _commbench():
    def rec(op, ms, db):
        return {"schema": 1, "kind": "commbench", "rank": 0, "op": op,
                "axis": "dp", "axis_size": 4, "payload_bytes": 1024,
                "backend": "cuda", "time_ms": ms, "db_ms": db}
    return [rec("psum", 1.0, 1.0), rec("psum", 3.5, 1.0),
            rec("psum", 4.0, 1.0), rec("all_gather", 1.0, None)]


SEQUENCES = {
    "clean": _clean, "loss_spike": _loss_spike,
    "grad_explosion": _grad_explosion,
    "step_time_regression": _step_time_regression, "nan": _nan,
    "phase": _phase, "memsnap": _memsnap, "kernelbench": _kernelbench,
    "reqtrace_tail": _reqtrace, "ckpt": _ckpt, "straggler": _straggler,
    "recompile_storm": _recompile_storm, "commbench": _commbench,
}


def _norm(found):
    out = []
    for a in found:
        d = a.to_dict()
        z = d.pop("z", None)
        out.append((d, z))
    return out


def _replay_both(records):
    jd = jax_health.AnomalyDetector(jax_health.HealthConfig(action="record"))
    td = health.AnomalyDetector(health.HealthConfig(action="record"))
    fired = []
    for rec in records:
        j = _norm(jd.observe(json.loads(json.dumps(rec))))
        t = _norm(td.observe(json.loads(json.dumps(rec))))
        assert [d for d, _ in t] == [d for d, _ in j], rec
        for (_, zt), (_, zj) in zip(t, j):
            if zj is None or isinstance(zj, str):
                assert zt == zj
            else:
                assert abs(zt - zj) <= 1e-9
        fired += [d["kind"] for d, _ in t]
    assert td.kinds() == jd.kinds()
    return fired


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_detectors_agree_on_synthetic_sequences(name):
    fired = _replay_both(SEQUENCES[name]())
    if name == "clean":
        assert fired == []
    else:
        assert fired, f"{name}: the sequence fired nothing"


@pytest.mark.parametrize("path", SPECIMENS, ids=os.path.basename)
def test_detectors_agree_on_the_jax_specimens(path):
    with open(path) as f:
        records = [json.loads(line) for line in f if line.strip()]
    _replay_both(records)


def test_synthetic_sequences_cover_every_rule():
    fired = set()
    for make in SEQUENCES.values():
        fired |= set(_replay_both(make()))
    assert fired == {
        "nan", "loss_spike", "grad_explosion", "step_time_regression",
        "phase_error", "recompile_storm", "hbm_projection_drift",
        "flops_drift", "checkpoint_failed", "checkpoint_stall",
        "kernel_time_drift", "comm_bw_degraded", "straggler",
        "tail_latency", "hbm_pressure", "kv_thrash",
        "mem_projection_drift"}


# ---------------------------------------------------------------------------
# TrainStep(health=) against the JAX TrainStep(health=)
# ---------------------------------------------------------------------------

_MODEL = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
              max_seq_len=64, dropout=0.0, initializer_range=0.02)


@pytest.mark.parametrize("poison", [False, True])
def test_sharded_taps_of_pieces_are_the_jax_taps(poison):
    """Three gradients and parameters, each cut into two flat pieces (a
    rank's dp pieces): the rows summed (what `sum_over_cuts` does over
    the ranks) give JAX's stats of the whole tensors; with NaN and Inf
    entries the counts are exact."""
    import jax.numpy as jnp
    rs = np.random.RandomState(7)
    shapes = [(5, 4), (7,), (3, 3)]
    grads = [rs.randn(*s).astype(np.float32) for s in shapes]
    old = [rs.randn(*s).astype(np.float32) for s in shapes]
    new = [o - 0.01 * g for o, g in zip(old, grads)]
    if poison:
        grads[0][1, 2] = np.nan
        grads[2][0, 0] = grads[2][2, 1] = np.inf
    loss = np.float32(3.25)
    want = np.asarray(jax_health.device_health_stats(
        jnp.asarray(loss), [jnp.asarray(g) for g in grads],
        [jnp.asarray(n) for n in new], [jnp.asarray(o) for o in old]))
    idx, gp, npc, opc = [], [], [], []
    for k, (g, n, o) in enumerate(zip(grads, new, old)):
        for part in (slice(0, 3), slice(3, None)):
            idx.append(k)
            gp.append(torch.from_numpy(g.reshape(-1)[part].copy()))
            npc.append(torch.from_numpy(n.reshape(-1)[part].copy()))
            opc.append(torch.from_numpy(o.reshape(-1)[part].copy()))
    rows = health.health_rows(3, idx, grads=gp) + health.health_rows(
        3, idx, new_vals=npc, param_vals=opc)
    got = health.sharded_health_stats(torch.tensor(loss), rows,
                                      lambda r: r).numpy()
    assert got.shape == (5,)
    np.testing.assert_allclose(got, want, rtol=1e-6, equal_nan=True)
    assert (got[2], got[3]) == ((1.0, 2.0) if poison else (0.0, 0.0))


def test_train_step_taps_track_the_jax_taps():
    paddle.seed(5)
    jm = JaxGPT(JaxGPTConfig(**_MODEL))
    arrays = [(n, np.asarray(p._value)) for n, p in jm.named_parameters()]
    jo = jax_opt.AdamW(learning_rate=1e-4, weight_decay=0.01,
                       parameters=jm.parameters())
    jstep = paddle.jit.TrainStep(
        jm, jm.loss, jo, health=jax_health.HealthConfig(
            every_k=1, action="record", dump_on_exception=False))
    tm = load_jax_params(GPTForPretraining(GPTConfig(**_MODEL),
                                           device="cpu"), arrays)
    to = AdamW(learning_rate=1e-4, weight_decay=0.01,
               parameters=tm.parameters())
    tstep = TrainStep(tm, tm.loss, to, health=health.HealthConfig(
        every_k=1, action="record", dump_on_exception=False))
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 512, (2, 64)).astype(np.int32)
    lbl = rs.randint(0, 512, (2, 64)).astype(np.int32)
    for _ in range(5):
        jstep(paddle.to_tensor(ids, "int32"), paddle.to_tensor(lbl, "int32"))
        tstep(torch.from_numpy(ids), torch.from_numpy(lbl))
    jr, tr = list(jstep.health.ring), list(tstep.health.ring)
    assert len(jr) == len(tr) == 5
    for j, t in zip(jr, tr):
        for key in ("grad_norm", "update_ratio", "loss"):
            assert t[key] == pytest.approx(j[key], rel=1e-5, abs=0), key
        assert (t["nan_count"], t["inf_count"]) == (j["nan_count"],
                                                    j["inf_count"]) == (0, 0)
        assert t["grad_norm"] > 0 and t["update_ratio"] > 0
    # the pre-update copy: one copy of the trainable parameters
    assert tstep.tap_bytes == sum(p.numel() * 4 for p in tm.parameters())
    assert jstep.health.anomalies == [] and tstep.health.anomalies == []


def test_taps_are_built_only_on_fetch_steps():
    net = Linear(8, 4, device="cpu")
    opt = SGD(learning_rate=0.05, parameters=net.parameters())
    step = TrainStep(net, lambda x, y: ((net(x) - y) ** 2).mean(), opt,
                     health={"every_k": 3, "action": "record"})
    x, y = torch.ones(4, 8), torch.zeros(4, 4)
    staged = []
    for _ in range(6):
        step(x, y)
        staged.append(step._last_health is not None)
    assert staged == [False, False, True, False, False, True]
    assert len(step.health.ring) == 2


def _linear_pair(health_cfg):
    jnet = paddle.nn.Linear(8, 4)
    jo = jax_opt.SGD(learning_rate=0.05, parameters=jnet.parameters())
    jstep = paddle.jit.TrainStep(
        jnet, lambda x, y: ((jnet(x) - y) ** 2).mean(), jo,
        health=jax_health.HealthConfig(**health_cfg))
    tnet = Linear(8, 4, device="cpu")
    to = SGD(learning_rate=0.05, parameters=tnet.parameters())
    tstep = TrainStep(tnet, lambda x, y: ((tnet(x) - y) ** 2).mean(), to,
                      health=health.HealthConfig(**health_cfg))
    return jstep, tstep


def _dumps(d):
    return sorted(f for f in os.listdir(d)
                  if f.startswith("health_blackbox_"))


def test_nan_raises_health_error_in_both(tmp_path):
    jstep, tstep = _linear_pair(dict(every_k=1, action="raise",
                                     dump_on_exception=False))
    bad = np.full((4, 8), np.inf, np.float32)
    y = np.zeros((4, 4), np.float32)
    with pytest.raises(jax_health.HealthError) as je:
        jstep(paddle.to_tensor(bad), paddle.to_tensor(y))
    with pytest.raises(health.HealthError) as te:
        tstep(torch.from_numpy(bad), torch.from_numpy(y))
    assert [a.kind for a in te.value.anomalies] \
        == [a.kind for a in je.value.anomalies] == ["nan"]
    assert te.value.anomalies[0].value == je.value.anomalies[0].value
    # with dumps on, the port's HealthError leaves the black box an
    # escaping exception leaves
    _, tstep = _linear_pair(dict(every_k=1, action="raise",
                                 dump_dir=str(tmp_path)))
    with pytest.raises(health.HealthError):
        tstep(torch.from_numpy(bad), torch.from_numpy(y))
    assert len(_dumps(tmp_path)) == 1


def test_dump_sections_equal_the_jax_dump(tmp_path):
    jp = jax_watchdog.dump_black_box("j", path=str(tmp_path / "j.json"))
    tp = watchdog.dump_black_box("t", path=str(tmp_path / "t.json"),
                                 ring=[{"step": 1}])
    jb, tb = json.load(open(jp)), json.load(open(tp))
    assert sorted(tb) == sorted(jb)
    assert tb["kind"] == "health_blackbox" and tb["ring"] == [{"step": 1}]
    assert tb["locks"] == []


def test_a_stall_dumps_once_per_window(tmp_path):
    wd = watchdog.HangWatchdog(deadline_s=0.05, dump_dir=str(tmp_path),
                               poll_s=0.01).start()
    try:
        wd.step_opened()
        with span("stuck.region"):
            time.sleep(0.3)
            assert len(_dumps(tmp_path)) == 1
            time.sleep(0.2)             # still the same armed window
        assert len(_dumps(tmp_path)) == 1 and wd.fires == 1
        box = json.load(open(os.path.join(tmp_path, _dumps(tmp_path)[0])))
        assert [s["name"] for s in box["open_spans"]] == ["stuck.region"]
        assert wd.overdue_s() > 0
        wd.step_closed()
        assert not wd.armed and wd.overdue_s() == 0.0
    finally:
        wd.stop()


def test_an_exception_out_of_the_step_dumps(tmp_path):
    net = Linear(8, 4, device="cpu")
    opt = SGD(learning_rate=0.05, parameters=net.parameters())

    def loss_fn(x, y):
        raise RuntimeError("the loss failed")

    step = TrainStep(net, loss_fn, opt, health=health.HealthConfig(
        every_k=1, action="record", hang_deadline_s=30.0,
        dump_dir=str(tmp_path)))
    try:
        with pytest.raises(RuntimeError, match="the loss failed"):
            step(torch.ones(4, 8), torch.zeros(4, 4))
        dumps = _dumps(tmp_path)
        assert len(dumps) == 1
        box = json.load(open(os.path.join(tmp_path, dumps[0])))
        assert "the loss failed" in box["reason"]
        assert not step.health.watchdog.armed
    finally:
        step.health.close()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_metrics_server_answers_503_while_stalled(tmp_path):
    mon = health.HealthMonitor(health.HealthConfig(
        every_k=1, action="record", hang_deadline_s=0.05,
        dump_dir=str(tmp_path)))
    srv = MetricsServer(health=mon).start()
    try:
        assert _get(srv.url + "/healthz")[0] == 200
        mon.step_open()
        time.sleep(0.2)
        code, body = _get(srv.url + "/healthz")
        assert code == 503 and body["status"] == "stalled"
        assert body["watchdog"]["overdue_s"] > 0
        mon.step_close(loss=1.0)
        code, body = _get(srv.url + "/healthz")
        assert code == 200 and body["status"] == "ok"
        code, steps = _get(srv.url + "/steps?n=5")
        assert code == 200 and steps[-1]["loss"] == 1.0
        assert len(_dumps(tmp_path)) == 1
        with urllib.request.urlopen(srv.url + "/metrics", timeout=10) as r:
            text = r.read().decode()
        assert "paddle_tpu_last_step_loss 1" in text
    finally:
        srv.stop()
        mon.close()


def test_healthwatch_and_memwatch_selfchecks(capsys):
    assert healthwatch.main(["--selfcheck"]) == 0
    assert memwatch.main(["--selfcheck"]) == 0
    out = capsys.readouterr().out
    assert "selfcheck OK" in out and "memwatch selfcheck OK" in out


def test_healthwatch_gate_mode_matches_the_jax_tool(capsys):
    spec = os.path.join(REPO, "tools", "specimens", "health_anomalous.jsonl")
    assert healthwatch.main([spec]) == 5
    assert healthwatch.main([spec, "--expect", "phase_error"]) == 9
    text = capsys.readouterr().out
    for kind in ("nan", "loss_spike", "grad_explosion",
                 "step_time_regression"):
        assert f"[{kind}]" in text
