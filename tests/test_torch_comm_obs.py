"""The port's mesh observatory (telemetry/comm_obs.py), its records and
their checks, held against the JAX package's: the payload ladder, DB
keys, wire bytes, attribution (a hand-computed case and the gloo / CPU
exemption), a measurement under a fake clock, the per-rank skew, the
DB's keep-best and refuse-non-finite rules, and the commbench/plan
ledger rules; the commlab CLI's selfcheck."""
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

from paddle_tpu.telemetry import comm_obs as jco
from paddle_tpu.telemetry import sink as jsink

from paddle_tpu_torch.distributed import env
from paddle_tpu_torch.telemetry import comm_obs as co
from paddle_tpu_torch.telemetry import ledger_check, sink

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _trace_check():
    spec = importlib.util.spec_from_file_location(
        "trace_check_jax", os.path.join(ROOT, "tools", "trace_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Tick:
    """A clock that advances one second a read."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


@pytest.fixture
def world1(tmp_path):
    """A one-rank gloo process group on the CPU and its mesh."""
    import torch.distributed as dist
    env.init_distributed("gloo", init_method=f"file://{tmp_path}/store",
                         world_size=1, rank=0, device="cpu")
    try:
        yield env.build_mesh()
    finally:
        env.clear_mesh()
        dist.destroy_process_group()
        env._STATE.update(backend=None, device=None, local_rank=0)


def test_ladder_keys_and_wire_bytes_equal_jax():
    assert co.payload_sweep() == jco.payload_sweep()
    assert co.payload_sweep(256 * 1024, 16 << 20) == \
        jco.payload_sweep(256 * 1024, 16 << 20) and \
        len(co.payload_sweep(256 * 1024, 16 << 20)) == 7
    assert co.SWEEP_OPS == jco.SWEEP_OPS
    assert co.db_key("psum", 4, 262144, "gloo") == \
        jco.db_key("psum", 4, 262144, "gloo") == "psum|ax4|262144|gloo"
    for op in co.SWEEP_OPS:
        for n in (1, 2, 3, 4, 8):
            for b in (1, 4096, 1 << 20):
                assert co.wire_bytes(op, b, n) == jco.wire_bytes(op, b, n)


def test_attribution_equals_jax_and_exempts_gloo():
    for args in (("psum", 1 << 20, 4, 0.5), ("all_gather", 4096, 2, 0.01),
                 ("ppermute", 65536, 8, 0.0)):
        want = jco.attribution(*args, peak_bw=1e11)
        assert co.attribution(*args, peak_bw=1e11) == want
        assert co.attribution(*args, over_dcn=True, peak_bw=5e10) == \
            jco.attribution(*args, over_dcn=True, peak_bw=5e10)
    # hand-computed: a 1 MiB psum over 4 ranks moves 2 * 3/4 MiB
    got = co.attribution("psum", 1 << 20, 4, 0.5, peak_bw=1e11)
    assert got["wire_bytes"] == 1.5 * (1 << 20)
    assert got["achieved_bw"] == 1.5 * (1 << 20) / 5e-4
    assert got["predicted_ms"] == 1.5 * (1 << 20) / 1e11 * 1e3
    assert got["medium"] == "ici"
    # no peak: gloo through the host (the port), a CPU backend (JAX)
    assert co.attribution("psum", 1 << 20, 4, 0.5, device_kind="gloo") == \
        jco.attribution("psum", 1 << 20, 4, 0.5, device_kind="cpu")
    gloo = co.attribution("psum", 1 << 20, 4, 0.5, device_kind="gloo")
    assert (gloo["bw_frac"], gloo["predicted_ms"], gloo["medium"]) == \
        (None, None, None)
    h100 = co.attribution("psum", 1 << 20, 4, 0.5,
                          device_kind="NVIDIA H100 80GB HBM3")
    assert h100["peak_bw"] == 900e9 and h100["bw_frac"] is not None


def test_measure_collective_under_a_fake_clock_equals_jax(world1):
    import jax
    from jax.sharding import Mesh
    jmesh = Mesh(np.asarray(jax.devices()[:1]), ("dp",))
    keys = ("op", "axis", "axis_size", "payload_bytes", "time_ms",
            "compile_ms", "wire_bytes", "achieved_bw", "bw_frac",
            "predicted_ms", "n_samples", "warmup", "db_ms")
    for op in ("psum", "all_gather", "reduce_scatter", "all_to_all"):
        for payload in (16384, 100000):
            got = co.measure_collective(op, "dp", mesh=world1,
                                        payload_bytes=payload, warmup=1,
                                        k=3, clock=Tick())
            want = jco.measure_collective(op, "dp", mesh=jmesh,
                                          payload_bytes=payload, warmup=1,
                                          k=3, clock=Tick())
            assert {k: getattr(got, k) for k in keys} == \
                {k: getattr(want, k) for k in keys}
            assert (got.backend, got.time_ms, got.compile_ms) == \
                ("gloo", 1000.0, 1000.0)
    res = co.sweep_mesh(mesh=world1, payloads=[16384], warmup=0, k=1,
                        axes=["dp"], clock=Tick())
    assert [r.op for r in res] == list(co.SWEEP_OPS[:4])   # no ppermute
    recs = [r.to_record() for r in res]
    assert ledger_check.check_records(recs) == []
    assert co.sweep_axes(world1) == []


def test_rank_step_skew_equals_jax():
    recs = [{"kind": "step", "step": s, "rank": r, "step_ms": ms}
            for s, r, ms in ((0, 0, 10.0), (0, 1, 13.5), (1, 0, 9.0),
                             (1, 1, 9.0), (1, 2, 30.0), (2, 0, 5.0),
                             (3, 0, float("nan")), (3, 1, 4.0))]
    recs.append({"kind": "plan", "step": 0, "rank": 3, "step_ms": 1.0})
    assert co.rank_step_skew(recs) == jco.rank_step_skew(recs)
    assert co.rank_step_skew(recs)[1] == {0: 0.0, 1: 0.0, 2: 21.0}


def test_comm_db_keep_best_and_refuse_non_finite_equal_jax(tmp_path):
    rows = [[("psum|ax2|16384|gloo", {"best_ms": 2.0})],
            [("psum|ax2|16384|gloo", {"best_ms": 3.0}),
             ("all_gather|ax2|16384|gloo", {"best_ms": 1.0})],
            [("psum|ax2|16384|gloo", {"best_ms": 1.5}),
             ("ppermute|ax2|16384|gloo", {"best_ms": float("nan")}),
             ("all_to_all|ax2|16384|gloo",
              {"best_ms": 1.0, "wire_bytes": float("inf")})]]
    dbs = {"port": co.CommDB(str(tmp_path / "p.json")),
           "jax": jco.CommDB(str(tmp_path / "j.json"))}
    for batch in rows:
        got = {k: db.update(batch) for k, db in dbs.items()}
        assert got["port"] == got["jax"]
    assert dbs["port"].entries == dbs["jax"].entries
    assert dbs["port"].best_ms("psum", 2, 16384, "gloo") == 1.5
    dbs["port"].save()
    assert co.CommDB(str(tmp_path / "p.json")).entries == \
        dbs["port"].entries
    assert co.CommDB(co.DEFAULT_DB_PATH).entries == {}
    assert dbs["port"].lookup("psum", backend="gloo") == \
        dbs["jax"].lookup("psum", backend="gloo")


def test_db_flag_is_the_ports_own(monkeypatch):
    monkeypatch.delenv(co.ENV_FLAG, raising=False)
    assert co.ENV_FLAG == "PADDLE_TPU_TORCH_COMM_DB"
    assert co.db_flag_path() is None
    monkeypatch.setenv(co.ENV_FLAG, "1")
    assert co.db_flag_path() == co.DEFAULT_DB_PATH
    assert co.DEFAULT_DB_PATH.endswith(
        os.path.join("paddle_tpu_torch", "tools", "comm_db.json"))
    monkeypatch.setenv(co.ENV_FLAG, "0")
    assert co.db_flag_path() is None


def _commbench(**kw):
    base = dict(op="psum", axis="dp", axis_size=4, payload_bytes=1 << 20,
                backend="nccl", time_ms=0.5, wire_bytes=1.5 * (1 << 20),
                achieved_bw=1.5 * (1 << 20) / 5e-4, peak_bw=9e11,
                bw_frac=1.5 * (1 << 20) / 5e-4 / 9e11,
                predicted_ms=1.5 * (1 << 20) / 9e11 * 1e3,
                db_key="psum|ax4|1048576|nccl", event="measure")
    base.update(kw)
    return base


def test_records_and_their_rules_equal_jax():
    tc = _trace_check()
    specs = [_commbench(), _commbench(time_ms=float("nan")),
             _commbench(achieved_bw=1.0), _commbench(bw_frac=0.9),
             _commbench(predicted_ms=99.0), _commbench(wire_bytes=1e9),
             _commbench(event="db_update", db_key="other"),
             _commbench(op="bogus", medium="ici"), _commbench(medium="x")]
    recs = [sink.make_commbench_record(**k) for k in specs]
    assert recs == [jsink.make_commbench_record(**k) for k in specs]
    plans = [dict(model="m", chosen={"dp": 2, "pp": 1, "mp": 2, "sp": 1,
                                     "ep": 1}, candidates_considered=n,
                  candidates_rejected=rej, n_chips=nc,
                  projected_hbm_bytes=100, measured_hbm_bytes=m)
             for n, rej, nc, m in ((5, [{"layout": "a", "reason": "SH206"}],
                                    4, 110),
                                   (1, [{"layout": "a", "reason": ""}], 8,
                                    200), (3, [], 4, None))]
    precs = [sink.make_plan_record(**k) for k in plans]
    assert precs == [jsink.make_plan_record(**k) for k in plans]
    for r in recs + precs:
        assert ledger_check.validate_record(r) == \
            jsink.validate_step_record(r)
    assert ledger_check.check_commbench_records(recs, "x") == \
        tc.check_commbench_records(recs, "x")
    # the same findings (the remedy after the dash names the port's
    # measured peak where JAX's names its compile observatory)
    assert [p.split(" — ")[0] for p in
            ledger_check.check_plan_records(precs, "x")] == \
        [p.split(" — ")[0] for p in tc.check_plan_records(precs, "x")]
    bad = ledger_check.check_records(precs)
    assert any("drift 50.0%" in p for p in bad)
    assert any("multiplies to 4 chips" in p for p in bad)
    assert ledger_check.check_records([precs[0]]) == []


def test_commlab_selfcheck_runs(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.commlab",
         "--selfcheck", "--out", str(tmp_path)], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "comm lab selfcheck OK" in out.stdout
