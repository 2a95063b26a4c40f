"""The port's kernel observatory (paddle_tpu_torch.telemetry.kernel_obs)
and the registry's examples and costs, on the CPU.

- With an injected clock a measurement is deterministic; its
  kind=kernelbench record passes the JAX `validate_step_record` and the
  port's `validate_record`, and replays through the health detector's
  `kernel_time_drift` rule as the JAX detector replays it.
- `roofline` matches fractions computed by hand against the H100 SXM
  data-sheet peaks (989 TFLOP/s bf16, 67 TFLOP/s f32, 3.35 TB/s).
- The DB round-trips through its file, keeps the best entry and refuses
  non-finite values.
- Each registry entry's `example` (at its small size) runs the plain
  version with finite output, and `cost` matches counts made by hand
  for K7 (layernorm_fused), K10 (paged_decode) and K12 (moe_gather).
"""
import itertools
import json
import math

import numpy as np
import pytest
import torch

from paddle_tpu.telemetry import kernel_obs as jax_kernel_obs
from paddle_tpu.telemetry.health import AnomalyDetector as JaxDetector
from paddle_tpu.telemetry.sink import validate_step_record

from paddle_tpu_torch.ops.kernel_registry import get_kernel, kernels
from paddle_tpu_torch.telemetry import kernel_obs
from paddle_tpu_torch.telemetry.health import AnomalyDetector
from paddle_tpu_torch.telemetry.ledger_check import validate_record
from paddle_tpu_torch.telemetry.mfu import (device_peak_flops,
                                            device_peak_hbm_bw)

H100 = "NVIDIA H100 80GB HBM3"


def _clock(step_s=0.5):
    c = itertools.count()
    return lambda: next(c) * step_s


def test_injected_clock_makes_a_measurement_deterministic():
    reg = get_kernel("layernorm_fused")
    a = kernel_obs.measure_kernel(reg, device="cpu", clock=_clock(), k=5)
    b = kernel_obs.measure_kernel(reg, device="cpu", clock=_clock(), k=5)
    assert a.to_record() == b.to_record()
    # every timed call reads the clock twice: 500 ms a sample
    assert (a.kernel_ms, a.fallback_ms, a.compile_ms) == (500.0,) * 3
    assert a.sig == "bf16[16,768],bf16[16,768],bf16[768],bf16[768]"
    assert a.dtype == "bf16" and a.backend == "cpu"


def test_kernelbench_records_pass_both_validators():
    for name in ("paged_decode", "moe_combine"):
        res = kernel_obs.measure_kernel(get_kernel(name), device="cpu",
                                        clock=_clock(), k=3)
        rec = json.loads(json.dumps(res.to_record()))
        assert validate_step_record(rec) == []
        assert validate_record(rec) == []
        assert rec["kind"] == "kernelbench" and rec["event"] == "measure"
        assert rec["db_key"] == kernel_obs.db_key(
            name, rec["sig"], rec["dtype"], "cpu")
        # the CPU has no peaks: no roofline, no drift jurisdiction
        assert "predicted_ms" not in rec and "bound" not in rec


def test_signature_format_matches_the_jax_one():
    args = (torch.zeros(4, 128), torch.zeros(40, dtype=torch.int32), 3)
    nargs = (np.zeros((4, 128), np.float32), np.zeros(40, np.int32), 3)
    assert kernel_obs.shape_signature(args) \
        == jax_kernel_obs.shape_signature(nargs) == "f32[4,128],i32[40]"
    assert kernel_obs.dominant_dtype(args) \
        == jax_kernel_obs.dominant_dtype(nargs) == "f32"
    assert kernel_obs.db_key("k", "s", "f32", "cuda") \
        == jax_kernel_obs.db_key("k", "s", "f32", "cuda")


def test_roofline_hand_computed_h100_fractions():
    # 1 GFLOP and 1 GB in 1 ms: 1 TFLOP/s and 1 TB/s achieved
    r = kernel_obs.roofline(1e9, 1e9, 1.0, device_kind=H100)
    assert r["flops_frac"] == pytest.approx(1e12 / 989e12)
    assert r["bw_frac"] == pytest.approx(1e12 / 3.35e12)
    assert r["predicted_ms"] == pytest.approx(1e9 / 3.35e12 * 1e3)
    assert r["bound"] == "memory"
    # 100 GFLOP, 1 MB in 0.5 ms, f32: compute-bound at 67 TFLOP/s
    r = kernel_obs.roofline(100e9, 1e6, 0.5, device_kind=H100,
                            dtype="float32")
    assert r["predicted_ms"] == pytest.approx(100e9 / 67e12 * 1e3)
    assert r["bound"] == "compute"
    assert r["flops_frac"] == 1.0       # clamped: 200 TFLOP/s achieved
    # unknown device: no peaks, no prediction
    r = kernel_obs.roofline(1e9, 1e9, 1.0, device_kind="cpu")
    assert r["predicted_ms"] is None and r["bound"] is None
    assert device_peak_hbm_bw(H100) == 3.35e12
    assert device_peak_hbm_bw("NVIDIA H100 PCIe") == 2.0e12
    assert device_peak_flops(H100, "float32") == 67e12
    assert device_peak_flops("NVIDIA H100 PCIe", "float32") == 51e12


def test_drift_rule_reads_port_records_as_the_jax_detector_does():
    res = kernel_obs.measure_kernel(get_kernel("paged_decode"),
                                    device="cpu", clock=_clock(), k=3)
    recs = []
    for ms, pred in ((1.0, 0.01), (0.02, 0.01), (0.001, 0.01)):
        res.kernel_ms = ms
        res.roof = {"predicted_ms": pred, "bound": "memory"}
        recs.append(json.loads(json.dumps(res.to_record())))
    jd, td = JaxDetector(), AnomalyDetector()
    for rec in recs:
        assert [a.to_dict() for a in td.observe(rec)] \
            == [a.to_dict() for a in jd.observe(rec)]
    assert td.kinds() == ["kernel_time_drift"]
    assert len(td.anomalies) == 2       # too slow, then (re-armed) too fast


def test_db_round_trip_keeps_best_and_refuses_nonfinite(tmp_path):
    path = str(tmp_path / "sub" / "kernel_db.json")
    db = kernel_obs.KernelDB(path)
    res = kernel_obs.measure_kernel(get_kernel("layernorm_fused"),
                                    device="cpu", clock=_clock(0.25), k=3)
    assert res.kernel_ms == 250.0
    updated, refused = db.update([res])
    assert len(updated) == 1 and refused == []
    db.save()
    again = kernel_obs.KernelDB(path)
    key = updated[0]
    assert again.entries == db.entries
    assert again.best_ms("layernorm_fused", res.sig, "bf16", "cpu") == 250.0
    # slower: skipped; faster: replaces; non-finite: refused
    assert again.update([(key, {"best_ms": 300.0})]) == ([], [])
    assert again.update([(key, {"best_ms": 1.5})]) == ([key], [])
    assert again.entries[key]["kernel"] == "layernorm_fused"
    _, refused = again.update([(key, {"best_ms": float("nan")}),
                               (key, {"best_ms": 1.0,
                                      "fallback_ms": math.inf})])
    assert [r[0] for r in refused] == [key, key]
    assert again.entries[key]["best_ms"] == 1.5
    assert again.lookup("layernorm_fused", backend="cpu") \
        == [(key, again.entries[key])]


@pytest.mark.parametrize("name", sorted(k.name for k in kernels()))
def test_each_example_runs_its_plain_version(name):
    reg = get_kernel(name)
    args = reg.example(np.random.default_rng(0), small=True)
    out = reg.plain(*args)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    assert all(bool(torch.isfinite(o.float()).all()) for o in outs)
    flops, nbytes = reg.cost(args)
    assert nbytes > 0 and flops >= 0
    # the same seed gives the same example
    again = reg.example(np.random.default_rng(0), small=True)
    for a, b in zip(args, again):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)


def test_cost_hand_counts_k7_k10_k12():
    # K7: 16 rows of 768, x/r/out in bf16, bf16 w and b
    args = get_kernel("layernorm_fused").example(np.random.default_rng(1))
    assert get_kernel("layernorm_fused").cost(args) == (
        8 * 16 * 768, 16 * 768 * 2 * 3 + 2 * 768 * 2)
    # K10: q and out rows, the ctx+1 K and V rows of each slot, the
    # tables and ctx
    reg = get_kernel("paged_decode")
    q, kp, vp, tables, ctx, n = reg.example(np.random.default_rng(2))
    keys = sum(int(c) + 1 for c in ctx)         # every ctx is < 512
    assert reg.cost((q, kp, vp, tables, ctx, n)) == (
        4 * keys * 768, (2 * keys * 768 + 2 * 16 * 768) * 2
        + (16 * 32 + 16) * 4)
    # K12 over a hand-made map: rows 3, 1, 3 and a sentinel (4) -> two
    # distinct rows read, four written, the map read
    src = torch.zeros(4, 8)
    idx = torch.tensor([3, 1, 3, 4], dtype=torch.int32)
    assert get_kernel("moe_gather").cost((src, idx)) == (
        0, (2 + 4) * 8 * 4 + 4 * 4)
