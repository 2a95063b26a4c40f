"""Offline training-health analyzer: replay a metrics JSONL through the
SAME anomaly rules the in-flight monitor runs
(paddle_tpu_torch.telemetry.health.AnomalyDetector) and exit nonzero on
findings — the port of the JAX package's tools/healthwatch.py.

    # gate mode (default): a clean run must stay clean
    python -m paddle_tpu_torch.tools.healthwatch run.jsonl

    # expect mode: a broken specimen must trip EVERY listed family
    python -m paddle_tpu_torch.tools.healthwatch \
        tools/specimens/health_anomalous.jsonl \
        --expect nan,loss_spike,grad_explosion,step_time_regression

    # selfcheck: every checked-in specimen (tools/specimens/*.jsonl,
    # read as data) fires exactly the families the JAX analyzer fires
    # on it (SPECIMEN_KINDS); the others fire nothing
    python -m paddle_tpu_torch.tools.healthwatch --selfcheck

Step records (kind=step) run the rolling-window rules (NaN/Inf, loss
spike, grad explosion, step-time regression — compile steps exempt)
plus the per-rank straggler rule; phase records are checked for
recorded errors and non-finite metrics; checkpoint records run
checkpoint_failed / checkpoint_stall; commbench records comm_bw_degraded;
request traces tail_latency; memory-ledger records hbm_pressure /
kv_thrash / mem_projection_drift. Records of other kinds are not judged
here, as in the JAX analyzer. Detector knobs mirror HealthConfig;
`--rules fam1,fam2` keeps only those anomaly families in the verdict.

Exit codes: 0 clean / all expected families fired; 5 findings in gate
mode; 9 an expected family did NOT fire (the watcher itself is broken).
"""
import argparse
import glob
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SPECIMEN_DIR = os.path.join(_REPO, "tools", "specimens")

# the record kinds the analyzer judges
JUDGED_KINDS = ("step", "phase", "ckpt", "commbench", "reqtrace",
                "memsnap")

# what the JAX analyzer fires on each checked-in specimen (the files
# not listed fire nothing: they are other tools' specimens)
SPECIMEN_KINDS = {
    "health_anomalous.jsonl": ("grad_explosion", "loss_spike", "nan",
                               "step_time_regression"),
    "memsnap_pressure.jsonl": ("hbm_pressure", "kv_thrash"),
    "commbench_degraded.jsonl": ("comm_bw_degraded",),
    "reqtrace_tail.jsonl": ("tail_latency",),
}


def analyze_file(path, config):
    """Replay one JSONL through a fresh detector. Returns (anomalies,
    n_step, n_phase, problems)."""
    from ..telemetry.health import AnomalyDetector
    from ..telemetry.sink import read_jsonl

    try:
        records = read_jsonl(path)
    except (OSError, json.JSONDecodeError) as e:
        return [], 0, 0, [f"{path}: unreadable: {e}"]
    if not records:
        # a file nothing ever wrote must not green-light the run it
        # claims to describe
        return [], 0, 0, [f"{path}: no records — telemetry never wrote"]
    det = AnomalyDetector(config)
    n_step = n_phase = 0
    for rec in records:
        kind = rec.get("kind") if isinstance(rec, dict) else None
        if kind not in JUDGED_KINDS:
            continue
        n_phase += kind == "phase"
        n_step += kind == "step"
        det.observe(rec)
    return det.anomalies, n_step, n_phase, []


def selfcheck(config):
    """Every specimen fires exactly its SPECIMEN_KINDS (none when not
    listed). Returns the list of failures ([] == ok)."""
    failures = []
    paths = sorted(glob.glob(os.path.join(SPECIMEN_DIR, "*.jsonl")))
    if not paths:
        return [f"no specimens under {SPECIMEN_DIR}"]
    for path in paths:
        anoms, _, _, problems = analyze_file(path, config)
        want = set(SPECIMEN_KINDS.get(os.path.basename(path), ()))
        got = {a.kind for a in anoms}
        failures += problems
        if got != want:
            failures.append(f"{os.path.basename(path)}: fired "
                            f"{sorted(got)}, expected {sorted(want)}")
        print(f"healthwatch selfcheck: {os.path.basename(path)}: "
              f"{sorted(got) or 'silent'}")
    missing = set(SPECIMEN_KINDS) - {os.path.basename(p) for p in paths}
    failures += [f"specimen {m} not found" for m in sorted(missing)]
    return failures


def main(argv=None):
    from ..telemetry.health import HealthConfig

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*", help="metrics JSONL file(s)")
    ap.add_argument("--expect", default=None,
                    help="comma-separated anomaly kinds that MUST fire")
    ap.add_argument("--selfcheck", action="store_true",
                    help="replay every tools/specimens/*.jsonl and hold "
                         "the families each fires")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="write the findings report here")
    ap.add_argument("--window", type=int, default=64)
    ap.add_argument("--min-points", type=int, default=8)
    ap.add_argument("--z-loss", type=float, default=8.0)
    ap.add_argument("--z-grad", type=float, default=8.0)
    ap.add_argument("--z-step-time", type=float, default=8.0)
    ap.add_argument("--ckpt-stall-s", type=float, default=300.0)
    ap.add_argument("--tail-frac", type=float, default=0.6)
    ap.add_argument("--tail-count", type=int, default=4)
    ap.add_argument("--rules", default=None,
                    help="comma-separated anomaly families to keep")
    args = ap.parse_args(argv)

    config = HealthConfig(
        action="record", window=args.window, min_points=args.min_points,
        z_loss=args.z_loss, z_grad=args.z_grad,
        z_step_time=args.z_step_time, ckpt_stall_s=args.ckpt_stall_s,
        tail_cause_frac=args.tail_frac, tail_cause_count=args.tail_count)

    if args.selfcheck:
        failures = selfcheck(config)
        for f in failures:
            print(f"SELFCHECK FAILED: {f}", file=sys.stderr)
        if failures:
            return 9
        print("selfcheck OK: every specimen fired its families")
        return 0
    if not args.paths:
        ap.error("give JSONL paths or --selfcheck")

    keep = None
    if args.rules is not None:
        keep = {k.strip() for k in args.rules.split(",") if k.strip()}
        if not keep:
            print("--rules given but no family named", file=sys.stderr)
            return 2

    all_anoms, all_problems = [], []
    per_file = {}
    for path in args.paths:
        anoms, n_step, n_phase, problems = analyze_file(path, config)
        if keep is not None:
            anoms = [a for a in anoms if a.kind in keep]
        all_anoms += anoms
        all_problems += problems
        per_file[path] = {
            "n_step_records": n_step, "n_phase_records": n_phase,
            "anomalies": [a.to_dict() for a in anoms],
            "problems": problems,
        }
        tag = f"{len(anoms)} finding(s)" if anoms else "clean"
        print(f"healthwatch: {path}: {n_step} step + {n_phase} phase "
              f"record(s), {tag}")
        for a in anoms:
            print(f"  [{a.kind}] {a.message}")
        for p in problems:
            print(f"  [invalid] {p}")

    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"tool": "healthwatch", "files": per_file},
                      f, indent=2, sort_keys=True)
        print(f"report: {args.json_out}")

    if args.expect is not None:
        expected = {k.strip() for k in args.expect.split(",") if k.strip()}
        fired = {a.kind for a in all_anoms}
        missing = sorted(expected - fired)
        if missing:
            print(f"SELFCHECK FAILED: expected anomaly families "
                  f"{missing} did not fire", file=sys.stderr)
            return 9
        print(f"selfcheck OK: all {len(expected)} expected families "
              f"fired ({sorted(expected)})")
        return 0

    if all_problems:
        return 5
    if all_anoms:
        kinds = sorted({a.kind for a in all_anoms})
        print(f"healthwatch: {len(all_anoms)} anomaly(ies) across "
              f"{len(args.paths)} file(s): {kinds}", file=sys.stderr)
        return 5
    return 0


if __name__ == "__main__":
    sys.exit(main())
