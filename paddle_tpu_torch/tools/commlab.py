"""Comm Lab: measured collective latencies and the persistent comm DB
over ranks of the port's process group (telemetry/comm_obs) — the
port's counterpart of the repo's tools/commlab.py.

    python -m paddle_tpu_torch.tools.commlab --device cpu --smoke
    python -m paddle_tpu_torch.tools.commlab --selfcheck
    python -m paddle_tpu_torch.tools.commlab --ranks 4 --mesh dp=4 \\
        --payloads 262144,16777216 [--update-db] [--telemetry run.jsonl]

The lab launches `--ranks` rank processes (`distributed.launch`, a file
store under `--out`): gloo on the CPU (`--device cpu`), gloo ranks
sharing card 0 (`--device cuda`, the default), or NCCL at one rank a
card (`--backend nccl`). Each rank builds the mesh `--mesh`, sweeps
every op of comm_obs.SWEEP_OPS over every axis above one (or `--axes`;
an axis of one skips ppermute) at every payload rung — first call timed
apart, warm-up, median of k — and writes its kind=commbench records;
the parent reads them, checks them with telemetry/ledger_check.py and
feeds them to the health rules' AnomalyDetector (`comm_bw_degraded`),
and prints rank 0's table. gloo ranks move through the host: their
records carry no bw_frac or predicted_ms.

Modes:
  (default)    the sweep (the payload ladder 256 KiB .. 256 MiB unless
               --payloads), records checked, exit 13 on a finding
  --smoke      every (op, axis) at the two small rungs (SMOKE_PAYLOADS)
               on 4 gloo ranks, dp 2 x mp 2; with --telemetry also
               kind=bench `comm.<op>.smoke_ms` rows
  --selfcheck  the lab's proof: its degraded specimen must trip
               `comm_bw_degraded` BY NAME through the real
               AnomalyDetector while the in-band and reference-free rows
               stay silent; a clean 2-rank CPU sweep must validate and
               stay quiet; the DB must refuse non-finite rows and
               round-trip

`--update-db` rolls rank 0's rows into the DB
(paddle_tpu_torch/tools/comm_db.json; keep-best, non-finite refused)
and echoes each rolled row as an event=db_update record. Reading the DB
back into measurements is opt-in via PADDLE_TPU_TORCH_COMM_DB.

Exit codes: 0 clean; 13 findings (invalid records, degraded
collectives); 9 selfcheck miss (the lab itself is broken).
"""
import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the --smoke rungs: CPU ranks measure scheduling overhead, not
# bandwidth, so MiB-scale rungs buy nothing there
SMOKE_PAYLOADS = (16 * 1024, 64 * 1024)
RANK_DEADLINE_S = 120.0

# the selfcheck's degraded specimen: schema-valid measurements with a DB
# reference — one 3x slower than its db_ms (must page comm_bw_degraded),
# one in band, one with no reference (no jurisdiction)
SPECIMEN = (
    {"schema": 1, "kind": "commbench", "rank": 0, "op": "psum",
     "axis": "dp", "axis_size": 4, "payload_bytes": 262144,
     "backend": "nccl", "time_ms": 0.3, "db_ms": 0.1,
     "db_key": "psum|ax4|262144|nccl", "event": "measure"},
    {"schema": 1, "kind": "commbench", "rank": 0, "op": "all_gather",
     "axis": "dp", "axis_size": 4, "payload_bytes": 262144,
     "backend": "nccl", "time_ms": 0.105, "db_ms": 0.1,
     "db_key": "all_gather|ax4|262144|nccl", "event": "measure"},
    {"schema": 1, "kind": "commbench", "rank": 0, "op": "ppermute",
     "axis": "dp", "axis_size": 4, "payload_bytes": 262144,
     "backend": "nccl", "time_ms": 5.0,
     "db_key": "ppermute|ax4|262144|nccl", "event": "measure"},
)


def parse_mesh(spec):
    """'dp=2,mp=2' -> {'dp': 2, 'mp': 2}."""
    out = {}
    for part in (spec or "").split(","):
        if part.strip():
            k, _, v = part.partition("=")
            out[k.strip()] = int(v)
    return out


# ---------------------------------------------------------------------------
# the rank side
# ---------------------------------------------------------------------------

def worker(args):
    """One rank: init, mesh, sweep, write `<out>/rank<r>.jsonl`."""
    import torch
    from ..distributed import collective, env
    from ..telemetry import comm_obs
    if args.device == "cpu":
        torch.set_num_threads(1)
    env.init_distributed(
        args.backend, device="cpu" if args.device == "cpu" else None,
        timeout_s=RANK_DEADLINE_S)
    collective.set_collective_deadline(RANK_DEADLINE_S)
    mesh = env.build_mesh(**parse_mesh(args.mesh))
    payloads = [int(p) for p in args.payloads.split(",")]
    axes = args.axes.split(",") if args.axes else None
    res = comm_obs.sweep_mesh(mesh=mesh, payloads=payloads,
                              warmup=args.warmup, k=args.k, axes=axes)
    rank = env.get_rank()
    with open(os.path.join(args.out, f"rank{rank}.jsonl"), "w") as f:
        for r in res:
            f.write(json.dumps(r.to_record(rank=rank)) + "\n")
    sys.stdout.flush()
    # a timed-out collective cannot be cancelled: leave without joining
    os._exit(0)


# ---------------------------------------------------------------------------
# the parent side
# ---------------------------------------------------------------------------

def run_sweep(out, ranks=4, backend="gloo", device="cuda", mesh="dp=4",
              payloads=SMOKE_PAYLOADS, warmup=2, k=5, axes=None,
              timeout=600.0, no_db=False):
    """Launch `ranks` rank processes that sweep `mesh`'s axes (see the
    module docstring); -> (every rank's records, rank 0's first; the
    seconds the job took). Raises with the ranks' log tails when a rank
    fails."""
    from ..distributed.launch import (start_local_trainers,
                                      watch_local_trainers)
    os.makedirs(out, exist_ok=True)
    store = tempfile.mkdtemp(prefix="store_", dir=out)
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    if no_db:
        # the same answer on every host, whatever DB the flag names
        env.pop("PADDLE_TPU_TORCH_COMM_DB", None)
    argv = ["--worker", "--out", out, "--backend", backend, "--device",
            device, "--mesh", mesh, "--payloads",
            ",".join(str(int(p)) for p in payloads), "--warmup",
            str(warmup), "--k", str(k)]
    if axes:
        argv += ["--axes", ",".join(axes)]
    t0 = time.perf_counter()
    procs = start_local_trainers(
        ranks, "paddle_tpu_torch.tools.commlab", argv, base_env=env,
        ranks_per_device=ranks if backend == "gloo" else 1, module=True,
        store_dir=store, log_dir=out)
    try:
        rc = watch_local_trainers(procs, timeout=timeout)
    finally:
        shutil.rmtree(store, ignore_errors=True)
    seconds = time.perf_counter() - t0
    if rc != 0:
        tails = []
        for r in range(ranks):
            p = os.path.join(out, f"workerlog.{r}")
            if os.path.exists(p):
                with open(p, errors="replace") as f:
                    tails.append(f"--- rank {r} ---\n" + f.read()[-3000:])
        raise RuntimeError(f"commlab: the sweep's ranks exited {rc} after "
                           f"{seconds:.1f} s\n" + "\n".join(tails))
    records = []
    for r in range(ranks):
        with open(os.path.join(out, f"rank{r}.jsonl")) as f:
            records += [json.loads(line) for line in f if line.strip()]
    return records, seconds


def print_table(records):
    print(f"{'op':16s} {'axis':5s} {'n':>3s} {'backend':7s} "
          f"{'payload':>10s} {'ms':>9s} {'first':>8s} {'GB/s':>7s} "
          f"{'BW%':>6s}")
    for r in records:
        if r.get("rank", 0) != 0 or r.get("event") == "db_update":
            continue
        bw = r.get("achieved_bw")
        bf = r.get("bw_frac")
        print(f"{r['op']:16s} {r['axis']:5s} {r['axis_size']:3d} "
              f"{r['backend']:7s} {r['payload_bytes']:10d} "
              f"{r['time_ms']:9.3f} {r.get('compile_ms', 0.0):8.2f} "
              f"{(bw or 0) / 1e9:7.3f} "
              f"{'-' if bf is None else f'{bf * 100:.1f}':>6s}")


def check(records):
    """ledger_check's problems with the records, and the anomalies the
    AnomalyDetector's comm rules raise on them."""
    from ..telemetry.health import AnomalyDetector
    from ..telemetry.ledger_check import check_records
    problems = check_records(list(records), "commlab")
    det = AnomalyDetector()
    found = []
    for rec in records:
        found.extend(det.observe(rec))
    drifts = [a for a in found
              if a.kind in ("comm_bw_degraded", "straggler")]
    return problems, drifts


def bench_rows(records):
    """kind=bench `comm.<op>.smoke_ms` rows: each op's median over its
    sweep points on rank 0."""
    from ..telemetry import sink
    by_op = {}
    for r in records:
        if r.get("rank", 0) == 0:
            by_op.setdefault(r["op"], []).append(r["time_ms"])
    dev = records[0]["backend"] if records else "cpu"
    return [sink.make_bench_record(metric=f"comm.{op}.smoke_ms",
                                   value=statistics.median(ms), unit="ms",
                                   device=dev)
            for op, ms in sorted(by_op.items())]


def update_db(records, db_path):
    """Roll rank 0's measured rows into the DB; -> (the db_update echo
    records, refused [(key, why)])."""
    from ..telemetry import comm_obs
    db = comm_obs.CommDB(db_path)
    rows = [(r["db_key"], {"best_ms": r["time_ms"],
                           "wire_bytes": r.get("wire_bytes"),
                           "predicted_ms": r.get("predicted_ms")})
            for r in records if r.get("rank", 0) == 0 and r.get("db_key")]
    updated, refused = db.update(rows)
    echo = []
    if updated:
        db.save()
        by_key = {r["db_key"]: r for r in records if r.get("rank", 0) == 0}
        echo = [dict(by_key[k], event="db_update") for k in updated]
    return echo, refused


def run_selfcheck(out):
    """The lab's proof (see the module docstring); -> (ok, report)."""
    from ..telemetry import comm_obs
    ok, report = True, {}
    problems, drifts = check(list(SPECIMEN))
    report["specimen"] = {"problems": problems,
                          "anomalies": [a.kind for a in drifts]}
    if problems:
        print(f"SELFCHECK FAILED: the degraded specimen must be schema-"
              f"valid: {problems}", file=sys.stderr)
        ok = False
    if [a.kind for a in drifts] != ["comm_bw_degraded"]:
        print(f"SELFCHECK FAILED: the specimen raised "
              f"{[a.kind for a in drifts]}, not one comm_bw_degraded (the "
              "in-band and reference-free rows must stay silent)",
              file=sys.stderr)
        ok = False
    records, _ = run_sweep(os.path.join(out, "clean"), ranks=2,
                           device="cpu", mesh="dp=2",
                           payloads=SMOKE_PAYLOADS[:1], warmup=1, k=2,
                           timeout=120.0, no_db=True)
    problems, drifts = check(records)
    n_want = 2 * len(comm_obs.SWEEP_OPS)
    report["clean"] = {"n_records": len(records), "problems": problems,
                       "anomalies": [a.kind for a in drifts]}
    if problems or drifts or len(records) != n_want:
        print(f"SELFCHECK FAILED: the clean sweep gave {len(records)} "
              f"records (want {n_want}), problems {problems}, anomalies "
              f"{[a.kind for a in drifts]}", file=sys.stderr)
        ok = False
    if any(r.get("bw_frac") is not None or r.get("predicted_ms")
           is not None for r in records):
        print("SELFCHECK FAILED: gloo records carry a roofline",
              file=sys.stderr)
        ok = False
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "db.json")
        db = comm_obs.CommDB(path)
        updated, _ = db.update([(r["db_key"], {"best_ms": r["time_ms"]})
                                for r in records if r["rank"] == 0])
        _, bad = db.update([("psum|ax2|16384|gloo",
                             {"best_ms": float("nan")})])
        db.save()
        report["db"] = {"updated": len(updated), "refused": len(bad)}
        if not updated or not bad or \
                comm_obs.CommDB(path).entries != db.entries:
            print(f"SELFCHECK FAILED: DB contract {report['db']} (rows must "
                  "land, a NaN must be refused, save/load must round-trip)",
                  file=sys.stderr)
            ok = False
    return ok, report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--mesh", default="dp=4",
                    help="the mesh every rank builds, e.g. dp=2,mp=2")
    ap.add_argument("--axes", default=None,
                    help="axes to sweep (default: every axis above one)")
    ap.add_argument("--payloads", default=None,
                    help="comma-separated payload bytes (default: "
                         "256 KiB .. 256 MiB)")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--out", default=None)
    ap.add_argument("--db", default=None,
                    help="comm DB path (default the port's "
                         "paddle_tpu_torch/tools/comm_db.json)")
    ap.add_argument("--update-db", action="store_true")
    ap.add_argument("--telemetry", default=None,
                    help="append the records (and --smoke's bench rows) "
                         "to this JSONL")
    ap.add_argument("--report", default=None)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--selfcheck", action="store_true")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args)
        return 0
    out = args.out or tempfile.mkdtemp(prefix="commlab_")
    if args.selfcheck:
        ok, report = run_selfcheck(out)
        if args.report:
            with open(args.report, "w") as f:
                json.dump(report, f, indent=2, sort_keys=True)
        if ok:
            print("comm lab selfcheck OK: degraded specimen caught by name "
                  "(in-band and reference-free rows silent), "
                  f"{report['clean']['n_records']} collectives measured "
                  "clean on 2 gloo CPU ranks, DB refuses non-finite rows "
                  "and round-trips")
        return 0 if ok else 9
    if args.smoke:
        args.ranks, args.mesh = 4, "dp=2,mp=2"
        args.warmup, args.k = 1, 2
        payloads = list(SMOKE_PAYLOADS)
    elif args.payloads:
        payloads = [int(p) for p in args.payloads.split(",")]
    else:
        from ..telemetry.comm_obs import payload_sweep
        payloads = payload_sweep()
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("commlab runs its ranks on the CUDA card by "
                               "default and none is available; pass "
                               "--device cpu")
    records, seconds = run_sweep(
        out, args.ranks, args.backend, args.device, args.mesh, payloads,
        args.warmup, args.k, args.axes.split(",") if args.axes else None)
    print_table(records)
    problems, drifts = check(records)
    problems += [a.message for a in drifts]
    if args.update_db and not problems:
        from ..telemetry import comm_obs
        echo, refused = update_db(records, args.db or comm_obs.DEFAULT_DB_PATH)
        problems += [f"--update-db {k}: {why}" for k, why in refused]
        records += echo
        print(f"comm db: {len(echo)} row(s) rolled forward")
    if args.telemetry:
        from ..telemetry.sink import JsonlSink
        sink = JsonlSink(args.telemetry)
        for rec in records + (bench_rows(records) if args.smoke else []):
            sink.write(rec)
        sink.close()
    if args.report:
        with open(args.report, "w") as f:
            json.dump({"problems": problems, "seconds": seconds,
                       "records": records}, f, indent=2, sort_keys=True)
    if problems:
        print(f"comm lab: {len(problems)} finding(s)")
        for p in problems:
            print(f"  {p}", file=sys.stderr)
        return 13
    print(f"comm lab: {len(records)} record(s) clean in {seconds:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
