"""Memory watch CLI: render, gate and replay the memory observatory's
ledger (paddle_tpu_torch/telemetry/mem_obs, kind=memsnap records) — the
port of the JAX package's tools/memwatch.py.

Every record is gated through the port's ledger rules
(telemetry/ledger_check.py: bucket sums, headroom arithmetic, KV census
tiling recomputed from each record's own fields) and replayed through
the in-flight rules of telemetry/health.py (`hbm_pressure`,
`kv_thrash`, `mem_projection_drift`) — what pages in flight is what this
tool reports offline.

    python -m paddle_tpu_torch.tools.memwatch run.jsonl
    python -m paddle_tpu_torch.tools.memwatch run.jsonl --postmortem
    python -m paddle_tpu_torch.tools.memwatch --smoke [--device cpu]
    python -m paddle_tpu_torch.tools.memwatch --selfcheck

Modes:
  (default)     render the ledger timeline of a JSONL file: per-sample
                bucket bytes, headroom, KV occupancy and rates; any
                invalid record OR fired rule is a finding (exit 14)
  --postmortem  render the LAST event=postmortem record in the file —
                what killed the allocation, the top-K tagged suspects,
                the KV pool state; exit 14 when there is none
  --smoke       a real tiny serving engine (tagged weights + paged-KV
                arenas) plus a real Adam step (its state tagged as
                opt_state), sampled for a few steps against a declared
                budget (the card's memory on the card, 256 MiB on the
                CPU): records gated, rules must stay SILENT, and the
                params, opt_state and kv buckets must be non-empty.
                The JAX smoke also reconciles the ledger with a static
                projection from the compile observatory; the port has
                no projection (mem_obs.py), so that step is dropped
  --selfcheck   the checked-in pressure specimen
                (tools/specimens/memsnap_pressure.jsonl, read as data)
                must trip `hbm_pressure` AND `kv_thrash` by name; a
                clean smoke ledger (on the CPU) must validate and stay
                silent; a captured postmortem must round-trip through
                the validator and carry its suspects

Exit codes: 0 clean; 14 findings; 9 selfcheck miss (the watcher itself
is broken).
"""
import argparse
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SPECIMEN = os.path.join(_REPO, "tools", "specimens",
                        "memsnap_pressure.jsonl")

MEM_RULES = ("hbm_pressure", "kv_thrash", "mem_projection_drift")


def _mb(v):
    return "-" if not isinstance(v, (int, float)) else f"{v / 2**20:.2f}"


def _read(path):
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return [r for r in records
            if isinstance(r, dict) and r.get("kind") == "memsnap"]


def _validate_records(records, label):
    """The ledger rules over a batch of records after a JSON round trip
    (what validates in memory but not after one IS a finding)."""
    from ..telemetry.ledger_check import check_records
    recs = [json.loads(json.dumps(r)) for r in records]
    return [f"{label}: {p}" for p in check_records(recs, label)]


def _rule_findings(records, detector=None):
    """Feed ledger records through the in-flight rules."""
    from ..telemetry.health import AnomalyDetector

    det = detector or AnomalyDetector()
    found = []
    for rec in records:
        found.extend(det.observe(rec))
    return [a for a in found if a.kind in MEM_RULES]


def print_timeline(records):
    print(f"{'step':>6s} {'event':10s} {'total MB':>9s} {'params':>8s} "
          f"{'opt':>8s} {'kv':>8s} {'work':>8s} {'other':>8s} "
          f"{'headMB':>8s} {'kvocc':>6s} {'ev/s':>6s}")
    print("-" * 96)
    for r in records:
        occ = r.get("kv_occupancy")
        evr = r.get("kv_eviction_rate")
        occ = "-" if occ is None else f"{occ:.3f}"
        evr = "-" if evr is None else f"{evr:.2f}"
        print(f"{r.get('step', 0):>6d} {r.get('event', '?'):10s} "
              f"{_mb(r.get('total_bytes')):>9s} "
              f"{_mb(r.get('params_bytes')):>8s} "
              f"{_mb(r.get('opt_state_bytes')):>8s} "
              f"{_mb(r.get('kv_bytes')):>8s} "
              f"{_mb(r.get('workspace_bytes')):>8s} "
              f"{_mb(r.get('other_bytes')):>8s} "
              f"{_mb(r.get('headroom_bytes')):>8s} "
              f"{occ:>6s} {evr:>6s}")


def print_postmortem(rec):
    """Render one forensic record: the offline half of the engine's
    capture-on-failure."""
    print(f"POSTMORTEM at step {rec.get('step')} "
          f"(rank {rec.get('rank')}, engine {rec.get('engine')})")
    print(f"  error: {rec.get('error')}")
    total = rec.get("total_bytes")
    budget = rec.get("hbm_budget_bytes")
    print(f"  ledger: total {_mb(total)} MB"
          + (f" of {_mb(budget)} MB budget "
             f"(headroom {_mb(rec.get('headroom_bytes'))} MB)"
             if budget else " (no declared budget)"))
    for k in ("params_bytes", "opt_state_bytes", "kv_bytes",
              "workspace_bytes", "other_bytes"):
        print(f"    {k[:-6]:10s} {_mb(rec.get(k)):>10s} MB")
    nt = rec.get("kv_blocks_total")
    if nt is not None:
        print(f"  kv pool: {rec.get('kv_blocks_held')}/{nt} held, "
              f"{rec.get('kv_blocks_free')} free, "
              f"{rec.get('kv_blocks_cached')} cached; "
              f"evictions {rec.get('kv_evictions')}, "
              f"admissions {rec.get('kv_admissions')}")
    top = rec.get("top_arrays") or []
    print(f"  top {len(top)} live suspects by bytes:")
    for t in top:
        print(f"    {_mb(t.get('bytes')):>10s} MB  "
              f"{t.get('bucket', '?'):10s} "
              f"{t.get('dtype', '?'):10s} {t.get('shape', '')}")
    for seg in rec.get("top_segments") or []:
        print(f"    segment {seg}")


# ---------------------------------------------------------------------------
# smoke: a real tagged process sampled against a declared budget
# ---------------------------------------------------------------------------

def run_smoke(telemetry=None, steps=6, device=None):
    """Every tagging hook exercised (engine weights, KV arenas, an Adam
    step's state), sampled against a declared budget (the card's memory
    on the card, 256 MiB on the CPU). Returns (records, problems)."""
    import torch

    from .. import nn
    from ..device import resolve_device
    from ..models.gpt import GPTConfig, GPTForPretraining
    from ..optimizer import Adam
    from ..serving import SamplingParams, ServingEngine
    from ..telemetry.mem_obs import (MemoryObservatory, register_provider,
                                     unregister_provider)
    from ..telemetry.sink import JsonlSink

    dev = resolve_device(device)
    budget_mb = (torch.cuda.get_device_properties(dev).total_memory
                 // 2 ** 20 if dev.type == "cuda" else 256)
    # heads of 64: the width the card's paged kernels take
    cfg = GPTConfig(vocab_size=256, hidden_size=128, num_layers=2,
                    num_heads=2, max_seq_len=64, dropout=0.0,
                    use_flash_attention=False)
    model = GPTForPretraining(cfg, device=dev, seed=0)
    eng = ServingEngine(model, max_slots=2, block_size=8, prefill_chunk=8,
                        max_model_len=64, dtype=None, device=dev,
                        hbm_budget_mb=budget_mb)

    # a real Adam step, its state tagged as opt_state (states appear at
    # the first update)
    lin = nn.Linear(16, 16, device=dev)
    opt = Adam(learning_rate=1e-3, parameters=lin.parameters())
    x = torch.ones((4, 16), device=dev)
    (lin(x) ** 2).sum().backward()
    opt.step()
    key = register_provider(
        "memwatch.adam", "opt_state", opt,
        lambda o: [v for st in o._states.values() for v in st.values()
                   if isinstance(v, torch.Tensor)])
    sink = JsonlSink(telemetry) if telemetry else None
    obs = MemoryObservatory(
        sink=sink, hbm_budget_bytes=int(budget_mb) * 2 ** 20,
        kv_source=eng._kv_accounting, engine=eng.engine_id, device=dev)
    try:
        h = eng.submit([1, 2, 3], SamplingParams(max_new_tokens=4))
        records = []
        for i in range(1, steps + 1):
            eng.step()
            records.append(obs.snapshot(i))
        list(h.tokens())
    finally:
        unregister_provider(key)
        if sink is not None:
            sink.close()

    problems = _validate_records(records, "smoke")
    fired = _rule_findings(records)
    problems += [f"smoke: {a.message}" for a in fired]
    last = records[-1]
    for bucket in ("params_bytes", "opt_state_bytes", "kv_bytes"):
        if not last.get(bucket):
            problems.append(
                f"smoke: {bucket} is empty — the tagging hook for "
                "that bucket never fired")
    print_timeline(records)
    print(f"smoke on {dev}: ledger {last['total_bytes']} bytes against a "
          f"{budget_mb} MiB budget")
    return records, problems


# ---------------------------------------------------------------------------
# selfcheck
# ---------------------------------------------------------------------------

def run_selfcheck():
    """Specimen pages BY NAME, a clean CPU ledger stays silent, a
    postmortem round-trips. Returns (ok, report)."""
    from ..telemetry.ledger_check import validate_record
    from ..telemetry.mem_obs import MemoryObservatory

    ok = True
    report = {}
    with open(SPECIMEN) as f:
        specimen = [json.loads(line) for line in f if line.strip()]
    spec_problems = _validate_records(specimen, "specimen")
    if spec_problems:
        print("SELFCHECK FAILED: the pressure specimen must be "
              "schema-valid (pressure is a semantics finding, not a "
              "malformed record):", file=sys.stderr)
        for p in spec_problems:
            print(f"  {p}", file=sys.stderr)
        ok = False
    fired = _rule_findings(specimen)
    kinds = {a.kind for a in fired}
    report["specimen"] = {"n_records": len(specimen),
                          "anomalies": [a.to_dict() for a in fired],
                          "kinds": sorted(kinds)}
    for want in ("hbm_pressure", "kv_thrash"):
        if want not in kinds:
            print(f"SELFCHECK FAILED: tools/specimens/"
                  f"memsnap_pressure.jsonl did not trip {want}",
                  file=sys.stderr)
            ok = False

    records, clean_problems = run_smoke(steps=4, device="cpu")
    report["clean"] = {"n_records": len(records),
                       "problems": clean_problems}
    if clean_problems:
        print("SELFCHECK FAILED: the clean smoke ledger did not come "
              "back clean:", file=sys.stderr)
        for p in clean_problems:
            print(f"  {p}", file=sys.stderr)
        ok = False

    obs = MemoryObservatory(hbm_budget_bytes=256 * 2 ** 20, device="cpu")
    pm = json.loads(json.dumps(obs.capture_postmortem(
        "CUDA out of memory. Tried to allocate 2.50 GiB", step=4)))
    pm_problems = validate_record(pm)
    report["postmortem"] = {"problems": pm_problems,
                            "n_suspects": len(pm.get("top_arrays") or [])}
    if pm_problems or not pm.get("error") or not pm.get("top_arrays"):
        print(f"SELFCHECK FAILED: a captured postmortem did not "
              f"round-trip with its cause and suspects: {pm_problems}",
              file=sys.stderr)
        ok = False
    print_postmortem(pm)
    return ok, report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", nargs="?", default=None,
                    help="memsnap JSONL to render/replay")
    ap.add_argument("--postmortem", action="store_true",
                    help="render the last OOM postmortem in the file "
                         "(exit 14 when there is none)")
    ap.add_argument("--smoke", action="store_true",
                    help="tagged engine + optimizer sampled against a "
                         "budget; exit 14 on any finding")
    ap.add_argument("--selfcheck", action="store_true",
                    help="specimen trips hbm_pressure + kv_thrash by "
                         "name, clean ledger silent, postmortem "
                         "round-trips")
    ap.add_argument("--device", default=None,
                    help="--smoke's device (default: the CUDA card)")
    ap.add_argument("--telemetry", default=None,
                    help="in --smoke, append the sampled memsnap "
                         "records to this JSONL")
    ap.add_argument("--report", default=None,
                    help="write the JSON report here")
    args = ap.parse_args(argv)

    if args.selfcheck:
        ok, report = run_selfcheck()
        report["tool"] = "memwatch"
        if args.report:
            with open(args.report, "w") as f:
                json.dump(report, f, indent=2, sort_keys=True)
        if ok:
            print("memwatch selfcheck OK: pressure specimen caught "
                  "hbm_pressure + kv_thrash by name, clean ledger "
                  "silent, postmortem round-trips")
        return 0 if ok else 9

    if args.smoke:
        records, problems = run_smoke(telemetry=args.telemetry,
                                      device=args.device)
        if problems:
            print(f"memwatch: {len(problems)} finding(s)")
            for p in problems:
                print(f"  {p}", file=sys.stderr)
            return 14
        print(f"memwatch: {len(records)} ledger sample(s) clean")
        return 0

    if not args.path:
        ap.print_help()
        return 1

    records = _read(args.path)
    if args.postmortem:
        pms = [r for r in records if r.get("event") == "postmortem"]
        if not pms:
            print(f"memwatch: no postmortem record in {args.path} — "
                  "nothing to diagnose", file=sys.stderr)
            return 14
        print_postmortem(pms[-1])
        return 0

    problems = _validate_records(records, args.path) \
        if records else [f"{args.path}: no memsnap records"]
    fired = _rule_findings(records)
    print_timeline(records)
    for a in fired:
        print(f"ANOMALY {a.kind}: {a.message}")
    problems += [f"{args.path}: {a.kind} fired" for a in fired]
    if problems:
        print(f"memwatch: {len(problems)} finding(s)")
        for p in problems:
            print(f"  {p}", file=sys.stderr)
        return 14
    print(f"memwatch: {len(records)} record(s) clean in {args.path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
