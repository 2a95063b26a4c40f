"""Auto-sharding planner CLI: search, verify and explain a parallelism
plan without building or running the model — the port's counterpart of
the repo's tools/autoshard.py.

Runs `paddle_tpu_torch.planner.plan` over a GPT preset, prints the
candidate table with each rejection's reason, and writes a JSON report
and a kind=plan record. Every plan it prints has passed the lint
battery: sharding_lint SH201-SH208 with the per-device memory
projection, the program lint over one recorded proxy step, and the
collective-order capture, with zero error findings.

    python -m paddle_tpu_torch.tools.autoshard --model 1.3b --chips 4 \\
        --report /tmp/plan.json
    python -m paddle_tpu_torch.tools.autoshard --model 13b --mesh dp=2,mp=8

`--selfcheck` proves the planner still sees what it gates on:
  a) an infeasible specimen (GPT-3 1.3B at seq 2048 on 4 H100s under a
     1 GiB budget) must be REJECTED with the binding constraint named;
  b) a feasible GPT-3 125M plan on 8 H100s must verify clean — its tags
     re-linted on a live (meta-device) model — and its kind=plan record
     must pass telemetry/ledger_check.py, with the >15 % projection-drift
     rule firing on a doctored copy.

Exit codes: 0 plan found; 8 no feasible plan (the rejection ledger is
printed); 9 a selfcheck leg failed to fire.
"""
import argparse
import json
import sys

_PRESETS = {"tiny": None, "125m": "gpt3_125m", "350m": "gpt3_350m",
            "1.3b": "gpt3_1_3b", "13b": "gpt3_13b"}

# leg a's specimen: no dp x mp x pp factorization of 4 cards holds 1.3B
# of f32 params + grads + AdamW moments + remat activations under 1 GiB
INFEASIBLE = {"model": "1.3b", "max_seq_len": 2048, "chips": 4,
              "chip": "h100", "hbm_budget_gib": 1.0,
              "message_contains": ("SH206", "binding constraint", "budget")}


def build_config(name, max_seq_len=None):
    from ..models.gpt import GPTConfig
    if name not in _PRESETS:
        raise SystemExit(f"unknown model {name!r} "
                         f"(presets: {sorted(_PRESETS)})")
    if name == "tiny":
        return GPTConfig(vocab_size=256, hidden_size=64, num_layers=2,
                         num_heads=4, max_seq_len=max_seq_len or 64)
    kw = {"max_seq_len": max_seq_len} if max_seq_len else {}
    return getattr(GPTConfig, _PRESETS[name])(**kw)


def parse_mesh(spec):
    """'dp=2,mp=8' -> {'dp': 2, 'mp': 8}."""
    out = {}
    for part in spec.split(","):
        axis, _, size = part.partition("=")
        out[axis.strip()] = int(size)
    return out


def run_plan(args):
    from .. import planner
    cfg = build_config(args.model, args.max_seq_len)
    mesh_shape = parse_mesh(args.mesh) if args.mesh else args.chips
    budget = int(args.budget_gib * 2 ** 30) if args.budget_gib else None
    kwargs = dict(
        hbm_budget=budget, chip=args.chip, verify=args.verify,
        zero_stages=tuple(int(z) for z in args.zero_stages.split(",")),
        micro_batches=tuple(int(m) for m in args.micro_batches.split(",")),
        dp_over_dcn=args.dp_over_dcn, model_name=args.model)
    if args.global_batch:
        kwargs["global_batch"] = args.global_batch
    return planner.plan(cfg, mesh_shape, **kwargs)


def emit(plan, args, rank=0):
    print(f"autoshard: {plan.model} on {plan.n_chips} x {plan.chip} "
          f"(budget {plan.hbm_budget / 2**30:.1f} GiB, "
          f"calibration x{plan.calibration:.2f})")
    print(plan.summary_table())
    c = plan.chosen
    print(f"chosen: {plan.layout.describe()} — projected "
          f"{plan.projected_hbm_bytes / 2**30:.2f} GiB/device, "
          f"est {c.step_time_s * 1e3:.2f} ms/step "
          f"({c.cost.get('comm_frac', 0) * 100:.1f}% comm), "
          f"verified: {'+'.join(plan.verify.get('families_checked', []))} "
          f"with {plan.verify.get('findings_on_chosen', {}).get('n', 0)} "
          "finding(s)")
    if args.report:
        with open(args.report, "w") as f:
            json.dump(plan.to_dict(), f, indent=2, sort_keys=True)
        print(f"report: {args.report}")
    if args.telemetry:
        from ..telemetry.sink import JsonlSink
        sink = JsonlSink(args.telemetry)
        sink.write(plan.to_record(rank=rank))
        sink.close()
        print(f"telemetry: kind=plan record -> {args.telemetry}")


def run_selfcheck():
    """The two-sided gate; -> 0 or 9."""
    from .. import planner
    from ..telemetry.ledger_check import check_records, validate_record

    spec = INFEASIBLE
    cfg = build_config(spec["model"], spec["max_seq_len"])
    try:
        planner.plan(cfg, spec["chips"], chip=spec["chip"],
                     hbm_budget=int(spec["hbm_budget_gib"] * 2 ** 30),
                     verify="sharding")
    except planner.InfeasiblePlanError as e:
        missing = [w for w in spec["message_contains"] if w not in str(e)]
        if missing or not e.candidates:
            print(f"SELFCHECK FAILED: the infeasible specimen was rejected "
                  f"without naming its binding constraint (missing "
                  f"{missing}) or without a candidate ledger: {e}",
                  file=sys.stderr)
            return 9
        print(f"selfcheck a OK: specimen rejected ({len(e.candidates)} "
              "candidates, binding constraint named)")
    else:
        print("SELFCHECK FAILED: the infeasible specimen produced a plan",
              file=sys.stderr)
        return 9

    from ..analysis import sharding_lint
    from ..models.gpt import GPTConfig, GPTForPretraining
    from ..planner.rules import apply_partition_rules
    cfg = GPTConfig.gpt3_125m()
    plan = planner.plan(cfg, 8, chip="h100", verify="full",
                        model_name="125m")
    findings = plan.chosen.findings
    fams = plan.verify.get("families_checked", [])
    if findings or set(fams) != {"sharding", "program", "collective_order"}:
        print(f"SELFCHECK FAILED: the 125M plan is not lint-clean "
              f"(families {fams}, findings "
              f"{[f.rule_id for f in findings]})", file=sys.stderr)
        return 9
    # the plan's tags must lint clean on the live model too
    model = GPTForPretraining(cfg, device="meta")
    apply_partition_rules(model, plan.rules, overwrite=True)
    mesh = plan.mesh_spec()
    live = sharding_lint.lint_model_sharding(
        model, mesh, zero_stage=plan.layout.zero_stage)
    live += sharding_lint.lint_partition_rules(plan.rules, model, mesh)
    if live:
        print(f"SELFCHECK FAILED: the planner's tags lint dirty on the live "
              f"125M model: {[f.rule_id for f in live]}", file=sys.stderr)
        return 9
    rec = plan.to_record()
    problems = validate_record(rec) + check_records([rec])
    drifted = dict(rec, measured_hbm_bytes=int(
        rec["projected_hbm_bytes"] * 1.5))
    if problems:
        print(f"SELFCHECK FAILED: the plan record fails ledger_check: "
              f"{problems}", file=sys.stderr)
        return 9
    if not any("drift" in p for p in check_records([drifted])):
        print("SELFCHECK FAILED: a 50% projection drift did not trip the "
              "plan rule", file=sys.stderr)
        return 9
    print(f"selfcheck b OK: 125M plan {plan.layout.describe()} lint-clean "
          f"({plan.verify.get('program_ops', 0)} proxy ops, live-model "
          "lint clean, plan record valid, drift rule fires)")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(_PRESETS), default="125m")
    ap.add_argument("--chips", type=int, default=8,
                    help="card count (every axis free)")
    ap.add_argument("--mesh", default=None,
                    help="fix axes, e.g. dp=2,mp=8 (overrides --chips)")
    ap.add_argument("--chip", default="h100", choices=["h100"])
    ap.add_argument("--budget-gib", type=float, default=None,
                    help="per-card memory budget (default: 0.8 * the "
                         "card's memory)")
    ap.add_argument("--max-seq-len", type=int, default=None)
    ap.add_argument("--zero-stages", default="1,2,3")
    ap.add_argument("--micro-batches", default="1")
    ap.add_argument("--global-batch", type=int, default=None,
                    help="sequences per step to cost at (default: one "
                         "per card)")
    ap.add_argument("--dp-over-dcn", action="store_true",
                    help="dp is the outer axis of a two-level plan (its "
                         "collectives cross the inter-node link)")
    ap.add_argument("--verify", choices=["full", "sharding"],
                    default="full")
    ap.add_argument("--report", default=None,
                    help="write the JSON plan report here")
    ap.add_argument("--telemetry", default=None,
                    help="append the kind=plan record to this JSONL")
    ap.add_argument("--selfcheck", action="store_true")
    args = ap.parse_args(argv)

    if args.selfcheck:
        return run_selfcheck()

    from ..planner import InfeasiblePlanError
    try:
        plan = run_plan(args)
    except InfeasiblePlanError as e:
        print(f"autoshard: NO FEASIBLE PLAN — {e}", file=sys.stderr)
        for c in getattr(e, "candidates", [])[:40]:
            print(f"  {c.layout.describe():28} "
                  f"{c.projected_hbm_bytes / 2**30:8.2f} GiB  "
                  f"{c.reason}", file=sys.stderr)
        return 8
    emit(plan, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
