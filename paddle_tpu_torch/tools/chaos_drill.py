"""Chaos drill: the resilience runtime survives real kills — the port of
tools/chaos_drill.py.

A real train loop (`jit.TrainStep` with `resilience=`, AdamW, dropout)
run through the production wiring and killed on purpose:

  1. BASELINE — an uninterrupted run of S steps, a checkpoint after
                every step from step K-1 on (earlier saves would only
                repeat the same work), per-step losses logged;
  2. CRASH    — the same run SIGKILL'd right after step K's async save
                starts (that save's commit is held by a chaos stall, so
                the kill always lands while it is in flight: step_K is
                left as an uncommitted `.tmp` husk);
  3. RESUME   — a fresh process auto-resumes from the last COMMITTED
                step (K-1): model, optimizer and RNG restored, the loop
                finishes;
  4. VERDICT  — the stitched crash + resume losses equal the baseline's
                step for step (exact float equality), and so do the
                final weight digests and the final RNG states; the
                `kind=ckpt` ledger passes `telemetry.ledger_check`;
  5. CORRUPT  — a piece of the newest committed checkpoint is
                bit-flipped (`resilience.chaos.corrupt_one_file`):
                verification names the leaf and restore falls back to
                the previous valid checkpoint.

Legs 1 and 2 run side by side (they share nothing). Each training
process serves a `MetricsServer` and scrapes itself to show the
`ckpt.*` counters live, and runs under seeded transient I/O faults
(`--io-error-rate`, default 0.05) that the retry path absorbs.

    python -m paddle_tpu_torch.tools.chaos_drill                # the card
    python -m paddle_tpu_torch.tools.chaos_drill --device cpu --tiny
    python -m paddle_tpu_torch.tools.chaos_drill --selfcheck --device cpu

The card's run: GPT-3 125M at full width, its 12 layers cut to
CARD_LAYERS (the time of the smoke that runs it), batch 8 x 1024, bf16 amp, dropout 0.1, 6 steps, the kill after
step 5's save starts (resume from step_4). `--tiny`: a 2-layer width-64 GPT, batch 4 x 32.
`--selfcheck`: the JAX package's corrupt specimen
(`tools/specimens/ckpt_corrupt`, read as it is) must be rejected with
its leaf named, a re-manifested clean copy must pass, and the tiny
drill (kill at step 3) must pass.

Exit codes: 0 ok; 8 drill failed; 9 selfcheck miss.
"""
import argparse
import contextlib
import hashlib
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SPECIMEN = os.path.join(_ROOT, "tools", "specimens", "ckpt_corrupt",
                        "step_3")

EXIT_DRILL_FAILED = 8
EXIT_SELFCHECK_MISS = 9

TINY = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            max_seq_len=64, dropout=0.1)
TINY_BATCH = (4, 32)
CARD_BATCH = (8, 1024)
CARD_LAYERS = 4
LR, WD = 1e-4, 0.01


def _config(args):
    from ..models.gpt import GPTConfig
    if args.tiny:
        return GPTConfig(**TINY)
    return GPTConfig.gpt3_125m(dropout=0.1, num_layers=CARD_LAYERS)


def build(args, device=None):
    """(model, optimizer, loss_fn) of the drill, on its device (or
    `device`)."""
    import torch
    from .. import amp
    from ..models.gpt import GPTForPretraining
    from ..optimizer import AdamW
    torch.manual_seed(args.seed)
    dev = device or ("cpu" if args.device == "cpu" else None)
    model = GPTForPretraining(_config(args), device=dev, seed=args.seed)
    opt = AdamW(learning_rate=LR, weight_decay=WD,
                parameters=model.parameters())
    amp_on = not args.tiny

    def loss_fn(ids, lbl):
        with amp.auto_cast(enable=amp_on, dtype="bfloat16"):
            return model.loss(ids, lbl)
    return model, opt, loss_fn


def batch_at(i, args, device):
    """Step i's batch, a function of the step (a seekable loader's
    stand-in)."""
    import numpy as np
    import torch
    b, s = TINY_BATCH if args.tiny else CARD_BATCH
    vocab = _config(args).vocab_size
    rs = np.random.RandomState(10_000 + i)
    return [torch.from_numpy(rs.randint(0, vocab, (b, s))).to(device)
            for _ in range(2)]


def weights_digest(model):
    h = hashlib.sha256()
    for name, p in sorted(model.named_parameters()):
        h.update(name.encode())
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def run_child(args):
    """One training leg: auto-resume, train, log each step's loss,
    optionally SIGKILL itself after step K's save starts. Writes one
    JSON line a step and a final summary line (absent when killed)."""
    import urllib.request
    import warnings
    from ..jit import TrainStep
    from ..ops.kernel_registry import kernels, reset_launches
    from ..resilience import (ChaosConfig, ChaosMonkey, ResilienceManager,
                              RetryPolicy)
    from ..resilience.ckpt import rng_now
    from ..telemetry import MetricsServer
    model, opt, loss_fn = build(args)
    dev = next(model.parameters()).device
    res = ResilienceManager(
        args.dir, save_every=1, keep_last=2, preempt=False,
        sink=args.telemetry or None,
        retry=RetryPolicy(max_attempts=8, base_delay_s=0.01,
                          max_delay_s=0.05, seed=args.seed))
    step = TrainStep(model, loss_fn, opt, resilience=res)
    start = res.resume() or 0
    reset_launches()
    monkey = ChaosMonkey(ChaosConfig(seed=args.seed,
                                     io_error_rate=args.io_error_rate))
    out = open(args.out, "a")
    metrics_ok = False
    ms = []
    with MetricsServer() as srv, monkey.active(), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for i in range(start, args.steps):
            res.note(data_position=i + 1)
            res.save_every = 1 if i + 1 >= args.save_from else 0
            hold = contextlib.nullcontext()
            if args.kill_at and i + 1 == args.kill_at:
                # the save this step's boundary starts may not commit
                # before the kill: stall its commit (a crash mid-save),
                # once the save before it has committed
                res.ckpt.drain()
                hold = ChaosMonkey(ChaosConfig(
                    slow_write_s=3600.0, ops=("commit",))).active()
            t0 = time.perf_counter()
            with hold:
                loss = float(step(*batch_at(i, args, dev)))
                ms.append((time.perf_counter() - t0) * 1e3)
                out.write(json.dumps({"step": i, "loss": loss}) + "\n")
                out.flush()
                os.fsync(out.fileno())
                if args.kill_at and i + 1 == args.kill_at:
                    os.kill(os.getpid(), signal.SIGKILL)
        res.ckpt.drain()
        try:
            text = urllib.request.urlopen(srv.url + "/metrics",
                                          timeout=5).read().decode()
            metrics_ok = ("paddle_tpu_ckpt_saves" in text
                          and "paddle_tpu_ckpt_commits" in text)
        except Exception:
            metrics_ok = False
    commits = [r for r in res.ckpt.records if r["event"] == "commit"]
    saves = [r for r in res.ckpt.records if r["event"] == "save"]
    out.write(json.dumps({
        "summary": True, "resumed_from": res.resumed_from, "start": start,
        "metrics_ok": metrics_ok, "final_rng": rng_now(),
        "weights": weights_digest(model), "chaos_faults": monkey.faults,
        "step_ms": ms, "restore_ms": res.ckpt.last_restore_ms,
        "snapshot_ms": [r.get("snapshot_ms") for r in saves],
        "save_ms": [r.get("save_ms") for r in commits],
        "bytes": [r.get("bytes") for r in commits],
        "launches": {k.name: k.launches for k in kernels()}}) + "\n")
    out.close()
    res.close()
    return 0


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------

def _leg_cmd(args, workdir, out, kill_at=None, telemetry=None):
    cmd = [sys.executable, "-m", "paddle_tpu_torch.tools.chaos_drill",
           "--child", "--dir", workdir, "--out", out,
           "--steps", str(args.steps), "--seed", str(args.seed),
           "--save-from", str(max(1, args.kill_at - 1)),
           "--io-error-rate", str(args.io_error_rate),
           "--kill-at", str(kill_at or 0)]
    if args.tiny:
        cmd.append("--tiny")
    if args.device:
        cmd += ["--device", args.device]
    if telemetry:
        cmd += ["--telemetry", telemetry]
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    if args.device == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    return cmd, env


def _spawn_leg(args, workdir, out, kill_at=None, telemetry=None):
    cmd, env = _leg_cmd(args, workdir, out, kill_at, telemetry)
    return subprocess.run(cmd, cwd=_ROOT, env=env, capture_output=True,
                          text=True, timeout=args.leg_timeout)


def _start_leg(args, workdir, out, kill_at=None, telemetry=None):
    cmd, env = _leg_cmd(args, workdir, out, kill_at, telemetry)
    return subprocess.Popen(cmd, cwd=_ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _read_leg(path):
    losses, summary = {}, None
    if not os.path.exists(path):
        return losses, summary
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("summary"):
                summary = rec
            else:
                losses[rec["step"]] = rec["loss"]
    return losses, summary


def run_drill(root, args, verbose=True):
    """The kill-and-resume drill (see the module docstring). Returns
    (failures, report): failure strings ([] == passed) and the legs'
    numbers."""
    failures = []
    report = {}

    def say(msg):
        if verbose:
            print(f"chaos_drill: {msg}", flush=True)

    os.makedirs(root, exist_ok=True)
    base_dir = os.path.join(root, "baseline_ckpt")
    drill_dir = os.path.join(root, "drill_ckpt")
    base_out = os.path.join(root, "baseline.jsonl")
    drill_out = os.path.join(root, "drill.jsonl")
    ledger = os.path.join(root, "ckpt_ledger.jsonl")
    for p in (base_out, drill_out, ledger):
        if os.path.exists(p):
            os.remove(p)
    steps, kill_at = args.steps, args.kill_at

    # the baseline and the crashed run share nothing: side by side
    t0 = time.time()
    base_p = _start_leg(args, base_dir, base_out)
    crash_p = _start_leg(args, drill_dir, drill_out, kill_at=kill_at,
                         telemetry=ledger)
    try:
        _, crash_err = crash_p.communicate(timeout=args.leg_timeout)
        report["crash_s"] = time.time() - t0
        _, base_err = base_p.communicate(timeout=args.leg_timeout)
        report["baseline_s"] = time.time() - t0
    finally:
        for p in (base_p, crash_p):
            if p.poll() is None:
                p.kill()
                p.wait()
    if base_p.returncode != 0:
        return [f"baseline leg failed rc={base_p.returncode}: "
                f"{base_err[-1500:]}"], report
    base_losses, base_summary = _read_leg(base_out)
    report["baseline"] = base_summary
    say(f"baseline: {len(base_losses)} steps in {report['baseline_s']:.1f}s")
    if len(base_losses) != steps or base_summary is None:
        return [f"baseline leg incomplete: {len(base_losses)}/{steps} "
                "steps logged"], report

    if crash_p.returncode != -signal.SIGKILL:
        failures.append(f"crash leg: expected SIGKILL exit "
                        f"(-{int(signal.SIGKILL)}), got {crash_p.returncode}: "
                        f"{crash_err[-800:]}")
    crash_losses, crash_summary = _read_leg(drill_out)
    say(f"crash: killed after step {kill_at - 1}, "
        f"{len(crash_losses)} losses logged")
    if crash_summary is not None:
        failures.append("crash leg wrote a clean-exit summary — the kill "
                        "never happened")
    husks = [n for n in os.listdir(drill_dir) if n.endswith(".tmp")]
    report["husks"] = husks
    say(f"uncommitted husks left by the kill: {husks or 'none'}")

    t0 = time.time()
    proc = _spawn_leg(args, drill_dir, drill_out, telemetry=ledger)
    report["resume_s"] = time.time() - t0
    if proc.returncode != 0:
        return failures + [f"resume leg failed rc={proc.returncode}: "
                           f"{proc.stderr[-1500:]}"], report
    all_losses, resume_summary = _read_leg(drill_out)
    if resume_summary is None:
        return failures + ["resume leg wrote no summary"], report
    report["resume"] = resume_summary
    expect = kill_at - 1
    say(f"resume: restored from committed step "
        f"{resume_summary['resumed_from']} (expected {expect})")
    if resume_summary["resumed_from"] != expect:
        failures.append(
            f"resumed from step {resume_summary['resumed_from']}, "
            f"expected the last committed step {expect}")

    diverged = []
    for i in range(steps):
        b, d = base_losses.get(i), all_losses.get(i)
        if d is None:
            diverged.append(f"step {i}: missing from the drill run")
        elif b != d:
            diverged.append(f"step {i}: baseline {b!r} vs drill {d!r}")
    report["losses"] = [base_losses[i] for i in range(steps)]
    if diverged:
        failures.append("loss trajectory diverged after resume: "
                        + "; ".join(diverged[:4]))
    else:
        say(f"loss trajectory matches baseline exactly on all "
            f"{steps} steps")
    if resume_summary["weights"] != base_summary["weights"]:
        failures.append("final weights digest differs from baseline — "
                        "resume was not bit-identical")
    if resume_summary["final_rng"] != base_summary["final_rng"]:
        failures.append("final RNG state differs from baseline — the "
                        "restored generators diverged")
    for name, summ in (("baseline", base_summary),
                       ("resume", resume_summary)):
        if not summ.get("metrics_ok"):
            failures.append(f"{name} leg: ckpt.* metrics were NOT visible "
                            "on /metrics during the run")

    from ..telemetry.ledger_check import check_jsonl
    recs, problems = check_jsonl(ledger)
    report["ledger"] = ledger
    if problems:
        failures.append(f"ckpt telemetry ledger invalid: {problems[:3]}")
    else:
        say(f"ckpt ledger: {len(recs)} records validated")

    import warnings
    from .. import monitor
    from ..resilience import CheckpointManager, corrupt_one_file
    t0 = time.time()
    mgr = CheckpointManager(drill_dir)
    newest = mgr.latest_step()
    bad = corrupt_one_file(mgr.step_dir(newest), seed=args.seed,
                           prefer="arrays/model")
    # the restore target lives on the host: where it lives changes
    # nothing of the verification and the fallback under test
    model, opt, _ = build(args, device="cpu")
    before = monitor.get("ckpt.fallbacks")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        rs = mgr.restore(model=model, optimizer=opt)
    falls = [r for r in mgr.records if r["event"] == "fallback"]
    problems = falls[0]["problems"] if falls else []
    report["corrupt"] = {"file": os.path.relpath(bad, drill_dir),
                         "problem": problems[0] if problems else None}
    say(f"corrupted {os.path.relpath(bad, drill_dir)} -> "
        f"{problems[0] if problems else 'NOT DETECTED'}")
    if not problems:
        failures.append("corrupted piece was NOT detected by manifest "
                        "verification")
    elif "leaf" not in problems[0]:
        failures.append(f"corruption detected but no leaf named: "
                        f"{problems[0]}")
    if rs is None or rs.step == newest:
        failures.append(f"restore did not fall back past the corrupt "
                        f"step {newest} (got {rs})")
    else:
        report["corrupt"]["fell_back_to"] = rs.step
        say(f"restore fell back from corrupt step {newest} to valid "
            f"step {rs.step}")
    if monitor.get("ckpt.fallbacks") <= before:
        failures.append("ckpt.fallbacks counter did not advance")
    report["corrupt_s"] = time.time() - t0
    mgr.close()
    return failures, report


def run_selfcheck(args, expect_leaf="model.w", verbose=True):
    """The JAX specimen rejected with its leaf named, a re-manifested
    clean copy accepted, and the tiny drill passing."""
    from ..resilience.ckpt import (MANIFEST_NAME, _atomic_write_json,
                                   build_manifest, load_manifest,
                                   verify_checkpoint)
    failures = []
    problems = verify_checkpoint(SPECIMEN)
    if verbose:
        print(f"chaos_drill --selfcheck: specimen -> "
              f"{problems[0] if problems else 'ACCEPTED (!)'}")
    if not problems:
        failures.append(f"specimen {SPECIMEN} was ACCEPTED by manifest "
                        "verification — the verifier is blind")
    elif not [p for p in problems if f"leaf {expect_leaf}" in p]:
        failures.append(f"specimen rejected but the offending leaf "
                        f"{expect_leaf!r} was not named: {problems[:3]}")
    with tempfile.TemporaryDirectory(prefix="ckpt_selfcheck_") as td:
        clean = os.path.join(td, "step_3")
        shutil.copytree(SPECIMEN, clean)
        m = load_manifest(clean)
        _atomic_write_json(os.path.join(clean, MANIFEST_NAME),
                           build_manifest(clean, leaves=m.get("leaves"),
                                          step=m.get("step")))
        if verify_checkpoint(clean):
            failures.append("re-manifested specimen copy still rejected — "
                            "the verifier flags valid checkpoints")
    args.tiny, args.steps, args.kill_at = True, 6, 3
    with tempfile.TemporaryDirectory(prefix="chaos_drill_") as td:
        failures += run_drill(td, args, verbose=verbose)[0]
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dir", default=None,
                    help="working directory (default: a new one under "
                         "build/chaos_drill)")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs on the CPU; default the CUDA card")
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny GPT (the CPU run's)")
    ap.add_argument("--steps", type=int, default=None,
                    help="steps a run (default 6)")
    ap.add_argument("--kill-at", type=int, default=None,
                    help="SIGKILL after this step's save starts "
                         "(default 5; 3 with --tiny)")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--io-error-rate", type=float, default=0.05,
                    help="seeded transient-fault injection rate")
    ap.add_argument("--leg-timeout", type=float, default=600.0)
    ap.add_argument("--report", default=None,
                    help="write the legs' numbers here as JSON")
    ap.add_argument("--selfcheck", action="store_true",
                    help="specimen rejection + the tiny drill")
    ap.add_argument("--expect-leaf", default="model.w")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--save-from", type=int, default=1,
                    help=argparse.SUPPRESS)
    ap.add_argument("--telemetry", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.steps is None:
        args.steps = 6
    if args.kill_at is None:
        args.kill_at = 3 if args.tiny else 5

    if args.child:
        return run_child(args)
    if args.device != "cpu":
        import torch
        if not torch.cuda.is_available():
            print("chaos_drill runs on the CUDA card by default and none is "
                  "available; pass --device cpu", file=sys.stderr)
            return 2
    if args.selfcheck:
        failures = run_selfcheck(args, expect_leaf=args.expect_leaf)
        if failures:
            for f in failures:
                print(f"SELFCHECK FAILED: {f}", file=sys.stderr)
            return EXIT_SELFCHECK_MISS
        print("chaos_drill selfcheck OK: corrupt specimen rejected with "
              "the leaf named, clean copy accepted, kill/resume drill "
              "loss-continuous")
        return 0
    if not 0 < args.kill_at < args.steps:
        print(f"--kill-at {args.kill_at} must be in (0, --steps "
              f"{args.steps})", file=sys.stderr)
        return 2
    root = args.dir or tempfile.mkdtemp(
        prefix="chaos_drill_", dir=os.path.join(_ROOT, "build")
        if os.path.isdir(os.path.join(_ROOT, "build")) else None)
    failures, report = run_drill(root, args)
    if args.report:
        with open(args.report, "w") as f:
            json.dump({"failures": failures, **report}, f)
    if failures:
        for f in failures:
            print(f"DRILL FAILED: {f}", file=sys.stderr)
        return EXIT_DRILL_FAILED
    print(f"chaos_drill OK: SIGKILL at step {args.kill_at} under "
          f"{args.io_error_rate:.0%} fault injection -> auto-resume from "
          f"the last committed step, loss trajectory bit-identical to the "
          f"uninterrupted baseline; corrupt piece detected and walked past")
    return 0


if __name__ == "__main__":
    sys.exit(main())
