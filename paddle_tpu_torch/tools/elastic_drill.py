"""Elastic drill: a run survives the loss of a HOST — the port of
tools/elastic_drill.py's host-loss drill (:139-428) on the card.

The chaos drill shows a run surviving its own death (SIGKILL -> resume
onto the same world). This drill kills somebody else: a dp 2 "pod" of
two host processes, each training on the card through its own
`jit.TrainStep` (they form no process group, as in the JAX drill),
loses host 1 to SIGKILL, and the survivor walks the elastic protocol:

  detect   the dead peer by missed heartbeats over a registry directory
           (`distributed.elastic.ElasticCoordinator`, miss threshold 3,
           membership learned from heartbeats: no `expected_hosts`),
           polled at every step boundary and, while the step's
           checkpoint commits, every 0.15 s (the JAX drill's steps are
           short; a 125M-width commit takes seconds);
  replan   for the surviving chip count through the drill's `plan_fn`
           ({"dp": n}: a stand-in until the planner is ported, ROADMAP
           Queue 1 item 3);
  drain    a final checkpoint through `ResilienceManager`
           (`save_every=1`, stamped with the pod's layout {"dp": 2}),
           then exit ELASTIC_EXIT_CODE (101);
  reshard  a relaunched process with layout {"dp": 1} auto-resumes:
           the stored layout differs from the live one, so `resume()`
           takes the reshard route; its parameters, AdamW slots and RNG
           must equal the drained ones (digests);
  resume   2 more steps with finite losses.

Every transition is a `kind=elastic` record; the combined ledger
(elastic and ckpt records of both processes) must pass
`telemetry.ledger_check` with all five elastic events. On the card each
step of every child launches K1 (flash_fwd), K3 (flash_bwd) and K6
(layernorm_fwd_saved) once a layer, and no child runs nvcc: the children
import the same checkout and load the libraries the parent built under
its `build/paddle_tpu_torch/` (each reports `_build.nvcc_runs`).

    python -m paddle_tpu_torch.tools.elastic_drill              # the card
    python -m paddle_tpu_torch.tools.elastic_drill --device cpu --tiny

The card's run: GPT-3 125M's width (hidden 768, 12 heads of 64, vocab
50304) x CARD_LAYERS layers, 4 x 1024 tokens, bf16 amp, AdamW, dropout
0.1; the kill once host 0 has passed step 2 and seen host 1. `--tiny`:
a 2-layer width-64 GPT, 4 x 32, f32.

Exit codes: 0 ok; 8 drill failed.
"""
import argparse
import hashlib
import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

EXIT_DRILL_FAILED = 8

TINY = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            max_seq_len=64, dropout=0.1)
TINY_BATCH = (4, 32)
CARD_LAYERS = 2
CARD_BATCH = (4, 1024)
LR, WD = 1e-4, 0.01

# the detector's knobs, shared by both hosts and by the parent's bound on
# the detection latency. The timeout must exceed the longest gap between
# two heartbeats of a running host. A host's first step (its CUDA
# context, cuBLAS, the kernels' libraries: 1.6 s alone on the card, 6.0
# s beside the smoke's checkpoint jobs) runs before its first heartbeat,
# and membership is learned from heartbeats, so a slow start is never a
# miss; a running host's gaps on the card were 0.17-0.45 s (PERF.md).
HEARTBEAT_TIMEOUT_S = {"card": 6.0, "cpu": 3.0}
MISS_THRESHOLD = 3
POLL_SLEEP_S = 0.15
TRAIN_KERNELS = ("flash_fwd", "flash_bwd", "layernorm_fwd_saved")


def _config(args):
    from ..models.gpt import GPTConfig
    if args.tiny:
        return GPTConfig(**TINY)
    return GPTConfig.gpt3_125m(dropout=0.1, num_layers=CARD_LAYERS)


def build(args):
    """(model, optimizer, loss_fn) of the drill on its device."""
    import torch
    from .. import amp
    from ..models.gpt import GPTForPretraining
    from ..optimizer import AdamW
    torch.manual_seed(args.seed)
    dev = "cpu" if args.device == "cpu" else None
    if dev == "cpu":
        # three processes share the host's cores with whatever else runs
        # there; a thread pool each oversubscribes them, and a tiny step
        # then takes seconds, longer than the heartbeat timeout
        torch.set_num_threads(1)
    model = GPTForPretraining(_config(args), device=dev, seed=args.seed)
    opt = AdamW(learning_rate=LR, weight_decay=WD,
                parameters=model.parameters())
    amp_on = not args.tiny

    def loss_fn(ids, lbl):
        with amp.auto_cast(enable=amp_on, dtype="bfloat16"):
            return model.loss(ids, lbl)
    return model, opt, loss_fn


def batch_at(i, args, device):
    """Step i's batch, a function of the step."""
    import numpy as np
    import torch
    b, s = TINY_BATCH if args.tiny else CARD_BATCH
    rs = np.random.RandomState(20_000 + i)
    return [torch.from_numpy(rs.randint(0, _config(args).vocab_size,
                                        (b, s))).to(device)
            for _ in range(2)]


def state_digests(model, optimizer):
    """(parameters' digest, optimizer slots' digest) over the leaves a
    checkpoint holds (`distributed.checkpoint.state_leaves`), by name."""
    import torch
    from ..distributed.checkpoint import state_leaves
    h = {"model": hashlib.sha256(), "opt": hashlib.sha256()}
    for pl in sorted(state_leaves(model, optimizer), key=lambda p: p.name):
        v = pl.get()
        d = h["model" if pl.name.startswith("model.") else "opt"]
        d.update(pl.name.encode())
        if isinstance(v, torch.Tensor):
            d.update(v.detach().float().cpu().numpy().tobytes())
        else:
            d.update(repr(v).encode())
    return h["model"].hexdigest(), h["opt"].hexdigest()


def plan_fn(n_chips):
    """The replan's stand-in for the planner: data parallel over the
    surviving chips."""
    return {"dp": int(n_chips)}


def _launches():
    from ..ops.kernel_registry import kernels
    return {k.name: k.launches for k in kernels()}


def _timed_step(step, batch):
    from ..ops.kernel_registry import reset_launches
    reset_launches()
    t0 = time.perf_counter()
    loss = float(step(*batch))
    return loss, (time.perf_counter() - t0) * 1e3, _launches()


def await_commit(res, coord, step):
    """Wait out the checkpoint commit in flight (the step's save; 650 MB
    on the card, seconds on a busy disk), polling the coordinator at its
    interval meanwhile, so that detection is bound by the poll and not
    by the disk. A change detected here latches until the next step
    boundary acts on it. -> the seconds waited."""
    t0 = time.perf_counter()
    pend = res.ckpt._pending
    while pend is not None and not pend[2].done():
        coord.poll(step=step)
        time.sleep(POLL_SLEEP_S)
    return time.perf_counter() - t0


def run_host(args):
    """One host of the dp 2 pod. Host 0, the chief, owns the checkpoints,
    the ledger and the coordinator; host 1 trains and heartbeats until
    it is killed."""
    from ..distributed.elastic import ElasticCoordinator, ElasticManager
    from ..jit import TrainStep
    from ..ops import _build
    from ..resilience import ResilienceManager, RetryPolicy
    from ..resilience.ckpt import rng_now
    host = str(args.host_id)
    model, opt, loss_fn = build(args)
    dev = next(model.parameters()).device
    em = ElasticManager(args.registry, np=2, host_id=host,
                        heartbeat_interval=POLL_SLEEP_S,
                        timeout=args.heartbeat_timeout,
                        fault_tolerance_level=1)
    out = open(args.out, "a")

    def log(**rec):
        out.write(json.dumps(rec) + "\n")
        out.flush()
        os.fsync(out.fileno())

    if host != "0":
        # the victim: train, heartbeat after every step (the first one
        # registers it), until killed
        step = TrainStep(model, loss_fn, opt)
        last, i = None, 0
        while True:
            loss, ms, launches = _timed_step(step, batch_at(i, args, dev))
            em.heartbeat()
            now = time.monotonic()
            log(host=host, step=i + 1, loss=loss, ms=ms,
                gap_s=None if last is None else now - last,
                launches=launches, nvcc_runs=_build.nvcc_runs)
            last, i = now, i + 1
            time.sleep(POLL_SLEEP_S)

    res = ResilienceManager(
        args.dir, save_every=1, preempt=False, sink=args.telemetry or None,
        layout={"dp": 2}, rank=0,
        retry=RetryPolicy(max_attempts=4, base_delay_s=0.01,
                          max_delay_s=0.05))
    coord = ElasticCoordinator(em, plan_fn=plan_fn,
                               miss_threshold=MISS_THRESHOLD).attach(res)
    step = TrainStep(model, loss_fn, opt, resilience=res)
    em.register()
    i = res.resume() or 0
    try:
        while True:
            loss, ms, launches = _timed_step(step, batch_at(i, args, dev))
            i += 1
            wait_s = await_commit(res, coord, i)
            log(host=host, step=i, loss=loss, ms=ms, launches=launches,
                commit_wait_s=wait_s, known=sorted(coord._known))
            time.sleep(POLL_SLEEP_S)
    except SystemExit as e:
        # the step that ran into the boundary's exit: its loss and
        # launches, then what the drained checkpoint holds
        detect = [r for r in coord.events if r["event"] == "declared_dead"]
        params, slots = state_digests(model, opt)
        log(summary=True, host=host, exit_code=e.code,
            drained_step=res.state.step, exit_loss=float(res.last_loss),
            exit_launches=_launches(), params=params, slots=slots,
            rng=rng_now(), events=coord.events,
            detect_s=detect[0].get("detect_s") if detect else None,
            next_layout=coord.next_layout, nvcc_runs=_build.nvcc_runs)
        out.close()
        raise


def run_relaunch(args):
    """The relaunch onto the 1-host world: resume (which must take the
    reshard route), check what it restored, train `--steps` steps."""
    from ..jit import TrainStep
    from ..ops import _build
    from ..resilience import ResilienceManager, RetryPolicy
    from ..resilience.ckpt import rng_now
    model, opt, loss_fn = build(args)
    dev = next(model.parameters()).device
    res = ResilienceManager(
        args.dir, model=model, optimizer=opt, save_every=1, preempt=False,
        sink=args.telemetry or None, layout=plan_fn(1), rank=0,
        retry=RetryPolicy(max_attempts=4, base_delay_s=0.01,
                          max_delay_s=0.05))
    step = TrainStep(model, loss_fn, opt, resilience=res)
    t0 = time.perf_counter()
    start = res.resume() or 0
    restore_ms = (time.perf_counter() - t0) * 1e3
    params, slots = state_digests(model, opt)
    rng = rng_now()
    losses, ms, launches = [], [], []
    for i in range(start, start + args.steps):
        loss, m, lc = _timed_step(step, batch_at(i, args, dev))
        losses.append(loss)
        ms.append(m)
        launches.append(lc)
    res.ckpt.drain()
    res.close()
    with open(args.out, "a") as out:
        out.write(json.dumps({
            "summary": True, "relaunch": True, "layout": res.layout,
            "resumed_from": res.resumed_from,
            "resumed_via": res.resumed_via, "restore_ms": restore_ms,
            "params": params, "slots": slots, "rng": rng,
            "losses": losses, "ms": ms, "launches": launches,
            "nvcc_runs": _build.nvcc_runs}) + "\n")
    return 0


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------

def _child_cmd(args, extra):
    cmd = [sys.executable, "-m", "paddle_tpu_torch.tools.elastic_drill",
           "--seed", str(args.seed), "--heartbeat-timeout",
           str(args.heartbeat_timeout)] + extra
    if args.tiny:
        cmd.append("--tiny")
    if args.device:
        cmd += ["--device", args.device]
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    if args.device == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    return cmd, env


def _start(args, extra, log):
    cmd, env = _child_cmd(args, extra)
    with open(log, "w") as f:
        # a session of its own: a kill takes the whole process group
        return subprocess.Popen(cmd, cwd=_ROOT, env=env, stdout=f,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)


def _read(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _tail(path, n=1500):
    try:
        with open(path) as f:
            return f.read()[-n:]
    except OSError:
        return ""


def _killpg(p):
    if p.poll() is None:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    p.wait()


def expected_launches(args, launches):
    """K1/K3/K6 once a layer a step on the card, nothing else; nothing at
    all on the CPU (the plain versions run)."""
    n = 0 if args.device == "cpu" else _config(args).num_layers
    return {k: (n if k in TRAIN_KERNELS else 0) for k in launches}


def run_drill(root, args, verbose=True):
    """The host-loss drill. -> (failures, report): failure strings ([]
    == passed) and the legs' numbers."""
    failures, report = [], {}

    def say(msg):
        if verbose:
            print(f"elastic_drill: {msg}", flush=True)

    t_drill = time.perf_counter()
    os.makedirs(root, exist_ok=True)
    registry = os.path.join(root, "registry")
    ckpt_dir = os.path.join(root, "ckpt")
    ledger = os.path.join(root, "elastic_ledger.jsonl")
    out0, out1 = (os.path.join(root, f"host{h}.jsonl") for h in (0, 1))
    logs = [os.path.join(root, f"host{h}.log") for h in (0, 1)]
    for p in (ledger, out0, out1):
        if os.path.exists(p):
            os.remove(p)

    # -- leg 1: the pod; SIGKILL host 1 once host 0 has passed
    # --kill-after steps and seen host 1
    common = ["--child-host", "--dir", ckpt_dir, "--registry", registry]
    h0 = _start(args, common + ["--host-id", "0", "--out", out0,
                                "--telemetry", ledger], logs[0])
    h1 = _start(args, common + ["--host-id", "1", "--out", out1], logs[1])
    try:
        deadline = time.monotonic() + args.leg_timeout
        k0 = None
        while time.monotonic() < deadline and h0.poll() is None:
            recs = [r for r in _read(out0) if "step" in r]
            if recs and recs[-1]["step"] >= args.kill_after and \
                    "1" in recs[-1]["known"]:
                k0 = recs[-1]["step"]
                break
            time.sleep(0.05)
        if k0 is None:
            return [f"host 0 never passed step {args.kill_after} with host "
                    f"1 seen (rc {h0.poll()}): {_tail(logs[0])} / host 1: "
                    f"{_tail(logs[1])}"], report
        t_kill = time.monotonic()
        os.killpg(h1.pid, signal.SIGKILL)
        say(f"SIGKILL'd host 1 after host 0's step {k0}; host 0 must "
            f"detect within ~{args.heartbeat_timeout + MISS_THRESHOLD * POLL_SLEEP_S:.1f}"
            " s + drain")
        try:
            h0.wait(timeout=args.leg_timeout)
        except subprocess.TimeoutExpired:
            return ["host 0 never exited after its peer died: the failure "
                    "detector is blind"], report
        report["kill_to_exit_s"] = time.monotonic() - t_kill
    finally:
        _killpg(h1)
        _killpg(h0)
    report["pod_s"] = time.perf_counter() - t_drill

    from ..distributed.launch import ELASTIC_EXIT_CODE
    if h0.returncode != ELASTIC_EXIT_CODE:
        failures.append(f"host 0 exited {h0.returncode}, expected "
                        f"ELASTIC_EXIT_CODE {ELASTIC_EXIT_CODE}: "
                        f"{_tail(logs[0])}")
    recs0 = _read(out0)
    summ0 = next((r for r in recs0 if r.get("summary")), None)
    if summ0 is None:
        return failures + [f"host 0 wrote no summary: {_tail(logs[0])}"], \
            report
    steps0 = [r for r in recs0 if "step" in r and not r.get("summary")]
    steps1 = [r for r in _read(out1) if "step" in r]
    events = summ0["events"]
    names = [e["event"] for e in events]
    report.update(
        drained_step=summ0["drained_step"], exit_code=h0.returncode,
        detect_s=summ0["detect_s"], events=names, kill_step=k0,
        next_layout=summ0["next_layout"],
        host0_losses=[r["loss"] for r in steps0] + [summ0["exit_loss"]],
        host0_ms=[r["ms"] for r in steps0],
        host0_commit_wait_s=[r["commit_wait_s"] for r in steps0],
        host1_ms=[r["ms"] for r in steps1],
        host1_gaps_s=[r["gap_s"] for r in steps1],
        heartbeat_timeout_s=args.heartbeat_timeout)
    say(f"host 0: exit {h0.returncode} at drained step "
        f"{summ0['drained_step']}, {report['kill_to_exit_s']:.1f} s from "
        f"the kill, detect_s {summ0['detect_s']}, events {names}")
    # in order: the misses, the death, the replan, the relaunch
    n_miss = names.index("declared_dead") if "declared_dead" in names else -1
    if n_miss < 1 or set(names[:n_miss]) != {"heartbeat_miss"} or \
            names[n_miss:] != ["declared_dead", "replan", "relaunch"]:
        failures.append(f"host 0's elastic events are not heartbeat_miss..., "
                        f"declared_dead, replan, relaunch: {names}")
    early = [e for e in events if e["event"] == "heartbeat_miss"
             and e.get("step", 0) <= k0]
    if early:
        failures.append(f"a heartbeat miss before the kill (host 1 was "
                        f"alive): {early[0]}; raise the heartbeat timeout "
                        f"above host 1's gaps {report['host1_gaps_s']}")
    replan = next((e for e in events if e["event"] == "replan"), {})
    if (replan.get("layout_to") or {}).get("dp") != 1 or \
            (summ0.get("next_layout") or {}).get("dp") != 1:
        failures.append(f"the replan did not land on dp 1: {replan}")
    bound = args.heartbeat_timeout + MISS_THRESHOLD * POLL_SLEEP_S + 5.0
    if summ0["detect_s"] is None or summ0["detect_s"] > bound:
        failures.append(f"death detected in {summ0['detect_s']} s, outside "
                        f"the bound {bound:.2f} s")

    # -- leg 2: the relaunch onto dp 1
    t0 = time.perf_counter()
    cmd, env = _child_cmd(args, ["--child-relaunch", "--dir", ckpt_dir,
                                 "--steps", str(args.steps), "--out", out0,
                                 "--telemetry", ledger])
    proc = subprocess.run(cmd, cwd=_ROOT, env=env, capture_output=True,
                          text=True, timeout=args.leg_timeout)
    report["relaunch_s"] = time.perf_counter() - t0
    if proc.returncode != 0:
        return failures + [f"the relaunch failed rc={proc.returncode}: "
                           f"{proc.stderr[-1500:]}"], report
    summ1 = next((r for r in _read(out0) if r.get("relaunch")), None)
    if summ1 is None:
        return failures + ["the relaunch wrote no summary"], report
    report.update(resumed_via=summ1["resumed_via"],
                  resumed_from=summ1["resumed_from"],
                  relaunch_losses=summ1["losses"],
                  relaunch_ms=summ1["ms"],
                  restore_ms=summ1["restore_ms"])
    say(f"relaunch: layout {summ1['layout']}, resumed from step "
        f"{summ1['resumed_from']} via {summ1['resumed_via']}, losses "
        f"{summ1['losses']}")
    if summ1["resumed_via"] != "reshard":
        failures.append(f"the relaunch resumed via {summ1['resumed_via']!r}, "
                        "not the reshard route (stored dp 2, live dp 1)")
    if summ1["resumed_from"] != summ0["drained_step"]:
        failures.append(f"the relaunch resumed from step "
                        f"{summ1['resumed_from']}, host 0 drained step "
                        f"{summ0['drained_step']}")
    for what in ("params", "slots", "rng"):
        if summ1[what] != summ0[what]:
            failures.append(f"the restored {what} differ from the drained "
                            "ones")
    if len(summ1["losses"]) != args.steps or not all(
            math.isfinite(v) for v in summ1["losses"]):
        failures.append(f"the relaunch's losses are not {args.steps} finite "
                        f"values: {summ1['losses']}")

    # every child's steps: K1/K3/K6 once a layer a step, no nvcc
    per_step = {"host0": [r["launches"] for r in steps0]
                + [summ0["exit_launches"]],
                "host1": [r["launches"] for r in steps1],
                "relaunch": summ1["launches"]}
    report["launches"] = {}
    for who, rows in per_step.items():
        for i, got in enumerate(rows):
            if got != expected_launches(args, got):
                failures.append(f"{who} step {i + 1}: launches {got} != "
                                f"{expected_launches(args, got)}")
        report["launches"][who] = {k: sum(r.get(k, 0) for r in rows)
                                   for k in (rows[0] if rows else {})}
    runs = {"host0": summ0["nvcc_runs"], "relaunch": summ1["nvcc_runs"],
            "host1": max([r["nvcc_runs"] for r in steps1] or [0])}
    if any(runs.values()):
        failures.append(f"a child ran nvcc: {runs}")

    # -- leg 3: the combined ledger
    from ..telemetry.ledger_check import check_jsonl
    recs, problems = check_jsonl(ledger)
    seen = {r.get("event") for r in recs if r.get("kind") == "elastic"}
    report["ledger"] = {"elastic": sum(r.get("kind") == "elastic"
                                       for r in recs),
                        "ckpt": sum(r.get("kind") == "ckpt" for r in recs)}
    if problems:
        failures.append(f"the elastic ledger is invalid: {problems[:3]}")
    missing = [e for e in ("heartbeat_miss", "declared_dead", "replan",
                           "relaunch", "reshard_restore") if e not in seen]
    if missing:
        failures.append(f"the ledger lacks the elastic events {missing}")
    if not problems and not missing:
        say(f"ledger: {report['ledger']['elastic']} kind=elastic and "
            f"{report['ledger']['ckpt']} kind=ckpt records validated")
    report["drill_s"] = time.perf_counter() - t_drill
    return failures, report


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dir", default=None,
                    help="working directory (default: a new one under "
                         "build/)")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs on the CPU; default the CUDA card")
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny GPT (the CPU run's)")
    ap.add_argument("--steps", type=int, default=2,
                    help="the relaunch's steps")
    ap.add_argument("--kill-after", type=int, default=2,
                    help="SIGKILL host 1 once host 0 has passed this step")
    ap.add_argument("--seed", type=int, default=4321)
    ap.add_argument("--heartbeat-timeout", type=float, default=None,
                    help="seconds without a heartbeat before a miss "
                         "(default HEARTBEAT_TIMEOUT_S of the device)")
    ap.add_argument("--leg-timeout", type=float, default=300.0)
    ap.add_argument("--report", default=None,
                    help="write the legs' numbers here as JSON")
    ap.add_argument("--child-host", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--child-relaunch", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--host-id", default="0", help=argparse.SUPPRESS)
    ap.add_argument("--registry", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--telemetry", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.heartbeat_timeout is None:
        args.heartbeat_timeout = HEARTBEAT_TIMEOUT_S[
            "cpu" if args.device == "cpu" else "card"]

    import warnings
    warnings.simplefilter("ignore", RuntimeWarning)
    if args.child_host:
        return run_host(args)
    if args.child_relaunch:
        return run_relaunch(args)
    if args.device != "cpu":
        import torch
        if not torch.cuda.is_available():
            print("elastic_drill runs on the CUDA card by default and none "
                  "is available; pass --device cpu", file=sys.stderr)
            return 2
    # a SIGTERM unwinds through run_drill's cleanup, which kills the
    # hosts (each runs in a session of its own, out of this group's reach)
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(128 + signal.SIGTERM))
    root = args.dir or tempfile.mkdtemp(
        prefix="elastic_drill_", dir=os.path.join(_ROOT, "build")
        if os.path.isdir(os.path.join(_ROOT, "build")) else None)
    failures, report = run_drill(root, args)
    if args.report:
        with open(args.report, "w") as f:
            json.dump({"failures": failures, **report}, f)
    if failures:
        for f in failures:
            print(f"DRILL FAILED: {f}", file=sys.stderr)
        return EXIT_DRILL_FAILED
    print("elastic_drill OK: SIGKILL of one dp 2 host -> declared dead "
          "within the bound, replan to dp 1, exit 101 with a drained "
          "checkpoint, reshard-restore with equal parameters, AdamW slots "
          "and RNG, finite continued losses, a valid elastic ledger")
    return 0


if __name__ == "__main__":
    sys.exit(main())
