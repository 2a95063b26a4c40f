"""Fleet drill: replica processes behind one router on one card, one
SIGKILLed mid-stream, a respawn, a rolling restart under load, and the
combined ledger checked by telemetry/ledger_check.py.

The port's counterpart of the JAX package's tools/fleet_drill.py:

    python -m paddle_tpu_torch.fleet.drill            # on the CUDA card
    python -m paddle_tpu_torch.fleet.drill --device cpu --tiny

A replica is `python -m paddle_tpu_torch.fleet.drill --serve`: it builds
GPT-3 125M (random weights from --seed, std --init-range; `--tiny`: a
2-layer model of width 128) on its device, starts a `ServingEngine` with
its own `engine_id` and its own JSONL ledger at the serve configuration
(16 slots, block 16, prefill chunk 128, max_model_len 512; bf16) behind
a `ServingHTTPServer`, and prints one JSON line when ready: its port,
device name and power limit, and the SHA-256 of its weights. SIGTERM
drains it to quiesce (the quiesce record lands in its ledger) and it
exits 0 after printing each kernel's launch count from the port's
registry; SIGKILL is the chaos case (no quiesce, maybe a torn last
line). There is no warm-up submit: the engine's quiesce counts every
admission and the ledger rules hold the router's per-engine admissions
to it exactly. `--device` defaults to the card: without one a replica
exits non-zero unless `--device cpu` was given.

`drill()` is the supervisor: it spawns the replicas in parallel (and
one more behind a router of its own, the single-replica baseline),
measures waves of greedy streams through the
router over all replicas and over the solo one (best of 2 each; the
second fleet wave is the no-kill reference), runs the chaos wave (the
replica of the first stream to reach half its tokens is SIGKILLed; every
stream must complete through failover, each splice must balance, and
the tokens streamed before the kill must equal the reference), respawns
the victim under a new `engine_id`, runs `FleetRouter.rolling_restart`
(SIGTERM -> drain -> exit -> respawn -> ready) under feeder traffic
(half greedy, half sampled with seeds; zero failures allowed), sends one
more wave through a `FleetHTTPServer` over the router (JSONL streams;
its /metrics, /healthz and /replicas are read too) so that every final
incarnation serves, drains every replica and checks the concatenated
ledger (every incarnation and both routers).

The kernels are built by the parent before it spawns (`ops._build`'s
cross-process file lock also makes concurrent builds wait for one
another), so replicas load what is built. Exit codes: 0 ok, 12 findings.
"""
import argparse
import hashlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

__all__ = ["SERVE_ENGINE", "TINY_ENGINE", "build_model", "weights_checksum",
           "serve_prompts", "feeder_knobs", "serve", "ReplicaProcess",
           "drill"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the serve configuration of GPT-3 125M (the JAX bench_serving.py's
# engine shape, :274-276)
SERVE_ENGINE = dict(max_slots=16, block_size=16, prefill_chunk=128,
                    max_model_len=512)
INIT_RANGE = 0.055
# the CPU rehearsal's model and engine
TINY_MODEL = dict(vocab_size=512, hidden_size=128, num_layers=2,
                  num_heads=4, max_seq_len=128, dropout=0.0,
                  initializer_range=0.2)
TINY_ENGINE = dict(max_slots=4, block_size=8, prefill_chunk=8,
                   max_model_len=64)
# the sampled feeders' knob sets (a seed each)
SAMPLED_KNOBS = ({"top_k": 50}, {"top_p": 0.9}, {"temperature": 0.8},
                 {"top_k": 50, "top_p": 0.9, "temperature": 0.8})
# the kernels every replica's served path launches
SERVED_KERNELS = ("layernorm_fused", "paged_decode", "flash_prefill_chunk")
EXIT_FINDINGS = 12
N_REPLICAS = 3
N_FEEDERS = 4               # feeder threads during the rolling restart
READY_TIMEOUT_S = 600


def build_model(seed=0, init_range=INIT_RANGE, device=None, tiny=False):
    """GPT-3 125M (or the tiny rehearsal model) from `seed`."""
    from ..models.gpt import GPTConfig, GPTForPretraining
    cfg = GPTConfig(**TINY_MODEL) if tiny else GPTConfig.gpt3_125m(
        max_seq_len=1024, initializer_range=init_range)
    return GPTForPretraining(cfg, device=device, seed=seed)


def weights_checksum(model):
    """SHA-256 over the parameters' bytes, in name order."""
    h = hashlib.sha256()
    for name, p in sorted(model.named_parameters()):
        h.update(name.encode())
        h.update(p.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def serve_prompts(seed, vocab, n=32, template_len=96, lo=16, hi=384):
    """The serve prompts: `n` prompts of lo..hi tokens from `seed`, the
    even ones starting with one shared `template_len`-token template."""
    rng = np.random.default_rng(seed)
    template = rng.integers(0, vocab, template_len).tolist()
    lengths = rng.integers(lo, hi + 1, n)
    prompts = []
    for i, length in enumerate(lengths):
        if i % 2 == 0:
            tail = rng.integers(0, vocab, max(int(length), template_len + 1)
                                - template_len).tolist()
            prompts.append(template + tail)
        else:
            prompts.append(rng.integers(0, vocab, int(length)).tolist())
    return prompts


def feeder_knobs(i):
    """Even requests greedy, odd ones sampled with a seed of their own."""
    if i % 2 == 0:
        return {}
    return {"decode_strategy": "sampling", "seed": 1000 + i,
            **SAMPLED_KNOBS[(i // 2) % len(SAMPLED_KNOBS)]}


# ---------------------------------------------------------------------------
# child: one replica process
# ---------------------------------------------------------------------------

def _wait_http_idle(timeout_s):
    """Wait until no HTTP handler thread is alive: after a drain the
    finished streams' handlers still write their last events, and
    closing the front under them would tear those streams."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if not any("process_request_thread" in t.name
                   for t in threading.enumerate()):
            return True
        time.sleep(0.01)
    return False


def _emit(obj):
    print(json.dumps(obj), flush=True)


def serve(port, engine_id, telemetry, seed=0, init_range=INIT_RANGE,
          device=None, tiny=False, dtype="bfloat16"):
    """Run one replica until SIGTERM (see the module docstring)."""
    import torch

    from ..device import card_line, resolve_device
    from ..ops.kernel_registry import kernels
    from ..serving import ServingEngine, ServingHTTPServer
    from ..telemetry.sink import JsonlSink

    dev = resolve_device(device)        # no card and no --device: raises
    model = build_model(seed, init_range, dev, tiny)
    checksum = weights_checksum(model)
    sink = JsonlSink(telemetry)
    engine = ServingEngine(model, sink=sink, engine_id=engine_id,
                           enable_tracing=False, device=dev,
                           dtype=dtype if dtype != "model" else None,
                           **(TINY_ENGINE if tiny else SERVE_ENGINE))
    del model                           # the engine holds its own copy
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda sig, frame: stop.set())
    engine.start()
    srv = ServingHTTPServer(engine, port=port).start()
    on_card = dev.type == "cuda"
    _emit({"event": "ready", "engine_id": engine_id, "port": srv.port,
           "pid": os.getpid(),
           "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
           "card": card_line() if on_card else None,
           "weights_sha256": checksum})
    while not stop.wait(0.05):
        pass
    drained = engine.drain(timeout=300)
    idle = _wait_http_idle(30)
    srv.stop()
    engine.stop()
    sink.close()
    if on_card:
        torch.cuda.synchronize(dev)
    _emit({"event": "exit", "engine_id": engine_id, "drained": drained,
           "http_idle": idle,
           "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
           "launches": {k.name: k.launches for k in kernels()}})
    return 0 if drained and idle else 1


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------

class ReplicaProcess:
    """One incarnation of a replica: a `--serve` child, its JSON lines
    (ready and exit reports) read by a thread, its stderr in a log."""

    def __init__(self, name, engine_id, workdir, child_args):
        self.name = name
        self.engine_id = int(engine_id)
        self.ledger = os.path.join(workdir, f"{name}-e{engine_id}.jsonl")
        self.log = os.path.join(workdir, f"{name}-e{engine_id}.log")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
        with open(self.log, "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "paddle_tpu_torch.fleet.drill",
                 "--serve", "--port", "0", "--engine-id", str(engine_id),
                 "--telemetry", self.ledger, *child_args],
                cwd=_ROOT, env=env, stdout=subprocess.PIPE, stderr=err,
                text=True)
        self.reports = []
        self._cv = threading.Condition()
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                rep = json.loads(line)
            except ValueError:
                continue
            with self._cv:
                self.reports.append(rep)
                self._cv.notify_all()
        with self._cv:
            self._cv.notify_all()

    def report(self, event):
        with self._cv:
            return next((r for r in self.reports
                         if r.get("event") == event), None)

    def _tail(self, n=2000):
        try:
            with open(self.log) as f:
                return f.read()[-n:]
        except OSError:
            return ""

    def wait_ready(self, timeout_s):
        """The ready report; raises if the child exits or times out."""
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while True:
                rep = next((r for r in self.reports
                            if r.get("event") == "ready"), None)
                if rep is not None:
                    return rep
                if self.proc.poll() is not None and \
                        not self._reader.is_alive():
                    raise RuntimeError(
                        f"replica {self.name} (engine {self.engine_id}) "
                        f"exited {self.proc.returncode} before ready:\n"
                        f"{self._tail()}")
                left = deadline - time.monotonic()
                if left <= 0:
                    raise RuntimeError(
                        f"replica {self.name} (engine {self.engine_id}) "
                        f"not ready in {timeout_s} s:\n{self._tail()}")
                self._cv.wait(min(left, 0.5))

    @property
    def url(self):
        return f"http://127.0.0.1:{self.report('ready')['port']}"

    def terminate(self, timeout_s):
        """SIGTERM -> drain -> exit; returns the exit report, raises
        unless the child exited 0 with one."""
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=30)
            raise RuntimeError(f"replica {self.name} (engine "
                               f"{self.engine_id}) did not drain on "
                               f"SIGTERM in {timeout_s} s")
        self._reader.join(timeout=30)
        rep = self.report("exit")
        if rc != 0 or rep is None:
            raise RuntimeError(f"replica {self.name} (engine "
                               f"{self.engine_id}) exited {rc}:\n"
                               f"{self._tail()}")
        return rep

    def kill(self):
        """SIGKILL: no drain, no goodbye."""
        self.proc.kill()
        self.proc.wait(timeout=60)
        self._reader.join(timeout=30)

    def alive(self):
        return self.proc.poll() is None


def _concat_ledgers(paths, out_path):
    """Concatenate per-process JSONLs. A SIGKILLed process may leave a
    torn final line: drop ONLY a last line that does not parse (a torn
    line mid-file is corruption, and the rules must see it)."""
    records = []
    with open(out_path, "w") as out:
        for p in paths:
            if not os.path.exists(p):
                continue
            with open(p) as f:
                lines = [ln for ln in f.read().splitlines() if ln.strip()]
            if lines:
                try:
                    json.loads(lines[-1])
                except ValueError:
                    lines = lines[:-1]
            for line in lines:
                out.write(line + "\n")
                records.append(json.loads(line))
    return records


def _wave(router, prompts, params, tag, kill=None):
    """Stream every prompt through `router` at once, one thread each.
    Returns (tokens per stream, error per stream, wall seconds). With
    `kill(streams)`: called once from this thread as soon as any stream
    has streamed half its tokens."""
    streams = [[] for _ in prompts]
    errors = [None] * len(prompts)

    def client(i):
        try:
            for tok in router.stream(prompts[i], params[i],
                                     request_id=f"{tag}-{i}"):
                streams[i].append(tok)
        except Exception as e:      # noqa: BLE001 — recorded per stream
            errors[i] = e

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    if kill is not None:
        half = [p["max_new_tokens"] // 2 for p in params]
        while not any(len(s) >= h for s, h in zip(streams, half)):
            if not any(t.is_alive() for t in threads):
                break
            time.sleep(0.001)
        kill(streams)
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise RuntimeError(f"{tag}: a stream did not end in 900 s")
    return streams, errors, wall


def _http_wave(url, prompts, params, tag):
    """The `_wave` of streams POSTed to a fleet front as JSONL streams."""
    import urllib.request
    streams = [[] for _ in prompts]
    errors = [None] * len(prompts)

    def client(i):
        body = json.dumps({"prompt": prompts[i], "stream": True,
                           "request_id": f"{tag}-{i}", **params[i]})
        req = urllib.request.Request(
            url + "/generate", data=body.encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=900) as r:
                for line in r:
                    ev = json.loads(line)
                    if "token" in ev:
                        streams[i].append(ev["token"])
                    elif not ev.get("done") or ev["tokens"] != streams[i]:
                        raise RuntimeError(f"stream ended with {ev}")
        except Exception as e:      # noqa: BLE001 — recorded per stream
            errors[i] = e

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if any(t.is_alive() for t in threads):
        raise RuntimeError(f"{tag}: a stream did not end in 900 s")
    return streams, errors, time.perf_counter() - t0


def _http_get(url, path):
    """(status, body) of a GET; an HTTP error status is returned."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url + path, timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def drill(workdir=None, seed=0, init_range=INIT_RANGE, device=None,
          tiny=False, dtype=None, prompts=None, max_new=None):
    """Run the drill; returns a dict of results with `findings` (empty
    when clean). `device=None` is the card; `tiny` swaps in the
    rehearsal model; `dtype` is the engines' compute dtype (None: bf16
    on the card, the model's f32 on the CPU); `prompts` default to the serve prompts (greedy,
    `max_new` new tokens each)."""
    import torch

    from ..device import resolve_device
    from ..telemetry.ledger_check import check_records
    from ..telemetry.sink import JsonlSink
    from .http import FleetHTTPServer
    from .replica import HTTPReplica
    from .router import FleetRouter

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    dtype = dtype or ("bfloat16" if on_card else "model")
    if on_card:
        from ..ops import _build
        from ..ops.kernel_registry import kernels
        _build.build(sorted({os.path.basename(k.source)[:-3]
                             for k in kernels()}))
    workdir = workdir or tempfile.mkdtemp(prefix="fleet_drill_")
    os.makedirs(workdir, exist_ok=True)
    cfg = TINY_MODEL if tiny else {"vocab_size": 50304}
    if prompts is None:
        prompts = (serve_prompts(seed, cfg["vocab_size"], n=12,
                                 template_len=12, lo=8, hi=24) if tiny
                   else serve_prompts(seed, cfg["vocab_size"]))
    max_new = max_new or (16 if tiny else 32)
    block = (TINY_ENGINE if tiny else SERVE_ENGINE)["block_size"]
    child_args = ["--seed", str(seed), "--init-range", str(init_range),
                  "--device", str(dev.type), "--dtype", dtype] \
        + (["--tiny"] if tiny else [])
    findings = []
    res = {"workdir": workdir, "prompts": prompts, "max_new": max_new,
           "findings": findings}
    expected_device = torch.cuda.get_device_name(dev) if on_card else "cpu"
    greedy = [{"max_new_tokens": max_new} for _ in prompts]

    n_replicas = N_REPLICAS
    names = [f"r{i}" for i in range(n_replicas)] + ["solo"]
    next_id = [len(names)]
    procs = {n: ReplicaProcess(n, i, workdir, child_args)
             for i, n in enumerate(names)}
    incarnations = list(procs.values())
    t0 = time.perf_counter()
    ready = {n: p.wait_ready(READY_TIMEOUT_S) for n, p in procs.items()}
    res["spawn_s"] = time.perf_counter() - t0
    res["ready"] = ready
    sums = {r["weights_sha256"] for r in ready.values()}
    if len(sums) != 1:
        findings.append(f"replicas built different weights: {sums}")
    res["weights_sha256"] = sorted(sums)
    for n, r in ready.items():
        if r["device"] != expected_device:
            findings.append(f"{n} runs on {r['device']}, not "
                            f"{expected_device}")

    replicas = [HTTPReplica(n, procs[n].url, engine_id=procs[n].engine_id)
                for n in names[:n_replicas]]
    router_ledger = os.path.join(workdir, "router.jsonl")
    router_sink = JsonlSink(router_ledger)
    router = FleetRouter(replicas, block_size=block, probe_interval_s=0.2,
                         miss_threshold=2, breaker_cooldown_s=0.5,
                         failover_budget=4, sink=router_sink)
    solo_ledger = os.path.join(workdir, "router-solo.jsonl")
    solo_sink = JsonlSink(solo_ledger)
    solo_router = FleetRouter(
        [HTTPReplica("solo", procs["solo"].url,
                     engine_id=procs["solo"].engine_id)],
        block_size=block, probe_interval_s=0.2, sink=solo_sink)
    stop_probe = threading.Event()

    def prober():
        # the deployment's periodic prober (the router itself probes only
        # on the routing path): a silent SIGKILL becomes probe misses
        while not stop_probe.is_set():
            try:
                router.probe_all()
            except Exception:       # noqa: BLE001 — keep probing
                pass
            stop_probe.wait(0.1)

    probe_thread = threading.Thread(target=prober, daemon=True)
    probe_thread.start()
    front = FleetHTTPServer(router, port=0).start()
    exits = []
    try:
        # ---- rated waves: all replicas, then the solo one ----------------
        n_tok = len(prompts) * max_new
        for label, r in (("fleet", router), ("solo", solo_router)):
            best, last = None, None
            for w in range(2):
                streams, errors, wall = _wave(r, prompts, greedy,
                                              f"{label}{w}")
                bad = [i for i, e in enumerate(errors) if e is not None]
                if bad:
                    findings.append(f"{label} wave {w}: streams {bad} "
                                    f"failed: {errors[bad[0]]!r}")
                best = min(wall, best or wall)
                last = streams
            res[f"{label}_tokens_per_s"] = n_tok / best
            res[f"{label}_streams"] = last
        reference = res["fleet_streams"]
        res["scaling_efficiency"] = res["fleet_tokens_per_s"] / (
            n_replicas * res["solo_tokens_per_s"])

        # ---- chaos wave: SIGKILL mid-stream ------------------------------
        kill = {}

        def kill_first(streams):
            half = max_new // 2
            first = next(i for i, s in enumerate(streams) if len(s) >= half)
            with router._mu:
                routes = [e for e in router.events if e["event"] == "route"
                          and e.get("request_id") == f"chaos-{first}"]
            victim = routes[-1]["replica"]
            t_kill = time.monotonic()
            procs[victim].kill()            # returns once it is reaped
            t_exit = time.monotonic()
            # the streams go on in their threads; wait here for the
            # router's verdict
            while not router.replica_states()[victim]["dead"] and \
                    time.monotonic() - t_kill < 30:
                time.sleep(0.0005)
            t_dead = time.monotonic()
            kill.update(stream=first, victim=victim,
                        exit_ms=(t_exit - t_kill) * 1e3,
                        detect_ms=(t_dead - t_kill) * 1e3
                        if router.replica_states()[victim]["dead"]
                        else None)

        streams, errors, _ = _wave(router, prompts, greedy, "chaos",
                                   kill=kill_first)
        victim = kill["victim"]
        with router._mu:
            events = list(router.events)
        dead_rec = [e for e in events if e["event"] == "declared_dead"
                    and e["replica"] == victim]
        res.update(chaos_streams=streams, victim=victim,
                   killed_stream=kill["stream"], exit_ms=kill["exit_ms"],
                   detect_ms=kill["detect_ms"],
                   detect_s_record=dead_rec[0].get("detect_s")
                   if dead_rec else None)
        if kill["detect_ms"] is None:
            findings.append(f"the router never declared {victim} dead")
        for i, e in enumerate(errors):
            if e is not None:
                findings.append(f"chaos stream {i} raised "
                                f"{type(e).__name__}: {e}")
            elif len(streams[i]) != max_new:
                findings.append(f"chaos stream {i} ended after "
                                f"{len(streams[i])} tokens")
        spliced = [e for e in events if e["event"] == "replay_spliced"]
        res["spliced"] = [dict(request=e["request_id"],
                               before=e["streamed_before"],
                               after=e["streamed_after"],
                               n_tokens=e["n_tokens"]) for e in spliced]
        for e in spliced:
            i = int(e["request_id"].rsplit("-", 1)[1])
            b = e["streamed_before"]
            if e["streamed_before"] + e["streamed_after"] != e["n_tokens"]:
                findings.append(f"splice of {e['request_id']} does not "
                                "balance")
            if streams[i][:b] != reference[i][:b]:
                findings.append(f"{e['request_id']}: the {b} tokens "
                                "streamed before the kill differ from the "
                                "no-kill run")
        if not on_card:     # f32 on the CPU: the splice is exact
            for i, (got, ref) in enumerate(zip(streams, reference)):
                if errors[i] is None and got != ref:
                    findings.append(f"chaos stream {i} differs from the "
                                    "no-kill run")
        kinds = {e["event"] for e in events}
        for needed in ("declared_dead", "failover", "replay_spliced"):
            if needed not in kinds:
                findings.append(f"the kill left no {needed!r} record")

        # ---- respawn the victim under a new engine id --------------------
        def respawn(name):
            p = ReplicaProcess(name, next_id[0], workdir, child_args)
            next_id[0] += 1
            incarnations.append(p)
            rep = p.wait_ready(READY_TIMEOUT_S)
            if rep["weights_sha256"] not in sums or \
                    rep["device"] != expected_device:
                findings.append(f"respawned {name} (engine "
                                f"{p.engine_id}): {rep}")
            procs[name] = p
            r = next(x for x in replicas if x.name == name)
            r.url, r.engine_id = p.url, p.engine_id
            return p

        t0 = time.perf_counter()
        respawn(victim)
        router.readmit(victim)
        res["respawn_s"] = time.perf_counter() - t0

        # ---- rolling restart under feeder traffic ------------------------
        stop_feed = threading.Event()
        feed = []                   # (prompt index, knobs, tokens)
        feed_errors = []
        feed_mu = threading.Lock()

        def feeder(tid):
            k = 0
            while not stop_feed.is_set():
                i = (tid + N_FEEDERS * k) % len(prompts)
                knobs = {"max_new_tokens": max_new, **feeder_knobs(i)}
                k += 1
                try:
                    toks = router.generate(prompts[i], knobs,
                                           request_id=f"roll-{tid}-{k}")
                    with feed_mu:
                        feed.append((i, knobs, toks))
                    if len(toks) != max_new:
                        raise RuntimeError(f"{len(toks)} tokens")
                except Exception as e:  # noqa: BLE001 — zero allowed
                    with feed_mu:
                        feed_errors.append(f"roll-{tid}-{k}: "
                                           f"{type(e).__name__}: {e}")

        def restart_fn(replica):
            exits.append(procs[replica.name].terminate(600))
            respawn(replica.name)

        feeders = [threading.Thread(target=feeder, args=(t,))
                   for t in range(N_FEEDERS)]
        for t in feeders:
            t.start()
        t0 = time.perf_counter()
        restarted = router.rolling_restart(restart_fn=restart_fn)
        res["rolling_restart_s"] = time.perf_counter() - t0
        stop_feed.set()
        for t in feeders:
            t.join(timeout=900)
        if len(restarted) != n_replicas:
            findings.append(f"rolling restart restarted {restarted}, "
                            f"not all {n_replicas} replicas")
        findings += [f"rolling-restart request failed: {e}"
                     for e in feed_errors]
        if not feed:
            findings.append("no feeder request completed during the "
                            "rolling restart")
        res.update(restarted=restarted, feed=feed,
                   feed_failed=len(feed_errors))

        # ---- one more wave, through the fleet's HTTP front --------------
        streams, errors, _ = _http_wave(front.url, prompts, greedy, "final")
        res["final_streams"] = streams
        bad = [i for i, e in enumerate(errors) if e is not None]
        if bad:
            findings.append(f"final wave: streams {bad} failed: "
                            f"{errors[bad[0]]!r}")
        status, text = _http_get(front.url, "/metrics")
        for series in ("paddle_tpu_fleet_replicas_healthy",
                       "paddle_tpu_fleet_failovers",
                       "paddle_tpu_fleet_spliced"):
            if status != 200 or series not in text:
                findings.append(f"fleet /metrics ({status}) lacks {series}")
        status, body = _http_get(front.url, "/healthz")
        if status != 200 or sorted(json.loads(body)["routable"]) != \
                names[:n_replicas]:
            findings.append(f"fleet /healthz answered {status} {body}")
        status, body = _http_get(front.url, "/replicas")
        if status != 200 or sorted(json.loads(body)) != names[:n_replicas]:
            findings.append(f"fleet /replicas answered {status} {body}")
    finally:
        front.stop()
        stop_probe.set()
        probe_thread.join(timeout=10)
        # the current incarnations: the SIGKILLed one was replaced, so
        # every one must still be alive and exit cleanly on SIGTERM
        for p in procs.values():
            if not p.alive():
                findings.append(f"replica {p.name} (engine {p.engine_id}) "
                                f"died: exit {p.proc.returncode}")
                continue
            try:
                exits.append(p.terminate(600))
            except RuntimeError as e:
                findings.append(str(e))
        router.emit_quiesce()
        router_sink.close()
        solo_router.emit_quiesce()
        solo_sink.close()
        for p in incarnations:
            if p.alive():
                p.kill()

    # ---- the ledger ------------------------------------------------------
    res["exits"] = exits
    for rep in exits:
        if rep["device"] != expected_device:
            findings.append(f"engine {rep['engine_id']} exited on "
                            f"{rep['device']}")
        if on_card and not all(rep["launches"].get(k, 0) > 0
                               for k in SERVED_KERNELS):
            findings.append(f"engine {rep['engine_id']} launched "
                            f"{rep['launches']}")
    records = _concat_ledgers(
        [p.ledger for p in incarnations] + [router_ledger]
        + [solo_ledger],
        os.path.join(workdir, "combined.jsonl"))
    problems = check_records(records, "combined")
    res["ledger_records"] = len(records)
    res["ledger_problems"] = problems
    findings += [f"ledger: {p}" for p in problems]
    for kind in ("fleet", "serving", "memsnap"):
        if not any(r.get("kind") == kind for r in records):
            findings.append(f"the combined ledger has no kind={kind} "
                            "records")
    res["prefix_hit_rate"] = _fleet_prefix_hit_rate(records)
    return res


def _fleet_prefix_hit_rate(records):
    """Prefill tokens saved / offered over every engine's last quiesce
    record in the ledger (the fleet-wide prefix hit rate)."""
    last = {}
    for r in records:
        if r.get("kind") == "serving" and r.get("event") == "quiesce":
            last[r.get("engine")] = r
    saved = sum(r.get("prefill_tokens_saved", 0) for r in last.values())
    offered = sum(r.get("prefill_tokens_offered", 0) for r in last.values())
    return saved / offered if offered else 0.0


def _summary(res):
    out = {k: v for k, v in res.items()
           if k not in ("prompts", "fleet_streams", "solo_streams",
                        "chaos_streams", "final_streams", "feed", "ready",
                        "exits")}
    out["exits"] = [{k: r[k] for k in ("engine_id", "device", "launches")}
                    for r in res.get("exits", [])]
    out["feed_requests"] = len(res.get("feed", []))
    if res.get("ready"):
        out["devices"] = sorted({r["device"] for r in res["ready"].values()})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--serve", action="store_true",
                    help="run one replica process (what the drill spawns)")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--engine-id", type=int, default=0)
    ap.add_argument("--telemetry", default=None,
                    help="--serve: the replica's JSONL ledger; else the "
                         "drill's working directory")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--init-range", type=float, default=INIT_RANGE)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default: the card) or 'cpu'")
    ap.add_argument("--dtype", default=None,
                    help="the engines' compute dtype: 'bfloat16' or "
                         "'model' (the model's f32); default bf16 on the "
                         "card, f32 on the CPU")
    ap.add_argument("--tiny", action="store_true",
                    help="a 2-layer width-128 model (CPU rehearsal)")
    args = ap.parse_args(argv)
    if args.serve:
        return serve(args.port, args.engine_id, args.telemetry, args.seed,
                     args.init_range, args.device, args.tiny,
                     args.dtype or "bfloat16")
    res = drill(args.telemetry, seed=args.seed, init_range=args.init_range,
                device=args.device, tiny=args.tiny, dtype=args.dtype)
    print(json.dumps(_summary(res), default=repr))
    for f in res["findings"]:
        print(f"FAIL: {f}")
    print(f"fleet drill: {len(res['findings'])} finding(s) "
          f"(ledgers: {res['workdir']})")
    return EXIT_FINDINGS if res["findings"] else 0


if __name__ == "__main__":
    sys.exit(main())
