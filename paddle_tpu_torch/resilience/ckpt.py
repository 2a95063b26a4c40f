"""Step-granular checkpointing with an atomic commit protocol — the port
of paddle_tpu/resilience/ckpt.py.

**Atomic commit protocol** (JAX's). A save writes the leaves into
`step_N.tmp/arrays/`, then `run_state.json` (step, epoch, data
position, RNG — what bit-identical resume needs beyond arrays), then
`manifest.json` with per-leaf shapes, dtypes and byte sizes and a
per-file content digest of everything else in the directory. Files and
directories are fsync'd, then ONE `os.replace(step_N.tmp -> step_N)`
commits, then the `latest` marker is updated. A crash before the rename
leaves only a `.tmp` husk that restore ignores and GC reaps.

**The port's files.** One `torch.save` file a leaf piece,
`arrays/<dotted leaf name>/<rank>` (the JAX directory convention, so
`_leaf_for` names the leaf of a bad file). Each manifest leaf keeps
JAX's `shape`, `dtype` (numpy names: 'float32', 'bfloat16') and
`nbytes`, and adds `pieces`: for each file its rank, its mp/ep cut and
its flat element range under ZeRO (distributed/checkpoint.py).

**Ranks.** Every rank of a job calls `save` at the same step. Each
snapshots its pieces to host memory before `save` returns; one
background thread a manager (reused for its lifetime) then writes the
rank's files into `step_N.tmp/arrays/`, digests them as it writes (so
the sha256 time is spread over the ranks; the serializing, digesting,
writing and fsyncs of one rank's files run on a few helper threads) and
writes `ranks/<rank>.json`
(its files' digests, its leaf table and its RNG state) atomically:
that file is the rank's done marker. Rank 0's thread waits for every
rank's marker, writes `run_state.json` (the RNG a list indexed by rank)
and the manifest, renames and updates `latest`; the other ranks' threads
wait for the rename (or rank 0's `step_N.failed` marker). No thread
touches a process group: gloo groups are not safe across threads. The
main thread's `save` barriers over the job before the snapshot, so
every rank's previous save has committed first.

**At most one save in flight.** A new save drains (joins) the previous
one; the snapshot is host memory, so training may overwrite the
parameters while the thread writes.

**Restore-time integrity.** `verify_checkpoint` replays the manifest:
missing, truncated, or digest-mismatched files are reported with the
offending LEAF named. `CheckpointManager.restore()` walks newest ->
oldest past invalid checkpoints (counted as `ckpt.fallbacks`).

**Retention.** keep_last-K plus keep-every-N survivors; everything else
— including `.tmp` husks of crashed saves — is GC'd after each commit.

All I/O goes through `resilience.retry.with_retry` (transient storage
errors back off and retry, counted in `ckpt.retries`) and the chaos
injection points (`resilience.chaos.inject`: `save` at each piece
write, `commit` at rank 0's commit, `restore` at a load). The piece
writes run on helper threads, so which writes a seeded fault schedule
hits may change from run to run (JAX injects once a save).
"""
import base64
import hashlib
import io
import json
import os
import shutil
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import monitor
from . import chaos
from .retry import RetryPolicy, with_retry

__all__ = ["CheckpointManager", "RunState", "CheckpointError",
           "CheckpointCorruptError", "build_manifest", "load_manifest",
           "verify_checkpoint", "checkpoint_bytes"]

MANIFEST_NAME = "manifest.json"
RUN_STATE_NAME = "run_state.json"
ARRAYS_SUBDIR = "arrays"
RANKS_SUBDIR = "ranks"
LATEST_NAME = "latest"
MANIFEST_SCHEMA = 1
_STEP_PREFIX = "step_"
TMP_SUFFIX = ".tmp"
_FAILED_SUFFIX = ".failed"
_POLL_S = 0.02
# how long a rank waits for the others' pieces, or for rank 0's commit
_COMMIT_TIMEOUT_S = 600.0
_IO_THREADS = 8


class CheckpointError(RuntimeError):
    """A checkpoint operation failed permanently (retries exhausted or a
    non-transient error)."""


class CheckpointCorruptError(CheckpointError):
    """Integrity verification rejected a checkpoint. `problems` lists
    the findings, each naming the offending file (and leaf when the
    file maps to one)."""

    def __init__(self, path, problems):
        self.path = path
        self.problems = list(problems)
        super().__init__(
            f"checkpoint {path} failed integrity verification: "
            + "; ".join(self.problems[:4])
            + (f" (+{len(self.problems) - 4} more)"
               if len(self.problems) > 4 else ""))


def _rank_world():
    from ..distributed import env
    return env.get_rank(), env.get_world_size()


# ---------------------------------------------------------------------------
# run state: everything beyond arrays that bit-identical resume needs
# ---------------------------------------------------------------------------

def _b64(t):
    return base64.b64encode(t.numpy().tobytes()).decode("ascii")


def _unb64(s):
    return torch.frombuffer(bytearray(base64.b64decode(s)),
                            dtype=torch.uint8)


def rng_now():
    """This process's generator states: torch's CPU generator and, once
    CUDA is initialised, every CUDA device's (base64 strings)."""
    st = {"cpu": _b64(torch.get_rng_state())}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        st["cuda"] = [_b64(s) for s in torch.cuda.get_rng_state_all()]
    return st


def rng_set(st):
    torch.set_rng_state(_unb64(st["cpu"]))
    if st.get("cuda") and torch.cuda.is_available():
        torch.cuda.set_rng_state_all([_unb64(s) for s in st["cuda"]])


class RunState:
    """Training-position record saved inside every checkpoint.

    step           completed-steps count == next step index to run
    epoch          current epoch
    data_position  opaque loader cursor
    rng_state      the generators dropout and the user's draws read
                   (`rng_now`: torch's CPU generator and every CUDA
                   device's). JAX keeps one generator key; the port keeps
                   each rank's states, and a checkpoint of a job of
                   several ranks holds them as a list indexed by rank
    layout         parallelism layout the run was saved under (axis dict,
                   see resilience.reshard.normalize_layout)
    extra          user dict (JSON-serializable)
    """

    def __init__(self, step=0, epoch=0, data_position=None, rng_state=None,
                 extra=None, layout=None):
        self.step = int(step)
        self.epoch = int(epoch)
        self.data_position = data_position
        self.rng_state = rng_state
        self.layout = dict(layout) if layout else None
        self.extra = dict(extra or {})

    def capture_rng(self):
        """Record this process's live generator states."""
        self.rng_state = rng_now()
        return self

    def restore_rng(self, rank=None):
        """Re-seed the live generators from the captured states (a list
        is indexed by `rank`, default this process's, modulo its length:
        a job relaunched on more ranks reuses the saved ones); no-op when
        none was captured."""
        st = self.rng_state
        if st is None:
            return self
        if isinstance(st, list):
            if rank is None:
                rank = _rank_world()[0]
            st = st[rank % len(st)]
            self.rng_state = st
        rng_set(st)
        return self

    def snapshot(self):
        """Copy with the CURRENT rng state captured — what a save should
        persist (the live object keeps mutating afterwards)."""
        return RunState(step=self.step, epoch=self.epoch,
                        data_position=self.data_position,
                        extra=dict(self.extra),
                        layout=self.layout).capture_rng()

    def to_dict(self):
        d = {"schema": MANIFEST_SCHEMA, "step": self.step,
             "epoch": self.epoch, "data_position": self.data_position,
             "rng_state": self.rng_state, "extra": self.extra}
        if self.layout:
            d["layout"] = self.layout
        return d

    @classmethod
    def from_dict(cls, d):
        return cls(step=d.get("step", 0), epoch=d.get("epoch", 0),
                   data_position=d.get("data_position"),
                   rng_state=d.get("rng_state"),
                   extra=d.get("extra"),
                   layout=d.get("layout"))

    def __repr__(self):
        return (f"RunState(step={self.step}, epoch={self.epoch}, "
                f"data_position={self.data_position!r})")


# ---------------------------------------------------------------------------
# durability + manifest primitives
# ---------------------------------------------------------------------------

def _fsync_file(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path):
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:          # pragma: no cover - non-POSIX fallback
        return
    try:
        os.fsync(fd)
    except OSError:          # pragma: no cover - some FSes refuse dir fsync
        pass
    finally:
        os.close(fd)


def _atomic_write_json(path, obj):
    """tmp-write + fsync + rename + dir fsync: the file is either absent
    or complete, never half-written."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))


def _sha256(path, chunk=1 << 20):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def _walk_files(root):
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for name in sorted(filenames):
            yield os.path.join(dirpath, name)


def build_manifest(ckpt_dir, leaves=None, step=None, digest="sha256",
                   known=None):
    """Manifest dict over every file currently in `ckpt_dir` (except the
    manifest itself): relative path -> {size, sha256}. `leaves` is the
    per-leaf metadata captured at save time; `known` holds entries the
    files' writers already digested (each rank its own pieces)."""
    files = {}
    known = known or {}
    for path in _walk_files(ckpt_dir):
        rel = os.path.relpath(path, ckpt_dir).replace(os.sep, "/")
        if rel == MANIFEST_NAME:
            continue
        if rel in known:
            files[rel] = dict(known[rel])
            continue
        entry = {"size": os.path.getsize(path)}
        if digest == "sha256":
            entry["sha256"] = _sha256(path)
        files[rel] = entry
    return {"schema": MANIFEST_SCHEMA, "kind": "ckpt_manifest",
            "step": step, "time_unix": time.time(), "digest": digest,
            "leaves": leaves or {}, "files": files}


def load_manifest(ckpt_dir):
    with open(os.path.join(ckpt_dir, MANIFEST_NAME)) as f:
        return json.load(f)


def _leaf_for(rel, leaf_names):
    """Map a manifest file path to the leaf whose piece it holds: each
    leaf's files sit in a directory named by its dotted name
    (`arrays/model.fc.weight/0`); longest-prefix match handles leaf
    names that are themselves dotted."""
    if not rel.startswith(ARRAYS_SUBDIR + "/"):
        return None
    sub = rel[len(ARRAYS_SUBDIR) + 1:]
    best = None
    for name in leaf_names:
        if (sub == name or sub.startswith(name + "/")) and \
                (best is None or len(name) > len(best)):
            best = name
    return best


def verify_checkpoint(ckpt_dir, deep=True, part=None):
    """Integrity-check one committed checkpoint against its manifest.

    Returns a list of problem strings ([] == valid); each names the
    offending file, and the leaf it belongs to. `deep=False` skips
    content digests (size/presence only); `part=(k, n)` digests only
    every n-th file from the k-th (the ranks of a job split the work,
    `CheckpointManager.restore`)."""
    problems = []
    if not os.path.isdir(ckpt_dir):
        return [f"{ckpt_dir}: not a directory"]
    mpath = os.path.join(ckpt_dir, MANIFEST_NAME)
    if not os.path.exists(mpath):
        return [f"{MANIFEST_NAME} missing — checkpoint was never "
                "committed (or predates the manifest protocol)"]
    try:
        manifest = load_manifest(ckpt_dir)
    except (OSError, ValueError) as e:
        return [f"{MANIFEST_NAME} unreadable: {e}"]
    files = manifest.get("files")
    if not isinstance(files, dict) or not files:
        return [f"{MANIFEST_NAME} carries no file table"]
    leaf_names = list((manifest.get("leaves") or {}).keys())
    use_digest = deep and manifest.get("digest") == "sha256"
    for i, rel in enumerate(sorted(files)):
        meta = files[rel]
        path = os.path.join(ckpt_dir, *rel.split("/"))
        leaf = _leaf_for(rel, leaf_names)
        tag = f" (leaf {leaf})" if leaf else ""
        if not os.path.exists(path):
            problems.append(f"{rel}: missing{tag}")
            continue
        size = os.path.getsize(path)
        if size != meta.get("size"):
            problems.append(
                f"{rel}: truncated or resized — {size} bytes on disk vs "
                f"{meta.get('size')} in manifest{tag}")
            continue
        if use_digest and meta.get("sha256") and (
                part is None or i % part[1] == part[0]):
            actual = _sha256(path)
            if actual != meta["sha256"]:
                problems.append(
                    f"{rel}: content digest mismatch — shard bytes were "
                    f"corrupted after write{tag}")
    return problems


def checkpoint_bytes(manifest):
    """Total payload bytes a manifest accounts for."""
    return sum(int(e.get("size", 0))
               for e in (manifest.get("files") or {}).values())


# ---------------------------------------------------------------------------
# one save: snapshot (main thread), then write + commit (any thread)
# ---------------------------------------------------------------------------

def snapshot(places):
    """[(place, host copy of its piece or None)]: the pieces this rank
    writes (`place.get()`, the `save_flat` elements), copied to host
    memory (a CUDA device is synchronised first, so offloaded states
    copied back on a side stream are complete)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    out = []
    for pl in places:
        flat = pl.save_flat
        if not pl.writes or (flat is not None and flat[0] == flat[1]):
            out.append((pl, None))
            continue
        v = pl.get()
        if pl.scalar:
            v = torch.from_numpy(np.array(v))
        else:
            v = v.detach().to("cpu", copy=True).contiguous()
        out.append((pl, v))
    return out


class SaveJob:
    """One checkpoint of this rank's snapshot into `final` (through
    `tmp`): `prepare()` on the main thread of every rank, then `run()`
    on any thread (see the module docstring). `io(fn, label)` runs each
    I/O operation (the manager's retry loop); `on_commit(manifest)` runs
    on rank 0 after the rename."""

    def __init__(self, final, tmp, snap, run_state, step, rank=None,
                 world=None, digest="sha256", io=None, on_commit=None):
        r, w = _rank_world()
        self.final, self.tmp = final, tmp
        self.snap, self.run_state, self.step = snap, run_state, step
        self.rank = r if rank is None else int(rank)
        self.world = w if world is None else int(world)
        self.digest = digest
        self.io = io or (lambda fn, label: fn())
        self.on_commit = on_commit
        self.timeout_s = _COMMIT_TIMEOUT_S
        self.failed_op = "save"
        self.nbytes = sum(v.numel() * v.element_size()
                          for _, v in snap if v is not None)

    @property
    def _failed_marker(self):
        return self.final + _FAILED_SUFFIX

    def prepare(self):
        """Clear a stale husk of this step (rank 0), then meet every rank
        (a barrier over the job), so no rank writes into a directory rank
        0 is still clearing."""
        if self.rank == 0:
            shutil.rmtree(self.tmp, ignore_errors=True)
            if os.path.exists(self._failed_marker):
                os.remove(self._failed_marker)
            os.makedirs(os.path.join(self.tmp, RANKS_SUBDIR), exist_ok=True)
        if self.world > 1:
            import torch.distributed as dist
            dist.barrier()

    def run(self):
        try:
            files, leaves = self._write_pieces()
            rec = {"rank": self.rank, "files": files, "leaves": leaves,
                   "rng_state": self.run_state.rng_state}
            _atomic_write_json(self._rank_path(self.rank), rec)
        except BaseException:
            self._fail_marker()
            raise
        if self.rank != 0:
            return self._await_commit()
        self.failed_op = "commit"
        try:
            recs = self._await_ranks(rec)
            manifest = self.io(lambda: self._commit(recs),
                               f"ckpt.commit(step={self.step})")
        except BaseException:
            self._fail_marker()
            shutil.rmtree(self.tmp, ignore_errors=True)
            raise
        if self.on_commit is not None:
            self.on_commit(manifest)
        return manifest

    # -- rank side -----------------------------------------------------------
    def _rank_path(self, rank, suffix=".json"):
        return os.path.join(self.tmp, RANKS_SUBDIR, f"{rank}{suffix}")

    def _fail_marker(self):
        path = self._failed_marker if self.rank == 0 else \
            self._rank_path(self.rank, _FAILED_SUFFIX)
        try:
            with open(path, "w") as f:
                f.write("failed")
        except OSError:
            pass

    def _write_pieces(self):
        """Serialize, digest and write this rank's pieces (on a few
        helper threads: the sha256, the copies and the writes release
        the GIL), then fsync them together (one fsync at a time waits on
        the device for each file)."""
        files, leaves, jobs = {}, {}, []
        with ThreadPoolExecutor(_IO_THREADS) as pool:
            for pl, v in self.snap:
                leaf = pl.meta()
                leaf["pieces"] = []
                if v is not None:
                    rel = f"{ARRAYS_SUBDIR}/{pl.name}/{self.rank}"
                    pc = pl.piece_meta(self.rank)
                    pc["file"] = rel
                    leaf["pieces"] = [pc]
                    jobs.append((rel, pool.submit(
                        self.io, lambda rel=rel, v=v: self._write(rel, v),
                        f"ckpt.save({rel})")))
                leaves[pl.name] = leaf
            for rel, fut in jobs:
                files[rel] = fut.result()
            list(pool.map(_fsync_file,
                          [os.path.join(self.tmp, *rel.split("/"))
                           for rel, _ in jobs]))
        return files, leaves

    def _write(self, rel, v):
        chaos.inject("save")
        buf = io.BytesIO()
        torch.save(v, buf)
        data = buf.getbuffer()
        path = os.path.join(self.tmp, *rel.split("/"))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
        entry = {"size": len(data)}
        if self.digest == "sha256":
            entry["sha256"] = hashlib.sha256(data).hexdigest()
        return entry

    def _await_commit(self):
        """A rank other than 0: wait until rank 0 renamed the directory
        (or failed)."""
        t0 = time.monotonic()
        while True:
            if os.path.exists(self._failed_marker):
                raise CheckpointError(
                    f"checkpoint at step {self.step}: rank 0 failed the "
                    "commit")
            if not os.path.exists(self.tmp):
                return None
            if time.monotonic() - t0 > self.timeout_s:
                raise CheckpointError(
                    f"checkpoint at step {self.step}: no commit after "
                    f"{self.timeout_s:.0f}s")
            time.sleep(_POLL_S)

    # -- rank 0 --------------------------------------------------------------
    def _await_ranks(self, own):
        recs = {0: own}
        t0 = time.monotonic()
        while len(recs) < self.world:
            for r in range(1, self.world):
                if r in recs:
                    continue
                if os.path.exists(self._rank_path(r, _FAILED_SUFFIX)):
                    raise CheckpointError(
                        f"checkpoint at step {self.step}: rank {r} failed "
                        "to write its pieces")
                path = self._rank_path(r)
                if os.path.exists(path):
                    with open(path) as f:
                        recs[r] = json.load(f)
            if len(recs) < self.world:
                if time.monotonic() - t0 > self.timeout_s:
                    raise CheckpointError(
                        f"checkpoint at step {self.step}: ranks "
                        f"{sorted(set(range(self.world)) - set(recs))} "
                        f"wrote nothing in {self.timeout_s:.0f}s")
                time.sleep(_POLL_S)
        return [recs[r] for r in range(self.world)]

    def _commit(self, recs):
        chaos.inject("commit")
        tmp, final = self.tmp, self.final
        rs = self.run_state.to_dict()
        if self.world > 1:
            rs["rng_state"] = [r["rng_state"] for r in recs]
        _atomic_write_json(os.path.join(tmp, RUN_STATE_NAME), rs)
        leaves, known = {}, {}
        for r in recs:
            known.update(r["files"])
            for name, leaf in r["leaves"].items():
                have = leaves.get(name)
                if have is None:
                    leaves[name] = dict(leaf, pieces=list(leaf["pieces"]))
                else:
                    have["pieces"] += leaf["pieces"]
        manifest = build_manifest(tmp, leaves=leaves, step=self.step,
                                  digest=self.digest, known=known)
        _atomic_write_json(os.path.join(tmp, MANIFEST_NAME), manifest)
        for dirpath, _, _ in os.walk(tmp):
            _fsync_dir(dirpath)
        # a restart that replayed this step supersedes the committed
        # copy only NOW: move it aside (the suffix puts a crash leftover
        # under husk GC), land the new one, then reap
        aside = None
        if os.path.exists(final):
            aside = final + ".superseded" + TMP_SUFFIX
            if os.path.exists(aside):
                shutil.rmtree(aside, ignore_errors=True)
            os.replace(final, aside)
        os.replace(tmp, final)
        _fsync_dir(os.path.dirname(final))
        if aside is not None:
            shutil.rmtree(aside, ignore_errors=True)
        return manifest


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------

class CheckpointManager:
    """Atomic, retrying, self-verifying step-checkpoint store.

        mgr = CheckpointManager(dir, model, optimizer, keep_last=3)
        mgr.save(step, run_state=rs)     # async; the previous save
                                         # drains first
        rs = mgr.restore()               # newest VALID checkpoint

    keep_last    committed checkpoints retained (>=1)
    keep_every   additionally keep every N-th step forever (None: off)
    async_save   write and commit on the manager's thread (one, reused)
                 vs before `save` returns
    retry        RetryPolicy for every I/O op (default: 4 attempts,
                 0.5s..30s full-jitter backoff)
    rank         this process's rank (default: the process group's)
    digest       'sha256' (default) or 'none' (size-only manifests)
    health       optional telemetry.HealthMonitor — every emitted
                 kind=ckpt record is also judged by its AnomalyDetector
    sink         optional JsonlSink or path for kind=ckpt records; when
                 absent, records ride the context-active recorder's sink
    """

    def __init__(self, directory, model=None, optimizer=None, keep_last=3,
                 keep_every=None, async_save=True, retry=None, rank=None,
                 digest="sha256", health=None, sink=None):
        self.dir = os.path.abspath(directory)
        os.makedirs(self.dir, exist_ok=True)
        self.model = model
        self.optimizer = optimizer
        if keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {keep_last}")
        self.keep_last = int(keep_last)
        self.keep_every = int(keep_every) if keep_every else None
        self.async_save = bool(async_save)
        self.retry = retry or RetryPolicy()
        r, self.world = _rank_world()
        self.rank = r if rank is None else int(rank)
        self.digest = digest
        self.health = health
        from ..telemetry.sink import JsonlSink
        self._owns_sink = isinstance(sink, str)
        self.sink = JsonlSink(sink) if self._owns_sink else sink
        self.records = []
        self._writer = None
        self._pending = None      # (step, SaveJob, future, t0)
        self.last_snapshot_ms = None
        self.last_save_ms = None
        self.last_restore_ms = None
        if self.rank == 0:
            self._gc_husks()

    # -- naming -------------------------------------------------------------
    def step_dir(self, step):
        return os.path.join(self.dir, f"{_STEP_PREFIX}{int(step)}")

    def _tmp_dir(self, step):
        return self.step_dir(step) + TMP_SUFFIX

    def steps(self):
        """Committed (manifest-bearing) step numbers, ascending."""
        out = []
        try:
            names = os.listdir(self.dir)
        except OSError:
            return out
        for name in names:
            if not name.startswith(_STEP_PREFIX) or "." in name:
                continue
            try:
                step = int(name[len(_STEP_PREFIX):])
            except ValueError:
                continue
            if os.path.exists(os.path.join(self.dir, name, MANIFEST_NAME)):
                out.append(step)
        return sorted(out)

    def latest_step(self):
        """Newest committed step. The directory scan is authoritative:
        the rename, not the `latest` marker, is the commit point."""
        steps = self.steps()
        return steps[-1] if steps else None

    # -- the writer thread (ONE for the manager's lifetime) -----------------
    def _executor(self):
        if self._writer is None:
            self._writer = ThreadPoolExecutor(
                1, thread_name_prefix=f"ckpt_rank{self.rank}")
        return self._writer

    def _on_retry(self, attempt, exc, delay):
        monitor.incr("ckpt.retries")
        warnings.warn(
            f"[ckpt] transient I/O error (attempt {attempt}): "
            f"{type(exc).__name__}: {exc}; retrying in {delay:.2f}s",
            RuntimeWarning, stacklevel=4)

    def _io(self, fn, label):
        return with_retry(fn, policy=self.retry, on_retry=self._on_retry,
                          label=label)

    # -- save / commit ------------------------------------------------------
    def save(self, step, run_state=None, block=False):
        """Checkpoint the model (+optimizer) at `step`: drain the
        previous save, copy this rank's pieces to host memory, hand them
        to the writer thread and return. `block=True` (or
        async_save=False) commits before returning."""
        if self.model is None:
            raise CheckpointError("CheckpointManager has no model attached")
        self.drain()
        step = int(step)
        t0 = time.perf_counter()
        from ..distributed.checkpoint import state_leaves
        if run_state is None:
            run_state = RunState(step=step).capture_rng()
        elif run_state.rng_state is None or \
                isinstance(run_state.rng_state, list):
            run_state = run_state.snapshot()
        snap = snapshot(state_leaves(self.model, self.optimizer))
        job = SaveJob(self.step_dir(step), self._tmp_dir(step), snap,
                      run_state, step, rank=self.rank, world=self.world,
                      digest=self.digest, io=self._io,
                      on_commit=lambda m, s=step, t=t0: self._committed(
                          s, m, t))
        job.prepare()
        self.last_snapshot_ms = (time.perf_counter() - t0) * 1000.0
        fut = self._executor().submit(job.run)
        self._pending = (step, job, fut, t0)
        monitor.incr("ckpt.saves")
        self._emit("save", step, bytes=job.nbytes,
                   snapshot_ms=round(self.last_snapshot_ms, 4))
        if block or not self.async_save:
            self.drain()
        return self

    def drain(self):
        """Wait out the in-flight save (every rank's pieces written,
        committed by rank 0). A crash before that loses only the
        uncommitted step — never a committed one."""
        if self._pending is None:
            return
        step, job, fut, t0 = self._pending
        self._pending = None
        try:
            fut.result()
        except Exception as e:
            self._failed(step, job.failed_op, e)
            raise (e if isinstance(e, CheckpointError) else
                   CheckpointError(f"checkpoint {job.failed_op} at step "
                                   f"{step} failed: {e}")) from e
        self.last_save_ms = (time.perf_counter() - t0) * 1000.0

    def _committed(self, step, manifest, t0):
        """Rank 0, after the rename (on the writer thread)."""
        self._write_latest(step)
        save_ms = (time.perf_counter() - t0) * 1000.0
        nbytes = checkpoint_bytes(manifest)
        monitor.incr("ckpt.commits")
        monitor.set_gauge("ckpt.save_ms", save_ms)
        monitor.set_gauge("ckpt.bytes", float(nbytes))
        monitor.set_gauge("ckpt.last_step", float(step))
        self._emit("commit", step, save_ms=save_ms, bytes=nbytes)
        self._gc()

    def _write_latest(self, step):
        path = os.path.join(self.dir, LATEST_NAME)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(int(step)))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(self.dir)

    def _failed(self, step, op, exc):
        monitor.incr("ckpt.failures")
        self._emit("failed", step, op=op,
                   error=f"{type(exc).__name__}: {exc}")

    # -- retention ----------------------------------------------------------
    def _gc(self):
        steps = self.steps()
        keep = set(steps[-self.keep_last:])
        if self.keep_every:
            keep.update(s for s in steps if s % self.keep_every == 0)
        removed = 0
        for s in steps:
            if s not in keep:
                shutil.rmtree(self.step_dir(s), ignore_errors=True)
                removed += 1
        removed += self._gc_husks()
        if removed:
            monitor.incr("ckpt.gc_removed", removed)
            self._emit("gc", steps[-1] if steps else 0, removed=removed)
        return removed

    def _gc_husks(self):
        """Reap uncommitted `.tmp` husks and `.failed` markers of crashed
        or failed saves, sparing the save in flight."""
        live = self._pending[1] if self._pending is not None else None
        spare = (live.tmp, live.final + _FAILED_SUFFIX) if live else ()
        removed = 0
        try:
            names = os.listdir(self.dir)
        except OSError:
            return 0
        for name in names:
            path = os.path.join(self.dir, name)
            if not name.startswith(_STEP_PREFIX) or path in spare:
                continue
            if name.endswith(TMP_SUFFIX) and os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)
                removed += 1
            elif name.endswith(_FAILED_SUFFIX):
                try:
                    os.remove(path)
                except OSError:
                    pass
        return removed

    # -- verify / restore ---------------------------------------------------
    def verify(self, step, deep=True):
        return verify_checkpoint(self.step_dir(step), deep=deep)

    def _verify_together(self, step):
        """`verify(step)` with the digests split over the job's ranks
        (each reads 1/world of the files; the problems are exchanged),
        where every rank restores together."""
        if self.world == 1:
            return self.verify(step)
        import torch.distributed as dist
        mine = verify_checkpoint(self.step_dir(step),
                                 part=(self.rank, self.world))
        every = [None] * self.world
        dist.all_gather_object(every, mine)
        seen, out = set(), []
        for p in sorted(q for ps in every for q in ps):
            if p not in seen:
                seen.add(p)
                out.append(p)
        return out

    def restore(self, step=None, model=None, optimizer=None, loader=None):
        """Restore model(+optimizer+RNG) in place; returns the RunState.

        step=None: newest VALID checkpoint — invalid ones are skipped
        with a warning and counted as `ckpt.fallbacks`; returns None when
        no checkpoint exists; raises CheckpointCorruptError when
        checkpoints exist but none verifies. step=N: that exact
        checkpoint; corruption raises.

        `loader(arrays_path, model, optimizer)` overrides the array
        restore (default `distributed.checkpoint.load_checkpoint`) while
        keeping this method's verification, fallback, retry and
        telemetry — the hook `resilience.reshard` routes through.
        """
        self.drain()
        model = model if model is not None else self.model
        optimizer = optimizer if optimizer is not None else self.optimizer
        if model is None:
            raise CheckpointError("restore needs a model")
        if step is not None:
            problems = self._verify_together(step)
            if problems:
                raise CheckpointCorruptError(self.step_dir(step), problems)
            return self._restore_one(int(step), model, optimizer,
                                     loader=loader)
        steps = self.steps()
        if not steps:
            return None
        last_problems = None
        for s in sorted(steps, reverse=True):
            problems = self._verify_together(s)
            if problems:
                last_problems = (s, problems)
                monitor.incr("ckpt.fallbacks")
                self._emit("fallback", s, problems=problems[:8])
                warnings.warn(
                    f"[ckpt] checkpoint step {s} failed verification "
                    f"({problems[0]}" +
                    (f"; +{len(problems) - 1} more" if len(problems) > 1
                     else "") + "); falling back to an older checkpoint",
                    RuntimeWarning, stacklevel=2)
                continue
            return self._restore_one(s, model, optimizer, loader=loader)
        raise CheckpointCorruptError(
            self.step_dir(last_problems[0]), last_problems[1])

    def _restore_one(self, step, model, optimizer, loader=None):
        from ..distributed.checkpoint import load_checkpoint
        if loader is None:
            loader = load_checkpoint
        path = os.path.join(self.step_dir(step), ARRAYS_SUBDIR)
        t0 = time.perf_counter()

        def _load():
            chaos.inject("restore")
            return loader(path, model, optimizer)

        try:
            self._io(_load, f"ckpt.restore(step={step})")
        except Exception as e:
            self._failed(step, "restore", e)
            raise (e if isinstance(e, CheckpointError) else
                   CheckpointError(f"checkpoint restore at step {step} "
                                   f"failed: {e}")) from e
        rs_path = os.path.join(self.step_dir(step), RUN_STATE_NAME)
        run_state = RunState(step=step)
        if os.path.exists(rs_path):
            with open(rs_path) as f:
                run_state = RunState.from_dict(json.load(f))
        run_state.restore_rng(self.rank)
        self.last_restore_ms = (time.perf_counter() - t0) * 1000.0
        monitor.incr("ckpt.restores")
        monitor.set_gauge("ckpt.restore_ms", self.last_restore_ms)
        self._emit("restore", step)
        return run_state

    # -- record plumbing ----------------------------------------------------
    def _emit(self, event, step, **fields):
        from ..telemetry.sink import emit_record, make_ckpt_record
        rec = make_ckpt_record(event=event, step=step, rank=self.rank,
                               **fields)
        self.records.append(rec)
        emit_record(rec, self.sink)
        if self.health is not None:
            self.health.observe_record(rec)
        return rec

    # -- lifecycle ----------------------------------------------------------
    def close(self):
        """Drain and stop the writer thread."""
        try:
            self.drain()
        finally:
            if self._writer is not None:
                self._writer.shutdown(wait=True)
                self._writer = None
            if self.sink is not None and self._owns_sink:
                self.sink.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
