"""Launcher — the port of paddle_tpu/distributed/launch.py (reference
`python -m paddle.distributed.launch`: `fleet/launch.py:386`,
start_local_trainers:464, watch_local_trainers:573).

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 4 \\
        --ranks-per-device 4 [--timeout 600] [-m] script_or_module [args...]

It starts one process a local rank under the env contract
(`PADDLE_TRAINERS_NUM`, `PADDLE_TRAINER_ID`, `PADDLE_TRAINER_ENDPOINTS`,
`PADDLE_MASTER`, `PADDLE_LOCAL_RANK`, `PADDLE_LOCAL_SIZE`, and the
rendezvous `PADDLE_DIST_INIT_METHOD`: the `--master` address as
tcp://, else a file store in a fresh temporary directory, which no two
jobs can share). `--ranks-per-device N` places N consecutive local ranks
on each card (`PADDLE_DEVICE_ID` = local rank // N), which
`env.init_distributed(backend="gloo")` takes; NCCL refuses that, and its
`init_distributed` raises. Each rank runs in a process group of its own;
when any rank fails, or the job outlives `--timeout`, the launcher kills
every rank's group (SIGTERM, then SIGKILL) and returns the failing
code (TIMEOUT_EXIT_CODE on a timeout). A one-process job
(`--nproc_per_node 1`, the default) still runs as a child.

The JAX launcher's elastic relaunch (exit codes 101/102) is not ported:
ROADMAP Queue 1 item 6 (elastic, launch restarts).
"""
import argparse
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

__all__ = ["start_local_trainers", "watch_local_trainers", "launch",
           "TIMEOUT_EXIT_CODE"]

# the launcher's own exit code when a job outlives its --timeout
TIMEOUT_EXIT_CODE = 75


def _parse_args(argv=None):
    p = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    p.add_argument("--nnodes", type=int,
                   default=int(os.environ.get("PADDLE_NNODES", "1")))
    p.add_argument("--node_rank", type=int, default=0)
    p.add_argument("--master", type=str,
                   default=os.environ.get("PADDLE_MASTER", ""),
                   help="host:port of the rendezvous (default: a file "
                        "store in a temporary directory)")
    p.add_argument("--nproc_per_node", type=int, default=1)
    p.add_argument("--ranks-per-device", "--ranks_per_device", type=int,
                   default=1, dest="ranks_per_device",
                   help="local ranks that share one card (gloo only)")
    p.add_argument("--devices", "--gpus", type=str, default="",
                   help="accepted for CLI parity; ranks take cards by "
                        "local rank (// --ranks-per-device)")
    p.add_argument("--timeout", type=float, default=None,
                   help="seconds before the whole job is killed")
    p.add_argument("--log_dir", type=str, default=None,
                   help="write each rank's output to <log_dir>/workerlog.N")
    p.add_argument("-m", "--module", action="store_true",
                   help="run the target as `python -m <module>`")
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def start_local_trainers(nproc, script, script_args, master=None,
                         base_env=None, ranks_per_device=1, module=False,
                         nnodes=1, node_rank=0, store_dir=None,
                         log_dir=None):
    """Spawn one process a local rank (reference start_local_trainers),
    each in its own process group. Without `master` the ranks meet at a
    file store in `store_dir` (made by the caller, removed by it). With
    `log_dir` each rank's stdout and stderr go to
    `<log_dir>/workerlog.<rank>`, as the reference names them."""
    world = nproc * nnodes
    if master:
        init = f"tcp://{master}"
    else:
        if store_dir is None:
            raise ValueError("start_local_trainers: give master= or "
                             "store_dir=")
        init = "file://" + os.path.join(store_dir, "store")
    procs = []
    for local in range(nproc):
        rank = node_rank * nproc + local
        env = dict(os.environ if base_env is None else base_env)
        env.update({
            "PADDLE_TRAINERS_NUM": str(world),
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_LOCAL_RANK": str(local),
            "PADDLE_LOCAL_SIZE": str(nproc),
            "PADDLE_MASTER": master or "",
            "PADDLE_TRAINER_ENDPOINTS": master or "",
            "PADDLE_DIST_INIT_METHOD": init,
            "PADDLE_DEVICE_ID": str(local // max(1, int(ranks_per_device))),
        })
        cmd = [sys.executable] + (["-m"] if module else []) + [script] \
            + list(script_args)
        out = None
        if log_dir is not None:
            out = open(os.path.join(log_dir, f"workerlog.{rank}"), "wb")
        try:
            procs.append(subprocess.Popen(
                cmd, env=env, start_new_session=True, stdout=out,
                stderr=subprocess.STDOUT if out is not None else None))
        finally:
            if out is not None:
                out.close()
    return procs


def _kill(procs, grace_s=5.0):
    for sig in (signal.SIGTERM, signal.SIGKILL):
        live = [p for p in procs if p.poll() is None]
        for p in live:
            try:
                os.killpg(p.pid, sig)
            except (ProcessLookupError, PermissionError):
                pass
        end = time.monotonic() + grace_s
        for p in live:
            try:
                p.wait(timeout=max(0.0, end - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
    for p in procs:
        try:
            p.wait(timeout=grace_s)
        except subprocess.TimeoutExpired:
            pass


def watch_local_trainers(procs, poll_interval=0.1, timeout=None):
    """Wait for every rank (reference watch_local_trainers). On a rank's
    non-zero exit, kill every rank and return that code; past `timeout`
    seconds kill every rank and return TIMEOUT_EXIT_CODE; 0 when all
    exit 0."""
    t0 = time.monotonic()
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [c for c in codes if c not in (None, 0)]
            if bad:
                _kill(procs)
                return bad[0]
            if all(c == 0 for c in codes):
                return 0
            if timeout is not None and time.monotonic() - t0 > timeout:
                _kill(procs)
                return TIMEOUT_EXIT_CODE
            time.sleep(poll_interval)
    except BaseException:
        _kill(procs)
        raise


def launch(argv=None):
    args = _parse_args(argv)
    store = None if args.master else tempfile.mkdtemp(prefix="paddle_launch_")
    try:
        procs = start_local_trainers(
            args.nproc_per_node, args.training_script,
            args.training_script_args, master=args.master or None,
            ranks_per_device=args.ranks_per_device, module=args.module,
            nnodes=args.nnodes, node_rank=args.node_rank, store_dir=store,
            log_dir=args.log_dir)
        return watch_local_trainers(procs, timeout=args.timeout)
    finally:
        if store is not None:
            shutil.rmtree(store, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(launch())
