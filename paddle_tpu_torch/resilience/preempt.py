"""Preemption-aware graceful shutdown and the `resilience=` train hook —
the port of paddle_tpu/resilience/preempt.py.

- `PreemptionHandler` turns SIGTERM into an ARMED FLAG, not an
  exception: the signal may land inside a kernel launch or a
  collective, so all real work waits for the next step boundary on the
  main thread.
- Train steps wired with `resilience=` (jit.TrainStep,
  ShardedTrainStep, `PipelineParallel.resilience`) call
  `ResilienceManager.step_boundary()` after each step: periodic saves,
  and on an armed request a drained in-flight save, a final synchronous
  checkpoint, a black-box dump (telemetry.watchdog) and
  `SystemExit(RESUMABLE_EXIT_CODE)` — a code a launcher tells from a
  crash.
- With ranks (a process group of several), the flag is all-reduced (a
  MAX over the world) at every boundary, so every rank saves and exits
  at the same step when one rank alone received SIGTERM. The JAX
  package's single controller needs no such exchange. The all-reduce
  waits through `collective.guarded_wait`: under an armed
  `collective_deadline` a dead peer raises CollectiveTimeoutError, which
  `distributed.elastic.elastic_run` turns into exit 101.
- `elastic=` (a `distributed.elastic.ElasticCoordinator`) is wired both
  ways: `step_boundary` polls the coordinator after advancing the step
  and before the preemption check, and on a membership change the
  coordinator drains a final checkpoint through `graceful_shutdown`
  with ELASTIC_EXIT_CODE (101).
- `resume()` restores the newest valid checkpoint, through the reshard
  path when the stored layout differs from the live one
  (`resumed_via` "reshard" or "direct").
"""
import signal
import threading
import time
import warnings

import torch

from .. import monitor
from .ckpt import CheckpointManager, RunState

__all__ = ["RESUMABLE_EXIT_CODE", "PreemptionHandler", "ResilienceManager",
           "as_resilience"]

# exit-code protocol: 101 (distributed.launch.ELASTIC_EXIT_CODE) =
# relaunch with a new world; 102 = graceful preemption exit, state
# committed, relaunch and auto-resume from the checkpoint
RESUMABLE_EXIT_CODE = 102


class PreemptionHandler:
    """Arm a 'checkpoint at the next step boundary' request on SIGTERM.

    The signal handler only sets a flag; `request()` arms it without a
    signal (tests, drills, cooperative shutdown). install()/uninstall()
    save and restore the previous handlers; install from a thread other
    than the main one warns and only `request()` arms."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self.signals = tuple(signals)
        self._prev = {}
        self._requested = None     # (signal number or None, monotonic ts)
        self.installed = False

    def _on_signal(self, signum, frame):
        self._requested = (signum, time.monotonic())
        monitor.incr("ckpt.preempt_signals")

    def install(self):
        if self.installed:
            return self
        if threading.current_thread() is not threading.main_thread():
            warnings.warn(
                "PreemptionHandler.install() outside the main thread: "
                "signal handlers cannot be set; only request() will arm",
                RuntimeWarning, stacklevel=2)
            return self
        for sig in self.signals:
            self._prev[sig] = signal.signal(sig, self._on_signal)
        self.installed = True
        return self

    def uninstall(self):
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):     # non-main thread / teardown
                pass
        self._prev.clear()
        self.installed = False

    def request(self, signum=None):
        """Arm the shutdown request without a real signal."""
        self._requested = (signum, time.monotonic())
        return self

    @property
    def requested(self):
        return self._requested is not None

    @property
    def signal_name(self):
        if self._requested is None:
            return None
        signum = self._requested[0]
        if signum is None:
            return "request()"
        try:
            return signal.Signals(signum).name
        except ValueError:
            return str(signum)


def _world():
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def _any_rank(flag):
    """MAX of `flag` over the job's ranks (the default process group),
    waited for under the armed collective deadline, if any."""
    import torch.distributed as dist
    from ..distributed import env
    from ..distributed.collective import guarded_wait
    dev = env.current_device() if env.backend() == "nccl" \
        else torch.device("cpu")
    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=dev)
    work = dist.all_reduce(t, op=dist.ReduceOp.MAX, async_op=True)
    guarded_wait("all_reduce", work, shape=(1,))
    return bool(t.item())


class ResilienceManager:
    """The `resilience=` hook: periodic step checkpoints, preemption-aware
    graceful shutdown and auto-resume.

        res = ResilienceManager("/ckpts/job", save_every=100)
        step = TrainStep(model, loss_fn, opt, resilience=res)
        start = res.resume() or 0
        for i in range(start, total_steps):
            loss = step(*batch_at(i))    # step_boundary after each step

    save_every=0 disables periodic saves (preemption saves still
    happen). `manager=` shares a CheckpointManager; otherwise one is
    built over `checkpoint_dir`. `layout` is stamped into every
    checkpoint (a ShardedTrainStep sets its own when none is given).
    `elastic=` takes a `distributed.elastic.ElasticCoordinator`, wired
    both ways through its `attach` (it drains through this manager and
    shares its telemetry sink; `step_boundary` polls it).
    """

    def __init__(self, checkpoint_dir=None, manager=None, model=None,
                 optimizer=None, save_every=100, keep_last=3,
                 keep_every=None, async_save=True, retry=None,
                 preempt=True, exit_on_preempt=True,
                 exit_code=RESUMABLE_EXIT_CODE, dump_dir=None, health=None,
                 sink=None, rank=None, layout=None, elastic=None):
        if (checkpoint_dir is None) == (manager is None):
            raise ValueError("ResilienceManager: pass exactly one of "
                             "checkpoint_dir or manager")
        self.ckpt = manager if manager is not None else CheckpointManager(
            checkpoint_dir, model=model, optimizer=optimizer,
            keep_last=keep_last, keep_every=keep_every,
            async_save=async_save, retry=retry, rank=rank, health=health,
            sink=sink)
        self.save_every = int(save_every)
        self.exit_on_preempt = bool(exit_on_preempt)
        self.exit_code = int(exit_code)
        self.dump_dir = dump_dir if dump_dir is not None else self.ckpt.dir
        from .reshard import normalize_layout
        self.layout = normalize_layout(layout)
        self.elastic = None
        if elastic is not None:
            if hasattr(elastic, "attach"):
                elastic.attach(self)     # sets self.elastic = elastic
            else:
                self.elastic = elastic
        self.state = RunState(layout=self.layout)
        self.resumed_from = None
        self.resumed_via = None
        self.preempted_at = None
        self.last_loss = None
        self._shutdown_done = False
        if isinstance(preempt, PreemptionHandler):
            self.handler = preempt.install()
        elif preempt:
            self.handler = PreemptionHandler().install()
        else:
            self.handler = None

    # -- train-step wiring --------------------------------------------------
    def attach(self, model, optimizer=None, layout=None):
        """Late-bind the model/optimizer (the train step passes its own
        when the manager was built from a bare directory) and, when none
        was given, the step's layout."""
        if self.ckpt.model is None:
            self.ckpt.model = model
        if self.ckpt.optimizer is None and optimizer is not None:
            self.ckpt.optimizer = optimizer
        if self.layout is None and layout is not None:
            from .reshard import normalize_layout
            self.layout = normalize_layout(layout)
            self.state.layout = self.layout
        return self

    def note(self, epoch=None, data_position=None, **extra):
        """Update run-position fields carried by the next checkpoint."""
        if epoch is not None:
            self.state.epoch = int(epoch)
        if data_position is not None:
            self.state.data_position = data_position
        self.state.extra.update(extra)
        return self

    def step_boundary(self, loss=None):
        """Called by the wired train step after each COMPLETED step:
        advances the step count; polls the elastic coordinator (which
        may itself drain and exit with ELASTIC_EXIT_CODE on a membership
        change); on an armed preemption request (on any rank) commits a
        final checkpoint and exits resumable; otherwise saves on the
        periodic schedule. `last_loss` keeps `loss` (the step's, which a
        caller loses when the boundary exits)."""
        self.last_loss = loss
        self.state.step += 1
        if self.elastic is not None:
            self.elastic.step_boundary(self.state.step)
        asked = self.handler is not None and self.handler.requested
        if _world() > 1:
            asked = _any_rank(asked)
        if asked:
            self.graceful_shutdown()
            return
        if self.save_every and self.state.step % self.save_every == 0:
            self.ckpt.save(self.state.step,
                           run_state=self.state.snapshot())

    def graceful_shutdown(self, reason=None, exit_code=None):
        """Drain + final synchronous checkpoint + black-box dump + (by
        default) SystemExit. Idempotent — a second call exits without
        re-saving. `exit_code` overrides the configured code for this
        exit: the elastic coordinator drains through here with
        ELASTIC_EXIT_CODE (relaunch onto a new world) where a
        preemption exits RESUMABLE_EXIT_CODE (resume onto the same)."""
        code = int(exit_code) if exit_code is not None else self.exit_code
        if self._shutdown_done:
            if self.exit_on_preempt:
                raise SystemExit(code)
            return
        self._shutdown_done = True
        self.preempted_at = self.state.step
        sig = self.handler.signal_name if self.handler is not None and \
            self.handler.requested else None
        reason = reason or (f"preemption ({sig or 'requested'}): graceful "
                            f"shutdown at step {self.state.step}")
        monitor.incr("ckpt.preemptions")
        err = None
        try:
            self.ckpt.save(self.state.step,
                           run_state=self.state.snapshot(), block=True)
        except Exception as e:      # the dump must still happen
            err = e
        from ..telemetry.watchdog import dump_black_box
        dump_black_box(
            reason=reason, dump_dir=self.dump_dir,
            ring=list(self.ckpt.records[-16:]),
            extra={"ckpt_step": self.state.step,
                   "ckpt_dir": self.ckpt.dir,
                   "exit_code": code if self.exit_on_preempt else None,
                   "final_save_error": repr(err) if err else None})
        fields = {"signal": sig} if sig else {}
        self.ckpt._emit("preempt", self.state.step, **fields)
        self.close(uninstall=True)
        if err is not None:
            raise err
        if self.exit_on_preempt:
            raise SystemExit(code)

    # -- resume -------------------------------------------------------------
    def resume(self, model=None, optimizer=None, mesh=None, step=None):
        """Auto-resume: restore the newest valid checkpoint (if any; or
        exactly `step`) into the attached model/optimizer and the RNG,
        adopt its RunState, and return the step to continue FROM, or
        None when starting fresh.
        A checkpoint saved under a layout other than this run's routes
        through `resilience.reshard.reshard_restore`; `resumed_via`
        records which ("reshard" / "direct")."""
        if model is not None or optimizer is not None:
            self.attach(model, optimizer)
        from . import reshard
        from ..distributed import env
        if mesh is None:
            mesh = env.current_mesh()
        live = self.layout or reshard.layout_from_mesh(mesh)
        stored = reshard.stored_layout(self.ckpt, step)
        if stored is not None and live is not None and \
                reshard.layouts_differ(stored, live):
            rs = reshard.reshard_restore(
                self.ckpt.dir, step=step, target_layout=live, mesh=mesh,
                model=self.ckpt.model, optimizer=self.ckpt.optimizer,
                manager=self.ckpt, rank=self.ckpt.rank)
            self.resumed_via = "reshard"
        else:
            rs = self.ckpt.restore(step=step)
            self.resumed_via = "direct" if rs is not None else None
        if rs is None:
            return None
        self.state = rs
        # later checkpoints carry the LIVE layout: the reshard happened
        self.state.layout = live or rs.layout
        self.resumed_from = rs.step
        monitor.set_gauge("ckpt.resumed_step", float(rs.step))
        return rs.step

    # -- lifecycle ----------------------------------------------------------
    def close(self, uninstall=True):
        try:
            self.ckpt.close()
        finally:
            if uninstall and self.handler is not None:
                self.handler.uninstall()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def as_resilience(arg):
    """Normalize the `resilience=` argument of TrainStep /
    ShardedTrainStep / PipelineParallel: None/False -> None,
    ResilienceManager -> itself, CheckpointManager -> wrapped, str ->
    manager over that directory, dict -> kwargs."""
    if arg is None or arg is False:
        return None
    if isinstance(arg, ResilienceManager):
        return arg
    if isinstance(arg, CheckpointManager):
        return ResilienceManager(manager=arg)
    if isinstance(arg, str):
        return ResilienceManager(checkpoint_dir=arg)
    if isinstance(arg, dict):
        return ResilienceManager(**arg)
    raise TypeError(
        "resilience= expects a ResilienceManager, CheckpointManager, "
        f"checkpoint-dir string, or kwargs dict; got {type(arg).__name__}")
