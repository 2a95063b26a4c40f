"""The fault-tolerance runtime — the port of paddle_tpu/resilience.

- `ckpt`    — CheckpointManager: atomic step checkpoints (tmp dir +
              manifest with per-file digests + fsync + one rename), one
              `torch.save` file a leaf piece with each rank writing its
              own pieces, keep-last-K/keep-every-N retention, at most one
              save in flight on one writer thread, restore that verifies
              and falls back past corrupt checkpoints; RunState (step,
              data position, each rank's RNG states).
- `retry`   — the failure classifier and with_retry/RetryPolicy:
              exponential backoff with full jitter, deadlines, shared
              budgets.
- `preempt` — PreemptionHandler (SIGTERM -> checkpoint at the next step
              boundary) and ResilienceManager, the `resilience=` hook of
              TrainStep, ShardedTrainStep and PipelineParallel: exit 102
              and auto-resume; `elastic=` polls a
              `distributed.elastic.ElasticCoordinator` at every step
              boundary (a declared-dead peer: replan, drain, exit 101).
- `chaos`   — seeded fault injection (transient I/O errors, slow
              writes, corrupt-a-shard-after-write); the in-process half
              of `tools/chaos_drill.py`.
- `reshard` — cross-layout restore: a checkpoint saved under one mesh
              and ZeRO stage restored under another, leaf by leaf; the
              elastic relaunch's `resume()` takes it (drilled by
              `tools/elastic_drill.py`).

`ckpt.*` counters and gauges land on the training `MetricsServer`'s
`/metrics`; every checkpoint event is a `kind=ckpt` record (and a
cross-layout restore a `kind=elastic` one) that
`telemetry.ledger_check` validates and the health detector's
`checkpoint_stall`/`checkpoint_failed` rules judge.
"""
from . import chaos  # noqa: F401
from . import ckpt  # noqa: F401
from . import preempt  # noqa: F401
from . import reshard  # noqa: F401
from . import retry  # noqa: F401
from .chaos import ChaosConfig, ChaosMonkey, corrupt_one_file
from .ckpt import (CheckpointCorruptError, CheckpointError,
                   CheckpointManager, RunState, build_manifest,
                   checkpoint_bytes, load_manifest, verify_checkpoint)
from .preempt import (RESUMABLE_EXIT_CODE, PreemptionHandler,
                      ResilienceManager, as_resilience)
from .reshard import (layout_from_mesh, layouts_differ, normalize_layout,
                      reshard_restore, stored_layout)
from .retry import (TRANSIENT_HTTP_STATUSES, HTTPStatusError, RetryBudget,
                    RetryError, RetryPolicy, classify_failure,
                    classify_http_status, is_transient, retry_after_hint,
                    retrying, tag_transient, with_retry)

__all__ = [
    "CheckpointManager", "RunState", "CheckpointError",
    "CheckpointCorruptError", "build_manifest", "load_manifest",
    "verify_checkpoint", "checkpoint_bytes",
    "RetryPolicy", "RetryBudget", "RetryError", "with_retry", "retrying",
    "is_transient", "classify_failure", "tag_transient",
    "classify_http_status", "retry_after_hint", "HTTPStatusError",
    "TRANSIENT_HTTP_STATUSES",
    "RESUMABLE_EXIT_CODE", "PreemptionHandler", "ResilienceManager",
    "as_resilience",
    "reshard_restore", "normalize_layout", "layout_from_mesh",
    "layouts_differ", "stored_layout",
    "ChaosConfig", "ChaosMonkey", "corrupt_one_file",
    "ckpt", "retry", "preempt", "chaos", "reshard",
]
