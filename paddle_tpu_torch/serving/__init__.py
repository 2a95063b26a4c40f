"""paddle_tpu_torch.serving — continuous-batching LLM serving engine.

The port of paddle_tpu/serving: `kv_cache` (refcounted block pool,
prefix index, paged K/V arenas), `scheduler` (token-granular continuous
batching with chunked prefill and preemption by recompute),
`resilience` (deadlines, priorities, admission control, typed errors,
the warm-restart backoff), `engine` (`ServingEngine`: greedy and
sampled decoding with jax.random's draws, the background serve loop
with stop, drain and warm restart, `serving.*` metrics and request
traces, the memory observatory's ledger, headroom shed
(`MemoryPressureError`) and OOM postmortem) and `http`
(`ServingHTTPServer`, the stdlib HTTP front).

    engine = ServingEngine(model, max_slots=16).start()
    srv = ServingHTTPServer(engine, port=8000).start()
"""
from .engine import EngineConfig, ServingEngine
from .http import ServingHTTPServer
from .kv_cache import (NULL_BLOCK, BlockLeakError, BlockPool, PagedKVCache,
                       PrefixIndex, StaleIndexError)
from .resilience import (AdmissionController, Deadlines,
                         DeadlineExceededError, EngineDeadError,
                         EngineDrainingError, EngineStoppedError,
                         MemoryPressureError, QueueFullError,
                         RequestCancelledError, ServingError, ShedError)
from .scheduler import Request, RequestHandle, SamplingParams, Scheduler

__all__ = ["EngineConfig", "ServingEngine", "ServingHTTPServer",
           "NULL_BLOCK", "BlockLeakError", "BlockPool", "PagedKVCache",
           "PrefixIndex", "StaleIndexError", "AdmissionController",
           "Deadlines", "DeadlineExceededError", "EngineDeadError",
           "EngineDrainingError", "EngineStoppedError",
           "MemoryPressureError", "QueueFullError",
           "RequestCancelledError", "ServingError", "ShedError", "Request",
           "RequestHandle", "SamplingParams", "Scheduler"]
