"""paddle_tpu_torch.serving — continuous-batching LLM serving engine.

The port of paddle_tpu/serving: `kv_cache` (refcounted block pool,
prefix index, paged K/V arenas), `scheduler` (token-granular continuous
batching with chunked prefill and preemption by recompute),
`resilience` (deadlines, priorities, admission control, typed errors)
and `engine` (`ServingEngine`).
"""
from .engine import EngineConfig, ServingEngine
from .kv_cache import (NULL_BLOCK, BlockLeakError, BlockPool, PagedKVCache,
                       PrefixIndex, StaleIndexError)
from .resilience import (AdmissionController, Deadlines,
                         DeadlineExceededError, QueueFullError,
                         RequestCancelledError, ServingError, ShedError)
from .scheduler import Request, RequestHandle, SamplingParams, Scheduler

__all__ = ["EngineConfig", "ServingEngine", "NULL_BLOCK", "BlockLeakError",
           "BlockPool", "PagedKVCache", "PrefixIndex", "StaleIndexError",
           "AdmissionController", "Deadlines", "DeadlineExceededError",
           "QueueFullError", "RequestCancelledError", "ServingError",
           "ShedError", "Request", "RequestHandle", "SamplingParams",
           "Scheduler"]
