"""The memory planner's older import path — the port of
paddle_tpu/distributed/planner.py, a shim over `paddle_tpu_torch.planner`.

The memory arithmetic (gpt_memory_plan, MemoryPlan, search_plan) lives
in `paddle_tpu_torch.planner.memory`, under the full planner
(`paddle_tpu_torch.planner.plan`); this module re-exports it so
`from paddle_tpu_torch.distributed.planner import search_plan` (and the
`paddle_tpu_torch.distributed` package exports) keep working.
"""
from ..planner.memory import (  # noqa: F401
    HBM_BYTES, MemoryPlan, _divisors, gpt_memory_plan, gpt_params,
    search_plan, tp_divisibility_issues,
)

__all__ = ["gpt_memory_plan", "MemoryPlan", "HBM_BYTES", "search_plan"]
