"""paddle_tpu_torch.planner — the auto-sharding planner, the port of
paddle_tpu/planner/.

A cost-model-driven layout search (dp x zero x mp x pp x sp x ep) whose
every returned candidate has passed the lint battery
(`analysis.sharding_lint` SH201-SH208 with per-device memory projection,
`analysis.program_lint` over one recorded proxy step, an
`analysis.collective_order` capture) with zero error findings.

Layers:

- `memory`  — per-card memory arithmetic (params/grads/opt/activations,
              ZeRO and remat aware) and the older `search_plan`.
- `rules`   — parameter placement as regex partition rules, applied to
              a model as the port's per-module (axes, groups) tags.
- `planner` — the search: `plan(model_cfg, mesh_shape, hbm_budget,
              chip=...)` -> `Plan` (chosen `Layout`, rules, the
              candidate ledger with rejection reasons, the kind=plan
              record); `evaluate_layout` for auditing one layout;
              `calibration_from_records` (measured memory) and
              `calibration_from_comm_records` (measured collectives,
              telemetry/comm_obs) close the loop.

CLI: `python -m paddle_tpu_torch.tools.autoshard` (plan table, rejection
reasons, JSON report, `--selfcheck`).
"""
from .memory import (  # noqa: F401
    HBM_BYTES, MemoryPlan, gpt_memory_plan, gpt_params, search_plan,
    tp_divisibility_issues,
)
from .rules import (  # noqa: F401
    SpecLayout, apply_partition_rules, gpt_moe_partition_rules,
    gpt_partition_rules, match_partition_rules,
    parameter_spec_from_name,
)
from .planner import (  # noqa: F401
    AbstractParam, Candidate, InfeasiblePlanError, Layout, MeshSpec,
    Plan, abstract_params_for, calibration_from_comm_records,
    calibration_from_records, default_rules_for, evaluate_layout,
    gpt_abstract_params, gpt_moe_abstract_params, plan,
)

__all__ = [
    "HBM_BYTES", "MemoryPlan", "gpt_memory_plan", "gpt_params",
    "search_plan", "tp_divisibility_issues",
    "SpecLayout", "apply_partition_rules", "gpt_partition_rules",
    "gpt_moe_partition_rules", "match_partition_rules",
    "parameter_spec_from_name",
    "AbstractParam", "Candidate", "InfeasiblePlanError", "Layout",
    "MeshSpec", "Plan", "abstract_params_for",
    "calibration_from_comm_records", "calibration_from_records",
    "default_rules_for", "evaluate_layout",
    "gpt_abstract_params", "gpt_moe_abstract_params", "plan",
]
