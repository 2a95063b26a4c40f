"""Mixture-of-Experts: the port of paddle_tpu/moe.

  kernels.py  — dispatch (row gather) and combine (k-way weighted
                gather) as CUDA kernels, their plain versions, and the
                autograd Functions with the JAX package's index-form
                backwards;
  router.py   — top-k routing, GShard capacity bucketing, aux and z
                losses, routing-health stats;
  layer.py    — MoEFFN and moe_ffn_values (one device, or expert
                parallel over a mesh's ep axis);
  model.py    — GPTMoEConfig/GPTMoE: GPT blocks with routed FFNs, the
                aux losses folded into loss();
  stats.py    — the moe_* fields of a step record.
"""
from .kernels import (combine_plain, gather_plain, moe_combine,
                      moe_gather)  # noqa: F401
from .layer import MoEFFN, moe_ffn_values  # noqa: F401
from .model import (GPTMoE, GPTMoEBlock, GPTMoEConfig, GPTMoEModel,
                    gpt_moe_tiny_config)  # noqa: F401
from .router import capacity_for, route_top_k  # noqa: F401
from .stats import note_step_stats  # noqa: F401
