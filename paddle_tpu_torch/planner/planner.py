"""Auto-sharding planner: cost-model-driven layout search, verified by
the lints before anything is built — the port of
paddle_tpu/planner/planner.py.

`plan(model_cfg, mesh_shape, hbm_budget, chip=...)` searches
dp x zero x mp x pp x sp x ep layouts: an analytic cost model ranks the
candidates and every candidate must pass the lint battery with zero
error findings:

  - `analysis.sharding_lint` SH201-SH206 over the candidate's regex
    partition rules applied to the model's ABSTRACT parameters (name,
    shape, dtype and the port's tag groups; nothing built), with
    `project_hbm` per-device accounting feeding the SH206 budget check;
  - SH208 partition-rule coverage;
  - `analysis.program_lint` over one recorded proxy step (state updated
    out of place, host syncs, upcasts, 64-bit values, collectives over
    a group of one under the candidate's mesh axis sizes);
  - an `analysis.collective_order` capture of that same step.

The search, its enumeration, ranking, tie-break and error text are
JAX's. Meshes are `MeshSpec` stand-ins (axis names and sizes; it
answers `env.axis_size` as the port's DeviceMesh does), parameters are
`AbstractParam`s, and the one proxy step — the port's jit.TrainStep on
the CPU at JAX's proxy configuration (vocab 256, width 64, 2 layers, 4
heads, seq 64, AdamW, batch 2 x 32) — is executed once per process
(JAX traces it) and cached across candidates and calls. Its weights and
batch come from explicit generators, so plan() moves no caller's
random stream (JAX's proxy draws from the global one). `chip` is a
name in the port's tables ("h100") or a `cost_model.ChipSpec`.
"""
import itertools
from dataclasses import dataclass, field

import numpy as np

from ..analysis import Finding, SEV_ERROR, summarize
from ..analysis import sharding_lint
from .. import cost_model
from .memory import (gpt_memory_plan, gpt_params, _divisors, hbm_bytes,
                     tp_divisibility_issues)
from .rules import (gpt_moe_partition_rules, gpt_partition_rules,
                    match_partition_rules)

__all__ = ["plan", "Plan", "Layout", "Candidate", "MeshSpec",
           "AbstractParam", "InfeasiblePlanError", "gpt_abstract_params",
           "gpt_moe_abstract_params", "abstract_params_for",
           "default_rules_for", "evaluate_layout",
           "calibration_from_records", "calibration_from_comm_records"]

MESH_AXES = ("dp", "pp", "mp", "sp", "ep")

# calibration ratios outside this band mean the analytic model and the
# measured bytes disagree structurally — clamp so one bad record can't
# swing feasibility by an order of magnitude
_CALIBRATION_BAND = (0.5, 4.0)


class MeshSpec:
    """A stand-in for the port's mesh carrying only what the lints read —
    axis names, axis sizes, device count — so a 64-card layout can be
    linted with no card. It answers as a torch DeviceMesh does for
    `env.axis_size` (`mesh_dim_names`, `size(dim)`), and as JAX's
    MeshSpec does for the lints (`axis_names`, `shape[axis]`)."""

    def __init__(self, dp=1, pp=1, mp=1, sp=1, ep=1):
        self._shape = {"dp": int(dp), "pp": int(pp), "mp": int(mp),
                       "sp": int(sp), "ep": int(ep)}
        for a, s in self._shape.items():
            if s < 1:
                raise ValueError(f"mesh axis {a} size {s} < 1")

    @property
    def axis_names(self):
        return MESH_AXES

    @property
    def shape(self):
        return dict(self._shape)

    @property
    def mesh_dim_names(self):
        return MESH_AXES

    def size(self, mesh_dim=None):
        """The size of axis `mesh_dim` (an index into MESH_AXES), or the
        device count (DeviceMesh.size's signature)."""
        if mesh_dim is not None:
            return self._shape[MESH_AXES[mesh_dim]]
        n = 1
        for s in self._shape.values():
            n *= s
        return n

    def __repr__(self):
        inner = ", ".join(f"{a}={s}" for a, s in self._shape.items()
                          if s > 1) or "1 device"
        return f"MeshSpec({inner})"


class AbstractParam:
    """A parameter that exists only as (shape, dtype, mesh_axes, groups)
    — the unit the sharding lint and HBM projection consume; `groups` is
    the port's tag group count (3 on the fused qkv, cut by heads)."""

    __slots__ = ("shape", "dtype", "mesh_axes", "groups")

    def __init__(self, shape, dtype=np.float32, mesh_axes=None, groups=1):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self.mesh_axes = mesh_axes
        self.groups = int(groups)

    @property
    def nbytes(self):
        return int(np.prod(self.shape or (1,))) * self.dtype.itemsize

    def __repr__(self):
        return (f"AbstractParam({self.shape}, {self.dtype}, "
                f"{self.mesh_axes}, groups={self.groups})")


def gpt_abstract_params(cfg, prefix="gpt.", dtype=np.float32):
    """[(name, AbstractParam)] for `models.gpt.GPTForPretraining(cfg)`
    WITHOUT building it — names, shapes and order match the live
    model's `named_parameters()` exactly (the CPU tests hold them
    together), so rule matching and HBM projection see precisely what
    `shard_model` will see. Linear weights are [in_features,
    out_features]; the fused qkv carries its tag's 3 groups."""
    d, f = cfg.hidden_size, cfg.ffn_hidden_size
    out = [(f"{prefix}wte.weight", AbstractParam((cfg.vocab_size, d), dtype)),
           (f"{prefix}wpe.weight",
            AbstractParam((cfg.max_seq_len, d), dtype))]
    for i in range(cfg.num_layers):
        b = f"{prefix}blocks.{i}."
        out += [
            (b + "ln1.weight", AbstractParam((d,), dtype)),
            (b + "ln1.bias", AbstractParam((d,), dtype)),
            (b + "attn.qkv_proj.weight",
             AbstractParam((d, 3 * d), dtype, groups=3)),
            (b + "attn.qkv_proj.bias",
             AbstractParam((3 * d,), dtype, groups=3)),
            (b + "attn.out_proj.weight", AbstractParam((d, d), dtype)),
            (b + "attn.out_proj.bias", AbstractParam((d,), dtype)),
            (b + "ln2.weight", AbstractParam((d,), dtype)),
            (b + "ln2.bias", AbstractParam((d,), dtype)),
            (b + "mlp.fc1.weight", AbstractParam((d, f), dtype)),
            (b + "mlp.fc1.bias", AbstractParam((f,), dtype)),
            (b + "mlp.fc2.weight", AbstractParam((f, d), dtype)),
            (b + "mlp.fc2.bias", AbstractParam((d,), dtype)),
        ]
    out += [(f"{prefix}ln_f.weight", AbstractParam((d,), dtype)),
            (f"{prefix}ln_f.bias", AbstractParam((d,), dtype))]
    return out


def gpt_moe_abstract_params(cfg, prefix="gpt.", dtype=np.float32):
    """[(name, AbstractParam)] for `moe.GPTMoE(cfg)` — derived from the
    dense skeleton: each block's fc1/fc2 MLP entries are replaced in
    place by the routed expert stack (router gate + stacked expert
    weights, no expert biases, as MoEFFN)."""
    d, f = cfg.hidden_size, cfg.ffn_hidden_size
    E = int(getattr(cfg, "num_experts", 0) or 0)
    out = []
    for name, p in gpt_abstract_params(cfg, prefix=prefix, dtype=dtype):
        if name.endswith("mlp.fc1.weight"):
            b = name[:-len("fc1.weight")]
            out += [(b + "w_gate", AbstractParam((d, E), dtype)),
                    (b + "w_in", AbstractParam((E, d, f), dtype)),
                    (b + "w_out", AbstractParam((E, f, d), dtype))]
        elif ".mlp." not in name:
            out.append((name, p))
    return out


def _is_moe(cfg):
    return int(getattr(cfg, "num_experts", 0) or 0) > 0


def abstract_params_for(cfg, dtype=np.float32):
    """Model-family dispatch: a config carrying num_experts > 0 is the
    GPTMoE family, anything else the dense GPT family."""
    if _is_moe(cfg):
        return gpt_moe_abstract_params(cfg, dtype=dtype)
    return gpt_abstract_params(cfg, dtype=dtype)


def default_rules_for(cfg):
    """Default partition-rule set for a config's model family."""
    return gpt_moe_partition_rules() if _is_moe(cfg) \
        else gpt_partition_rules()


@dataclass(frozen=True, order=True)
class Layout:
    """One point in the search space. fsdp/ZeRO is `zero_stage` over
    the dp axis (stage 3 = parameters dp-sharded = FSDP), not a
    separate mesh axis — matching ShardedTrainStep's model."""
    dp: int = 1
    pp: int = 1
    mp: int = 1
    sp: int = 1
    ep: int = 1
    zero_stage: int = 1
    micro_batch: int = 1
    remat: bool = True

    @property
    def n_chips(self):
        return self.dp * self.pp * self.mp * self.sp * self.ep

    def mesh_shape(self):
        return {"dp": self.dp, "pp": self.pp, "mp": self.mp,
                "sp": self.sp, "ep": self.ep}

    def to_dict(self):
        return {"dp": self.dp, "pp": self.pp, "mp": self.mp,
                "sp": self.sp, "ep": self.ep,
                "zero_stage": self.zero_stage,
                "micro_batch": self.micro_batch, "remat": self.remat}

    def describe(self):
        axes = "x".join(f"{a}{getattr(self, a)}" for a in
                        ("dp", "pp", "mp", "sp", "ep")
                        if getattr(self, a) > 1) or "single-chip"
        return f"{axes} zero{self.zero_stage} mb{self.micro_batch}"


@dataclass
class Candidate:
    """One evaluated layout: its memory plan, tag-true HBM projection,
    cost estimate, and the static-analysis verdict."""
    layout: Layout
    memory: object = None              # MemoryPlan
    state_report: dict = field(default_factory=dict)
    projected_hbm_bytes: int = 0
    cost: dict = field(default_factory=dict)
    findings: list = field(default_factory=list)
    status: str = "feasible"
    reason: str = None

    @property
    def feasible(self):
        return self.status == "feasible"

    @property
    def step_time_s(self):
        return float(self.cost.get("step_time_s", float("inf")))

    @property
    def s_per_token(self):
        """Cost per token — THE ranking number: layouts are all scored
        at the same global batch, but ceil'd microbatch counts can
        leave a few % of token skew, and per-token cost is immune."""
        tok = float(self.cost.get("tokens_per_step", 0) or 0)
        return self.step_time_s / tok if tok else float("inf")

    def sort_key(self):
        # deterministic: finding-free candidates first (a feasible
        # candidate may carry warnings), then cost per token, then
        # projected HBM, then the layout tuple itself — two runs over
        # the same config always rank candidates identically (no
        # clocks, no hashes)
        return (len(self.findings), self.s_per_token,
                self.projected_hbm_bytes,
                tuple(sorted(self.layout.to_dict().items())))

    def to_dict(self):
        d = {"layout": self.layout.to_dict(), "status": self.status,
             "projected_hbm_bytes": int(self.projected_hbm_bytes),
             "cost": {k: (float(v) if isinstance(v, float) else v)
                      for k, v in self.cost.items()}}
        if self.reason:
            d["reason"] = self.reason
        if self.findings:
            d["findings"] = [f.to_dict() for f in self.findings]
        if self.memory is not None:
            d["memory"] = {
                "params": int(self.memory.params),
                "param_bytes": int(self.memory.param_bytes),
                "grad_bytes": int(self.memory.grad_bytes),
                "opt_bytes": int(self.memory.opt_bytes),
                "activation_bytes": int(self.memory.activation_bytes),
            }
        if self.state_report:
            d["state_projection"] = self.state_report
        return d


class InfeasiblePlanError(RuntimeError):
    """No candidate survived. Carries every evaluated candidate and
    names the binding constraint of the closest miss, so the caller
    learns WHY (budget too small, divisibility, lint kill) instead of
    just 'no'."""

    def __init__(self, message, candidates=()):
        super().__init__(message)
        self.candidates = list(candidates)


def calibration_from_records(records):
    """Projection-calibration ratio from measured-memory records:
    median(measured total bytes / projected bytes) over kind=compile
    records carrying both `hbm.total_bytes` (a measured peak, e.g.
    torch.cuda.max_memory_allocated of a step) and `hbm_projected_bytes`
    (the SH206 projection of the same layout).
    Returns 1.0 when no record qualifies; clamped to the sanity band so
    a single corrupt record cannot flip feasibility by 10x."""
    ratios = []
    for rec in records or ():
        if not isinstance(rec, dict) or rec.get("kind") != "compile":
            continue
        measured = (rec.get("hbm") or {}).get("total_bytes")
        projected = rec.get("hbm_projected_bytes")
        if measured and projected:
            ratios.append(float(measured) / float(projected))
    if not ratios:
        return 1.0
    lo, hi = _CALIBRATION_BAND
    return float(min(hi, max(lo, np.median(ratios))))


def calibration_from_comm_records(records):
    """Per-collective cost corrections from mesh-observatory records
    (telemetry/comm_obs via tools/commlab): for each op,
    median(measured time_ms / analytic predicted_ms) over
    kind=commbench measurement records carrying both — the comm
    sibling of `calibration_from_records`. The resulting {op: factor}
    dict feeds `estimate_layout_cost(comm_calibration=...)`, scaling
    that collective's terms: a mesh measuring psum at half the
    analytic link bandwidth prices every allreduce term at 2x. Each
    factor is clamped to the same sanity band as the HBM ratio (one
    corrupt record must not flip a ranking by 10x); ops with no
    qualifying record are absent — the cost model defaults them to
    1.0 (analytic). Returns {} when nothing qualifies."""
    ratios = {}
    for rec in records or ():
        if not isinstance(rec, dict) or rec.get("kind") != "commbench":
            continue
        if rec.get("event") not in (None, "measure"):
            continue   # db_update echoes would double-count their rows
        op = rec.get("op")
        measured = rec.get("time_ms")
        predicted = rec.get("predicted_ms")
        if op and isinstance(measured, (int, float)) and measured > 0 \
                and isinstance(predicted, (int, float)) and predicted > 0:
            ratios.setdefault(str(op), []).append(
                float(measured) / float(predicted))
    lo, hi = _CALIBRATION_BAND
    return {op: float(min(hi, max(lo, np.median(rs))))
            for op, rs in sorted(ratios.items())}


def _resolve_comm_calibration(comm_calibration):
    """{op: factor} from either an explicit dict or an iterable of
    commbench records; {} (fully analytic) when None."""
    if comm_calibration is None:
        return {}
    if isinstance(comm_calibration, dict):
        return {str(k): float(v) for k, v in comm_calibration.items()}
    return calibration_from_comm_records(comm_calibration)


# ---------------------------------------------------------------------------
# the proxy step: ONE small executed step, shared by every candidate
# ---------------------------------------------------------------------------

_PROXY_CACHE = {}


def _proxy_trace():
    """Run and record (once per process, then cached) one step of a
    small GPT's jit.TrainStep on the CPU, with its collective capture.
    The PT rules are dimension-independent and per-layer-repetitive, so
    a 2-layer model is a faithful specimen of the full config's step;
    only the mesh axis sizes (PT105) vary per candidate, and
    `lint_record` over the cached record is cheap. The weights and the
    batch come from explicit generators: the caller's random streams do
    not move."""
    key = "gpt-adamw"
    if key in _PROXY_CACHE:
        return _PROXY_CACHE[key]
    import torch
    from ..analysis import collective_order, program_lint
    from ..jit import TrainStep
    from ..models.gpt import GPTConfig, GPTForPretraining
    from ..optimizer import AdamW

    cfg = GPTConfig(vocab_size=256, hidden_size=64, num_layers=2,
                    num_heads=4, max_seq_len=64, dropout=0.0)
    model = GPTForPretraining(cfg, device="cpu", seed=0)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    step = TrainStep(model, model.loss, opt)
    gen = torch.Generator().manual_seed(0)
    ids, labels = (torch.randint(0, cfg.vocab_size, (2, 32), generator=gen,
                                 dtype=torch.int32) for _ in range(2))
    with collective_order.capture(rank=0) as trace:
        _, rec = program_lint.record_step(
            step, ids, labels,
            state=lambda: program_lint.train_step_state(step),
            fn_name="TrainStep[proxy]")
    entry = {
        "record": rec, "collectives_recorded": len(trace),
        # one process runs ONE rank's step, so the cross-rank comparison
        # over this capture is vacuously clean
        "collective_findings": collective_order.verify_ranks([trace]),
    }
    _PROXY_CACHE[key] = entry
    return entry


def _program_findings(layout):
    from ..analysis import program_lint
    tr = _proxy_trace()
    return program_lint.lint_record(
        tr["record"], mesh_axis_sizes=layout.mesh_shape(),
        fn_name="TrainStep[proxy]")


# ---------------------------------------------------------------------------
# candidate evaluation
# ---------------------------------------------------------------------------

def _project_state_bytes(report, cfg, layout):
    """Reconcile the tag-true projection with pipeline sharding: the
    mesh_axes tags carry the mp/dp placement but not the pp stacking
    (pipeline shards by stacking block params over the pp axis), so
    for pp > 1 the tag-based total is scaled by the worst stage's
    parameter fraction — the same ceil(L/pp)/L charge
    `gpt_memory_plan` makes."""
    total = report["per_device"]["total_bytes"]
    if layout.pp <= 1:
        return int(total)
    local_layers = max(1, -(-cfg.num_layers // layout.pp))
    return int(total * local_layers / max(1, cfg.num_layers))


def _resolve_tagged(named, resolved):
    """AbstractParams carrying their rule-resolved mesh_axes — layout-
    independent, so built ONCE per search, not per candidate."""
    return [(n, AbstractParam(p.shape, p.dtype, axes or None, p.groups))
            for (n, p), (_n, axes, _i) in zip(named, resolved)]


def _evaluate(cfg, layout, chip, budget, rules, tagged,
              calibration_ratio, verify, dp_over_dcn, global_batch,
              comm_calibration=None):
    """Run one layout through memory accounting, the sharding-lint
    battery and the cost model. Returns a Candidate (never raises on a
    bad layout — rejection is data). `global_batch` (sequences per
    step) is the FIXED amount of work every candidate is costed at —
    without it, high-dp layouts look slow simply because they chew
    more data per step."""
    cand = Candidate(layout=layout)
    cand.memory = gpt_memory_plan(
        cfg, dp=layout.dp, mp=layout.mp, pp=layout.pp, sp=layout.sp,
        micro_batch=layout.micro_batch, zero_stage=layout.zero_stage,
        remat=layout.remat)

    mesh = MeshSpec(**layout.mesh_shape())
    findings = sharding_lint.lint_model_sharding(
        tagged, mesh, zero_stage=layout.zero_stage)
    findings += sharding_lint.lint_partition_rules(rules, tagged, mesh)
    report, _ = sharding_lint.project_hbm(
        tagged, mesh, zero_stage=layout.zero_stage)
    cand.state_report = report
    state_b = _project_state_bytes(report, cfg, layout) * calibration_ratio
    act_b = cand.memory.activation_bytes
    cand.projected_hbm_bytes = int(state_b + act_b)
    if cand.projected_hbm_bytes > budget:
        # name the binding constraint from the SAME numbers the
        # rejection compares: the tag-true per-device state components
        # scaled by the pp stage fraction and the calibration ratio
        # (NOT the raw gpt_memory_plan parts — those are uncalibrated
        # and would misattribute the rejection)
        per_dev = report["per_device"]
        state_scale = state_b / max(1, per_dev["total_bytes"])
        parts = {"param_bytes": per_dev["param_bytes"] * state_scale,
                 "grad_bytes": per_dev["grad_bytes"] * state_scale,
                 "opt_state_bytes": per_dev["opt_state_bytes"]
                 * state_scale,
                 "activation_bytes": act_b}
        binding = max(parts, key=parts.get)
        findings.append(Finding(
            "SH206", SEV_ERROR, "mesh",
            f"projected per-device HBM {cand.projected_hbm_bytes / 2**30:.2f}"
            f" GiB exceeds the budget {budget / 2**30:.2f} GiB "
            f"(binding constraint: {binding} "
            f"{parts[binding] / 2**30:.2f} GiB; calibration x"
            f"{calibration_ratio:.2f})",
            suggestion="raise zero_stage, deepen pp, grow the mesh, or "
                       "raise the budget"))
    if verify == "full" and \
            not any(f.severity == SEV_ERROR for f in findings):
        findings += _program_findings(layout)
    cand.findings = findings
    # microbatches per dp rank to push global_batch sequences through;
    # the 1F1B in-flight bound (2*pp) in the MEMORY accounting is
    # independent of this total count
    num_micro = max(1, -(-int(global_batch) //
                         (layout.dp * layout.micro_batch)))
    cand.cost = cost_model.layout_cost_from_config(
        cfg, chip=chip, n_params=cand.memory.params, dp=layout.dp,
        pp=layout.pp, mp=layout.mp, sp=layout.sp, ep=layout.ep,
        zero_stage=layout.zero_stage, micro_batch=layout.micro_batch,
        num_micro=num_micro, dp_over_dcn=dp_over_dcn,
        comm_calibration=comm_calibration)
    # only ERROR-severity findings reject: warnings (e.g. an SH208
    # dead rule, which is a layout-INDEPENDENT property of the rule
    # set) stay attached to the candidate — rejecting every layout
    # over one would misreport a lint warning as infeasibility — and
    # the ranking prefers finding-free candidates, so a warning only
    # wins when nothing clean survives
    errors = [f for f in findings if f.severity == SEV_ERROR]
    if errors:
        cand.status = "rejected"
        cand.reason = f"{errors[0].rule_id}: {errors[0].message}"
    return cand


def evaluate_layout(model_cfg, layout, chip="h100", hbm_budget=None,
                    headroom=0.8, rules=None, calibration=None,
                    verify="sharding", dp_over_dcn=False,
                    global_batch=None, param_dtype=np.float32,
                    comm_calibration=None):
    """Evaluate ONE explicit layout through the same battery plan()
    runs — how a hand-written spec gets compared against the planner's
    pick (the parity tests), and how an existing run's layout gets
    re-audited after a config change. global_batch defaults to the
    layout's chip count (plan()'s rule) so the two are comparable."""
    layout = layout if isinstance(layout, Layout) else Layout(**layout)
    budget = hbm_budget if hbm_budget is not None \
        else int(hbm_bytes(chip) * headroom)
    rules = rules if rules is not None else default_rules_for(model_cfg)
    named = abstract_params_for(model_cfg, dtype=param_dtype)
    tagged = _resolve_tagged(named, match_partition_rules(rules, named))
    ratio = calibration if isinstance(calibration, (int, float)) \
        else calibration_from_records(calibration)
    if global_batch is None:
        global_batch = layout.n_chips
    return _evaluate(model_cfg, layout, chip, budget, rules, tagged,
                     float(ratio or 1.0), verify, dp_over_dcn,
                     global_batch,
                     comm_calibration=_resolve_comm_calibration(
                         comm_calibration))


# ---------------------------------------------------------------------------
# the Plan
# ---------------------------------------------------------------------------

@dataclass
class Plan:
    """A verified parallelism plan: the chosen layout, the rules that
    place every parameter, and the full candidate ledger (feasible AND
    rejected, with reasons) — the planner's whole argument, not just
    its conclusion."""
    model: str
    chip: str
    n_chips: int
    hbm_budget: int
    layout: Layout
    rules: list
    candidates: list
    calibration: float = 1.0
    verify: dict = field(default_factory=dict)
    comm_calibration: dict = field(default_factory=dict)

    @property
    def chosen(self):
        return next(c for c in self.candidates
                    if c.feasible and c.layout == self.layout)

    @property
    def projected_hbm_bytes(self):
        return self.chosen.projected_hbm_bytes

    @property
    def cost(self):
        return self.chosen.cost

    @property
    def rejected(self):
        return [c for c in self.candidates if not c.feasible]

    def mesh_spec(self):
        return MeshSpec(**self.layout.mesh_shape())

    def build_mesh(self, devices=None):
        """Install the real mesh for this plan over the live process
        group (`env.build_mesh`, which raises when the world size is not
        the layout's product) — the moment the plan stops being static.
        The port's mesh spans the group's ranks: `devices` must be
        None."""
        from ..distributed import env
        if devices is not None:
            raise ValueError("Plan.build_mesh: the port's mesh spans the "
                             "process group's ranks; devices must be None")
        return env.build_mesh(**self.layout.mesh_shape())

    def apply(self, model, mesh=None):
        """Tag the model's parameters from the plan's rules and place
        them on the mesh (current process mesh by default; build_mesh
        first on a fresh process). Returns the model."""
        from ..distributed import env
        from ..distributed.sharded_train import shard_model
        from .rules import apply_partition_rules
        apply_partition_rules(model, self.rules)
        return shard_model(model, mesh or env.current_mesh())

    def trainer_kwargs(self):
        """kwargs for ShardedTrainStep (which also accepts the plan
        itself via `plan=`)."""
        return {"zero_stage": self.layout.zero_stage,
                "seq_shard_batch": self.layout.sp > 1}

    def to_record(self, rank=0, measured_hbm_bytes=None):
        """The kind=plan telemetry record (validated by
        telemetry/ledger_check.py; the >15% projection-drift rule fires
        when a measured peak is attached as measured_hbm_bytes)."""
        from ..telemetry import sink
        return sink.make_plan_record(
            model=self.model, chosen=self.layout.to_dict(),
            candidates_considered=len(self.candidates),
            candidates_rejected=[
                {"layout": c.layout.describe(), "reason": c.reason}
                for c in self.rejected],
            rank=rank, chip=self.chip, n_chips=self.n_chips,
            projected_hbm_bytes=int(self.projected_hbm_bytes),
            measured_hbm_bytes=measured_hbm_bytes,
            cost_step_s=float(self.cost.get("step_time_s", 0.0)),
            hbm_budget_bytes=int(self.hbm_budget),
            calibration=float(self.calibration),
            verify=dict(self.verify),
            **({"comm_calibration": dict(self.comm_calibration)}
               if self.comm_calibration else {}))

    def to_dict(self):
        return {
            "model": self.model, "chip": self.chip,
            "n_chips": int(self.n_chips),
            "hbm_budget_bytes": int(self.hbm_budget),
            "calibration": float(self.calibration),
            "comm_calibration": dict(self.comm_calibration),
            "chosen": self.layout.to_dict(),
            "projected_hbm_bytes": int(self.projected_hbm_bytes),
            "cost": {k: (float(v) if isinstance(v, float) else v)
                     for k, v in self.cost.items()},
            "rules": [[p, list(a) if a else []] for p, a in self.rules],
            "verify": dict(self.verify),
            "candidates": [c.to_dict() for c in self.candidates],
        }

    def summary_table(self):
        """Human-readable candidate table (the CLI's plan table)."""
        rows = [f"{'layout':28} {'hbm GiB':>8} {'step ms':>8} "
                f"{'comm %':>6}  status"]
        for c in sorted(self.candidates, key=Candidate.sort_key):
            mark = "*" if c.feasible and c.layout == self.layout else " "
            status = "feasible" if c.feasible else \
                f"rejected [{(c.reason or '?').split(':')[0]}]"
            rows.append(
                f"{mark}{c.layout.describe():27} "
                f"{c.projected_hbm_bytes / 2**30:8.2f} "
                f"{c.step_time_s * 1e3:8.2f} "
                f"{c.cost.get('comm_frac', 0.0) * 100:5.1f}%  {status}")
        return "\n".join(rows)


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------

def _resolve_mesh_shape(mesh_shape, n_chips):
    """(n, fixed-axes dict) from plan()'s mesh_shape argument: an int
    is a chip count with every axis free; a dict fixes the named axes
    (e.g. {"dp": 2, "mp": 8} — the two-level 13B topology) and, when
    it covers the whole product, the chip count too."""
    fixed = {}
    if isinstance(mesh_shape, dict):
        for a, s in mesh_shape.items():
            if a not in MESH_AXES:
                raise ValueError(f"unknown mesh axis {a!r} "
                                 f"(axes are {MESH_AXES})")
            fixed[a] = int(s)
        if n_chips is None:
            # partially-fixed dict with no n_chips: the free axes
            # default to 1, so the product IS the chip count
            n_chips = 1
            for s in fixed.values():
                n_chips *= s
    elif mesh_shape is not None:
        n_chips = int(mesh_shape)
    if n_chips is None:
        raise ValueError("give mesh_shape (chip count or axis dict) "
                         "or n_chips")
    return int(n_chips), fixed


def _enumerate_layouts(cfg, n, fixed, zero_stages, micro_batches,
                       max_mp, remat):
    """Deterministic candidate stream: sorted divisor loops, fixed axes
    honored, SH203-divisibility pruned at the source (see
    memory.tp_divisibility_issues — the enumeration must never propose
    what the lint instantly kills)."""
    seq_parallel = bool(getattr(cfg, "sequence_parallel", None))
    n_experts = int(getattr(cfg, "num_experts", 0) or 0)
    out = []
    for mp in _divisors(n):
        if fixed.get("mp", mp) != mp or mp > max_mp:
            continue
        if tp_divisibility_issues(cfg, mp):
            continue
        for pp in _divisors(n // mp):
            if fixed.get("pp", pp) != pp or cfg.num_layers % pp:
                continue
            rest = n // (mp * pp)
            sp_opts = [s for s in _divisors(rest)
                       if not tp_divisibility_issues(cfg, 1, sp=s)] \
                if (seq_parallel or "sp" in fixed) else [1]
            for sp in sp_opts:
                if fixed.get("sp", sp) != sp or rest % sp:
                    continue
                rest2 = rest // sp
                ep_opts = [e for e in _divisors(rest2)
                           if n_experts and n_experts % e == 0] \
                    if (n_experts or "ep" in fixed) else [1]
                if not ep_opts:
                    ep_opts = [1]
                for ep in ep_opts:
                    if fixed.get("ep", ep) != ep or rest2 % ep:
                        continue
                    dp = rest2 // ep
                    if fixed.get("dp", dp) != dp:
                        continue
                    # zero is inert without a dp axis to shard over:
                    # searching stages at dp=1 would triple identical
                    # candidates
                    stages = zero_stages if dp > 1 \
                        else (min(zero_stages),)
                    for zero, mb in itertools.product(stages,
                                                      micro_batches):
                        out.append(Layout(
                            dp=dp, pp=pp, mp=mp, sp=sp, ep=ep,
                            zero_stage=zero, micro_batch=mb,
                            remat=remat))
    return out


def plan(model_cfg, mesh_shape=None, hbm_budget=None, chip="h100", *,
         n_chips=None, zero_stages=(1, 2, 3), micro_batches=(1,),
         max_mp=8, remat=True, headroom=0.8, verify="full",
         calibration=None, rules=None, model_name=None,
         dp_over_dcn=False, global_batch=None, cost_slack=0.10,
         param_dtype=np.float32, comm_calibration=None):
    """Search dp x fsdp(zero) x tp x pp x sp x ep layouts for
    `model_cfg` on `mesh_shape` chips of `chip`, and return the
    cheapest candidate that passes the full lint battery with
    zero error-severity findings — finding-FREE candidates always
    outrank warned ones, so the chosen layout carries warnings only
    when no clean layout survives at all. Raises InfeasiblePlanError
    (carrying every evaluated candidate and the binding constraint of
    the closest miss) when nothing survives.

    mesh_shape: chip count (int) or {axis: size} dict fixing axes
                (the {"dp": 2, "mp": 8} two-level topology).
    hbm_budget: per-chip byte budget; defaults to headroom * the
                chip's memory (the rest is the allocator's room —
                exactly MemoryPlan.fits' rule).
    verify:     "full" = sharding battery + program lint + collective
                capture (one cached proxy step, run once per process on
                the CPU); "sharding" = arithmetic + sharding lint only
                (pure-host, for tight loops).
    calibration: float ratio, or an iterable of measured-memory
                records (`calibration_from_records`) — measured bytes
                over projected, scaling every candidate's state
                projection.
    comm_calibration: {op: factor} dict, or an iterable of
                mesh-observatory commbench records
                (`calibration_from_comm_records`) — measured collective
                time over the analytic prediction, scaling each
                candidate's per-collective cost terms. The comm
                sibling of `calibration`.
    global_batch: sequences per step every candidate is costed at
                (default: one per chip) — the fixed unit of work that
                makes high-dp and high-pp layouts comparable.
    cost_slack: the winner is the LOWEST-HBM candidate among those
                within this fraction of the best per-token cost —
                near-ties on speed are broken toward banked memory
                headroom (bigger future batches, longer sequences),
                not toward whichever near-tie enumerated first.
    Deterministic by construction: no randomness, sorted enumeration,
    total-ordered ranking — the same config always yields the same
    plan and the same report.
    """
    n, fixed = _resolve_mesh_shape(mesh_shape, n_chips)
    budget = hbm_budget if hbm_budget is not None \
        else int(hbm_bytes(chip) * headroom)
    chip_name = getattr(chip, "name", chip)
    rules = rules if rules is not None else default_rules_for(model_cfg)
    ratio = calibration if isinstance(calibration, (int, float)) \
        else calibration_from_records(calibration)
    ratio = float(ratio or 1.0)
    comm_cal = _resolve_comm_calibration(comm_calibration)
    named = abstract_params_for(model_cfg, dtype=param_dtype)
    tagged = _resolve_tagged(named, match_partition_rules(rules, named))
    if model_name is None:
        fam = "gpt_moe" if _is_moe(model_cfg) else "gpt"
        model_name = (f"{fam}[{gpt_params(model_cfg) / 1e6:.0f}M"
                      f"/L{model_cfg.num_layers}/s{model_cfg.max_seq_len}]")

    layouts = _enumerate_layouts(model_cfg, n, fixed, tuple(zero_stages),
                                 tuple(micro_batches), max_mp, remat)
    if not layouts:
        raise InfeasiblePlanError(
            f"no {n}-chip mesh factorization survives the divisibility "
            f"constraints for {model_name} (heads={model_cfg.num_heads}, "
            f"layers={model_cfg.num_layers}, fixed={fixed or 'none'})")

    if global_batch is None:
        global_batch = n
    candidates = [_evaluate(model_cfg, lo, chip, budget, rules, tagged,
                            ratio, verify, dp_over_dcn, global_batch,
                            comm_calibration=comm_cal)
                  for lo in layouts]
    feasible = sorted((c for c in candidates if c.feasible),
                      key=Candidate.sort_key)
    if not feasible:
        closest = min(candidates,
                      key=lambda c: (len([f for f in c.findings
                                          if f.severity == SEV_ERROR]),
                                     c.projected_hbm_bytes))
        raise InfeasiblePlanError(
            f"no feasible layout for {model_name} on {n} x {chip_name} "
            f"(budget {budget / 2**30:.2f} GiB): closest candidate "
            f"{closest.layout.describe()} rejected — {closest.reason}",
            candidates)

    # near-ties on cost break toward banked HBM headroom: among
    # candidates within cost_slack of the best per-token cost, take
    # the smallest projection (then cheapest, then the layout tuple —
    # still a total order)
    clean = [c for c in feasible if not c.findings] or feasible
    best = clean[0].s_per_token
    window = [c for c in clean
              if c.s_per_token <= best * (1.0 + cost_slack)]
    chosen = min(window, key=lambda c: (c.projected_hbm_bytes,
                                        c.s_per_token,
                                        tuple(sorted(
                                            c.layout.to_dict().items()))))
    verify_info = {
        "mode": verify,
        "families_checked": (["sharding", "program", "collective_order"]
                             if verify == "full" else ["sharding"]),
        "findings_on_chosen": summarize(chosen.findings),
    }
    if verify == "full":
        tr = _proxy_trace()
        verify_info["collectives_recorded"] = tr["collectives_recorded"]
        verify_info["collective_findings"] = len(
            tr["collective_findings"])
        verify_info["program_ops"] = tr["record"].n_ops
    return Plan(model=model_name, chip=chip_name, n_chips=n,
                hbm_budget=budget, layout=chosen.layout, rules=rules,
                candidates=candidates, calibration=ratio,
                verify=verify_info, comm_calibration=comm_cal)

