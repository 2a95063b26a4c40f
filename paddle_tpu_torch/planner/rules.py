"""Regex partition rules: parameter placement as data — the port of
paddle_tpu/planner/rules.py.

An ordered list of `(regex, axes)` rules, first match wins, matched
against the dotted parameter name (`match_partition_rules` /
`parameter_spec_from_name`), that the planner searches over, lints
(SH208 coverage), serializes into a plan report and applies to a model.
The rules and their resolution are JAX's verbatim; only applying them
differs: the port tags a module, not a parameter. `module.mesh_axes`
maps a local parameter name to `(axes, groups)` (the tag
`sharded_train.shard_model` cuts by), so `apply_partition_rules` writes
the axes into the owning module's tag and keeps the tag's group count
(3 on the fused `qkv_proj`, whose q | k | v thirds are cut by heads):
the rules carry no groups, and dropping them would cut q, k and v
wrongly. The Megatron tuples below are the ones `models/gpt.py`,
`distributed/mp_layers.py` and `moe/layer.py` tag with.
"""
import re
from dataclasses import dataclass

__all__ = [
    "COLUMN_PARALLEL_WEIGHT_AXES", "COLUMN_PARALLEL_BIAS_AXES",
    "ROW_PARALLEL_WEIGHT_AXES", "VOCAB_PARALLEL_WEIGHT_AXES",
    "EXPERT_IN_WEIGHT_AXES", "EXPERT_OUT_WEIGHT_AXES",
    "REPLICATED", "SpecLayout", "gpt_partition_rules",
    "gpt_moe_partition_rules", "parameter_spec_from_name",
    "match_partition_rules", "apply_partition_rules",
]

# Megatron placement (the axes models/gpt.py and mp_layers tag with):
# column-parallel splits the OUTPUT dim over mp, row-parallel the INPUT
# dim, vocab-parallel embedding the vocab dim.
COLUMN_PARALLEL_WEIGHT_AXES = (None, "mp")
COLUMN_PARALLEL_BIAS_AXES = ("mp",)
ROW_PARALLEL_WEIGHT_AXES = ("mp", None)
VOCAB_PARALLEL_WEIGHT_AXES = ("mp", None)
# expert-parallel MoE placement (moe/layer.py MoEFFN's tags): stacked
# expert weights shard the EXPERT dim over ep and keep the Megatron ffn
# split over mp inside each expert
EXPERT_IN_WEIGHT_AXES = ("ep", None, "mp")     # w_in  [E, d, f]
EXPERT_OUT_WEIGHT_AXES = ("ep", "mp", None)    # w_out [E, f, d]
# explicit replication: () normalizes to an all-None spec; distinct
# from "no rule matched" (which SH208 flags under a sharded layout)
REPLICATED = ()


@dataclass(frozen=True)
class SpecLayout:
    """Mesh-axis naming for a rule set. The defaults are the process
    mesh's axes (`distributed.env.MESH_AXES`); ZeRO is not a separate
    axis here — it rides the dp axis via the trainer's zero_stage (see
    ShardedTrainStep), so rules never name it."""
    data_axis: str = "dp"
    tp_axis: str = "mp"
    sp_axis: str = "sp"
    ep_axis: str = "ep"

    def _mp(self, axes):
        if self.tp_axis == "mp":
            return axes
        return tuple(self.tp_axis if a == "mp" else a for a in axes)

    def column_parallel(self):
        return self._mp(COLUMN_PARALLEL_WEIGHT_AXES)

    def column_parallel_bias(self):
        return self._mp(COLUMN_PARALLEL_BIAS_AXES)

    def row_parallel(self):
        return self._mp(ROW_PARALLEL_WEIGHT_AXES)

    def vocab_parallel(self):
        return self._mp(VOCAB_PARALLEL_WEIGHT_AXES)

    def _ep(self, axes):
        out = []
        for a in axes:
            if a == "ep":
                out.append(self.ep_axis)
            elif a == "mp":
                out.append(self.tp_axis)
            else:
                out.append(a)
        return tuple(out)

    def expert_in(self):
        return self._ep(EXPERT_IN_WEIGHT_AXES)

    def expert_out(self):
        return self._ep(EXPERT_OUT_WEIGHT_AXES)


def gpt_partition_rules(layout=None):
    """The GPT family's placement as ordered (regex, axes) rules — the
    axes of the `mesh_axes` tags in `models/gpt.py` (the CPU tests hold
    the two together). Ends with an explicit replicate-everything
    catch-all: layernorms, row-parallel biases and the position table
    are replicated ON PURPOSE, and the catch-all is what makes that
    visible to the SH208 coverage lint (a param matching NO rule is a
    finding; a param matching the catch-all is a decision)."""
    lo = layout or SpecLayout()
    return [
        (r"\bwte\.weight$", lo.vocab_parallel()),
        (r"\bwpe\.weight$", REPLICATED),
        (r"\b(qkv_proj|fc1)\.weight$", lo.column_parallel()),
        (r"\b(qkv_proj|fc1)\.bias$", lo.column_parallel_bias()),
        (r"\b(out_proj|fc2)\.weight$", lo.row_parallel()),
        (r"\b(ln1|ln2|ln_f)\.(weight|bias)$", REPLICATED),
        (r".*", REPLICATED),
    ]


def gpt_moe_partition_rules(layout=None):
    """Placement for the GPTMoE family (moe/model.py): the MoE rules
    FIRST (more specific — the gpt catch-all would otherwise eat them),
    then the dense GPT rules for the shared attention/embedding/LN
    parameters; the axes of MoEFFN's tags. The router gate is replicated ON
    PURPOSE: every token routes against all experts, so the [d, E]
    gate must be resident everywhere."""
    lo = layout or SpecLayout()
    return [
        (r"\bmlp\.w_gate$", REPLICATED),
        (r"\bmlp\.w_in$", lo.expert_in()),
        (r"\bmlp\.w_out$", lo.expert_out()),
    ] + gpt_partition_rules(layout)


def parameter_spec_from_name(param_name, layout=None, rules=None):
    """Heuristic mesh_axes assignment from a dotted parameter name —
    the first matching rule's axes (None when nothing matches, which
    the coverage lint treats as silent replication)."""
    for pattern, axes in (rules if rules is not None
                          else gpt_partition_rules(layout)):
        if re.search(pattern, param_name):
            return axes
    return None


def match_partition_rules(rules, named_params, on_miss="raise"):
    """Resolve every (name, param) through the ordered rule list.

    Returns [(name, axes, rule_index)]; scalar/size-1 leaves resolve to
    REPLICATED without consulting the rules (never worth sharding).
    on_miss: "raise" (a param no rule covers is a rule-set bug — the
    planner's default, mirrored softly by SH208) or "replicate"."""
    out = []
    for name, p in named_params:
        shape = tuple(getattr(p, "shape", ()) or ())
        n = 1
        for s in shape:
            n *= int(s)
        if not shape or n <= 1:
            out.append((name, REPLICATED, None))
            continue
        for i, (pattern, axes) in enumerate(rules):
            if re.search(pattern, name):
                out.append((name, tuple(axes or ()), i))
                break
        else:
            if on_miss == "raise":
                raise ValueError(
                    f"no partition rule matches parameter '{name}' "
                    f"(shape {shape}); add a rule or an explicit "
                    "catch-all ('.*', ()) so the replication is a "
                    "decision, not an accident")
            out.append((name, None, None))
    return out


def _tag_owner(model, name):
    """(module, local name) of the tag of parameter `name`: the module
    whose `mesh_axes` holds it (a tag may sit on an ancestor, as the
    attention's "qkv_proj.weight" does), else the parameter's own
    module."""
    parts = name.split(".")
    for i in range(len(parts) - 1, -1, -1):
        mod = model.get_submodule(".".join(parts[:i])) if i else model
        local = ".".join(parts[i:])
        if local in (getattr(mod, "mesh_axes", None) or {}):
            return mod, local
    prefix, _, local = name.rpartition(".")
    return (model.get_submodule(prefix) if prefix else model), local


def apply_partition_rules(model, rules=None, overwrite=False):
    """Tag a live model's parameters from a rule list: the resolved axes
    go into the owning module's `mesh_axes` tag (local name -> (axes,
    groups)), which `shard_model`/`ShardedTrainStep` cut by. Existing
    tags win unless overwrite=True — a hand-tuned exception on one
    layer survives a planner re-tag; a re-tag keeps the tag's group
    count; a parameter `shard_model` already cut keeps its tag.
    Returns the model."""
    rules = rules if rules is not None else gpt_partition_rules()
    named = [(n, p) for n, p in model.named_parameters() if p is not None]
    for name, axes, _ in match_partition_rules(rules, named):
        mod, local = _tag_owner(model, name)
        tags = getattr(mod, "mesh_axes", None)
        old = (tags or {}).get(local)
        if (old is not None and not overwrite) or \
                local in mod.__dict__.get("_mesh_cut", {}):
            continue
        axes = tuple(axes or ())
        if old is None and not axes:
            continue
        if tags is None:
            tags = mod.mesh_axes = {}
        tags[local] = (axes, int(old[1]) if old is not None else 1)
    return model
